"""Fused memory-efficient softmax cross-entropy over a tied embedding.

Counterpart of ``dlrover_tpu/ops/cross_entropy.py`` (XLA code there, not
Pallas, so plain PyTorch here): chunked over the N tokens inside a
``torch.autograd.Function``,

* never holding more than one [chunk, V] f32 logits block (forward and
  backward recompute per chunk);
* saving only the per-token logsumexp (f32 [N]) between the passes;
* casting the cotangent to the activations' dtype before the two
  unembedding matmuls, so the backward runs them at the bf16 rate.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _exact_tf32(*xs: torch.Tensor):
    """TF32 products of operands that are exactly representable in
    bf16/f16 are exact (TF32 keeps 10 mantissa bits, bf16 7, f16 10),
    so an f32 matmul of upcast low-precision operands may run on the
    TF32 tensor cores and still equal the low-precision product
    accumulated in f32 -- the JAX ``preferred_element_type=f32`` dot.
    Off the card, or when any operand is f32, nothing changes."""
    if not all(
        x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) for x in xs
    ):
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 products and f32 output for operands of any
    float dtype (JAX's ``preferred_element_type=jnp.float32``)."""
    with _exact_tf32(a, b):
        return a.float() @ b.float()


class _FusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wte, targets, num_chunks, save_logits):
        n = x.shape[0]
        if n % num_chunks:
            raise ValueError(
                f"N={n} tokens must divide into num_chunks={num_chunks}"
            )
        wte_t = wte.float().t()  # upcast once, not once per chunk
        lse, gold, saved = [], [], []
        with _exact_tf32(x, wte):
            for x_c, t_c in zip(
                x.chunk(num_chunks), targets.chunk(num_chunks)
            ):
                logits = x_c.float() @ wte_t
                lse.append(torch.logsumexp(logits, dim=-1))
                gold.append(logits.gather(1, t_c[:, None])[:, 0])
                if save_logits:
                    saved.append(logits.to(x.dtype))
        lse = torch.stack(lse)
        loss = (lse - torch.stack(gold)).mean()
        ctx.save_for_backward(x, wte, targets, lse.reshape(-1), *saved)
        ctx.num_chunks = num_chunks
        return loss

    @staticmethod
    def backward(ctx, g):
        x, wte, targets, lse, *saved = ctx.saved_tensors
        n, num_chunks = x.shape[0], ctx.num_chunks
        wte_t = None if saved else wte.float().t()  # upcast once
        dx = torch.empty_like(x)
        dwte = torch.zeros(wte.shape, dtype=torch.float32, device=wte.device)
        with _exact_tf32(x, wte):
            for i, (x_c, t_c, lse_c, dx_c) in enumerate(zip(
                x.chunk(num_chunks), targets.chunk(num_chunks),
                lse.chunk(num_chunks), dx.chunk(num_chunks),
            )):
                if saved:
                    logits = saved[i].float()
                else:
                    logits = x_c.float() @ wte_t
                dlogits = torch.exp(logits - lse_c[:, None])
                dlogits[torch.arange(len(t_c), device=t_c.device), t_c] -= 1.0
                dlogits = (dlogits * (g / n)).to(x.dtype)  # bf16 cotangent
                torch.matmul(dlogits, wte, out=dx_c)
                dwte += dlogits.t().float() @ x_c.float()
        return dx, dwte.to(wte.dtype), None, None, None


def fused_cross_entropy(
    x: torch.Tensor,
    wte: torch.Tensor,
    targets: torch.Tensor,
    num_chunks: int = 8,
    save_logits: bool = False,
) -> torch.Tensor:
    """Mean token cross-entropy of ``x @ wte^T`` against targets.

    x: [N, E] activations (bf16 is fine); wte: [V, E] tied embedding;
    targets: [N] int. N must divide into ``num_chunks``.
    ``save_logits=True`` keeps the forward logits in x's dtype so the
    backward skips the [N, V] recompute matmul, at the cost of N*V
    low-precision values of memory and of rounding the logits before
    the backward's exp.
    """
    return _FusedCrossEntropy.apply(x, wte, targets, num_chunks, save_logits)
