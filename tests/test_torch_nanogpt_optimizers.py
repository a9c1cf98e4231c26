"""The port's nanoGPT example end to end with each ``--optimizer`` the
JAX example offers besides AdamW: the smoke model (2 layers, T 128, f32)
on the CPU for 3 steps. Every loss finite, the loss falling, and the
optimizer state of the expected kind: quantized moments at 8 and 4
bits (int8 codes, packed uint8 nibbles) beside f32 moments for the
small leaves, AGD's f32 moments.
"""

import math

import pytest
import torch

from dlrover_tpu_torch.examples.nanogpt import train
from dlrover_tpu_torch.optim.low_bit import QTensor, optimizer_state_bytes


def _run(optimizer, *extra):
    args = train.parse_args(
        ["--smoke", "--device", "cpu", "--steps", "3",
         "--optimizer", optimizer, *extra]
    )
    return train.run(args)


@pytest.mark.parametrize("optimizer,code_dtype,width", [
    ("adam8bit", torch.int8, 1024), ("adam4bit", torch.uint8, 512),
])
def test_low_bit_adam_trains(optimizer, code_dtype, width):
    out = _run(optimizer)
    losses = out["losses"]
    assert all(math.isfinite(x) for x in losses) and out["finite"]
    assert losses[-1] < losses[0]
    state = out["opt_state"]
    assert state["count"] == 3
    # wte [256, 128] is quantized; the [2, 128] LayerNorm gains are not
    for name in ("mu", "nu"):
        wte = state[name]["wte"]
        assert isinstance(wte, QTensor)
        assert wte.q.dtype == code_dtype and tuple(wte.q.shape) == (32, width)
        assert wte.scales.abs().max().item() > 0
        ln = state[name]["blocks"]["ln1_g"]
        assert isinstance(ln, torch.Tensor) and ln.dtype == torch.float32
    actual, f32_equiv = optimizer_state_bytes(state)
    assert actual < (0.3 if optimizer == "adam8bit" else 0.2) * f32_equiv


def test_plain_quantizers_give_the_same_losses_on_the_cpu():
    a = _run("adam4bit")["losses"]
    b = _run("adam4bit", "--quant", "plain")["losses"]
    assert a == b


def test_agd_trains():
    out = _run("agd")
    losses = out["losses"]
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    state = out["opt_state"]
    assert state["count"] == 3 and state["max_exp_avg_sq"] is None
    assert state["exp_avg"]["wte"].dtype == torch.float32
    assert state["exp_avg_sq"]["wte"].abs().max().item() > 0


def test_quant_plain_needs_a_low_bit_optimizer():
    with pytest.raises(ValueError, match="--quant plain"):
        _run("agd", "--quant", "plain")
