"""dlrover-tpu on PyTorch and CUDA.

The second package of the repository: the same training system as
``dlrover_tpu`` (JAX on a TPU), written for PyTorch on an NVIDIA
Hopper card. Modules mirror the JAX package's layout and names, so each
file here has its counterpart there; the JAX package is the reference
the tests hold this one to.

This package imports ``torch`` and ``numpy`` only — never ``jax`` or
anything of ``dlrover_tpu``. What it needs from the JAX package's
framework-free modules is copied. Kernels the JAX package wrote in
Pallas are CUDA C++ here (``csrc/``), built with ``nvcc`` at first use
(``ops/_build.py``).
"""
