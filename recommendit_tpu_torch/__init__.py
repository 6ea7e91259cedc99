"""recommendit_tpu_torch — the PyTorch / CUDA port of ``recommendit_tpu``.

Mirrors the JAX package's layout and module names. Plain tensor code is
PyTorch; each Pallas kernel of the JAX package becomes a kernel written by
hand for Hopper (``csrc/``), with its plain PyTorch twin beside the wrapper.
Imports ``torch`` and never ``jax``; from the JAX package only the
framework-free ``recommendit_tpu.config`` and
``recommendit_tpu.utils.latency`` are used.
"""

__version__ = "0.1.0"
