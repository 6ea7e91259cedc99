"""recommendit_tpu_torch — the PyTorch / CUDA port of ``recommendit_tpu``.

Mirrors the JAX package's layout and module names. Plain tensor code is
PyTorch; each Pallas kernel of the JAX package becomes a kernel written by
hand for Hopper (``csrc/``), with its plain PyTorch twin beside the wrapper.
Imports ``torch`` and never ``jax``, and nothing of the JAX package: what it
needs of the JAX package's framework-free modules it keeps as copies
(``config.py``, ``utils/latency.py``), pinned to the originals by tests.
Entry points run on the card (``device="cuda"``) unless the caller names
the CPU; without a card a call that names no device raises.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level names, as the JAX package's (importing the package
    loads nothing else)."""
    from importlib import import_module

    exports = {
        "CTRModel": "recommendit_tpu_torch.models.ctr",
        "CTRTrainer": "recommendit_tpu_torch.training.train_ctr",
        "make_ctr_dataset": "recommendit_tpu_torch.data.ctr",
    }
    if name in exports:
        return getattr(import_module(exports[name]), name)
    raise AttributeError(f"module 'recommendit_tpu_torch' has no attribute {name!r}")
