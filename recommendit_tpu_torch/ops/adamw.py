"""AdamW's update with global-norm clipping's scale in one pass — the
wrapper of ``csrc/adamw.cu``.

The JAX package has no kernel here: XLA fuses optax's update into one loop
over each buffer. The port's plain version is the foreach path of
:class:`~recommendit_tpu_torch.training.train_embeddings.OptaxAdamW`
(``_adamw_update``, after ``clip_``): sixteen ``torch._foreach_*`` passes
and two for the clip's scale. :func:`adamw_fused_` computes the same
update in one launch that reads each element's param, gradient and moments
once and writes the param and moments once, rounding every operation as
the foreach ops round it on the card, so the two are bit-equal. The
optimizer chooses by device alone (:func:`on_card`): CUDA tensors take the
kernel, CPU tensors the foreach path; a CUDA tensor the kernel cannot
take is an error, not a slower path.
"""
from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from recommendit_tpu_torch.ops._build import count_launch

# Kernel launches since the last reset. Only the CUDA wrapper adds to it.
LAUNCHES = {"adamw_fused": 0}

# the step's f32 scalars the kernel takes as they are, in its argument order
# (OptaxAdamW._scalars' keys); the bias corrections follow as reciprocals
SCALAR_KEYS = ("b1", "1-b1", "b2", "1-b2")


class _Segment(ctypes.Structure):
    """``csrc/adamw.cu``'s ``Segment``: n f32 elements of a param, its
    gradient and both moments, and whether weight decay applies."""
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("decay", ctypes.c_int)]


def on_card(tensors: Mapping[str, Sequence[torch.Tensor]]) -> bool:
    """Whether a step over ``tensors`` (a list of each role: params,
    gradients, moments, the clip's factors) takes the kernel: True where
    they are on a CUDA device, False where none is. A tensor the kernel
    cannot take where any is on the card — on the CPU or another card than
    the first, not float32, not contiguous — raises ValueError naming it:
    on the card no step runs the foreach path."""
    named = [(f"{role}[{i}]", t) for role, ts in tensors.items() for i, t in enumerate(ts)]
    cuda = [t.device for _, t in named if t.device.type == "cuda"]
    if not cuda:
        return False
    for name, t in named:
        why = ("on " + str(t.device) if t.device != cuda[0] else
               str(t.dtype) if t.dtype != torch.float32 else
               "not contiguous" if not t.is_contiguous() else None)
        if why:
            raise ValueError(f"the AdamW kernel takes contiguous float32 tensors on "
                             f"{cuda[0]}: {name} is {why}")
    return True


def _lib():
    from recommendit_tpu_torch.ops._build import load_library

    lib = load_library("adamw")
    lib.adamw_max_segments.restype = ctypes.c_int
    lib.adamw_fused_launch.restype = ctypes.c_int
    lib.adamw_fused_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    return lib


def adamw_fused_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                 mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                 decay: Sequence[bool], s: dict, weight_decay: float, eps: float,
                 clip: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
    """``optax.adamw``'s update of ``params``, ``mu``, ``nu`` in place, as
    ``OptaxAdamW``'s foreach path computes it, on the current stream: one
    launch a ``adamw_max_segments()`` tensors (every tensor of the step,
    in one launch, for every optimizer of the port). ``s`` holds the step's
    f32 host scalars (``OptaxAdamW._scalars``), ``decay`` whether each
    param is decayed; ``clip`` = (d, c), the clip's two f32 device scalars,
    scales each gradient by (g / d) · c in registers: the gradients are
    read, never written. Every tensor must be on the card (:func:`on_card`) and each
    gradient and moment have its param's number of elements."""
    clip_ptrs = (None, None)
    if clip is not None:
        d, c = clip
        if d.numel() != 1 or c.numel() != 1 or not on_card(
                {"param": params, "clip factor": clip}):
            raise ValueError("the clip's factors must be two one-element float32 "
                             "tensors on the params' device")
        clip_ptrs = (d.data_ptr(), c.data_ptr())
    segs = []
    for p, g, m, v, dec in zip(params, grads, mu, nu, decay, strict=True):
        n = p.numel()
        if not (g.numel() == m.numel() == v.numel() == n):
            raise ValueError(f"a gradient or moment of {g.numel()}, {m.numel()}, "
                             f"{v.numel()} elements for a param of {n}")
        if n:
            # no decay at all where weight_decay is 0, as the foreach path
            # (adding p · 0 could turn a -0 update into +0)
            segs.append((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n,
                         int(bool(dec) and bool(weight_decay))))
    if not segs:
        return
    device = params[0].device
    lib = _lib()
    most = lib.adamw_max_segments()
    # a foreach division by a host scalar multiplies by its f32 reciprocal
    # on the card: so does the kernel
    recips = [float(np.float32(1) / np.float32(s[k])) for k in ("bc1", "bc2")]
    scalars = [s[k] for k in SCALAR_KEYS] + recips + [eps, weight_decay, s["-lr"]]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for a in range(0, len(segs), most):
            part = segs[a:a + most]
            table = (_Segment * len(part))(*part)
            rc = lib.adamw_fused_launch(table, len(part), *clip_ptrs, *scalars, stream)
            if rc != 0:
                raise RuntimeError(f"adamw_fused launch failed: CUDA error {rc}")
            count_launch(LAUNCHES, "adamw_fused")
