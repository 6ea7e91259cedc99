"""BPR and sampled-softmax losses — the in-batch BPR kernels, their twins
and the autograd function that joins them.

Counterpart of ``recommendit_tpu/ops/bpr.py``:

* :func:`pairwise_bpr_loss`, :func:`in_batch_softmax_loss` — plain torch.
* :func:`in_batch_bpr_loss_ref` — the plain twin of ``in_batch_bpr_loss_xla``;
  :func:`_bpr_bwd_ref` — the closed-form twin of ``_bpr_bwd_xla``.
* :class:`InBatchBPR` — the counterpart of the custom VJP
  ``in_batch_bpr_pallas``. On CUDA tensors its forward launches
  ``csrc/bpr.cu``'s forward (the port of ``_bpr_row_loss_kernel``) and its
  backward the backward kernel (the port of ``_bpr_bwd_kernel``), each a
  tile launch on the tensor cores (3xTF32) and a finishing launch over
  partials in a scratch the wrapper allocates; on CPU tensors it runs the
  two twins; any other device raises.
* :func:`in_batch_bpr_loss` — the dispatcher.

Math: with s = U Vᵀ, the loss is Σ_{i≠j} softplus(s_ij − s_ii) / (B(B−1)),
and ∂L/∂s_ij = σ(s_ij − s_ii)/(B(B−1)) for i≠j,
∂L/∂s_ii = −Σ_{j≠i} σ(s_ij − s_ii)/(B(B−1)). B < 2 raises: the mean over
B(B−1) pairs is undefined (JAX returns NaN there).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from recommendit_tpu_torch.ops._build import count_launch
from recommendit_tpu_torch.ops.topk import full_f32_matmul

# Kernel launches since the last reset, by kernel name. Only the CUDA
# wrappers add to it, once per wrapper call (each makes two CUDA launches).
LAUNCHES = {"bpr_fwd": 0, "bpr_bwd": 0}

_MAX_DIM = 256   # csrc/bpr.cu stages two 64-row tiles of up to 256 columns


def pairwise_bpr_loss(user_emb: torch.Tensor, pos_item_emb: torch.Tensor,
                      neg_item_emb: torch.Tensor) -> torch.Tensor:
    """Explicit-negative BPR: −mean log σ(s_pos − s_neg)."""
    pos = (user_emb * pos_item_emb).sum(-1)
    neg = (user_emb * neg_item_emb).sum(-1)
    return -F.logsigmoid(pos - neg).mean()


def _check_batch(b: int) -> None:
    if b < 2:
        raise ValueError(
            f"in-batch BPR needs a batch of at least 2 rows, got {b}")


def _off_diagonal(b: int, like: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.eye(b, dtype=like.dtype, device=like.device)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + log1p(exp(−|x|)), the form ``jax.nn.softplus`` computes
    and the kernel writes out."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def in_batch_bpr_loss_ref(user_emb: torch.Tensor,
                          item_emb: torch.Tensor) -> torch.Tensor:
    """Plain twin of the forward kernel (``in_batch_bpr_loss_xla``):
    diagonal positives, every other in-batch item a negative. Products in
    full f32 (TF32 off)."""
    b = user_emb.shape[0]
    _check_batch(b)
    with full_f32_matmul():
        scores = user_emb @ item_emb.T
    sp = _softplus(scores - scores.diagonal()[:, None])
    return (sp * _off_diagonal(b, sp)).sum() / (b * (b - 1))


def _bpr_bwd_ref(u: torch.Tensor, v: torch.Tensor, g: torch.Tensor):
    """Closed-form twin of the backward kernels (``_bpr_bwd_xla``):
    (du, dv) for the upstream gradient ``g``."""
    b = u.shape[0]
    _check_batch(b)
    with full_f32_matmul():
        scores = u @ v.T
        sig = torch.sigmoid(scores - scores.diagonal()[:, None])
        grad_s = sig * _off_diagonal(b, sig) / (b * (b - 1))
        grad_s = g * (grad_s - torch.diag(grad_s.sum(dim=1)))
        return grad_s @ v, grad_s.T @ u


def _check_kernel_args(*tensors: torch.Tensor) -> None:
    u = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the BPR kernels take float32, got {t.dtype}")
        if t.device != u.device:
            raise ValueError("all tensors must be on one device")
    u, v = tensors[:2]
    if u.dim() != 2 or u.shape != v.shape:
        raise ValueError(
            f"shape mismatch: users {tuple(u.shape)}, items {tuple(v.shape)}")
    b, d = u.shape
    _check_batch(b)
    if d % 4 or d > _MAX_DIM:
        raise ValueError(
            f"feature dim {d} must be a multiple of 4 and at most {_MAX_DIM}")
    if b >= 2 ** 31 or b * d >= 2 ** 62:
        raise ValueError("unsupported batch size")
    for t in (u, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("embeddings must be contiguous and 16-byte aligned")


def _lib():
    from recommendit_tpu_torch.ops._build import load_library

    lib = load_library("bpr")
    lib.bpr_scratch_floats.restype = ctypes.c_longlong
    lib.bpr_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.bpr_forward_launch.restype = ctypes.c_int
    lib.bpr_forward_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.bpr_backward_launch.restype = ctypes.c_int
    lib.bpr_backward_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def _scratch(lib, b: int, d: int, backward: bool, device) -> torch.Tensor:
    """The kernels' partial sums: (slices, B) row sums, and for the
    backward (slices, B, D) of W V and of Wᵀ U (``bpr_scratch_floats``)."""
    n = lib.bpr_scratch_floats(b, d, int(backward))
    if n < 0:
        raise ValueError(f"no BPR kernel for a ({b}, {d}) batch")
    return torch.empty(n, dtype=torch.float32, device=device)


def bpr_forward_cuda(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on the current stream → the scalar loss
    (the mean of the kernel's (B,) row losses, taken outside as in JAX)."""
    _check_kernel_args(u, v)
    lib = _lib()
    b, d = u.shape
    row_loss = torch.empty(b, dtype=torch.float32, device=u.device)
    scratch = _scratch(lib, b, d, False, u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.bpr_forward_launch(u.data_ptr(), v.data_ptr(),
                                    row_loss.data_ptr(), scratch.data_ptr(),
                                    b, d, stream)
    if rc != 0:
        raise RuntimeError(f"bpr forward launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "bpr_fwd")
    return row_loss.mean()


def bpr_backward_cuda(u: torch.Tensor, v: torch.Tensor, g: torch.Tensor):
    """Launch the backward kernel on the current stream → (du, dv)."""
    g = g.reshape(1).contiguous()
    _check_kernel_args(u, v, g)
    lib = _lib()
    b, d = u.shape
    du = torch.empty_like(u)
    dv = torch.empty_like(v)
    scratch = _scratch(lib, b, d, True, u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.bpr_backward_launch(
            u.data_ptr(), v.data_ptr(), g.data_ptr(), du.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), b, d, stream)
    if rc != 0:
        raise RuntimeError(f"bpr backward launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "bpr_bwd")
    return du, dv


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no BPR kernel for device {t.device}")
    return t.device.type


def bpr_forward(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The loss: the forward kernel for tensors on the card, the twin for
    tensors on the CPU."""
    if _device_type(u) == "cuda":
        return bpr_forward_cuda(u, v)
    return in_batch_bpr_loss_ref(u, v)


def bpr_backward(u: torch.Tensor, v: torch.Tensor, g: torch.Tensor):
    """(du, dv): the backward kernels for tensors on the card, the
    closed-form twin for tensors on the CPU."""
    if _device_type(u) == "cuda":
        return bpr_backward_cuda(u, v, g)
    return _bpr_bwd_ref(u, v, g)


class InBatchBPR(torch.autograd.Function):
    """In-batch BPR loss of (B, D) user and item embeddings, with the
    closed-form backward. CUDA tensors: the kernels. CPU tensors: the twins
    (any float dtype, so ``gradcheck`` runs in float64)."""

    @staticmethod
    def forward(ctx, user_emb, item_emb):
        ctx.save_for_backward(user_emb, item_emb)
        return bpr_forward(user_emb, item_emb)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return bpr_backward(*ctx.saved_tensors, g)


def in_batch_bpr_loss(user_emb: torch.Tensor, item_emb: torch.Tensor,
                      use_kernel: bool = True) -> torch.Tensor:
    """In-batch BPR loss: :class:`InBatchBPR` (the kernels on the card) when
    ``use_kernel``, else the twin under plain autograd."""
    if use_kernel:
        return InBatchBPR.apply(user_emb, item_emb)
    return in_batch_bpr_loss_ref(user_emb, item_emb)


def in_batch_softmax_loss(user_emb: torch.Tensor, item_emb: torch.Tensor,
                          log_q: torch.Tensor | None = None,
                          temperature: float = 0.05,
                          item_bias: torch.Tensor | None = None) -> torch.Tensor:
    """In-batch sampled softmax with the logQ correction: logits
    cos/T + item_bias − log_q, the diagonal as the positive."""
    with full_f32_matmul():
        scores = (user_emb @ item_emb.T) / temperature
    if item_bias is not None:
        scores = scores + item_bias[None, :]
    if log_q is not None:
        scores = scores - log_q[None, :]
    return -torch.log_softmax(scores, dim=1).diagonal().mean()
