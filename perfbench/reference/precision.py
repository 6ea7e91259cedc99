"""Matrix products at a stated precision, in plain PyTorch, the same on the
CPU and the card: the operands are rounded first (to TF32, bf16 or
per-row int8), then multiplied in full float32 with TF32 off. A product of
two bf16 or two TF32 values is exact in f32, so this is what the card's
tensor cores compute, up to the order of summation.

* ``f32``  — the operands as they are;
* ``tf32`` — each operand rounded to 10 mantissa bits (nearest, ties even);
* ``bf16`` — each operand rounded to bfloat16;
* ``int8`` — each row of each operand scaled by max|x| / 127 and rounded to
  the nearest integer; the product is scaled back.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32", "bf16", "int8")


@contextlib.contextmanager
def full_f32():
    """TF32 off for the block, on the card; the CPU has no TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def quantize_rows(x: torch.Tensor):
    """(int-valued f32 rows, per-row scale): symmetric int8 per row."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 127.0
    return torch.round(x / scale).clamp(-127, 127), scale


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return x.float()
    if prec == "tf32":
        return round_tf32(x)
    if prec == "bf16":
        return round_bf16(x)
    raise ValueError(f"unknown operand precision {prec!r}")


class _Rounded(torch.autograd.Function):
    """``a @ b`` with every operand rounded to ``prec``, forward and
    backward (the backward's products round theirs too, as the card's
    tensor cores would)."""

    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.save_for_backward(a, b)
        ctx.prec = prec
        with full_f32():
            return operand(a, prec) @ operand(b, prec)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.prec
        with full_f32():
            ga = operand(g, p) @ operand(b, p).T
            a2, g2 = a.reshape(-1, a.shape[-1]), g.reshape(-1, g.shape[-1])
            gb = operand(a2, p).T @ operand(g2, p)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """``a @ b`` (a: (..., K), b: (K, M)) at ``prec``; differentiable except
    at ``int8``."""
    if prec == "int8":
        with full_f32():
            qa, sa = quantize_rows(a.float())
            qb, sb = quantize_rows(b.float().T)
            return (qa @ qb.T) * sa * sb.T
    if prec == "f32":
        with full_f32():
            return a.float() @ b.float()
    return _Rounded.apply(a, b, prec)
