"""The port's losses (``recommendit_tpu_torch/ops/bpr.py``) against the JAX
package's on the same seeded numpy inputs.

``InBatchBPR`` on CPU tensors runs the plain twins (the CUDA kernels run on
the card: ``tests/test_torch_kernels.py``). The JAX side is the Pallas
custom VJP in interpret mode, as ``tests/test_ops.py`` runs it, and the XLA
reference under ``jax.grad``.

Tolerances: 1e-5 relative — the loss against the reference's value, each
gradient's largest difference against its largest entry (both sides sum
the same f32 terms in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.ops.bpr import (
    in_batch_bpr_loss_xla,
    in_batch_bpr_pallas,
    in_batch_softmax_loss as jax_softmax,
    pairwise_bpr_loss as jax_pairwise,
)
from recommendit_tpu_torch.ops import bpr

RTOL = 1e-5


def _unit_rows(b, d, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, d)).astype(np.float32)
    v = rng.normal(size=(b, d)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return u, v


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max() / scale)


def _port_loss_and_grads(u, v, use_kernel=True):
    tu = torch.tensor(u, requires_grad=True)
    tv = torch.tensor(v, requires_grad=True)
    loss = bpr.in_batch_bpr_loss(tu, tv, use_kernel)
    loss.backward()
    return float(loss.detach()), tu.grad.numpy(), tv.grad.numpy()


SHAPES = [(16, 8), (16, 64), (20, 8), (20, 64), (64, 8), (64, 64)]


@pytest.mark.parametrize("b,d", SHAPES)
def test_in_batch_bpr_matches_pallas_interpret(b, d):
    u, v = _unit_rows(b, d, seed=b + d)
    want = float(in_batch_bpr_pallas(jnp.asarray(u), jnp.asarray(v), 16, True))
    gu, gv = jax.grad(lambda a, c: in_batch_bpr_pallas(a, c, 16, True),
                      argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    loss, du, dv = _port_loss_and_grads(u, v)
    assert abs(loss - want) <= RTOL * abs(want)
    _close(du, gu)
    _close(dv, gv)


@pytest.mark.parametrize("b,d", SHAPES)
def test_in_batch_bpr_matches_xla(b, d):
    u, v = _unit_rows(b, d, seed=100 + b + d)
    want, (gu, gv) = jax.value_and_grad(in_batch_bpr_loss_xla, argnums=(0, 1))(
        jnp.asarray(u), jnp.asarray(v))
    for use_kernel in (True, False):
        loss, du, dv = _port_loss_and_grads(u, v, use_kernel)
        assert abs(loss - float(want)) <= RTOL * abs(float(want))
        _close(du, gu)
        _close(dv, gv)


@pytest.mark.parametrize("b,d", [(16, 8), (20, 64), (64, 64)])
def test_closed_form_backward_matches_autograd_of_twin(b, d):
    u, v = (torch.tensor(a) for a in _unit_rows(b, d, seed=7 * b))
    g = torch.tensor(1.7)
    du, dv = bpr._bpr_bwd_ref(u, v, g)
    uu, vv = u.clone().requires_grad_(), v.clone().requires_grad_()
    (g * bpr.in_batch_bpr_loss_ref(uu, vv)).backward()
    _close(du.numpy(), uu.grad.numpy())
    _close(dv.numpy(), vv.grad.numpy())


@pytest.mark.parametrize("b", [2, 5, 9])
def test_gradcheck_float64(b):
    gen = torch.Generator().manual_seed(b)
    u = torch.randn(b, 4, generator=gen, dtype=torch.float64, requires_grad=True)
    v = torch.randn(b, 4, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(bpr.InBatchBPR.apply, (u, v))


def test_cpu_takes_the_twins_without_counting_launches():
    u, v = _unit_rows(20, 8, seed=3)
    before = dict(bpr.LAUNCHES)
    _port_loss_and_grads(u, v)
    assert bpr.LAUNCHES == before


def test_other_device_raises():
    u = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no BPR kernel"):
        bpr.InBatchBPR.apply(u, u)


def test_batch_of_one_raises_where_jax_returns_nan():
    """The mean over B(B−1) pairs is 0/0 at B=1: JAX returns NaN (ROADMAP
    C.10), the port refuses the batch."""
    u, v = _unit_rows(1, 8, seed=0)
    assert np.isnan(float(in_batch_bpr_loss_xla(jnp.asarray(u), jnp.asarray(v))))
    for use_kernel in (True, False):
        with pytest.raises(ValueError, match="at least 2 rows"):
            bpr.in_batch_bpr_loss(torch.tensor(u), torch.tensor(v), use_kernel)


def test_pairwise_loss_and_grads_match_jax():
    rng = np.random.default_rng(11)
    u, p, n = (rng.normal(size=(32, 16)).astype(np.float32) for _ in range(3))
    want, grads = jax.value_and_grad(jax_pairwise, argnums=(0, 1, 2))(
        jnp.asarray(u), jnp.asarray(p), jnp.asarray(n))
    ts = [torch.tensor(a, requires_grad=True) for a in (u, p, n)]
    loss = bpr.pairwise_bpr_loss(*ts)
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= RTOL * abs(float(want))
    for t, g in zip(ts, grads):
        _close(t.grad.numpy(), g)


@pytest.mark.parametrize("with_log_q", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_softmax_loss_and_grads_match_jax(with_log_q, with_bias):
    u, v = _unit_rows(48, 16, seed=12)
    rng = np.random.default_rng(13)
    log_q = np.log(rng.dirichlet(np.ones(48))).astype(np.float32)
    bias = rng.normal(size=48).astype(np.float32)

    def jf(a, c, b):
        return jax_softmax(a, c, jnp.asarray(log_q) if with_log_q else None,
                           0.05, item_bias=b if with_bias else None)

    want, grads = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(bias))
    ts = [torch.tensor(a, requires_grad=True) for a in (u, v, bias)]
    loss = bpr.in_batch_softmax_loss(
        ts[0], ts[1], torch.tensor(log_q) if with_log_q else None, 0.05,
        item_bias=ts[2] if with_bias else None)
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= RTOL * abs(float(want))
    _close(ts[0].grad.numpy(), grads[0])
    _close(ts[1].grad.numpy(), grads[1])
    if with_bias:
        _close(ts[2].grad.numpy(), grads[2])
    else:
        assert ts[2].grad is None
