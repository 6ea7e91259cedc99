"""The optimizer's one-pass kernel (``csrc/adamw.cu``, ``ops/adamw.py``) and
the clip's factors handed to ``OptaxAdamW.step``.

On the CPU: the foreach path with ``clip=`` is bit-equal to clipping in
place and then stepping, and leaves the gradients clipped, as
``OptaxAdamW``'s docstring says; ``on_card`` and the step's dispatch
choose by device: CPU tensors of any dtype and layout take the foreach
path, contiguous f32 tensors on one card the kernel, and any other tensor
where one is on the card raises ValueError naming it; the wrapper refuses
what the kernel cannot take before it loads anything.

On the card (``cuda``; skipped without one): after 5 steps the kernel is
bit-equal — every bit of params, ``mu`` and ``nu``, so a -0 against a +0
fails — to ``clip_by_global_norm_sharded_`` then
``OptaxAdamW._step_unchunked`` (on a one-rank process group), and so is
the chunked foreach path, over a list mixing decayed and undecayed params,
an odd-length 1-D tensor, a table cut by chunk boundaries, row views
whose starts are not 16-byte aligned (the param and gradient only, and all
four tensors alike), a norm above and below the limit, weight decay 0 and
0.1; the kernel reads the gradients and writes nothing to them, and the
step is one launch. Each division the foreach ops make is pinned on
values where a true division and a multiply by the f32 reciprocal differ
(by a host scalar: the reciprocal's product; by a tensor: the true
quotient): the kernel rounds as they do. On the card run ``python -m pytest
tests/test_torch_adamw_fused.py -m cuda --noconftest``: this file imports
torch only.
"""
import socket
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from recommendit_tpu_torch.ops import adamw as fused
from recommendit_tpu_torch.training import train_embeddings as tte

STEPS = 5
LR = 1e-2
# shapes, decay flags and the chunk of each card case
CASES = {
    "mixed_decay": ([(300, 16), (41,), (16, 32), (32,), ()],
                    [True, False, True, True, False], tte.ADAM_CHUNK),
    "odd_1d": ([(100_003,), (7,)], [True, False], tte.ADAM_CHUNK),
    "chunk_boundary": ([(300, 16), (41,), (5, 3)], [True, False, True], 1000),
    "unaligned_view": ([(20_001,), (301, 16)], [True, True], tte.ADAM_CHUNK),
    "unaligned_all": ([(20_001,), (301, 16)], [False, True], tte.ADAM_CHUNK),
}
NORMS = {"above": 1.0, "below": 1e9}   # max_norm against the gradients' norm ~100


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _tensors(shapes, gen, device, scale=1.0):
    return [scale * torch.randn(s, generator=gen).to(device) for s in shapes]


# --- the CPU: the foreach path and the dispatch ------------------------------ #

@pytest.mark.parametrize("max_norm", NORMS.values(), ids=NORMS)
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("chunk", [100, tte.ADAM_CHUNK])
def test_foreach_clip_equals_clip_then_step(max_norm, wd, chunk):
    shapes, decay, _ = CASES["mixed_decay"]
    gen = torch.Generator().manual_seed(0)
    p0 = _tensors(shapes, gen, "cpu")
    given = tte.OptaxAdamW([p.clone() for p in p0], decay, wd, chunk=chunk)
    clipped = tte.OptaxAdamW([p.clone() for p in p0], decay, wd, chunk=chunk)
    one_pass = tte.OptaxAdamW([p.clone() for p in p0], decay, wd)
    for step in range(STEPS):
        grads = _tensors(shapes, gen, "cpu", scale=1.0 + step)
        clip = tte.clip_factors(tte.global_norm(grads), max_norm)
        g_given = [g.clone() for g in grads]
        given.step(g_given, LR, clip=clip)
        g_clipped = [g.clone() for g in grads]
        tte.clip_by_global_norm_(g_clipped, max_norm)
        clipped.step(g_clipped, LR)
        one_pass._step_unchunked([g.clone() for g in grads], LR, clip=clip)
        # the foreach path leaves the gradients clipped, as clip_by_global_norm_ does
        assert all(_bits_equal(a, b) for a, b in zip(g_given, g_clipped))
        if max_norm > 1e6:
            assert all(_bits_equal(a, b) for a, b in zip(g_given, grads))
        for x, y, z in ((given.params, clipped.params, one_pass.params),
                        (given.mu, clipped.mu, one_pass.mu),
                        (given.nu, clipped.nu, one_pass.nu)):
            assert all(_bits_equal(a, b) and _bits_equal(a, c) for a, b, c in zip(x, y, z))


def test_cpu_steps_launch_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was called for CPU tensors")

    monkeypatch.setattr(tte, "adamw_fused_", refuse)
    before = dict(fused.LAUNCHES)
    opt = tte.OptaxAdamW([torch.ones(4, 3), torch.ones(5)], [True, False], 0.1)
    grads = [torch.ones(4, 3), torch.ones(5)]
    opt.step(grads, LR, clip=tte.clip_factors(tte.global_norm(grads), 1.0))
    opt.step(grads, LR)
    assert fused.LAUNCHES == before
    assert opt.count == 2


def _stand_in(device="cuda:0", dtype=torch.float32, contiguous=True):
    """What ``on_card`` reads of a tensor, for a card this host lacks."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           is_contiguous=lambda: contiguous)


@pytest.mark.parametrize("odd,want", [
    (None, True),
    ({"device": "cpu"}, "param\\[3\\] is on cpu"),
    ({"dtype": torch.float64}, "param\\[3\\] is torch.float64"),
    ({"dtype": torch.bfloat16}, "param\\[3\\] is torch.bfloat16"),
    ({"contiguous": False}, "param\\[3\\] is not contiguous"),
    ({"device": "cuda:1"}, "param\\[3\\] is on cuda:1"),
])
def test_fusable_takes_contiguous_f32_on_one_card(odd, want):
    """On the card the kernel or an error naming the tensor, never the
    foreach path."""
    tensors = [_stand_in() for _ in range(3)]
    if odd is not None:
        tensors.append(_stand_in(**odd))
    if want is True:
        assert fused.on_card({"param": tensors}) is True
    else:
        with pytest.raises(ValueError, match=want):
            fused.on_card({"param": tensors})


def test_fusable_of_real_tensors_on_the_cpu():
    """CPU tensors take the foreach path whatever their dtype or layout."""
    assert not fused.on_card({})
    assert not fused.on_card({"param": [torch.ones(3)]})
    assert not fused.on_card({"param": [torch.ones(3, 2).t()]})
    assert not fused.on_card({"param": [torch.ones(3, dtype=torch.float64)],
                              "gradient": [torch.ones(3, dtype=torch.bfloat16)]})


def test_a_card_tensor_among_cpu_tensors_is_named():
    with pytest.raises(ValueError, match="gradient\\[0\\] is on cpu"):
        fused.on_card({"param": [_stand_in()], "gradient": [_stand_in("cpu")]})
    with pytest.raises(ValueError, match="param\\[0\\] is on cpu"):
        fused.on_card({"param": [_stand_in("cpu")], "gradient": [_stand_in()]})


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_cpu_steps_of_other_dtypes_take_the_foreach_path(dtype, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was called for CPU tensors")

    monkeypatch.setattr(tte, "adamw_fused_", refuse)
    opt = tte.OptaxAdamW([torch.ones(4, 3, dtype=dtype)], [True], 0.1)
    before = opt.params[0].clone()
    opt.step([torch.ones(4, 3, dtype=dtype)], LR)
    assert opt.params[0].dtype == dtype and not torch.equal(opt.params[0], before)


@pytest.mark.parametrize("takes", [True, False])
def test_step_dispatches_on_what_it_sees(takes, monkeypatch):
    calls, seen = [], []

    def on_card(tensors):
        seen.append({k: list(v) for k, v in tensors.items()})
        return takes

    monkeypatch.setattr(tte, "on_card", on_card)
    monkeypatch.setattr(tte, "adamw_fused_", lambda *a, **k: calls.append((a, k)))
    opt = tte.OptaxAdamW([torch.ones(4, 3), torch.ones(5)], [True, False], 0.1)
    grads = [torch.ones(4, 3), torch.ones(5)]
    clip = tte.clip_factors(tte.global_norm(grads), 1.0)
    before = [p.clone() for p in opt.params]
    opt.step(grads, LR, clip=clip)
    (roles,) = seen
    assert list(roles) == ["param", "gradient", "mu", "nu", "clip factor"]
    assert roles["gradient"] == grads and len(roles["clip factor"]) == 2
    if takes:
        (args, kwargs), = calls
        p, g, m, v, decay, s, wd, eps, c = args
        assert p is opt.params and g is grads and m is opt.mu and v is opt.nu
        assert decay == [True, False] and wd == 0.1 and eps == tte.ADAM_EPS
        assert c is clip and s["bc1"] == pytest.approx(0.1) and s["-lr"] == pytest.approx(-LR)
        assert all(torch.equal(a, b) for a, b in zip(opt.params, before))
    else:
        assert not calls
        assert not torch.equal(opt.params[0], before[0])


def test_wrapper_refuses_what_the_kernel_cannot_take():
    p = [torch.ones(4)]
    s = {k: 1.0 for k in (*fused.SCALAR_KEYS, "bc1", "bc2", "-lr")}
    with pytest.raises(ValueError, match="elements"):
        fused.adamw_fused_(p, [torch.ones(5)], [torch.ones(4)], [torch.ones(4)], [True],
                           s, 0.1, 1e-8)
    with pytest.raises(ValueError, match="factors"):
        fused.adamw_fused_(p, p, p, p, [True], s, 0.1, 1e-8,
                           clip=(torch.ones(()), torch.ones(())))
    with pytest.raises(ValueError):
        fused.adamw_fused_(p, p, p, p, [True, False], s, 0.1, 1e-8)


# --- the card ----------------------------------------------------------------- #

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def model_group():
    """A process group of this one rank (NCCL), the ``model`` group of a
    (1, 1) mesh; skipped without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import torch.distributed as dist

    if dist.is_initialized():
        yield dist.group.WORLD
        return
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view that starts one float past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _recip_differs(x: torch.Tensor, b: float) -> bool:
    """Whether x / b, correctly rounded, differs from x · f32(1 / b)
    anywhere in ``x``."""
    x = x.double().cpu()
    true = (x / b).float()
    recip = (x.float() * torch.tensor(1 / b, dtype=torch.float32))
    return bool((true != recip).any())


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("case", CASES)
def test_fused_step_is_bit_equal_to_the_foreach_step(case, norm, wd, model_group):
    from recommendit_tpu_torch.parallel.mesh import (
        clip_by_global_norm_sharded_,
        sharded_global_norm,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    shapes, decay, chunk = CASES[case]
    max_norm = NORMS[norm]
    sharded = [len(s) == 2 for s in shapes]
    gen = torch.Generator().manual_seed(7)
    p0 = _tensors(shapes, gen, dev)
    opts = {name: tte.OptaxAdamW([p.clone() for p in p0], decay, wd, chunk=chunk)
            for name in ("kernel", "chunked", "one_pass")}
    if case.startswith("unaligned"):
        for opt in opts.values():
            opt.params[0] = _unaligned(opt.params[0])
            if case == "unaligned_all":
                opt.mu[0], opt.nu[0] = _unaligned(opt.mu[0]), _unaligned(opt.nu[0])
    kernel = opts["kernel"]
    for step in range(STEPS):
        grads = _tensors(shapes, gen, dev, scale=1.0 + step)
        if case.startswith("unaligned"):
            grads[0] = _unaligned(grads[0])
        lr = tte.cosine_lr(LR, step, STEPS)
        norm_ = sharded_global_norm(grads, sharded, model_group)
        assert (float(norm_) > max_norm) == (norm == "above")
        clip = tte.clip_factors(norm_, max_norm)
        if norm == "above":   # the clip's division rounds otherwise than a reciprocal
            assert _recip_differs(grads[0], float(norm_))
        g_kernel = [g.clone() for g in grads]
        before = dict(fused.LAUNCHES)
        kernel.step(g_kernel, lr, clip=clip)
        assert fused.LAUNCHES["adamw_fused"] == before["adamw_fused"] + 1
        assert all(_bits_equal(a, b) for a, b in zip(g_kernel, grads))   # read only
        opts["chunked"]._step_foreach([g.clone() for g in grads], lr, clip=clip)
        g_ref = [g.clone() for g in grads]
        clip_by_global_norm_sharded_(g_ref, sharded, max_norm, model_group)
        opts["one_pass"]._step_unchunked(g_ref, lr)
        torch.cuda.synchronize()
        for name in ("chunked", "one_pass"):
            for x, y in ((kernel.params, opts[name].params), (kernel.mu, opts[name].mu),
                         (kernel.nu, opts[name].nu)):
                for i, (a, b) in enumerate(zip(x, y)):
                    assert _bits_equal(a, b), (step, name, i, (a - b).abs().max())
    # the bias corrections' products by a reciprocal round otherwise than a
    # true division here
    assert _recip_differs(kernel.mu[0], float(np.float32(1) - np.float32(0.9) ** np.float32(STEPS)))
    assert not _bits_equal(kernel.params[0].cpu(), p0[0].cpu())


@pytest.mark.cuda
def test_foreach_divisions_round_as_the_kernel(cuda_device):
    """Each division the foreach path makes, on values where a true
    division and a multiply by the f32 reciprocal differ, rounds on the
    card as the kernel rounds it: by a host scalar (the bias corrections)
    the product by the f32 reciprocal, which the kernel is given; by a
    list (the update by its denominator) and by a device scalar (the clip)
    the correctly rounded quotient, the kernel's ``__fdiv_rn``; the square
    root correctly rounded, the kernel's ``__fsqrt_rn``."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1 << 16, generator=gen)
    y = torch.rand(1 << 16, generator=gen) + 0.5
    b = float(np.float32(1) - np.float32(0.999) ** np.float32(3))
    true_b, true_y = (x.double() / b).float(), (x.double() / y.double()).float()
    recip_b = x * torch.tensor(np.float32(1) / np.float32(b))
    assert not torch.equal(true_b, recip_b) and not torch.equal(true_y, x * (1 / y))
    xd, yd = x.to(cuda_device), y.to(cuda_device)
    by_scalar, = torch._foreach_div([xd], b)
    assert torch.equal(by_scalar.cpu(), recip_b)
    by_list, = torch._foreach_div([xd], [yd])
    assert torch.equal(by_list.cpu(), true_y)
    by_tensor = [xd.clone()]
    torch._foreach_div_(by_tensor, torch.tensor(b, dtype=torch.float32, device=cuda_device))
    assert torch.equal(by_tensor[0].cpu(), true_b)
    root, = torch._foreach_sqrt([yd])
    assert torch.equal(root.cpu(), y.double().sqrt().float())


@pytest.mark.cuda
@pytest.mark.parametrize("odd", ["float64", "transposed_grad", "cpu_moment"])
def test_a_card_step_refuses_what_the_kernel_cannot_take(odd, cuda_device):
    """A step on the card over a tensor the kernel cannot take raises,
    naming it, and changes nothing: there is no foreach path on the card."""
    dtype = torch.float64 if odd == "float64" else torch.float32
    opt = tte.OptaxAdamW([torch.ones(4, 3, dtype=dtype, device=cuda_device)], [True], 0.1)
    grad = torch.ones(4, 3, dtype=dtype, device=cuda_device)
    if odd == "transposed_grad":
        grad = torch.ones(3, 4, device=cuda_device).t()
    if odd == "cpu_moment":
        opt.nu[0] = opt.nu[0].cpu()
    before = dict(fused.LAUNCHES)
    with pytest.raises(ValueError, match=r"\[0\] is "):
        opt.step([grad], LR)
    assert fused.LAUNCHES == before
    assert torch.equal(opt.params[0], torch.ones_like(opt.params[0]))
