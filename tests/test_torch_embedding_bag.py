"""The multi-hot bags and the table's exact Adagrad (``ops/embedding_bag.py``,
``csrc/embedding_bag.cu``).

On the CPU: the plain versions against their definitions written out
(every bag summed row by row; each distinct row's gradient summed over
its slots, then ``acc += g²; w -= lr · g / (√acc + eps)``), duplicates
within and across bags, a one-row field, rows no id touches left as they
were; the layout's offsets and slots; the wrappers' refusals of what the
kernels cannot take, by tensors standing in for CUDA ones.

On the card (``cuda``; skipped without one): ``bag_fwd_kernel`` bit-equal
to the plain sum (the same additions in the same order), one launch a
call; the update kernels against the plain update on the card, at rows of
16 to 512 floats, with a row hit more than 100,000 times in one step
(its run crosses ~500 chunks of the sorted ids), rows no id touches
bit-equal to before, and the device counter of rows updated. Run them with
``python -m pytest tests/test_torch_embedding_bag.py -m cuda --noconftest``:
this file imports torch only.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from recommendit_tpu_torch.ops import embedding_bag as eb

LR, EPS = 0.005, 1e-8


def _layout(rng, n_fields=26, max_rows=1000, max_bag=5, one_row_field=True):
    vocab = [int(x) for x in rng.integers(1, max_rows, n_fields)]
    if one_row_field:
        vocab[0] = 1
    bags = [int(x) for x in rng.integers(1, max_bag + 1, n_fields)]
    return eb.BagLayout(tuple(vocab), tuple(bags))


def _ids(rng, layout, b, hot=None):
    """(b, S) stacked ids, field-local ids uniform; ``hot``: (field, local
    row) every id of that field's bag takes."""
    local = np.stack([rng.integers(0, layout.vocab_sizes[f], b) for f in layout.slot_field], 1)
    if hot is not None:
        f, r = hot
        a, e = layout.bag_start[f], layout.bag_start[f + 1]
        local[:, a:e] = r
    return torch.as_tensor(layout.stack(local))


# --- CPU: the definitions ---------------------------------------------------- #

def test_layout_offsets_and_slots():
    lay = eb.BagLayout((3, 1, 5), (2, 1, 3))
    assert lay.slots == 6 and lay.rows == 9 and lay.n_fields == 3
    assert lay.offsets.tolist() == [0, 3, 4]
    assert lay.bag_start.tolist() == [0, 2, 3, 6]
    assert lay.slot_field.tolist() == [0, 0, 1, 2, 2, 2]
    assert lay.stack([[2, 0, 0, 4, 4, 1]]).tolist() == [[2, 0, 3, 8, 8, 5]]
    with pytest.raises(ValueError, match="outside its field's 1 rows"):
        lay.stack([[0, 0, 1, 0, 0, 0]])
    with pytest.raises(ValueError):
        eb.BagLayout((3, 1), (2,))


def test_pool_plain_is_each_bag_summed():
    rng = np.random.default_rng(0)
    lay = _layout(rng)
    table = torch.randn(lay.rows, 16, generator=torch.Generator().manual_seed(0))
    ids = _ids(rng, lay, 32)
    ids[:, lay.bag_start[3]:lay.bag_start[4]] = ids[0, lay.bag_start[3]]   # duplicates
    out = eb.pool_bags(table, ids, lay)
    want = torch.stack([
        torch.stack([table[ids[b, lay.bag_start[f]:lay.bag_start[f + 1]]].double().sum(0)
                     for f in range(lay.n_fields)]) for b in range(32)]).float()
    assert out.shape == (32, lay.n_fields, 16)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    # one id a field: the row itself, exactly
    one = eb.BagLayout(lay.vocab_sizes, (1,) * lay.n_fields)
    ids1 = _ids(rng, one, 8)
    assert torch.equal(eb.pool_bags(table, ids1, one), table[ids1])


def _update_by_rows(table, acc, ids, grad, lay):
    """The definition row by row in float64: each distinct row's gradient
    summed over every slot that names it."""
    table, acc = table.double().clone(), acc.double().clone()
    sums = {}
    for b in range(ids.shape[0]):
        for s in range(ids.shape[1]):
            r = int(ids[b, s])
            sums[r] = sums.get(r, 0) + grad[b, lay.slot_field[s]].double()
    for r, g in sums.items():
        acc[r] += g * g
        table[r] -= LR * g / (torch.sqrt(acc[r]) + EPS)
    return table, acc, len(sums)


@pytest.mark.parametrize("acc0", ["zero", "warm"])
def test_update_plain_is_exact_adagrad_of_summed_rows(acc0):
    rng = np.random.default_rng(1)
    g = torch.Generator().manual_seed(1)
    lay = _layout(rng, max_rows=40, max_bag=4)
    table = torch.randn(lay.rows, 8, generator=g)
    acc = (torch.zeros_like(table) if acc0 == "zero"
           else torch.rand(table.shape, generator=g) + 0.5)
    ids = _ids(rng, lay, 24)        # 40-row fields: many ids repeat, within and across bags
    ids[:, 0] = 0                   # the one-row field
    grad = torch.randn(24, lay.n_fields, 8, generator=g)
    want_t, want_a, n_rows = _update_by_rows(table, acc, ids, grad, lay)
    counter = torch.zeros((), dtype=torch.int64)
    t, a = table.clone(), acc.clone()
    eb.bag_adagrad_(t, a, ids, grad, lay, LR, EPS, counter=counter)
    assert int(counter) == n_rows
    torch.testing.assert_close(a.double(), want_a, rtol=1e-5, atol=1e-6)
    if acc0 == "warm":      # from zero, the first step is sign-like where Σg nears 0
        torch.testing.assert_close(t.double(), want_t, rtol=1e-5, atol=1e-7)
    untouched = torch.ones(lay.rows, dtype=torch.bool)
    untouched[ids.reshape(-1)] = False
    assert untouched.any()
    assert torch.equal(t[untouched], table[untouched])
    assert torch.equal(a[untouched], acc[untouched])


def test_update_plain_from_zero_moves_each_touched_element_by_lr():
    """From a zero accumulator a row's first step is lr · g / (|g| + eps):
    lr in size wherever |g| ≫ eps."""
    rng = np.random.default_rng(2)
    lay = _layout(rng, max_rows=50)
    table = torch.randn(lay.rows, 8, generator=torch.Generator().manual_seed(2))
    acc = torch.zeros_like(table)
    ids = _ids(rng, lay, 16)
    grad = torch.randn(16, lay.n_fields, 8, generator=torch.Generator().manual_seed(3))
    t = table.clone()
    eb.bag_adagrad_(t, acc, ids, grad, lay, LR, EPS)
    moved = (t - table).abs()[torch.unique(ids.reshape(-1))]
    big = acc[torch.unique(ids.reshape(-1))].sqrt() > 1e-4
    torch.testing.assert_close(moved[big], torch.full_like(moved[big], LR), rtol=1e-3,
                               atol=0)


# --- CPU: what the kernels refuse -------------------------------------------- #

def _stand_in(shape, dtype=torch.float32, device="cuda:0", contiguous=True, ptr=0):
    strides = torch.empty(shape, device="meta").stride()
    if not contiguous:
        strides = tuple(reversed(strides))
    return SimpleNamespace(device=torch.device(device), dtype=dtype, shape=tuple(shape),
                           is_contiguous=lambda: contiguous, data_ptr=lambda: ptr,
                           stride=lambda: strides)


@pytest.mark.parametrize("role, change, message", [
    ("ids", {"dtype": torch.int64}, "ids is torch.int64"),
    ("grad", {"device": "cuda:1"}, "grad is on cuda:1"),
    ("table", {"device": "cpu"}, "table is on cpu"),
    ("grad", {"contiguous": False}, "grad is not contiguous"),
    ("acc", {"ptr": 8}, "acc is not 16-byte aligned"),
    ("acc", {"shape": (10, 8)}, "acc is of shape"),
])
def test_card_tensors_the_kernels_cannot_take_raise(role, change, message):
    roles = {"table": ((100, 16), torch.float32, (None, None)),
             "acc": ((100, 16), torch.float32, (100, 16)),
             "ids": ((4, 6), torch.int32, (4, 6)),
             "grad": ((4, 3, 16), torch.float32, (4, 3, 16))}
    named = []
    for name, (shape, dtype, want) in roles.items():
        kw = {"shape": shape, "dtype": dtype, **(change if name == role else {})}
        named.append((name, _stand_in(**kw), dtype, want))
    with pytest.raises(ValueError, match=message):
        eb._check(named)


def test_pooled_gradient_may_be_a_slice_of_wider_rows():
    """The interaction's input gradient sliced back to the pooled fields:
    each example's (F, D) block contiguous at a stride of its own."""
    wide = torch.zeros(4, 128 + 3 * 16)
    g = wide[:, 128:].reshape(4, 3, 16)
    assert not g.is_contiguous() and eb._rows_contiguous(g)
    assert not eb._rows_contiguous(torch.zeros(4, 16, 3).transpose(1, 2))
    assert not eb._rows_contiguous(torch.zeros(4, 2 + 3 * 16)[:, 2:].reshape(4, 3, 16))


def test_cpu_tensors_take_the_plain_path_and_rows_are_checked():
    assert not eb._check([("table", torch.zeros(3, 4), torch.float32, (None, None))])
    with pytest.raises(ValueError, match="multiple of 4"):
        eb._dim(torch.zeros(3, 6))
    with pytest.raises(ValueError, match="for 3 slots"):
        eb.pool_bags(torch.zeros(4, 4), torch.zeros(2, 2, dtype=torch.int32),
                     eb.BagLayout((2, 2), (1, 2)))


# --- on the card -------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [16, 128, 132, 512])
def test_bag_fwd_kernel_equals_the_plain_sum(cuda_device, dim):
    rng = np.random.default_rng(dim)
    lay = _layout(rng, max_rows=3000, max_bag=40)
    table = torch.randn(lay.rows, dim, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(dim))
    ids = _ids(rng, lay, 300).to(cuda_device, torch.int32)
    before = eb.LAUNCHES["bag_fwd"]
    out = eb.pool_bags(table, ids, lay)
    assert eb.LAUNCHES["bag_fwd"] == before + 1
    torch.cuda.synchronize()
    want = eb.pool_bags_plain(table, ids.long(), lay)
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dim, batch, hot", [
    (16, 64, None), (128, 700, None), (128, 4096, (5, 7)), (512, 300, (2, 1)),
])
def test_bag_update_kernels_against_the_plain_update(cuda_device, dim, batch, hot):
    """``hot`` = (field, row): every id of that field's bag names one row;
    at batch 4,096 with a bag of 32 that row is hit 131,072 times. The
    plain update in float64 on the card stands for the exact one; the
    kernels sum each row's gradients in f32 in another order, so (a) the
    accumulators' and the weights' changes lie within 1e-4 of it by norm
    (a sum of 131,072 f32 terms is good to ~2e-5), and (b) each accumulator
    lies within the f32 bound of a sum of n terms (1.01·n·2⁻²⁴·Σ|g_i| on
    the row's sum, then two roundings). The gradient is handed over as
    autograd hands it: a slice of wider rows."""
    rng = np.random.default_rng(dim + batch)
    gen = torch.Generator(cuda_device).manual_seed(batch)
    lay = _layout(rng, max_rows=5000, max_bag=8)
    if hot is not None:
        bags = list(lay.bag_sizes)
        bags[hot[0]] = 32
        lay = eb.BagLayout(lay.vocab_sizes, tuple(bags))
    table = torch.randn(lay.rows, dim, device=cuda_device, generator=gen)
    acc = torch.rand(lay.rows, dim, device=cuda_device, generator=gen) + 0.5
    ids = _ids(rng, lay, batch, hot).to(cuda_device)
    if hot is not None:
        assert int((ids == int(lay.offsets[hot[0]]) + hot[1]).sum()) >= (
            100_000 if batch == 4096 else 1)
    wide = torch.randn(batch, dim * (lay.n_fields + 1), device=cuda_device, generator=gen)
    grad = wide[:, dim:].reshape(batch, lay.n_fields, dim)
    t_k, a_k = table.clone(), acc.clone()
    counter = torch.zeros((), dtype=torch.int64, device=cuda_device)
    before = eb.LAUNCHES["bag_update"]
    eb.bag_adagrad_(t_k, a_k, ids.to(torch.int32), grad, lay, LR, EPS, counter=counter)
    assert eb.LAUNCHES["bag_update"] == before + 1
    torch.cuda.synchronize()
    t64, a64 = table.double(), acc.double()
    eb.bag_adagrad_plain_(t64, a64, ids, grad.double(), lay, LR, EPS)
    touched = torch.unique(ids.reshape(-1))
    assert int(counter) == touched.numel()

    def rel(x, want, base):
        return float((x.double() - want).norm() / (want - base.double()).norm())

    assert rel(a_k, a64, acc) <= 1e-4 and rel(t_k, t64, table) <= 1e-4
    # (b): Σ|g_i| and n a row, in float64
    absum = torch.zeros_like(a64)
    eb.bag_adagrad_plain_(torch.zeros_like(t64), absum, ids, grad.double().abs(), lay,
                          LR, EPS)        # acc += (Σ|g_i|)²
    n = torch.bincount(ids.reshape(-1), minlength=lay.rows).double()[:, None]
    g64 = (a64 - acc.double()).sqrt()
    err = 1.01 * n * 2.0**-24 * absum.sqrt()
    bound = 2 * g64 * err + err * err + 2.0**-23 * (a64 + 2 * g64 * err + err * err)
    assert bool(((a_k.double() - a64).abs() <= bound + 1e-30).all())
    untouched = torch.ones(lay.rows, dtype=torch.bool, device=cuda_device)
    untouched[touched] = False
    assert torch.equal(t_k[untouched], table[untouched])
    assert torch.equal(a_k[untouched], acc[untouched])


@pytest.mark.cuda
def test_bag_update_rows_hit_once_are_bit_equal(cuda_device):
    """A row hit once sums one gradient row: the kernel's update of it is
    the plain update bit for bit (the same roundings), from zero too."""
    lay = eb.BagLayout((5000, 3000), (2, 1))
    b = 1000
    ids = torch.cat([torch.randperm(5000)[:2 * b].view(b, 2),
                     5000 + torch.randperm(3000)[:b, None]], 1).to(cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(9)
    table = torch.randn(lay.rows, 128, device=cuda_device, generator=gen)
    acc = torch.zeros_like(table)
    grad = torch.randn(b, 2, 128, device=cuda_device, generator=gen)
    t_k, a_k, t_p, a_p = table.clone(), acc.clone(), table.clone(), acc.clone()
    eb.bag_adagrad_(t_k, a_k, ids.to(torch.int32), grad, lay, LR, EPS)
    eb.bag_adagrad_plain_(t_p, a_p, ids, grad, lay, LR, EPS)
    assert torch.equal(a_k, a_p) and torch.equal(t_k, t_p)


@pytest.mark.cuda
def test_kernels_refuse_int64_ids_on_the_card(cuda_device):
    lay = eb.BagLayout((10, 10), (1, 1))
    table = torch.zeros(20, 16, device=cuda_device)
    with pytest.raises(ValueError, match="ids is torch.int64"):
        eb.pool_bags(table, torch.zeros(2, 2, dtype=torch.int64, device=cuda_device), lay)
