"""DLRM-DCNv2 on the port (``models/ctr.py``'s ``CTRArch``,
``training/train_ctr.dcn_step``) against the plain reference
(``perfbench/reference/dlrm_dcnv2_train.py``, in float32), on the CPU at a
small size: 26 fields of at most 1,000 rows, short bags, rows of 16.

The forward's loss, the dense gradients and two steps of Adagrad (the
dense params, the table and every accumulator); ids repeated within a bag
and across bags, and a one-row field whose row every example names; the
preset's published shape; and the benchmark's cell at a small size:
correct, and its two faults (TF32 products, the update without
deduplication) refused by its checks.

Adagrad's first step from a zero accumulator is lr · g / (|g| + eps): where
a gradient element nears 0 by cancellation its step swings with rounding,
so the params are compared by the norm of their change, the gradients and
accumulators element by element.
"""
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference import dlrm_dcnv2_train as R
from recommendit_tpu_torch.models import ctr
from recommendit_tpu_torch.training.train_ctr import AdagradRecipe, DCNState, dcn_step

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 27
BAGS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 20, 27, 10, 3, 1, 1)


def small_arch(vocab=None) -> ctr.CTRArch:
    rng = np.random.default_rng(7)
    if vocab is None:
        vocab = tuple(int(v) for v in rng.integers(2, 1000, 26))
        vocab = (1,) + vocab[1:]          # a one-row field
    return ctr.CTRArch(vocab_sizes=vocab, embed_dim=16, bag_sizes=BAGS, cross_layers=3,
                       cross_rank=8, bottom=(32, 24), top=(64, 48, 32))


def batch(arch, rng, b=64, local=None):
    lay = arch.layout
    if local is None:
        local = np.stack([rng.integers(0, arch.vocab_sizes[f], b) for f in lay.slot_field], 1)
    ids = torch.as_tensor(lay.stack(local))
    dense = torch.log1p(torch.as_tensor(rng.exponential(10.0, (b, 13)), dtype=torch.float32))
    labels = torch.as_tensor(rng.random(b) < 0.25, dtype=torch.float32)
    return dense, ids, labels


def rel(a, b, base=None):
    base = 0 if base is None else base
    return float((a - b).detach().norm() / (b - base).detach().norm())


def _two_steps(arch, batches):
    params = ctr.init_dcn_params(torch.Generator().manual_seed(3), arch, "cpu")
    p0 = {k: v.clone() for k, v in params.items()}
    ref = R.Reference({k: v.clone() for k, v in params.items()}, arch.bag_sizes)
    st = DCNState(params, arch, AdagradRecipe())
    out = []
    for dense, ids, labels in batches:
        keep = {}
        loss = dcn_step(st, dense, ids, labels, keep)
        want_loss, want_grads = ref.step(dense, ids, labels)
        out.append((float(loss), want_loss, keep["dense_grads"], want_grads))
    return st, ref, p0, out


def test_forward_loss_grads_and_two_adagrad_steps():
    arch = small_arch()
    rng = np.random.default_rng(11)
    batches = [batch(arch, rng), batch(arch, rng)]
    st, ref, p0, out = _two_steps(arch, batches)
    names = [k for k in st.params if k != "embed"]
    for loss, want_loss, grads, want in out:
        assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
        for k, g in zip(names, grads):
            torch.testing.assert_close(g, want[k], rtol=1e-4, atol=1e-7)
    for i, k in enumerate(names):
        torch.testing.assert_close(st.dense_acc[i], ref.acc[k], rtol=1e-4, atol=1e-12)
        assert rel(st.params[k], ref.p[k], p0[k]) < 1e-4, k
    torch.testing.assert_close(st.table_acc, ref.acc["embed"], rtol=1e-4, atol=1e-12)
    assert rel(st.table, ref.p["embed"], p0["embed"]) < 1e-4
    assert int(st.rows_updated) == sum(torch.unique(b[1]).numel() for b in batches)


def test_duplicates_within_and_across_bags_and_a_one_row_field():
    """Every id of field 20's bag names one row, field 21's bags name rows
    of a 3-row field, the one-row field's row is in every example: each row's
    gradient is the sum over all of its slots."""
    vocab = (1,) + (50,) * 19 + (40, 3) + (50,) * 4
    arch = small_arch(vocab)
    lay = arch.layout
    rng = np.random.default_rng(5)
    local = np.stack([rng.integers(0, arch.vocab_sizes[f], 32) for f in lay.slot_field], 1)
    a, e = lay.bag_start[20], lay.bag_start[21]
    local[:, a:e] = 7
    st, ref, p0, out = _two_steps(arch, [batch(arch, rng, 32, local)])
    (loss, want_loss, _, _), = out
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    hot = int(lay.offsets[20]) + 7
    for row in (0, hot, int(lay.offsets[21]) + 1):
        torch.testing.assert_close(st.table_acc[row], ref.acc["embed"][row], rtol=1e-4,
                                   atol=1e-12)
        assert float(st.table_acc[row].abs().sum()) > 0
    assert rel(st.table, ref.p["embed"], p0["embed"]) < 1e-4
    # rows no id named are as they were
    named = torch.zeros(lay.rows, dtype=torch.bool)
    named[torch.as_tensor(lay.stack(local)).reshape(-1)] = True
    assert torch.equal(st.table[~named], p0["embed"][~named])
    assert int(st.rows_updated) == int(named.sum())


def test_preset_is_the_published_shape():
    a = ctr.DLRM_DCNV2
    assert a.layout.rows == 204_184_588 and a.layout.slots == 214
    assert a.cross_width == 3456 and a.embed_dim == 128
    small = dataclasses.replace(a, vocab_sizes=(1,) * 26)
    p = ctr.init_dcn_params(torch.Generator().manual_seed(0), small, "cpu")
    assert sum(v.numel() for k, v in p.items() if k != "embed") == 16_044_545
    assert p["cross_v1"].shape == (3456, 512) and p["cross_w3"].shape == (512, 3456)
    assert [p[f"top_w{i}"].shape[1] for i in range(1, 6)] == [1024, 1024, 512, 256, 1]
    assert [p[f"bot_w{i}"].shape[1] for i in range(1, 4)] == [512, 256, 128]
    cfg = json.loads((ROOT / "perfbench/configs/dlrm-dcnv2-rank.json").read_text())
    assert tuple(cfg["published_vocab_sizes"]) == a.vocab_sizes
    assert tuple(cfg["bag_sizes"]) == a.bag_sizes
    assert (cfg["embed_dim"], cfg["cross_layers"], cfg["cross_rank"]) == (128, 3, 512)
    assert tuple(cfg["bottom"]) == a.bottom and tuple(cfg["top"]) == a.top
    held = [v if v <= 65536 else -(-v // 4) for v in a.vocab_sizes]
    assert cfg["vocab_sizes"] == held and sum(held) == 51_137_046


def test_arch_refuses_a_cross_net_without_layers_and_bags_of_another_count():
    with pytest.raises(ValueError, match="cross net"):
        dataclasses.replace(small_arch(), cross_layers=0)
    with pytest.raises(ValueError, match="cross net"):
        dataclasses.replace(small_arch(), cross_rank=0)
    with pytest.raises(ValueError, match="bag sizes"):
        dataclasses.replace(small_arch(), bag_sizes=BAGS[:-1]).layout


def test_init_dcn_params_are_torchrecs_initialisers():
    """Each field's rows within 1/√rows, each linear layer within 1/√in,
    the cross net's V and W Xavier-normal, its bias zero."""
    arch = small_arch()
    p = ctr.init_dcn_params(torch.Generator().manual_seed(1), arch, "cpu")
    for f, (off, n) in enumerate(zip(arch.layout.offsets, arch.vocab_sizes)):
        assert float(p["embed"][off:off + n].abs().max()) <= 1 / np.sqrt(n)
    for k, w in p.items():
        if k[:5] in ("bot_w", "top_w"):
            lim = 1 / np.sqrt(w.shape[0])
            assert float(w.abs().max()) <= lim
            assert float(p[k.replace("_w", "_b")].abs().max()) <= lim
    std = np.sqrt(2.0 / (arch.cross_width + arch.cross_rank))
    for li in range(1, arch.cross_layers + 1):
        assert not p[f"cross_b{li}"].any()
        for k in (f"cross_v{li}", f"cross_w{li}"):
            assert abs(float(p[k].std()) / std - 1) < 0.2, k


# --- the benchmark's cell at a small size ------------------------------------ #

TINY_CFG = {"vocab_sizes": list(small_arch().vocab_sizes), "embed_dim": 16,
            "bottom": [32, 24], "cross_layers": 2, "cross_rank": 8, "top": [64, 32],
            "bag_sizes": list(BAGS)}


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    from perfbench.spec import load_cell
    from perfbench.tests.tiny import tiny_root

    root = tiny_root(tmp_path_factory.mktemp("bench") / "b")
    path = root / "perfbench/configs/dlrm-dcnv2-rank.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY_CFG)
    path.write_text(json.dumps(cfg))
    return load_cell("dlrm-dcnv2-train", root)


def test_benchmark_cell_is_correct_and_reads_its_metrics(tiny_cell):
    from perfbench.run import run_cell

    r = run_cell(tiny_cell, SEED, 0.3, False, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"loss_err", "grad_gap", "table_delta_gap", "accum_gap"}
    assert {"train_examples_per_s", "setup_s"} <= set(r["metrics"])
    r = run_cell(tiny_cell, SEED, 0.3, True, "cpu", time.perf_counter())
    assert r["correct"] and "dlrm.mfu" in r["metrics"]


@pytest.mark.parametrize("what", ["control", "dedup"])
def test_benchmark_checks_refuse_the_faults(tiny_cell, what):
    from perfbench import ctr_control, judge

    nums = ctr_control.control_numbers(tiny_cell, SEED, "cpu", what)
    assert not judge.passed(judge.checks(nums, tiny_cell.config["checks"])), nums
