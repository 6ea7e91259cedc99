"""The host-table and verified paths on the card against the same code on
the CPU.

The ``cuda`` tests need an NVIDIA GPU and nvcc and skip without them. On
the card run ``python -m pytest tests/test_torch_card_paths.py -m cuda
--noconftest``: this file imports torch and the port only (``tests/
conftest.py`` imports jax, which the card's machine does not have).

* The prefetcher's pinned staging slots and side stream: every batch
  arrives equal to its source, also once its slot has been refilled.
* The host-table trainer on the card (the BPR kernels, one launch each a
  step) against the same run on the CPU (the twins), prefetch 0, dropout
  0, sgd rows: per-epoch losses within 1e-4 relative and tables within
  1e-4 (3xTF32 products and f32 sums in other orders through 2 epochs).
* The certified top-k on the card: values within C.22's bound of the
  exact top-k, for both methods, with no escalation.
* The CTR table's sparse update on the card (``index_add_`` adds
  duplicates in no fixed order) against the CPU: touched rows within C.22's
  bound over their terms, untouched rows bit-equal; and three CTR trainer
  steps on the card against the CPU from the same params and batches, in
  both table modes, within ``chip_smoke.ctr_card_vs_cpu``'s bound: each
  tensor's L2 distance from the CPU's within 5 % of its move, the losses
  within 1e-6 relative.
"""
import json

import numpy as np
import pytest
import torch

from recommendit_tpu_torch.config import Settings, settings
from recommendit_tpu_torch.data.ctr import make_ctr_dataset
from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
from recommendit_tpu_torch.ops import bpr, sparse_embed, topk
from recommendit_tpu_torch.training.host_table import PrefetchIterator
from recommendit_tpu_torch.training.host_train import HostTableEmbeddingTrainer
from recommendit_tpu_torch.training.train_ctr import CTRTrainer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetch_on_the_card(cuda_device, depth):
    rng = np.random.default_rng(depth)
    src = [(np.array([n]), {"r": rng.normal(size=(256, 64)).astype(np.float32),
                            "i": rng.integers(0, 99, 256).astype(np.int32)})
           for n in range(12)]
    got = list(PrefetchIterator(iter(src), depth=depth, device=cuda_device, keep=(0,)))
    torch.cuda.synchronize()
    assert len(got) == 12
    for (ids, rows), (want_ids, want) in zip(got, src):
        assert ids is want_ids
        assert rows["r"].device.type == "cuda" and rows["i"].dtype == torch.int32
        np.testing.assert_array_equal(rows["r"].cpu().numpy(), want["r"])
        np.testing.assert_array_equal(rows["i"].cpu().numpy(), want["i"])


@pytest.mark.cuda
def test_host_trainer_on_the_card_matches_the_cpu(cuda_device):
    data = make_synthetic_movielens(200, 150, 12_000, seed=2)
    cfg = Settings(EMBEDDING_DIM=32, HIDDEN_DIM=48, BATCH_SIZE=256, TRAIN_EPOCHS=2,
                   DROPOUT=0.0, LOSS_MODE="in_batch", HOST_TABLE=True,
                   HOST_TABLE_OPTIMIZER="sgd", HOST_TABLE_LR=0.1,
                   HOST_TABLE_PREFETCH=0, SEED=5)
    runs = {}
    for dev in ("cpu", cuda_device):
        tr = HostTableEmbeddingTrainer(data, cfg, model_output_path="", device=dev)
        before = dict(bpr.LAUNCHES)
        tr.train()
        runs[torch.device(dev).type] = (tr, {k: bpr.LAUNCHES[k] - before[k]
                                             for k in before})
    (cpu, cpu_launches), (card, card_launches) = runs["cpu"], runs["cuda"]
    steps = sum(h["steps"] for h in card.history)
    assert cpu_launches == {"bpr_fwd": 0, "bpr_bwd": 0}
    assert card_launches == {"bpr_fwd": steps, "bpr_bwd": steps}
    np.testing.assert_allclose([h["loss"] for h in card.history],
                               [h["loss"] for h in cpu.history], rtol=1e-4)
    for side in ("user_table", "item_table"):
        np.testing.assert_allclose(getattr(card, side).table, getattr(cpu, side).table,
                                   rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["count", "bound"])
@pytest.mark.parametrize("n_q", [1, 64])
def test_certified_on_the_card(cuda_device, method, n_q):
    g = torch.Generator().manual_seed(n_q)
    items = torch.nn.functional.normalize(torch.randn(300_000, 40, generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(n_q, 40, generator=g), dim=1)
    items, q = items.to(cuda_device), q.to(cuda_device)
    before = dict(topk.ESCALATIONS)
    v, i = topk.mips_topk_certified(q, items, 100, method=method, canonical=True)
    ev, ei = topk.canonical_tie_order(*topk.mips_topk(q, items, 100, mode="exact"))
    assert topk.ESCALATIONS == before
    bound = 2 * 39 * 2.0 ** -24 * (q.abs()[:, None, :] * items[ei].abs()).sum(-1)
    assert bool(((v - ev).abs() <= bound).all())
    true = (items[i].double() * q.double()[:, None, :]).sum(-1)
    assert bool(((true - ev.double()).abs() <= 2 * bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("vocab", [(5000, 300, 7, 4097), (26, 20000, 97, 5000)])
def test_sparse_table_update_on_the_card(cuda_device, vocab):
    rng = np.random.default_rng(len(vocab))
    b, d = 4096, 16
    offs = np.concatenate([[0], np.cumsum(vocab)[:-1]])
    raw = np.stack([rng.integers(0, v, size=b) for v in vocab], 1)
    raw[1:33] = raw[0]                                  # duplicates in every field
    ids = torch.tensor(raw + offs[None, :])
    grads = torch.tensor(rng.standard_normal((b, len(vocab), d)).astype(np.float32))
    table = torch.tensor(rng.standard_normal((sum(vocab), d)).astype(np.float32))
    accum = torch.tensor((rng.random(sum(vocab)) * 0.5).astype(np.float32))
    cpu = [t.clone() for t in (table, accum)]
    card = [t.to(cuda_device) for t in (table, accum)]
    sparse_embed.sparse_table_update(*cpu, ids, grads, vocab)
    sparse_embed.sparse_table_update(*card, ids.to(cuda_device), grads.to(cuda_device), vocab)
    got_t, got_a = (t.cpu().double() for t in card)
    want_t, want_a = (t.double() for t in cpu)
    k = torch.zeros(sum(vocab), dtype=torch.float64).index_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), dtype=torch.float64))
    g_abs = torch.zeros(sum(vocab), d, dtype=torch.float64).index_add_(
        0, ids.reshape(-1), grads.reshape(-1, d).double().abs())
    scale = 0.05 / (want_a.sqrt() + 1e-8)
    eps = 2.0 ** -24
    t_tol = 2 * (k + 1)[:, None] * eps * (table.double().abs() + scale[:, None] * g_abs)
    a_tol = 2 * (k + 1) * eps * (accum.double() + 3 * (g_abs ** 2).mean(1))
    assert bool(((got_t - want_t).abs() <= t_tol).all())
    assert bool(((got_a - want_a).abs() <= a_tol).all())
    untouched = k == 0
    assert bool(untouched.any())
    assert torch.equal(card[0].cpu()[untouched], table[untouched])
    assert torch.equal(card[1].cpu()[untouched], accum[untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_ctr_steps_on_the_card_match_the_cpu(cuda_device, mode):
    import chip_smoke

    data = make_ctr_dataset(n_examples=20_000, n_users=2_000, n_items=500, seed=3)
    cfg = settings.replace(CTR_BATCH_SIZE=2048, CTR_TABLE_UPDATE=mode, SEED=3)
    rec = chip_smoke.ctr_card_vs_cpu(data, cfg, cuda_device, 3, steps=3)
    print(json.dumps(rec))                  # shown with -rP
    assert ("accum" in rec["tensors"]) is (mode == "sparse")
    assert rec["tensors"]["embed"]["max_move"] > 0
    assert all(t["rel_l2"] <= chip_smoke.CTR_REL_L2 for t in rec["tensors"].values())
