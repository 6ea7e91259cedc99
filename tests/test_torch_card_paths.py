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
"""
import numpy as np
import pytest
import torch

from recommendit_tpu_torch.config import Settings
from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
from recommendit_tpu_torch.ops import bpr, topk
from recommendit_tpu_torch.training.host_table import PrefetchIterator
from recommendit_tpu_torch.training.host_train import HostTableEmbeddingTrainer


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
    ev, ei = topk.canonical_tie_order(*topk.mips_topk(q, items, 100, "exact"))
    assert topk.ESCALATIONS == before
    bound = 2 * 39 * 2.0 ** -24 * (q.abs()[:, None, :] * items[ei].abs()).sum(-1)
    assert bool(((v - ev).abs() <= bound).all())
    true = (items[i].double() * q.double()[:, None, :]).sum(-1)
    assert bool(((true - ev.double()).abs() <= 2 * bound).all())
