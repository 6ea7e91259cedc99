"""The program's spans (``utils/profiling.span``): which spans each path
opens and how they nest, under ``torch.profiler`` on the CPU; that every
span the source opens is in ``SPANS`` and every name there is opened;
that no module of the port opens a profiler range any other way; and that
with no profiler running a span is the one shared null context."""
import ast
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from recommendit_tpu_torch.utils import profiling
from recommendit_tpu_torch.utils.profiling import SPANS, span

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "recommendit_tpu_torch"
SEED = 2**31 + 77


def _sources():
    return [p for p in sorted(PKG.rglob("*.py")) if "build" not in p.relative_to(PKG).parts]


def span_tree(prof) -> Counter:
    """(span, innermost enclosing span or None) of every program span the
    profiler recorded, counted."""
    out = Counter()
    for e in prof.events():
        if e.name not in SPANS:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name not in SPANS:
            parent = parent.cpu_parent
        out[(e.name, None if parent is None else parent.name)] += 1
    return out


def test_no_profiler_no_range():
    """With no profiler running, every span is the one shared null context;
    under one, a ``record_function`` of its name."""
    assert span("serve.batch") is span("train.step") is profiling._NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        s = span("serve.batch")
        assert isinstance(s, torch.profiler.record_function) and s.name == "serve.batch"
    assert span("serve.batch") is profiling._NO_SPAN


def test_the_source_opens_exactly_spans():
    """Each ``span("…")`` in the port names an entry of SPANS, each entry is
    opened somewhere, and SPANS holds no name twice."""
    opened = set()
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "span"):
                assert isinstance(node.args[0], ast.Constant), f"{path}: {ast.dump(node)}"
                opened.add(node.args[0].value)
    assert opened == set(SPANS)
    assert len(SPANS) == len(set(SPANS))


def test_no_ungated_profiler_range():
    """``record_function`` is opened only by ``span``."""
    users = [p.relative_to(PKG).as_posix() for p in _sources()
             if any(isinstance(n, (ast.Name, ast.Attribute))
                    and getattr(n, "id", getattr(n, "attr", None)) == "record_function"
                    for n in ast.walk(ast.parse(p.read_text())))]
    assert users == ["utils/profiling.py"]


# --- serve_batch, on the exact engine and the fused route's CPU twin ------ #

SERVE_TREE = Counter({
    ("serve.batch", None): 1, ("serve.tower", "serve.batch"): 1,
    ("serve.retrieve", "serve.batch"): 1, ("retrieve.score", "serve.retrieve"): 1,
    ("retrieve.select", "serve.retrieve"): 1, ("rank.features", "serve.batch"): 2,
    ("rank.select", "serve.batch"): 2, ("rank.scorer", "serve.batch"): 1,
})


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    from perfbench.tests.tiny import tiny_root

    return tiny_root(tmp_path_factory.mktemp("bench") / "b")


@pytest.fixture(scope="module", params=["serve1m-exact-b1024", "serve1m-b4096"])
def pipe(request, tiny_bench):
    """A small pipeline over the benchmark's serve configuration: the exact
    f32 index, or the fused bf16 index (the window kernel's route, its twin
    on the CPU)."""
    from perfbench.spec import load_cell
    from perfbench.systems.serve import Session

    return Session(load_cell(request.param, tiny_bench), SEED, "cpu").pipe


def test_serve_batch_spans(pipe):
    users = torch.arange(1, 61)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.serve_batch(users)
    assert span_tree(prof) == SERVE_TREE


def test_serve_rows_copy_span(pipe):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ids, _, _ = pipe._serve_rows([1, 2, 3])
    tree = span_tree(prof)
    assert tree[("serve.copy", None)] == 1 and tree[("serve.batch", None)] == 1
    assert ids.shape == (3, pipe._k_out)


def test_exact_engine_blocks_prune_and_merge(monkeypatch):
    """Three column blocks wide enough for window-max pruning: each block
    scored, pruned and reduced, and merged into the running top-k."""
    from recommendit_tpu_torch.ops import topk

    monkeypatch.setattr(topk, "_SCORE_BUDGET", 32 * 9 * topk._REDUCE_CHUNK)
    g = torch.Generator().manual_seed(3)
    q, items = torch.randn(32, 8, generator=g), torch.randn(300_000, 8, generator=g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vals, idx = topk.mips_topk(q, items, 50)
    assert span_tree(prof) == Counter({("retrieve.score", None): 3,
                                       ("retrieve.prune", None): 3,
                                       ("retrieve.select", None): 6})
    want = torch.topk(q @ items.T, 50).values
    assert torch.allclose(vals, want, atol=1e-5) and idx.shape == (32, 50)


# --- the sharded step, world size 1 -------------------------------------- #

_STEP = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from recommendit_tpu_torch.models.two_tower import N_GENRES, init_params
from recommendit_tpu_torch.parallel import mesh as pm
from recommendit_tpu_torch.parallel.train import init_sharded_state, make_sharded_train_step
sys.path.insert(0, sys.argv[2])
from test_torch_spans import span_tree
pm.distributed_init("file://" + sys.argv[1], 1, 0, device="cpu")
mesh = pm.create_mesh((1, 1))
g = torch.Generator().manual_seed(0)
tx = pm.AdamW(1e-3, 1e-4, 1.0)
params, state = init_sharded_state(mesh, tx, init_params(g, 30, 20, 8, 16, device="cpu"))
params = {k: v.requires_grad_(True) for k, v in params.items()}
genre = (torch.rand(21, N_GENRES, generator=g) > 0.7).float()
step = make_sharded_train_step(mesh, tx, genre)
batch = (torch.randint(1, 31, (16,), generator=g), torch.randint(1, 21, (16,), generator=g))
step(params, state, batch)
with profile(activities=[ProfilerActivity.CPU]) as prof:
    step(params, state, batch)
print(json.dumps(sorted([list(k) + [v] for k, v in span_tree(prof).items()], key=str)))
torch.distributed.destroy_process_group()
"""


def test_sharded_step_spans(tmp_path):
    out = subprocess.run([sys.executable, "-c", _STEP, str(tmp_path / "store"),
                          str(Path(__file__).parent)],
                         capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    got = Counter({(a, b): n for a, b, n in json.loads(out.stdout.strip().splitlines()[-1])})
    assert got == Counter({
        ("train.step", None): 1, ("train.forward", "train.step"): 1,
        ("train.lookup", "train.forward"): 1, ("train.backward", "train.step"): 1,
        ("train.optim", "train.step"): 1, ("train.clip", "train.optim"): 1,
        ("train.adamw", "train.optim"): 1})


# --- the CTR family's ranges --------------------------------------------- #

def test_ctr_ranges_appear_under_a_profiler():
    from recommendit_tpu_torch.config import settings
    from recommendit_tpu_torch.data.ctr import make_ctr_dataset
    from recommendit_tpu_torch.training.train_ctr import CTRTrainer

    data = make_ctr_dataset(n_examples=3000, n_users=60, n_items=40, seed=7)
    cfg = settings.replace(CTR_BATCH_SIZE=256, CTR_EMBED_DIM=8, CTR_RETRIEVAL_DIM=8,
                           CTR_TOP_HIDDEN=(16,))
    tt = CTRTrainer(data, cfg=cfg, joint=True, device="cpu")
    state = tt.start()
    batches = tt.epoch_batches(np.random.default_rng(0), tt.batch_size())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tt.step(state, [b[0] for b in batches], decay_steps=20)
    names = {name for name, _ in span_tree(prof)}
    assert names == {n for n in SPANS if n.startswith("ctr::")}
