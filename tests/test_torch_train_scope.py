"""The port's ``train_scope_bench`` (``recommendit_tpu_torch/scripts/
train_scope_bench.py``) against JAX's script (``scripts/
train_scope_bench.py``), on the CPU at a tiny size (60 users x 40 items x
1,500 ratings, 3 epochs, in-batch BPR).

JAX's script trains at ML-1M shape only, so it is not run here: its
printed keys are read from its syntax tree (the dict its ``main`` dumps),
and the port's line must carry exactly those keys, in that order, then
``scope_applies`` (false: the port's trainer has one scope). Its numbers
are the trainer's ``history``'s, exactly.
"""
import ast
import json
from pathlib import Path

import numpy as np
import pytest

from recommendit_tpu_torch.scripts import train_scope_bench

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(n_users=60, n_items=40, n_ratings=1500)
CFG = ["LOSS_MODE=in_batch", "BATCH_SIZE=64", "EMBEDDING_DIM=8", "HIDDEN_DIM=16"]


def _jax_keys():
    tree = ast.parse((ROOT / "scripts" / "train_scope_bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    dumped = [n.args[0] for n in ast.walk(main) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps"]
    assert len(dumped) == 1 and isinstance(dumped[0], ast.Dict)
    return [k.value for k in dumped[0].keys]


@pytest.fixture(scope="module")
def line():
    return train_scope_bench.run("step", 3, CFG, "cpu", **TINY)


def test_line_keys_are_jax_s(line, capsys):
    want = _jax_keys()
    assert want[:2] == ["scope", "epochs"] and len(want) == 6
    assert list(line)[:-1] == want + ["scope_applies"]
    assert line["scope_applies"] is False


def test_line_numbers_come_from_the_history(line):
    hist = line["history"]
    assert len(hist) == 3 and line["epochs"] == 3 and line["scope"] == "step"
    steady = [h["examples_per_s"] for h in hist[1:]]
    assert line["ex_s_epoch1_incl_compile"] == round(hist[0]["examples_per_s"])
    assert line["ex_s_steady_mean"] == round(float(np.mean(steady)))
    assert line["ex_s_steady_max"] == round(float(np.max(steady)))
    assert line["total_s"] >= 0 and all(h["steps"] > 0 for h in hist)


def test_printed_line_and_positional_args(capsys):
    args = train_scope_bench.parse_args(["epoch", "2", "--cfg", "LOSS_MODE=in_batch",
                                         "--device", "cpu"])
    assert (args.scope, args.epochs, args.cfg) == ("epoch", 2, ["LOSS_MODE=in_batch"])
    defaults = train_scope_bench.parse_args([])
    assert (defaults.scope, defaults.epochs) == ("chunk", 5)
    train_scope_bench.run("epoch", 2, CFG, "cpu", **TINY)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "platform: cpu"
    printed = json.loads(out[-1])
    assert list(printed) == _jax_keys() + ["scope_applies"] and printed["epochs"] == 2
