"""The port's multi-process drivers on gloo ranks, on the CPU:
``scripts/multiproc_smoke.py`` (2 ranks: the sharded two-tower and CTR
steps, both merges, the serve path against world size 1, and the CTR
checkpoint resumed across a restart of the process group),
``parallel/dryrun.dryrun_multichip`` (4 ranks) and
``scripts/scale_smoke.py`` (2 ranks, rows capped)."""
import json

import numpy as np
import pytest
import torch

from recommendit_tpu_torch.parallel.dryrun import dryrun_multichip
from recommendit_tpu_torch.scripts import multiproc_smoke, scale_smoke


def test_multiproc_smoke_two_ranks(tmp_path):
    out = tmp_path / "multiproc.json"
    assert multiproc_smoke.main(["--nproc", "2", "--device", "cpu",
                                 "--out", str(out), "--timeout", "240"]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] and rep["n_processes"] == 2
    assert rep["resume_across_restart_matches"]
    assert rep["serve_matches_world_1"]
    for p in rep["processes"]:
        assert p["world_size"] == 2 and p["retrieval_ok"]
        assert p["train_losses"][-1] < p["train_losses"][0]
        assert p["serve_digest"] == rep["processes"][0]["serve_digest"]
    straight = rep["processes"][0]["ctr_losses"]
    for p in rep["resume_processes"]:
        assert p["resumed_ctr_losses"] == straight[multiproc_smoke.CTR_SAVE_AT:]


def test_dryrun_multichip_four_ranks(capsys):
    r = dryrun_multichip(4, device="cpu", timeout=240)
    assert r["mesh"] == {"data": 1, "model": 4}
    assert np.isfinite(r["loss"]) and np.isfinite(r["ctr_loss"])
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_scale_smoke_two_ranks():
    outs = scale_smoke.run("ml25m", row_cap=256, nproc=2, device="cpu",
                           timeout=240)
    assert [o["mesh"] for o in outs] == [{"data": 1, "model": 2}] * 2
    assert outs[0]["users"] == 257 and outs[0]["items"] == 257
    for o in outs:
        assert np.isfinite(o["first_loss"]) and np.isfinite(o["last_loss"])
        assert o["last_loss"] == outs[0]["last_loss"]


def test_cuda_runs_need_a_card_a_rank():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        multiproc_smoke.run(2, device="cuda")
    with pytest.raises(RuntimeError):
        scale_smoke.run(nproc=1, device="cuda")
