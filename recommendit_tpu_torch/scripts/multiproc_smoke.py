"""Multi-process smoke run of the multi-device layer — torch port of
``scripts/multiproc_smoke.py``.

Runs the code paths a single process cannot: ``parallel.mesh.distributed_init``
→ a process group of ``--nproc`` ranks (NCCL, one card a rank, or gloo on
the CPU), then over a ``('data', 'model')`` mesh across them:

* the sharded DP×MP two-tower train step (dropout on, clipping, AdamW),
* both sharded-retrieval merges (all-gather and ring), against numpy,
* the sharded CTR/joint train step (row-sharded 26-field table),
* the sharded two-stage SERVE path, its output compared with the same
  program at world size 1 (ids equal, scores within 1e-5),
* checkpoint-resume ACROSS A RESTART OF THE PROCESS GROUP: phase A trains 4
  CTR steps straight and saves each rank's state at step 2 (``torch.save``
  files read back with ``weights_only=True``); a freshly spawned group
  (phase B) restores them and re-runs steps 2-3, whose losses must equal
  phase A's exactly.

Usage:
  python -m recommendit_tpu_torch.scripts.multiproc_smoke --nproc 2 --device cpu
  python -m recommendit_tpu_torch.scripts.multiproc_smoke --nproc 4   # 4 cards

Writes its JSON report to ``--out`` (default: a file in the temp
directory) and prints it; exits 1 if a check failed.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE

CTR_STEPS = 4
CTR_SAVE_AT = 2
PREFER_MODEL = 4                  # JAX's (n // 4, 4) mesh where n allows
SERVE_TOL = 1e-5
CTR_WORLD1_TOL = 1e-6


# --------------------------------------------------------------------- #
# Deterministic workloads shared by the ranks and the world-1 reference
# (everything seeded, no wall-clock).
# --------------------------------------------------------------------- #

def _mesh():
    from recommendit_tpu_torch.parallel import create_mesh

    return create_mesh(prefer_model=PREFER_MODEL)


def _ctr_setup(mesh):
    from recommendit_tpu_torch.models.ctr import init_ctr_params
    from recommendit_tpu_torch.parallel import (
        AdamW,
        init_ctr_sharded_state,
        make_ctr_sharded_train_step,
    )
    from recommendit_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size

    params = init_ctr_params(
        torch.Generator().manual_seed(1), [32] * 26, embed_dim=16,
        bottom_hidden=32, top_hidden=(64, 32), retrieval_dim=16,
        pad_rows_to=axis_size(mesh, MODEL_AXIS), device="cpu")
    n_rows = params["embed"].shape[0]
    tx = AdamW(1e-3)
    step = make_ctr_sharded_train_step(mesh, tx, n_user_fields=8)
    params, state = init_ctr_sharded_state(mesh, tx, params)
    return step, params, state, n_rows


def _ctr_batch(step_idx: int, n_rows: int, device, batch: int = 16):
    rng = np.random.default_rng(1000 + step_idx)
    arrays = (rng.normal(size=(batch, 13)).astype(np.float32),
              rng.integers(0, n_rows, size=(batch, 26)),
              rng.integers(0, 2, size=(batch,)).astype(np.float32),
              (rng.normal(size=(batch,)) - 3.0).astype(np.float32))
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def _ckpt_path(ckpt_dir: str, rank: int) -> str:
    return os.path.join(ckpt_dir, f"ctr_state.rank{rank}.pt")


def ctr_run(mesh, ckpt_dir: str, rank: int, save_at=CTR_SAVE_AT):
    """The straight CTR run: ``CTR_STEPS`` steps, each rank's state saved
    before step ``save_at`` (None: no save) → the losses."""
    from recommendit_tpu_torch.parallel.mesh import mesh_device
    from recommendit_tpu_torch.utils.checkpoint import save_train_state

    step, params, state, n_rows = _ctr_setup(mesh)
    losses = []
    for s in range(CTR_STEPS):
        if s == save_at:
            save_train_state(_ckpt_path(ckpt_dir, rank), {
                "params": params, "opt_state": state.state_dict(),
                "step": torch.tensor(s)})
        params, state, loss = step(params, state,
                                   _ctr_batch(s, n_rows, mesh_device(mesh)))
        losses.append(float(loss))
    return losses


def ctr_resume(mesh, ckpt_dir: str, rank: int):
    """Restore this rank's saved state into a fresh setup and run the
    remaining steps → their losses."""
    from recommendit_tpu_torch.parallel.mesh import mesh_device
    from recommendit_tpu_torch.utils.checkpoint import load_train_state

    step, params, state, n_rows = _ctr_setup(mesh)
    dev = mesh_device(mesh)
    saved = load_train_state(_ckpt_path(ckpt_dir, rank), device=dev)
    with torch.no_grad():
        for k, p in params.items():
            if p.shape != saved["params"][k].shape:
                raise ValueError(f"checkpoint {k}: shape {tuple(saved['params'][k].shape)}, "
                                 f"this rank holds {tuple(p.shape)}")
            p.copy_(saved["params"][k])
    state.load_state_dict(saved["opt_state"])
    losses = []
    for s in range(int(saved["step"]), CTR_STEPS):
        params, state, loss = step(params, state, _ctr_batch(s, n_rows, dev))
        losses.append(float(loss))
    return int(saved["step"]), losses


def serve_outputs(mesh):
    """A deterministic sharded serve call on ``mesh`` → (ids, scores,
    retrieval scores) of the whole batch, as numpy."""
    from recommendit_tpu_torch.models.ranker import init_mlp, mlp_score
    from recommendit_tpu_torch.models.two_tower import init_params
    from recommendit_tpu_torch.parallel import make_sharded_serve_fn, row_sharded
    from recommendit_tpu_torch.parallel.mesh import mesh_device

    dev = mesh_device(mesh)
    rng = np.random.default_rng(7)
    n_users, n_items, d = 64, 256, 16
    params = init_params(torch.Generator().manual_seed(0), n_users, n_items, d,
                         32, device=dev)
    corpus = rng.normal(size=(n_items, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    user_packed = torch.as_tensor(
        rng.normal(size=(n_users + 1, 24)).astype(np.float32), device=dev)
    item_packed = torch.as_tensor(
        rng.normal(size=(n_items + 1, 23)).astype(np.float32), device=dev)
    rparams = {k: v.to(dev) for k, v in
               init_mlp(torch.Generator().manual_seed(1), 50, (32, 16)).items()}
    serve = make_sharded_serve_fn(
        mesh, params, row_sharded(mesh).shard(corpus),
        torch.arange(1, n_items + 1, device=dev), user_packed, item_packed,
        lambda f: mlp_score(rparams, f), n_candidates=32, k_out=8)
    uids = torch.as_tensor(rng.integers(1, n_users, size=16), device=dev)
    return tuple(x.cpu().numpy() for x in serve(uids))


def digest(outs) -> str:
    ids, scores, rvals = outs
    h = hashlib.sha1()
    h.update(ids.astype(np.int64).tobytes())
    h.update(np.round(scores, 5).astype(np.float32).tobytes())
    h.update(np.round(rvals, 5).astype(np.float32).tobytes())
    return h.hexdigest()


def _train_and_retrieve(mesh) -> dict:
    from recommendit_tpu_torch.models.two_tower import init_params
    from recommendit_tpu_torch.parallel import (
        AdamW,
        init_sharded_state,
        make_sharded_train_step,
        row_sharded,
        sharded_mips_topk,
        sharded_mips_topk_ring,
    )
    from recommendit_tpu_torch.parallel.mesh import mesh_device
    from recommendit_tpu_torch.parallel.train import dropout_generator

    dev = mesh_device(mesh)
    n_users = n_items = 64
    d, h, batch = 16, 32, 16
    params = init_params(torch.Generator().manual_seed(0), n_users - 1,
                         n_items - 1, d, h, device="cpu")
    rng = np.random.default_rng(0)
    genre_table = (rng.random((n_items, 18)) < 0.2).astype(np.float32)
    tx = AdamW(1e-3, weight_decay=1e-4, clip_norm=1.0)
    step = make_sharded_train_step(mesh, tx, genre_table, dropout_rate=0.2)
    sp, so = init_sharded_state(mesh, tx, params)
    u_ids = torch.as_tensor(rng.integers(1, n_users, size=batch), device=dev)
    i_ids = torch.as_tensor(rng.integers(1, n_items, size=batch), device=dev)
    gen = dropout_generator(mesh, 0)
    losses = []
    for _ in range(3):
        sp, so, loss = step(sp, so, (u_ids, i_ids), gen)
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"

    corpus = rng.normal(size=(128, d)).astype(np.float32)
    items = row_sharded(mesh).shard(corpus)
    queries = rng.normal(size=(4, d)).astype(np.float32)
    q = torch.as_tensor(queries, device=dev)
    _, idx = sharded_mips_topk(q, items, 8, mesh)
    _, ridx = sharded_mips_topk_ring(q, items, 8, mesh)
    idx, ridx = idx.cpu().numpy(), ridx.cpu().numpy()
    assert (idx == ridx).all(), "ring merge != all-gather merge"
    want = np.argsort(-(queries @ corpus.T), axis=1)[:, :8]
    assert (np.sort(want) == np.sort(idx)).all(), "sharded top-k wrong"
    return {"train_losses": losses, "retrieval_ok": True}


# --------------------------------------------------------------------- #
# Rank bodies
# --------------------------------------------------------------------- #

def _phase_a(ckpt_dir: str) -> dict:
    import torch.distributed as dist

    mesh = _mesh()
    rank = dist.get_rank()
    out = {"rank": rank, "world_size": dist.get_world_size(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    out.update(_train_and_retrieve(mesh))
    # each step sees a new batch of random labels: finite, not falling
    losses = ctr_run(mesh, ckpt_dir, rank)
    assert all(np.isfinite(losses)), losses
    dist.barrier()
    if rank == 0:
        with open(os.path.join(ckpt_dir, "step.json"), "w") as f:
            json.dump({"step": CTR_SAVE_AT}, f)
    out["ctr_losses"] = losses
    outs = serve_outputs(mesh)
    out["serve"] = [x.tolist() for x in outs]
    out["serve_digest"] = digest(outs)
    return out


def _phase_b(ckpt_dir: str) -> dict:
    import torch.distributed as dist

    with open(os.path.join(ckpt_dir, "step.json")) as f:
        saved_step = json.load(f)["step"]
    mesh = _mesh()
    step, losses = ctr_resume(mesh, ckpt_dir, dist.get_rank())
    assert step == saved_step, (step, saved_step)
    return {"rank": dist.get_rank(), "resumed_ctr_losses": losses}


def _world1_ref() -> dict:
    """The same serve program and the straight CTR run at world size 1."""
    mesh = _mesh()
    outs = serve_outputs(mesh)
    return {"serve": [x.tolist() for x in outs], "serve_digest": digest(outs),
            "ctr_losses": ctr_run(mesh, "", 0, save_at=None)}


def run(nproc: int = 2, device=DEFAULT_DEVICE, timeout: float = 600.0) -> dict:
    """Spawn the reference and the two phases → the report (``ok`` and the
    checks' results)."""
    from recommendit_tpu_torch.parallel.launch import spawn

    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="multiproc_ckpt_") as ckpt_dir:
        ref = spawn(_world1_ref, 1, device=device, timeout=timeout)[0]
        outs = spawn(_phase_a, nproc, (ckpt_dir,), device=device, timeout=timeout)
        outs_b = spawn(_phase_b, nproc, (ckpt_dir,), device=device, timeout=timeout)
    c0 = outs[0]["ctr_losses"]
    r0 = outs_b[0]["resumed_ctr_losses"]
    serve0 = [np.asarray(x) for x in outs[0]["serve"]]
    serve1 = [np.asarray(x) for x in ref["serve"]]
    checks = {
        "losses_identical_across_processes":
            all(o["train_losses"] == outs[0]["train_losses"] for o in outs),
        "ctr_losses_identical_across_processes":
            all(o["ctr_losses"] == c0 for o in outs),
        "serve_identical_across_processes":
            all(o["serve"] == outs[0]["serve"] for o in outs),
        "serve_matches_world_1": bool(
            (serve0[0] == serve1[0]).all()
            and np.allclose(serve0[1], serve1[1], rtol=0, atol=SERVE_TOL)
            and np.allclose(serve0[2], serve1[2], rtol=0, atol=SERVE_TOL)),
        "ctr_losses_match_world_1": bool(
            np.allclose(ref["ctr_losses"], c0, rtol=0, atol=CTR_WORLD1_TOL)),
        "resume_processes_agree":
            all(o["resumed_ctr_losses"] == r0 for o in outs_b),
        "resume_across_restart_matches": r0 == c0[CTR_SAVE_AT:],
    }
    for o in outs:
        o.pop("serve")
    return {
        "ok": all(checks.values()), **checks,
        "wall_s": time.time() - t0, "n_processes": nproc, "device": str(device),
        "processes": outs, "resume_processes": outs_b,
        "world_1_reference": {"serve_digest": ref["serve_digest"],
                              "ctr_losses": ref["ctr_losses"]},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default=DEFAULT_DEVICE, choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each process group may take")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "multiproc_smoke.json"))
    args = ap.parse_args(argv)
    report = run(args.nproc, args.device, args.timeout)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
