"""Where the tensor-core fold kernel's time goes: timing-only variants of its
source, built and timed on the card. A measurement tool, outside the
package: nothing imports it.

    python3 tools/fold_breakdown.py [--rounds 2]   # from the repo root

Builds ``recommendit_tpu_torch/csrc/fold_mips.cu`` as it is and in altered
copies (under ``recommendit_tpu_torch/build/fold_breakdown/``, beside
``csrc/window_tc.cuh``), then times the tensor-core entry of each at the
fold phase's shape of ``chip_smoke.py`` — Q=1024 f32 queries x 1,000,000
bf16 unit rows x 136 columns (129 nonzero), block 2048, R=64 and R=32 — by
CUDA events, the variants taking turns ``--rounds`` times:

* ``kernel``: the source as it is (three bf16 pieces, a ring of up to
  ``kMaxStages`` = 4 stages: 3 fit at d = 136);
* ``cuda_cores``: the CUDA-core entry of the same build (f32 FMAs);
* ``ring_2``: the ring 2 stages deep: the same outputs, checked;
* ``one_piece``: one wgmma a k-step (the hi piece alone, so the queries
  rounded to bf16: other outputs, the same fold);
* ``products_only``: the fold left out (the bins keep their initial values
  and are stored): the TMA ring and the three wgmma alone;
* ``fold_only``: no wgmma (the accumulators stay zero, so every score
  ties): the TMA ring, the fold and the stores alone;
* ``logical_take``: the tie-aware compare written with ``&&`` and ``||``
  in place of ``&`` and ``|`` (more register moves): the same outputs,
  checked;
* ``two_pieces``: two wgmma a k-step (hi and mid, no lo): the control of
  the precision check. Its scores and the kernel's are read against f64
  (``chip_smoke.fold_f64_err``: the largest error over Σ|q_k·x_k|) on 256
  of the timed queries and on ``chip_smoke.lo_heavy_inputs`` (65,536 rows,
  1,024 queries, R=64), against ``chip_smoke.FOLD_F64_LIMIT``.

Every build's library stays under its directory (``lib.so``) for
``cuobjdump``. The split kernel runs once before the timings (the pieces
are its output) and is timed alone as ``split``. Prints one JSON line: the
card's name and power limit, the shape, the ms of each variant and R per
round, the f64 errors, and the count of ptxas's C7519 notes (an injected
``warpgroup.arrive``) per variant. Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from recommendit_tpu_torch.ops import _build  # noqa: E402
from recommendit_tpu_torch.ops import mips_fold as mf  # noqa: E402

BUILDS = ("kernel", "ring_2", "one_piece", "products_only", "fold_only",
          "logical_take", "two_pieces")
VARIANTS = ("kernel", "cuda_cores", *BUILDS[1:-1])
CHECKED = ("kernel", "two_pieces")   # read against f64
EXACT = ("kernel", "ring_2", "logical_take")   # the same outputs as the kernel
N_Q, N_ROWS, DIM, DIM_FUNC, BLOCK = 1024, 1_000_000, 136, 129, 2048
REDUCTIONS = (64, 32)
LO_ROWS, CHECK_Q = 65_536, 256

_RING = "constexpr int kMaxStages = 4;"
_PIECE_LOOP = "for (int pc = 0; pc < kPieces; ++pc)\n              tc::wgmma("
_FULL_TILES = "        if (lim == tc::kBR)\n          fold_tile<kOut, false>"
_EDGE_TILES = "        else\n          fold_tile<kOut, true>"
_TAKE = "const bool w = (s > v) | ((s == v) & (rj < vr));"


def _sub(text: str, old: str, new: str, count: int) -> str:
    if text.count(old) != count:
        raise ValueError(f"fold_mips.cu changed: {old!r} occurs "
                         f"{text.count(old)} times, not {count}")
    return text.replace(old, new)


def variant_source(name: str, source: str) -> str:
    """``csrc/fold_mips.cu`` (the text ``source``) as build ``name`` has it."""
    if name == "kernel":
        return source
    if name == "ring_2":
        return _sub(source, _RING, _RING.replace("4", "2"), 1)
    if name in ("one_piece", "two_pieces", "fold_only"):
        pieces = {"one_piece": "1", "two_pieces": "2", "fold_only": "0"}[name]
        return _sub(source, _PIECE_LOOP, _PIECE_LOOP.replace("kPieces", pieces), 2)
    if name == "logical_take":
        return _sub(source, _TAKE, "const bool w = s > v || (s == v && rj < vr);", 1)
    if name == "products_only":
        out = _sub(source, _FULL_TILES, _FULL_TILES.replace("lim == tc::kBR", "lim < 0"), 1)
        return _sub(out, _EDGE_TILES, _EDGE_TILES.replace("else", "else if (lim < 0)"), 1)
    raise ValueError(f"unknown variant {name!r}")


def build(name: str, out_dir: Path):
    """The build's library and ptxas's count of C7519 notes, compiled with
    the port's nvcc flags."""
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "window_tc.cuh").write_text((_build.CSRC_DIR / "window_tc.cuh").read_text())
    src = d / "fold_mips.cu"
    src.write_text(variant_source(name, (_build.CSRC_DIR / "fold_mips.cu").read_text()))
    lib = d / "lib.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib)), (proc.stdout + proc.stderr).count("C7519")


def fold_tc(lib, pieces, rows, bn: int, out: int, stream):
    """(vals, ids) of one launch of ``lib``'s tensor-core entry."""
    n_q, (n_rows, dim) = pieces.shape[1], rows.shape
    n_cand = -(-n_rows // bn) * out
    vals = torch.empty((n_q, n_cand), device=rows.device)
    ids = torch.empty((n_q, n_cand), device=rows.device, dtype=torch.int32)
    fn = lib.fold_mips_bf16_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(pieces.data_ptr(), rows.data_ptr(), vals.data_ptr(), ids.data_ptr(), n_q,
            n_rows, dim, bn, out, mf.pad_score(torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"launch failed, CUDA error {rc}")
    return vals, ids


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fold_breakdown: no CUDA device", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "fold_breakdown"
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        built = dict(zip(BUILDS, pool.map(lambda v: build(v, out_dir), BUILDS)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    items = torch.randn(N_ROWS, DIM, generator=gen, device=dev)
    items[:, DIM_FUNC:] = 0
    items = (items / items.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    q = torch.randn(N_Q, DIM, generator=gen, device=dev)
    q[:, DIM_FUNC:] = 0
    pieces = mf.split_queries(q)
    pad = mf.pad_score(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    ms, same = {}, {}
    for r in REDUCTIONS:
        bn, out, n_blocks = mf.fold_shape(N_ROWS, 1, BLOCK, r)
        outs = {name: (torch.empty((N_Q, n_blocks * out), device=dev),
                       torch.empty((N_Q, n_blocks * out), device=dev, dtype=torch.int32))
                for name in VARIANTS}

        def launch(name):
            vals, ids = outs[name]
            if name == "cuda_cores":
                fn = built["kernel"][0].fold_mips_launch
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [
                    ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                               ctypes.c_void_p]
                head = (q.data_ptr(), items.data_ptr(), 1)
            else:
                fn = built[name][0].fold_mips_bf16_launch
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                    ctypes.c_float, ctypes.c_void_p]
                head = (pieces.data_ptr(), items.data_ptr())
            fn.restype = ctypes.c_int
            rc = fn(*head, vals.data_ptr(), ids.data_ptr(), N_Q, N_ROWS, DIM, bn, out,
                    pad, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")

        for name in EXACT:
            launch(name)
        torch.cuda.synchronize()
        same[f"r{r}"] = all(torch.equal(a, b) for name in EXACT[1:]
                            for a, b in zip(outs["kernel"], outs[name]))
        for _ in range(args.rounds):
            for name in VARIANTS:
                ms.setdefault(f"{name}/r{r}", []).append(
                    _events_ms(lambda: launch(name), 5 if name == "cuda_cores" else 20))
    ms["split"] = [_events_ms(lambda: mf.split_queries(q), 50) for _ in range(args.rounds)]
    errors = {}
    lq, li = chip_smoke.lo_heavy_inputs(LO_ROWS, DIM, N_Q, dev, args.seed)
    for data, (qq, rows) in (("unit", (q, items)), ("lo_heavy", (lq, li))):
        bn, out, _ = mf.fold_shape(rows.shape[0], 1, BLOCK, REDUCTIONS[0])
        for name in CHECKED:
            vals, ids = fold_tc(built[name][0], mf.split_queries(qq), rows, bn, out, stream)
            errors[f"{name}/{data}"] = chip_smoke.fold_f64_err(
                qq[:CHECK_Q], rows, vals[:CHECK_Q], ids[:CHECK_Q])
    print(json.dumps({"card": card, "shape": {
        "q": N_Q, "n": N_ROWS, "d": DIM, "d_nonzero": DIM_FUNC, "block": BLOCK},
        "exact_variants_equal_kernel": same, "ms": ms,
        "f64_err": errors, "f64_limit": chip_smoke.FOLD_F64_LIMIT,
        "ptxas_c7519_notes": {name: notes for name, (_, notes) in built.items()}}),
        flush=True)
    if not all(same.values()):
        print("fold_breakdown: a ring_2 or logical_take output differs from the kernel",
              file=sys.stderr)
        return 1
    if not (max(errors["kernel/unit"], errors["kernel/lo_heavy"])
            <= chip_smoke.FOLD_F64_LIMIT < errors["two_pieces/lo_heavy"]):
        print("fold_breakdown: the f64 limit does not part the kernel from two pieces",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
