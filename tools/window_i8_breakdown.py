"""Where the int8 tensor-core window kernel's time goes: timing-only
variants of its source, built and timed on the card. A measurement tool,
outside the package: nothing imports it.

    python3 tools/window_i8_breakdown.py [--rounds 2]   # from the repo root

Builds ``recommendit_tpu_torch/csrc/window_mips_i8.cu`` with
``csrc/window_tc.cuh`` as they are and in five altered copies (under
``recommendit_tpu_torch/build/i8_breakdown/``), then times the tensor-core
entry of each at the int8 serve shape — Q in {256, 1024} x 1,003,520 rows x
144 int8 columns (129 nonzero, as the serve corpus has), 1M valid rows,
W=64 — by CUDA events, the variants taking turns ``--rounds`` times:

* ``kernel``: the source as it is (a ring of ``kMaxStages`` = 4 stages);
* ``ring_2``, ``ring_8``: the ring 2 or 8 stages deep (8 fit at d = 144);
* ``int_trick``: each int32 sum made f32 as the bits 0x4B400000 + acc less
  1.5 * 2**23 (an integer add and an f32 subtract, exact while |acc| <=
  2**22) in place of cvt.rn.f32.s32: the same outputs, checked;
* ``no_scale``: the scale step left out (the window max reads the int32
  bits as floats: wrong maxima, the same work after them);
* ``products_only``: the scale step and the window max left out (nothing is
  stored): the TMA ring and the wgmma alone.

Prints one JSON line: the card's name and power limit, the shape, and the
ms of each variant and Q per round. Exits 2 without a card.
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
from recommendit_tpu_torch.ops import _build  # noqa: E402

VARIANTS = ("kernel", "ring_2", "ring_8", "int_trick", "no_scale", "products_only")
N_ROWS, N_VALID, DIM, DIM_FUNC, WINDOW = 1_003_520, 1_000_000, 144, 129, 64
QS = (256, 1024)

_RING = "constexpr int kMaxStages = 4;"

_CVT = "__int2float_rn((int)acc["
_DEQUANTIZE = "__device__ __forceinline__ void dequantize("
_TRICK = """__device__ __forceinline__ float int_trick(uint32_t acc) {
  return __fsub_rn(__uint_as_float(acc + 0x4B400000u), 12582912.0f);
}

"""
_SCALE_STEP = """            dequantize(acc0, scales + stage * kBR, lane & 3);
            dequantize(acc1, scales + stage * kBR, lane & 3);
"""
_FULL_TILES = "        if (lim == kBR) {"
_EDGE_TILES = "        } else {\n          epilogue<kLW, kQueriesMajor, true>"


def _sub(text: str, old: str, new: str, count: int) -> str:
    if text.count(old) != count:
        raise ValueError(f"window_tc.cuh changed: {old!r} occurs "
                         f"{text.count(old)} times, not {count}")
    return text.replace(old, new)


def variant_header(name: str, header: str) -> str:
    """``csrc/window_tc.cuh`` (the text ``header``) as variant ``name``
    builds it."""
    if name == "kernel":
        return header
    if name.startswith("ring_"):
        return _sub(header, _RING, _RING.replace("4", name[5:]), 1)
    if name == "int_trick":
        out = _sub(header, _CVT, "int_trick(acc[", 2)
        return _sub(out, _DEQUANTIZE, _TRICK + _DEQUANTIZE, 1)
    out = _sub(header, _SCALE_STEP, "", 1)
    if name == "no_scale":
        return out
    if name == "products_only":
        out = _sub(out, _FULL_TILES, "        if (lim < 0) {", 1)
        return _sub(out, _EDGE_TILES, _EDGE_TILES.replace("else {", "else if (lim < 0) {"), 1)
    raise ValueError(f"unknown variant {name!r}")


def build(name: str, out_dir: Path) -> ctypes.CDLL:
    """The variant's library, compiled with the port's nvcc flags."""
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "window_tc.cuh").write_text(
        variant_header(name, (_build.CSRC_DIR / "window_tc.cuh").read_text()))
    src = d / "window_mips_i8.cu"
    src.write_text((_build.CSRC_DIR / "window_mips_i8.cu").read_text())
    lib = d / "lib.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _events_ms(fn, reps: int = 20) -> float:
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
        print("window_i8_breakdown: no CUDA device", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "i8_breakdown"
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda v: build(v, out_dir), VARIANTS)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    items = torch.randint(-127, 128, (N_ROWS, DIM), generator=gen, device=dev,
                          dtype=torch.int8)
    items[:, DIM_FUNC:] = 0
    scales = torch.rand(N_ROWS, generator=gen, device=dev) * 0.01
    scales[N_VALID:] = 0.0
    n_cand = -(-N_ROWS // WINDOW)
    ms, same = {}, {}
    for n_q in QS:
        q8 = torch.randint(-127, 128, (n_q, DIM), generator=gen, device=dev,
                           dtype=torch.int8)
        q8[:, DIM_FUNC:] = 0
        outs = {}
        for name, lib in libs.items():
            fn = lib.window_mips_i8_tc_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            vals = torch.empty((n_cand, n_q), device=dev)
            pos = torch.empty((n_cand, n_q), device=dev, dtype=torch.int32)
            outs[name] = (fn, vals, pos)

        def launch(name):
            fn, vals, pos = outs[name]
            rc = fn(q8.data_ptr(), items.data_ptr(), scales.data_ptr(),
                    vals.data_ptr(), pos.data_ptr(), n_q, N_ROWS, DIM, N_VALID,
                    WINDOW, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")

        exact = ("kernel", "ring_2", "ring_8", "int_trick")
        for name in exact:
            launch(name)
        torch.cuda.synchronize()
        same[f"q{n_q}"] = all(torch.equal(a, b) for name in exact[1:]
                              for a, b in zip(outs["kernel"][1:], outs[name][1:]))
        for _ in range(args.rounds):
            for name in VARIANTS:
                ms.setdefault(f"{name}/q{n_q}", []).append(
                    _events_ms(lambda: launch(name)))
    print(json.dumps({"card": card, "shape": {
        "n": N_ROWS, "n_valid": N_VALID, "d": DIM, "d_nonzero": DIM_FUNC,
        "window": WINDOW}, "exact_variants_equal_kernel": same, "ms": ms}), flush=True)
    if not all(same.values()):
        print("window_i8_breakdown: a ring or int_trick output differs from the kernel",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
