"""The inputs of a DLRM-DCNv2 training cell, drawn on the device from
``--seed``: the params and the pool of batches that the benchmark makes and
hands, the same, to the program and to the plain reference. Nothing here
imports the program.

The configuration gives each field's held rows (``vocab_sizes``, stacked
at static offsets into one table), its published rows
(``published_vocab_sizes``) and its bag (``bag_sizes``); the widths
(``dense_in``, ``bottom``, ``embed_dim``, ``cross_layers``,
``cross_rank``, ``top``). Initial scales, as torchrec's modules leave them
(the configuration's ``assumed``): a field's rows U(−1/√n, 1/√n), n its
published rows; each MLP layer's weight and bias U(−1/√in, 1/√in); the
cross net's V and W Xavier-normal, its bias 0. Each field of the table is
drawn block by block from its own generator, so the reference draws it
again after the program's state is freed.

A batch (the mix's ``ids``, ``dense`` and ``click_rate``): each example's
bag of field f holds ``bag_sizes[f]`` ids, drawn Zipf(s) over a seeded
permutation of the field's held rows (the permutation one a field and
seed, shared by the pool); 13 dense features log(1 + x), x exponential of
the mix's mean; a click with probability ``click_rate``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.seeds import generator

TABLE_BLOCK = 1 << 20      # rows a generator draws of a field


def offsets(cfg: dict) -> np.ndarray:
    """Each field's first row in the stacked table."""
    return np.concatenate([[0], np.cumsum(cfg["vocab_sizes"])[:-1]]).astype(np.int64)


def embed_block(cfg: dict, seed: int, field: int, block: int, device) -> torch.Tensor:
    """Rows ``[block·TABLE_BLOCK, …)`` of field ``field`` (at most
    ``TABLE_BLOCK``, at most up to its held rows)."""
    n = int(cfg["vocab_sizes"][field])
    a = block * TABLE_BLOCK
    k = 1.0 / math.sqrt(int(cfg["published_vocab_sizes"][field]))
    g = generator(device, seed, "dlrm_embed", field, block)
    rows = min(n, a + TABLE_BLOCK) - a
    return (torch.rand((rows, int(cfg["embed_dim"])), generator=g, device=device) * 2 - 1) * k


def embed(cfg: dict, seed: int, device) -> torch.Tensor:
    """The stacked (Σ held rows, D) table."""
    d = int(cfg["embed_dim"])
    out = torch.empty((int(sum(cfg["vocab_sizes"])), d), device=device)
    for f, (off, n) in enumerate(zip(offsets(cfg), cfg["vocab_sizes"])):
        for blk in range(-(-int(n) // TABLE_BLOCK)):
            a = int(off) + blk * TABLE_BLOCK
            rows = embed_block(cfg, seed, f, blk, device)
            out[a:a + rows.shape[0]] = rows
    return out


def _linear(device, seed: int, tag: str, n_in: int, n_out: int):
    k = 1.0 / math.sqrt(n_in)
    w = torch.rand((n_in, n_out), generator=generator(device, seed, tag, "w"), device=device)
    b = torch.rand((n_out,), generator=generator(device, seed, tag, "b"), device=device)
    return (w * 2 - 1) * k, (b * 2 - 1) * k


def cross_width(cfg: dict) -> int:
    return int(cfg["embed_dim"]) * (len(cfg["vocab_sizes"]) + 1)


def dense_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The MLPs' and the cross net's params, under the program's names."""
    p: Dict[str, torch.Tensor] = {}
    widths = [int(cfg["dense_in"])] + [int(w) for w in cfg["bottom"]] + [int(cfg["embed_dim"])]
    for i in range(len(widths) - 1):
        p[f"bot_w{i + 1}"], p[f"bot_b{i + 1}"] = _linear(device, seed, f"bot{i + 1}",
                                                         widths[i], widths[i + 1])
    w, r = cross_width(cfg), int(cfg["cross_rank"])
    std = math.sqrt(2.0 / (w + r))
    for li in range(1, int(cfg["cross_layers"]) + 1):
        p[f"cross_v{li}"] = torch.randn((w, r), generator=generator(device, seed, "cross_v", li),
                                        device=device) * std
        p[f"cross_w{li}"] = torch.randn((r, w), generator=generator(device, seed, "cross_w", li),
                                        device=device) * std
        p[f"cross_b{li}"] = torch.zeros(w, device=device)
    widths = [w] + [int(x) for x in cfg["top"]] + [1]
    for i in range(len(widths) - 1):
        p[f"top_w{i + 1}"], p[f"top_b{i + 1}"] = _linear(device, seed, f"top{i + 1}",
                                                         widths[i], widths[i + 1])
    return p


def params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every param: ``embed`` first, then the dense ones."""
    return {"embed": embed(cfg, seed, device), **dense_params(cfg, seed, device)}


def bag_bounds(cfg: dict) -> List[Tuple[int, int]]:
    out, a = [], 0
    for k in cfg["bag_sizes"]:
        out.append((a, a + int(k)))
        a += int(k)
    return out


def batches(cfg: dict, mix: dict, seed: int, device) -> List[tuple]:
    """The mix's pool: ``pool`` (dense (B, 13) f32, ids (B, S) int32 rows
    of the stacked table, labels (B,) f32)."""
    b, pool = int(mix["batch"]), int(mix["pool"])
    s_exp = float(mix["ids"]["s"])
    slots = int(sum(cfg["bag_sizes"]))
    ids = [torch.empty((b, slots), dtype=torch.int32, device=device) for _ in range(pool)]
    for f, ((a, e), off, n) in enumerate(zip(bag_bounds(cfg), offsets(cfg),
                                             cfg["vocab_sizes"])):
        n = int(n)
        cdf = torch.cumsum(torch.arange(1, n + 1, dtype=torch.float64, device=device)
                           .pow_(-s_exp), 0)
        perm = torch.randperm(n, generator=generator(device, seed, "dlrm_perm", f),
                              device=device)
        for k in range(pool):
            u = torch.rand((b * (e - a),), dtype=torch.float64, device=device,
                           generator=generator(device, seed, "dlrm_ids", f, k)) * cdf[-1]
            rank = torch.searchsorted(cdf, u).clamp_(max=n - 1)
            ids[k][:, a:e] = (perm[rank] + int(off)).view(b, e - a).to(torch.int32)
        del cdf, perm
    out = []
    mean = float(mix["dense"]["mean"])
    for k in range(pool):
        u = torch.rand((b, int(cfg["dense_in"])), device=device,
                       generator=generator(device, seed, "dlrm_dense", k))
        dense = torch.log1p(-mean * torch.log1p(-u))
        labels = (torch.rand((b,), device=device,
                             generator=generator(device, seed, "dlrm_click", k))
                  < float(mix["click_rate"])).float()
        out.append((dense, ids[k], labels))
    return out


def touched_rows(pool: List[tuple], steps: int) -> torch.Tensor:
    """The distinct table rows the first ``steps`` batches look up (int64)."""
    return torch.unique(torch.cat([pool[k][1].reshape(-1) for k in range(steps)]).long())
