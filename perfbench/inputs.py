"""The inputs of a run, drawn on the device from ``--seed``: the weights,
tables and ratings that the benchmark makes and hands, the same, to the
program and to the plain reference. Nothing here imports the program.

Each tensor is drawn from its own generator (``seeds.generator(seed,
tag)``), and a large table block by block, so any part can be drawn again
alone (the training reference draws the initial tables again after the
program's state is freed)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

from perfbench.seeds import generator

TABLE_BLOCK = 1 << 20      # rows a generator draws of a large table


def glorot(device, seed: int, tag: str, shape) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    g = generator(device, seed, tag)
    return (torch.rand(shape, generator=g, device=device) * 2 - 1) * limit


def normal(device, seed: int, tag: str, shape, std: float = 1.0) -> torch.Tensor:
    g = generator(device, seed, tag)
    return torch.randn(shape, generator=g, device=device) * std


def uniform(device, seed: int, tag: str, shape, lo: float = 0.0, hi: float = 1.0):
    g = generator(device, seed, tag)
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def table_block(device, seed: int, tag: str, rows: int, dim: int, block: int,
                std: float) -> torch.Tensor:
    """Rows ``[block·TABLE_BLOCK, …)`` (at most ``TABLE_BLOCK``, at most
    up to ``rows``) of an N(0, std²) table."""
    a = block * TABLE_BLOCK
    n = min(rows, a + TABLE_BLOCK) - a
    g = generator(device, seed, tag, block)
    return torch.randn((n, dim), generator=g, device=device).mul_(std)


def table(device, seed: int, tag: str, rows: int, dim: int, std: float,
          zero_row0: bool = True) -> torch.Tensor:
    """An N(0, std²) (rows, dim) table drawn block by block; row 0 (the
    padding row) zero where ``zero_row0``."""
    out = torch.empty((rows, dim), device=device)
    for b in range(-(-rows // TABLE_BLOCK)):
        blk = table_block(device, seed, tag, rows, dim, b, std)
        out[b * TABLE_BLOCK: b * TABLE_BLOCK + blk.shape[0]] = blk
    if zero_row0 and rows:
        out[0] = 0.0
    return out


# --- serving ---------------------------------------------------------------- #

@dataclass
class ServeInputs:
    """The two-tower's user side, the catalog's item vectors and biases,
    the ranker, the feature tables and the ratings of a serve
    configuration."""
    tower: Dict[str, torch.Tensor]     # user_embed, user_w1, user_b1, user_w2, user_b2
    item_vecs: torch.Tensor            # (N, D): the item tower's outputs
    item_bias: torch.Tensor            # (N,): the items' score bias
    ranker: Dict[str, torch.Tensor]    # w0, b0, w1, b1, …
    feat_mean: torch.Tensor            # (F,)
    feat_std: torch.Tensor             # (F,)
    user_feats: torch.Tensor           # (U + 1, user scalars + genres)
    item_feats: torch.Tensor           # (N + 1, item scalars + genres)
    ratings_user: torch.Tensor         # (R,) int64
    ratings_item: torch.Tensor         # (R,) int64


# value ranges of the feature tables' scalar columns, in the feature schema's order
USER_SCALARS = ((1.0, 5.0), (0.0, 7.0), (0.0, 1.0), (0.0, 1.0), (0.0, 1.0), (0.0, 1.0))
ITEM_SCALARS = ((1.0, 5.0), (0.0, 8.0), (0.0, 1.0), (0.0, 1.5), (0.0, 1.0))
GENRE_RATE = 0.15


def _feature_table(device, seed, tag, rows: int, scalars, n_genres: int, binary: bool):
    lo = torch.tensor([a for a, _ in scalars], device=device)
    hi = torch.tensor([b for _, b in scalars], device=device)
    s = uniform(device, seed, tag + ".scalars", (rows, len(scalars))) * (hi - lo) + lo
    g = uniform(device, seed, tag + ".genres", (rows, n_genres))
    if binary:
        g = (g < GENRE_RATE).float()
    return torch.cat([s, g], dim=1)


def serve_inputs(cfg: dict, seed: int, device) -> ServeInputs:
    u, n, d, h = cfg["n_users"], cfg["n_items"], cfg["embedding_dim"], cfg["hidden_dim"]
    if len(USER_SCALARS) != cfg["user_scalars"] or len(ITEM_SCALARS) != cfg["item_scalars"]:
        raise ValueError("the feature schema's scalar columns changed")
    tower = {
        "user_embed": table(device, seed, "user_embed", u + 1, d, 0.1),
        "user_w1": glorot(device, seed, "user_w1", (d, h)),
        "user_b1": normal(device, seed, "user_b1", (h,), 0.01),
        "user_w2": glorot(device, seed, "user_w2", (h, d)),
        "user_b2": normal(device, seed, "user_b2", (d,), 0.01),
    }
    n_feat = cfg["n_features"]
    dims = [n_feat, *cfg["ranker_hidden"], 1]
    ranker = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        ranker[f"w{i}"] = glorot(device, seed, f"ranker.w{i}", (a, b))
        ranker[f"b{i}"] = normal(device, seed, f"ranker.b{i}", (b,), 0.01)
    r = cfg["n_ratings"]
    head = max(1, n // 50)
    ru = torch.randint(1, u + 1, (r,), generator=generator(device, seed, "ratings.user"),
                       device=device)
    uni = torch.randint(1, n + 1, (r,), generator=generator(device, seed, "ratings.item"),
                        device=device)
    pop = torch.randint(1, head + 1, (r,), generator=generator(device, seed, "ratings.head"),
                        device=device)
    ri = torch.where(uniform(device, seed, "ratings.which", (r,)) < 0.5, uni, pop)
    return ServeInputs(
        tower=tower,
        item_vecs=table(device, seed, "item_vecs", n, d, 1.0, zero_row0=False),
        item_bias=normal(device, seed, "item_bias", (n,), cfg["bias_scale"]),
        ranker=ranker,
        feat_mean=normal(device, seed, "feat_mean", (n_feat,)),
        feat_std=uniform(device, seed, "feat_std", (n_feat,), 0.5, 2.0),
        user_feats=_feature_table(device, seed, "user_feats", u + 1, USER_SCALARS,
                                  cfg["genres"], binary=False),
        item_feats=_feature_table(device, seed, "item_feats", n + 1, ITEM_SCALARS,
                                  cfg["genres"], binary=True),
        ratings_user=ru, ratings_item=ri)


# --- training ---------------------------------------------------------------- #

def padded_rows(n: int, shards: int) -> int:
    """A table's rows less the padding row 0, padded so that rows + 1
    divide ``shards``."""
    return -(-(n + 1) // shards) * shards - 1


def train_layout(cfg: dict) -> dict:
    """Rows of a rank's table shards: the tables laid out over ``of_shards``
    ranks of the model axis, as the configuration's deployment holds them;
    the item bias and genre table whole."""
    shards = int(cfg["of_shards"])
    users_p, items_p = padded_rows(cfg["n_users"], shards), padded_rows(cfg["n_items"], shards)
    return {"user_rows": (users_p + 1) // shards, "item_rows": (items_p + 1) // shards,
            "users_p": users_p, "items_p": items_p, "shards": shards}


DENSE_INIT = {   # the JAX initialisers: Glorot-uniform weights, zero biases
    "user_w1": "glorot", "user_b1": "zeros", "user_w2": "glorot", "user_b2": "zeros",
    "item_w1": "glorot", "item_b1": "zeros", "item_w2": "glorot", "item_b2": "zeros",
    "item_bias": "zeros",
}


def dense_shapes(cfg: dict) -> Dict[str, tuple]:
    d, h, g = cfg["embedding_dim"], cfg["hidden_dim"], cfg["genres"]
    return {"user_w1": (d, h), "user_b1": (h,), "user_w2": (h, d), "user_b2": (d,),
            "item_w1": (d + g, h), "item_b1": (h,), "item_w2": (h, d), "item_b2": (d,),
            "item_bias": (train_layout(cfg)["items_p"] + 1,)}


def train_dense(cfg: dict, seed: int, name: str, device) -> torch.Tensor:
    shape = dense_shapes(cfg)[name]
    if DENSE_INIT[name] == "zeros":
        return torch.zeros(shape, device=device)
    return glorot(device, seed, name, shape)


TABLE_STD = 0.1


def table_tag(name: str, shard: int) -> str:
    return f"{name}.shard{shard}"


def train_table_block(cfg: dict, seed: int, name: str, shard: int, block: int, device):
    """Block ``block`` of shard ``shard`` of table ``name`` (``user_embed``
    or ``item_embed``): N(0, 0.1²), the global row 0 (the padding row) 0."""
    lay = train_layout(cfg)
    rows = lay["user_rows"] if name == "user_embed" else lay["item_rows"]
    t = table_block(device, seed, table_tag(name, shard), rows, cfg["embedding_dim"],
                    block, TABLE_STD)
    if shard == 0 and block == 0:
        t[0] = 0.0
    return t


def train_table(cfg: dict, seed: int, name: str, shard: int, device) -> torch.Tensor:
    lay = train_layout(cfg)
    rows = lay["user_rows"] if name == "user_embed" else lay["item_rows"]
    return table(device, seed, table_tag(name, shard), rows, cfg["embedding_dim"], TABLE_STD,
                 zero_row0=shard == 0)


def train_params(cfg: dict, seed: int, shard: int, device) -> Dict[str, torch.Tensor]:
    """A rank's initial params: its shard of each table, the rest whole."""
    p = {k: train_dense(cfg, seed, k, device) for k in DENSE_INIT}
    for name in ("user_embed", "item_embed"):
        p[name] = train_table(cfg, seed, name, shard, device)
    return p


def genre_table(cfg: dict, seed: int, device) -> torch.Tensor:
    """(items + 1, genres) multi-hot genre vectors, each genre at 0.2."""
    rows = train_layout(cfg)["items_p"] + 1
    return (uniform(device, seed, "genres", (rows, cfg["genres"])) < 0.2).float()


def train_redraw(cfg: dict, seed: int, shard: int, name: str, device):
    """Yield the initial ``name`` of shard ``shard`` again, as (block,
    first row, end row)."""
    if name in ("user_embed", "item_embed"):
        lay = train_layout(cfg)
        rows = lay["user_rows"] if name == "user_embed" else lay["item_rows"]
        a = b = 0
        while a < rows:
            blk = train_table_block(cfg, seed, name, shard, b, device)
            yield blk, a, a + blk.shape[0]
            a += blk.shape[0]
            b += 1
    else:
        blk = train_dense(cfg, seed, name, device)
        yield blk, 0, blk.shape[0]


def train_sizes(cfg: dict) -> Dict[str, int]:
    """The largest user and item ids of the rows the configuration's mesh
    holds (all of them where it holds every shard)."""
    lay = train_layout(cfg)
    held = int(cfg["mesh"][1])        # shards on the mesh's model axis
    return {"users": min(lay["users_p"], lay["user_rows"] * held) - 1,
            "items": min(lay["items_p"], lay["item_rows"] * held) - 1}
