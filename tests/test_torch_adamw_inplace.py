"""The port's in-place AdamW step (C.64), on the CPU.

``OptaxAdamW.step`` runs optax's update over row ranges of the params,
their gradients and moments, packed into groups of at most ``chunk``
elements, so no temporary is larger than a group — the memory plan of
JAX's donated step (``recommendit_tpu/parallel/train.py:70``). Held here:
the groups cover every element once; the chunked step bit-equal to the
one-pass form (``_step_unchunked``) over 50 steps at chunk sizes that cut
the tables into many groups, with and without weight decay, with a param
that is not decayed (``item_bias``) and groups without a decayed param; no
``torch._foreach_*`` operand over one chunk; and the chunked step against
``optax.adamw`` as ``tests/test_torch_training.py`` holds the one-pass
form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommendit_tpu_torch.training import train_embeddings as tte

STEPS = 50
# shapes of a small two-tower set: tables, the item bias (not decayed), a
# tower's weights and biases, a 0-d scalar and an empty tensor
SHAPES = {"user_embed": (61, 16), "item_embed": (41, 16), "item_bias": (41,),
          "w1": (16, 32), "b1": (32,), "w2": (32, 16), "scale": (), "none": (0, 4)}
CHUNKS = (16, 100, 500, tte.ADAM_CHUNK)


def _params(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {k: torch.tensor((0.3 * rng.normal(size=s)).astype(np.float32))
            for k, s in SHAPES.items()}


def _grads(rng, step: int):
    """Seeded gradients; the tables' rows mostly zero, as a lookup's are."""
    out = []
    for k, s in SHAPES.items():
        g = rng.normal(size=s).astype(np.float32) * (1.0 + step % 3)
        if k.endswith("_embed"):
            g *= rng.random(s[0])[:, None] < 0.2
        out.append(torch.tensor(g))
    return out


def _pair(wd: float, chunk: int):
    p0 = _params()
    decay = [k != "item_bias" for k in SHAPES]
    a = tte.OptaxAdamW([v.clone() for v in p0.values()], decay, wd, chunk=chunk)
    b = tte.OptaxAdamW([v.clone() for v in p0.values()], decay, wd)
    return a, b


@pytest.mark.parametrize("chunk", [1, 7, 16, 100, 4096])
def test_groups_cover_every_element_once(chunk):
    shapes = list(SHAPES.values())
    groups = tte.chunk_groups(shapes, chunk)
    seen = {i: [] for i in range(len(shapes))}
    for g in groups:
        sizes = [(b - a) * int(np.prod(shapes[i][1:])) for i, a, b, _ in g]
        assert sum(sizes) <= chunk or len(g) == 1, (g, sizes)
        for i, a, b, whole in g:
            seen[i].append((a, b))
            n = shapes[i][0] if shapes[i] else 1
            assert whole == (a == 0 and b == n)
    for i, s in enumerate(shapes):
        n = s[0] if s else 1
        if not np.prod(s):
            assert not seen[i]
            continue
        ranges = seen[i]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(x[1] == y[0] for x, y in zip(ranges, ranges[1:]))
    # row ranges never split a row: the (32, 16) weights at chunk 7 go a row a group
    assert all(b - a == 1 for g in tte.chunk_groups([(32, 16)], 7) for _, a, b, _ in g)


@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_step_is_bit_equal_to_one_pass(wd, chunk):
    chunked, one_pass = _pair(wd, chunk)
    if chunk < 500:
        assert len(chunked.groups) > 4
    if chunk == 16:
        # groups of item_bias rows alone: no decayed param in them
        assert any(not d for d in chunked._group_decayed)
    rng = np.random.default_rng(1)
    for step in range(STEPS):
        grads = _grads(rng, step)
        lr = tte.cosine_lr(1e-2, step, STEPS)
        chunked.step([g.clone() for g in grads], lr)
        one_pass._step_unchunked(grads, lr)
        for name, x, y in (("params", chunked.params, one_pass.params),
                           ("mu", chunked.mu, one_pass.mu),
                           ("nu", chunked.nu, one_pass.nu)):
            for k, a, b in zip(SHAPES, x, y):
                assert torch.equal(a, b), (step, name, k)
    assert chunked.count == one_pass.count == STEPS
    assert not torch.equal(chunked.params[0], _params()["user_embed"])


@pytest.mark.parametrize("chunk", [32, 500])
def test_no_foreach_operand_exceeds_a_chunk(chunk, monkeypatch):
    opt, _ = _pair(1e-4, chunk)
    calls = []
    for name in dir(torch):
        if name.startswith("_foreach_"):
            fn = getattr(torch, name)

            def spy(*args, _fn=fn, _name=name, **kwargs):
                sizes = [sum(t.numel() for t in a) for a in args
                         if isinstance(a, (list, tuple))]
                calls.append((_name, max(sizes)))
                return _fn(*args, **kwargs)

            monkeypatch.setattr(torch, name, spy)
    opt.step(_grads(np.random.default_rng(2), 0), 1e-3)
    monkeypatch.undo()
    total = sum(int(np.prod(s)) for s in SHAPES.values())
    assert total > 4 * chunk
    assert calls and max(n for _, n in calls) <= chunk, max(calls, key=lambda c: c[1])
    # the same 16 operations a group (14 without a decayed param)
    per_group = [16 if d else 14 for d in opt._group_decayed]
    assert len(calls) == sum(per_group)


@pytest.mark.parametrize("lr,wd", [(1e-3, 1e-5), (1e-2, 0.1)])
def test_chunked_step_rounds_as_optax(lr, wd):
    """The chunked step at chunk 100 (a 256 x 64 decayed matrix a row a
    group, a 256 bias without decay in 3 groups) against ``optax.adamw``
    jitted: within 2 ulps of the largest param of the first step's gap
    after 50 steps, the rule ``test_adamw_rounds_as_optax`` holds the
    one-pass form to."""
    rng = np.random.default_rng(11)
    p0 = {"w": (0.3 * rng.normal(size=(256, 64))).astype(np.float32),
          "b": (0.3 * rng.normal(size=256)).astype(np.float32)}
    tx = optax.adamw(lr, weight_decay=wd, mask={"w": True, "b": False})
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)

    @jax.jit
    def jstep(params, state, g):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state

    w, b = (torch.tensor(p0[k]) for k in ("w", "b"))
    opt = tte.OptaxAdamW([w, b], [True, False], wd, chunk=100)
    assert len(opt.groups) == 256 + 3
    gaps = []
    for _ in range(STEPS):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        jp, state = jstep(jp, state, {k: jnp.asarray(v) for k, v in g.items()})
        opt.step([torch.tensor(g["w"]), torch.tensor(g["b"])], lr)
        gaps.append(max(float(np.abs(w.numpy() - np.asarray(jp["w"])).max()),
                        float(np.abs(b.numpy() - np.asarray(jp["b"])).max())))
    ulp = float(np.spacing(max(np.abs(v).max() for v in p0.values())))
    assert max(gaps) <= gaps[0] + 2 * ulp, (gaps[0], max(gaps), ulp)
