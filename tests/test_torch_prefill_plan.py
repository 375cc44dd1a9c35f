"""K3's host plan (``ops/decode_attn.py::prefill_plan``) and a torch
emulation of the tiled online softmax that the bf16/f16 kernel runs over it.

The kernel packs each kv head's query rows as ``r = position * g +
head-in-group`` (q's own order within the group), gives a block 128 such
rows, and launches the blocks heavy-first: block ``x`` takes row tile
``n_tiles - 1 - x // (B * nkv)``. These tests hold the plan's index math
on the CPU (every query row covered once, each tile's causal frontier,
the order), then run the kernel's arithmetic over the plan in torch: K/V
tiles of ``kv_tile`` positions (zeros past the chunk, as the kernel's TMA
reads them), scores in f32 from bf16 operands, the row max and sum kept
online in the exp2 domain, P rounded to bf16 for P·V. That emulation is
held to ``flash_prefill_plain`` and to JAX's ``flash_prefill_stacked``
(Pallas row 13) in interpret mode at the kernel's own tolerance, 2^-6 of
the output's largest magnitude. The kernel itself is held to the plain
version on the card (``tests/test_torch_decode_attn.py``).
"""

import math

import numpy as np
import pytest
import torch

from awq_tpu_torch.ops import decode_attn as tda

# One intra-op thread: the CPU tensors here are small, and the test workers
# share the cores.
torch.set_num_threads(1)

TOL = 2.0 ** -6
# (B, S, nq, nkv, hd, T, start): g = 1, 4 and 71 (falcon: hd 64, one kv
# head); S no multiple of the 128-row tile; start > 0; B = 2
CASES = [(1, 40, 2, 2, 128, 256, 0), (2, 70, 8, 2, 128, 256, 37), (2, 45, 4, 1, 128, 256, 100),
         (1, 50, 71, 1, 64, 256, 0), (2, 19, 71, 1, 64, 256, 90)]


def _coverage(plan):
    seen = {}
    for x in range(plan.blocks):
        b, h, r0, r1, frontier = plan.tile(x)
        assert 0 <= r0 < r1 <= plan.rows and r1 - r0 <= tda.PREFILL_ROWS
        for r in range(r0, r1):
            key = (b, h, r // plan.g, r % plan.g)
            assert key not in seen, key
            seen[key] = x
        assert frontier == min(plan.start + (r1 - 1) // plan.g + 1, plan.t)
    return seen


@pytest.mark.parametrize("b,s,nq,nkv,hd,t,start", CASES + [(1, 1000, 32, 8, 128, 4096, 0),
                                                         (1, 512, 71, 1, 64, 2048, 700)])
def test_plan_covers_every_query_row_once(b, s, nq, nkv, hd, t, start):
    plan = tda.prefill_plan(b, s, nq, nkv, t, start, hd)
    assert plan.g == nq // nkv and plan.rows == s * plan.g
    assert plan.n_tiles == -(-s * plan.g // tda.PREFILL_ROWS)
    assert plan.blocks == plan.n_tiles * b * nkv
    assert plan.kv_tile == {128: 64, 64: 128}[hd]
    seen = _coverage(plan)
    assert len(seen) == b * nkv * s * plan.g
    # each tile's frontier is its last row's position + 1 past start, the
    # largest limit of its rows (row r attends keys <= start + r // g)
    for x in range(plan.blocks):
        _, _, r0, r1, frontier = plan.tile(x)
        assert frontier == start + max(r // plan.g for r in range(r0, r1)) + 1


@pytest.mark.parametrize("b,s,nq,nkv,hd,t,start", CASES + [(1, 1000, 32, 8, 128, 4096, 0)])
def test_plan_orders_tiles_heavy_first(b, s, nq, nkv, hd, t, start):
    plan = tda.prefill_plan(b, s, nq, nkv, t, start, hd)
    fronts = [plan.tile(x)[4] for x in range(plan.blocks)]
    assert all(a >= c for a, c in zip(fronts, fronts[1:])), fronts
    # the first wave holds the tile with the longest frontier of every
    # (row, kv head), the last block the shortest
    first = {plan.tile(x)[:2] for x in range(b * nkv)}
    assert len(first) == b * nkv and fronts[0] == start + s
    assert fronts[-1] == start + (min(tda.PREFILL_ROWS, plan.rows) - 1) // plan.g + 1


def _bf16(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float()


def emulate(q, cache, start, plan):
    """The kernel's arithmetic over ``plan``, block by block, in torch f32:
    ``q [B, S, nq, hd]`` and ``cache [2, B, nkv, T, hd]`` hold
    bf16-representable values. Returns ``[B, S, nq * hd]``."""
    b, s, nq, hd = q.shape
    g, bkv, end = plan.g, plan.kv_tile, start + s
    scale_log2 = tda._LOG2E / math.sqrt(hd)
    out = torch.full((b, s, nq, hd), float("nan"))
    for x in range(plan.blocks):
        bi, h, r0, r1, frontier = plan.tile(x)
        rows = torch.arange(r0, r1)
        pos, gi = rows // g, rows % g
        qb = q[bi, pos, h * g + gi]
        lim = start + pos
        m = torch.full((len(rows),), float("-inf"))
        l = torch.zeros(len(rows))
        o = torch.zeros(len(rows), hd)
        for j0 in range(0, frontier, bkv):
            kt, vt = torch.zeros(bkv, hd), torch.zeros(bkv, hd)
            n = max(0, min(bkv, end - j0))      # positions past the chunk read zeros
            kt[:n], vt[:n] = cache[0, bi, h, j0:j0 + n], cache[1, bi, h, j0:j0 + n]
            keys = torch.arange(j0, j0 + bkv)
            sc = (qb @ kt.t()) * scale_log2
            sc = sc.masked_fill(keys[None, :] > lim[:, None], float("-inf"))
            mn = torch.maximum(m, sc.amax(1))
            ref = torch.where(mn == float("-inf"), torch.zeros_like(mn), mn)
            alpha = torch.exp2(m - ref)
            m = mn
            p = torch.exp2(sc - ref[:, None])
            l = l * alpha + p.sum(1)
            o = o * alpha[:, None] + p.to(torch.bfloat16).float() @ vt
        out[bi, pos, h * g + gi] = o / l[:, None]
    assert not out.isnan().any()
    return out.reshape(b, s, nq * hd)


def _check(got, ref):
    err = (got - ref).abs().max().item()
    assert err <= TOL * ref.abs().max().item(), err


@pytest.mark.parametrize("b,s,nq,nkv,hd,t,start", CASES)
def test_emulation_matches_plain_and_pallas_row_13(b, s, nq, nkv, hd, t, start):
    import jax.numpy as jnp
    from awq_tpu.ops import decode_attn as jda

    rng = np.random.default_rng(s + nq + start)
    q = _bf16(rng, b, s, nq, hd)
    cache = _bf16(rng, 2, b, nkv, t, hd)
    plan = tda.prefill_plan(b, s, nq, nkv, t, start, hd)
    got = emulate(q, cache, start, plan)
    _check(got, tda.flash_prefill_plain(q, cache, start))
    ref = np.array(jda.flash_prefill_stacked(
        jnp.asarray(q.numpy()), jnp.asarray(cache.numpy()[None]), jnp.int32(0),
        jnp.int32(start), block_q=s, interpret=True, fixed_max=None))
    _check(got, torch.from_numpy(ref))


def test_emulation_ignores_the_cache_past_the_chunk():
    """Positions at or past start + S are never attended: the kernel's TMA
    reads them as zeros and the mask drops them; poisoning them changes
    nothing."""
    rng = np.random.default_rng(5)
    b, s, nq, nkv, hd, t, start = 1, 70, 8, 2, 128, 256, 30
    q = _bf16(rng, b, s, nq, hd)
    cache = _bf16(rng, 2, b, nkv, t, hd)
    plan = tda.prefill_plan(b, s, nq, nkv, t, start, hd)
    poisoned = cache.clone()
    poisoned[:, :, :, start + s:] = float("nan")
    assert torch.equal(emulate(q, cache, start, plan), emulate(q, poisoned, start, plan))
