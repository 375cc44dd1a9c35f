"""The split flash decode's host plan (``ops/decode_attn.py::decode_plan``)
and a torch emulation of the kernel's order of operations (K2, K8, K9 and
K14 in ``csrc/decode_attn.cu``).

The plan cuts each (row, kv head) into ``cluster`` slices of ``per``
positions, one block each, whose blocks form a thread-block cluster; it
must cover every row's positions once, keep slices on tile (and K8's page)
edges, and fit the card's shared memory. The emulation replays the kernel
on the CPU: per block, per warp a 16- or 32-position share of each
64-position tile with its own online softmax, q * scale split into two
halves of the mma type, P rounded to it before P.V (the row sums add the
f32 weights; K9's codes in f16), K9's scales on the score and the weight;
then the block's warps merged, then the cluster's blocks, the current
token last (sums in rank order here; the kernel's shuffle trees differ in
rounding only). It is held to the plain versions (``flash_decode_plain``,
``flash_decode_int8_plain``, ``flash_decode_layer_plain``) and through them
to JAX's kernels, which the other port tests hold them to.
"""

import math

import numpy as np
import pytest
import torch

from awq_tpu_torch.ops import decode_attn as tda

# One intra-op thread: the tensors here are small, and the test workers
# share the cores.
torch.set_num_threads(1)

LENGTHS = [0, 1, 31, 32, 33, 1000, 2047, 4000]
# (name, nq, nkv, hd, element bytes, slice unit, page), as the wrappers ask:
# K2 and K9 at Llama-3-8B's group, K8 over pages of 256 and of 16, K14 at
# Falcon-7B's (71 q heads over one kv head, head_dim 64), at Llama-3-8B's
# and at its widest group (128); K2, K9 and K8 at Falcon-7B's group and K2
# at the widest over an f32 cache (the unit decode_attn_wide's shapes)
K2U, T = tda.K2_UNIT, tda.DECODE_TILE
KINDS = [("k2", 32, 8, 128, 2, K2U, 0), ("k2_f32", 16, 1, 128, 4, K2U, 0),
         ("k9", 32, 8, 128, 1, T, 0), ("k8_256", 32, 8, 128, 2, K2U, 256),
         ("k8_16", 32, 8, 128, 2, K2U, 16), ("k14_falcon", 71, 1, 64, 2, T, 0),
         ("k14_llama", 32, 8, 128, 2, T, 0), ("k14_g128_f32", 128, 1, 128, 4, T, 0),
         ("k2_falcon", 71, 1, 64, 2, K2U, 0), ("k2_g128_f32", 128, 1, 128, 4, K2U, 0),
         ("k9_falcon", 71, 1, 64, 1, T, 0), ("k8_falcon_16", 71, 1, 64, 2, K2U, 16)]


def _plan(kind, b, max_length):
    name, nq, nkv, hd, esize, unit, page = kind
    return tda.decode_plan(b, nq, nkv, hd, max_length, esize, unit, page,
                           cur=not name.startswith("k14"))


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("max_length", LENGTHS)
@pytest.mark.parametrize("kind", KINDS, ids=[k[0] for k in KINDS])
def test_plan_covers_every_row_once_on_tile_and_page_edges(kind, max_length, b):
    plan = _plan(kind, b, max_length)
    assert plan.per % tda.DECODE_TILE == 0 and plan.per >= tda.DECODE_TILE
    if plan.page:
        assert plan.per % plan.page == 0          # K8: whole pages a block
    # rows of every length up to max_length: each position read by one block
    for length in sorted({0, 1, max_length // 3, max_length - 1, max_length} - {-1}):
        seen = np.zeros(max(length, 1), np.int32)
        for rank in range(plan.cluster):
            lo, hi = plan.slice(rank, length)
            assert lo % tda.DECODE_TILE == 0 and lo <= hi
            seen[lo:hi] += 1
        assert (seen[:length] == 1).all() and (seen[length:] == 0).all()
    # no block starts past the longest row (cluster is as small as it can be)
    assert plan.cluster == 1 or (plan.cluster - 1) * plan.per < max_length


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("max_length", LENGTHS)
@pytest.mark.parametrize("kind", KINDS, ids=[k[0] for k in KINDS])
def test_plan_fits_the_card(kind, max_length, b):
    plan = _plan(kind, b, max_length)
    assert 1 <= plan.cluster <= tda.MAX_CLUSTER and plan.blocks % plan.cluster == 0
    assert plan.blocks == plan.cluster * plan.nkv * b       # grid (cluster, nkv, b)
    assert 2 <= plan.stages <= 4
    assert plan.smem <= tda.SMEM_MAX and plan.threads <= 512
    lay = plan.layout()
    # regions on 16-byte (cp.async, ldmatrix) boundaries; a position's row is
    # a whole number of 16-byte copies, and so is K8's page stride
    assert all(lay[k] % 16 == 0 for k in ("hdr", "q", "stage", "ring", "wide", "ps"))
    # (K9's int8 rows at head_dim 64 have four chunks, swizzled by two bits)
    assert plan.row_bytes % 16 == 0 and plan.row_bytes // 16 >= (
        4 if plan.esize == 1 and plan.hd == 64 else 8)
    if plan.page:
        assert (plan.nkv * plan.page * plan.row_bytes) % 16 == 0
    for rank in range(plan.cluster):
        lo, hi = plan.slice(rank, max_length)
        offs = {(t * plan.row_bytes + c * 16) for t in range(lo, min(hi, lo + 3))
                for c in range(plan.row_bytes // 16)}
        assert all(o % 16 == 0 for o in offs)
    # the warps' states overlay the main region and fit
    assert lay["merge"] <= lay["total"] - lay["hdr"]
    # a ring no deeper than the slice's tiles; two blocks of a 16-block
    # cluster fit one SM unless even two stages do not
    assert plan.stages <= max(2, -(-min(plan.per, max_length) // tda.DECODE_TILE) + 1)
    if plan.cluster > 8 and plan.stages > 2:
        assert 2 * (plan.smem + 1024) <= tda.SMEM_SM


@pytest.mark.parametrize("page", [256, 128, 64, 16])
@pytest.mark.parametrize("b,max_length", [(1, 1), (1, 1000), (1, 4000), (8, 1200), (3, 257)])
def test_k8_slices_rows_as_k2_does(b, max_length, page):
    """Over pages dividing K2_UNIT, K8's plan is K2's: the same slices, so
    the same sums in the same order (K8's output equals K2's bit for bit)."""
    k2 = tda.decode_plan(b, 32, 8, 128, max_length, 2, K2U)
    k8 = tda.decode_plan(b, 32, 8, 128, max_length, 2, K2U, page)
    assert (k8.cluster, k8.per, k8.stages) == (k2.cluster, k2.per, k2.stages)
    assert k8.per % page == 0


def test_plan_fills_one_wave_and_grows_tiles_with_the_cache():
    # Llama-3-8B at batch 1: 8 kv heads x 16 blocks on 132 SMs
    p = tda.decode_plan(1, 32, 8, 128, 4000, 2, K2U)
    # (3 stages: two blocks of a 16-block cluster share an SM)
    assert (p.cluster, p.per, p.stages, p.blocks) == (16, 256, 3, 128)
    # a longer cache gives each block more tiles, never a larger cluster
    p2 = tda.decode_plan(1, 32, 8, 128, 32000, 2, K2U)
    assert (p2.cluster, p2.per) == (16, 2048)
    # falcon-7b: one kv head, the whole 71-head group in every block
    f = tda.decode_plan(1, 71, 1, 64, 1000, 2)
    assert (f.cluster, f.per, f.row_tiles, f.warps) == (16, 64, 5, 10)
    # eight rows: two blocks a (row, kv head), 128 blocks in all
    assert tda.decode_plan(8, 32, 8, 128, 1200, 2, K2U).blocks == 128
    # one position: one block a (row, kv head); K14 at 1000 positions: one
    # tile a block, K2 a 256-position unit a block
    assert tda.decode_plan(1, 32, 8, 128, 1, 2, K2U).cluster == 1
    assert tda.decode_plan(1, 32, 8, 128, 1000, 2).cluster == 16
    assert tda.decode_plan(1, 32, 8, 128, 1000, 2, K2U).cluster == 4


def test_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        tda.decode_plan(1, 1024, 1, 128, 100, 4)


# ---- the kernel's order, emulated --------------------------------------------

def _round(x, dtype):
    return x.to(dtype).float() if dtype is not None else x


def _emulate(plan, q, k, v, lengths, k_new=None, v_new=None, scales=None, mma=torch.bfloat16):
    """The kernel's arithmetic on the CPU in f32. ``k``/``v`` [B, nkv, T, hd]
    hold the cache's values (K9: the codes) as f32; ``scales`` [2, B, nkv, T]
    for K9; ``mma`` the mma type (None: the f32 mode, no rounding)."""
    b_, nq, hd = q.shape
    nkv, g = k.shape[1], nq // k.shape[1]
    npw, tile = plan.npw, tda.DECODE_TILE
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty((b_, nq, hd))
    neg = float("-inf")
    for b in range(b_):
        length = int(lengths[b])
        for h in range(nkv):
            qs = q[b, h * g:(h + 1) * g].float() * scale
            q_hi = _round(qs, mma)
            q_lo = _round(qs - q_hi, mma) if mma is not None else torch.zeros_like(qs)
            blocks = []
            for rank in range(plan.cluster):
                lo, hi = plan.slice(rank, length)
                warps = []
                for pw in range(tile // npw):
                    m = torch.full((g,), neg)
                    l = torch.zeros(g)
                    o = torch.zeros((g, hd))
                    for t0 in range(lo, hi, tile):
                        cols = torch.arange(t0 + pw * npw, t0 + (pw + 1) * npw)
                        live = cols < hi
                        idx = cols.clamp(max=k.shape[2] - 1)
                        kk = k[b, h, idx].float() * live[:, None]
                        vv = v[b, h, idx].float() * live[:, None]
                        s = q_hi @ kk.T + q_lo @ kk.T
                        if scales is not None:
                            s = s * (scales[0, b, h, idx] * live)
                        s = s.masked_fill(~live, neg)
                        mn = torch.maximum(m, s.max(dim=1).values)
                        ref = torch.where(mn == neg, torch.zeros_like(mn), mn)
                        alpha = torch.exp(m - ref)
                        p = torch.exp(s - ref[:, None])
                        l = l * alpha + p.sum(dim=1)
                        pv = p * (scales[1, b, h, idx] * live) if scales is not None else p
                        o = o * alpha[:, None] + _round(pv, mma) @ vv
                        m = mn
                    warps.append((m, l, o))
                mb = torch.stack([w[0] for w in warps]).max(dim=0).values
                lb, ob = torch.zeros(g), torch.zeros((g, hd))
                for mw, lw, ow in warps:
                    wgt = torch.where(mw == neg, torch.zeros_like(mw), torch.exp(mw - mb))
                    lb, ob = lb + lw * wgt, ob + ow * wgt[:, None]
                blocks.append((mb, lb, ob))
            if k_new is not None:
                s_c = qs @ k_new[b, h].float()
            else:
                s_c = torch.full((g,), neg)
            m_all = torch.stack([s_c] + [blk[0] for blk in blocks]).max(dim=0).values
            l_all, acc = torch.zeros(g), torch.zeros((g, hd))
            for mb, lb, ob in blocks:
                wgt = torch.where(mb == neg, torch.zeros_like(mb), torch.exp(mb - m_all))
                l_all, acc = l_all + lb * wgt, acc + ob * wgt[:, None]
            if k_new is not None:
                p_c = torch.exp(s_c - m_all)
                l_all = l_all + p_c
                acc = acc + p_c[:, None] * v_new[b, h].float()[None, :]
            out[b, h * g:(h + 1) * g] = acc / l_all[:, None]
    return out


def _normal(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# The kernel's two roundings against the plain versions' f32: P to bf16
# (2^-9 relative a weight) and q's low half (2^-17); sums in other orders.
# 2^-7 of the output's largest magnitude holds them with room; the card's
# check (2^-6) adds the output's own rounding.
EMU_TOL = 2.0 ** -7


def _assert_close(got, ref):
    err = (got - ref.float()).abs().max().item()
    assert err <= EMU_TOL * ref.float().abs().max().item(), err


@pytest.mark.parametrize("lengths", [[0], [1000], [1000, 0, 930, 3, 1200, 850, 64, 977]],
                         ids=["length0", "len1000", "ragged8"])
def test_emulated_k2_matches_plain(lengths):
    rng = np.random.default_rng(len(lengths) + lengths[0])
    b, nq, nkv, hd, t = len(lengths), 32, 8, 128, 1280
    cache = _normal(rng, 2, b, nkv, t, hd).to(torch.bfloat16).float()
    q = _normal(rng, b, nq, hd)
    kn, vn = _normal(rng, b, nkv, hd), _normal(rng, b, nkv, hd)
    lens = torch.tensor(lengths, dtype=torch.int32)
    mx = max(lengths)
    plan = tda.decode_plan(b, nq, nkv, hd, mx, 2, K2U)
    got = _emulate(plan, q, cache[0], cache[1], lens, kn, vn)
    ref = tda.flash_decode_plain(q, kn, vn, cache, lens, max_length=mx)
    _assert_close(got, ref)
    if lengths[0] == 0:   # a row of length 0 returns its current token's v
        torch.testing.assert_close(got[0].reshape(nkv, -1, hd),
                                   vn[0][:, None].expand(nkv, nq // nkv, hd))


def test_emulated_k9_matches_plain():
    from awq_tpu_torch.ops.cache_append import quantize_kv

    rng = np.random.default_rng(9)
    lengths = [700, 0, 129]
    b, nq, nkv, hd, t = len(lengths), 32, 8, 128, 768
    codes, scales = quantize_kv(_normal(rng, 2, b, nkv, t, hd))
    q = _normal(rng, b, nq, hd)
    kn, vn = _normal(rng, b, nkv, hd), _normal(rng, b, nkv, hd)
    lens = torch.tensor(lengths, dtype=torch.int32)
    plan = tda.decode_plan(b, nq, nkv, hd, max(lengths), 1)
    got = _emulate(plan, q, codes[0].float(), codes[1].float(), lens, kn, vn, scales=scales,
                   mma=torch.float16)
    _assert_close(got, tda.flash_decode_int8_plain(q, kn, vn, codes, scales, lens))


@pytest.mark.parametrize("b,nq,nkv,hd,length,mma", [
    (1, 71, 1, 64, 1000, torch.bfloat16), (1, 71, 1, 64, 1, torch.bfloat16),
    (1, 71, 1, 64, 2047, torch.float16), (2, 32, 8, 128, 333, torch.bfloat16),
    (1, 128, 1, 128, 300, None)], ids=["falcon1000", "falcon1", "falcon2047_f16",
                                       "llama333", "g128_f32"])
def test_emulated_k14_matches_plain(b, nq, nkv, hd, length, mma):
    rng = np.random.default_rng(nq + length)
    t = length + 5
    dtype = torch.float32 if mma is None else mma
    q = _normal(rng, b, nq, hd)
    k, v = (_normal(rng, b, nkv, t, hd).to(dtype).float() for _ in range(2))
    plan = tda.decode_plan(b, nq, nkv, hd, length, 4 if mma is None else 2)
    got = _emulate(plan, q, k, v, [length] * b, mma=mma)
    _assert_close(got, tda.flash_decode_layer_plain(q, k, v, length))


def _c_dec_split(length: int, want: int, unit: int) -> tuple:
    """``csrc/decode_attn.cu::dec_split`` line by line, in C's integer
    arithmetic: the split a block of a ``*_dev`` launch works out from the
    length it reads."""
    p = (length + want - 1) // want
    p = (p + unit - 1) // unit * unit
    p = unit if p < unit else p
    c = (length + p - 1) // p
    return p, (1 if c < 1 else c)


# the single-position step's launches under a captured decode step: K2 and
# K9 at Llama-3-8B's and OPT-6.7B's groups, K14 at Falcon-7B's and
# StarCoder's (48 q heads over one kv head, head_dim 128), B = 1, in the
# buckets of runtime/generate.py::plan_bound (255 ... 2047)
DEV_KINDS = [("k2", 32, 8, 128, 2, K2U, True), ("k2_mha", 32, 32, 128, 2, K2U, True),
             ("k9", 32, 8, 128, 1, T, True), ("k14_falcon", 71, 1, 64, 2, T, False),
             ("k14_starcoder", 48, 1, 128, 2, T, False), ("k14_f32", 48, 1, 128, 4, T, False)]


@pytest.mark.parametrize("bucket", [255, 511, 1023, 2047])
@pytest.mark.parametrize("kind", DEV_KINDS, ids=[k[0] for k in DEV_KINDS])
def test_device_length_split_gives_host_plan_slices(kind, bucket):
    """A launch planned for a bucket (``by_length``) whose blocks split by the
    length they read (the kernel's ``dec_split``, mirrored here) gives,
    for EVERY length up to the bucket, the slices of the launch planned on
    the host for that length: the same ``per``, block for block the same
    positions, as many live blocks as the host plan's cluster, the others
    empty; the bucket's cluster holds them all; its shared memory is the
    body's layout at its stages, and it fits the card."""
    _, nq, nkv, hd, esize, unit, cur = kind
    dev = tda.decode_plan(1, nq, nkv, hd, bucket, esize, unit, cur=cur, by_length=True)
    assert dev.by_length and dev.smem == dev.layout()["total"] <= tda.SMEM_MAX
    for length in range(bucket + 1):
        host = tda.decode_plan(1, nq, nkv, hd, length, esize, unit, cur=cur)
        per, live = _c_dec_split(length, dev.want, dev.unit)
        assert (per, live) == tda.decode_split(length, dev.want, dev.unit)
        assert (per, live) == (host.per, host.cluster) and (dev.want, dev.unit) == (
            host.want, host.unit)
        assert live <= dev.cluster
        for rank in range(dev.cluster):
            got = dev.slice(rank, length)
            if rank < live:
                assert got == host.slice(rank, length)
            else:
                assert got[0] == got[1]
    assert dev.cluster == max(_c_dec_split(n, dev.want, dev.unit)[1] for n in range(bucket + 1))
