"""The schedule of K5, the chunk mode of K6's body (``ops/megakernel_batched.py::
batched_plan`` with ``cluster`` > 0, which ``ops/megakernel_chunk.py`` hands to
``csrc/megakernel_batched.cu`` built with ``AWQ_MEGA_CHUNK``), and a torch
emulation of its order of sums.

A window of 1..32 rows runs on a cooperative grid of thread-block clusters.
Every matmul phase hands its 16-column tile units (gate/up: a gate and an up
block) to the clusters in equal runs; each block of a cluster (its rank)
takes the cluster's units over its own run of the input channels' chunks,
stages its rows over windows of that run, takes its tiles in waves with
``k`` warps splitting a tile's chunks, adds the warps' sums in warp order and
carries a window's sums to the next; the cluster then adds the ranks' sums
in rank order through distributed shared memory, and rank q finishes its
rows. Codes are exact and centred (q - 8 in W4, q - 4 in W3). The attention takes a kv
head's packed (window row, head) query rows over slices of the positions
(``chunk_slices``), in tiles of ``TP`` positions with an online softmax, q,
k and P at f32's precision and V in the mma type; a combine merges the
slices.

These tests hold the plan on the CPU (every weight byte and every chunk of
IC once, the windows, the shared memory and its regions, the slices, and a
refusal of what the kernel refuses; K6's own layout is pinned in
``test_torch_batched_plan.py``), and hold the
emulation to the plain version and to the JAX package's interpret-mode
``w4a16_llama_chunk_step`` (Pallas row 17) in W4 and W3 over f32, bf16 and
f16 caches. The kernel is held to the plain version and to this emulation
on the card (``tests/test_torch_megakernel.py``).
"""

import math

import numpy as np
import pytest
import torch

from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops import megakernel_batched as tmb
from awq_tpu_torch.ops import megakernel_chunk as tmc

# One intra-op thread: the CPU tensors here are small, and the test workers
# share the cores.
torch.set_num_threads(1)

LLAMA3_8B = dict(H=4096, I=14336, nq=32, nkv=8)
TINY = dict(H=1024, I=2048, nq=8, nkv=2)
ROWS = (1, 2, 16, 17, 32)
# an H100's grid in clusters of 1, 2 and 4 blocks (the smoke's cluster probe)
GRIDS = {1: 132, 2: 132, 4: 120}


def _plan(cfg, s, w3, cluster):
    return tmb.batched_plan(s, cfg["H"], cfg["I"], cfg["nq"], cfg["nkv"], 0, w3,
                            GRIDS[cluster], cluster=cluster)


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("w3", [False, True])
@pytest.mark.parametrize("cfg", [LLAMA3_8B, TINY], ids=["llama3_8b", "tiny"])
@pytest.mark.parametrize("s", ROWS)
def test_every_weight_byte_and_chunk_is_taken_once(cfg, s, w3, cluster):
    """The clusters' runs of units cover each phase's units once, in order;
    the ranks' runs of chunks cover IC once, in order, and each rank's
    windows its own run; a wave's warps fit the eight consumers and no wave
    holds more tiles than a cluster has (no box reads past them)."""
    p = _plan(cfg, s, w3, cluster)
    assert list(p["phases"]) == ["qkv", "o", "gateup", "down"]
    assert p["cluster"] == cluster and p["grid"] % cluster == 0
    for name, ph in p["phases"].items():
        assert ph["units"] * 16 * ph["unit"] == ph["oc"]
        assert len(ph["blocks"]) == p["grid"] // cluster
        seen = np.zeros(ph["units"], dtype=np.int64)
        end = 0
        for u0, u1 in ph["blocks"]:
            assert u0 == end and u1 >= u0
            seen[u0:u1] += 1
            end = u1
        assert end == ph["units"] and (seen == 1).all(), name
        tmax = max(u1 - u0 for u0, u1 in ph["blocks"]) * ph["unit"]
        assert ph["unit"] <= ph["wave"] <= tmax and ph["wave"] % ph["unit"] == 0
        assert ph["wave"] * ph["k"] * p["row_halves"] <= tmb.WARPS
        chunks = np.zeros(ph["nch"], dtype=np.int64)
        end = 0
        for q, (c0, c1) in enumerate(ph["ranks"]):
            assert c0 == end and c1 > c0
            end = c1
            wins = tmb.rank_windows(ph, q)
            assert wins[0][0] == c0 and wins[-1][1] == c1 and len(wins) == ph["windows"]
            for (a0, a1), (b0, _) in zip(wins, wins[1:]):
                assert a1 == b0
            assert all(0 < w1 - w0 <= p["window"] for w0, w1 in wins)
            for w0, w1 in wins:
                chunks[w0:w1] += 1
        assert end == ph["nch"] and (chunks == 1).all()


def _fits(lay, b, w3, wc, chunk):
    """csrc/megakernel_batched.cu::layout_fits, the kernel's check: the
    regions at an offset the build fixes (OFF_BARS, OFF_RED, OFF_RS) where
    it carves them, the others aligned and as large as it uses them."""
    kc = 256 if w3 else 128
    bp = -(-b // 8) * 8
    slots = lay["slots"]
    nbar = 2 * slots + 1 + (2 if chunk else 0)
    xs_bytes, rows_bytes = bp * (wc * kc // 128) * 4, bp * (wc * kc // 2 + 8) * 4
    att = tmb.CHUNK_ATT_BYTES if chunk else tmb.ATT_BYTES
    o, smem = lay, lay["smem"]
    bars = 128 + slots * tmb.stage_bytes(w3)
    red = (bars + 8 * nbar + 127) // 128 * 128
    ok = (smem <= tmb.SMEM_MAX and o["bars"] == bars and o["red"] == red
          and o["rs"] == red + tmb.RED_BYTES and o["att"] == red
          and o["xsum"] % 16 == 0 and o["xsum"] >= o["rs"] + tmb.RS_BYTES
          and o["rows"] % 16 == 0 and o["rows"] >= o["xsum"] + xs_bytes
          and o["rows"] + rows_bytes <= smem and o["att"] + att <= smem)
    if chunk:
        ok = ok and (o["tot"] % 16 == 0 and o["tot"] >= o["rows"] + rows_bytes
                     and o["tot"] + tmb.TOT_BYTES <= smem)
    return ok


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("w3", [False, True])
@pytest.mark.parametrize("cfg", [LLAMA3_8B, TINY], ids=["llama3_8b", "tiny"])
@pytest.mark.parametrize("s", ROWS)
def test_shared_memory_fits_and_passes_the_kernels_checks(cfg, s, w3, cluster):
    """The window fits 227 KB beside a ring of at least 32 KB; the regions
    that the wrapper hands the kernel (``_layout_ints``) pass its check, the
    merge's sums lie past the rows and the merge's barriers in the barrier
    region; the plan's ints are what the kernel reads."""
    p = _plan(cfg, s, w3, cluster)
    lay = p["layout"]
    assert p["smem"] == lay["smem"] <= tmb.SMEM_MAX
    assert p["slots"] * p["stage_bytes"] >= 32 * 1024
    assert _fits(lay, s, w3, p["window"], True)
    ints = tmb._chunk_plan_ints(s, cfg["H"], cfg["I"], cfg["nq"], cfg["nkv"], w3,
                                GRIDS[cluster], cluster)
    assert len(ints) == 4 + 15 + len(tmb.REGIONS) + 1
    assert ints[:4] == (p["grid"], p["smem"], p["slots"], p["window"])
    assert ints[19:26] == tuple(lay[r] for r in tmb.REGIONS) and ints[-1] == cluster
    assert ints[4 + 12:4 + 15] == (0, 0, 0)            # no head
    for i, name in enumerate(("qkv", "o", "gateup", "down")):
        ph = p["phases"][name]
        assert ints[4 + 3 * i:7 + 3 * i] == (ph["wave"], ph["k"], ph["windows"])
        assert 16 * ph["wave"] // ph["unit"] <= 256 and ph["k"] * (24 if w3 else 16) <= 256


@pytest.mark.parametrize("s,hist", [(1, 0), (16, 0), (17, 40), (32, 700), (24, 1031),
                                    (32, 4064)])
@pytest.mark.parametrize("cfg", [LLAMA3_8B, TINY], ids=["llama3_8b", "tiny"])
def test_attention_slices(cfg, s, hist):
    """The slices cover ``[0, hist + s)`` in whole tiles of ``TP``, none
    empty; a block of 128 packed query rows; about one item a block."""
    grid = 132
    nrb, nsplit, split = tmb.chunk_slices(s, hist, cfg["nq"], cfg["nkv"], grid)
    npos = hist + s
    assert split % tmb.TP == 0 and (nsplit - 1) * split < npos <= nsplit * split
    assert nrb == -(-(s * cfg["nq"] // cfg["nkv"]) // 128)
    assert cfg["nkv"] * nrb * nsplit <= max(grid, cfg["nkv"] * nrb)


def test_plan_refuses_what_the_kernel_refuses():
    for s in (0, 33):
        with pytest.raises(ValueError):
            _plan(LLAMA3_8B, s, False, 2)
    with pytest.raises(ValueError, match="head"):
        tmb.batched_plan(16, 4096, 14336, 32, 8, 128256, False, 132, cluster=2)
    with pytest.raises(ValueError, match="clusters"):
        tmb.batched_plan(16, 4096, 14336, 32, 8, 0, False, 130, cluster=4)
    with pytest.raises(ValueError, match="finer"):
        tmb.batched_plan(16, 256, 512, 2, 2, 0, True, 132, cluster=2)


# ---- a torch emulation of K5's order of sums -------------------------------------

def _seq_sum(parts):
    acc = torch.zeros_like(parts[0])
    for x in parts:
        acc = acc + x
    return acc


def _group_sums(xb, folded):
    """Σ bf16(x) over each group of 128 channels as the staging adds it
    (``test_torch_batched_plan._group_sums``)."""
    b, ic = xb.shape
    v = xb.reshape(b, ic // 16, 16)
    if folded:
        s16 = _seq_sum([v[..., e] for e in range(16)])
    else:
        s16 = _seq_sum([v[..., 2 * p] + v[..., 2 * p + 1] for p in (0, 4, 1, 5, 2, 6, 3, 7)])
    s = s16.reshape(b, ic // 128, 8)
    for o in (1, 2, 4):
        s = s + s[..., torch.arange(8) ^ o]
    return s[..., 0]


def _sched(plan, kinds):
    """``qdot_layer`` and ``rms_rows`` as K5 orders their f32 sums: codes
    centred (exact); per rank, its windows, each the sum of its warps in warp order
    (warp kp takes chunks kp, kp + k, ...); the ranks' sums in rank order;
    each row's sum of squares over the clusters' runs of columns in order."""
    kc = plan["chunk"]
    ncl = plan["grid"] // plan["cluster"]

    def qdot(ql, l, x):
        qw, s, z = ql.qweight[l], ql.scales[l], ql.szeros[l]
        ph = plan["phases"][kinds[id(ql)]]
        b, ic = x.shape
        oc = qw.shape[-1]
        ng = ic // 128
        xb = x.to(torch.bfloat16).float()
        xs = _group_sums(xb, kinds[id(ql)] in ("qkv", "gateup"))          # [b, ng]
        # codes centred as the kernel takes them: q - 8 (W4), q - 4 (W3)
        c = 4.0 if ql.dense3 else 8.0
        q = tmk.unpack_codes(qw, ql.dense3).reshape(ng, 128, oc) - c
        dot = torch.einsum("bgk,gkc->gbc", xb.reshape(b, ng, 128), q)
        contrib = dot * s[:, None, :] - xs.t()[:, :, None] * (z - c * s)[:, None, :]
        gpc = kc // 128
        ranks = []
        for q_ in range(plan["cluster"]):
            part = None
            for c0, c1 in tmb.rank_windows(ph, q_):
                warps = []
                for kp in range(ph["k"]):
                    acc = torch.zeros(b, oc)
                    for c in range(c0 + kp, c1, ph["k"]):
                        for g in range(c * gpc, (c + 1) * gpc):
                            acc = acc + contrib[g]
                    warps.append(acc)
                v = _seq_sum([torch.zeros(b, oc)] + warps)
                part = v if part is None else part + v
            ranks.append(part)
        return _seq_sum([torch.zeros(b, oc)] + ranks)

    def rms(x, w, eps):
        h = x.shape[1]
        units = h // 16
        runs = [(g * units // ncl * 16, (g + 1) * units // ncl * 16) for g in range(ncl)]
        ss = _seq_sum([(x[:, c0:c1] * x[:, c0:c1]).sum(dim=1) for c0, c1 in runs])
        return x * torch.rsqrt(ss / h + eps)[:, None] * w.float()

    return qdot, rms


def _attend(grid, nq, nkv):
    """``attend_window`` as K5's attention orders it: a kv head's packed
    (window row, head) query rows over the slices of ``chunk_slices``, tiles
    of TP positions, an online max and sum in f32; q, k and P at f32's
    precision (hi and lo halves of the mma type in the kernel), V in the mma
    type (bf16; f16 over an f16 cache: an f32 cache's and the window's own
    rounded to it); the slices merged as the combine merges them."""

    def attend(qs, keys, vals, hist, dtype):
        s, _, grp, hd = qs.shape
        mt = torch.float16 if dtype == torch.float16 else torch.bfloat16
        npos = hist + s
        k, v = keys, vals.to(mt).float()
        R = s * grp
        qp = qs.permute(1, 0, 2, 3).reshape(nkv, R, hd)        # row r * grp + g
        limit = hist + torch.arange(R) // grp
        _, nsplit, split = tmb.chunk_slices(s, hist, nq, nkv, grid)
        out = torch.zeros(nkv, R, hd)
        for kvh in range(nkv):
            ms, ls, accs = [], [], []
            for sp in range(nsplit):
                p0, p1 = sp * split, min(sp * split + split, npos)
                m = torch.full((R,), -math.inf)
                l_ = torch.zeros(R)
                acc = torch.zeros(R, hd)
                for t0 in range(p0, p1, tmb.TP):
                    pos = torch.arange(t0, min(t0 + tmb.TP, npos))
                    sc = qp[kvh] @ k[kvh, pos].t()
                    seen = (pos[None, :] < p1) & (pos[None, :] <= limit[:, None])
                    sc = sc.masked_fill(~seen, -math.inf)
                    mn = torch.maximum(m, sc.amax(dim=1))
                    mb = torch.where(mn == -math.inf, torch.zeros_like(mn), mn)
                    alpha = torch.exp(m - mb)
                    p = torch.exp(sc - mb[:, None])
                    l_ = l_ * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ v[kvh, pos]
                    m = mn
                ms.append(m)
                ls.append(l_)
                accs.append(acc)
            mx = torch.stack(ms).amax(dim=0)
            f = [torch.exp(m_ - mx) for m_ in ms]
            lt = _seq_sum([l_ * f_ for l_, f_ in zip(ls, f)])
            at = _seq_sum([a_ * f_[:, None] for a_, f_ in zip(accs, f)])
            out[kvh] = at / lt[:, None]
        return out.reshape(nkv, s, grp, hd).permute(1, 0, 2, 3)

    return attend


def emulate(monkeypatch, h, ws, ln1, ln2, cos, sin, cache, hist, nq, nkv, grid, cluster,
            eps=1e-5):
    """K5's window, emulated in torch on the CPU: the plain version with its
    matmuls, norms and attention in K5's orders (``_sched``, ``_attend``) on
    a copy of ``cache``; returns ``(h_new, k_new, v_new)``."""
    wq, wo, wgu, wdn = ws
    plan = tmb.batched_plan(h.shape[0], wq.in_features, wdn.in_features, nq, nkv, 0,
                            wq.dense3, grid, cluster=cluster)
    kinds = {id(wq): "qkv", id(wo): "o", id(wgu): "gateup", id(wdn): "down"}
    qdot, rms = _sched(plan, kinds)
    with monkeypatch.context() as mp:
        mp.setattr(tmc, "qdot_layer", qdot)
        mp.setattr(tmc, "rms_rows", rms)
        mp.setattr(tmc, "attend_window", _attend(grid, nq, nkv))
        return tmc.w4a16_llama_chunk_step_plain(h, wq, wo, wgu, wdn, ln1, ln2, cos, sin,
                                                cache.clone(), hist, nq, nkv, eps)


def _close(got, ref, tol):
    f32 = lambda a: a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    got, ref = f32(got), f32(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


# test_torch_megakernel.py::CHUNK_TOL: 2^-6 of an output's largest magnitude
# against JAX's interpret-mode kernel and between orders of f32 sums (a bf16
# scratch value on a rounding edge lands on the other side, and the window's
# QKV, gate/up, hm and residual roundings compound over the layers).
TOL = 2.0 ** -6


@pytest.mark.parametrize("hist", [0, 40, 200])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("w3", [False, True], ids=["w4", "w3"])
def test_emulated_chunk_step_matches_plain_and_jax(w3, cdt, hist, monkeypatch):
    """A 17-row window, 2 layers, a QKV bias, 4 q heads over 2 kv heads: the
    plan on 132 blocks in clusters of 2 (each rank half of IC), the
    emulation against the plain version and JAX's interpret-mode row 17 on
    the same inputs and cache dtype."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel_chunk import w4a16_llama_chunk_step
    from awq_tpu_torch.convert import params_from_jax
    from test_torch_megakernel import _inputs, _jax_lins
    from test_torch_w3_model import _jax_lins3

    s, nq, nkv, H, I, L = 17, 4, 2, 512, 512, 2
    jl = (_jax_lins3 if w3 else _jax_lins)(31 + hist, H, I, nq, nkv, L, bias=True)
    t = params_from_jax(jax.device_get(jl), device="cpu")
    assert t["wqkv"].dense3 == w3
    inp = _inputs(32 + hist, H, L, nkv, rows=tmc.CHUNK_S)
    cos, sin = np.cos(inp["ang"]), np.sin(inp["ang"])
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[cdt]
    jcache = jnp.asarray(inp["cache"]).astype(jdt)
    cache = torch.from_numpy(np.array(jcache.astype(jnp.float32))).to(cdt)
    jh, jk, jv = w4a16_llama_chunk_step(
        jnp.asarray(inp["h"]).at[s:].set(0.0), jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"],
        jnp.asarray(inp["ln1"]), jnp.asarray(inp["ln2"]), jnp.asarray(cos), jnp.asarray(sin),
        jcache, jnp.int32(hist), nq=nq, nkv=nkv, eps=1e-5, interpret=True)
    ws = [t["wqkv"], t["wo"], t["wgateup"], t["down"]]
    args = (torch.from_numpy(inp["h"][:s].copy()), ws, torch.from_numpy(inp["ln1"]),
            torch.from_numpy(inp["ln2"]), torch.from_numpy(cos[:s].copy()),
            torch.from_numpy(sin[:s].copy()), cache, hist, nq, nkv)
    plain = tmc.w4a16_llama_chunk_step_plain(args[0], *ws, *args[2:6], cache.clone(), hist,
                                             nq, nkv)
    emu = emulate(monkeypatch, *args, 132, 2)
    ref = (jh[:s], jk[:, :, :s], jv[:, :, :s])
    for g, p, r in zip(emu, plain, ref):
        _close(g, p, TOL)
        _close(g, np.asarray(jnp.asarray(r).astype(jnp.float32)), TOL)
    assert emu[1].dtype == emu[2].dtype == cdt
