"""The schedule of K6's matmul phases (``ops/megakernel_batched.py::
batched_plan``, which the wrapper hands to ``csrc/megakernel_batched.cu``)
and a torch emulation of its order of sums.

Every matmul phase of a step (QKV, o-proj, gate/up, down per layer, then the
head) hands its 16-column tile units (gate/up: a gate and an up block
together) to the grid's blocks in equal runs; a block stages its rows over a
window of input channels at once, takes its tiles in waves, ``k`` warps
splitting a tile's chunks (a W4 group or a W3 packing chunk each), adds the
warps' sums in warp order and carries a window's sums to the next in a
block-private buffer. The rmsnorms fold into the staging: each block adds
the blocks' sums of squares of a row in block order. These tests hold the
plan on the CPU (every weight byte once, the bytes a block takes in each
phase against the mean, shared memory, the windows covering IC in order)
and emulate the kernel's order of f32 sums in torch, held to the plain
version and to the JAX package's interpret-mode
``w4a16_llama_token_step_batched`` (Pallas row 18) for W4, W3, the int8
cache and the page pool. The attention keeps the plain version's order
here: the emulation is of the matmuls and the folded norms. The kernel
itself is held to the plain version on the card
(``tests/test_torch_megakernel_batched.py``, ``test_torch_kv8.py``,
``test_torch_paged.py``, ``test_torch_w3_model.py``).
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops import megakernel_batched as tmb

# One intra-op thread: the CPU tensors here are small, and the test workers
# share the cores.
torch.set_num_threads(1)

N_SM = 132
LLAMA3_8B = dict(H=4096, I=14336, nq=32, nkv=8, vocab=128256)
TINY = dict(H=256, I=512, nq=2, nkv=2, vocab=256)
ROWS = (2, 8, 13, 32, 64)


def _plan(cfg, b, w3, grid=N_SM):
    return tmb.batched_plan(b, cfg["H"], cfg["I"], cfg["nq"], cfg["nkv"], cfg["vocab"], w3,
                            grid)


@pytest.mark.parametrize("w3", [False, True])
@pytest.mark.parametrize("cfg", [LLAMA3_8B, TINY])
@pytest.mark.parametrize("b", ROWS)
def test_every_weight_byte_is_taken_once(cfg, b, w3):
    """The blocks' runs of units cover each phase's units once, in order;
    a wave's warps (k a tile, one a row half) fit the eight consumers, and
    gate/up's waves hold whole pairs."""
    p = _plan(cfg, b, w3)
    assert list(p["phases"]) == ["qkv", "o", "gateup", "down", "head"]
    for name, ph in p["phases"].items():
        assert ph["units"] * 16 * ph["unit"] == ph["oc"]
        seen = np.zeros(ph["units"], dtype=np.int64)
        end = 0
        for u0, u1 in ph["blocks"]:
            assert u0 == end and u1 >= u0
            seen[u0:u1] += 1
            end = u1
        assert end == ph["units"] and (seen == 1).all(), name
        assert ph["wave"] >= 1 and ph["wave"] % ph["unit"] == 0
        assert ph["wave"] * ph["k"] * p["row_halves"] <= tmb.WARPS
        assert len(p["phases"]) == 5


@pytest.mark.parametrize("w3", [False, True])
@pytest.mark.parametrize("b", ROWS)
def test_bytes_a_block_takes_in_each_phase(b, w3):
    """Llama-3-8B on 132 blocks, one an SM: the busiest block takes within
    10% of the mean bytes of o-proj, gate/up, down and the head (runs of
    units that differ by one: 1.031x in o-proj and down, 1.031x in gate/up,
    1.005x in the head), and 1.031x in QKV (3 or 2 of 384 units, with rope
    moved to the attention no unit pairing is needed)."""
    p = _plan(LLAMA3_8B, b, w3)
    wbytes = 3 if w3 else 4
    spread = {}
    for name, ph in p["phases"].items():
        unit = ph["unit"] * 16 * (ph["ic"] * wbytes // 8 + 2 * 4 * ph["ic"] // 128)
        by = [(u1 - u0) * unit for u0, u1 in ph["blocks"]]
        spread[name] = max(by) / (sum(by) / len(by))
        assert sum(by) == ph["units"] * unit
    assert max(spread.values()) <= 1.1, spread
    assert spread["head"] <= 1.005


@pytest.mark.parametrize("w3", [False, True])
@pytest.mark.parametrize("cfg", [LLAMA3_8B, TINY])
@pytest.mark.parametrize("b", ROWS)
def test_shared_memory_ring_and_windows(cfg, b, w3):
    """A block's shared memory stays under 227 KB with at least 32 KB of
    code and scale rows in flight; the windows over IC are runs of whole
    chunks that cover IC in order, none longer than the rows' room."""
    p = _plan(cfg, b, w3)
    assert p["smem"] <= tmb.SMEM_MAX == 227 * 1024
    assert p["slots"] * p["stage_bytes"] >= 32 * 1024
    assert p["chunk"] == (256 if w3 else 128)
    assert p["row_halves"] == (1 if b <= 32 else 2)
    for name, ph in p["phases"].items():
        assert ph["nch"] * p["chunk"] == ph["ic"]
        wins = ph["window_chunks"]
        assert wins[0][0] == 0 and wins[-1][1] == ph["nch"] and len(wins) == ph["windows"]
        for (a0, a1), (b0, _) in zip(wins, wins[1:]):
            assert a1 == b0
        assert all(0 < c1 - c0 <= p["window"] for c0, c1 in wins)
    if cfg is LLAMA3_8B and not w3:
        # 8 rows: every phase but down (two windows) stages its rows once
        if b == 8:
            assert {n: ph["windows"] for n, ph in p["phases"].items()} == dict(
                qkv=1, o=1, gateup=1, down=2, head=1)
        if b == 32:
            assert p["phases"]["qkv"]["windows"] == 2


@pytest.mark.parametrize("w3", [False, True])
@pytest.mark.parametrize("cfg", [LLAMA3_8B, TINY])
@pytest.mark.parametrize("b", ROWS)
def test_plan_ints_pass_the_kernels_checks(cfg, b, w3):
    """What the wrapper hands the kernel (``_plan_ints``: grid, shared bytes,
    ring slots, window, then each phase's wave, warps a tile and windows)
    is ``batched_plan`` and passes the checks of the C ``plan_for``: the
    layout's bytes, no more warps than a block has, TMA boxes of at most 256
    columns and rows, windows of whole chunks no longer than the rows' room;
    an absent head is zeros."""
    p = _plan(cfg, b, w3)
    args = (b, cfg["H"], cfg["I"], cfg["nq"], cfg["nkv"], cfg["vocab"], w3, N_SM)
    t = tmb._plan_ints(*args)
    assert t[:4] == (p["grid"], p["smem"], p["slots"], p["window"])
    assert t[1] == tmb._smem(b, w3, p["window"])[0] <= tmb.SMEM_MAX
    rows = 24 if w3 else 16
    rh = -(-b // tmb.WARP_ROWS)
    for i, name in enumerate(("qkv", "o", "gateup", "down", "head")):
        wave, k, nw = t[4 + 3 * i: 7 + 3 * i]
        ph, u2 = p["phases"][name], 2 if name == "gateup" else 1
        assert (wave, k, nw) == (ph["wave"], ph["k"], ph["windows"])
        assert wave >= u2 and wave % u2 == 0 and k >= 1 and wave * k * rh <= tmb.WARPS
        assert 16 * wave // u2 <= 256 and k * rows <= 256
        assert 1 <= nw <= ph["nch"] and -(-ph["nch"] // nw) <= p["window"]
    nohead = tmb._plan_ints(*args[:5], 0, w3, N_SM)
    assert nohead[:-3] == t[:-3] and nohead[-3:] == (0, 0, 0)


def test_plan_refuses_what_the_kernel_refuses():
    with pytest.raises(ValueError):
        _plan(LLAMA3_8B, 1, False)
    with pytest.raises(ValueError):
        _plan(LLAMA3_8B, 65, False)


def _old_k6_layout(b, w3, wc):
    """K6's layout as csrc/megakernel_batched.cu computed it before the host
    plan carried the offsets (smem_layout there): the partial sums after the
    ring and its barriers, then the norm factors, the group sums and rows."""
    kc = 256 if w3 else 128
    sb = tmb.stage_bytes(w3)
    slots = tmb.RING_BYTES // sb
    bp = -(-b // 8) * 8
    u_off = (128 + slots * sb + 16 * slots + 8 + 127) // 128 * 128
    xs_off = u_off + tmb.RED_BYTES + tmb.RS_BYTES
    rows_off = (xs_off + bp * (wc * kc // 128) * 4 + 15) // 16 * 16
    end = rows_off + bp * (wc * kc // 2 + 8) * 4
    return (128 + slots * sb, u_off, u_off + tmb.RED_BYTES, xs_off, rows_off,
            max(end, u_off + tmb.ATT_BYTES))


@pytest.mark.parametrize("w3", [False, True])
@pytest.mark.parametrize("b", (2, 8, 13, 32, 33, 64))
def test_k6_layout_is_unchanged(b, w3):
    """K6's regions, now from the host's ``smem_layout`` (the one source of
    the layout, shared with K5), lie where the kernel put them before, byte
    for byte, and pass the kernel's check."""
    from test_torch_chunk_plan import _fits

    for cfg in (dict(LLAMA3_8B), dict(TINY)):
        p = tmb.batched_plan(b, cfg["H"], cfg["I"], cfg["nq"], cfg["nkv"], cfg["vocab"], w3, 132)
        lay = tmb.smem_layout(b, w3, p["window"])
        bars, red, rs, xs, rows, smem = _old_k6_layout(b, w3, p["window"])
        assert (lay["bars"], lay["red"], lay["rs"], lay["xsum"], lay["rows"], lay["att"]) == (
            bars, red, rs, xs, rows, red)
        assert lay["smem"] == smem == p["smem"] and lay["tot"] == 0
        assert _fits(lay, b, w3, p["window"], False)
        assert tmb._layout_ints(b, w3, p["window"]) == (bars, red, rs, xs, rows, red, 0)


# ---- a torch emulation of the kernel's order of sums ------------------------------

def _seq_sum(parts):
    """Sum a list of tensors left to right in f32."""
    acc = torch.zeros_like(parts[0])
    for x in parts:
        acc = acc + x
    return acc


def _group_sums(xb, folded):
    """Σ bf16(x) over each group of 128 channels as the staging adds it: a
    lane's 16 channels in order (from rows copied in the staged pair layout,
    the pairs in the order they are stored, 0 4 1 5 2 6 3 7, a pair's two
    halves first), then the 8 lanes of a group by a butterfly."""
    b, ic = xb.shape
    v = xb.reshape(b, ic // 16, 16)
    if folded:
        s16 = _seq_sum([v[..., e] for e in range(16)])
    else:
        s16 = _seq_sum([v[..., 2 * p] + v[..., 2 * p + 1] for p in (0, 4, 1, 5, 2, 6, 3, 7)])
    s = s16.reshape(b, ic // 128, 8)
    for o in (1, 2, 4):
        idx = torch.arange(8) ^ o
        s = s + s[..., idx]
    return s[..., 0]


def _sched(plan, kinds, grid):
    """``qdot_layer`` and ``rms_rows`` as K6 orders their f32 sums."""
    kc = plan["chunk"]

    def qdot(ql, l, x):
        qw, s, z = ((ql.qweight, ql.scales, ql.szeros) if l is None
                    else (ql.qweight[l], ql.scales[l], ql.szeros[l]))
        ph = plan["phases"][kinds[id(ql)]]
        b, ic = x.shape
        oc = qw.shape[-1]
        ng = ic // 128
        xb = x.to(torch.bfloat16).float()
        xs = _group_sums(xb, kinds[id(ql)] in ("qkv", "gateup", "head"))    # [b, ng]
        q = tmk.unpack_codes(qw, ql.dense3).reshape(ng, 128, oc)
        # W4: codes centred, q - 8; W3: exact codes
        bias = 0.0 if ql.dense3 else -8.0
        dot = torch.einsum("bgk,gkc->gbc", xb.reshape(b, ng, 128), q + bias)
        contrib = dot * s[:, None, :] - xs.t()[:, :, None] * (bias * s + z)[:, None, :]
        gpc = kc // 128                           # groups a chunk
        part = None
        for c0, c1 in ph["window_chunks"]:
            warps = []
            for kp in range(ph["k"]):
                acc = torch.zeros(b, oc)
                for c in range(c0 + kp, c1, ph["k"]):
                    for g in range(c * gpc, (c + 1) * gpc):
                        acc = acc + contrib[g]
                warps.append(acc)
            v = _seq_sum([torch.zeros(b, oc)] + warps)
            part = v if part is None else part + v
        return part

    def rms(x, w, eps):
        h = x.shape[1]
        units = h // 16
        blocks = [(g * units // grid * 16, (g + 1) * units // grid * 16) for g in range(grid)]
        ss = _seq_sum([(x[:, c0:c1] * x[:, c0:c1]).sum(dim=1) for c0, c1 in blocks])
        return x * torch.rsqrt(ss / h + eps)[:, None] * w.float()

    return qdot, rms


def _kinds(t):
    k = {id(t["wqkv"]): "qkv", id(t["wo"]): "o", id(t["wgateup"]): "gateup",
         id(t["down"]): "down"}
    if "lm_head" in t:
        k[id(t["lm_head"])] = "head"
    return k


def _close(got, ref, tol):
    f32 = lambda a: a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    got, ref = f32(got), f32(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


# The existing K6 tests' tolerances: 2^-6 of an output's largest magnitude
# against JAX's interpret-mode kernel and between orders of f32 sums (a bf16
# scratch value on a rounding edge lands on the other side and the step
# compounds over the layers; test_torch_megakernel_batched.py::TOL,
# test_torch_kv8.py::TOL_B, test_torch_w3_model.py::CHUNK_TOL).
TOL = 2.0 ** -6


@pytest.mark.parametrize("variant", ["w4", "w3", "int8", "paged"])
@pytest.mark.parametrize("grid,window", [(N_SM, None), (12, 1)])
def test_emulated_batched_step_matches_plain_and_jax(variant, grid, window, monkeypatch):
    """8 ragged rows (0 and T-1 among them), 2 layers, a head: the plan on
    132 blocks (eight or four warps a tile), and on 12 blocks with one-chunk windows (several warps a
    tile, every window's sums carried)."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel_batched import w4a16_llama_token_step_batched
    from awq_tpu_torch.convert import params_from_jax
    from test_torch_kv8 import _kv8_in
    from test_torch_megakernel_batched import B, LENGTHS, T, _inputs, _jax_lins
    from test_torch_paged import _scatter
    from test_torch_w3_model import _jax_lins3

    nq, nkv = (4, 2) if variant in ("w4", "int8") else (2, 2)
    H, I, L, V = nq * 128, 512, 2, 256
    lins = _jax_lins3 if variant == "w3" else _jax_lins
    jl = lins(21, H, I, nq, nkv, L, vocab=V)
    t = params_from_jax(jax.device_get(jl), device="cpu")
    assert t["wqkv"].dense3 == (variant == "w3")
    inp = _inputs(22, H, L, nkv)
    lengths = np.array(LENGTHS, np.int32)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    jkw = dict(nq=nq, nkv=nkv, eps=1e-5, interpret=True, whead=jl["lm_head"],
               norm_w=jnp.asarray(inp["norm"]))
    tkw = dict(whead=t["lm_head"], norm_w=torch.from_numpy(inp["norm"]))
    if variant == "int8":
        codes, scales = _kv8_in(inp, B)
        jcache = jnp.asarray(codes.numpy())
        jkw["cache_scales"] = jnp.asarray(scales.numpy().reshape(L, 2, B, nkv, T // 256, 256))
        caches = [(codes.clone(), dict(cache_scales=scales.clone())) for _ in range(2)]
    elif variant == "paged":
        cache = np.asarray(jnp.asarray(inp["cache"]).astype(jnp.bfloat16).astype(jnp.float32))
        pool, tables = _scatter(cache, 1, T, 3)
        jcache = jb(pool)
        jkw["tables"] = jnp.asarray(tables)
        caches = [(torch.from_numpy(pool).to(torch.bfloat16),
                   dict(tables=torch.from_numpy(tables))) for _ in range(2)]
    else:
        jcache = jb(inp["cache"])
        caches = [(torch.from_numpy(inp["cache"]).to(torch.bfloat16), {}) for _ in range(2)]
    h = torch.from_numpy(inp["h"].copy()).to(torch.bfloat16)
    res = w4a16_llama_token_step_batched(
        jb(inp["h"]), jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"],
        jnp.asarray(inp["ln1"]), jnp.asarray(inp["ln2"]), jnp.asarray(inp["cos"]),
        jnp.asarray(inp["sin"]), jcache, jnp.asarray(lengths), **jkw)
    args = (h, t["wqkv"], t["wo"], t["wgateup"], t["down"], torch.from_numpy(inp["ln1"]),
            torch.from_numpy(inp["ln2"]), torch.from_numpy(inp["cos"]),
            torch.from_numpy(inp["sin"]))
    lens = torch.from_numpy(lengths)
    plain = tmb.w4a16_llama_token_step_batched_plain(
        *args, caches[0][0], lens, nq, nkv, 1e-5, **tkw, **caches[0][1])
    plan = tmb.batched_plan(B, H, I, nq, nkv, V, variant == "w3", grid)
    if window:                    # one chunk a window: every window's sums carried
        for ph in plan["phases"].values():
            ph["window_chunks"] = [(c, c + 1) for c in range(ph["nch"])]
    if grid == 12:
        assert plan["phases"]["o"]["k"] > 1 and plan["phases"]["gateup"]["k"] == 1
    qdot, rms = _sched(plan, _kinds(t), grid)
    monkeypatch.setattr(tmb, "qdot_layer", qdot)
    monkeypatch.setattr(tmb, "rms_rows", rms)
    got = tmb.w4a16_llama_token_step_batched_plain(
        *args, caches[1][0], lens, nq, nkv, 1e-5, **tkw, **caches[1][1])
    assert len(got) == len(plain) == len(res) == 4
    for g, p, r in zip(got, plain, res):
        _close(g, p, TOL)
        _close(g, np.asarray(jnp.asarray(r).astype(jnp.float32)), TOL)
    # both wrote each row's k/v at its length
    for i in (0, 1):
        if variant == "paged":
            at = (slice(None), i, torch.from_numpy(tables[:, 0]).long(), slice(None), lens.long())
        else:
            at = (slice(None), i, torch.arange(B), slice(None), lens.long())
        if variant != "int8":
            assert torch.equal(caches[1][0][at].transpose(0, 1), got[1 + i])
