"""The schedule of K4's matmul phases (``csrc/megakernel.cu``, mirrored by
``ops/megakernel.py::matmul_phases`` and its helpers) and a torch emulation
of its order of sums.

Every matmul phase of a launch (QKV, o-proj, gate/up, down per layer, then
the head) hands its 32-column tiles to the grid's blocks (one an SM), block
``b`` taking tiles ``b, b + nb, ...``; a block's 8 warps take the tile's
128-channel groups ``w, w + 8, ...`` and add their sums in warp order, so no
tile is shared between blocks and the result is deterministic. Each warp
loads its next group's codes while it computes on the current one. These
tests hold the schedule on the CPU (every weight byte once, the bytes a
block takes in each phase against the mean, the order of a warp's loads)
and emulate the kernel's order of f32 sums in torch, held to the plain
version and to the JAX package's interpret-mode ``w4a16_llama_token_step``
(W4, W3 and an int8 cache). The kernel itself is held to the plain version
on the card
(``tests/test_torch_megakernel.py``, ``test_torch_w3_model.py``,
``test_torch_kv8.py``, ``test_torch_tp_kernels.py``).
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.ops import megakernel as tmk

# One intra-op thread: the CPU tensors here are small, and the test workers
# share the cores.
torch.set_num_threads(1)

N_SM = 132
LLAMA3_8B = dict(H=4096, I=14336, nq=32, nkv=8, vocab=128256)
TINY = dict(H=256, I=512, nq=2, nkv=2, vocab=256)
MODES = (tmk.MODE_LAYERS, tmk.MODE_ATT, tmk.MODE_MLP)


def _phases(cfg, mode, layers):
    return tmk.matmul_phases(mode, layers, cfg["H"], cfg["I"], cfg["nq"], cfg["nkv"],
                             cfg["vocab"] if mode == tmk.MODE_LAYERS else 0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cfg,layers", [(LLAMA3_8B, 1), (TINY, 2)])
@pytest.mark.parametrize("nb", [N_SM, 64, 5])
def test_every_weight_byte_is_loaded_once(mode, cfg, layers, nb):
    phases = _phases(cfg, mode, layers)
    names = [p.name for p in phases]
    per_layer = {tmk.MODE_LAYERS: ["qkv", "o", "gu", "down"], tmk.MODE_ATT: ["qkv", "o"],
                 tmk.MODE_MLP: ["gu", "down"]}[mode]
    assert names == per_layer * layers + (["head"] if mode == tmk.MODE_LAYERS else [])
    for p in phases:
        seen = np.zeros((p.oc // tmk.TILE, p.ng), dtype=np.int64)
        for b in range(nb):
            for w in range(tmk.WARPS):
                for col, g in tmk.warp_loads(p, b, nb, w):
                    seen[col // tmk.TILE, g] += 1
        assert (seen == 1).all(), p


@pytest.mark.parametrize("w3", [False, True])
def test_bytes_a_block_takes_in_each_phase(w3):
    """Llama-3-8B on 132 blocks, one an SM: a phase's busiest block takes
    whole tiles (equal bytes each: 32 columns over IC, codes and scale rows),
    1.033x the mean bytes in o-proj and down (128 tiles, 4 blocks idle) and
    the head (30 or 31 tiles), 1.18x in gate/up (3 or 4 of 448 pairs) and
    1.38x in QKV (1 or 2 of 192 tiles). Cutting those tiles over IC, with
    the pieces merged across blocks, was measured slower (PERF.md §6)."""
    phases = _phases(LLAMA3_8B, tmk.MODE_LAYERS, 1)
    bound = {"qkv": 1.38, "o": 1.033, "gu": 1.18, "down": 1.033, "head": 1.033}
    for p in phases:
        tile = p.ng * (32 * 128 * (3 if w3 else 4) // 8 + 2 * 32 * 4) * (2 if p.half else 1)
        by = [len(tmk.block_tiles(p, b, N_SM)) * tile for b in range(N_SM)]
        assert max(by) / (sum(by) / N_SM) <= bound[p.name], (p.name, max(by) * N_SM / sum(by))
        # a block's warps differ by at most one group a tile
        for b in (0, N_SM - 1):
            n = [len(tmk.warp_loads(p, b, N_SM, w)) for w in range(tmk.WARPS)]
            assert max(n) - min(n) <= len(tmk.block_tiles(p, b, N_SM)) * (2 if p.half else 1)


def test_a_warps_loads_run_one_group_ahead():
    """Within a tile a warp's groups are 8 apart (one each warp of the
    block, in turn), so that the group it requests while computing on one is
    the next it needs; every block with a tile in a phase has its 8 warps
    busy in it (IC of 1024 channels or more)."""
    phases = _phases(LLAMA3_8B, tmk.MODE_LAYERS, 2)
    for p in phases:
        for b in (0, 1, 65, 127, N_SM - 1):
            for w in range(tmk.WARPS):
                loads = tmk.warp_loads(p, b, N_SM, w)
                for (c0, g0), (c1, g1) in zip(loads, loads[1:]):
                    assert (c1 == c0 and g1 == g0 + tmk.WARPS) or (c1 != c0 and g1 == w)
                assert bool(loads) == bool(tmk.block_tiles(p, b, N_SM))
        busy = sum(1 for b in range(N_SM) if tmk.block_tiles(p, b, N_SM))
        assert busy == min(N_SM, p.tiles)


# ---- a torch emulation of the kernel's order of sums ------------------------------

def _sched_qdot(nb, kinds):
    """``qdot_layer`` as K4 orders its f32 sums: a tile's group g (warp g %
    8) folds the dot of bf16(x) with the codes biased by 128 as acc += dot·s
    − Σx·(128·s + sz), the warp's groups in order, and the block adds its 8
    warps in order; each tile lies in one block."""
    def qdot(ql, l, x):
        qw, s, z = ((ql.qweight, ql.scales, ql.szeros) if l is None
                    else (ql.qweight[l], ql.scales[l], ql.szeros[l]))
        ic, oc = x.shape[1], qw.shape[-1]
        ng = ic // tmk.GROUP
        half = oc // 2 if kinds[id(ql)] == "gu" else 0
        ph = tmk.MatmulPhase("x", 0, ic, oc, (half or oc) // tmk.TILE, ng, half)
        xb = x[0].to(torch.bfloat16).float().reshape(ng, tmk.GROUP)
        q = tmk.unpack_codes(qw, ql.dense3).reshape(ng, tmk.GROUP, oc)
        dot = torch.einsum("gk,gkc->gc", xb, q + 128.0)
        xs = xb.sum(dim=1)
        out = torch.zeros(oc)
        for b in range(nb):
            per_warp = [tmk.warp_loads(ph, b, nb, w) for w in range(tmk.WARPS)]
            for t in tmk.block_tiles(ph, b, nb):
                for col0 in ((t * tmk.TILE, half + t * tmk.TILE) if half else (t * tmk.TILE,)):
                    cols = torch.arange(col0, col0 + tmk.TILE)
                    total = None
                    for loads in per_warp:
                        acc = torch.zeros(tmk.TILE)
                        for c, g in loads:
                            if c == col0:
                                acc = acc + (dot[g, cols] * s[g, cols]
                                             - xs[g] * (128.0 * s[g, cols] + z[g, cols]))
                        total = acc if total is None else total + acc
                    out[cols] = total
        return out[None]
    return qdot


def _kinds(t, head=None):
    k = {id(t["wqkv"]): "qkv", id(t["wo"]): "o", id(t["wgateup"]): "gu", id(t["down"]): "down"}
    if head is not None:
        k[id(head)] = "head"
    return k


def _close(got, ref, tol):
    f32 = lambda a: a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    got, ref = f32(got), f32(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


# Tolerances, as the port's megakernel parity tests state them: the
# emulation reorders f32 sums only, so against the plain version a bf16
# output moves by at most one bf16 step where a sum lands on a rounding
# edge; against JAX's interpret-mode kernel, 2^-8 of the largest value for
# f32 outputs (the logits) and 2^-6 for the bf16 residual and k/v of a
# token step (TOL_B / STEP_TOL of test_torch_kv8.py, test_torch_w3_model.py).
TOL, TOL_B = 2.0 ** -8, 2.0 ** -6


@pytest.mark.parametrize("variant", ["w4", "w3", "int8"])
@pytest.mark.parametrize("nb", [N_SM, 5])
def test_emulated_token_step_matches_plain_and_jax(variant, nb, monkeypatch):
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops import megakernel as jmk
    from awq_tpu_torch.convert import params_from_jax
    from test_torch_kv8 import _kv8_in
    from test_torch_megakernel_batched import _jax_lins
    from test_torch_w3_model import _inputs, _jax_lins3

    nq, nkv = (4, 2) if variant == "w3" else (2, 2)
    H, I, L, V, length = nq * 128, 512, 2, 256, 65
    lins = _jax_lins3 if variant == "w3" else _jax_lins
    jl = lins(11, H, I, nq, nkv, L, vocab=V)
    t = params_from_jax(jax.device_get(jl), device="cpu")
    assert t["wqkv"].dense3 == (variant == "w3")
    inp = _inputs(12, H, L, nkv)
    h = torch.from_numpy(inp["h"][:1].copy()).to(torch.bfloat16)
    cos, sin = torch.from_numpy(inp["cos"][0]), torch.from_numpy(inp["sin"][0])
    ln1, ln2 = torch.from_numpy(inp["ln1"]), torch.from_numpy(inp["ln2"])
    norm = torch.from_numpy(inp["norm"])
    jh = jnp.asarray(h.float().numpy()).astype(jnp.bfloat16)
    jkw = dict(nq=nq, nkv=nkv, eps=1e-5, whead=jl["lm_head"], norm_w=jnp.asarray(inp["norm"]),
               interpret=True)
    if variant == "int8":
        codes, scales = _kv8_in(inp, 1)
        jcache = jnp.asarray(codes.numpy())
        jkw["cache_scales"] = jnp.asarray(scales.numpy())
        caches = [(codes.clone(), scales.clone()) for _ in range(2)]
    else:
        cache = torch.from_numpy(inp["cache"]).to(torch.bfloat16)
        jcache = jnp.asarray(inp["cache"]).astype(jnp.bfloat16)
        caches = [(cache.clone(), None) for _ in range(2)]
    res = jmk.w4a16_llama_token_step(jh, jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"],
                                     jnp.asarray(inp["ln1"]), jnp.asarray(inp["ln2"]),
                                     jnp.asarray(inp["cos"][0]), jnp.asarray(inp["sin"][0]),
                                     jcache, length, **jkw)
    args = (h, t["wqkv"], t["wo"], t["wgateup"], t["down"], ln1, ln2, cos, sin)
    kw = dict(whead=t["lm_head"], norm_w=norm)
    plain = tmk.w4a16_llama_token_step_plain(*args, caches[0][0], length, nq, nkv, 1e-5,
                                             cache_scales=caches[0][1], **kw)
    monkeypatch.setattr(tmk, "qdot_layer", _sched_qdot(nb, _kinds(t, t["lm_head"])))
    got = tmk.w4a16_llama_token_step_plain(*args, caches[1][0], length, nq, nkv, 1e-5,
                                           cache_scales=caches[1][1], **kw)
    assert len(got) == len(plain) == len(res) == 4
    for g, p, r in zip(got, plain, res):
        tol = TOL_B if g.dtype == torch.bfloat16 else TOL
        _close(g, p, tol)
        _close(g, np.asarray(jnp.asarray(r).astype(jnp.float32)), tol)
    # the in-place writes: the cache holds the returned k/v at `length`
    if variant != "int8":
        c = caches[1][0]
        for l in range(L):
            assert torch.equal(c[l, 0, 0, :, length], got[1][l])
            assert torch.equal(c[l, 1, 0, :, length], got[2][l])
