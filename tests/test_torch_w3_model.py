"""Port parity of the W3 slice above K1: the W3 modes of the megakernels'
plain versions (K4's layer and token steps, K5's chunk step, K6's batched
step) against the JAX kernels run with ``interpret=True``. W3 ``forward``
and both engines are held in ``test_torch_w3_engines.py``.

The JAX kernel weights follow its own dense3 tests
(``tests/test_megakernel.py:285-300``): W3-g128 ``quantize_linear``
outputs (``pack_int3``) folded by ``tile_qlinear(..., fold_scales=True)``
into the TPU's ``w3x`` layout with bf16 scales, which ``params_from_jax``
unfolds back into ``pack_int3``. Tests marked ``cuda`` hold the CUDA W3
modes to the plain versions on a card and skip here.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops import megakernel_batched as tmb
from awq_tpu_torch.ops import megakernel_chunk as tmc

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

HD, T = 128, 256

# The tolerances of the W4 parity tests (test_torch_megakernel.py,
# test_torch_megakernel_batched.py), whose reasons hold unchanged: the
# plain versions and the JAX kernels round the same values to bf16, and an
# input on a rounding edge can round the other way on the two sides (2^-8
# of the output for one matmul, compounding to 2^-6 over the layers of the
# chunk and batched steps, which round their scratch to bf16).
# Outputs that leave in bf16 (the token step's residual and k/v) show a
# difference that crosses a rounding edge as one whole bf16 step, up to
# 2^-7 of the largest magnitude: STEP_TOL.
TOL, CHUNK_TOL, STEP_TOL = 2.0 ** -8, 2.0 ** -6, 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _jax_lins3(seed, H, I, nq, nkv, L, bias=False, vocab=0):
    """Folded stacked W3 (dense3, w3x) linears of the JAX package."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.w4a16 import quantize_linear, tile_qlinear

    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 64))
    rng = np.random.default_rng(seed)

    def lin(ic, oc, n, with_bias=False):
        qls = []
        for _ in range(n):
            w = jax.random.normal(next(keys), (ic, oc), jnp.float32) * 0.05
            b = (jnp.asarray(rng.standard_normal(oc).astype(np.float32) * 0.1)
                 if with_bias else None)
            qls.append(quantize_linear(w, n_bit=3, bias=b))
        ql = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qls)
        assert ql.dense3
        return tile_qlinear(ql, block_n=128, fold_scales=True)

    out = {"wqkv": lin(H, (nq + 2 * nkv) * HD, L, bias), "wo": lin(H, H, L),
           "wgateup": lin(H, 2 * I, L), "down": lin(I, H, L)}
    if vocab:
        out["lm_head"] = lin(H, vocab, 1)
    return out


def _inputs(seed, H, L, nkv, rows=1, slots=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ang = rng.uniform(0, 6.28, (rows, HD)).astype(np.float32)
    return dict(h=f(rows, H) * 0.3, ln1=rng.uniform(0.8, 1.2, (L, H)).astype(np.float32),
                ln2=rng.uniform(0.8, 1.2, (L, H)).astype(np.float32),
                norm=rng.uniform(0.8, 1.2, H).astype(np.float32),
                cache=f(L, 2, slots, nkv, T, HD) * 0.2, cos=np.cos(ang), sin=np.sin(ang))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _port(jl):
    import jax

    t = params_from_jax(jax.device_get(jl), device="cpu")
    assert all(t[k].dense3 for k in ("wqkv", "wo", "wgateup", "down"))
    return t


@pytest.mark.parametrize("length", [0, 37])
def test_layer_step_w3_plain_matches_jax(length):
    """I = 768: down's IC holds a full 5-group w3x chunk and a trailer."""
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel import w4a16_llama_layer_step

    nq = nkv = 2
    H, I, L = nq * HD, 768, 2
    jl = _jax_lins3(40 + length, H, I, nq, nkv, L)
    inp = _inputs(length, H, L, nkv)
    t = _port(jl)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    jh, jk, jv = w4a16_llama_layer_step(
        j["h"], jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"], j["ln1"], j["ln2"],
        j["cos"][0], j["sin"][0], j["cache"], 1, length, nq=nq, nkv=nkv, eps=1e-5,
        interpret=True)
    cache = _t(inp["cache"])
    th, tk, tv = tmk.w4a16_llama_layer_step(
        _t(inp["h"]), t["wqkv"], t["wo"], t["wgateup"], t["down"], _t(inp["ln1"]),
        _t(inp["ln2"]), _t(inp["cos"][0]), _t(inp["sin"][0]), cache, 1, length,
        nq, nkv, 1e-5)
    for g, r in ((th, jh), (tk, jk), (tv, jv)):
        _close(g, r, TOL)
    assert torch.equal(cache[1, 0, 0, :, length], tk[0])


def test_token_step_w3_plain_matches_jax():
    """All layers and a W3 head in one step, bf16 residual and cache."""
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel import w4a16_llama_token_step

    nq, nkv = 4, 2
    H, I, L, V, length = nq * HD, 512, 2, 256, 65
    jl = _jax_lins3(7, H, I, nq, nkv, L, vocab=V)
    inp = _inputs(8, H, L, nkv)
    t = _port(jl)
    assert tmk.head_in_kernel({"lm_head": t["lm_head"], "layers": t})
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    res = w4a16_llama_token_step(
        jb(inp["h"]), jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"],
        jnp.asarray(inp["ln1"]), jnp.asarray(inp["ln2"]), jnp.asarray(inp["cos"][0]),
        jnp.asarray(inp["sin"][0]), jb(inp["cache"]), length, nq=nq, nkv=nkv, eps=1e-5,
        whead=jl["lm_head"], norm_w=jnp.asarray(inp["norm"]), interpret=True)
    cache = _t(inp["cache"]).to(torch.bfloat16)
    got = tmk.w4a16_llama_token_step(
        _t(inp["h"]).to(torch.bfloat16), t["wqkv"], t["wo"], t["wgateup"], t["down"],
        _t(inp["ln1"]), _t(inp["ln2"]), _t(inp["cos"][0]), _t(inp["sin"][0]), cache,
        length, nq, nkv, 1e-5, whead=t["lm_head"], norm_w=_t(inp["norm"]))
    assert len(got) == len(res) == 4
    for g, r in zip(got, res):
        tol = STEP_TOL if g.dtype == torch.bfloat16 else TOL
        _close(g, np.asarray(jnp.asarray(r).astype(jnp.float32)), tol)


@pytest.mark.parametrize("s,hist", [(17, 40), (32, 0)])
def test_chunk_step_w3_plain_matches_jax(s, hist):
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel_chunk import CHUNK_S, w4a16_llama_chunk_step

    nq, nkv, H, I, L = 4, 2, 512, 512, 2
    jl = _jax_lins3(s + hist, H, I, nq, nkv, L, bias=True)
    inp = _inputs(s * 3 + hist, H, L, nkv, rows=CHUNK_S)
    t = _port(jl)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    hw = j["h"].at[s:].set(0.0)
    jh, jk, jv = w4a16_llama_chunk_step(
        hw, jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"], j["ln1"], j["ln2"],
        j["cos"], j["sin"], j["cache"], jnp.int32(hist), nq=nq, nkv=nkv, eps=1e-5,
        interpret=True)
    cache = _t(inp["cache"])
    th, tk, tv = tmc.w4a16_llama_chunk_step(
        _t(inp["h"][:s]), t["wqkv"], t["wo"], t["wgateup"], t["down"], _t(inp["ln1"]),
        _t(inp["ln2"]), _t(inp["cos"][:s]), _t(inp["sin"][:s]), cache, hist, nq, nkv,
        1e-5)
    _close(th, jh[:s], CHUNK_TOL)
    _close(tk, jk[:, :, :s], CHUNK_TOL)
    _close(tv, jv[:, :, :s], CHUNK_TOL)
    assert torch.equal(cache[:, 0, 0, :, hist:hist + s], tk)


def test_batched_step_w3_plain_matches_jax():
    """8 ragged rows, 2 layers, a W3 head, a bf16 cache."""
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel_batched import w4a16_llama_token_step_batched

    nq = nkv = 2
    B, H, I, L, V = 8, 2 * HD, 256, 2, 256
    lengths = [37, 0, 65, 200, 5, 255, 128, 17]
    jl = _jax_lins3(5, H, I, nq, nkv, L, vocab=V)
    inp = _inputs(12, H, L, nkv, rows=B, slots=B)
    t = _port(jl)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    res = w4a16_llama_token_step_batched(
        jb(inp["h"]), jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"],
        jnp.asarray(inp["ln1"]), jnp.asarray(inp["ln2"]), jnp.asarray(inp["cos"]),
        jnp.asarray(inp["sin"]), jb(inp["cache"]), jnp.asarray(lengths, jnp.int32),
        nq=nq, nkv=nkv, eps=1e-5, whead=jl["lm_head"], norm_w=jnp.asarray(inp["norm"]),
        interpret=True)
    cache = _t(inp["cache"]).to(torch.bfloat16)
    got = tmb.w4a16_llama_token_step_batched(
        _t(inp["h"]).to(torch.bfloat16), t["wqkv"], t["wo"], t["wgateup"], t["down"],
        _t(inp["ln1"]), _t(inp["ln2"]), _t(inp["cos"]), _t(inp["sin"]), cache,
        torch.tensor(lengths, dtype=torch.int32), nq, nkv, 1e-5, whead=t["lm_head"],
        norm_w=_t(inp["norm"]))
    assert len(got) == len(res) == 4
    for g, r in zip(got, res):
        _close(g, np.asarray(jnp.asarray(r).astype(jnp.float32)), CHUNK_TOL)


# ---- on the card: the W3 modes of K4, K5 and K6 against their plain versions

def _card_lins(dev, H, I, nq, nkv, L, V, seed):
    """Random W3 (pack_int3) linears and head on the card."""
    from awq_tpu_torch.ops.w4a16 import QLinear

    g = torch.Generator(device=dev).manual_seed(seed)

    def ql(ic, oc, n=None):
        lead = () if n is None else (n,)
        return QLinear(
            qweight=torch.randint(-(2**31), 2**31 - 1, lead + (ic * 3 // 32, oc),
                                  generator=g, dtype=torch.int32, device=dev),
            scales=(torch.rand(lead + (ic // 128, oc), generator=g, device=dev) + 0.5) * 0.005,
            szeros=(torch.rand(lead + (ic // 128, oc), generator=g, device=dev) + 3.5) * 0.005,
            w_bit=3, group_size=128, dense3=True)

    return (ql(H, (nq + 2 * nkv) * HD, L), ql(H, H, L), ql(H, 2 * I, L), ql(I, H, L),
            ql(H, V))


def _card_rest(dev, H, L, nkv, rows, slots, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    return dict(h=(r(rows, H) * 0.3).to(torch.bfloat16),
                ln=(torch.rand((L, H), generator=g, device=dev) * 0.4 + 0.8).to(torch.bfloat16),
                cache=(r(L, 2, slots, nkv, T, HD) * 0.3).to(torch.bfloat16),
                cos=torch.cos(r(rows, HD)), sin=torch.sin(r(rows, HD)),
                norm=(torch.rand(H, generator=g, device=dev) * 0.4 + 0.8).to(torch.bfloat16))


def _card_close(got, ref, tol):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


# K4: one layer 2^-6 of the output (the plain version and the kernel round
# the same values to bf16 and sum in other orders); K5 and K6 2^-5 after
# three layers of bf16 scratch; the head's logits likewise.
@pytest.mark.cuda
def test_w3_token_and_layer_kernels_match_plain_on_card(cuda):
    nq, nkv, H, I, L, V = 4, 2, 512, 1024, 3, 512
    wq, wo, wgu, wdn, head = _card_lins(cuda, H, I, nq, nkv, L, V, 1)
    x = _card_rest(cuda, H, L, nkv, 1, 1, 2)
    args = (wq, wo, wgu, wdn, x["ln"], x["ln"])
    before = dict(tmk.LAUNCHES)
    c1, c2 = x["cache"].clone(), x["cache"].clone()
    got = tmk.w4a16_llama_layer_step(x["h"], *args, x["cos"][0], x["sin"][0], c1, 1, 77,
                                     nq, nkv)
    ref = tmk.w4a16_llama_layer_step_plain(x["h"], *args, x["cos"][0], x["sin"][0], c2, 1,
                                           77, nq, nkv)
    for g, r in zip(got, ref):
        _card_close(g, r, 2 ** -6)
    c1, c2 = x["cache"].clone(), x["cache"].clone()
    got = tmk.w4a16_llama_token_step(x["h"], *args, x["cos"][0], x["sin"][0], c1, 100,
                                     nq, nkv, whead=head, norm_w=x["norm"])
    ref = tmk.w4a16_llama_token_step_plain(x["h"], *args, x["cos"][0], x["sin"][0], c2,
                                           100, nq, nkv, whead=head, norm_w=x["norm"])
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        _card_close(g, r, 2 ** -5)
    assert tmk.LAUNCHES["megakernel_layer_w3"] == before["megakernel_layer_w3"] + 1
    assert tmk.LAUNCHES["megakernel_token_w3"] == before["megakernel_token_w3"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("s,hist", [(16, 0), (32, 100)])
def test_w3_chunk_kernel_matches_plain_on_card(cuda, s, hist):
    nq, nkv, H, I, L = 4, 2, 512, 1024, 3
    wq, wo, wgu, wdn, _ = _card_lins(cuda, H, I, nq, nkv, L, 32, 3)
    x = _card_rest(cuda, H, L, nkv, s, 1, 4)
    args = (wq, wo, wgu, wdn, x["ln"], x["ln"], x["cos"], x["sin"])
    c1, c2 = x["cache"].clone(), x["cache"].clone()
    got = tmc.w4a16_llama_chunk_step(x["h"], *args, c1, hist, nq, nkv)
    ref = tmc.w4a16_llama_chunk_step_plain(x["h"], *args, c2, hist, nq, nkv)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        _card_close(g, r, 2 ** -5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["slot", "int8", "paged"])
def test_w3_batched_kernel_matches_plain_on_card(cuda, mode):
    from awq_tpu_torch.ops.cache_append import quantize_kv

    nq, nkv, H, I, L, V, B = 4, 2, 512, 1024, 3, 512, 8
    wq, wo, wgu, wdn, head = _card_lins(cuda, H, I, nq, nkv, L, V, 5)
    x = _card_rest(cuda, H, L, nkv, B, B, 6)
    lengths = torch.tensor([37, 0, 65, 200, 5, 255, 128, 17], dtype=torch.int32, device=cuda)
    kw = dict(whead=head, norm_w=x["norm"], max_length=255)
    cache = x["cache"]
    if mode == "int8":
        q, s = quantize_kv(cache)
        c1, c2 = q.clone(), q.clone()
        s1, s2 = s.clone(), s.clone()
        kw1, kw2 = dict(kw, cache_scales=s1), dict(kw, cache_scales=s2)
    elif mode == "paged":
        # the slots' T positions as pages of 64 in a permuted pool
        page, mp = 64, T // 64
        perm = torch.randperm(B * mp, generator=torch.Generator().manual_seed(7)).to(cuda)
        tables = perm.reshape(B, mp).to(torch.int32)
        pool = torch.empty((L, 2, B * mp, nkv, page, HD), dtype=cache.dtype, device=cuda)
        pool[:, :, perm.long()] = cache.reshape(L, 2, B, nkv, mp, page, HD).permute(
            0, 1, 2, 4, 3, 5, 6).reshape(L, 2, B * mp, nkv, page, HD)
        c1, c2 = pool.clone(), pool.clone()
        kw1, kw2 = dict(kw, tables=tables), dict(kw, tables=tables)
    else:
        c1, c2 = cache.clone(), cache.clone()
        kw1 = kw2 = kw
    args = (wq, wo, wgu, wdn, x["ln"], x["ln"], x["cos"], x["sin"])
    key = {"slot": "megakernel_batched_w3", "int8": "megakernel_batched_int8_w3",
           "paged": "megakernel_batched_paged_w3"}[mode]
    before = tmb.LAUNCHES[key]
    got = tmb.w4a16_llama_token_step_batched(x["h"], *args, c1, lengths, nq, nkv, **kw1)
    ref = tmb.w4a16_llama_token_step_batched_plain(x["h"], *args, c2, lengths, nq, nkv,
                                                   **kw2)
    torch.cuda.synchronize()
    assert tmb.LAUNCHES[key] == before + 1
    for g, r in zip(got, ref):
        _card_close(g, r, 2 ** -5)
