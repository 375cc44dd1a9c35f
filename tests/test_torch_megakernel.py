"""Port parity of the megakernels: K4 (``ops/megakernel.py``, the whole-token
and whole-layer steps) and K5 (``ops/megakernel_chunk.py``, the chunk
step), their plain versions against the JAX kernels run with
``interpret=True``, and the gates.

The JAX weights are W4-g128 ``quantize_linear`` outputs repacked by
``tile_qlinear(..., fold_scales=True)`` (the layout the JAX megakernels
take) and reach the port through ``params_from_jax``, which unfolds them.
Geometry: head_dim 128, hidden 256-512, 2-3 layers, a cache of 256
positions. Tests marked ``cuda`` hold the CUDA kernels to the plain
versions on a card and skip here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import ModelConfig as TConfig
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops import megakernel_chunk as tmc
from awq_tpu_torch.ops.w4a16 import QLinear

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

HD, T = 128, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _jax_lins(seed, H, I, nq, nkv, L, bias=False):
    """Folded stacked W4 linears of the JAX package, distinct per layer."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.w4a16 import quantize_linear, tile_qlinear

    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 64))
    rng = np.random.default_rng(seed)

    def lin(ic, oc, with_bias=False):
        qls = []
        for _ in range(L):
            w = jax.random.normal(next(keys), (ic, oc), jnp.float32) * 0.05
            b = (jnp.asarray(rng.standard_normal(oc).astype(np.float32) * 0.1)
                 if with_bias else None)
            qls.append(quantize_linear(w, bias=b))
        ql = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qls)
        return tile_qlinear(ql, block_n=128, fold_scales=True)

    return {"wqkv": lin(H, (nq + 2 * nkv) * HD, bias), "wo": lin(H, H),
            "wgateup": lin(H, 2 * I), "down": lin(I, H)}


def _inputs(seed, H, L, nkv, rows=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(h=f(rows, H) * 0.3, ln1=rng.uniform(0.8, 1.2, (L, H)).astype(np.float32),
                ln2=rng.uniform(0.8, 1.2, (L, H)).astype(np.float32),
                cache=f(L, 2, 1, nkv, T, HD) * 0.2,
                ang=rng.uniform(0, 6.28, (rows, HD)).astype(np.float32))


def _both(jl, inp):
    """(JAX arrays, port tensors) of the weights and inputs."""
    import jax
    import jax.numpy as jnp

    t = params_from_jax(jax.device_get(jl), device="cpu")
    cos, sin = np.cos(inp["ang"]), np.sin(inp["ang"])
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    j.update(cos=jnp.asarray(cos), sin=jnp.asarray(sin))
    tt = {k: torch.from_numpy(v.copy()) for k, v in inp.items()}
    tt.update(cos=torch.from_numpy(cos), sin=torch.from_numpy(sin))
    return j, t, tt


def _close(got, ref, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


# The plain versions compute in f32 what the JAX kernels compute in f32 in
# interpret mode (dots of bf16(x) against exact codes, bf16 scales from the
# folded rows); the JAX kernels dot against codes biased by +128 and take
# 128·sum(x) back off, which costs them some f32 cancellation. Every matmul
# rounds its input to bf16, and an input on a bf16 rounding edge can round
# the other way on the two sides: one element then moves by one bf16 step
# (2^-8 relative) and moves every output of that matmul a little. The
# largest effect measured on the layer and token steps was 6e-4 of the
# output's largest magnitude: TOL = 2^-8 covers it. The chunk step also
# rounds QKV, gate/up, hm and the residual to bf16 (as the JAX kernel's
# bf16 scratch does), so such steps recur and compound over the layers:
# 6.5e-3 was measured after two layers, and CHUNK_TOL = 2^-6 covers it.
TOL, CHUNK_TOL = 2.0 ** -8, 2.0 ** -6


@pytest.mark.parametrize("nq,nkv,length,bias", [
    (2, 2, 0, False), (2, 2, 37, False), (4, 2, 200, False), (4, 2, 37, True)])
def test_layer_step_plain_matches_jax(nq, nkv, length, bias):
    from awq_tpu.ops.megakernel import w4a16_llama_layer_step

    H, I, L = nq * HD, 256, 2
    jl = _jax_lins(nq + length, H, I, nq, nkv, L, bias)
    j, t, tt = _both(jl, _inputs(length, H, L, nkv))
    jh, jk, jv = w4a16_llama_layer_step(
        j["h"], jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"], j["ln1"],
        j["ln2"], j["cos"][0], j["sin"][0], j["cache"], 1, length, nq=nq,
        nkv=nkv, eps=1e-5, interpret=True)
    cache = tt["cache"].clone()
    th, tk, tv = tmk.w4a16_llama_layer_step(
        tt["h"], t["wqkv"], t["wo"], t["wgateup"], t["down"], tt["ln1"],
        tt["ln2"], tt["cos"][0], tt["sin"][0], cache, 1, length, nq, nkv, 1e-5)
    _close(th, jh, TOL)
    _close(tk, jk, TOL)
    _close(tv, jv, TOL)
    # the new k/v are written in place at `length` of layer 1, nothing else
    torch.testing.assert_close(cache[1, 0, 0, :, length], tk[0], rtol=0, atol=0)
    torch.testing.assert_close(cache[1, 1, 0, :, length], tv[0], rtol=0, atol=0)
    cache[1, :, 0, :, length] = tt["cache"][1, :, 0, :, length]
    assert torch.equal(cache, tt["cache"])


@pytest.mark.parametrize("head", [False, True])
def test_token_step_plain_matches_jax(head):
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel import w4a16_llama_token_step
    from awq_tpu.ops.w4a16 import quantize_linear, tile_qlinear

    nq = nkv = 2
    H, I, L, V, length = nq * HD, 256, 3, 512, 65
    jl = _jax_lins(7, H, I, nq, nkv, L)
    inp = _inputs(8, H, L, nkv)
    # a bf16 cache and residual, as the model runs them
    cache_bf = jnp.asarray(inp["cache"]).astype(jnp.bfloat16)
    h_bf = jnp.asarray(inp["h"]).astype(jnp.bfloat16)
    j, t, tt = _both(jl, inp)
    kw = dict(nq=nq, nkv=nkv, eps=1e-5, interpret=True)
    tkw = {}
    if head:
        whead = tile_qlinear(jax.tree_util.tree_map(
            lambda a: a[None], quantize_linear(jax.random.normal(
                jax.random.PRNGKey(9), (H, V), jnp.float32) * 0.05)),
            block_n=128, fold_scales=True)
        norm_w = jnp.asarray(np.random.default_rng(9).uniform(0.8, 1.2, H),
                             jnp.float32)
        kw.update(whead=whead, norm_w=norm_w)
        th_ = params_from_jax(jax.device_get({"lm_head": whead}), device="cpu")
        tkw = dict(whead=th_["lm_head"], norm_w=torch.from_numpy(np.array(norm_w)))
        assert th_["lm_head"].qweight.dim() == 2
    res = w4a16_llama_token_step(
        h_bf, jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"], j["ln1"],
        j["ln2"], j["cos"][0], j["sin"][0], cache_bf, length, **kw)
    cache = torch.from_numpy(np.array(cache_bf.astype(jnp.float32))).to(torch.bfloat16)
    got = tmk.w4a16_llama_token_step(
        torch.from_numpy(np.array(h_bf.astype(jnp.float32))).to(torch.bfloat16),
        t["wqkv"], t["wo"], t["wgateup"], t["down"], tt["ln1"], tt["ln2"],
        tt["cos"][0], tt["sin"][0], cache, length, nq, nkv, 1e-5, **tkw)
    assert len(got) == len(res) == (4 if head else 3)
    # the residual and k/v leave in bf16, where an f32 difference that
    # crosses a rounding edge shows as one bf16 step: within TOL
    for g, r in zip(got[:3], res[:3]):
        _close(g, r, TOL)
    if head:
        _close(got[3], res[3], TOL)
    for l in range(L):
        assert torch.equal(cache[l, 0, 0, :, length], got[1][l])
        assert torch.equal(cache[l, 1, 0, :, length], got[2][l])


@pytest.mark.parametrize("s,hist", [(17, 40), (32, 0), (8, 200)])
def test_chunk_step_plain_matches_jax(s, hist):
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel_chunk import CHUNK_S, w4a16_llama_chunk_step

    assert tmc.CHUNK_S == CHUNK_S
    nq, nkv, H, I, L = 4, 2, 512, 512, 2
    jl = _jax_lins(s + hist, H, I, nq, nkv, L, bias=True)
    inp = _inputs(s * 3 + hist, H, L, nkv, rows=CHUNK_S)
    j, t, tt = _both(jl, inp)
    # JAX takes the window padded to CHUNK_S rows at the end
    hw = j["h"].at[s:].set(0.0)
    jh, jk, jv = w4a16_llama_chunk_step(
        hw, jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"], j["ln1"],
        j["ln2"], j["cos"], j["sin"], j["cache"], jnp.int32(hist),
        nq=nq, nkv=nkv, eps=1e-5, interpret=True)
    cache = tt["cache"].clone()
    th, tk, tv = tmc.w4a16_llama_chunk_step(
        tt["h"][:s].contiguous(), t["wqkv"], t["wo"], t["wgateup"], t["down"],
        tt["ln1"], tt["ln2"], tt["cos"][:s].contiguous(),
        tt["sin"][:s].contiguous(), cache, hist, nq, nkv, 1e-5)
    _close(th, jh[:s], CHUNK_TOL)
    _close(tk, jk[:, :, :s], CHUNK_TOL)
    _close(tv, jv[:, :, :s], CHUNK_TOL)
    assert torch.equal(cache[:, 0, 0, :, hist:hist + s], tk)
    assert torch.equal(cache[:, 1, 0, :, hist:hist + s], tv)
    assert torch.equal(cache[:, :, :, :, :hist], tt["cache"][:, :, :, :, :hist])
    assert torch.equal(cache[:, :, :, :, hist + s:], tt["cache"][:, :, :, :, hist + s:])


def _gate_model(**change):
    cfg = TConfig(arch="llama", vocab_size=64, hidden_size=256,
                  intermediate_size=256, num_layers=2, num_heads=2,
                  num_kv_heads=2, head_dim=128, max_position_embeddings=512,
                  dtype="float32")
    cfg = dataclasses.replace(cfg, **change)
    import awq_tpu_torch.models.llama as tllama
    from awq_tpu_torch.config import QuantConfig

    p = tllama.fuse_linears(tllama.init_qparams(cfg, QuantConfig(), device="cpu"), cfg)
    return cfg, p["layers"]


@pytest.mark.parametrize("case", [
    "ok", "wo_bias", "hd64", "s33", "w3", "disabled", "unforced", "int8",
    "batch2", "unfused", "group16"])
def test_gates(case, monkeypatch):
    monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    cfg, layers = _gate_model()
    layers = dict(layers)
    cache = torch.zeros((2, 2, 1, 2, 256, 128))
    s = 16
    if case == "wo_bias":
        layers["wo"] = dataclasses.replace(layers["wo"],
                                           bias=torch.zeros((2, 256)))
    elif case == "hd64":
        cfg = dataclasses.replace(cfg, head_dim=64)
    elif case == "s33":
        s = 33
    elif case == "w3":
        layers["down"] = dataclasses.replace(layers["down"], w_bit=3)
    elif case == "disabled":
        monkeypatch.setenv("AWQ_TPU_DISABLE_MEGAKERNEL", "1")
    elif case == "unforced":
        monkeypatch.delenv("AWQ_TPU_FORCE_MEGAKERNEL")   # a CPU cache
    elif case == "int8":
        cache = cache.to(torch.int8)
    elif case == "batch2":
        cache = torch.zeros((2, 2, 2, 2, 256, 128))
    elif case == "unfused":
        layers["up"] = layers.pop("wgateup")
    elif case == "group16":     # K4 takes at most 8 q heads per kv head
        cfg = dataclasses.replace(cfg, num_heads=16, num_kv_heads=1)
    token = tmk.megakernel_supported(cfg, layers, cache)
    chunk = tmc.chunk_megakernel_supported(cfg, layers, cache, s)
    assert token == (case in ("ok", "s33"))
    assert chunk == (case == "ok")
    if case == "ok":
        assert tmc.chunk_megakernel_supported(cfg, layers, cache, 1)
        assert tmc.chunk_megakernel_supported(cfg, layers, cache, 32)
        assert not tmc.chunk_megakernel_supported(cfg, layers, cache, 0)
        # a qkv bias (qwen2) is taken
        layers["wqkv"] = dataclasses.replace(
            layers["wqkv"], bias=torch.zeros((2, layers["wqkv"].out_features)))
        assert tmk.megakernel_supported(cfg, layers, cache)


@pytest.mark.parametrize("case", ["ok", "vocab48", "bias", "stacked", "fp"])
def test_head_in_kernel(case):
    """The head joins K4 only as a 2-D W4 g128 QLinear without bias over
    whole 32-column tiles; otherwise forward runs it after the kernel."""
    vocab = 48 if case == "vocab48" else 64
    head = QLinear(qweight=torch.zeros((32, vocab), dtype=torch.int32),
                   scales=torch.ones((2, vocab)), szeros=torch.zeros((2, vocab)),
                   bias=torch.zeros(vocab) if case == "bias" else None)
    if case == "stacked":
        head = QLinear(qweight=head.qweight[None], scales=head.scales[None],
                       szeros=head.szeros[None])
    elif case == "fp":
        head = torch.zeros((256, vocab))
    assert tmk.head_in_kernel({"lm_head": head}) == (case == "ok")


def test_unsupported_operands_raise():
    """What the kernels do not take raises, naming its ROADMAP item; an
    int8 cache is taken with its f32 scales only."""
    cfg, layers = _gate_model()
    h, ln = torch.zeros((1, 256)), torch.ones((2, 256))
    lins = (layers["wqkv"], layers["wo"], layers["wgateup"], layers["down"])
    cache = torch.zeros((2, 2, 1, 2, 8, 128))
    with pytest.raises(ValueError, match="scales"):
        tmk.check_operands("k4", h, lins, ln, ln, cache.to(torch.int8), 2, 2, 1)
    scales = torch.zeros((2, 2, 1, 2, 8))
    assert tmk.check_operands("k4", h, lins, ln, ln, cache.to(torch.int8), 2, 2, 1,
                              scales=scales) == (2, 256, 256, False)
    with pytest.raises(ValueError, match="cache_scales"):
        tmk.check_operands("k4", h, lins, ln, ln, cache, 2, 2, 1, scales=scales)
    # 3-bit codes in the nibble container beside W4 linears: not one format
    # (a uniform pack_int3 stack is W3 mode, tests/test_torch_w3.py)
    w3 = dataclasses.replace(layers["down"], w_bit=3)
    with pytest.raises(ValueError, match="as wqkv"):
        tmk.check_operands("k4", h, (*lins[:3], w3), ln, ln, cache, 2, 2, 1)
    assert tmk.check_operands("k4", h, lins, ln, ln, cache, 2, 2, 1) == (2, 256, 256, False)


# ---- on the card: K4 and K5 against their plain versions -------------------

def _card_model(dev, nq, nkv, H, I, L, bias, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def lin(ic, oc, b=False):
        qw = torch.randint(-(2**31), 2**31 - 1, (L, ic // 8, oc), generator=g,
                           dtype=torch.int32, device=dev)
        s = (torch.rand((L, ic // 128, oc), generator=g, device=dev) + 0.5) * 0.01
        bias_t = (torch.randn((L, oc), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        return QLinear(qweight=qw, scales=s, szeros=s * 8,
                       bias=bias_t if b else None)

    ws = (lin(H, (nq + 2 * nkv) * HD, bias), lin(H, H), lin(H, 2 * I), lin(I, H))
    ln = [(torch.rand((L, H), generator=g, device=dev) * 0.4 + 0.8).to(torch.bfloat16)
          for _ in range(2)]
    cache = (torch.randn((L, 2, 1, nkv, T, HD), generator=g, device=dev) * 0.5
             ).to(torch.bfloat16)
    ang = torch.rand((32, HD), generator=g, device=dev) * 6.28
    return ws, ln, cache, torch.cos(ang), torch.sin(ang), g


# bf16 residual and k/v out; the kernel sums in other orders than the plain
# version (f32): 2^-6 of the largest value bounds that with a margin.
CARD_TOL = 2.0 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("length,bias", [(0, False), (37, True), (200, False)])
def test_layer_and_token_kernels_match_plain_on_card(cuda, length, bias):
    nq, nkv, H, I, L = 4, 2, 512, 1024, 3
    ws, (ln1, ln2), cache, cos, sin, g = _card_model(cuda, nq, nkv, H, I, L, bias, length)
    h = (torch.randn((1, H), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    c1, c2 = cache.clone(), cache.clone()
    got = tmk.w4a16_llama_layer_step(h, *ws, ln1, ln2, cos[0], sin[0], c1, 1,
                                     length, nq, nkv)
    ref = tmk.w4a16_llama_layer_step_plain(h, *ws, ln1, ln2, cos[0], sin[0],
                                           c2, 1, length, nq, nkv)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        _close(a.cpu(), b.cpu(), CARD_TOL)
    head = QLinear(qweight=torch.randint(-(2**31), 2**31 - 1, (H // 8, 1024),
                                         generator=g, dtype=torch.int32, device=cuda),
                   scales=torch.full((H // 128, 1024), 0.01, device=cuda),
                   szeros=torch.full((H // 128, 1024), 0.08, device=cuda))
    norm_w = torch.ones(H, dtype=torch.bfloat16, device=cuda)
    c1, c2 = cache.clone(), cache.clone()
    got = tmk.w4a16_llama_token_step(h, *ws, ln1, ln2, cos[0], sin[0], c1,
                                     length, nq, nkv, whead=head, norm_w=norm_w)
    ref = tmk.w4a16_llama_token_step_plain(h, *ws, ln1, ln2, cos[0], sin[0],
                                           c2, length, nq, nkv, whead=head,
                                           norm_w=norm_w)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        _close(a.cpu(), b.cpu(), CARD_TOL)
    assert torch.equal(c1[:, :, :, :, length + 1:], cache[:, :, :, :, length + 1:])


# K5 on the card: its six units (W4 and W3 over f32, bf16 and f16 caches),
# windows of 1, 2, 17 and 32 rows at hist 0, 40 and 1031 (a cache of 1088
# positions), 2 layers at H 512, I 1024, 4 q heads over 2 kv heads, a bias.
CHUNK_T = 1088
CHUNK_CACHES = (torch.float32, torch.bfloat16, torch.float16)


def _chunk_card_model(dev, w3, cdt, seed):
    nq, nkv, H, I, L = 4, 2, 512, 1024, 2
    g = torch.Generator(device=dev).manual_seed(seed)

    def lin(ic, oc, b=False):
        rows = ic * 3 // 32 if w3 else ic // 8
        qw = torch.randint(-(2**31), 2**31 - 1, (L, rows, oc), generator=g,
                           dtype=torch.int32, device=dev)
        s = (torch.rand((L, ic // 128, oc), generator=g, device=dev) + 0.5) * (
            0.005 if w3 else 0.01)
        bias_t = (torch.randn((L, oc), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        return QLinear(qweight=qw, scales=s, szeros=s * (4 if w3 else 8),
                       bias=bias_t if b else None, w_bit=3 if w3 else 4, dense3=w3)

    ws = (lin(H, (nq + 2 * nkv) * HD, True), lin(H, H), lin(H, 2 * I), lin(I, H))
    ln = [(torch.rand((L, H), generator=g, device=dev) * 0.4 + 0.8).to(torch.bfloat16)
          for _ in range(2)]
    cache = (torch.randn((L, 2, 1, nkv, CHUNK_T, HD), generator=g, device=dev) * 0.5).to(cdt)
    ang = torch.rand((32, HD), generator=g, device=dev) * 6.28
    h = (torch.randn((32, H), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    return (nq, nkv), ws, ln, cache, torch.cos(ang), torch.sin(ang), h


@pytest.mark.cuda
@pytest.mark.parametrize("hist", [0, 40, 1031])
@pytest.mark.parametrize("s", [1, 2, 17, 32])
@pytest.mark.parametrize("cdt", CHUNK_CACHES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("w3", [False, True], ids=["w4", "w3"])
def test_chunk_kernel_matches_plain_on_card(cuda, w3, cdt, s, hist):
    (nq, nkv), ws, (ln1, ln2), cache, cos, sin, h = _chunk_card_model(cuda, w3, cdt, s + hist)
    h = h[:s].contiguous()
    c1, c2 = cache.clone(), cache.clone()
    key = "megakernel_chunk" + ("_w3" if w3 else "")
    before = tmc.LAUNCHES[key]
    got = tmc.w4a16_llama_chunk_step(h, *ws, ln1, ln2, cos[:s], sin[:s], c1,
                                     hist, nq, nkv)
    ref = tmc.w4a16_llama_chunk_step_plain(h, *ws, ln1, ln2, cos[:s], sin[:s],
                                           c2, hist, nq, nkv)
    torch.cuda.synchronize()
    assert tmc.LAUNCHES[key] == before + 1
    for a, b in zip(got, ref):
        _close(a.cpu(), b.cpu(), CARD_TOL)
    assert torch.equal(c1[:, :, :, :, hist + s:], cache[:, :, :, :, hist + s:])
    assert torch.equal(c1[:, :, :, :, :hist], cache[:, :, :, :, :hist])
    assert torch.equal(c1[:, 0, 0, :, hist:hist + s], got[1])
    assert torch.equal(c1[:, 1, 0, :, hist:hist + s], got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("w3", [False, True], ids=["w4", "w3"])
def test_chunk_kernel_in_clusters_of_one_on_card(cuda, w3):
    """A model whose IC is one chunk (128 channels in W4, 256 in W3) gives a
    cluster of two no chunk for its second rank: K5 runs in clusters of one,
    every block over all of IC, and holds to the plain version as above."""
    nq = nkv = 2 if w3 else 1
    L, s, hist = 2, 17, 40
    H = I = nq * HD
    g = torch.Generator(device=cuda).manual_seed(5)

    def lin(ic, oc, b=False):
        rows = ic * 3 // 32 if w3 else ic // 8
        sc = (torch.rand((L, ic // 128, oc), generator=g, device=cuda) + 0.5) * 0.01
        return QLinear(qweight=torch.randint(-(2**31), 2**31 - 1, (L, rows, oc), generator=g,
                                             dtype=torch.int32, device=cuda),
                       scales=sc, szeros=sc * (4 if w3 else 8), w_bit=3 if w3 else 4, dense3=w3,
                       bias=(torch.randn((L, oc), generator=g, device=cuda) * 0.1).to(
                           torch.bfloat16) if b else None)

    ws = (lin(H, (nq + 2 * nkv) * HD, True), lin(H, H), lin(H, 2 * I), lin(I, H))
    ln = (torch.rand((L, H), generator=g, device=cuda) * 0.4 + 0.8).to(torch.bfloat16)
    cache = (torch.randn((L, 2, 1, nkv, T, HD), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    ang = torch.rand((s, HD), generator=g, device=cuda) * 6.28
    h = (torch.randn((s, H), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    step = (h, *ws, ln, ln, torch.cos(ang), torch.sin(ang))
    got = tmc.w4a16_llama_chunk_step(*step, cache.clone(), hist, nq, nkv)
    ref = tmc.w4a16_llama_chunk_step_plain(*step, cache.clone(), hist, nq, nkv)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        _close(a.cpu(), b.cpu(), CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", CHUNK_CACHES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("w3", [False, True], ids=["w4", "w3"])
def test_chunk_kernel_two_calls_bit_equal_on_card(cuda, w3, cdt):
    """K5 sums in a fixed order (warps, windows and the cluster's ranks in
    order, no atomics): two calls on equal caches give the same bits, in
    every unit."""
    (nq, nkv), ws, (ln1, ln2), cache, cos, sin, h = _chunk_card_model(cuda, w3, cdt, 7)
    s, hist = 32, 1031
    outs = []
    for _ in range(2):
        c = cache.clone()
        got = tmc.w4a16_llama_chunk_step(h[:s].contiguous(), *ws, ln1, ln2, cos[:s], sin[:s],
                                         c, hist, nq, nkv)
        torch.cuda.synchronize()
        outs.append((*got, c))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("w3,cdt,s,hist", [(False, torch.bfloat16, 32, 1031),
                                            (True, torch.bfloat16, 17, 40),
                                            (False, torch.float32, 32, 200),
                                            (False, torch.float16, 2, 1031)])
def test_chunk_kernel_rows_match_emulation_on_card(cuda, w3, cdt, s, hist, monkeypatch):
    """Each window row of h, and each (layer, kv head, row) of the k/v
    written, holds within the card tolerance of its own largest value to
    the CPU emulation of K5's order of sums (``test_torch_chunk_plan``: the
    ranks' runs of IC and windows, centred codes, the tiles of the
    attention's slices), which the CPU tests hold to the plain version and
    to JAX's interpret-mode kernel."""
    import dataclasses

    from test_torch_chunk_plan import emulate
    from test_torch_megakernel_batched import _rows_close

    (nq, nkv), ws, (ln1, ln2), cache, cos, sin, h = _chunk_card_model(cuda, w3, cdt, 11)
    h = h[:s].contiguous()
    got = tmc.w4a16_llama_chunk_step(h, *ws, ln1, ln2, cos[:s], sin[:s], cache.clone(),
                                     hist, nq, nkv)
    torch.cuda.synchronize()
    cpu = lambda q: dataclasses.replace(q, **{f.name: getattr(q, f.name).cpu()
                                              for f in dataclasses.fields(q)
                                              if isinstance(getattr(q, f.name), torch.Tensor)})
    grid = tmc._card_grid(cuda.index or 0, "megakernel_chunk_" + {
        torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}[cdt]
        + ("_w3" if w3 else ""), tmc.CLUSTER)
    emu = emulate(monkeypatch, h.cpu(), [cpu(q) for q in ws], ln1.cpu(), ln2.cpu(),
                  cos[:s].cpu(), sin[:s].cpu(), cache.cpu(), hist, nq, nkv, grid, tmc.CLUSTER)
    _rows_close(got[0], emu[0], CARD_TOL, "h")
    for i, name in ((1, "k"), (2, "v")):     # [L, nkv, s, hd]: each (layer, kv head, row)
        _rows_close(got[i].flatten(0, 2), emu[i].flatten(0, 2), CARD_TOL, name)
