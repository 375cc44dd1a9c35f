"""Port parity of the tensor-parallel half-layer megakernels K12 and K13
(``ops/megakernel_tp.py``): their plain versions against the JAX
package's ``w4a16_llama_attn_half`` and ``w4a16_llama_mlp_half`` (Pallas
rows 19 and 20) run with ``interpret=True``, on one rank's shard of a
tp = 2 ``build_tp_params`` deploy layout (fused, folded, tiled), carried
to the port by ``convert.rank_params_from_jax``; and the gate,
``tp_megakernel_supported``, on JAX's gate cases.

Geometry: ``tests/test_megakernel_tp.py::_flash_cfg`` (f32, hidden 512,
4 q and 2 kv heads, 2 layers), so a rank holds 2 q heads and 1 kv head, an
intermediate of 512 and a cache of 256 positions. Tests marked ``cuda``
hold the CUDA kernels to the plain versions on a card and skip here.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import ModelConfig as TConfig
from awq_tpu_torch.config import QuantConfig as TQuant
from awq_tpu_torch.convert import rank_params_from_jax, rank_tree_from_jax
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import cache_append as tca
from awq_tpu_torch.ops import megakernel_tp as tmt
from awq_tpu_torch.parallel.deploy import build_tp_params as tbuild
from awq_tpu_torch.parallel.mesh import TPGroup
from awq_tpu_torch.parallel.tp import tp_local_cfg

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

HD, T, TP = 128, 256, 2
GEOM = dict(arch="llama", vocab_size=512, hidden_size=512, intermediate_size=1024,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
            max_position_embeddings=256, dtype="float32")
# As K4's layer step against JAX (tests/test_torch_megakernel.py::TOL): f32
# sums in other orders, and an input to a matmul on a bf16 rounding edge
# that rounds the other way moves that matmul's outputs by up to 6e-4 of
# their largest magnitude; 2^-8 covers it. The k/v in bf16 (int8 cache)
# are one bf16 step apart at most: 2^-7.
TOL, KV_BF16_TOL = 2.0 ** -8, 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, ref, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _with_qkv_bias(params, seed):
    """The plain params with a random q/k/v bias (qwen2's)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    la = dict(params["layers"])
    for n in ("wq", "wk", "wv"):
        ql = la[n]
        shape = (ql.qweight.shape[0], ql.qweight.shape[-1])
        la[n] = dataclasses.replace(
            ql, bias=jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.1))
    return dict(params, layers=la)


@pytest.fixture(scope="module")
def deploys():
    """{"w4", "bias", "w3"}: (JAX rank trees, port rank params) of a tp = 2
    deploy layout, ranks 0 and 1."""
    import jax
    from awq_tpu.config import ModelConfig, QuantConfig
    from awq_tpu.models.llama import init_params, quantize_params
    from awq_tpu.parallel import MeshConfig, build_tp_params, make_mesh

    cfg = ModelConfig(**GEOM)
    fp = init_params(cfg, jax.random.PRNGKey(3), scale=0.05)
    mesh = make_mesh(MeshConfig(dp=1, tp=TP), devices=jax.devices()[:TP])
    w4 = quantize_params(fp, QuantConfig(w_bit=4, group_size=128))
    plain = {"w4": w4, "bias": _with_qkv_bias(w4, 1),
             "w3": quantize_params(fp, QuantConfig(w_bit=3, group_size=128))}
    out = {}
    for name, p in plain.items():
        dep = build_tp_params(p, cfg, mesh, quantize_head=True)
        host = types.SimpleNamespace(params=jax.device_get(dep.params), pspecs=dep.pspecs,
                                     tp=dep.tp)
        out[name] = ([jax.tree_util.tree_map(np.asarray, rank_tree_from_jax(host, r))
                      for r in range(TP)],
                     [rank_params_from_jax(host, r, device="cpu") for r in range(TP)])
    return out


def _inputs(seed, H, L, nkv, int8=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ang = rng.uniform(0, 6.28, HD).astype(np.float32)
    d = dict(h=f(1, H) * 0.3, ln1=rng.uniform(0.8, 1.2, (L, H)).astype(np.float32),
             ln2=rng.uniform(0.8, 1.2, (L, H)).astype(np.float32),
             cos=np.cos(ang), sin=np.sin(ang))
    cache = f(L, 2, 1, nkv, T, HD) * 0.3
    if int8:
        q, s = tca.quantize_kv(torch.from_numpy(cache))
        d.update(cache=q.numpy(), scales=s.numpy())
    else:
        d["cache"] = cache
    return d


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case,length", [("w4", 37), ("w4_int8", 100), ("bias", 0),
                                         ("w3", 150)])
def test_attn_half_plain_matches_jax(deploys, case, length, rank):
    """K12's plain version against JAX's ``w4a16_llama_attn_half`` in
    interpret mode on rank ``rank``'s shard: the o-proj partial, the new
    k/v, and the port's in-place write (the k/v, or ``quantize_kv`` of the
    bf16 k/v over an int8 cache) at ``length`` of the layer, nothing else."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel_tp import w4a16_llama_attn_half

    int8 = case.endswith("int8")
    jtrees, tparams = deploys[case.split("_")[0]]
    jl, tl = jtrees[rank]["layers"], tparams[rank]["layers"]
    H, L, nq, nkv, layer = 512, 2, 2, 1, 1
    inp = _inputs(length + rank, H, L, nkv, int8)
    jw = jax.tree_util.tree_map(jnp.asarray, {k: jl[k] for k in ("wqkv", "wo")})
    jo, jk, jv = w4a16_llama_attn_half(
        jnp.asarray(inp["h"]), jw["wqkv"], jw["wo"], jnp.asarray(inp["ln1"]),
        jnp.asarray(inp["cos"]), jnp.asarray(inp["sin"]), jnp.asarray(inp["cache"]), layer,
        length, nq=nq, nkv=nkv, eps=1e-5, interpret=True,
        cache_scales=jnp.asarray(inp["scales"]) if int8 else None)
    t = {k: torch.from_numpy(v.copy()) for k, v in inp.items()}
    cache = t["cache"].clone()
    scales = t["scales"].clone() if int8 else None
    o, k, v = tmt.w4a16_llama_attn_half(
        t["h"], tl["wqkv"], tl["wo"], t["ln1"], t["cos"], t["sin"], cache, layer, length,
        nq, nkv, eps=1e-5, cache_scales=scales)
    assert o.dtype == torch.float32 and tuple(o.shape) == (1, H)
    _close(o, np.asarray(jo), TOL)
    assert k.dtype == (torch.bfloat16 if int8 else torch.float32)
    _close(k, np.asarray(jk, np.float32), KV_BF16_TOL if int8 else TOL)
    _close(v, np.asarray(jv, np.float32), KV_BF16_TOL if int8 else TOL)
    kv = torch.stack([k, v])                                   # [2, nkv, hd]
    if int8:
        q8, s8 = tca.quantize_kv(kv)
        assert torch.equal(cache[layer, :, 0, :, length], q8)
        assert torch.equal(scales[layer, :, 0, :, length], s8)
    else:
        assert torch.equal(cache[layer, :, 0, :, length], kv)
    keep = torch.ones(cache.shape[:5], dtype=torch.bool)
    keep[layer, :, 0, :, length] = False
    assert torch.equal(cache[keep], t["cache"][keep])


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", ["w4", "w3"])
def test_mlp_half_plain_matches_jax(deploys, case, rank):
    """K13's plain version against JAX's ``w4a16_llama_mlp_half`` in
    interpret mode on rank ``rank``'s shard, from an f32 residual."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel_tp import w4a16_llama_mlp_half

    jtrees, tparams = deploys[case]
    jl, tl = jtrees[rank]["layers"], tparams[rank]["layers"]
    inp = _inputs(7 + rank, 512, 2, 1)
    jw = jax.tree_util.tree_map(jnp.asarray, {k: jl[k] for k in ("wgateup", "down")})
    ref = w4a16_llama_mlp_half(jnp.asarray(inp["h"]), jw["wgateup"], jw["down"],
                               jnp.asarray(inp["ln2"]), 0, eps=1e-5, interpret=True)
    got = tmt.w4a16_llama_mlp_half(torch.from_numpy(inp["h"]), tl["wgateup"], tl["down"],
                                   torch.from_numpy(inp["ln2"]), 0, eps=1e-5)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 512)
    _close(got, np.asarray(ref), TOL)


def test_tp_megakernel_supported_matches_jax_gate_cases(deploys):
    """The gate takes a rank's deploy shard with its local cache and
    refuses, as JAX's gate does on the same cases: a cache of batch 2,
    head_dim 64, a bias on ``wo``, an ``act_scale``. (JAX's refusal of an
    untiled layout has no counterpart: the port has no tiled layout.)"""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import ModelConfig
    from awq_tpu.ops.megakernel_tp import tp_megakernel_supported as jgate

    jtrees, tparams = deploys["w4"]
    jl = jax.tree_util.tree_map(jnp.asarray, jtrees[1]["layers"])
    tl = tparams[1]["layers"]
    jcfg = ModelConfig(**dict(GEOM, num_heads=2, num_kv_heads=1))
    tcfg = TConfig(**dict(GEOM, num_heads=2, num_kv_heads=1))
    jbias = dataclasses.replace(jl["wo"], bias=jnp.zeros((2, 512), jnp.float32))
    tbias = dataclasses.replace(tl["wo"], bias=torch.zeros((2, 512)))
    cases = {
        "shard": (jcfg, jl, 1, tcfg, tl, True),
        "batch 2": (jcfg, jl, 2, tcfg, tl, False),
        "head_dim 64": (dataclasses.replace(jcfg, head_dim=64), jl, 1,
                        dataclasses.replace(tcfg, head_dim=64), tl, False),
        "bias on wo": (jcfg, dict(jl, wo=jbias), 1, tcfg, dict(tl, wo=tbias), False),
        "act_scale": (jcfg, dict(jl, act_scale=jnp.ones(512)), 1,
                      tcfg, dict(tl, act_scale=torch.ones(512)), False),
    }
    for name, (jc, jlay, b, tc, tlay, want) in cases.items():
        jcache = jnp.zeros((2, 2, b, 1, T, HD), jnp.float32)
        tcache = torch.zeros((2, 2, b, 1, T, HD))
        assert jgate(jc, jlay, jcache) is want, name
        assert tmt.tp_megakernel_supported(tc, tlay, tcache) is want, name
    # an int8 cache is taken with its scales, as JAX's KVCache8
    codes = torch.zeros((2, 2, 1, 1, T, HD), dtype=torch.int8)
    assert tmt.tp_megakernel_supported(tcfg, tl, tllama.KVCache8(codes, torch.zeros(codes.shape[:5])))
    assert not tmt.tp_megakernel_supported(tcfg, tl, codes)


def test_halves_refuse_what_they_do_not_take():
    """The wrappers raise on a cache or a layout the kernels do not take
    (CPU tensors take the plain versions, so the checks are reached on a
    meta device, where no kernel launches)."""
    cfg = TConfig(**GEOM)
    params = tllama.quantize_params(tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                                       device="cpu"), TQuant(4, 128))
    la = tbuild(params, cfg, TPGroup(rank=0, size=2, group=None, device=torch.device("cpu")))[
        "layers"]
    meta = torch.device("meta")
    h = torch.zeros((1, 512), device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tmt.w4a16_llama_attn_half(h, la["wqkv"], la["wo"], la["ln1"], h[0, :HD], h[0, :HD],
                                  torch.zeros((2, 2, 1, 1, T, HD), device=meta), 0, 0, 2, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tmt.w4a16_llama_mlp_half(h, la["wgateup"], la["down"], la["ln2"], 0)


# ---- on the card: K12 and K13 against their plain versions ----------------------

# f32 sums in other orders than the plain version's, bf16 k/v for the
# bf16 and int8 caches: 2^-6 of the largest value, as for K4's layer entry.
CARD_TOL = 2.0 ** -6


def _card_shard(cuda, w_bit, rank, bias=False):
    """A rank's deploy shard of a tp = 2 Llama-shaped model on the card:
    hidden 1024, 8 q / 2 kv heads, intermediate 2048, 3 layers."""
    cfg = TConfig(**dict(GEOM, hidden_size=1024, intermediate_size=2048, num_layers=3,
                         num_heads=8, num_kv_heads=2, dtype="bfloat16",
                         arch="qwen2" if bias else "llama", qkv_bias=bias))
    g = torch.Generator(device=cuda).manual_seed(5 + rank)
    params = tllama.init_qparams(cfg, TQuant(w_bit, 128), g, device=cuda)
    if bias:
        for n in ("wq", "wk", "wv"):
            params["layers"][n].bias.normal_(generator=g).mul_(0.1)
    mesh = TPGroup(rank=rank, size=2, group=None, device=cuda)
    return tp_local_cfg(cfg, 2), tbuild(params, cfg, mesh)["layers"], g


@pytest.mark.cuda
@pytest.mark.parametrize("w_bit,cache_dtype,bias", [
    (4, torch.bfloat16, False), (4, "int8", False), (4, torch.float32, True),
    (3, torch.bfloat16, False)], ids=["w4-bf16", "w4-int8", "w4-f32-bias", "w3-bf16"])
@pytest.mark.parametrize("length", [0, 200])
def test_attn_half_kernel_matches_plain_on_card(cuda, w_bit, cache_dtype, bias, length):
    lcfg, la, g = _card_shard(cuda, w_bit, 1, bias)
    nq, nkv, H = lcfg.num_heads, lcfg.num_kv_heads, lcfg.hidden_size
    data = torch.randn((3, 2, 1, nkv, 512, HD), generator=g, device=cuda) * 0.3
    if cache_dtype == "int8":
        codes, scales = tca.quantize_kv(data)
        caches = [(codes, scales), (codes.clone(), scales.clone())]
    else:
        data = data.to(cache_dtype)
        caches = [(data, None), (data.clone(), None)]
    h = (torch.randn((1, H), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    ang = torch.rand(HD, generator=g, device=cuda) * 6.28
    args = (h, la["wqkv"], la["wo"], la["ln1"], ang.cos(), ang.sin())
    before = tmt.LAUNCHES["megakernel_attn_half" + ("_w3" if w_bit == 3 else "")
                          + ("_int8" if cache_dtype == "int8" else "")]
    got = tmt.w4a16_llama_attn_half(*args, caches[0][0], 2, length, nq, nkv,
                                    cache_scales=caches[0][1])
    ref = tmt.w4a16_llama_attn_half_plain(*args, caches[1][0], 2, length, nq, nkv,
                                          cache_scales=caches[1][1])
    torch.cuda.synchronize()
    assert tmt.LAUNCHES["megakernel_attn_half" + ("_w3" if w_bit == 3 else "")
                        + ("_int8" if cache_dtype == "int8" else "")] == before + 1
    for a, b in zip(got, ref):
        _close(a.cpu(), b.cpu(), CARD_TOL)
    if cache_dtype == "int8":      # the kernel's write is quantize_kv of its own k/v
        q8, s8 = tca.quantize_kv(torch.stack(got[1:]))
        assert torch.equal(caches[0][0][2, :, 0, :, length], q8)
        assert torch.equal(caches[0][1][2, :, 0, :, length], s8)
    else:
        assert torch.equal(caches[0][0][2, :, 0, :, length], torch.stack(got[1:]))
    keep = torch.ones(caches[0][0].shape[:5], dtype=torch.bool, device=cuda)
    keep[2, :, 0, :, length] = False
    assert torch.equal(caches[0][0][keep], caches[1][0][keep])


@pytest.mark.cuda
@pytest.mark.parametrize("w_bit", [4, 3])
def test_mlp_half_kernel_matches_plain_on_card(cuda, w_bit):
    lcfg, la, g = _card_shard(cuda, w_bit, 0)
    h1 = torch.randn((1, lcfg.hidden_size), generator=g, device=cuda) * 0.5
    got = tmt.w4a16_llama_mlp_half(h1, la["wgateup"], la["down"], la["ln2"], 1)
    ref = tmt.w4a16_llama_mlp_half_plain(h1, la["wgateup"], la["down"], la["ln2"], 1)
    torch.cuda.synchronize()
    _close(got.cpu(), ref.cpu(), CARD_TOL)
