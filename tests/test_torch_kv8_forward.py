"""Port parity of ``forward`` and ``decode_step_batched`` over the int8 KV
cache (``KVCache8``) against the JAX package on the same numpy inputs (the
kernels are held in ``test_torch_kv8.py``, the engines in
``test_torch_kv8_engines.py``).

``forward``'s flash decode on the CPU needs JAX's own test hook
``AWQ_TPU_FORCE_FLASH=1`` and a cache of a multiple of 256 positions.
Without it JAX's CPU ``forward`` quantizes the current token before
attending to it; the port follows the deployed order (the current token in
full precision, quantized after every layer has run). The model is tiny
and f32: 2 layers, hidden 512, head_dim 128, W4-g128 weights. The JAX side
is imported inside the tests that use it, so that the card's test (marked
``cuda``, skipped here) runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import ModelConfig as TConfig, QuantConfig as TQuant
from awq_tpu_torch.convert import kv_cache8_from_jax, params_from_jax
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import cache_append as tca
from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops import megakernel_batched as tmb

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

HD = 128
GEOM = dict(arch="llama", vocab_size=512, hidden_size=512,
            intermediate_size=1024, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=128, max_position_embeddings=256, dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, ref, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _cache8(rng, *shape):
    """A random int8 cache: ``(codes, scales)`` numpy arrays of a
    ``quantize_kv`` of unit normals."""
    q, s = tca.quantize_kv(torch.from_numpy(_normal(rng, *shape)))
    return q.numpy(), s.numpy()


# ---- forward and the batched step ---------------------------------------------------

@pytest.fixture(scope="module")
def model():
    import jax
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama

    jcfg, tcfg = JConfig(**GEOM), TConfig(**GEOM)
    jparams = jllama.quantize_params(jllama.init_params(jcfg, jax.random.PRNGKey(2)),
                                     JQuant(w_bit=4, group_size=128))
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


def _flash_env(monkeypatch, mega):
    import jax

    monkeypatch.setenv("AWQ_TPU_FORCE_FLASH", "1")
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    if mega:
        monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    else:
        monkeypatch.delenv("AWQ_TPU_FORCE_MEGAKERNEL", raising=False)
    jax.clear_caches()   # forward's trace reads the env at trace time


# f32 model and int8 cache on both sides. The two sides' k/v differ in f32
# rounding, so a value on a quantization step's edge could take the next
# code (one step, 1/127 of its row's absmax) and move the attention a
# little; measured 7e-7 of the largest logit over the prefill and four
# decodes: 1e-5 leaves a margin and stays far below what the other order
# of quantization (the current token's own k/v taken from the int8 cache)
# changes, over 1e-3 in the test below.
def test_forward_kv8_matches_jax_flash_path(model, monkeypatch):
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = model
    _flash_env(monkeypatch, mega=False)
    t = 256
    rng = np.random.default_rng(3)
    steps = [rng.integers(0, 512, (1, 11))] + [rng.integers(0, 512, (1, 1)) for _ in range(4)]
    jcache = jllama.init_kv_cache8(jcfg, 1, t)
    tcache = tllama.init_kv_cache8(tcfg, 1, t, device="cpu")
    pos, worst = 0, 0.0
    for toks in steps:
        jl, jcache = jllama.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), jcache,
                                    jnp.int32(pos))
        tl, out = tllama.forward(tparams, tcfg, torch.from_numpy(toks), tcache, pos)
        assert out is tcache
        jl = np.asarray(jl)
        worst = max(worst, float(np.abs(tl.numpy() - jl).max() / np.abs(jl).max()))
        pos += toks.shape[1]
    assert worst <= 1e-5, worst
    codes, scales = np.asarray(jcache.data), np.asarray(jcache.scales)
    assert (tcache.data.numpy() == codes).mean() > 0.999
    # the scales are quantize_kv's of the k/v each side computed: f32 sums in
    # another order than XLA's leave ~5% of rows a few ulp apart (<= 12 ulp,
    # 1.1e-6, measured); quantize_kv itself is bit-exact against jax.jit's
    # (test_torch_kv8.py::test_quantize_kv_bit_exact)
    np.testing.assert_allclose(tcache.scales.numpy(), scales, rtol=2e-6, atol=0)
    assert np.abs(tcache.data[:, :, :, :, pos:].numpy()).max() == 0


def test_forward_kv8_scales_are_jitted_quantize_kv_of_its_own_kv(model, monkeypatch):
    """The int8 cache that the port's ``forward`` serves from holds, at every
    position it wrote (an 11-token prefill, then four decodes through the
    int8 append), exactly JAX's ``jax.jit(quantize_kv)`` of the k/v that this
    same forward computed: codes and scales at 0 ulp. The k/v are taken at
    the two writes (the prefill's ``quantize_kv`` and each decode layer's
    K9, which appends them),
    so this holds the serving path's own scale formula, not the two sides'
    k/v, which differ in f32 rounding."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    _, _, tcfg, tparams = model
    seen = []           # (kv [2, B, n_kv, S, hd] float, first position) per write

    def rec_quantize(kv):
        seen.append(("prefill", kv.clone()))
        return tca.quantize_kv(kv)

    def rec_decode(real):
        # K9 appends the current token (k_app, v_app; by default k_new,
        # v_new) to its layer's cache after attending
        def decode(q, k_new, v_new, *a, k_app=None, v_app=None, **kw):
            kv = torch.stack([k_new if k_app is None else k_app,
                              v_new if v_app is None else v_app])
            seen.append(("decode", kv.clone(), a[2].clone()))
            return real(q, k_new, v_new, *a, k_app=k_app, v_app=v_app, **kw)
        return decode

    monkeypatch.setattr(tllama, "quantize_kv", rec_quantize)
    monkeypatch.setattr(tllama, "flash_decode_int8", rec_decode(tllama.flash_decode_int8))
    monkeypatch.setattr(tllama, "flash_decode_int8_append_plain",
                        rec_decode(tllama.flash_decode_int8_append_plain))
    rng = np.random.default_rng(3)
    steps = [rng.integers(0, 512, (1, 11))] + [rng.integers(0, 512, (1, 1)) for _ in range(4)]
    cache = tllama.init_kv_cache8(tcfg, 1, 256, device="cpu")
    pos = 0
    for toks in steps:
        tllama.forward(tparams, tcfg, torch.from_numpy(toks), cache, pos)
        pos += toks.shape[1]
    jq = jax.jit(jllama.quantize_kv)
    layer = 0
    for rec in seen:
        if rec[0] == "prefill":          # one layer's [2, B, n_kv, S, hd]
            codes, scales = (np.asarray(a) for a in jq(jnp.asarray(rec[1].numpy())))
            s = rec[1].shape[3]
            got_c = cache.data[layer % 2, :, :, :, :s].numpy()
            got_s = cache.scales[layer % 2, :, :, :, :s].numpy()
            layer += 1
        else:                            # one layer's [2, B, n_kv, hd]
            codes, scales = (np.asarray(a) for a in jq(jnp.asarray(rec[1].numpy())))
            p = int(rec[2][0])
            got_c = cache.data[layer % 2, :, 0, :, p].numpy()
            got_s = cache.scales[layer % 2, :, 0, :, p].numpy()
            codes, scales = codes[:, 0], scales[:, 0]
            layer += 1
        np.testing.assert_array_equal(got_s, scales)
        np.testing.assert_array_equal(got_c, codes)
    assert [r[0] for r in seen] == ["prefill"] * 2 + ["decode"] * 8


def test_forward_kv8_deployed_order_differs_from_cpu_order(model, monkeypatch):
    """Without the hook, JAX's CPU ``forward`` quantizes the current token
    before attending to it. The port follows the deployed order; the two
    orders give measurably different logits, which is why the test above
    needs the hook."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = model
    monkeypatch.delenv("AWQ_TPU_FORCE_FLASH", raising=False)
    jax.clear_caches()
    rng = np.random.default_rng(5)
    prompt, tok = rng.integers(0, 512, (1, 9)), rng.integers(0, 512, (1, 1))
    jcache = jllama.init_kv_cache8(jcfg, 1, 256)
    tcache = tllama.init_kv_cache8(tcfg, 1, 256, device="cpu")
    jllama.forward(jparams, jcfg, jnp.asarray(prompt, jnp.int32), jcache, jnp.int32(0))
    _, jcache = jllama.forward(jparams, jcfg, jnp.asarray(prompt, jnp.int32), jcache,
                               jnp.int32(0))
    tllama.forward(tparams, tcfg, torch.from_numpy(prompt), tcache, 0)
    jl, _ = jllama.forward(jparams, jcfg, jnp.asarray(tok, jnp.int32), jcache, jnp.int32(9))
    tl, _ = tllama.forward(tparams, tcfg, torch.from_numpy(tok), tcache, 9)
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() > 1e-3 * np.abs(jl).max()
    jax.clear_caches()


def test_forward_kv8_megakernel_matches_jax_from_one_cache(model, monkeypatch):
    """``forward``'s decode on K4's int8 mode against JAX's on its own
    megakernel (interpret mode), with the W4 head inside both: JAX
    prefills 40 tokens into a KVCache8 and the port starts from that cache
    (``kv_cache8_from_jax``), so the two decode the same int8 prefix; then
    four decodes each side. The kernels round alike (K4's test margin); a
    new k/v on a quantization step's edge may take the next code on one
    side: 2^-6 of the largest logit."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, _ = model
    _flash_env(monkeypatch, mega=True)
    try:
        jp = jllama.fuse_linears(jllama.quantize_head(jparams, jcfg), jcfg)
        tp = params_from_jax(jax.device_get(jp), device="cpu")
        assert tmk.head_in_kernel(tp)
        rng = np.random.default_rng(13)
        prompt = rng.integers(0, 512, (1, 40))
        _, jc = jllama.forward(jp, jcfg, jnp.asarray(prompt, jnp.int32),
                               jllama.init_kv_cache8(jcfg, 1, 256), jnp.int32(0))
        tc = kv_cache8_from_jax(jax.device_get(jc), device="cpu")
        assert tmk.megakernel_supported(tcfg, tp["layers"], tc)
        pos = 40
        for _ in range(4):
            tok = rng.integers(0, 512, (1, 1))
            jl, jc = jllama.forward(jp, jcfg, jnp.asarray(tok, jnp.int32), jc, jnp.int32(pos))
            n0 = dict(tmk.LAUNCHES)
            tl, _ = tllama.forward(tp, tcfg, torch.from_numpy(tok), tc, pos)
            assert tmk.LAUNCHES == n0           # the plain version on the CPU
            _close(tl, np.asarray(jl), 2.0 ** -6)
            pos += 1
        assert (tc.data.numpy() == np.asarray(jc.data)).mean() > 0.999
    finally:
        jax.clear_caches()


def test_forward_kv8_megakernel_matches_stacked(model, monkeypatch):
    """``forward`` over a KVCache8 on K4's plain int8 mode against the
    stacked path (K9 and the K7 int8 append): the same token, the same
    quantization points. K4 rounds every matmul input to bf16 where the
    stacked path on an f32 model does not: 3e-2 of the largest logit, the
    margin of the float-cache megakernel test."""
    _, _, tcfg, tparams = model
    params = tllama.fuse_linears(tparams, tcfg)
    rng = np.random.default_rng(7)
    steps = [rng.integers(0, 512, (1, 40))] + [rng.integers(0, 512, (1, 1)) for _ in range(3)]
    caches = [tllama.init_kv_cache8(tcfg, 1, 256, device="cpu") for _ in range(2)]
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    pos = 0
    for toks in steps:
        monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
        assert tmk.megakernel_supported(tcfg, params["layers"], caches[0]) == (True)
        a, _ = tllama.forward(params, tcfg, torch.from_numpy(toks), caches[0], pos)
        monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "0")
        b, _ = tllama.forward(params, tcfg, torch.from_numpy(toks), caches[1], pos)
        _close(a, b, 3e-2)
        pos += toks.shape[1]
    # both wrote every position they fed, codes and scales
    for c in caches:
        assert bool((c.scales[:, :, 0, :, :pos] > 0).all())
        assert float(c.scales[:, :, 0, :, pos:].abs().max()) == 0.0


@pytest.mark.parametrize("mega", [False, True])
@pytest.mark.parametrize("lengths", [[5, 0, 40], [63, 17]])
def test_decode_step_batched_kv8_matches_jax(model, lengths, mega, monkeypatch):
    """One int8 step against JAX's ``decode_step_batched`` (its XLA path on
    the CPU, the current token in full precision as on the TPU): logits to
    f32 rounding (1e-4 of the largest) on the port's stacked path, and the
    written codes and scales. The two sides' new k/v differ in f32
    rounding, so a code on a step's edge may differ by one: at most 1 in
    1000 of the written codes. With ``mega`` the port takes K6's plain int8
    mode, which rounds QKV, gate/up, SiLU·mul and the residual to bf16:
    2e-2 of the largest logit (the K6-against-K4 margin), and codes within
    one step."""
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = model
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1" if mega else "0")
    if mega:
        tparams = tllama.fuse_linears(tparams, tcfg)
        assert tmb.megakernel_batched_supported(tcfg, tparams["layers"],
                                                tllama.init_kv_cache8(tcfg, len(lengths), 8,
                                                                      device="cpu"),
                                                len(lengths))
    b, t = len(lengths), 64
    rng = np.random.default_rng(sum(lengths))
    codes, scales = _cache8(rng, 2, 2, b, 2, t, HD)
    tokens = rng.integers(0, 512, b)
    jl, jc = jllama.decode_step_batched(
        jparams, jcfg, jnp.asarray(tokens, jnp.int32),
        jllama.KVCache8(jnp.asarray(codes), jnp.asarray(scales)),
        jnp.asarray(lengths, jnp.int32))
    tc = tllama.KVCache8(torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy()))
    tl, out = tllama.decode_step_batched(tparams, tcfg, torch.from_numpy(tokens), tc,
                                         torch.tensor(lengths, dtype=torch.int32))
    assert out is tc
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=(2e-2 if mega else 1e-4) * np.abs(jl).max())
    dq = np.abs(tc.data.numpy().astype(int) - np.asarray(jc.data).astype(int))
    if mega:
        assert dq.max() <= 1
        np.testing.assert_allclose(tc.scales.numpy(), np.asarray(jc.scales), rtol=2e-2)
    else:
        assert (dq != 0).mean() < 1e-3
        # as in test_forward_kv8_matches_jax_flash_path: the k/v differ by a
        # few ulp in ~1% of rows (<= 10 ulp, 1.0e-6, measured), the scales with them
        np.testing.assert_allclose(tc.scales.numpy(), np.asarray(jc.scales), rtol=2e-6)
    # only position lengths[b] of slot b changed
    changed = (tc.data.numpy() != codes).any(axis=(0, 1, 3, 5))
    want = np.zeros((b, t), bool)
    want[np.arange(b), lengths] = True
    np.testing.assert_array_equal(changed, want)


# ---- on the card: the model over a KVCache8 against its plain path -------------------

@pytest.mark.cuda
def test_forward_and_batched_step_kv8_kernels_match_plain_on_card(cuda):
    """Model level on the card, bf16 model over a KVCache8: a 40-token
    prefill and three decodes through ``forward`` (K4's int8 mode), the
    same with the megakernels off (K9, the K7 int8 append), and one
    ``decode_step_batched`` of 6 rows on K6's int8 mode and on the stacked
    path; each against ``impl="plain"``, within 5e-2 of the largest logit
    (the float-cache model test's tolerance)."""
    import dataclasses
    import os

    cfg = dataclasses.replace(TConfig(**GEOM), dtype="bfloat16")
    params = tllama.fuse_linears(tllama.init_qparams(
        cfg, TQuant(), torch.Generator("cuda").manual_seed(0)), cfg)
    rng = np.random.default_rng(0)
    steps = [rng.integers(0, 512, (1, 40))] + [rng.integers(0, 512, (1, 1))
                                               for _ in range(3)]
    old = os.environ.get("AWQ_TPU_DISABLE_MEGAKERNEL")
    try:
        for disable in ("0", "1"):
            os.environ["AWQ_TPU_DISABLE_MEGAKERNEL"] = disable
            caches = [tllama.init_kv_cache8(cfg, 1, 256) for _ in range(2)]
            pos = 0
            for toks in steps:
                tt = torch.from_numpy(toks).cuda()
                got, _ = tllama.forward(params, cfg, tt, caches[0], pos)
                ref, _ = tllama.forward(params, cfg, tt, caches[1], pos, impl="plain")
                _close(got.cpu(), ref.cpu(), 5e-2)
                pos += toks.shape[1]
            lens = torch.tensor([30, 0, 7, 255, 100, 64], dtype=torch.int32, device=cuda)
            base = tllama.init_kv_cache8(cfg, 6, 256)
            base.data.random_(-127, 128, generator=torch.Generator("cuda").manual_seed(1))
            base.scales.fill_(0.01)
            toks = torch.arange(6, device=cuda) * 7
            c = [tllama.KVCache8(base.data.clone(), base.scales.clone()) for _ in range(2)]
            got, _ = tllama.decode_step_batched(params, cfg, toks, c[0], lens, max_length=255)
            ref, _ = tllama.decode_step_batched(params, cfg, toks, c[1], lens, impl="plain")
            _close(got.cpu(), ref.cpu(), 5e-2)
    finally:
        if old is None:
            os.environ.pop("AWQ_TPU_DISABLE_MEGAKERNEL", None)
        else:
            os.environ["AWQ_TPU_DISABLE_MEGAKERNEL"] = old
