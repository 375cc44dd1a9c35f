"""Port parity of the int8 KV cache (``KVCache8``), its kernels:
``quantize_kv``, the int8 flash decode (K9, ``flash_decode_int8``), the
int8 modes of the megakernels K4 and K6 and of the append K7, against the
JAX package on the same numpy inputs. ``forward`` and
``decode_step_batched`` over a ``KVCache8`` are held in
``test_torch_kv8_forward.py``, both engines with ``cache_dtype="int8"`` in
``test_torch_kv8_engines.py``.

Where the JAX function reaches a Pallas kernel it runs with
``interpret=True``; ``forward``'s flash decode on the CPU needs JAX's own
test hook ``AWQ_TPU_FORCE_FLASH=1`` and a cache of a multiple of 256
positions. Without it JAX's CPU ``forward`` quantizes the current token
before attending to it; the port follows the deployed order (the current
token in full precision, quantized after every layer has run). Geometry:
head_dim 128, 2 layers, 256-512 positions. The JAX side is imported inside
the tests that use it, so that the card's tests (marked ``cuda``, skipped
here) run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import ModelConfig as TConfig
from awq_tpu_torch.convert import kv_cache8_from_jax, params_from_jax
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import cache_append as tca
from awq_tpu_torch.ops import decode_attn as tda
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


# ---- quantize_kv -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact(dtype):
    """Codes and scales equal JAX's ``quantize_kv`` bit for bit as every
    deployed caller runs it, under ``jax.jit`` (XLA turns its ``/ 127.0``
    into a multiplication by ``f32(1/127)``), on random rows, on rows whose
    values divide to exact .5 ties (absmax 127 makes the scale exactly 1:
    round half to even), and on an all-zero head (the 1e-6 floor)."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.models.llama import quantize_kv

    jquantize_kv = jax.jit(quantize_kv)

    rng = np.random.default_rng(0)
    x = _normal(rng, 3, 5, 2, HD) * 3.0
    x[0, 0, 0] = 0.0                                        # all-zero head
    ties = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5, 4.5], np.float32)
    x[1, 1, 1] = 0.0
    x[1, 1, 1, :8] = ties
    x[1, 1, 1, 8] = 127.0                                   # scale exactly 1
    x[2, 3, 0] = 1e-8                                       # under the floor
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    jq, js = jquantize_kv(jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype)))
    q, s = tca.quantize_kv(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    assert q[0, 0, 0].abs().max() == 0
    assert s[1, 1, 1] == 1.0
    np.testing.assert_array_equal(q[1, 1, 1, :9].numpy(), [0, 2, 2, 0, -2, 126, -4, 4, 127])
    # dequantization recovers each value within half a step (and the f32
    # rounding of code * scale, a few 1e-6 of a step at these sizes)
    err = (tca.dequantize_kv(q, s) - xt.float()).abs()
    assert bool((err <= s[..., None] / 2 * (1 + 1e-4)).all())


def test_init_kv_cache8_and_convert():
    import jax
    from awq_tpu.config import ModelConfig as JConfig
    from awq_tpu.models import llama as jllama

    cfg = TConfig(**GEOM)
    c = tllama.init_kv_cache8(cfg, 3, 256, device="cpu")
    assert isinstance(c, tllama.KVCache8) and c.device.type == "cpu"
    assert c.data.dtype == torch.int8 and tuple(c.data.shape) == (2, 2, 3, 2, 256, HD)
    assert c.scales.dtype == torch.float32 and tuple(c.scales.shape) == (2, 2, 3, 2, 256)
    assert tllama.cache_seq_len(c) == 256 == tllama.cache_seq_len(c.data)
    j = jllama.init_kv_cache8(JConfig(**GEOM), 3, 256)
    rng = np.random.default_rng(1)
    codes, scales = _cache8(rng, 2, 2, 3, 2, 256, HD)
    j = j._replace(data=codes, scales=scales)
    t = kv_cache8_from_jax(jax.device_get(j), device="cpu")
    assert torch.equal(t.data, torch.from_numpy(codes))
    assert torch.equal(t.scales, torch.from_numpy(scales))
    # JAX's [.., T//256, 256] scale view comes back as [.., T]
    t2 = kv_cache8_from_jax(j._replace(scales=scales.reshape(2, 2, 3, 2, 1, 256)),
                            device="cpu")
    assert torch.equal(t2.scales, t.scales)
    # half the bytes of a bf16 cache, plus 4 bytes of scale per 128 codes
    nbytes = sum(x.numel() * x.element_size() for x in c)
    bf = tllama.init_kv_cache(cfg, 3, 256, device="cpu")
    assert nbytes == bf.numel() * 2 // 2 + bf.numel() * 4 // HD


# ---- K9: int8 flash decode ---------------------------------------------------------

# f32 on both sides, the same order of scale multiplies; the Pallas
# kernel's online softmax over blocks of 256 and the plain version's
# one-pass softmax differ only in f32 rounding.
@pytest.mark.parametrize("lengths", [[300], [0, 37, 256, 511, 1, 128, 255, 64]],
                         ids=["B1", "B8"])
def test_flash_decode_int8_plain_matches_pallas(lengths):
    import jax.numpy as jnp
    from awq_tpu.ops.decode_attn import flash_decode_stacked8

    L, nq, nkv, t = 2, 4, 2, 512
    b = len(lengths)
    rng = np.random.default_rng(b)
    codes, scales = _cache8(rng, L, 2, b, nkv, t, HD)
    q = _normal(rng, b, nq, HD)
    k_new, v_new = _normal(rng, b, nkv, HD), _normal(rng, b, nkv, HD)
    lens = np.array(lengths, np.int32)
    layer = 1
    ref = np.asarray(flash_decode_stacked8(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(codes),
        jnp.asarray(scales.reshape(L, 2, b, nkv, t // 256, 256)), jnp.int32(layer),
        jnp.asarray(lens), interpret=True))
    got = tda.flash_decode_int8(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(codes)[layer], torch.from_numpy(scales)[layer],
        torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_flash_decode_int8_ignores_positions_past_length():
    rng = np.random.default_rng(4)
    codes, scales = (torch.from_numpy(a) for a in _cache8(rng, 2, 2, 2, 64, HD))
    q = torch.from_numpy(_normal(rng, 2, 4, HD))
    kn, vn = (torch.from_numpy(_normal(rng, 2, 2, HD)) for _ in range(2))
    lengths = torch.tensor([20, 0], dtype=torch.int32)
    a = tda.flash_decode_int8(q, kn, vn, codes, scales, lengths)
    codes[:, :, :, 20:] = 127
    scales[:, :, :, 20:] = 1e9
    b = tda.flash_decode_int8(q, kn, vn, codes, scales, lengths)
    assert torch.equal(a, b)
    # a row of length 0 attends to its current token alone
    np.testing.assert_allclose(a[1].reshape(2, 2, HD).numpy(),
                               vn[1][:, None].expand(2, 2, HD).numpy(), rtol=1e-6)


# ---- K4 and K6: the megakernels' int8 modes ----------------------------------------

def _kv8_in(inp, slots):
    """The JAX and port int8 caches of a test's random f32 cache."""
    q, s = tca.quantize_kv(torch.from_numpy(inp["cache"][:, :, :slots]))
    return q, s


# The plain versions compute in f32 what the JAX kernels compute in f32 in
# interpret mode, with the same bf16 rounding points and the same
# elementwise dequantization (f32(code) * scale); TOL and K6's TOL_B are
# the bf16-edge margins of the float-cache tests (test_torch_megakernel*).
TOL, TOL_B = 2.0 ** -8, 2.0 ** -6


def _check_k4_write(codes, scales, before, kv, layers, length):
    """K4's int8 write: at ``length`` of ``layers`` the codes and scales are
    ``quantize_kv`` of the returned bf16 k/v (``kv``, each ``[len(layers),
    nkv, hd]``), bit for bit; everywhere else the cache is ``before``."""
    for i, x in enumerate(kv):
        q, s = tca.quantize_kv(x)
        assert torch.equal(codes[layers, i, 0, :, length], q)
        assert torch.equal(scales[layers, i, 0, :, length], s)
    codes[layers, :, 0, :, length] = before[0][layers, :, 0, :, length]
    scales[layers, :, 0, :, length] = before[1][layers, :, 0, :, length]
    assert torch.equal(codes, before[0]) and torch.equal(scales, before[1])


def _check_k6_write(codes, scales, before, kv, lengths):
    """K6's int8 write: row b's codes and scales at ``lengths[b]`` are
    ``quantize_kv`` of its returned bf16 k/v (``kv``, each ``[L, B, nkv,
    hd]``), bit for bit; everywhere else the cache is ``before``."""
    rows, ll = torch.arange(len(lengths), device=codes.device), lengths.long()
    for i, x in enumerate(kv):
        q, s = tca.quantize_kv(x)
        # the indexed view [:, i, rows, :, ll] is [B, L, nkv, ...]
        assert torch.equal(codes[:, i, rows, :, ll].transpose(0, 1), q)
        assert torch.equal(scales[:, i, rows, :, ll].transpose(0, 1), s)
    codes[:, :, rows, :, ll] = before[0][:, :, rows, :, ll]
    scales[:, :, rows, :, ll] = before[1][:, :, rows, :, ll]
    assert torch.equal(codes, before[0]) and torch.equal(scales, before[1])


@pytest.mark.parametrize("entry", ["layer", "token"])
def test_megakernel_int8_plain_matches_jax(entry):
    """K4's int8 mode (``cache_scales``) against JAX's kernel in interpret
    mode: the residual, the bf16 k/v it returns (and the head's logits);
    the port's in-place write is quantize_kv of its own returned k/v."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops import megakernel as jmk
    from test_torch_megakernel_batched import _inputs, _jax_lins

    nq = nkv = 2
    H, I, L, V, length = nq * HD, 256, 2, 512, 100
    jl = _jax_lins(21, H, I, nq, nkv, L, vocab=V if entry == "token" else 0)
    t = params_from_jax(jax.device_get(jl), device="cpu")
    inp = _inputs(22, H, L, nkv)
    codes, scales = _kv8_in(inp, 1)
    h = torch.from_numpy(inp["h"][:1].copy()).to(torch.bfloat16)
    cos, sin = torch.from_numpy(inp["cos"][0]), torch.from_numpy(inp["sin"][0])
    ln1, ln2 = torch.from_numpy(inp["ln1"]), torch.from_numpy(inp["ln2"])
    jh = jnp.asarray(h.float().numpy()).astype(jnp.bfloat16)
    jargs = (jh, jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"], jnp.asarray(inp["ln1"]),
             jnp.asarray(inp["ln2"]), jnp.asarray(inp["cos"][0]), jnp.asarray(inp["sin"][0]),
             jnp.asarray(codes.numpy()))
    jkw = dict(nq=nq, nkv=nkv, eps=1e-5, cache_scales=jnp.asarray(scales.numpy()),
               interpret=True)
    c8, s8 = codes.clone(), scales.clone()
    targs = (h, t["wqkv"], t["wo"], t["wgateup"], t["down"], ln1, ln2, cos, sin, c8)
    if entry == "layer":
        res = jmk.w4a16_llama_layer_step(*jargs, 1, length, **jkw)
        got = tmk.w4a16_llama_layer_step(*targs, 1, length, nq, nkv, 1e-5,
                                         cache_scales=s8)
        layers = [1]
    else:
        norm = jnp.asarray(inp["norm"])
        res = jmk.w4a16_llama_token_step(*jargs, length, whead=jl["lm_head"], norm_w=norm,
                                         **jkw)
        got = tmk.w4a16_llama_token_step(*targs, length, nq, nkv, 1e-5,
                                         whead=t["lm_head"],
                                         norm_w=torch.from_numpy(inp["norm"]),
                                         cache_scales=s8)
        layers = list(range(L))
    assert len(got) == len(res)
    assert got[1].dtype == torch.bfloat16 and res[1].dtype == jnp.bfloat16
    # the token entry's residual leaves in bf16 after every layer: one bf16
    # step of an element in [1, 2) is 2^-7, above TOL of a largest value
    # under 2, so it takes TOL_B
    for g, r in zip(got, res):
        _close(g, r, TOL if entry == "layer" else TOL_B)
    _check_k4_write(c8, s8, (codes, scales), got[1:3], layers, length)


def test_megakernel_batched_int8_plain_matches_jax():
    """K6's int8 slot mode against JAX's kernel in interpret mode at 8 rows
    (JAX's ``B % 8``) of ragged lengths including 0 and T-1."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel_batched import w4a16_llama_token_step_batched
    from test_torch_megakernel_batched import B, LENGTHS, T, _inputs, _jax_lins

    nq, nkv = 4, 2
    H, I, L, V = nq * HD, 256, 2, 512
    jl = _jax_lins(31, H, I, nq, nkv, L, bias=True, vocab=V)
    t = params_from_jax(jax.device_get(jl), device="cpu")
    inp = _inputs(32, H, L, nkv)
    codes, scales = _kv8_in(inp, B)
    h = torch.from_numpy(inp["h"].copy()).to(torch.bfloat16)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    res = w4a16_llama_token_step_batched(
        jnp.asarray(h.float().numpy()).astype(jnp.bfloat16), jl["wqkv"], jl["wo"],
        jl["wgateup"], jl["down"], jnp.asarray(inp["ln1"]), jnp.asarray(inp["ln2"]),
        jnp.asarray(inp["cos"]), jnp.asarray(inp["sin"]), jnp.asarray(codes.numpy()),
        jnp.asarray(LENGTHS, jnp.int32), nq=nq, nkv=nkv, eps=1e-5, interpret=True,
        whead=jl["lm_head"], norm_w=jnp.asarray(inp["norm"]),
        cache_scales=jnp.asarray(scales.numpy().reshape(L, 2, B, nkv, T // 256, 256)))
    c8, s8 = codes.clone(), scales.clone()
    got = tmb.w4a16_llama_token_step_batched(
        h, t["wqkv"], t["wo"], t["wgateup"], t["down"], torch.from_numpy(inp["ln1"]),
        torch.from_numpy(inp["ln2"]), torch.from_numpy(inp["cos"]),
        torch.from_numpy(inp["sin"]), c8, lengths, nq, nkv, 1e-5, whead=t["lm_head"],
        norm_w=torch.from_numpy(inp["norm"]), cache_scales=s8)
    assert len(got) == len(res) == 4 and got[1].dtype == torch.bfloat16
    for g, r in zip(got, res):
        _close(g, r, TOL_B)
    _check_k6_write(c8, s8, (codes, scales), got[1:3], lengths)


def test_megakernel_batched_int8_plain_matches_single_token_per_row():
    """Row b of K6's plain int8 mode against K4's plain int8 mode on that
    row's slot; K6 rounds QKV, gate/up and SiLU·mul to bf16 where K4 keeps
    f32: 2e-2 of the largest value, as the float-cache test of the two."""
    from test_torch_megakernel_batched import LENGTHS, B, T

    g = torch.Generator().manual_seed(8)
    nq, nkv, H, I, L = 4, 2, 512, 256, 2

    def lin(ic, oc):
        qw = torch.randint(-(2**31), 2**31 - 1, (L, ic // 8, oc), generator=g,
                           dtype=torch.int32)
        s = (torch.rand((L, ic // 128, oc), generator=g) + 0.5) * 0.01
        return tmk.QLinear(qweight=qw, scales=s, szeros=s * 8)

    ws = (lin(H, (nq + 2 * nkv) * HD), lin(H, H), lin(H, 2 * I), lin(I, H))
    ln = torch.ones((L, H))
    codes, scales = tca.quantize_kv(torch.randn((L, 2, B, nkv, T, HD), generator=g) * 0.3)
    h = (torch.randn((B, H), generator=g) * 0.5).to(torch.bfloat16)
    ang = torch.rand((B, HD), generator=g) * 6.28
    cos, sin = torch.cos(ang), torch.sin(ang)
    c8, s8 = codes.clone(), scales.clone()
    got = tmb.w4a16_llama_token_step_batched_plain(
        h, *ws, ln, ln, cos, sin, c8, torch.tensor(LENGTHS, dtype=torch.int32), nq, nkv,
        cache_scales=s8)
    for b in (0, 1, 5):
        cb, sb = codes[:, :, b:b + 1].clone(), scales[:, :, b:b + 1].clone()
        ref = tmk.w4a16_llama_token_step_plain(h[b:b + 1], *ws, ln, ln, cos[b], sin[b], cb,
                                               LENGTHS[b], nq, nkv, cache_scales=sb)
        _close(got[0][b:b + 1], ref[0], 2e-2)
        _close(got[1][:, b], ref[1], 2e-2)
        _close(got[2][:, b], ref[2], 2e-2)


# ---- K7: the int8 append -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_append_int8_plain_bit_exact_against_jax(dtype):
    """K7's int8 mode against JAX's per-row ``quantize_kv`` (jitted, as its
    callers run it) + ``dynamic_update_slice`` loop
    (``models/llama.py:1313-1325``), bit for bit, rows at 0, T-1 and past T
    (clamped to T-1 by both)."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.models.llama import quantize_kv

    jquantize_kv = jax.jit(quantize_kv)

    L, b, nkv, t = 2, 4, 2, 64
    rng = np.random.default_rng(6)
    codes, scales = _cache8(rng, L, 2, b, nkv, t, HD)
    kv = torch.from_numpy(_normal(rng, L, 2, b, nkv, HD)).to(getattr(torch, dtype))
    lengths = np.array([0, t - 1, t + 5, 17], np.int32)
    jkvq, jkvs = jquantize_kv(jnp.asarray(kv.float().numpy()).astype(getattr(jnp, dtype)))
    jd, js = jnp.asarray(codes), jnp.asarray(scales)
    for i in range(b):
        jd = jax.lax.dynamic_update_slice(jd, jkvq[:, :, i][:, :, None, :, None, :],
                                          (0, 0, i, 0, int(lengths[i]), 0))
        js = jax.lax.dynamic_update_slice(js, jkvs[:, :, i][:, :, None, :, None],
                                          (0, 0, i, 0, int(lengths[i])))
    td, ts = torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy())
    assert tca.batched_cache_append_int8(td, ts, kv, torch.from_numpy(lengths)) is None
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


# ---- on the card: K9, K4, K6 and K7 int8 against their plain versions ----------------

# bf16 output rounding 2^-9, sums in other orders: 2^-6 of the largest value.
CARD_TOL = 2.0 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [[0], [1], [1000], [1000, 0, 930, 1100, 1015, 850, 1200, 31]],
                         ids=["len0", "len1", "len1000", "B8"])
def test_flash_decode_int8_kernel_matches_plain_on_card(cuda, lengths):
    g = torch.Generator(device=cuda).manual_seed(len(lengths) + lengths[0])
    b, nq, nkv, t = len(lengths), 32, 8, 1280
    codes, scales = tca.quantize_kv(torch.randn((2, b, nkv, t, HD), generator=g, device=cuda))
    q = torch.randn((b, nq, HD), generator=g, device=cuda).to(torch.bfloat16)
    kn, vn = (torch.randn((b, nkv, HD), generator=g, device=cuda).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n0 = tda.LAUNCHES["flash_decode_int8"]
    got = tda.flash_decode_int8(q, kn, vn, codes, scales, lens, max_length=max(lengths))
    ref = tda.flash_decode_int8_plain(q, kn, vn, codes, scales, lens, max_length=max(lengths))
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_int8"] == n0 + 1
    _close(got.cpu(), ref.cpu(), CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [0, 37, 200])
def test_megakernel_int8_kernels_match_plain_on_card(cuda, length):
    from test_torch_megakernel import _card_model

    nq, nkv, H, I, L = 4, 2, 512, 1024, 3
    ws, (ln1, ln2), cache, cos, sin, g = _card_model(cuda, nq, nkv, H, I, L, True, length)
    codes, scales = tca.quantize_kv(cache)
    h = (torch.randn((1, H), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    head = dict(whead=tmk.QLinear(
        qweight=torch.randint(-(2**31), 2**31 - 1, (H // 8, 1024), generator=g,
                              dtype=torch.int32, device=cuda),
        scales=torch.full((H // 128, 1024), 0.01, device=cuda),
        szeros=torch.full((H // 128, 1024), 0.08, device=cuda)),
        norm_w=torch.ones(H, dtype=torch.bfloat16, device=cuda))
    for entry in ("layer", "token"):
        c = [(codes.clone(), scales.clone()) for _ in range(2)]
        args = (h, *ws, ln1, ln2, cos[0], sin[0])
        if entry == "layer":
            got = tmk.w4a16_llama_layer_step(*args, c[0][0], 1, length, nq, nkv,
                                             cache_scales=c[0][1])
            ref = tmk.w4a16_llama_layer_step_plain(*args, c[1][0], 1, length, nq, nkv,
                                                   cache_scales=c[1][1])
            layers = [1]
        else:
            got = tmk.w4a16_llama_token_step(*args, c[0][0], length, nq, nkv,
                                             cache_scales=c[0][1], **head)
            ref = tmk.w4a16_llama_token_step_plain(*args, c[1][0], length, nq, nkv,
                                                   cache_scales=c[1][1], **head)
            layers = list(range(L))
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            _close(a.cpu(), r.cpu(), CARD_TOL)
        _check_k4_write(*c[0], (codes, scales), got[1:3], layers, length)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 5, 40])
def test_batched_int8_kernel_matches_plain_on_card(cuda, b):
    from test_torch_megakernel_batched import T, _card_model

    nq, nkv, H, I, L = 4, 2, 512, 1024, 3
    ws, (ln1, ln2), cache, cos, sin, hd_kw, g = _card_model(cuda, nq, nkv, H, I, L, b,
                                                            True, b)
    codes, scales = tca.quantize_kv(cache)
    h = (torch.randn((b, H), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    lens = torch.randint(0, T, (b,), generator=g, device=cuda).to(torch.int32)
    lens[0], lens[-1] = 0, T - 1
    c1, s1, c2, s2 = codes.clone(), scales.clone(), codes.clone(), scales.clone()
    n0 = tmb.LAUNCHES["megakernel_batched_int8"]
    got = tmb.w4a16_llama_token_step_batched(h, *ws, ln1, ln2, cos, sin, c1, lens, nq, nkv,
                                             max_length=T - 1, cache_scales=s1, **hd_kw)
    ref = tmb.w4a16_llama_token_step_batched_plain(h, *ws, ln1, ln2, cos, sin, c2, lens,
                                                   nq, nkv, cache_scales=s2, **hd_kw)
    torch.cuda.synchronize()
    assert tmb.LAUNCHES["megakernel_batched_int8"] == n0 + 1
    # the float-cache test's tolerance over 3 layers (test_torch_megakernel_batched)
    for a, r in zip(got, ref):
        _close(a.cpu(), r.cpu(), 2.0 ** -5)
    _check_k6_write(c1, s1, (codes, scales), got[1:3], lens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cache_append_int8_kernel_exact_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    L, b, nkv, t = 3, 5, 8, 300
    codes, scales = tca.quantize_kv(torch.randn((L, 2, b, nkv, t, HD), generator=g,
                                                device=cuda))
    kv = (torch.randn((L, 2, b, nkv, HD), generator=g, device=cuda) * 2).to(dtype)
    kv[0, 1, 2, 3] = 0.0                                    # the 1e-6 floor
    lens = torch.tensor([0, t - 1, t + 9, 17, 123], dtype=torch.int32, device=cuda)
    c1, s1, c2, s2 = codes.clone(), scales.clone(), codes.clone(), scales.clone()
    tca.batched_cache_append_int8(c1, s1, kv, lens)
    tca.batched_cache_append_int8_plain(c2, s2, kv, lens)
    torch.cuda.synchronize()
    assert torch.equal(c1, c2) and torch.equal(s1, s2)
