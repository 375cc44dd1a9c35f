"""Port parity of the batched whole-token megakernel (K6,
``ops/megakernel_batched.py``): the plain version against the JAX Pallas
kernel run with ``interpret=True``, against the port's own single-token
plain version row by row, and the gate.

Shapes follow the JAX package's own test of the kernel: 8 rows, 2 layers,
hidden 256, head_dim 128, a bf16 cache of 256 positions, ragged lengths
0..255. The JAX weights are W4-g128 ``quantize_linear`` outputs repacked by
``tile_qlinear(block_n=128, fold_scales=True)`` and reach the port through
``params_from_jax``, which unfolds them. Tests marked ``cuda`` hold the
CUDA kernel to the plain version on a card and skip here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import ModelConfig as TConfig
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops import megakernel_batched as tmb
from awq_tpu_torch.ops.w4a16 import QLinear

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

HD, T, B = 128, 256, 8
LENGTHS = [37, 0, 65, 200, 5, 255, 128, 17]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _jax_lins(seed, H, I, nq, nkv, L, bias=False, vocab=0):
    """Folded stacked W4 linears of the JAX package, distinct per layer."""
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
            qls.append(quantize_linear(w, bias=b))
        ql = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qls)
        return tile_qlinear(ql, block_n=128, fold_scales=True)

    out = {"wqkv": lin(H, (nq + 2 * nkv) * HD, L, bias), "wo": lin(H, H, L),
           "wgateup": lin(H, 2 * I, L), "down": lin(I, H, L)}
    if vocab:
        out["lm_head"] = lin(H, vocab, 1)
    return out


def _inputs(seed, H, L, nkv):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ang = rng.uniform(0, 6.28, (B, HD)).astype(np.float32)
    return dict(h=f(B, H) * 0.3, ln1=rng.uniform(0.8, 1.2, (L, H)).astype(np.float32),
                ln2=rng.uniform(0.8, 1.2, (L, H)).astype(np.float32),
                norm=rng.uniform(0.8, 1.2, H).astype(np.float32),
                cache=f(L, 2, B, nkv, T, HD) * 0.2, cos=np.cos(ang), sin=np.sin(ang))


def _bf16_t(a):
    return torch.from_numpy(a.copy()).to(torch.bfloat16)


def _close(got, ref, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


# The plain version computes in f32 what the JAX kernel computes in f32 in
# interpret mode, with the same bf16 rounding points (matmul inputs, QKV,
# gate/up, SiLU·mul, the residual between layers). An input on a bf16
# rounding edge can round the other way on the two sides (the JAX kernel
# dots against codes biased by +128 and takes 128·sum(x) back off, which
# costs it some f32 cancellation); one element then moves by one bf16 step
# (2^-8 relative) and such steps compound over the layers, as in the chunk
# kernel's test. Measured here after two layers: up to 5e-3 of an output's
# largest magnitude. TOL = 2^-6 covers it.
TOL = 2.0 ** -6


@pytest.mark.parametrize("nq,nkv,bias,head", [
    (2, 2, False, False), (2, 2, False, True), (4, 2, True, False)])
def test_batched_step_plain_matches_jax(nq, nkv, bias, head):
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.cache_append import batched_cache_append
    from awq_tpu.ops.megakernel_batched import w4a16_llama_token_step_batched

    H, I, L, V = nq * HD, 256, 2, 512
    jl = _jax_lins(3 + nq, H, I, nq, nkv, L, bias, V if head else 0)
    inp = _inputs(nq + 10, H, L, nkv)
    t = params_from_jax(jax.device_get(jl), device="cpu")
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    lengths = jnp.asarray(LENGTHS, jnp.int32)
    kw = dict(nq=nq, nkv=nkv, eps=1e-5, interpret=True)
    tkw = {}
    if head:
        kw.update(whead=jl["lm_head"], norm_w=jnp.asarray(inp["norm"]))
        assert t["lm_head"].qweight.dim() == 2
        tkw = dict(whead=t["lm_head"], norm_w=torch.from_numpy(inp["norm"]))
    res = w4a16_llama_token_step_batched(
        jb(inp["h"]), jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"],
        jnp.asarray(inp["ln1"]), jnp.asarray(inp["ln2"]), jnp.asarray(inp["cos"]),
        jnp.asarray(inp["sin"]), jb(inp["cache"]), lengths, **kw)
    cache = _bf16_t(inp["cache"])
    before = cache.clone()
    got = tmb.w4a16_llama_token_step_batched(
        _bf16_t(inp["h"]), t["wqkv"], t["wo"], t["wgateup"], t["down"],
        torch.from_numpy(inp["ln1"]), torch.from_numpy(inp["ln2"]),
        torch.from_numpy(inp["cos"]), torch.from_numpy(inp["sin"]), cache,
        torch.tensor(LENGTHS, dtype=torch.int32), nq, nkv, 1e-5, **tkw)
    assert len(got) == len(res) == (4 if head else 3)
    for g, r in zip(got, res):
        _close(g, r, TOL)
    assert got[1].shape == (L, B, nkv, HD) and got[0].dtype == torch.bfloat16
    if head:
        assert got[3].shape == (B, V) and got[3].dtype == torch.float32
    # the port appends in place what JAX's caller appends with its scatter
    jcache = batched_cache_append(jb(inp["cache"]),
                                  jnp.stack([res[1], res[2]], axis=1), lengths)
    _close(cache, jcache.astype(jnp.float32), TOL)
    rows = torch.arange(B)
    lens = torch.tensor(LENGTHS)
    assert torch.equal(cache[:, 0, rows, :, lens].transpose(0, 1), got[1])
    assert torch.equal(cache[:, 1, rows, :, lens].transpose(0, 1), got[2])
    cache[:, :, rows, :, lens] = before[:, :, rows, :, lens]
    assert torch.equal(cache, before)


def test_batched_plain_matches_single_token_plain_per_row():
    """Row b of the batched plain version against the port's single-token
    plain version on that row's cache slice. K4 keeps QKV, gate/up and
    SiLU·mul in f32 where K6 rounds them to bf16 (2^-9 relative each), so
    the two differ by a few bf16 steps: 2e-2 of the largest value, the
    tolerance of the JAX package's own test of the two kernels."""
    nq, nkv, H, I, L, V = 4, 2, 512, 256, 2, 512
    g = torch.Generator().manual_seed(5)

    def lin(ic, oc, n=L):
        qw = torch.randint(-(2**31), 2**31 - 1, (n, ic // 8, oc), generator=g,
                           dtype=torch.int32)
        s = (torch.rand((n, ic // 128, oc), generator=g) + 0.5) * 0.01
        return QLinear(qweight=qw, scales=s, szeros=s * 8)

    ws = (lin(H, (nq + 2 * nkv) * HD), lin(H, H), lin(H, 2 * I), lin(I, H))
    hq = lin(H, V, 1)
    head = dict(whead=QLinear(qweight=hq.qweight[0], scales=hq.scales[0],
                              szeros=hq.szeros[0]),
                norm_w=torch.rand(H, generator=g) * 0.4 + 0.8)
    ln1, ln2 = (torch.rand((L, H), generator=g) * 0.4 + 0.8 for _ in range(2))
    cache = (torch.randn((L, 2, B, nkv, T, HD), generator=g) * 0.3).to(torch.bfloat16)
    h = (torch.randn((B, H), generator=g) * 0.5).to(torch.bfloat16)
    ang = torch.rand((B, HD), generator=g) * 6.28
    cos, sin = torch.cos(ang), torch.sin(ang)
    c1 = cache.clone()
    got = tmb.w4a16_llama_token_step_batched_plain(
        h, *ws, ln1, ln2, cos, sin, c1, torch.tensor(LENGTHS, dtype=torch.int32),
        nq, nkv, **head)
    for b in (0, 1, 5, 6):
        row = cache[:, :, b:b + 1].clone()
        ref = tmk.w4a16_llama_token_step_plain(
            h[b:b + 1], *ws, ln1, ln2, cos[b], sin[b], row, LENGTHS[b], nq, nkv,
            **head)
        _close(got[0][b:b + 1], ref[0], 2e-2)
        _close(got[1][:, b], ref[1], 2e-2)
        _close(got[2][:, b], ref[2], 2e-2)
        _close(got[3][b:b + 1], ref[3], 2e-2)


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
    "b8", "b2", "b3", "b64", "b1", "b72", "slots", "int8", "disabled", "unforced",
    "hd64", "w3", "unfused"])
def test_batched_gate(case, monkeypatch):
    """K6 takes 2..64 rows over a float cache of as many slots under K4's
    gate; ``B % 8`` and the VMEM budget of the JAX gate are the TPU's."""
    monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    cfg, layers = _gate_model()
    layers = dict(layers)
    batch = {"b2": 2, "b3": 3, "b64": 64, "b1": 1, "b72": 72}.get(case, 8)
    cache = torch.zeros((2, 2, batch, 2, 16, 128))
    if case == "slots":
        cache = torch.zeros((2, 2, 16, 2, 16, 128))
    elif case == "int8":
        cache = cache.to(torch.int8)
    elif case == "disabled":
        monkeypatch.setenv("AWQ_TPU_DISABLE_MEGAKERNEL", "1")
    elif case == "unforced":
        monkeypatch.delenv("AWQ_TPU_FORCE_MEGAKERNEL")   # a CPU cache
    elif case == "hd64":
        cfg = dataclasses.replace(cfg, head_dim=64)
    elif case == "w3":
        layers["down"] = dataclasses.replace(layers["down"], w_bit=3)
    elif case == "unfused":
        layers["up"] = layers.pop("wgateup")
    ok = tmb.megakernel_batched_supported(cfg, layers, cache, batch)
    assert ok == (case in ("b8", "b2", "b3", "b64"))


def test_batched_unported_options_raise():
    """int8 KV (``cache_scales``) runs in slot mode over an int8 cache
    (tests/test_torch_kv8.py) and raises beside a float cache or in paged
    mode, which has no int8 pool, as in JAX; ``tables`` (paged mode) runs:
    a pool of 5 pages of 8 positions, two rows on their own pages."""
    cfg, layers = _gate_model()
    lins = (layers["wqkv"], layers["wo"], layers["wgateup"], layers["down"])
    ln = torch.ones((2, 256))
    cache = torch.zeros((2, 2, 2, 2, 16, 128))
    args = (torch.zeros((2, 256)), *lins, ln, ln, torch.ones((2, 128)),
            torch.zeros((2, 128)), cache, torch.zeros(2, dtype=torch.int32), 2, 2)
    with pytest.raises(ValueError, match="cache_scales"):
        tmb.w4a16_llama_token_step_batched(*args, cache_scales=torch.zeros(1))
    out = tmb.w4a16_llama_token_step_batched(*args)
    assert len(out) == 3 and out[0].shape == (2, 256)
    pool = torch.zeros((2, 2, 5, 2, 8, 128))
    tables = torch.tensor([[3, 1], [2, 4]], dtype=torch.int32)
    lens = torch.tensor([9, 0], dtype=torch.int32)
    paged = (*args[:9], pool, lens, 2, 2)
    out = tmb.w4a16_llama_token_step_batched(*paged, tables=tables)
    assert len(out) == 3 and out[0].shape == (2, 256)
    pool8 = (*args[:9], pool.to(torch.int8), lens, 2, 2)
    with pytest.raises(NotImplementedError, match="paged"):
        tmb.w4a16_llama_token_step_batched(*pool8, tables=tables,
                                           cache_scales=torch.zeros((2, 2, 5, 2, 8)))
    # row 0 wrote position 9 (page 1, offset 1), row 1 position 0 (page 2)
    assert torch.equal(pool[:, 0, 1, :, 1], out[1][:, 0])
    assert torch.equal(pool[:, 1, 2, :, 0], out[2][:, 1])


# ---- on the card: K6 against its plain version ------------------------------

def _card_model(dev, nq, nkv, H, I, L, b, bias, seed, w3=False):
    g = torch.Generator(device=dev).manual_seed(seed)

    def lin(ic, oc, n=L, with_bias=False):
        qw = torch.randint(-(2**31), 2**31 - 1, (n, ic * 3 // 32 if w3 else ic // 8, oc),
                           generator=g, dtype=torch.int32, device=dev)
        s = (torch.rand((n, ic // 128, oc), generator=g, device=dev) + 0.5) * 0.01
        bias_t = (torch.randn((n, oc), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        return QLinear(qweight=qw, scales=s, szeros=s * (4 if w3 else 8),
                       bias=bias_t if with_bias else None, w_bit=3 if w3 else 4,
                       group_size=128, dense3=w3)

    ws = (lin(H, (nq + 2 * nkv) * HD, with_bias=bias), lin(H, H), lin(H, 2 * I),
          lin(I, H))
    ln = [(torch.rand((L, H), generator=g, device=dev) * 0.4 + 0.8).to(torch.bfloat16)
          for _ in range(2)]
    cache = (torch.randn((L, 2, b, nkv, T, HD), generator=g, device=dev) * 0.5
             ).to(torch.bfloat16)
    ang = torch.rand((b, HD), generator=g, device=dev) * 6.28
    hq = lin(H, 1024, 1)
    head = dict(whead=QLinear(qweight=hq.qweight[0], scales=hq.scales[0],
                              szeros=hq.szeros[0], w_bit=hq.w_bit, group_size=128,
                              dense3=w3),
                norm_w=torch.ones(H, dtype=torch.bfloat16, device=dev))
    return ws, ln, cache, torch.cos(ang), torch.sin(ang), head, g


# bf16 residual and k/v out over 3 layers; the kernel sums in other orders
# than the plain version (f32), and a value on a bf16 rounding edge of the
# bf16 scratch can land on the other side: 2^-5 of the largest value.
CARD_TOL = 2.0 ** -5


@pytest.mark.cuda
@pytest.mark.parametrize("b,bias,head", [(8, False, True), (2, True, False),
                                         (5, False, True), (40, True, True),
                                         (2, False, True), (13, True, True),
                                         (64, False, True)])
def test_batched_kernel_matches_plain_on_card(cuda, b, bias, head):
    nq, nkv, H, I, L = 4, 2, 512, 1024, 3
    ws, (ln1, ln2), cache, cos, sin, hd_kw, g = _card_model(
        cuda, nq, nkv, H, I, L, b, bias, b)
    h = (torch.randn((b, H), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    lens = torch.randint(0, T, (b,), generator=g, device=cuda).to(torch.int32)
    lens[0], lens[-1] = 0, T - 1
    kw = hd_kw if head else {}
    c1, c2 = cache.clone(), cache.clone()
    n0 = tmb.LAUNCHES["megakernel_batched"]
    got = tmb.w4a16_llama_token_step_batched(h, *ws, ln1, ln2, cos, sin, c1, lens,
                                             nq, nkv, max_length=T - 1, **kw)
    ref = tmb.w4a16_llama_token_step_batched_plain(h, *ws, ln1, ln2, cos, sin, c2,
                                                   lens, nq, nkv, **kw)
    torch.cuda.synchronize()
    assert tmb.LAUNCHES["megakernel_batched"] == n0 + 1
    assert len(got) == len(ref) == (4 if head else 3)
    for a, r in zip(got, ref):
        _close(a.cpu(), r.cpu(), CARD_TOL)
    # the cache holds the returned k/v at each row's length and is
    # untouched elsewhere
    rows, ll = torch.arange(b, device=cuda), lens.long()
    assert torch.equal(c1[:, 0, rows, :, ll].transpose(0, 1), got[1])
    assert torch.equal(c1[:, 1, rows, :, ll].transpose(0, 1), got[2])
    c1[:, :, rows, :, ll] = cache[:, :, rows, :, ll]
    assert torch.equal(c1, cache)


@pytest.mark.cuda
def test_batched_kernel_without_max_length_and_with_stale_lengths(cuda):
    """Without max_length the wrapper sizes the attention slices for a full
    cache (no device read), and lengths at or past T are clamped to T-1 by
    kernel and plain alike."""
    nq, nkv, H, I, L, b = 2, 2, 256, 256, 2, 8
    ws, (ln1, ln2), cache, cos, sin, _, g = _card_model(cuda, nq, nkv, H, I, L, b,
                                                        False, 99)
    h = (torch.randn((b, H), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    lens = torch.tensor([3, T, 0, T + 40, 9, 1, 2, 100], dtype=torch.int32, device=cuda)
    c1, c2 = cache.clone(), cache.clone()
    got = tmb.w4a16_llama_token_step_batched(h, *ws, ln1, ln2, cos, sin, c1, lens,
                                             nq, nkv)
    ref = tmb.w4a16_llama_token_step_batched_plain(h, *ws, ln1, ln2, cos, sin, c2,
                                                   lens, nq, nkv)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        _close(a.cpu(), r.cpu(), CARD_TOL)
    _close(c1.cpu(), c2.cpu(), CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 33])
def test_batched_kernel_two_calls_bit_equal(cuda, b):
    """The kernel sums in a fixed order (warps, windows and attention slices
    merged in order, no atomics): two calls on the same inputs give the same
    bits, outputs and cache alike."""
    nq, nkv, H, I, L = 4, 2, 512, 1024, 2
    ws, (ln1, ln2), cache, cos, sin, hd_kw, g = _card_model(cuda, nq, nkv, H, I, L, b,
                                                            True, 7 + b)
    h = (torch.randn((b, H), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    lens = torch.randint(0, T, (b,), generator=g, device=cuda).to(torch.int32)
    c1, c2 = cache.clone(), cache.clone()
    one = tmb.w4a16_llama_token_step_batched(h, *ws, ln1, ln2, cos, sin, c1, lens, nq, nkv,
                                             max_length=T - 1, **hd_kw)
    two = tmb.w4a16_llama_token_step_batched(h, *ws, ln1, ln2, cos, sin, c2, lens, nq, nkv,
                                             max_length=T - 1, **hd_kw)
    torch.cuda.synchronize()
    for x, y in zip(one, two):
        assert torch.equal(x, y)
    assert torch.equal(c1, c2)


def _rows_close(got, ref, tol, what):
    """Each row (the first axis; the rest flattened) against its own largest
    magnitude, so that a fault in one row cannot hide under another row's
    larger values."""
    g, r = got.float().cpu().flatten(1), ref.float().cpu().flatten(1)
    err, scale = (g - r).abs().amax(1), r.abs().amax(1)
    bad = torch.nonzero(err > tol * scale).flatten().tolist()
    assert not bad, (f"{what}: rows {bad[:8]} off by {(err / scale)[bad[:8]].tolist()} "
                     f"of their own largest value (tol {tol:g})")


@pytest.mark.cuda
@pytest.mark.parametrize("b,w3", [(32, False), (33, False), (32, True)])
def test_batched_kernel_rows_match_plain_on_card(cuda, b, w3, monkeypatch):
    """At 32 and 33 rows (one and two passes of 32 rows a warp, windows
    over IC in every phase) each row of h and of the logits, and each
    (layer, row) of the k/v written, holds within the card tolerance of its
    own largest value to the plain version with K6's order of f32 sums
    (``test_torch_batched_plan._sched``, the emulation the CPU tests hold to
    the plain version and to JAX's interpret-mode kernel), and the whole
    outputs hold to the plain version as above. A row is held to the
    emulation, not to the plain version: W4's group identity with codes
    biased by 128 (JAX's) moved single rows of this random model by up to
    3.4% of their own largest value in f32 on the CPU too
    (scripts/exp_batched_rows.py); K6 now takes its W4 codes centred (q -
    8), and so does the emulation."""
    import dataclasses

    from test_torch_batched_plan import _sched

    nq, nkv, H, I, L = 4, 2, 512, 1024, 3
    ws, (ln1, ln2), cache, cos, sin, hd_kw, g = _card_model(cuda, nq, nkv, H, I, L, b,
                                                            True, 50 + b, w3=w3)
    h = (torch.randn((b, H), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    lens = torch.randint(0, T, (b,), generator=g, device=cuda).to(torch.int32)
    lens[1] = 0
    got = tmb.w4a16_llama_token_step_batched(h, *ws, ln1, ln2, cos, sin, cache.clone(), lens,
                                             nq, nkv, max_length=T - 1, **hd_kw)
    ref = tmb.w4a16_llama_token_step_batched_plain(h, *ws, ln1, ln2, cos, sin, cache.clone(),
                                                   lens, nq, nkv, **hd_kw)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        _close(a.cpu(), r.cpu(), CARD_TOL)
    cpu = lambda q: dataclasses.replace(q, **{f.name: getattr(q, f.name).cpu()
                                              for f in dataclasses.fields(q)
                                              if isinstance(getattr(q, f.name), torch.Tensor)})
    wc = [cpu(q) for q in ws]
    head = dict(whead=cpu(hd_kw["whead"]), norm_w=hd_kw["norm_w"].cpu())
    grid = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = tmb.batched_plan(b, H, I, nq, nkv, head["whead"].qweight.shape[-1], w3, grid)
    kinds = {id(wc[0]): "qkv", id(wc[1]): "o", id(wc[2]): "gateup", id(wc[3]): "down",
             id(head["whead"]): "head"}
    qdot, rms = _sched(plan, kinds, grid)
    monkeypatch.setattr(tmb, "qdot_layer", qdot)
    monkeypatch.setattr(tmb, "rms_rows", rms)
    emu = tmb.w4a16_llama_token_step_batched_plain(
        h.cpu(), *wc, ln1.cpu(), ln2.cpu(), cos.cpu(), sin.cpu(), cache.cpu(), lens.cpu(),
        nq, nkv, **head)
    _rows_close(got[0], emu[0], CARD_TOL, "h")
    _rows_close(got[3], emu[3], CARD_TOL, "logits")
    for i, name in ((1, "k"), (2, "v")):     # [L, B, nkv, hd]: each (layer, row)
        _rows_close(got[i].flatten(0, 1), emu[i].flatten(0, 1), CARD_TOL, name)
