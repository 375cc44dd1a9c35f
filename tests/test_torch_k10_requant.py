"""K10's requantizing stage (``csrc/w8a8.cu::w4a8_wgmma_kernel``),
emulated in torch on the CPU.

Per 128-channel stage and 128-column tile the kernel's requant warpgroup
builds, for each column and group, a 16-entry table of int8 codes (JAX's
requant chain once per code value: ``clip(rint(((128 + q) - (128 +
sz/s)) * (s * (1/scol))), -127, 127)``), looks each word's eight codes up
with PTX ``prmt`` byte selects and writes them into the 128-byte-swizzled
K-major B tile that wgmma reads, channel ``8s + r`` of a 64-channel block
at byte ``8r + s``; the x codes come in the same order
(``quant_per_token(perm=True)``). These tests run that index and byte math
(``prmt``, the select, the swizzle) in torch, read the tile back through
the swizzle's inverse and hold it to ``requant_w8`` with ``atol=0``, and
hold the product over the emulated tiles to JAX's Pallas row 7
(``w4a8_matmul_stacked_tiled_folded``) in interpret mode bit for bit. The
kernel itself is held to its plain version on the card
(``tests/test_torch_w8_prefill.py``).
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.ops import w4a16 as tw
from awq_tpu_torch.ops import w8a8 as tq8

# One intra-op thread: the CPU tensors here are small, and the test workers
# share the cores.
torch.set_num_threads(1)

KS = BN = 128          # channels of a stage, columns of a tile
M32 = 0xFFFFFFFF


def swz128(r, b):
    """Byte ``b`` of row ``r`` of a 128-byte-swizzled tile (``hop::swz128``)."""
    return r * 128 + (((b >> 4) ^ r) & 7) * 16 + (b & 15)


def prmt(a, b, sel):
    """PTX ``prmt.b32`` (default mode) over int64 tensors holding u32: byte i
    of the result is byte ``sel[4i+2:4i]`` of ``{b, a}``, its sign
    replicated when ``sel[4i+3]`` is set."""
    src = (b << 32) | a
    out = torch.zeros_like(a)
    for i in range(4):
        nib = (sel >> (4 * i)) & 0xF
        byte = (src >> (8 * (nib & 7))) & 0xFF
        rep = torch.where((byte & 0x80) != 0, 0xFF, 0)
        out |= torch.where((nib & 8) != 0, rep, byte) << (8 * i)
    return out


def lookup8(w, L):
    """``csrc/w8a8.cu::lookup8``: the eight codes of word ``w`` through the
    table words ``L`` -> (lo, hi), nibble s's code in byte s % 4."""
    wm = w & 0x77777777
    wh = wm >> 16

    def sel(hi, lo, mask):     # lop3 0xE4: (hi & mask) | (lo & ~mask)
        return (hi & mask) | (lo & (~mask & M32))

    zero, ones = torch.zeros_like(w), torch.full_like(w, M32)
    lo = sel(prmt(L[2], L[3], wm), prmt(L[0], L[1], wm), prmt(zero, ones, w >> 1))
    hi = sel(prmt(L[2], L[3], wh), prmt(L[0], L[1], wh), prmt(zero, ones, w >> 17))
    return lo, hi


def tables(s_raw, sz_raw, inv, live):
    """``requant_table`` per column: four int64 words of the 16 codes."""
    s, sz = s_raw.to(torch.bfloat16).float(), sz_raw.to(torch.bfloat16).float()
    zz = torch.where(live, sz / s + 128.0, torch.full_like(s, 128.0))
    f = torch.where(live, s * inv, torch.zeros_like(s))
    v = torch.arange(16, dtype=torch.float32)[:, None] + 128.0
    q = torch.clamp(torch.round((v - zz) * f), -127, 127).to(torch.int64) & 0xFF   # [16, n]
    return [q[4 * i] | q[4 * i + 1] << 8 | q[4 * i + 2] << 16 | q[4 * i + 3] << 24
            for i in range(4)]


def stage_tile(qw, scales, szeros, g, k0, n0):
    """The swizzled B tile (16384 bytes) of stage ``k0``, columns ``n0``: the
    producer's loads read zeros past IC and OC, as TMA does."""
    ic, oc = qw.shape[0] * 8, qw.shape[1]
    n_g = ic // g
    cols = n0 + torch.arange(BN)
    live = cols < oc
    c = cols.clamp(max=oc - 1)
    scl = torch.where(live, scales[:, c], torch.zeros(()))      # [n_g, BN]
    szr = torch.where(live, szeros[:, c], torch.zeros(()))
    smax = torch.clamp_min(scl.to(torch.bfloat16).float().amax(0), 0.0)
    inv = torch.ones(BN) / torch.clamp_min(smax * np.float32(15 / 127), 1e-12)
    words = qw.to(torch.int64) & M32
    tile = torch.zeros(KS * BN, dtype=torch.int64)
    n = torch.arange(BN)
    for half in range(2):
        gg = (k0 + 64 * half) // g
        s_row = scl[gg] if gg < n_g else torch.zeros(BN)
        z_row = szr[gg] if gg < n_g else torch.zeros(BN)
        L = tables(s_row, z_row, inv, live & (gg < n_g))
        for j in range(4):
            chunk = []
            for r in (2 * j, 2 * j + 1):
                row = k0 // 8 + 8 * half + r
                w = (torch.where(live, words[row, c], torch.zeros((), dtype=torch.int64))
                     if row < ic // 8 else torch.zeros(BN, dtype=torch.int64))
                chunk += list(lookup8(w, L))
            for e, word in enumerate(chunk):    # 16 bytes at chunk 4 * half + j of row n
                for byte in range(4):
                    tile[swz128(n, 16 * (4 * half + j) + 4 * e + byte)] = (word >> (8 * byte)) & 0xFF
    return tile


def read_back(tile):
    """The tile through the swizzle's inverse, in natural channel order:
    ``[BN, KS]`` int8."""
    n = torch.arange(BN)[:, None]
    b = torch.arange(KS)[None, :]
    perm = tile[swz128(n, b)].to(torch.uint8).view(torch.int8)
    return tq8.permute64(perm)


def _codes(rng, ic, oc, g):
    qw = rng.integers(-(2**31), 2**31 - 1, (ic // 8, oc), dtype=np.int64).astype(np.int32)
    s = (rng.uniform(0.5, 1.5, (ic // g, oc)) * 0.005).astype(np.float32)
    sz = s * rng.uniform(7.0, 8.0, (ic // g, oc)).astype(np.float32)
    return torch.from_numpy(qw), torch.from_numpy(s), torch.from_numpy(sz)


def test_swizzle_is_a_bijection_on_a_tile():
    r = torch.arange(128)[:, None]
    b = torch.arange(128)[None, :]
    addr = swz128(r, b).flatten()
    assert torch.equal(addr.sort().values, torch.arange(128 * 128))
    # each 8-row atom stays in its own 1024 bytes, each row in its own 128
    assert torch.equal(addr.view(128, 128) // 128, r.expand(128, 128))
    # the K10 byte permutation is its own inverse
    x = torch.arange(2 * 128, dtype=torch.int64).view(2, 128).to(torch.int8)
    assert torch.equal(tq8.permute64(tq8.permute64(x)), x)


# G 64 and 128; OC no multiple of 128; IC = 64 mod 128 (a last half stage)
@pytest.mark.parametrize("ic,oc,g", [(1024, 384, 128), (1024, 320, 128), (1088, 320, 64),
                                     (1088, 200, 64), (512, 136, 64)])
def test_stage_requant_matches_requant_w8(ic, oc, g):
    rng = np.random.default_rng(ic + oc + g)
    qw, s, sz = _codes(rng, ic, oc, g)
    w8, _ = tw.requant_w8(qw, s, sz, g)
    for k0 in range(0, ic, KS):
        kn = min(KS, ic - k0)
        for n0 in range(0, oc, BN):
            got = read_back(stage_tile(qw, s, sz, g, k0, n0))
            on = min(BN, oc - n0)
            assert torch.equal(got[:on, :kn], w8[n0:n0 + on, k0:k0 + kn]), (k0, n0)
            assert not got[on:].any()           # columns past OC requantize to 0


def _jax_linear(ic, oc, seed=11):
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.w4a16 import quantize_linear, tile_qlinear

    qls = [quantize_linear(jax.random.normal(k, (ic, oc), jnp.float32) * 0.05)
           for k in jax.random.split(jax.random.PRNGKey(seed), 2)]
    ql = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qls)
    return tile_qlinear(ql, block_n=256, fold_scales=True)


def emulate_k10(x, qw, s, sz, g, splits=1):
    """K10's product over the emulated tiles, the x codes in its channel
    order, int32 partials per split summed, then the epilogue."""
    m, ic = x.shape
    oc = qw.shape[1]
    xq, sx = tq8.quant_per_token(x, perm=True)
    _, scol = tw.requant_w8(qw, s, sz, g)
    n_st = -(-ic // KS)
    acc = torch.zeros((m, oc), dtype=torch.int64)
    for z in range(splits):
        part = torch.zeros((m, oc), dtype=torch.int64)
        for st in range(z * n_st // splits, (z + 1) * n_st // splits):
            k0 = st * KS
            kn = min(KS, ic - k0)
            for n0 in range(0, oc, BN):
                n = torch.arange(BN)[:, None]
                b = torch.arange(KS)[None, :]
                tile = stage_tile(qw, s, sz, g, k0, n0)[swz128(n, b)]
                tile = tile.to(torch.uint8).view(torch.int8).to(torch.int64)  # permuted order
                on = min(BN, oc - n0)
                part[:, n0:n0 + on] += xq[:, k0:k0 + kn].to(torch.int64) @ tile[:on, :kn].t()
        assert part.abs().max() < 2**31
        acc += part
    return ((acc.to(torch.int32).float() * scol) * sx).to(x.dtype)


@pytest.mark.parametrize("m,dtype,splits", [(40, "bfloat16", 1), (40, "float32", 2),
                                            (17, "bfloat16", 2)])
def test_emulated_product_matches_pallas_row_7(m, dtype, splits):
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from awq_tpu.ops import w4a16 as jw

    folded = _jax_linear(256, 512)
    tq = params_from_jax(jax.device_get({"x": folded}), device="cpu")["x"]
    x = torch.from_numpy(np.random.default_rng(m).standard_normal((m, 256))
                         .astype(np.float32) * 0.3).to(getattr(torch, dtype))
    a = x.float().numpy()
    jx = jnp.asarray(a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a)
    for layer in range(2):
        args = (tq.qweight[layer], tq.scales[layer], tq.szeros[layer], 128)
        got = emulate_k10(x, *args, splits=splits)
        ref = jw.w4a8_matmul_stacked_tiled_folded(jx, folded.qweight, jnp.int32(layer), 128, 256)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=0, atol=0)
        assert torch.equal(got, tw.w4a8_matmul_plain(x, *args))


@pytest.mark.parametrize("ic,oc,g", [(1088, 320, 64), (1024, 200, 128)])
def test_emulated_product_matches_plain(ic, oc, g):
    rng = np.random.default_rng(ic + g)
    qw, s, sz = _codes(rng, ic, oc, g)
    x = torch.from_numpy(rng.standard_normal((9, ic)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(emulate_k10(x, qw, s, sz, g, splits=3),
                       tw.w4a8_matmul_plain(x, qw, s, sz, g))
