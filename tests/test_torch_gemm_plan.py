"""The host-side plan of the wgmma GEMMs: K1's GEMM entry (W4 and W3), K10
and K11 (``ops/w4a16.py::gemm_plan``).

The plan picks the orientation and token tile by M and cuts IC into split
ranges on ring-stage edges, so that short prompts still put a block on
every SM. The kernels sum each range into a partial, and a second launch
adds the partials in split order (f32 for K1, int32 for K11). These tests
hold the plan's arithmetic on the CPU, and emulate the split partials in
torch to show that summing them in the plan's order gives K1's plain
version within its tolerance and K11's bit for bit. The kernels
themselves are held to their plain versions on the card
(``tests/test_torch_w4a16.py``, ``test_torch_w8_prefill.py``).
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.ops import w4a16 as tw
from awq_tpu_torch.ops.w8a8 import quant_per_token_plain

# One intra-op thread: the CPU tensors here are small, and the test workers
# share the cores.
torch.set_num_threads(1)

N_SM = 132     # the H100's SMs
KINDS = ("w4a16", "w3a16", "w8a8")
# Llama-3-8B's projections and head (the smoke script's phase-2 shapes)
SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgateup": (4096, 28672),
          "down": (14336, 4096), "head": (4096, 128256)}


@pytest.mark.parametrize("kind", KINDS + ("w4a8",))
@pytest.mark.parametrize("m", [9, 16, 32, 33, 64, 65, 200, 1000])
@pytest.mark.parametrize("ic,oc", [(4096, 6144), (14336, 4096), (1024, 202), (4608, 4544),
                                   (512, 256)])
def test_splits_cover_ic_on_stage_edges(kind, m, ic, oc):
    if kind == "w3a16" and ic % 256:
        pytest.skip("pack_int3 needs IC % 256 == 0")
    plan = tw.gemm_plan(m, ic, oc, kind, N_SM)
    edges = plan.edges(ic)
    assert plan.stage_k == {"w4a16": 64, "w3a16": 256, "w8a8": 128, "w4a8": 128}[kind]
    assert 1 <= plan.splits <= plan.n_stages
    assert plan.n_stages * plan.stage_k >= ic > (plan.n_stages - 1) * plan.stage_k
    assert edges[0] == 0 and edges[-1] == ic and len(edges) == plan.splits + 1
    assert all(a < b for a, b in zip(edges, edges[1:])), edges
    assert all(e % plan.stage_k == 0 for e in edges[:-1]), edges
    # the kernel's ranges: split z takes stages [z*n//splits, (z+1)*n//splits)
    n = plan.n_stages
    assert edges[:-1] == [z * n // plan.splits * plan.stage_k for z in range(plan.splits)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", [9, 16, 32, 40, 64])
@pytest.mark.parametrize("name", list(SHAPES))
def test_blocks_fill_the_sms_at_short_prompts(kind, m, name):
    ic, oc = SHAPES[name]
    plan = tw.gemm_plan(m, ic, oc, kind, N_SM)
    assert plan.blocks >= N_SM, plan
    # the splits fill one wave of the kernel's blocks and no more
    assert plan.splits == 1 or plan.blocks <= N_SM * plan.blocks_per_sm, plan


# K1 keeps its dequantized weights in registers as wgmma's A operand at
# every M, the tokens its N: 16, 32, 64, then 128 tokens a block. K11 takes
# the tokens as N up to 64 rows, then blocks of 128 x 128.
@pytest.mark.parametrize("m,tile", [(1, 16), (9, 16), (16, 16), (17, 32), (32, 32), (33, 64),
                                    (64, 64), (65, 128), (128, 128), (129, 128), (200, 128),
                                    (1000, 128)])
@pytest.mark.parametrize("kind", KINDS)
def test_token_tile_and_orientation_by_rows(m, tile, kind):
    plan = tw.gemm_plan(m, 4096, 4096, kind, N_SM)
    assert plan.tile_m == tile, plan
    assert plan.swap == (kind != "w8a8" or m <= 64), plan
    assert plan.tiles == 32 * -(-m // tile)
    assert plan.blocks_per_sm == (2 if tile <= 64 else 1)


# K10 takes 128 tokens x 128 columns at every M: one requantized stage
# feeds all 128 tokens of its block, and the weights are never the 64-row
# operand (wgmma's s8 form reads both operands from shared memory).
@pytest.mark.parametrize("m", [1, 40, 64, 65, 512, 1000])
@pytest.mark.parametrize("name", list(SHAPES))
def test_w4a8_tiles_are_128_by_128(m, name):
    ic, oc = SHAPES[name]
    plan = tw.gemm_plan(m, ic, oc, "w4a8", N_SM)
    assert plan.tile_m == 128 and not plan.swap and plan.blocks_per_sm == 1, plan
    assert plan.tiles == -(-oc // 128) * -(-m // 128)


# Split-K only where the tiles are fewer than the SMs, and then no more
# splits than one wave of blocks holds (K10 fits one block an SM).
@pytest.mark.parametrize("m", [1, 40, 512, 1000])
@pytest.mark.parametrize("name", list(SHAPES))
def test_w4a8_splits_only_below_a_wave(m, name):
    ic, oc = SHAPES[name]
    plan = tw.gemm_plan(m, ic, oc, "w4a8", N_SM)
    if plan.tiles >= N_SM:
        assert plan.splits == 1, plan
    else:
        assert plan.splits == max(1, min(N_SM // plan.tiles, plan.n_stages)), plan
        assert plan.blocks <= N_SM, plan


def test_long_prompts_do_not_split():
    for kind in KINDS + ("w4a8",):
        for name in ("wgateup", "down", "head"):
            assert tw.gemm_plan(1000, *SHAPES[name], kind, N_SM).splits == 1, (kind, name)


def _codes(rng, ic, oc, g, dense3):
    rows = ic * 3 // 32 if dense3 else ic // 8
    qw = rng.integers(-(2**31), 2**31 - 1, (rows, oc), dtype=np.int64).astype(np.int32)
    s = (rng.uniform(0.5, 1.5, (ic // g, oc)) * 0.005).astype(np.float32)
    return (torch.from_numpy(qw), torch.from_numpy(s),
            torch.from_numpy(s * (4 if dense3 else 8)))


# K1: each split's partial is its channels' product of x and the weights
# rounded to the tile type (bf16 for f32 and bf16 x, f16 for f16 x), in
# f32; the partials are summed in split order, rounded once to x's dtype,
# and the bias added in it. Tolerance 2^-6 of the output's largest
# magnitude, the kernel's own: both round the output to x's dtype (2^-9
# relative for bf16) and sum ~IC products in other orders.
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("m,ic,oc,g,dense3,bias", [
    (24, 1024, 256, 128, False, True), (9, 2048, 136, 64, False, False),
    (40, 1536, 320, 96, False, True), (64, 1024, 200, 1024, False, False),
    (20, 1024, 256, 128, True, True), (33, 2048, 384, 64, True, False),
    (80, 1536, 320, 32, False, True)])
def test_split_partials_emulated_match_plain(dtype, m, ic, oc, g, dense3, bias):
    rng = np.random.default_rng(m + ic + oc)
    qw, s, sz = _codes(rng, ic, oc, g, dense3)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((m, ic)).astype(np.float32)).to(dt)
    b = torch.from_numpy(rng.standard_normal(oc).astype(np.float32)).to(dt) if bias else None
    # few SMs for few tiles: the small shapes split as the real ones do
    plan = tw.gemm_plan(m, ic, oc, "w3a16" if dense3 else "w4a16", n_sm=4 * -(-oc // 128))
    assert plan.splits > 1
    tile = torch.float16 if dt == torch.float16 else torch.bfloat16
    w = tw.dequantize(qw, s, sz, g, tile, dense3).float()
    xt = x.to(tile).float()
    edges = plan.edges(ic)
    acc = torch.zeros((m, oc), dtype=torch.float32)
    for a, e in zip(edges, edges[1:]):
        acc = acc + xt[:, a:e] @ w[a:e]
    got = acc.to(dt)
    if b is not None:
        got = got + b
    ref = tw.w4a16_matmul_plain(x, qw, s, sz, g, b, dense3=dense3)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -6 * ref.float().abs().max().item(), err


# K11: int32 partials are exact, so their sum in any order, then the
# epilogue (f32(acc) * scol) * sx in its order, equals the plain version
# bit for bit.
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("m,ic,oc", [(1, 1024, 256), (17, 2048, 320), (33, 1088, 200),
                                     (64, 4096, 384), (100, 1024, 136)])
def test_int32_split_partials_bit_equal_plain(dtype, m, ic, oc):
    rng = np.random.default_rng(m + ic)
    qw, s, sz = _codes(rng, ic, oc, 64, False)
    w8, scol = tw.requant_w8(qw, s, sz, 64)
    x = torch.from_numpy(rng.standard_normal((m, ic)).astype(np.float32)).to(getattr(torch, dtype))
    plan = tw.gemm_plan(m, ic, oc, "w8a8", n_sm=4 * -(-oc // 128) * (1 if m <= 64 else 2))
    assert plan.splits > 1
    xq, sx = quant_per_token_plain(x)
    edges = plan.edges(ic)
    parts = [xq[:, a:e].long() @ w8[:, a:e].long().t() for a, e in zip(edges, edges[1:])]
    acc = torch.stack(parts).sum(0)
    assert acc.abs().max() < 2**31
    got = ((acc.to(torch.int32).float() * scol) * sx).to(x.dtype)
    assert torch.equal(got, tw.w8a8_matmul_plain(x, w8, scol))
