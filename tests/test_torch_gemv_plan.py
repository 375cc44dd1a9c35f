"""The host plan of K1's GEMV entry (``ops/w4a16.py::gemv_plan``) and a
torch emulation of the kernel's arithmetic.

The GEMV gives a block 128 output columns and a range of IC on packing-
chunk edges; where the column tiles alone leave SMs idle, the IC ranges of
a tile form a thread-block cluster that adds its ranks' sums in rank
order. A k-step of the tensor-core body is 16 contiguous input channels:
thread ``tq`` builds the A pairs of channels ``16j + 2tq + e`` and ``16j +
8 + 2tq + e`` from byte ``j`` of code words ``2tq + e`` (W3: of the lo
and hi words moved to the sub-step's fields). The emulation below reads
the packed words the same way (not through ``unpack_int4``/``unpack_int3``),
keeps JAX's per-group identity with the codes biased by 2^7 as the JAX
kernels bias them (f32 group sums folded at every group edge and at a
split's end), and adds the splits in rank order. It is held
to the plain version and to the JAX package's interpret-mode
``w4a16_matmul_stacked`` and ``w3a16_matmul_stacked``. The kernel itself is
held to the plain version on the card (``tests/test_torch_w4a16.py``,
``test_torch_dtypes.py``, ``test_torch_w3.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from awq_tpu_torch.ops import w4a16 as tw

# One intra-op thread: the CPU tensors here are small, and the test workers
# share the cores.
torch.set_num_threads(1)

N_SM = 132     # the H100's SMs
SMEM_MAX = 227 * 1024
LLAMA = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgateup": (4096, 28672),
         "down": (14336, 4096), "head": (4096, 128256)}
FALCON = {"wqkv": (4544, 4672), "wo": (4544, 4544), "up": (4544, 18176),
          "down": (18176, 4544), "head": (4544, 65024)}


def _shapes():
    out = [(k, ic, oc, 128) for k in ("w4a16", "w3a16") for ic, oc in LLAMA.values()]
    out += [("w4a16", ic, oc, 64) for ic, oc in FALCON.values()]
    out += [(k, 1536, oc, g) for k in ("w4a16", "w3a16") for oc in (202, 320)
            for g in (64, 96, 128, 1536)]
    out += [("w4a16", 512, 202, 8), ("w4a16", 512, 256, 24), ("w4a16", 64, 8, 64)]
    return out


@pytest.mark.parametrize("kind,ic,oc,g", _shapes())
@pytest.mark.parametrize("m", [1, 3, 8])
def test_plan_covers_ic_and_columns_once(kind, ic, oc, g, m):
    plan = tw.gemv_plan(m, ic, oc, g, kind, N_SM)
    assert plan.stage_k == {"w4a16": 64, "w3a16": 256}[kind]
    assert plan.n_stages * plan.stage_k == ic
    # columns: tiles of 128 cover [0, OC) once, the last one masked
    assert plan.tile_n == 128 and (plan.tiles - 1) * 128 < oc <= plan.tiles * 128
    # IC: the splits' stage ranges are contiguous, non-empty, in order
    ranges = plan.ranges()
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and sum(n for _, n in ranges) == plan.n_stages
    assert all(a + n == b for (a, n), (b, _) in zip(ranges, ranges[1:]))
    assert all(n >= 1 for _, n in ranges)
    edges = plan.edges(ic)
    assert edges == [a * plan.stage_k for a, _ in ranges] + [ic]
    # every (channel, column) is summed by exactly one block
    seen = np.zeros((plan.n_stages, plan.tiles), dtype=np.int64)
    for a, n in ranges:
        seen[a:a + n] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("kind,ic,oc,g", _shapes())
@pytest.mark.parametrize("m", [1, 8])
def test_plan_fits_a_cluster_and_shared_memory(kind, ic, oc, g, m):
    plan = tw.gemv_plan(m, ic, oc, g, kind, N_SM)
    assert 1 <= plan.cluster == plan.splits <= tw.GEMV_MAX_CLUSTER <= 8
    assert 2 <= plan.stages <= tw.GEMV_MAX_STAGES
    # the scale rows of a stage cover every group it spans
    k = plan.stage_k
    assert plan.ns == max((k0 + k - 1) // g - k0 // g + 1 for k0 in range(0, ic, k))
    # x over the longest range, its group sums, the ring and its barriers
    longest = max(n for _, n in plan.ranges())
    assert plan.smem == tw.gemv_smem(plan.tc, m, longest * k, g, plan.stages, plan.stage_bytes)
    assert plan.stages * plan.stage_bytes < plan.smem <= SMEM_MAX
    assert plan.tc == (g % 16 == 0)
    # a short range is in flight whole (the ring holds it and one more slot);
    # else as deep as fits beside x in half an SM (or the whole SM)
    full = min(tw.GEMV_MAX_STAGES, longest + 1)
    assert plan.stages == full or tw.gemv_smem(plan.tc, m, longest * k, g, plan.stages + 1,
                                               plan.stage_bytes) > 113 * 1024


@pytest.mark.parametrize("name", list(LLAMA))
def test_plan_puts_two_blocks_on_every_sm(name):
    ic, oc = LLAMA[name]
    for kind in ("w4a16", "w3a16"):
        plan = tw.gemv_plan(1, ic, oc, 128, kind, N_SM)
        assert plan.blocks >= 2 * N_SM or plan.splits in (tw.GEMV_MAX_CLUSTER, plan.n_stages)
        # at 8 rows x stays within 16 KB a block where 8 splits allow it
        p8 = tw.gemv_plan(8, ic, oc, 128, kind, N_SM)
        longest = max(n for _, n in p8.ranges())
        assert 8 * longest * p8.stage_k * 2 <= 16 * 1024 or p8.splits == 8
        # the ring keeps ~25 KB or more in flight an SM at two blocks an SM
        assert 2 * (plan.stages - 1) * plan.stage_bytes >= 25 * 1024


# ---- a torch emulation of the tensor-core body -----------------------------------

def _codes_w4(qw: np.ndarray, c: int, j: int) -> np.ndarray:
    """The codes of k-step j of 64-channel chunk c as the kernel builds them:
    [16, OC], row k = channel 16j + k. Words 2tq + e (tq < 4, e < 2) of the
    chunk, byte j of each: the low nibble is channel 16j + 2tq + e, the
    high one 16j + 8 + 2tq + e."""
    words = qw[8 * c:8 * c + 8].astype(np.int64) & 0xFFFFFFFF      # [8, OC]
    byte = (words >> (8 * j)) & 0xFF
    out = np.zeros((16, qw.shape[1]), dtype=np.float32)
    for tq in range(4):
        for e in range(2):
            r = 2 * tq + e
            out[2 * tq + e] = byte[r] & 0xF
            out[8 + 2 * tq + e] = byte[r] >> 4
    return out


def _codes_w3(qw: np.ndarray, c: int, q: int, j: int) -> np.ndarray:
    """The same for k-step j of 64-channel sub-step q of 256-channel chunk
    c of pack_int3: lo words 24c + 8(q >> 1) + r moved right by 16(q & 1),
    hi words 24c + 16 + r moved right by 8q; unit u = 2j (+1) is 2-bit field
    u of the moved lo word and bit u of the moved hi word."""
    lo = (qw[24 * c + 8 * (q >> 1):24 * c + 8 * (q >> 1) + 8].astype(np.int64) & 0xFFFFFFFF)
    hi = (qw[24 * c + 16:24 * c + 24].astype(np.int64) & 0xFFFFFFFF)
    lo, hi = lo >> (16 * (q & 1)), hi >> (8 * q)
    out = np.zeros((16, qw.shape[1]), dtype=np.float32)
    for tq in range(4):
        for e in range(2):
            r = 2 * tq + e
            for h in range(2):
                u = 2 * j + h
                out[8 * h + 2 * tq + e] = ((lo[r] >> (2 * u)) & 3) | (((hi[r] >> u) & 1) << 2)
    return out


def _emulate(x, qw, s, sz, g, plan, dense3, c=128.0):
    """The GEMV's arithmetic in torch f32: per split, k-steps of 16
    channels of x against the codes biased by c (2^7, bf16's), each group's
    sums folded at its edge as s·Σ x·(c + q) − (c·s + sz)·Σ x (f32), the
    splits of a column tile added in rank order."""
    m, ic = x.shape
    xt = torch.from_numpy(x)
    st, zt = torch.from_numpy(s), torch.from_numpy(sz)
    pieces = []
    for a, n in plan.ranges():
        acc = torch.zeros((m, qw.shape[1]), dtype=torch.float32)
        d = torch.zeros_like(acc)
        dx = torch.zeros((m, 1), dtype=torch.float32)
        k0 = a * plan.stage_k
        gcur = k0 // g
        for k in range(k0, (a + n) * plan.stage_k, 16):
            if dense3:
                q = _codes_w3(qw, k // 256, (k % 256) // 64, (k % 64) // 16)
            else:
                q = _codes_w4(qw, k // 64, (k % 64) // 16)
            xs = xt[:, k:k + 16]
            d += xs @ (torch.from_numpy(q) + c)
            dx += xs.sum(dim=1, keepdim=True)
            if (k + 16) % g == 0 or k + 16 == (a + n) * plan.stage_k:
                acc += d * st[gcur] - dx * (c * st[gcur] + zt[gcur])
                d.zero_()
                dx.zero_()
                gcur = (k + 16) // g
        pieces.append(acc)
    out = pieces[0]
    for p in pieces[1:]:
        out = out + p
    return out


def _inputs(kind, m, ic, oc, g, seed):
    rng = np.random.default_rng(seed)
    rows = ic * 3 // 32 if kind == "w3a16" else ic // 8
    qw = rng.integers(-(2**31), 2**31 - 1, (1, rows, oc), dtype=np.int64).astype(np.int32)
    s = (rng.uniform(0.5, 1.5, (1, ic // g, oc)) * 0.005).astype(np.float32)
    sz = (s * (4 if kind == "w3a16" else 8)).astype(np.float32)
    # x on the bf16 grid, as the tensor cores take it
    x = torch.from_numpy(rng.standard_normal((m, ic)).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy(), qw, s, sz


# Tolerances. Against the JAX kernels (f32 x, the same identity per group in
# another order) or, where they take no such group or column count, JAX's
# XLA version (an f32 dequant, then one matmul): 1e-5 of the output's
# largest magnitude, as the port's other K1 parity tests. Against the plain version, which rounds each
# dequantized weight to x's dtype before one matmul: 2^-6, the card's
# tolerance for bf16 (the plain version here runs on bf16 x).
@pytest.mark.parametrize("kind", ["w4a16", "w3a16"])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("g", [64, 96, 128, -1])
@pytest.mark.parametrize("oc", [202, 256])
def test_emulation_matches_plain_and_jax(kind, m, g, oc):
    import jax.numpy as jnp
    from awq_tpu.ops import w4a16 as jw

    dense3 = kind == "w3a16"
    ic = 768 if g == 96 else 512
    gs = ic if g == -1 else g
    x, qw, s, sz = _inputs(kind, m, ic, oc, gs, seed=m * 1000 + gs + oc)
    plan = tw.gemv_plan(m, ic, oc, gs, kind, n_sm=16)    # splits > 1 at these sizes
    assert plan.splits > 1
    got = _emulate(x, qw[0], s[0], sz[0], gs, plan, dense3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    plain = tw.w4a16_matmul_plain(xb, torch.from_numpy(qw[0]), torch.from_numpy(s[0]),
                                  torch.from_numpy(sz[0]), gs, dense3=dense3).float()
    scale = plain.abs().max().item()
    assert (got - plain).abs().max().item() <= 2 ** -6 * scale
    # the Pallas kernels take whole 128-column tiles and groups of 64 or more
    # whose multiples tile IC in 128s; JAX's XLA version takes any group
    if oc % 128 or g == 96:
        ref = jw.w4a16_matmul_xla(jnp.asarray(x), jnp.asarray(qw[0]), jnp.asarray(s[0]),
                                  jnp.asarray(sz[0]), gs, dense3=dense3)
    else:
        if dense3:
            ref = jw.w3a16_matmul_stacked(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(s),
                                          jnp.asarray(sz), jnp.int32(0), gs, block_n=128)
        else:
            ref = jw.w4a16_matmul_stacked(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(s),
                                          jnp.asarray(sz), jnp.int32(0), gs)
    ref = torch.from_numpy(np.array(ref))
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_emulation_is_deterministic_and_split_independent():
    """The splits add up to the one-split sum (the identity is linear) to f32
    rounding, and the fixed rank order gives the same bits every time."""
    x, qw, s, sz = _inputs("w4a16", 2, 1536, 256, 96, seed=3)
    many = tw.gemv_plan(2, 1536, 256, 96, "w4a16", n_sm=64)
    one = dataclasses.replace(many, splits=1)
    assert many.splits == 8
    a = _emulate(x, qw[0], s[0], sz[0], 96, many, False)
    b = _emulate(x, qw[0], s[0], sz[0], 96, many, False)
    c = _emulate(x, qw[0], s[0], sz[0], 96, one, False)
    assert torch.equal(a, b)
    assert (a - c).abs().max().item() <= 1e-5 * c.abs().max().item()


def test_wrapper_refuses_a_group_it_did_not_take_before():
    """Every group the GEMV took before is still taken (a multiple of 8
    dividing IC); the plan of such a group fits."""
    for g in (8, 24, 40, 64, 96, 128, 1536):
        plan = tw.gemv_plan(8, 1536, 320, g, "w4a16", N_SM)
        assert plan.smem <= SMEM_MAX
