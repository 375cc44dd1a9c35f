"""The per-token int8 quantization (``ops/w8a8.py::quant_per_token``) and
its one-pass kernel (``csrc/w8a8.cu``).

On the CPU: the plain version bit-equal to JAX's ``quant_per_token`` as the
package runs it (inside ``jit``, where XLA multiplies by f32(1/127) for the
source's division by 127) on rows of zeros, on exact .5 ties and at the
widths the prefill gives it (IC 64, 4096, 14336) over f32, bf16 and f16
rows; and a torch emulation of the kernel's ``perm`` store (the 8 x 8 byte
transpose of a 64-channel block across a quad of lanes: ``__byte_perm``
packets, traded by xor shuffles, assembled by ``__byte_perm``) bit-equal to
``permute64``.

On the card (marked ``cuda``): the kernel bit-equal to the plain version at
M = 1, 31, 32, 40, 200 and 1000 rows, with ``perm`` on and off, over f32,
bf16 and f16, and at other widths: IC 200 (element loads), 80 and 208
(16-byte vectors, a warp not all in the row), 64 and 14336, and 16384 and
28672, the last past one chunk a thread (two chunks, Llama-3-70B's
``down``); and rows wider than one pass holds (32768 channels): 36864
(OPT-66B's ``down``), 57344 (BLOOM-176B's) and 36870 (element loads).
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.ops import w8a8 as tq8

# One intra-op thread: the CPU tensors here are small, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rows(m, ic, dtype, device="cpu", seed=0):
    """``m`` rows of ``ic`` normals (x 3) in ``dtype``, row 1 all zeros (the
    1e-5 floor) and, where there are 3 rows and 8 channels, row 2 on exact
    .5 ties: absmax 127 makes its scale exactly 1.0."""
    g = torch.Generator(device=device).manual_seed(seed + m + ic)
    x = (torch.randn((m, ic), generator=g, device=device) * 3).to(dtype)
    if m > 1:
        x[1] = 0.0
    if m > 2 and ic >= 8:
        x[2] = 0.0
        x[2, :8] = torch.tensor([127.0, 2.5, -3.5, 0.5, 1.5, -0.5, -126.5, 125.5])
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("ic", [64, 4096, 14336])
def test_plain_bit_equal_to_jax(dtype, ic):
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.w8a8 import quant_per_token as jq

    x = _rows(5, ic, getattr(torch, dtype))
    q, s = tq8.quant_per_token_plain(x)
    jx = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
    jqx, jsx = jax.jit(jq)(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsx))
    assert s[1].item() == np.float32(1e-5) * np.float32(1 / 127)
    assert s[2].item() == 1.0
    assert q[2, :8].tolist() == [127, 2, -4, 0, 2, 0, -126, 126]


def _byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's ``__byte_perm(x, y, sel)`` on int64 tensors holding u32 words:
    byte ``n`` of the result is byte ``(sel >> 4n) & 7`` of the 8 bytes ``y:x``."""
    src = x | (y << 32)
    out = torch.zeros_like(x)
    for n in range(4):
        pick = (sel >> (4 * n)) & 7
        out |= ((src >> (8 * pick)) & 0xFF) << (8 * n)
    return out


def _perm_store(xq: torch.Tensor) -> torch.Tensor:
    """The kernel's ``perm`` store of int8 codes ``[M, IC]`` (IC % 64 == 0),
    ``perm_quad`` in ``csrc/w8a8.cu``: lane ``j`` of a quad holds channels
    16 j .. 16 j + 15 of a 64-channel block as four words ``w`` (the first
    channel in the low byte), packs for lane ``t`` the bytes of its rows
    2 j, 2 j + 1 at columns 2 t, 2 t + 1, and from the four packets it
    receives (``p[i]`` from lane ``i``) assembles its 16 output bytes."""
    m, ic = xq.shape
    # [M, IC / 64, lane, word, byte]
    w = xq.view(torch.uint8).reshape(m, ic // 64, 4, 4, 4).to(torch.int64)
    w = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)  # [.., lane, word]

    def packet(j, t):
        c = 2 * (t & 1)
        a, b = (w[..., j, 1], w[..., j, 3]) if t & 2 else (w[..., j, 0], w[..., j, 2])
        return _byte_perm(a, b, c | (c + 1) << 4 | (c + 4) << 8 | (c + 5) << 12)

    lanes = []
    for t in range(4):
        p = [packet(i, t) for i in range(4)]
        lanes.append(torch.stack([_byte_perm(p[0], p[1], 0x6420), _byte_perm(p[2], p[3], 0x6420),
                                  _byte_perm(p[0], p[1], 0x7531), _byte_perm(p[2], p[3], 0x7531)],
                                 dim=-1))
    o = torch.stack(lanes, dim=-2)                                  # [M, IC / 64, lane, word]
    out = torch.stack([(o >> (8 * e)) & 0xFF for e in range(4)], dim=-1)
    return out.to(torch.uint8).reshape(m, ic).view(torch.int8)


@pytest.mark.parametrize("ic", [64, 4096])
def test_perm_byte_transpose_equals_permute64(ic):
    """The byte transpose the kernel stores under ``perm`` writes K10's
    channel order, ``permute64``'s, bit for bit (codes over the whole int8
    range, every byte position of a block distinct)."""
    g = torch.Generator().manual_seed(ic)
    xq = torch.randint(-128, 128, (7, ic), generator=g, dtype=torch.int8)
    assert torch.equal(_perm_store(xq), tq8.permute64(xq))
    # and the plain wrapper's perm on the CPU is the same permutation
    x = _rows(7, ic, torch.float32)
    q, _ = tq8.quant_per_token_plain(x)
    assert torch.equal(tq8.quant_per_token(x, perm=True)[0], _perm_store(q))


def test_wrapper_refuses_what_the_kernel_cannot_take():
    """``perm`` on an IC that is no multiple of 64 is refused on the card
    before any launch (below); a CPU tensor never reaches that check: it
    takes the plain version, at any width, also past the 32768 channels of
    the kernel's one pass."""
    x = torch.zeros((2, 100))
    q, s = tq8.quant_per_token(x)                      # the CPU: the plain version
    assert q.shape == (2, 100) and s.shape == (2, 1)
    x = _rows(3, 36864, torch.bfloat16)
    q, s = tq8.quant_per_token(x, perm=True)
    qp, sp = tq8.quant_per_token_plain(x)
    assert torch.equal(q, tq8.permute64(qp)) and torch.equal(s, sp)


# ---- on the card ---------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("perm", [False, True], ids=["natural", "perm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m", [1, 31, 32, 40, 200, 1000])
def test_kernel_bit_equal_to_plain_on_card(cuda, m, dtype, perm):
    x = _rows(m, 4096, dtype, cuda)
    n0 = tq8.LAUNCHES["quant_per_token"]
    q, s = tq8.quant_per_token(x, perm=perm)
    torch.cuda.synchronize()
    assert tq8.LAUNCHES["quant_per_token"] == n0 + 1
    qp, sp = tq8.quant_per_token_plain(x)
    assert torch.equal(s, sp)
    assert torch.equal(q, tq8.permute64(qp) if perm else qp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("ic", [64, 80, 200, 208, 14336, 16384, 28672, 36864, 57344, 36870])
def test_kernel_bit_equal_at_other_widths_on_card(cuda, ic, dtype):
    """IC 200 (no multiple of 16: element loads and byte stores), 80 and 208
    (16-byte vectors, lanes past the row), 64, 14336, 16384 and 28672 (two
    chunks a thread), rows wider than one pass (32768 channels: OPT-66B's
    ``down`` 36864, BLOOM-176B's 57344, and 36870 by element loads) with
    ``perm`` where IC % 64 == 0, and a row that starts off a 16-byte
    boundary (a view one element in: the wrapper copies it)."""
    x = _rows(40, ic, dtype, cuda)
    qp, sp = tq8.quant_per_token_plain(x)
    for perm in (False, True) if ic % 64 == 0 else (False,):
        q, s = tq8.quant_per_token(x, perm=perm)
        torch.cuda.synchronize()
        assert torch.equal(s, sp)
        assert torch.equal(q, tq8.permute64(qp) if perm else qp)
    flat = torch.cat([torch.zeros(1, dtype=dtype, device=cuda), x.reshape(-1)])
    off = flat[1:].view(40, ic)
    q, s = tq8.quant_per_token(off)
    torch.cuda.synchronize()
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.cuda
def test_kernel_refuses_perm_off_64_on_card(cuda):
    before = dict(tq8.LAUNCHES)
    with pytest.raises(ValueError, match="perm"):
        tq8.quant_per_token(torch.zeros((2, 96), device=cuda), perm=True)
    assert tq8.LAUNCHES == before
