"""Port parity: int4 packing and group-wise quantization, bit for bit.

Inputs come from a seeded numpy RNG and go through both the JAX package
and the PyTorch port. Integer results (codes, packed words) and the f32
scales/zeros must be identical: no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awq_tpu.quant import core as jcore
from awq_tpu.quant import packing as jpack
from awq_tpu_torch.quant import core as tcore
from awq_tpu_torch.quant import packing as tpack

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


def _codes(ic, oc, seed):
    return np.random.default_rng(seed).integers(0, 16, (ic, oc), dtype=np.uint8)


@pytest.mark.parametrize("ic,oc", [(64, 128), (256, 40), (512, 200)])
def test_pack_int4_bit_exact(ic, oc):
    q = _codes(ic, oc, ic + oc)
    ref = np.array(jpack.pack_int4(jnp.asarray(q)))
    got = tpack.pack_int4(torch.from_numpy(q))
    assert got.dtype == torch.int32 and tuple(got.shape) == (ic // 8, oc)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tpack.unpack_int4(got).numpy(), q)
    np.testing.assert_array_equal(
        tpack.unpack_int4(torch.from_numpy(ref)).numpy(),
        np.asarray(jpack.unpack_int4(jnp.asarray(ref))))


def test_pack_int4_nibble_order():
    """Code of ic = 64c + 8s + r sits in word 8c + r, nibble s."""
    q = _codes(128, 8, 1)
    p = tpack.pack_int4(torch.from_numpy(q)).numpy().view(np.uint32)
    for ic in (0, 7, 8, 63, 64, 100, 127):
        c, rem = divmod(ic, 64)
        s, r = divmod(rem, 8)
        np.testing.assert_array_equal((p[8 * c + r] >> (4 * s)) & 0xF, q[ic])


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("n_bit,group", [(4, 128), (4, -1), (4, 64), (3, 128)])
def test_quantize_groupwise_bit_exact(n_bit, group):
    w = np.random.default_rng(7).standard_normal((512, 96)).astype(np.float32)
    jq, js, jz = jcore.quantize_groupwise(jnp.asarray(w), n_bit, group)
    tq, ts, tz = tcore.quantize_groupwise(torch.from_numpy(w), n_bit, group)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    np.testing.assert_array_equal(_bits(tz.numpy()), _bits(jz))
    np.testing.assert_array_equal(
        _bits(tcore.dequantize_groupwise(tq, ts, tz).numpy()),
        _bits(jcore.dequantize_groupwise(jq, js, jz)))


def test_quantize_clip_tie_bit_exact():
    """Clipping puts weights exactly on max_val, i.e. on a rounding tie of
    w / scales; a scales value one ulp off (``* (1/15)`` instead of
    ``/ 15``) flips those codes. Both packages must agree on every one."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    clip = (np.abs(w.reshape(2, 128, 64)).max(1) * 0.6).astype(np.float32)
    jq, js, jz = jcore.quantize_groupwise(jnp.asarray(w), 4, 128,
                                          clip_max=jnp.asarray(clip))
    tq, ts, tz = tcore.quantize_groupwise(torch.from_numpy(w), 4, 128,
                                          clip_max=torch.from_numpy(clip))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    np.testing.assert_array_equal(_bits(tz.numpy()), _bits(jz))
    # the case is a real tie case: the multiply-by-reciprocal scales differ
    # from the divided ones somewhere
    wg = np.clip(w.reshape(2, 128, 64), -clip[:, None], clip[:, None])
    span = np.maximum(wg.max(1) - wg.min(1), np.float32(1e-5))
    assert (span / np.float32(15) != span * np.float32(1 / 15)).any()


def test_pseudo_quantize_matches():
    w = np.random.default_rng(11).standard_normal((256, 32)).astype(np.float32)
    ref = np.asarray(jcore.pseudo_quantize(jnp.asarray(w), 4, 128))
    got = tcore.pseudo_quantize(torch.from_numpy(w), 4, 128).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
