"""``params_from_jax`` on every layout of the JAX package's ``QLinear``:
plain, tiled (block-contiguous), tiled and folded (bf16-bitpack nibbles and
packed qparam rows), folded with the f32 fields stripped, and the
stacked-of-1 tiled head. The codes must equal ``pack_int4`` of the
original codes bit for bit, and the scales the originals (plain, tiled)
or their bf16 rounding (folded: what the folded kernels compute with).
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.quant.packing import pack_int4, unpack_int4

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


def _stacked(L=2, ic=256, oc=384, seed=0):
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.w4a16 import quantize_linear

    qls = [quantize_linear(jax.random.normal(k, (ic, oc), jnp.float32) * 0.05)
           for k in jax.random.split(jax.random.PRNGKey(seed), L)]
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qls)


def _bf16(a):
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("layout", ["plain", "tiled", "folded", "stripped"])
def test_layouts_unfold_bit_exact(layout):
    import jax
    from awq_tpu.ops.w4a16 import strip_unfolded_qparams, tile_qlinear

    ql = _stacked()
    src = ql
    if layout != "plain":
        src = tile_qlinear(ql, block_n=128, fold_scales=layout != "tiled")
    if layout == "stripped":
        src = strip_unfolded_qparams({"x": src})["x"]
        assert np.asarray(src.scales).size == 1
    got = params_from_jax(jax.device_get({"x": src}), device="cpu")["x"]
    # the original codes, repacked by the port's pack_int4
    for l in range(2):
        codes = unpack_int4(torch.from_numpy(np.array(ql.qweight[l])))
        np.testing.assert_array_equal(got.qweight[l].numpy(), pack_int4(codes).numpy())
    folded = layout in ("folded", "stripped")
    want_s = _bf16(ql.scales) if folded else np.asarray(ql.scales)
    want_z = _bf16(ql.szeros) if folded else np.asarray(ql.szeros)
    np.testing.assert_array_equal(got.scales.numpy(), want_s)
    np.testing.assert_array_equal(got.szeros.numpy(), want_z)
    assert got.qweight.dtype == torch.int32 and got.scales.dtype == torch.float32


def test_tiled_head_comes_back_2d_and_dense3_raises():
    import dataclasses

    import jax
    from awq_tpu.ops.w4a16 import tile_qlinear

    head = tile_qlinear(_stacked(L=1, oc=512, seed=3), block_n=128, fold_scales=True)
    got = params_from_jax(jax.device_get({"lm_head": head}), device="cpu")["lm_head"]
    assert got.qweight.dim() == 2 and tuple(got.scales.shape) == (2, 512)
    ql = _stacked()
    # dense3 is the 3-bit layout (tests/test_torch_w3.py converts it); a
    # QLinear that claims it for 4-bit codes is refused
    with pytest.raises(ValueError, match="dense3=True"):
        params_from_jax(jax.device_get({"x": dataclasses.replace(
            ql, w_bit=4, dense3=True)}), device="cpu")
