"""Port parity: RMSNorm, rope tables (llama3 scaling) and rotary embedding."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awq_tpu.config import ModelConfig as JConfig, RopeScaling as JRope
from awq_tpu.models import layers as jl
from awq_tpu_torch.config import ModelConfig as TConfig, RopeScaling as TRope
from awq_tpu_torch.models import layers as tl

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

GEOM = dict(arch="llama", vocab_size=512, hidden_size=512,
            intermediate_size=1024, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=128, max_position_embeddings=256, dtype="float32",
            rope_theta=500000.0)


def _cfgs(scaled: bool):
    j = JConfig(**GEOM, rope_scaling=JRope() if scaled else None)
    t = TConfig(**GEOM, rope_scaling=TRope() if scaled else None)
    return j, t


def test_config_copy_matches():
    """The port's config module is a field-for-field copy."""
    for name in ("QuantConfig", "RopeScaling", "ModelConfig", "GenConfig",
                 "RuntimeConfig"):
        import awq_tpu.config as jc
        import awq_tpu_torch.config as tc

        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jc, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tc, name))]
        assert jf == tf, name
    hf = {"model_type": "llama", "hidden_size": 4096, "num_attention_heads": 32,
          "num_key_value_heads": 8, "intermediate_size": 14336,
          "num_hidden_layers": 32, "vocab_size": 128256, "rope_theta": 5e5,
          "rope_scaling": {"rope_type": "llama3", "factor": 8.0}}
    from awq_tpu.config import model_config_from_hf as jm
    from awq_tpu_torch.config import model_config_from_hf as tm

    assert dataclasses.asdict(jm(hf)) == dataclasses.asdict(tm(hf))


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 512)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 512).astype(np.float32)
    ref = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    # f32, one mean and one rsqrt per row: a few ulps
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# The tables are f32 cos/sin of angles up to 256 rad; an ulp of the angle
# there is 3e-5, and pow/cos may round differently in XLA and PyTorch.
@pytest.mark.parametrize("scaled", [False, True])
def test_rope_table_matches(scaled):
    jc, tc = _cfgs(scaled)
    jcos, jsin = jl.rope_table(jc, 256)
    tcos, tsin = tl.rope_table(tc, 256)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-4, rtol=0)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches(per_row):
    jc, tc = _cfgs(True)
    cos, sin = jl.rope_table(jc, 64)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 5, 4, 128)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 128)).astype(np.float32)
    pos = (np.stack([np.arange(3, 8), np.arange(10, 15)]) if per_row
           else np.arange(20, 25)).astype(np.int64)
    jq, jk = jl.apply_rope(jnp.asarray(q), jnp.asarray(k), cos, sin,
                           jnp.asarray(pos))
    tcos, tsin = (torch.from_numpy(np.array(a)) for a in (cos, sin))
    tq, tk = tl.apply_rope(torch.from_numpy(q), torch.from_numpy(k), tcos, tsin,
                           torch.from_numpy(pos))
    # same table: elementwise f32 products and sums, to an ulp
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-6)


def test_mlp_swiglu_matches():
    from awq_tpu.models.layers import Linear as JLinear
    from awq_tpu.ops.w4a16 import quantize_linear as jquant
    from awq_tpu_torch.ops.w4a16 import quantize_linear as tquant

    rng = np.random.default_rng(3)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.05
          for s in ((256, 384), (256, 384), (384, 256))]
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    ref = np.asarray(jl.mlp_swiglu(*(JLinear(w=jnp.asarray(w)) for w in ws),
                                   jnp.asarray(x)))
    got = tl.mlp_swiglu(*(tl.Linear(w=torch.from_numpy(w)) for w in ws),
                        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # quantized linears take the W4A16 path (plain version on the CPU)
    ref = np.asarray(jl.mlp_swiglu(*(jquant(jnp.asarray(w)) for w in ws),
                                   jnp.asarray(x)))
    got = tl.mlp_swiglu(*(tquant(torch.from_numpy(w)) for w in ws),
                        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_masked_attention_matches():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 6, 4, 128)).astype(np.float32)
    kc = rng.standard_normal((1, 2, 32, 128)).astype(np.float32)
    vc = rng.standard_normal((1, 2, 32, 128)).astype(np.float32)
    ref = np.asarray(jl.attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.int32(9)))
    got = tl.attention(torch.from_numpy(q), torch.from_numpy(kc),
                       torch.from_numpy(vc), 9).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
