"""Third-party AWQ checkpoints in both packages (``awq_tpu_torch/utils/
load_quant.py`` and ``awq_tpu_torch/native.py`` against JAX's), bit for bit:

- an AutoAWQ directory JAX's ``save_autoawq_checkpoint`` wrote, and the
  TinyChat v2 files ``tests/test_load_quant.py`` writes, load into the port
  equal to ``params_from_jax`` of JAX's load of the same files;
- the port's ``save_autoawq_checkpoint`` writes what JAX's writes, tensor for
  tensor, and JAX loads it;
- the native repacker (built with ``g++`` under a library name of the
  port's own) equals its numpy version, the plain reference.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
from awq_tpu.models import llama as jllama
from awq_tpu.quant.core import quantize_groupwise
from awq_tpu.utils import load_quant as jlq
from awq_tpu_torch import native as tnative
from awq_tpu_torch.config import ModelConfig as TConfig, QuantConfig as TQuant
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.models.hf_import import read_safetensors
from awq_tpu_torch.utils import load_quant as tlq

from test_torch_checkpoint import _assert_same

torch.set_num_threads(1)

GEOM = dict(arch="llama", vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=4, head_dim=32,
            max_position_embeddings=128, dtype="float32")
HF = {"model_type": "llama", "vocab_size": 256, "hidden_size": 128,
      "intermediate_size": 256, "num_hidden_layers": 2, "num_attention_heads": 4,
      "num_key_value_heads": 4, "max_position_embeddings": 128, "rms_norm_eps": 1e-5,
      "tie_word_embeddings": False}
NAMES = {"wq": "model.layers.{i}.self_attn.q_proj", "wk": "model.layers.{i}.self_attn.k_proj",
         "wv": "model.layers.{i}.self_attn.v_proj", "wo": "model.layers.{i}.self_attn.o_proj",
         "gate": "model.layers.{i}.mlp.gate_proj", "up": "model.layers.{i}.mlp.up_proj",
         "down": "model.layers.{i}.mlp.down_proj"}


def _jax_quantized(seed):
    cfg = JConfig(**GEOM)
    return cfg, jllama.quantize_params(jllama.init_params(cfg, jax.random.PRNGKey(seed)),
                                       JQuant(w_bit=4, group_size=64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autoawq_checkpoint_loads_equal(dtype, tmp_path):
    cfg, qp = _jax_quantized(9)
    d = str(tmp_path / "awq")
    jlq.save_autoawq_checkpoint(qp, cfg, JQuant(w_bit=4, group_size=64), d)
    jcfg, jparams, jq = jlq.load_autoawq_checkpoint(d, dtype=dtype)
    tcfg, tparams, tq = tlq.load_autoawq_checkpoint(d, dtype=dtype, device="cpu")
    _assert_same(tparams, params_from_jax(jax.device_get(jparams), device="cpu"))
    assert (tcfg.num_layers, tcfg.dtype, tq.group_size) == (jcfg.num_layers, dtype, 64)


def test_port_autoawq_export_equals_jax(tmp_path):
    cfg, qp = _jax_quantized(10)
    port = params_from_jax(jax.device_get(qp), device="cpu")
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jlq.save_autoawq_checkpoint(qp, cfg, JQuant(w_bit=4, group_size=64), jd)
    tlq.save_autoawq_checkpoint(port, TConfig(**GEOM), TQuant(w_bit=4, group_size=64), td)
    a = read_safetensors(os.path.join(jd, "model.safetensors"))
    b = read_safetensors(os.path.join(td, "model.safetensors"))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    with open(os.path.join(jd, "config.json")) as f, open(os.path.join(td, "config.json")) as g:
        assert json.load(f) == json.load(g)
    _, jparams, _ = jlq.load_autoawq_checkpoint(td, dtype="float32")
    _, tparams, _ = tlq.load_autoawq_checkpoint(jd, dtype="float32", device="cpu")
    _assert_same(params_from_jax(jax.device_get(jparams), device="cpu"), tparams)


def test_tinychat_v2_checkpoint_loads_equal(tmp_path):
    """The files of ``tests/test_load_quant.py::test_tinychat_v2_roundtrip``
    (v2-packed int16 codes, group-padded scales and scaled zeros)."""
    from tests.test_native import _pack_v2_reference

    cfg = JConfig(**GEOM)
    params = jllama.init_params(cfg, jax.random.PRNGKey(3))

    def pad(a):
        rows = -(-a.shape[0] // 16) * 16
        out = np.zeros((rows, a.shape[1]), a.dtype)
        out[:a.shape[0]] = a
        return out

    sd = {}
    for i in range(cfg.num_layers):
        for ours, fmt in NAMES.items():
            w = np.asarray(params["layers"][ours].w[i], np.float32)
            q, s, z = quantize_groupwise(jnp.asarray(w), 4, 64)
            p = fmt.format(i=i)
            sd[p + ".qweight"] = torch.from_numpy(
                _pack_v2_reference(np.ascontiguousarray(np.asarray(q).T)).copy())
            sd[p + ".scales"] = torch.from_numpy(pad(np.asarray(s, np.float32)))
            sd[p + ".scaled_zeros"] = torch.from_numpy(
                pad(-(np.asarray(s) * np.asarray(z)).astype(np.float32)))
        for key, name in (("ln1", "input_layernorm"), ("ln2", "post_attention_layernorm")):
            sd[f"model.layers.{i}.{name}.weight"] = torch.from_numpy(
                np.asarray(params["layers"][key][i], np.float32))
    sd["model.embed_tokens.weight"] = torch.from_numpy(np.asarray(params["embed"], np.float32))
    sd["model.norm.weight"] = torch.from_numpy(np.asarray(params["norm"], np.float32))
    sd["lm_head.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(params["lm_head"], np.float32).T))
    d = str(tmp_path / "tc2")
    os.makedirs(d)
    torch.save(sd, os.path.join(d, "model-v2.pt"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(HF, f)
    pt = os.path.join(d, "model-v2.pt")
    for dtype in ("float32", "bfloat16"):
        _, jparams, _ = jlq.load_tinychat_v2_checkpoint(pt, d, dtype=dtype, group_size=64)
        _, tparams, _ = tlq.load_tinychat_v2_checkpoint(pt, d, dtype=dtype, group_size=64,
                                                        device="cpu")
        _assert_same(tparams, params_from_jax(jax.device_get(jparams), device="cpu"))


def test_native_repack_equals_numpy():
    """Where ``g++`` builds the library: each entry point equals the numpy
    version on random packed words."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++: the numpy versions run, and are the reference")
    assert tnative.native_available()
    assert tnative._LIB_PATH.endswith("libawq_torch_repack.so")
    rng = np.random.default_rng(1)
    n, k = 64, 256
    v2 = rng.integers(-2**15, 2**15, (n // 4, k)).astype(np.int16)
    np.testing.assert_array_equal(tnative.unpack_awq_v2(v2, n, k),
                                  tnative._np_unpack_awq_v2(v2, n, k))
    gemm = rng.integers(-2**31, 2**31, (k, n // 8)).astype(np.int32)
    np.testing.assert_array_equal(tnative.unpack_awq_gemm(gemm, k, n),
                                  tnative._np_unpack_awq_gemm(gemm, k, n))
    codes = rng.integers(0, 16, (k, n)).astype(np.uint8)
    packed = tnative.pack_int4_tpu(codes)
    np.testing.assert_array_equal(packed, tnative._np_pack_int4_tpu(codes))
    np.testing.assert_array_equal(tnative.unpack_int4_tpu(packed, k, n), codes)
