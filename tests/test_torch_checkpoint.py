"""Checkpoints across the two packages (``awq_tpu_torch/utils/checkpoint.py``
against ``awq_tpu/utils/checkpoint.py``), bit for bit:

- a file JAX's ``save_checkpoint`` wrote loads into the port (no
  ``safetensors`` package on the port's side) equal to ``params_from_jax``
  of the same tree: an f32 unquantized model (``Linear`` leaves), W4 models
  in f32 and bf16 (bf16 leaves stored as raw bits), JAX's fused and folded
  deploy tree, and W3 (``pack_int3``) trees, plain and folded (``w3x``);
- a file the port wrote loads into JAX, and back through
  ``params_from_jax``, equal to the port's tree; the port loads its own;
- split checkpoints both ways, and the pack-layout version gate.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
from awq_tpu.models import llama as jllama
from awq_tpu.utils import checkpoint as jck
from awq_tpu_torch.config import ModelConfig as TConfig, QuantConfig as TQuant
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.models.layers import Linear
from awq_tpu_torch.ops.w4a16 import QLinear
from awq_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)

GEOM = dict(arch="llama", vocab_size=256, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
            max_position_embeddings=128)


def _assert_same(a, b, path="params"):
    """Two port trees equal bit for bit: the same leaves, dtypes, shapes
    and bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (QLinear, Linear)):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.uint8) if b.dtype == torch.bfloat16 else b), path
    else:
        assert a == b, path


def _jax_tree(kind):
    """``(cfg, qcfg, tree)`` of the JAX package."""
    dtype = "bfloat16" if kind == "w4_bf16" else "float32"
    cfg = JConfig(**GEOM, dtype=dtype)
    params = jllama.init_params(cfg, jax.random.PRNGKey(4))
    if kind == "fp":
        return cfg, None, params
    qcfg = JQuant(w_bit=3 if kind.startswith("w3") else 4, group_size=128)
    tree = jllama.quantize_params(params, qcfg)
    if kind.endswith("folded"):
        tree = jllama.fuse_linears(tree, cfg)
    return cfg, qcfg, tree


KINDS = ["fp", "w4", "w4_bf16", "folded", "w3", "w3_folded"]


@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoint_loads_into_the_port(kind, tmp_path):
    cfg, qcfg, tree = _jax_tree(kind)
    path = str(tmp_path / "ck")
    jck.save_checkpoint(path, tree, cfg, qcfg)
    params, tcfg, tq = tck.load_checkpoint(path, device="cpu")
    _assert_same(params, params_from_jax(jax.device_get(tree), device="cpu"))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert (tq and dataclasses.asdict(tq)) == (qcfg and dataclasses.asdict(qcfg))


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_loads_into_jax(kind, tmp_path):
    cfg, qcfg, tree = _jax_tree(kind)
    port = params_from_jax(jax.device_get(tree), device="cpu")
    tcfg = TConfig(**dataclasses.asdict(cfg))
    tq = TQuant(**dataclasses.asdict(qcfg)) if qcfg else None
    path = str(tmp_path / "ck")
    nbytes = tck.save_checkpoint(path, port, tcfg, tq)
    assert nbytes == os.path.getsize(path + ".safetensors")
    jtree, jcfg, jq = jck.load_checkpoint(path)
    _assert_same(params_from_jax(jax.device_get(jtree), device="cpu"), port)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    again, _, _ = tck.load_checkpoint(path, device="cpu")
    _assert_same(again, port)


def test_port_random_model_round_trip(tmp_path):
    """The port's own random W4 model (``init_qparams``, as the card's
    smoke saves it): saved, loaded, every leaf equal."""
    cfg = TConfig(**GEOM, dtype="bfloat16")
    params = tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=128),
                                 torch.Generator().manual_seed(2), device="cpu")
    path = str(tmp_path / "rand")
    tck.save_checkpoint(path, params, cfg, TQuant(w_bit=4, group_size=128))
    got, gcfg, _ = tck.load_checkpoint(path, device="cpu")
    _assert_same(got, params)
    assert gcfg == cfg


def test_split_checkpoints_both_ways(tmp_path):
    cfg, qcfg, tree = _jax_tree("w4_bf16")
    path = str(tmp_path / "ck")
    jck.save_checkpoint(path, tree, cfg, qcfg)
    ref, _, _ = tck.load_checkpoint(path, device="cpu")
    n = tck.split_checkpoint(path, str(tmp_path / "port_split"))
    assert n == jck.split_checkpoint(path, str(tmp_path / "jax_split"))
    for d in ("port_split", "jax_split"):
        got, _, _ = tck.load_split_checkpoint(str(tmp_path / d), device="cpu")
        _assert_same(got, ref)
    jtree, _, _ = jck.load_split_checkpoint(str(tmp_path / "port_split"))
    _assert_same(params_from_jax(jax.device_get(jtree), device="cpu"), ref)


def test_pack_layout_version_gate(tmp_path):
    cfg, qcfg, tree = _jax_tree("w4")
    path = str(tmp_path / "ck")
    jck.save_checkpoint(path, tree, cfg, qcfg)
    tck.split_checkpoint(path, str(tmp_path / "split"))
    for meta_path in (path + ".json", str(tmp_path / "split" / "meta.json")):
        with open(meta_path) as f:
            meta = json.load(f)
        meta["pack_layout_version"] = tck.PACK_LAYOUT_VERSION + 1
        with open(meta_path, "w") as f:
            json.dump(meta, f)
    with pytest.raises(ValueError, match="pack layout v2"):
        tck.load_checkpoint(path, device="cpu")
    with pytest.raises(ValueError, match="pack layout v2"):
        tck.load_split_checkpoint(str(tmp_path / "split"), device="cpu")


def test_safetensors_writer_reads_back_in_the_package(tmp_path):
    """The port's writer against the ``safetensors`` package's reader: every
    dtype the checkpoints hold, empty and scalar arrays included."""
    from safetensors.numpy import load_file

    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "i32": rng.integers(-9, 9, (7,)).astype(np.int32),
              "u16": rng.integers(0, 65535, (2, 2, 2)).astype(np.uint16),
              "f16": rng.standard_normal((4,)).astype(np.float16),
              "i8": rng.integers(-9, 9, (6,)).astype(np.int8),
              "empty": np.zeros((0, 3), np.float32), "scalar": np.float32(1.5).reshape(())}
    tck.write_safetensors(str(tmp_path / "a.safetensors"), arrays)
    got = load_file(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
