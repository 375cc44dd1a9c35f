"""Port parity: the HF importer (``awq_tpu_torch/models/hf_import.py``).

Tiny random ``transformers`` models built in process (no download): falcon
7b-style (MQA, one norm, the ``concat`` QKV layout) and 40b-style
(``new_decoder_architecture``: the ``grouped`` QKV layout and two norms),
and llama. The port's tree equals the JAX package's importer's, tensor for
tensor, and its f32 ``forward`` logits equal HF's at the JAX package's own
tolerance (``tests/test_models_multiarch.py``). A checkpoint directory
written by ``save_pretrained`` (safetensors shards) is read through the
port's own reader, in f32 and in bf16.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.models import hf_import as thf
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.models.layers import Linear

transformers = pytest.importorskip("transformers")

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


def _falcon(new_arch, seed):
    kw = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
              parallel_attn=True, bias=False, alibi=False, max_position_embeddings=128)
    kw.update(dict(num_kv_heads=2, multi_query=False, new_decoder_architecture=True)
              if new_arch else dict(multi_query=True, new_decoder_architecture=False))
    torch.manual_seed(seed)
    return transformers.FalconForCausalLM(transformers.FalconConfig(**kw)).eval().float()


def _llama(seed):
    cfg = transformers.LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=128)
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval().float()


MODELS = {"falcon_7b_style": lambda: _falcon(False, 1),
          "falcon_40b_style": lambda: _falcon(True, 5),
          "llama": lambda: _llama(2)}


def _assert_trees_equal(got, ref, path="params"):
    """The port's tree against the JAX importer's (numpy leaves)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_trees_equal(got[k], ref[k], f"{path}/{k}")
    elif hasattr(ref, "w"):
        assert isinstance(got, Linear), path
        _assert_trees_equal(got.w, ref.w, path + ".w")
        assert (got.b is None) == (ref.b is None), path
        if ref.b is not None:
            _assert_trees_equal(got.b, ref.b, path + ".b")
    else:
        ref = np.asarray(ref)
        assert tuple(got.shape) == ref.shape, path
        np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32),
                                      err_msg=path)


@pytest.mark.parametrize("name", list(MODELS))
def test_import_equals_jax_and_logits_equal_hf(name):
    from awq_tpu.models.hf_import import import_hf_model as jimport

    model = MODELS[name]()
    cfg, params = thf.import_hf_model(model, dtype="float32", device="cpu")
    jcfg, jparams = jimport(model, dtype="float32")
    assert cfg.__dict__ == jcfg.__dict__
    _assert_trees_equal(params, jparams)

    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 9))
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens).long()).logits.numpy()
    cache = tllama.init_kv_cache(cfg, 1, 16, torch.float32, device="cpu")
    ours, _ = tllama.forward(params, cfg, torch.from_numpy(tokens), cache, 0,
                             last_only=False)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("name", ["falcon_7b_style", "falcon_40b_style"])
def test_import_from_a_directory(name, tmp_path):
    """``save_pretrained`` writes ``config.json`` and safetensors shards: the
    port's reader gives the JAX importer's tree (f32, read by the
    ``safetensors`` package there), and a bf16 checkpoint gives the port's
    in-memory import of the same bf16 model, bit for bit."""
    from awq_tpu.models.hf_import import import_hf_model as jimport

    model = MODELS[name]()
    model.save_pretrained(tmp_path / "f32", safe_serialization=True)
    assert list((tmp_path / "f32").glob("*.safetensors"))
    cfg, params = thf.import_hf_model(str(tmp_path / "f32"), dtype="float32", device="cpu")
    _, jparams = jimport(str(tmp_path / "f32"), dtype="float32")
    _assert_trees_equal(params, jparams)

    model = model.to(torch.bfloat16)
    model.save_pretrained(tmp_path / "bf16", safe_serialization=True)
    _, got = thf.import_hf_model(str(tmp_path / "bf16"), dtype="bfloat16", device="cpu")
    _, ref = thf.import_hf_model(model, dtype="bfloat16", device="cpu")

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            elif isinstance(v, Linear):
                yield f"{prefix}{k}.w", v.w
                if v.b is not None:
                    yield f"{prefix}{k}.b", v.b
            else:
                yield prefix + k, v

    a, b = dict(flat(got)), dict(flat(ref))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == torch.bfloat16 and torch.equal(a[k], b[k]), k


def test_other_families_raise():
    # OPT imports since the port serves it; its projected embedding
    # (OPT-350m's word_embed_proj_dim != hidden_size) and GPT-NeoX-20B's
    # head_dim 96 do not
    cfg = transformers.OPTConfig(vocab_size=64, hidden_size=32, ffn_dim=64,
                                 num_hidden_layers=1, num_attention_heads=2,
                                 word_embed_proj_dim=16)
    model = transformers.OPTForCausalLM(cfg).eval()
    with pytest.raises(NotImplementedError, match="item 12"):
        thf.import_hf_model(model, dtype="float32", device="cpu")
    cfg = transformers.GPTNeoXConfig(vocab_size=64, hidden_size=192, intermediate_size=64,
                                     num_hidden_layers=1, num_attention_heads=2)
    model = transformers.GPTNeoXForCausalLM(cfg).eval()
    with pytest.raises(NotImplementedError, match="item 12"):
        thf.import_hf_model(model, dtype="float32", device="cpu")
