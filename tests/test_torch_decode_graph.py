"""Card tests of the decode step whose position lives in device memory
(``llama.decode_step``) and of its CUDA-graph replay (``DecodeLoop``).

- K4 (the whole-token megakernel) with its position read from device memory,
  its rope rows gathered from the tables and its workspace sized for the
  whole cache is bit-equal to the launch given the same length as a host int
  (which splits the attention by that length, as the device launch does),
  at lengths 0, 1000 and 2047 of a 2048-position cache, over bf16 and int8
  caches and in W3 mode, and within the card tolerance of the plain version.
- K2, K9 and K14 with their lengths in device memory and a grid planned for
  a bucket split by the length they read: each is bit-equal to the launch
  planned on the host for that length, at every length of a bucket's
  edges, at Llama-3-8B's, OPT-6.7B's, Falcon-7B's and StarCoder's heads.
- Greedy ids of an engine whose decode replays captured graphs equal those
  of the same engine with no loop (one ``forward`` call a token, a host
  position), on K4, on the stacked path (K1, K2), over an int8 cache (K9,
  K7's int8 mode), on falcon-shaped models (K14; one with Falcon-7B's 71 q
  heads over one kv head) and on OPT, StarCoder and Pythia shapes; rounds whose greedy
  configurations differ only in fields the step does not read replay one
  graph. Sampled rounds replay a graph too and draw the forward loop's ids
  from the same seed.

All skip without a card; the CPU tests of the same step are in
``test_torch_stream.py``.
"""

import pytest
import torch

from awq_tpu_torch.config import GenConfig, ModelConfig, QuantConfig, RuntimeConfig
from awq_tpu_torch.models import llama
from awq_tpu_torch.ops import decode_attn as tda
from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops.cache_append import quantize_kv
from awq_tpu_torch.ops.w4a16 import QLinear
from awq_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(1)

HD, T = 128, 2048
CARD_TOL = 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _k4_model(dev, w3, seed=3):
    nq, nkv, H, I, L = 4, 2, 512, 1024, 2
    g = torch.Generator(device=dev).manual_seed(seed)

    def lin(ic, oc, n=L):
        rows = ic * 3 // 32 if w3 else ic // 8
        qw = torch.randint(-(2**31), 2**31 - 1, (n, rows, oc), generator=g,
                           dtype=torch.int32, device=dev)
        s = (torch.rand((n, ic // 128, oc), generator=g, device=dev) + 0.5) * 0.01
        return QLinear(qweight=qw, scales=s, szeros=s * (4 if w3 else 8),
                       w_bit=3 if w3 else 4, dense3=w3)

    ws = (lin(H, (nq + 2 * nkv) * HD), lin(H, H), lin(H, 2 * I), lin(I, H))
    ln = [(torch.rand((L, H), generator=g, device=dev) * 0.4 + 0.8).to(torch.bfloat16)
          for _ in range(2)]
    hq = lin(H, 1024, 1)
    head = dict(whead=QLinear(qweight=hq.qweight[0], scales=hq.scales[0],
                              szeros=hq.szeros[0], w_bit=hq.w_bit, dense3=w3),
                norm_w=torch.ones(H, dtype=torch.bfloat16, device=dev))
    cache = (torch.randn((L, 2, 1, nkv, T, HD), generator=g, device=dev) * 0.5
             ).to(torch.bfloat16)
    ang = torch.rand((T, HD), generator=g, device=dev) * 6.28
    h = (torch.randn((1, H), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    return (nq, nkv), ws, ln, head, cache, torch.cos(ang), torch.sin(ang), h


def _cache_copies(cache, int8):
    if not int8:
        return [(cache.clone(), None) for _ in range(3)]
    codes, scales = quantize_kv(cache)
    return [(codes.clone(), scales.clone()) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("length", [0, 1000, 2047])
@pytest.mark.parametrize("variant", ["bf16", "int8", "w3"])
def test_k4_device_position_bit_equal_on_card(cuda, variant, length):
    (nq, nkv), ws, (ln1, ln2), head, cache, cos, sin, h = _k4_model(cuda, variant == "w3")
    (c_host, s_host), (c_dev, s_dev), (c_ref, s_ref) = _cache_copies(cache, variant == "int8")
    bound = T - 1
    host = tmk.w4a16_llama_token_step(h, *ws, ln1, ln2, cos[length], sin[length], c_host,
                                      length, nq, nkv, cache_scales=s_host, **head)
    pos = torch.tensor([length], dtype=torch.int32, device=cuda)
    dev = tmk.w4a16_llama_token_step(h, *ws, ln1, ln2, cos, sin, c_dev, pos, nq, nkv,
                                     cache_scales=s_dev, max_length=bound, **head)
    ref = tmk.w4a16_llama_token_step_plain(h, *ws, ln1, ln2, cos[length], sin[length], c_ref,
                                           length, nq, nkv, cache_scales=s_ref, **head)
    torch.cuda.synchronize()
    for a, b in zip(host, dev):
        assert torch.equal(a, b)
    assert torch.equal(c_host, c_dev)
    if s_host is not None:
        assert torch.equal(s_host, s_dev)
    for a, r in zip(dev, ref):       # h, k, v, logits
        assert (a.float() - r.float()).abs().max() <= CARD_TOL * r.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 1000, 2048])
def test_k14_device_length_bit_equal_on_card(cuda, length):
    """K14 at Falcon-7B's heads with its length in device memory and a grid
    for the whole cache splits by the length it reads: bit-equal to the
    host launch planned for that length (``forward``'s)."""
    g = torch.Generator(device=cuda).manual_seed(length)
    q = torch.randn((1, 71, 64), generator=g, device=cuda).to(torch.bfloat16)
    kc = torch.randn((1, 1, T, 64), generator=g, device=cuda).to(torch.bfloat16)
    vc = torch.randn((1, 1, T, 64), generator=g, device=cuda).to(torch.bfloat16)
    host = tda.flash_decode_layer(q, kc, vc, length)
    dev = tda.flash_decode_layer(q, kc, vc, torch.tensor([length], dtype=torch.int32,
                                                         device=cuda), max_length=T)
    ref = tda.flash_decode_layer_plain(q, kc, vc, length)
    torch.cuda.synchronize()
    assert torch.equal(host, dev)
    assert (dev.float() - ref.float()).abs().max() <= CARD_TOL * ref.float().abs().max()


# lengths at a bucket's edges and the split's: 0, one tile, a K2 unit (256),
# a slice more, the bucket's last
EDGES = [0, 1, 63, 64, 255, 256, 257, 700, 1023, 1024, 1500, 2047]


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(32, 8), (32, 32)], ids=["llama3_8b", "opt_6_7b"])
@pytest.mark.parametrize("kernel", ["k2", "k9"])
def test_k2_k9_device_length_bit_equal_on_card(cuda, kernel, heads):
    """K2 and K9 at one shared length read in device memory, their grid
    planned for the bucket 2047 (``by_length``, the captured step's), are
    bit-equal to the launch planned on the host for that length, at every
    length of ``EDGES``, and within the card tolerance of the plain
    version."""
    nq, nkv = heads
    g = torch.Generator(device=cuda).manual_seed(nq + nkv)
    q = torch.randn((1, nq, HD), generator=g, device=cuda).to(torch.bfloat16)
    kn, vn = (torch.randn((1, nkv, HD), generator=g, device=cuda).to(torch.bfloat16)
              for _ in range(2))
    cache = torch.randn((2, 1, nkv, T, HD), generator=g, device=cuda).to(torch.bfloat16)
    codes, scales = quantize_kv(cache.float())
    for length in EDGES:
        lens = torch.tensor([length], dtype=torch.int32, device=cuda)
        if kernel == "k2":
            host = tda.flash_decode(q, kn, vn, cache, lens, max_length=length)
            dev = tda.flash_decode(q, kn, vn, cache, lens, max_length=T - 1, by_length=True)
            ref = tda.flash_decode_plain(q, kn, vn, cache, lens, max_length=length)
        else:
            host = tda.flash_decode_int8(q, kn, vn, codes, scales, lens, max_length=length)
            dev = tda.flash_decode_int8(q, kn, vn, codes, scales, lens, max_length=T - 1,
                                        by_length=True)
            ref = tda.flash_decode_int8_plain(q, kn, vn, codes, scales, lens,
                                              max_length=length)
        torch.cuda.synchronize()
        assert torch.equal(host, dev), length
        assert (dev.float() - ref.float()).abs().max() <= CARD_TOL * ref.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(71, 1, 64), (48, 1, 128), (32, 8, 128)],
                         ids=["falcon_7b", "starcoder", "llama3_8b"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k14_device_length_edges_on_card(cuda, heads, dtype):
    """K14 with a device length and a bucket of 1024 positions, bit-equal to
    the host launch planned for the length at every length of ``EDGES``
    under the bucket."""
    nq, nkv, hd = heads
    g = torch.Generator(device=cuda).manual_seed(nq)
    q = torch.randn((1, nq, hd), generator=g, device=cuda).to(dtype)
    kc, vc = (torch.randn((1, nkv, T, hd), generator=g, device=cuda).to(dtype)
              for _ in range(2))
    for length in [n for n in EDGES if 1 <= n <= 1024]:
        host = tda.flash_decode_layer(q, kc, vc, length)
        dev = tda.flash_decode_layer(q, kc, vc, torch.tensor([length], dtype=torch.int32,
                                                             device=cuda), max_length=1024)
        torch.cuda.synchronize()
        assert torch.equal(host, dev), length


GEOMS = {
    "llama": dict(arch="llama", vocab_size=1024, hidden_size=512, intermediate_size=1024,
                  num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                  max_position_embeddings=T, dtype="bfloat16"),
    "falcon": dict(arch="falcon", vocab_size=1024, hidden_size=320, intermediate_size=1280,
                   num_layers=2, num_heads=5, num_kv_heads=1, head_dim=64,
                   max_position_embeddings=T, dtype="bfloat16", norm="layernorm",
                   act="gelu", parallel_block=True, single_ln=True),
    # Falcon-7B's heads (71 over one kv head), two layers
    "falcon71": dict(arch="falcon", vocab_size=1024, hidden_size=4544, intermediate_size=4544,
                     num_layers=2, num_heads=71, num_kv_heads=1, head_dim=64,
                     max_position_embeddings=T, dtype="bfloat16", norm="layernorm",
                     act="gelu", parallel_block=True, single_ln=True),
    # OPT-6.7B's, StarCoder's and Pythia-6.9B's heads at a narrow width
    "opt": dict(arch="opt", vocab_size=1024, hidden_size=512, intermediate_size=1024,
                num_layers=2, num_heads=4, num_kv_heads=4, head_dim=128,
                max_position_embeddings=T, dtype="bfloat16", norm="layernorm", act="relu",
                pos_embed="learned", attn_bias=True, mlp_bias=True, tie_word_embeddings=True),
    "starcoder": dict(arch="bigcode", vocab_size=1024, hidden_size=512, intermediate_size=1024,
                      num_layers=2, num_heads=48, num_kv_heads=1, head_dim=128,
                      max_position_embeddings=T, dtype="bfloat16", norm="layernorm",
                      act="gelu_tanh", pos_embed="learned", attn_bias=True, mlp_bias=True,
                      tie_word_embeddings=True),
    "neox": dict(arch="neox", vocab_size=1024, hidden_size=512, intermediate_size=1024,
                 num_layers=2, num_heads=4, num_kv_heads=4, head_dim=128,
                 max_position_embeddings=T, dtype="bfloat16", norm="layernorm", act="gelu",
                 rotary_pct=0.25, parallel_block=True, attn_bias=True, mlp_bias=True),
}
FAMILY_PATHS = ("falcon", "falcon71", "opt", "starcoder", "neox")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["megakernel", "stacked", "int8"] + list(FAMILY_PATHS))
def test_graph_decode_ids_equal_eager_on_card(cuda, path, monkeypatch):
    if path in ("stacked", "int8"):
        monkeypatch.setenv("AWQ_TPU_DISABLE_MEGAKERNEL", "1")
    else:
        monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    cfg = ModelConfig(**GEOMS[path if path in FAMILY_PATHS else "llama"])
    q = QuantConfig(w_bit=4, group_size=64 if cfg.head_dim == 64 else 128)
    params = llama.init_qparams(cfg, q, torch.Generator(device=cuda).manual_seed(5),
                                device=cuda)
    cache_dtype = "int8" if path == "int8" else torch.bfloat16
    rt = RuntimeConfig(max_seq_len=T, quantize_head=not path.startswith("falcon"))
    prompts = [list(range(7, 27)), list(range(40, 45))]
    gens = [GenConfig(greedy=True, max_new_tokens=40),
            GenConfig(greedy=True, max_new_tokens=33, top_p=0.5, top_k=7)]
    outs = []
    for graph in (True, False):
        eng = InferenceEngine(cfg, params, rt, cache_dtype=cache_dtype, device=cuda)
        if not graph:
            eng.loop = None              # the forward loop, a host position a token
        ids = []
        for prompt, gen in zip(prompts, gens):
            out = eng.generate(prompt, gen)
            assert out["timing"]["loop"] == ("graph" if graph else "forward")
            ids.append(out["output_ids"].tolist())
        if graph:
            assert len(eng.loop.graphs) == 1     # one bucket and penalty, captured once
        outs.append(ids)
    assert outs[0] == outs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["megakernel", "stacked"])
def test_sampled_graph_ids_equal_forward_on_card(cuda, path, monkeypatch):
    """Sampled rows replay a captured step too: the loop's own generator,
    registered with the graph, takes the burst's generator state, so two
    rounds draw the forward loop's ids from the same seed and leave the
    generator where the forward loop leaves it; the second round (another
    ``max_new_tokens``, the same sampling) replays the first's graph."""
    if path == "stacked":
        monkeypatch.setenv("AWQ_TPU_DISABLE_MEGAKERNEL", "1")
    else:
        monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    cfg = ModelConfig(**GEOMS["llama"])
    params = llama.init_qparams(cfg, QuantConfig(w_bit=4, group_size=128),
                                torch.Generator(device=cuda).manual_seed(5), device=cuda)
    rt = RuntimeConfig(max_seq_len=T, quantize_head=True)
    prompts = [list(range(7, 27)), list(range(40, 45))]
    gens = [GenConfig(temperature=0.8, top_k=40, top_p=0.9, max_new_tokens=40),
            GenConfig(temperature=0.8, top_k=40, top_p=0.9, max_new_tokens=33)]
    outs = []
    for graph in (True, False):
        eng = InferenceEngine(cfg, params, rt, device=cuda)
        if not graph:
            eng.loop = None
        rng = torch.Generator(device=cuda).manual_seed(21)
        ids = []
        for prompt, gen in zip(prompts, gens):
            out = eng.generate(prompt, gen, generator=rng)
            assert out["timing"]["loop"] == ("graph" if graph else "forward")
            ids.append(out["output_ids"].tolist())
        if graph:
            assert len(eng.loop.graphs) == 1
        outs.append((ids, torch.rand(4, generator=rng, device=cuda).tolist()))
    assert outs[0] == outs[1]
