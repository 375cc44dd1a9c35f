"""The decoder of every ported family (PyTorch port of ``awq_tpu/models/llama.py``).

Parameters are a plain dict, the same tree as the JAX package's: decoder
layers stacked on a leading axis (``params["layers"]["wqkv"]`` is one
:class:`QLinear` ``[L, ...]``), so a layer is a free view ``x[l]``. The KV
cache is the preallocated ``[L, 2, B, n_kv, T, hd]`` tensor, and
:func:`forward` WRITES IT IN PLACE (the JAX ``forward`` returned a new
cache; this one returns the same tensor it was given).

:func:`forward` takes, for llama/mistral/qwen2, the JAX package's paths:

- the megakernels, at batch 1 where :func:`~awq_tpu_torch.ops.megakernel.
  megakernel_supported` holds (fused g128 linears, all W4 or all W3 in
  ``pack_int3``, head_dim 128, a
  float cache on CUDA; ``AWQ_TPU_FORCE_MEGAKERNEL=1`` runs their plain
  versions on the CPU, ``AWQ_TPU_DISABLE_MEGAKERNEL=1`` turns them off):
  a one-token step is ONE launch of K4 for every layer, plus the final
  norm and the head when the head is a ``QLinear`` of the body's format; a
  window of 2..32
  tokens is one launch of K5. Both write the cache in place.
- otherwise the stacked per-kernel path: per layer RMSNorm -> fused QKV
  (K1) -> rope -> flash decode (K2, current token's k/v as operands,
  appended to the layer's cache by the same launch) or in-place chunk
  append + flash prefill (K3) -> o-proj (K1) -> RMSNorm -> fused gate/up (K1) ->
  SiLU·mul -> down (K1).

:func:`decode_step_batched` is the continuous-batching step: one token per
row, every row at its own position. With 2..64 rows under the same gate it
is ONE launch of K6 (``ops/megakernel_batched.py``), which also writes each
row's k/v in place; otherwise the stacked path with per-row rope rows and
K2 over per-row lengths, each launch appending its layer's current token
(K7's write, ``ops/cache_append.py``, fused into K2).

:func:`verify_step_batched` is the batched speculative verify: a window of
W tokens a row, every row at its own position, the logits of every window
position back; the stacked path with K1 over ``B * W`` rows and the window
mode of K2 (K9 over an int8 cache) a layer, which appends the windows.

:func:`decode_step_paged` is the same step over a PAGED cache: a page pool
``[L, 2, NP, n_kv, page, hd]`` and a block table ``[B, MP]`` per row. It
takes K6's paged mode (2..64 rows, pages of a power-of-two size), or the
stacked path with K8 (``flash_decode_paged``) per layer, which appends
into the layer's pages.

The int8 KV cache, :class:`KVCache8` (int8 codes and f32 scales, one per
position and head), rides :func:`forward` and :func:`decode_step_batched`:
decode through K4's and K6's int8 modes, or the stacked path with K9
(``flash_decode_int8``) per layer, which quantizes the current token into
the layer's cache after attending to it in full precision, as the TPU's
append after the layer scan does. Prefill quantizes the chunk and
writes it first, then attends over the dequantized prefix with K3. There
is no paged int8 pool and no int8 K5, as in the JAX package.

Under tensor parallelism (``tp_axis``, a :class:`~awq_tpu_torch.parallel.
mesh.TPGroup`; ``parallel/tp.py`` drives it) every rank runs
:func:`forward` on its shards with the LOCAL config (``tp_local_cfg``):
the vocab-sharded embedding is a masked local lookup and an all-reduce;
one-token decode at batch 1 takes the half-layer megakernels K12 and K13
(``ops/megakernel_tp.py``) with an all-reduce after each, where
``tp_megakernel_supported`` holds (on CUDA, or their plain versions on the
CPU with ``AWQ_TPU_TP_MEGAKERNEL=1``, the JAX package's switch); otherwise,
and for every prefill, the stacked path with an all-reduce after the
row-parallel ``wo`` and ``down`` (a bias added once, after it). K4 and K5
fuse all layers and take no part. The logits come back vocab-sharded.

``cfg.prefill_a8`` (the int8-activation prefill) routes every stacked-path
linear of a prefill (S > 1) through K11 over the layer's int8 weight cache
``<name>_w8`` (a ``W8Stack``, built by ``attach_w8_caches`` for
``RuntimeConfig.prefill_w8``) or K10, as ``qlinear_apply_stacked`` gates
them; the megakernels and decode are unchanged, so a float-cache prompt of
up to 32 tokens still takes K5, as in the JAX package.

Falcon (``arch="falcon"``: LayerNorm with bias, the exact-GELU MLP ``up``
/``down`` with no gate, the parallel block with one norm (7b, ``single_ln``)
or two (40b), MQA or grouped QKV) takes the stacked path of :func:`forward`
alone: its norm and MLP refuse every megakernel gate. Where
``flash_decode_supported`` fails (head_dim 64, 71 query heads per kv head),
a one-position step at one shared position writes each layer's k/v and
then attends through ``layers.attention``, whose S = 1 branch is K14
(``flash_decode_layer``: it launches or raises on the card, its plain
version on the CPU), as JAX's ``forward`` falls back to ``attention``
after its in-scan append; prefill runs K3's head_dim-64 mode. Falcon's
per-row batched and paged steps and its int8 steps take K2, K8 and K9 at
head_dim 64 and wide groups; its tensor-parallel paths raise (ROADMAP
A17b).

The ALiBi families (``pos_embed="alibi"``, no rope; the slopes of
``layers.alibi_slopes``) take :func:`forward` and :func:`decode_step` at
batch 1 over a float cache: MPT (bias-free LayerNorm, the erf-GELU plain
MLP; MPT-7B is MHA at head_dim 128) decodes on K4's MPT shape
(``megakernel_supported``, a power-of-two head count, as JAX's gate) and
prefills on the stacked path; BLOOM (the embedding LayerNorm
``embed_ln``, LayerNorm with bias, the tanh-GELU MLP, biases on every
linear) takes the stacked path alone, as JAX's K4 refuses its LayerNorm
bias. On the stacked path every attention call gets the slopes: K2 (the
current token at ``slope * len``), K3 (the row-relative ``slope * (j -
i)``) and, where K2 cannot take the shape (BLOOM-560m's head_dim 64), K14
through ``layers.attention``. Their batched and paged steps take K2 and
K8 with slopes (K6 takes the llama shape only, as JAX's gate); over an
int8 cache, K9 with slopes: the single-position step in JAX's ``forward``
order (the current token quantized first), the per-row step in its
``decode_step_batched`` order (see :func:`stacked_layers`). Their
tensor-parallel paths raise (ROADMAP A17b).

OPT (``pos_embed="learned"``: the position table ``pos_embed``, row ``p +
2`` for position ``p``; LayerNorm with bias, ReLU, biases), GPT-BigCode
(StarCoder: the table from row 0, the tanh GELU, MQA) and GPT-NeoX (Pythia:
rope over ``rotary_pct`` of the head, exact GELU, the parallel block with
two norms or the sequential one, an untied head) take the stacked path of
every entry point, as JAX's megakernel gates refuse them: K2 (K14 where K2
cannot take the heads: StarCoder's 48 q heads over one kv head, or head_dim
64), K3, K1, and on the per-row steps K2, K8 and K9. The table's row is
looked up by the position, a device tensor in :func:`decode_step`, and
added after the embedding in the model dtype, as JAX adds it. Their
tensor-parallel paths raise (ROADMAP A17b), and so do a head_dim other than
64 or 128 (GPT-NeoX-20B's 96) and OPT's post-LN variant (A12).

Other family features raise ``NotImplementedError`` naming their ROADMAP
item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from awq_tpu_torch import _device
from awq_tpu_torch.config import ModelConfig, QuantConfig
from awq_tpu_torch.models.layers import (
    Linear,
    activation,
    alibi_slopes,
    apply_rope,
    attention,
    layer_norm,
    linear_apply,
    rms_norm,
    rope_table,
    update_kv_cache,
)
from awq_tpu_torch.ops.cache_append import dequantize_kv, quantize_kv
from awq_tpu_torch.ops.decode_attn import flash_decode, flash_decode_append_plain
from awq_tpu_torch.ops.decode_attn import flash_decode_layer, flash_decode_layer_plain
from awq_tpu_torch.ops.decode_attn import flash_decode_supported
from awq_tpu_torch.ops.decode_attn import flash_decode_int8, flash_decode_int8_append_plain
from awq_tpu_torch.ops.decode_attn import flash_decode_paged, flash_decode_paged_append_plain
from awq_tpu_torch.ops.decode_attn import flash_prefill, flash_prefill_plain
from awq_tpu_torch.ops.decode_attn import flash_verify, flash_verify_append_plain
from awq_tpu_torch.ops.decode_attn import flash_verify_int8, flash_verify_int8_append_plain
from awq_tpu_torch.ops import megakernel as mk
from awq_tpu_torch.ops import megakernel_batched as mkb
from awq_tpu_torch.ops import megakernel_chunk as mkc
from awq_tpu_torch.ops import megakernel_tp as mtp
from awq_tpu_torch.ops.w4a16 import (
    QLinear,
    W8Stack,
    attach_w8_caches,
    qlinear_apply,
    qlinear_apply_stacked,
    quantize_linear,
)

Params = Dict[str, Any]

# per-layer linears eligible for AWQ quantization, in block order
LAYER_LINEARS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
LLAMA_ARCHS = ("llama", "mistral", "qwen2")
ALIBI_ARCHS = ("mpt", "bloom")
# learned positions (OPT, GPT-BigCode) and NeoX's partial rotary: the
# stacked path alone, as in the JAX package
STACKED_ARCHS = ("opt", "bigcode", "neox")
SUPPORTED_ARCHS = LLAMA_ARCHS + ("falcon",) + ALIBI_ARCHS + STACKED_ARCHS
# each family's (positions, norm, activation, embedding norm, linear biases)
_FAMILY = {**{a: ("rope", "rmsnorm", "silu", False, False) for a in LLAMA_ARCHS},
           "falcon": ("rope", "layernorm", "gelu", False, False),
           "mpt": ("alibi", "layernorm", "gelu", False, False),
           "bloom": ("alibi", "layernorm", "gelu_tanh", True, True),
           "opt": ("learned", "layernorm", "relu", False, True),
           "bigcode": ("learned", "layernorm", "gelu_tanh", False, True),
           "neox": ("rope", "layernorm", "gelu", False, True)}
# the kernels' head_dims (the JAX package sends others, GPT-NeoX-20B's 96,
# to XLA attention)
_KERNEL_HEAD_DIMS = (64, 128)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _gen(generator: Optional[torch.Generator], device: torch.device):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def _family_layers(cfg: ModelConfig, dev: torch.device, lin) -> Params:
    """The stacked layer tree of ``cfg``'s family, each linear drawn by
    ``lin(ic, oc, bias)`` in the order wq, wk, wv, wo, gate, up, down (as
    ``awq_tpu/models/llama.py::init_params`` lays it out): a gate only for a
    SiLU MLP, no ``ln2`` under ``single_ln``, LayerNorm biases (zeros)
    for a LayerNorm with bias, and the linears' biases of ``qkv_bias``,
    ``attn_bias`` and ``mlp_bias`` (BLOOM: all)."""
    dt = _dtype(cfg)
    h, i = cfg.hidden_size, cfg.intermediate_size
    nq, nkv, hd, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    ln_bias = cfg.norm == "layernorm" and cfg.norm_bias
    norms = ("ln1",) if cfg.single_ln else ("ln1", "ln2")
    layers: Params = {n: torch.ones((L, h), dtype=dt, device=dev) for n in norms}
    if ln_bias:
        layers.update({n + "_b": torch.zeros((L, h), dtype=dt, device=dev) for n in norms})
    qkv_b, mlp_b = cfg.qkv_bias or cfg.attn_bias, cfg.mlp_bias
    layers.update(wq=lin(h, nq * hd, qkv_b), wk=lin(h, nkv * hd, qkv_b),
                  wv=lin(h, nkv * hd, qkv_b), wo=lin(nq * hd, h, cfg.attn_bias))
    if cfg.act == "silu":
        layers["gate"] = lin(h, i, mlp_b)
    layers.update(up=lin(h, i, mlp_b), down=lin(i, h, mlp_b))
    return layers


def pos_offset(cfg: ModelConfig) -> int:
    """The row of position 0 in a learned position table: 2 for OPT (its
    ``OPTLearnedPositionalEmbedding``), else 0 (JAX's ``off``)."""
    return 2 if cfg.arch == "opt" else 0


def _outer_norms(cfg: ModelConfig, dev: torch.device) -> Params:
    """``norm`` (and ``norm_b`` for a LayerNorm with bias) of the final norm,
    and BLOOM's embedding LayerNorm ``embed_ln_w``/``embed_ln_b`` (ones and
    zeros, as JAX's ``init_params``, ``awq_tpu/models/llama.py:95-97``)."""
    ones = lambda: torch.ones((cfg.hidden_size,), dtype=_dtype(cfg), device=dev)  # noqa: E731
    zeros = lambda: torch.zeros((cfg.hidden_size,), dtype=_dtype(cfg), device=dev)  # noqa: E731
    out = {"norm": ones()}
    if cfg.norm == "layernorm" and cfg.norm_bias:
        out["norm_b"] = zeros()
    if cfg.embed_ln:
        out.update(embed_ln_w=ones(), embed_ln_b=zeros())
    return out


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                scale: float = 0.02, device="cuda") -> Params:
    """Random fp parameters of a model of any supported family (tests and
    benchmarks; the generator must live on ``device``): the learned
    position table ``pos_embed`` ``[max_position_embeddings + 2, H]`` for
    OPT (``+ 0`` for GPT-BigCode), as JAX's ``init_params`` lays it out."""
    _check_supported(cfg)
    dev = _device.resolve(device)
    gen = _gen(generator, dev)
    dt = _dtype(cfg)
    h, L = cfg.hidden_size, cfg.num_layers

    def w(shape):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    def lin(ic, oc, bias):
        return Linear(w=w((L, ic, oc)),
                      b=torch.zeros((L, oc), dtype=dt, device=dev) if bias else None)

    layers = _family_layers(cfg, dev, lin)
    params: Params = {"embed": w((cfg.vocab_size, h)), "layers": layers,
                      **_outer_norms(cfg, dev)}
    if cfg.pos_embed == "learned":
        params["pos_embed"] = w((cfg.max_position_embeddings + pos_offset(cfg), h))
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((h, cfg.vocab_size))
    return params


def init_qparams(cfg: ModelConfig, qcfg: QuantConfig,
                 generator: Optional[torch.Generator] = None,
                 scale: float = 0.02, device="cuda") -> Params:
    """Random packed parameters, built directly in the packed layout on
    ``device`` (no fp intermediate), as the JAX ``init_qparams`` does for
    its benchmarks: random int32 code words, scales uniform in
    ``[0.5, 1.5) * scale / 4``, zero points at ``2**(w_bit - 1)``. W3 takes
    the true dense 3-bit layout (``pack_int3``, ``[L, IC*3//32, OC]``)
    where ``IC % 256 == 0``, so that a W3 model streams real W3 bytes, else
    3-bit codes in the nibble container. The head stays fp. The layer tree
    is the family's (:func:`init_params`': no gate for a GELU MLP, no
    ``ln2`` under ``single_ln``, LayerNorm biases); the JAX function lays
    out the llama tree for every family.

    ``group_size == -1`` is one group over each linear's own IC, as
    ``quantize_linear`` takes it. (The JAX function takes the hidden size
    for every linear, whose groups then do not cover ``down``'s IC when
    the intermediate size is not a multiple of it,
    ``awq_tpu/models/llama.py:157``.)"""
    _check_supported(cfg)
    if qcfg.w_bit not in (3, 4):
        raise ValueError(f"w_bit={qcfg.w_bit}: the packed layouts take 3 or 4")
    dev = _device.resolve(device)
    gen = _gen(generator, dev)
    dt = _dtype(cfg)
    h, L = cfg.hidden_size, cfg.num_layers

    def qlin(ic, oc, bias):
        g = ic if qcfg.group_size == -1 else qcfg.group_size
        dense3 = qcfg.w_bit == 3 and ic % 256 == 0
        rows = ic * 3 // 32 if dense3 else ic // 8
        qw = torch.randint(-(2**31), 2**31 - 1, (L, rows, oc),
                           generator=gen, dtype=torch.int32, device=dev)
        if qcfg.w_bit == 3 and not dense3:
            qw &= 0x77777777          # 3-bit codes in the nibble container
        s = (torch.rand((L, ic // g, oc), generator=gen, device=dev) + 0.5) * (scale / 4)
        z = torch.full_like(s, float(2 ** (qcfg.w_bit - 1))) * s
        return QLinear(qweight=qw, scales=s, szeros=z,
                       bias=torch.zeros((L, oc), dtype=dt, device=dev) if bias else None,
                       w_bit=qcfg.w_bit, group_size=g, dense3=dense3)

    layers = _family_layers(cfg, dev, qlin)
    params: Params = {
        "embed": (torch.randn((cfg.vocab_size, h), generator=gen, device=dev)
                  * scale).to(dt),
        "layers": layers,
        **_outer_norms(cfg, dev),
    }
    if cfg.pos_embed == "learned":
        params["pos_embed"] = (torch.randn((cfg.max_position_embeddings + pos_offset(cfg), h),
                                           generator=gen, device=dev) * scale).to(dt)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = (torch.randn((h, cfg.vocab_size), generator=gen,
                                         device=dev) * scale).to(dt)
    return params


def quantize_params(params: Params, qcfg: QuantConfig) -> Params:
    """Real-quantize every decoder-layer :class:`Linear` to a packed
    :class:`QLinear`, layer by layer (embed and head stay fp)."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in LAYER_LINEARS:
        lin = layers.get(name)
        if not isinstance(lin, Linear):
            continue
        qls = [quantize_linear(lin.w[l].float(), n_bit=qcfg.w_bit,
                               group_size=qcfg.group_size,
                               bias=None if lin.b is None else lin.b[l])
               for l in range(lin.w.shape[0])]
        layers[name] = QLinear(
            qweight=torch.stack([q.qweight for q in qls]),
            scales=torch.stack([q.scales for q in qls]),
            szeros=torch.stack([q.szeros for q in qls]),
            bias=None if lin.b is None else torch.stack([q.bias for q in qls]),
            w_bit=qls[0].w_bit, group_size=qls[0].group_size, dense3=qls[0].dense3,
        )
    out["layers"] = layers
    return out


def fuse_linears(params: Params, cfg: ModelConfig) -> Params:
    """Concatenate wq/wk/wv -> ``wqkv`` and gate/up -> ``wgateup`` along the
    output-channel axis: one K1 launch instead of three/two. A plain concat
    (no tiling or folding: those layouts exist only for the TPU); OC is the
    last axis of both packings, so it keeps either layout. The parts' int8
    prefill caches (``wq_w8`` ...), where every part has one, fuse the same
    way."""
    layers = dict(params["layers"])
    if "wq" not in layers:
        return params

    def cat(parts):
        a = parts[0]
        if isinstance(a, QLinear):
            return QLinear(
                qweight=torch.cat([p.qweight for p in parts], dim=-1),
                scales=torch.cat([p.scales for p in parts], dim=-1),
                szeros=torch.cat([p.szeros for p in parts], dim=-1),
                bias=(torch.cat([p.bias for p in parts], dim=-1)
                      if a.bias is not None else None),
                w_bit=a.w_bit, group_size=a.group_size, dense3=a.dense3)
        return Linear(w=torch.cat([p.w for p in parts], dim=-1),
                      b=(torch.cat([p.b for p in parts], dim=-1)
                         if a.b is not None else None))

    def fuse(name, parts):
        layers[name] = cat([layers.pop(p) for p in parts])
        # int8 prefill caches (W8Stack [L, OC, IC]) of every part fuse too
        caches = [layers.pop(p + "_w8", None) for p in parts]
        if all(c is not None for c in caches):
            layers[name + "_w8"] = W8Stack(w8=torch.cat([c.w8 for c in caches], dim=-2),
                                           scol=torch.cat([c.scol for c in caches], dim=-1))

    fuse("wqkv", ("wq", "wk", "wv"))
    if "gate" in layers:
        fuse("wgateup", ("gate", "up"))
    out = dict(params)
    out["layers"] = layers
    return out


def attach_prefill_w8(params: Params, cfg: ModelConfig, runtime) -> Tuple[Params, ModelConfig]:
    """The engines' ``RuntimeConfig.prefill_w8`` step (``awq_tpu/runtime/
    engine.py:88-102``, ``batch_engine.py:96-111``), after
    :func:`fuse_linears`: the fused tree with an int8 prefill weight cache
    per eligible linear (``attach_w8_caches``, within
    ``prefill_w8_budget_gb`` when it is set) and ``cfg`` with
    ``prefill_a8``."""
    budget = int(runtime.prefill_w8_budget_gb * 2**30) or None
    out = dict(params)
    out["layers"] = attach_w8_caches(params["layers"], budget_bytes=budget)
    return out, dataclasses.replace(cfg, prefill_a8=True)


def quantize_head(params: Params, cfg: ModelConfig) -> Params:
    """Real-quantize a plain fp ``lm_head`` to the body's ``w_bit`` and group
    size (a W3 head in ``pack_int3`` where its IC is a multiple of 256, as
    ``quantize_linear`` packs it). No-op unless the body is quantized and
    the head's IC is a multiple of the group size."""
    head = params.get("lm_head")
    if head is None or isinstance(head, QLinear):
        return params
    body = next((p for p in params["layers"].values()
                 if isinstance(p, QLinear)), None)
    if body is None or head.dim() != 2 or head.shape[0] % body.group_size:
        return params
    out = dict(params)
    out["lm_head"] = quantize_linear(head.float(), n_bit=body.w_bit,
                                     group_size=body.group_size)
    return out


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    """Preallocated static KV cache ``[L, 2, B, n_kv, T, hd]``, head-major so
    each head's ``[T, hd]`` slab is contiguous for the flash kernels."""
    dev = _device.resolve(device)
    return torch.zeros((cfg.num_layers, 2, batch, cfg.num_kv_heads, max_seq,
                        cfg.head_dim), dtype=dtype, device=dev)


class KVCache8(NamedTuple):
    """int8 KV cache (the JAX package's ``KVCache8``): half the bytes of a
    bf16 cache held and streamed, so a card holds twice the slots or the
    context. ``data`` int8 ``[L, 2, B, n_kv, T, hd]``, ``scales`` f32
    ``[L, 2, B, n_kv, T]``: position ``t`` of a (layer, k|v, row, head) is
    ``f32(data[..., t, :]) * scales[..., t]`` (:func:`quantize_kv`)."""

    data: torch.Tensor
    scales: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.data.device


Cache = Union[torch.Tensor, KVCache8]


def init_kv_cache8(cfg: ModelConfig, batch: int, max_seq: int,
                   device="cuda") -> KVCache8:
    """A zeroed :class:`KVCache8` of ``batch`` rows and ``max_seq``
    positions."""
    dev = _device.resolve(device)
    L, nkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    return KVCache8(
        data=torch.zeros((L, 2, batch, nkv, max_seq, hd), dtype=torch.int8, device=dev),
        scales=torch.zeros((L, 2, batch, nkv, max_seq), dtype=torch.float32, device=dev))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda") -> Cache:
    """A zeroed cache of ``dtype``: a :class:`KVCache8` for ``"int8"`` (or
    ``torch.int8``), else a float tensor (:func:`init_kv_cache`)."""
    if dtype in ("int8", torch.int8):
        return init_kv_cache8(cfg, batch, max_seq, device=device)
    return init_kv_cache(cfg, batch, max_seq, dtype, device=device)


def cache_tensors(cache: Cache) -> Tuple[torch.Tensor, ...]:
    """The tensors a cache holds: ``(data, scales)`` or ``(cache,)``."""
    return tuple(cache) if isinstance(cache, KVCache8) else (cache,)


def cache_seq_len(cache: Cache) -> int:
    """T of either a plain tensor cache or a :class:`KVCache8`."""
    return (cache.data if isinstance(cache, KVCache8) else cache).shape[4]


def params_to(params: Params, device) -> Params:
    """The parameter tree with every tensor on ``device``."""
    dev = torch.device(device)

    def mv(x):
        if isinstance(x, dict):
            return {k: mv(v) for k, v in x.items()}
        if isinstance(x, QLinear):
            return QLinear(qweight=mv(x.qweight), scales=mv(x.scales),
                           szeros=mv(x.szeros), bias=mv(x.bias),
                           w_bit=x.w_bit, group_size=x.group_size, dense3=x.dense3)
        if isinstance(x, Linear):
            return Linear(w=mv(x.w), b=mv(x.b))
        if isinstance(x, W8Stack):
            return W8Stack(w8=mv(x.w8), scol=mv(x.scol))
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    return mv(params)


def _check_supported(cfg: ModelConfig) -> None:
    """The llama family (RMSNorm, SwiGLU, sequential block), falcon
    (LayerNorm with or without bias, exact GELU, the parallel block with one
    or two norms, MQA or grouped QKV), both with rope over the whole head;
    MPT (ALiBi, LayerNorm without bias, exact GELU, sequential block),
    BLOOM (ALiBi, ``embed_ln``, LayerNorm with bias, the tanh GELU,
    ``attn_bias`` and ``mlp_bias``, sequential block), OPT (learned
    positions from row 2, LayerNorm with bias, ReLU, biases, pre-LN only:
    OPT-350m's ``do_layer_norm_before=False`` is refused, which the JAX
    config parses and no JAX code reads), GPT-BigCode (learned positions,
    LayerNorm with bias, the tanh GELU, biases, MQA or MHA) and GPT-NeoX
    (rope over ``rotary_pct`` of the head, LayerNorm with bias, exact GELU,
    biases, the parallel block with two norms or the sequential one). The
    new three take head_dim 64 or 128 (the kernels'). Everything else
    raises, naming ROADMAP A12."""
    family = "other decoder families are ROADMAP queue A, item 12"
    if cfg.arch not in SUPPORTED_ARCHS:
        raise NotImplementedError(f"arch {cfg.arch!r}: {family}")
    pos, norm, act, embed_ln, biased = _FAMILY[cfg.arch]
    for bad, what in (
        (cfg.pos_embed != pos, f"pos_embed={cfg.pos_embed!r}"),
        (cfg.norm != norm, f"norm={cfg.norm!r}"),
        (cfg.act != act, f"act={cfg.act!r}"),
        (cfg.arch not in ("falcon", "neox") and cfg.parallel_block, "parallel_block"),
        (cfg.arch != "falcon" and cfg.single_ln, "single_ln"),
        (cfg.embed_ln != embed_ln, f"embed_ln={cfg.embed_ln}"),
        (cfg.attn_bias != biased or cfg.mlp_bias != biased,
         f"attention/MLP bias {cfg.attn_bias}/{cfg.mlp_bias}"),
        (cfg.arch == "mpt" and cfg.norm_bias, "LayerNorm bias (MPT no_bias=False)"),
        (cfg.arch in STACKED_ARCHS and not cfg.norm_bias, "LayerNorm without bias"),
        (cfg.rotary_pct != 1.0 and cfg.arch != "neox", "partial rotary (rotary_pct)"),
        (not cfg.do_layer_norm_before, "post-LN (do_layer_norm_before=False, OPT-350m)"),
        (cfg.arch in STACKED_ARCHS and cfg.head_dim not in _KERNEL_HEAD_DIMS,
         f"head_dim {cfg.head_dim} (the kernels take 64 and 128; GPT-NeoX-20B's 96)"),
    ):
        if bad:
            raise NotImplementedError(f"{cfg.arch}: {what}: {family}")


def check_llama_family(cfg: ModelConfig, what: str) -> None:
    """The tensor-parallel paths take the llama family only: the layer body
    of K12/K13 and the deploy layout are the llama block's, and JAX's ALiBi
    paged step refuses a TP axis (``awq_tpu/models/llama.py:1625``). Every
    family takes the batched, paged and int8-KV paths."""
    if cfg.arch not in LLAMA_ARCHS:
        raise NotImplementedError(
            f"{what} of a {cfg.arch} model: the family's tensor-parallel paths are "
            "ROADMAP queue A, item 17b")


def _norm(cfg: ModelConfig, x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, weight, cfg.rms_eps)
    return layer_norm(x, weight, bias, cfg.rms_eps)


_ROPE: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_SLOPES: Dict[tuple, torch.Tensor] = {}


def _slopes(cfg: ModelConfig, dev: torch.device) -> Optional[torch.Tensor]:
    """The ALiBi slopes ``[nq]`` f32 on ``dev`` (built once per device and
    head count), or None for a rope model."""
    if cfg.pos_embed != "alibi":
        return None
    key = (cfg.num_heads, str(dev))
    if key not in _SLOPES:
        _SLOPES[key] = alibi_slopes(cfg.num_heads, device=dev)
    return _SLOPES[key]


def _embed_ln(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    """BLOOM's ``word_embeddings_layernorm`` on the embedding output (JAX's
    ``_embed_ln``, ``awq_tpu/models/llama.py:422-429``); ``h`` otherwise."""
    if not cfg.embed_ln:
        return h
    return layer_norm(h, params["embed_ln_w"], params.get("embed_ln_b"), cfg.rms_eps)


def _rope_cached(cfg: ModelConfig, t: int, dev: torch.device):
    """The rope tables for ``t`` positions, built once per device and
    geometry: a megakernel step then reads its rows as free views."""
    key = (cfg.head_dim, cfg.rotary_pct, cfg.rope_theta, cfg.rope_scaling,
           t, str(dev))
    if key not in _ROPE:
        _ROPE[key] = rope_table(cfg, t, device=dev)
    return _ROPE[key]


def _mlp_in(layers: Params, shape: str):
    """K4's first MLP stack: ``wgateup``, or the MPT shape's ``up``."""
    return layers["up"] if shape == "mpt" else layers["wgateup"]


def _megakernel_forward(params, cfg, h, cache, start_pos, plain):
    """The megakernel path: ``(h [1, S, H], logits or None)``."""
    la = params["layers"]
    s = h.shape[1]
    shape = mk.model_shape(cfg)
    args = (la["wqkv"], la["wo"], _mlp_in(la, shape), la["down"], la["ln1"], la["ln2"])
    kw = dict(nq=cfg.num_heads, nkv=cfg.num_kv_heads, eps=cfg.rms_eps)
    if s == 1:
        fn = mk.w4a16_llama_token_step_plain if plain else mk.w4a16_llama_token_step
        if mk.head_in_kernel(params):
            kw.update(whead=params["lm_head"], norm_w=params["norm"])
        if isinstance(cache, KVCache8):
            cache, kw["cache_scales"] = cache
        rows = (None, None)         # the MPT shape reads no rope
        if shape == "llama":
            cos, sin = _rope_cached(cfg, cache_seq_len(cache), cache.device)
            rows = (cos[start_pos], sin[start_pos])
        res = fn(h[0], *args, *rows, cache, start_pos, shape=shape, **kw)
        return res[0][None], (res[3][:, None, :] if len(res) == 4 else None)
    cos, sin = _rope_cached(cfg, cache_seq_len(cache), cache.device)
    fn = mkc.w4a16_llama_chunk_step_plain if plain else mkc.w4a16_llama_chunk_step
    res = fn(h[0], *args, cos[start_pos:start_pos + s], sin[start_pos:start_pos + s],
             cache, start_pos, **kw)
    return res[0][None], None


def _embed_lookup(params: Params, cfg: ModelConfig, ids: torch.Tensor, dt,
                  tp_axis) -> torch.Tensor:
    """Token embedding lookup. Under tensor parallelism with a vocab-sharded
    table (``awq_tpu/models/llama.py:432-446``): a lookup of the ids in this
    rank's rows, zeros for the others, then an all-reduce over the group."""
    emb = params["embed"]
    if tp_axis is not None and emb.shape[0] != cfg.vocab_size:
        shard = emb.shape[0]
        loc = ids - tp_axis.rank * shard
        ok = (loc >= 0) & (loc < shard)
        h = torch.where(ok[..., None], emb[loc.clamp(0, shard - 1)], emb.new_zeros(()))
        return tp_axis.all_reduce(h.contiguous()).to(dt)
    return emb[ids].to(dt)


def _embed(params: Params, cfg: ModelConfig, ids: torch.Tensor, positions: torch.Tensor,
           tp_axis=None) -> torch.Tensor:
    """The decoder's input in the model dtype: the token embedding, BLOOM's
    embedding norm, then for learned positions (OPT, GPT-BigCode) the
    table's row of each position cast to the model dtype and added, JAX's
    rounding point (``awq_tpu/models/llama.py:638-641``, :1080-1082,
    :1545-1547). ``positions`` broadcasts against ``ids`` (a range, the
    rows' lengths, or :func:`decode_step`'s position read on the device);
    a row past the table is clamped to its last, as JAX's gather clamps."""
    dt = _dtype(cfg)
    h = _embed_ln(cfg, params, _embed_lookup(params, cfg, ids, dt, tp_axis))
    if cfg.pos_embed == "learned":
        table = params["pos_embed"]
        rows = (positions.long() + pos_offset(cfg)).clamp(0, table.shape[0] - 1)
        h = h + table[rows].to(dt)
    return h


def _tp_halves_forward(params, cfg, h, cache, start_pos, plain, tp_axis):
    """One token through every layer on K12 and K13, per layer in JAX's
    rounding order (``awq_tpu/models/llama.py:778-830``): ``h1 = f32(h) +
    all_reduce(o_part)``, ``h = dtype(h1 + all_reduce(m_part))``. The
    kernels write each layer's k/v into the rank's cache in place."""
    la = params["layers"]
    data, scales = mk.split_cache(cache)
    cos, sin = _rope_cached(cfg, data.shape[4], data.device)
    attn = mtp.w4a16_llama_attn_half_plain if plain else mtp.w4a16_llama_attn_half
    mlp = mtp.w4a16_llama_mlp_half_plain if plain else mtp.w4a16_llama_mlp_half
    kw = dict(nq=cfg.num_heads, nkv=cfg.num_kv_heads, eps=cfg.rms_eps, cache_scales=scales)
    hrow = h[0]
    for l in range(cfg.num_layers):
        o_part = attn(hrow, la["wqkv"], la["wo"], la["ln1"], cos[start_pos], sin[start_pos],
                      data, l, start_pos, **kw)[0]
        h1 = hrow.float() + tp_axis.all_reduce(o_part)
        m_part = mlp(h1, la["wgateup"], la["down"], la["ln2"], l, eps=cfg.rms_eps)
        hrow = (h1 + tp_axis.all_reduce(m_part)).to(h.dtype)
    return hrow[None]


def _use_tp_halves(cfg, layers, cache, b: int, s: int) -> bool:
    """``forward``'s gate of K12/K13 under ``tp_axis`` (JAX's ``use_tpmega``)."""
    dev = cache.device
    return (s == 1 and b == 1
            and (dev.type == "cuda" or mk._env("AWQ_TPU_TP_MEGAKERNEL"))
            and not mk._env("AWQ_TPU_DISABLE_MEGAKERNEL")
            and mtp.tp_megakernel_supported(cfg, layers, cache))


def _head_logits(params: Params, h: torch.Tensor, impl: str) -> torch.Tensor:
    """Final-normed hidden states -> f32 logits (tied embedding, quantized
    head or fp matrix)."""
    head = params.get("lm_head")
    if head is None:
        return torch.matmul(h.float(), params["embed"].float().T)
    if isinstance(head, QLinear):
        if head.qweight.dim() != 2:
            raise ValueError("lm_head QLinear must be 2-D [rows, OC]")
        return qlinear_apply(head, h, impl=impl).float()
    return torch.matmul(h.float(), head.float())


@torch.no_grad()
def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,       # [B, S] token ids
    cache: Cache,               # [L, 2, B, n_kv, T, hd] or a KVCache8, in place
    start_pos: int,             # the chunk occupies [start_pos, start_pos+S)
    last_only: bool = True,
    impl: str = "auto",
    tp_axis=None,
) -> Tuple[torch.Tensor, Cache]:
    """Run the decoder; returns ``(logits f32, cache)``.

    ``cache`` is updated IN PLACE at ``[start_pos, start_pos + S)`` and
    returned for symmetry with the JAX API. ``last_only=True`` computes the
    final position's logits only (``[B, 1, V]``), else ``[B, S, V]``.

    ``impl="auto"`` runs the kernels' wrappers: the hand kernels on a CUDA
    device, their plain versions on the CPU. ``impl="plain"`` runs the
    plain versions on any device; it is the reference the kernel path is
    held to on the card, and slower.

    ``tp_axis``: this rank's :class:`~awq_tpu_torch.parallel.mesh.TPGroup`
    when ``params``/``cache`` are its tensor-parallel shards and ``cfg`` the
    local config; the logits are then this rank's vocab slice ``[B, S,
    V/tp]`` (``parallel/tp.py::tp_forward`` gathers them).
    """
    _check_supported(cfg)
    _check_cache(cache)
    if tp_axis is not None:
        check_llama_family(cfg, "forward under tensor parallelism")
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', not {impl!r}")
    start_pos = int(start_pos)
    b, s = tokens.shape
    dt = _dtype(cfg)
    dev = cache.device
    t_max = cache_seq_len(cache)
    if start_pos + s > t_max:
        raise ValueError(f"chunk [{start_pos}, {start_pos + s}) exceeds the "
                         f"cache length {t_max}")
    layers = params["layers"]
    h = _embed(params, cfg, tokens.to(dev), torch.arange(start_pos, start_pos + s, device=dev),
               tp_axis)
    if tp_axis is not None:
        # Megatron TP: no whole-model megakernel (its layers leave no room
        # for the all-reduces); the halves at batch-1 decode, else stacked
        if _use_tp_halves(cfg, layers, cache, b, s):
            h = _tp_halves_forward(params, cfg, h, cache, start_pos, impl == "plain",
                                   tp_axis)
        else:
            h = stacked_layers(params, cfg, h, cache, start_pos, impl, tp_axis=tp_axis)
    elif b == 1 and ((s == 1 and mk.megakernel_supported(cfg, layers, cache)) or (
            s > 1 and mkc.chunk_megakernel_supported(cfg, layers, cache, s))):
        # the new k/v are written inside the kernel: no append here
        h, logits = _megakernel_forward(params, cfg, h, cache, start_pos,
                                        impl == "plain")
        if logits is not None:
            return logits, cache
    else:
        h = stacked_layers(params, cfg, h, cache, start_pos, impl)

    if last_only:
        h = h[:, -1:, :]
    h = _norm(cfg, h, params["norm"], params.get("norm_b"))
    return _head_logits(params, h, impl), cache


def stacked_layers(params: Params, cfg: ModelConfig, h: torch.Tensor,
                   cache: Cache, start_pos: int, impl: str = "auto",
                   layer_ids=None, lengths: Optional[torch.Tensor] = None,
                   max_length: Optional[int] = None,
                   tables: Optional[torch.Tensor] = None, tp_axis=None,
                   one_position: bool = False) -> torch.Tensor:
    """The stacked per-kernel path over ``h [B, S, H]`` for the layers
    ``layer_ids`` (all by default): returns the new residual and writes
    each layer's k/v into the cache in place.

    Decode (``S == 1``) takes K2 per layer with the current token as an
    operand, and the same launch appends it to the layer's cache after its
    attention (K7's write, fused: no stacking of the layers' k/v and no
    launch of its own); the plain path attends, then appends (JAX writes
    after its layer scan, which is the same, a layer reading only its own
    cache). Over a :class:`KVCache8` K9 takes K2's place, the current token
    in full precision, its append quantized; prefill quantizes the chunk
    into the cache, then runs K3 over the layer's dequantized prefix ``[0,
    start_pos + S)``.

    With ``lengths [B]`` (int32 on the cache's device; ``S == 1``) row ``b``
    decodes at its own position ``lengths[b]`` and ``start_pos`` is not
    read: per-row rope rows, K2 over the per-row prefixes, each row's
    append at its own position. ``max_length`` (at least ``lengths.max()``,
    from the caller's host copy) sizes K2's grid without a device sync. With
    ``tables [B, MP]`` as well, ``cache`` is a page pool and K8 takes K2's
    place, appending into the rows' pages. With ``lengths`` and ``S > 1``
    (``verify_step_batched``, no ``tables``) row ``b``'s window of S tokens
    sits at ``lengths[b] + [0, S)``: the window mode of K2 (K9 over an int8
    cache) attends its prefix and its causal window, the window in full
    precision, and appends the window after its attention, where JAX
    appends after its layer scan (over int8, quantized then); the linears
    stay W4A16 under ``cfg.prefill_a8``, as JAX's verify step.
    ``one_position`` says every row sits at ``lengths[0]``
    (``decode_step``): K2 and K9 then split by the length they read, and
    where K2 cannot take the heads K14 reads that length on the device and
    splits by it; ``max_length`` only sizes their grids. With ``tp_axis``
    (a rank's shards under tensor parallelism) the row-parallel ``wo`` and
    ``down`` end in an all-reduce of their partial sums, their bias added
    once after it
    (``_lin_row_fn``, ``awq_tpu/models/llama.py:463-494``).

    An ALiBi or learned-position model (MPT, BLOOM; OPT, GPT-BigCode) runs
    no rope, and an ALiBi model's every attention call takes its slopes:
    K2, K8, K9, K3, and K14 in the single-position
    fallback (``layers.attention``, or the device-position call). Falcon's
    and BLOOM's per-row steps take K2, K8 and K9 at head_dim 64 (Falcon-7B's
    71 q heads over one kv head); their single-position step keeps K14.

    Over an int8 cache an ALiBi model's single-position step (``lengths`` is
    None, or ``one_position``) follows JAX's ``forward``, which sends an
    int8 ALiBi cache to XLA attention (``use_flash`` is false there,
    ``awq_tpu/models/llama.py:681``): the current token is quantized into
    the cache first and attended at its dequantized value (:900-947). K9
    then takes ``dequantize_kv(quantize_kv(k))`` as its current token: the
    same scores and weights as attending the written row, while its append
    quantizes the full-precision k/v (``k_app``, ``v_app``), so the codes
    are the quantize-first order's. The per-row batched step follows JAX's
    ``decode_step_batched``, whose XLA attention takes the current token in
    full precision (``xla_attn``, :1198-1224, :1262-1267), as every rope
    family's K9 step does."""
    b, s = h.shape[:2]
    dt = _dtype(cfg)
    dev = cache.device
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    layers = params["layers"]
    plain = impl == "plain"
    q8 = isinstance(cache, KVCache8)
    decode = flash_decode_append_plain if plain else flash_decode
    decode8 = flash_decode_int8_append_plain if plain else flash_decode_int8
    decode_paged = flash_decode_paged_append_plain if plain else flash_decode_paged
    prefill = flash_prefill_plain if plain else flash_prefill
    verify = flash_verify_append_plain if plain else flash_verify
    verify8 = flash_verify_int8_append_plain if plain else flash_verify_int8
    slopes = _slopes(cfg, dev)
    rope = cfg.pos_embed == "rope"      # ALiBi and learned positions run none

    # the int8-activation prefill (cfg.prefill_a8): K11 over a layer's
    # int8 cache (``<name>_w8``), else K10; decode and the verify windows
    # stay W4A16, as in the JAX package
    a8 = s > 1 and cfg.prefill_a8 and lengths is None

    def lin(name, idx, xx, with_bias=True):
        p = layers[name]
        if isinstance(p, QLinear):
            if not with_bias:
                p = dataclasses.replace(p, bias=None)
            return qlinear_apply_stacked(p, idx, xx, impl=impl, a8=a8,
                                         w8stack=layers.get(name + "_w8") if a8 else None)
        b = p.b[idx] if with_bias and p.b is not None else None
        return linear_apply(Linear(w=p.w[idx], b=b), xx)

    def lin_row(name, idx, xx):
        """A row-parallel linear: each rank's partial sum over its input
        channels, summed over the group; the (replicated) bias once."""
        if tp_axis is None:
            return lin(name, idx, xx)
        p = layers[name]
        bias = p.bias if isinstance(p, QLinear) else p.b
        out = tp_axis.all_reduce(lin(name, idx, xx, with_bias=False).contiguous())
        return out if bias is None else out + bias[idx].to(out.dtype)

    if lengths is None:
        if rope:
            cos, sin = rope_table(cfg, start_pos + s, device=dev)
            positions = torch.arange(start_pos, start_pos + s, device=dev)
        row_lengths = torch.full((b,), start_pos, dtype=torch.int32, device=dev)
        max_length = start_pos
    else:
        t_max = cache_seq_len(cache) * (1 if tables is None else tables.shape[1])
        if rope:
            cos, sin = _rope_cached(cfg, t_max, dev)
            # row b's positions lengths[b] + [0, S), clamped to the table
            # as JAX's gather clamps them (a freed slot's stale length)
            positions = (lengths.long()[:, None] + torch.arange(s, device=dev)).clamp(
                0, t_max - 1)
        row_lengths = lengths

    # where K2 cannot take the shape, a single-position step at one shared
    # position writes its k/v and attends over the layer's cache
    # (layers.attention: K14, which launches or raises on the card), as
    # JAX's forward does (models/llama.py:938-978); with ``lengths`` and
    # ``one_position`` (every row at ``lengths[0]``, K14 takes one length)
    # the position is read on the device
    single = lengths is None or one_position
    fallback = (s == 1 and single and not q8 and tables is None
                and not flash_decode_supported(nq, nkv, hd, cache.dtype))
    quantize_first = q8 and single and slopes is not None
    # decode_step's device position: K2 and K9 split by the length they read
    # (K14 does so for its device length), so that a captured step gives the
    # bits of the step planned for that length on the host
    by_length = {"by_length": True} if one_position and lengths is not None and not plain \
        else {}

    def at(name, idx):
        t = layers.get(name)
        return None if t is None else t[idx]

    for idx in (range(cfg.num_layers) if layer_ids is None else layer_ids):
        # [2, B, n_kv, T, hd] (or [2, NP, ...]) view; int8 codes and scales
        kv, kv_s = (cache.data[idx], cache.scales[idx]) if q8 else (cache[idx], None)
        x = _norm(cfg, h, layers["ln1"][idx], at("ln1_b", idx))
        if "wqkv" in layers:
            q, k, v = torch.split(lin("wqkv", idx, x), [nq * hd, nkv * hd, nkv * hd], dim=-1)
        else:
            q, k, v = lin("wq", idx, x), lin("wk", idx, x), lin("wv", idx, x)
        q = q.reshape(b, s, nq, hd)
        k = k.reshape(b, s, nkv, hd)
        v = v.reshape(b, s, nkv, hd)
        if rope:
            q, k = apply_rope(q, k, cos, sin, positions)
        if fallback and lengths is not None:
            kv.index_copy_(3, lengths[:1].long(),
                           torch.stack([k, v]).transpose(2, 3).to(kv.dtype))
            n_att = lengths[:1] + 1
            if plain:
                attn = flash_decode_layer_plain(q[:, 0], kv[0], kv[1], int(n_att), slopes)
            else:
                attn = flash_decode_layer(q[:, 0].contiguous(), kv[0], kv[1], n_att,
                                          max_length=max_length + 1, slopes=slopes)
            attn = attn.reshape(b, 1, nq * hd)
        elif fallback:
            update_kv_cache(kv, k, v, start_pos)
            if plain:
                attn = flash_decode_layer_plain(q[:, 0], kv[0], kv[1], start_pos + 1, slopes)
            else:
                attn = attention(q, kv[0], kv[1], start_pos, slopes=slopes)
            attn = attn.reshape(b, 1, nq * hd)
        elif s == 1:
            # the current token rides as an operand, and the launch appends
            # it to the layer's cache after attending (over an int8 cache in
            # full precision: the append quantizes it)
            q1 = q[:, 0].contiguous()
            if q8:
                k1, v1 = k[:, 0].contiguous(), v[:, 0].contiguous()
                ka, va = k1, v1
                if quantize_first:
                    ka, va = (dequantize_kv(*quantize_kv(x), dt) for x in (k1, v1))
                attn = decode8(q1, ka, va, kv, kv_s, row_lengths, max_length=max_length,
                               slopes=slopes, k_app=k1, v_app=v1, **by_length)
            else:
                k1, v1 = k[:, 0].to(kv.dtype).contiguous(), v[:, 0].to(kv.dtype).contiguous()
                if tables is None:
                    attn = decode(q1, k1, v1, kv, row_lengths, max_length=max_length,
                                  slopes=slopes, **by_length)
                else:
                    attn = decode_paged(q1, k1, v1, cache, tables, idx, row_lengths,
                                        max_length=max_length, slopes=slopes)
            attn = attn.reshape(b, 1, nq * hd)
        elif lengths is not None:
            # a verify window a row (verify_step_batched): the window mode of
            # K2 (K9 over an int8 cache) attends each row's prefix and its
            # causal window in full precision, then appends the window
            attn = (verify8(q.contiguous(), k.contiguous(), v.contiguous(), kv, kv_s,
                            row_lengths, max_length=max_length) if q8 else
                    verify(q.contiguous(), k.contiguous(), v.contiguous(), kv, row_lengths,
                           max_length=max_length)).reshape(b, s, nq * hd)
        elif q8:
            # quantize and write the chunk, then attend over the dequantized
            # prefix, the chunk's own quantized positions included
            end = start_pos + s
            kq, ks = quantize_kv(torch.stack([k, v]).transpose(2, 3))   # [2, B, n_kv, S, *]
            kv[:, :, :, start_pos:end], kv_s[:, :, :, start_pos:end] = kq, ks
            attn = prefill(q.contiguous(), dequantize_kv(kv[:, :, :, :end],
                                                         kv_s[:, :, :, :end], dt), start_pos,
                           slopes)
        else:
            update_kv_cache(kv, k, v, start_pos)
            attn = prefill(q.contiguous(), kv, start_pos, slopes)
        attn_out = lin_row("wo", idx, attn.to(dt))
        if cfg.parallel_block:
            # falcon: both branches read norms of the same input (falcon-7b
            # one norm, single_ln) and sum into one residual
            xm = x if cfg.single_ln else _norm(cfg, h, layers["ln2"][idx], at("ln2_b", idx))
        else:
            h = h + attn_out
            xm = _norm(cfg, h, layers["ln2"][idx], at("ln2_b", idx))
        if cfg.act != "silu":
            hm = activation(lin("up", idx, xm), cfg.act, at("act_scale", idx))
        else:
            if "wgateup" in layers:
                g, u = torch.chunk(lin("wgateup", idx, xm), 2, dim=-1)
            else:
                g, u = lin("gate", idx, xm), lin("up", idx, xm)
            hm = torch.nn.functional.silu(g.float()).to(dt) * u
        m = lin_row("down", idx, hm)
        h = h + attn_out + m if cfg.parallel_block else h + m
    return h


def decode_step_on_k4(params: Params, cfg: ModelConfig, cache: Cache, b: int) -> bool:
    """Whether :func:`decode_step` of ``b`` rows takes K4 (else the stacked
    path); the environment's ``AWQ_TPU_DISABLE_MEGAKERNEL`` counts."""
    return b == 1 and mk.megakernel_supported(cfg, params["layers"], cache)


@torch.no_grad()
def decode_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,       # [B] one token per row
    cache: Cache,               # [L, 2, B, n_kv, T, hd] or a KVCache8, in place
    pos: torch.Tensor,          # [1] int32 on the cache's device: the position
    max_length: int,            # host bound on pos (a length bucket)
    impl: str = "auto",
) -> torch.Tensor:
    """One single-stream decode step whose position lives in device memory:
    every row feeds its token at ``pos`` (the rows of one dialogue, as
    :func:`forward` with ``S == 1`` at ``start_pos = pos``), and the logits
    ``[B, V]`` f32 come back. Nothing is read back to the host, so the step
    can be captured into a CUDA graph and replayed at every position
    (``runtime/generate.py``): the rope rows are gathered on the device, the
    k/v written in place at ``pos``. ``pos`` itself is not advanced.

    ``max_length`` (at least ``pos``, below the cache length) bounds the
    position. K4 (batch 1 under
    :func:`~awq_tpu_torch.ops.megakernel.megakernel_supported`) splits its
    attention by the position it reads, so its step gives the bits of
    :func:`forward`'s at that position; ``max_length`` sizes its workspace.
    So do the stacked path's attention kernels, K2 (K9 over an int8 cache),
    each appending its layer's token, or K14 where K2 cannot take the heads (falcon,
    StarCoder, BLOOM): their grids are planned for ``max_length`` and each
    splits by the length it reads, as :func:`forward` plans that length on
    the host. ``impl`` as in :func:`forward`; the plain versions read
    ``pos`` on the host."""
    _check_supported(cfg)
    _check_cache(cache)
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', not {impl!r}")
    dev = cache.device
    b = tokens.shape[0]
    t_max = cache_seq_len(cache)
    max_length = int(max_length)
    if not 0 <= max_length < t_max:
        raise ValueError(f"max_length {max_length} outside the cache [0, {t_max})")
    if pos.dtype != torch.int32 or pos.numel() != 1 or pos.device != dev:
        raise ValueError(f"pos must be one int32 on {dev}, got {pos.dtype} "
                         f"{tuple(pos.shape)} on {pos.device}")
    plain = impl == "plain"
    h = _embed(params, cfg, tokens.to(dev), pos)   # [B, H]
    if decode_step_on_k4(params, cfg, cache, b):
        la = params["layers"]
        shape = mk.model_shape(cfg)
        cos = sin = None            # the MPT shape reads no rope
        if shape == "llama":
            cos, sin = _rope_cached(cfg, t_max, dev)
        kw = dict(nq=cfg.num_heads, nkv=cfg.num_kv_heads, eps=cfg.rms_eps, shape=shape)
        if mk.head_in_kernel(params):
            kw.update(whead=params["lm_head"], norm_w=params["norm"])
        data, kw["cache_scales"] = mk.split_cache(cache)
        args = (h, la["wqkv"], la["wo"], _mlp_in(la, shape), la["down"], la["ln1"],
                la["ln2"])
        if plain:
            at = int(pos)
            rows = (None, None) if cos is None else (cos[at], sin[at])
            res = mk.w4a16_llama_token_step_plain(*args, *rows, data, at, **kw)
        else:
            res = mk.w4a16_llama_token_step(*args, cos, sin, data, pos,
                                            max_length=max_length, **kw)
        if len(res) == 4:
            return res[3]
        h = res[0]
    else:
        h = stacked_layers(params, cfg, h[:, None], cache, 0, impl,
                           lengths=pos.expand(b).contiguous(), max_length=max_length,
                           one_position=True)[:, 0]
    h = _norm(cfg, h, params["norm"], params.get("norm_b"))
    return _head_logits(params, h, impl)


def _check_cache(cache) -> None:
    """A cache is a float tensor or a :class:`KVCache8`; a bare int8 tensor
    has lost its scales."""
    if isinstance(cache, KVCache8):
        return
    if not isinstance(cache, torch.Tensor):
        raise TypeError(f"the cache must be a tensor or a KVCache8, got "
                        f"{type(cache).__name__}")
    if cache.dtype == torch.int8:
        raise TypeError("a bare int8 cache tensor: the int8 KV cache is a KVCache8 "
                        "of codes and scales (init_kv_cache8)")


def _check_step(cfg: ModelConfig, cache, impl: str, tp_axis) -> None:
    """What the batched, paged and verify steps refuse."""
    _check_supported(cfg)
    if tp_axis is not None:
        raise NotImplementedError(
            "the batched, paged and verify steps under tensor parallelism (tp_axis) are "
            "ROADMAP queue A, item 17b")
    _check_cache(cache)
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', not {impl!r}")


@torch.no_grad()
def decode_step_batched(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,       # [B] one token per row
    cache: Cache,               # [L, 2, B, n_kv, T, hd] or a KVCache8, in place
    lengths: torch.Tensor,      # [B] int32 per-row lengths (write positions)
    impl: str = "auto",
    max_length: Optional[int] = None,
    tp_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, Cache]:
    """One decode step with PER-ROW positions, the continuous-batching
    step: returns ``(logits [B, V] f32, cache)``. Row ``b`` reads its cache
    prefix ``[0, lengths[b])`` and writes its k/v at ``lengths[b]``, in
    place. ``lengths`` lives on the cache's device; ``max_length`` (at
    least ``lengths.max()``) comes from the caller's host copy, so that no
    step syncs to read it (without it the wrappers read it from the
    device). ``impl`` as in :func:`forward`."""
    _check_step(cfg, cache, impl, tp_axis)
    dev = cache.device
    b = tokens.shape[0]
    data, scales = mk.split_cache(cache)
    if data.shape[2] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"{b} tokens need a cache of {b} slots and lengths "
                         f"[{b}], got {tuple(data.shape)} and {tuple(lengths.shape)}")
    lengths = lengths.to(device=dev, dtype=torch.int32)
    layers = params["layers"]
    h = _embed(params, cfg, tokens.to(dev), lengths)   # [B, H]
    if mkb.megakernel_batched_supported(cfg, layers, cache, b):
        fn = (mkb.w4a16_llama_token_step_batched_plain if impl == "plain"
              else mkb.w4a16_llama_token_step_batched)
        cos, sin = _rope_cached(cfg, data.shape[4], dev)
        rows = lengths.long().clamp(0, data.shape[4] - 1)
        kw = dict(nq=cfg.num_heads, nkv=cfg.num_kv_heads, eps=cfg.rms_eps,
                  max_length=max_length, cache_scales=scales)
        if mk.head_in_kernel(params):
            kw.update(whead=params["lm_head"], norm_w=params["norm"])
        # the rows' k/v are written inside the kernel: no append here
        res = fn(h, layers["wqkv"], layers["wo"], layers["wgateup"],
                 layers["down"], layers["ln1"], layers["ln2"], cos[rows],
                 sin[rows], data, lengths, **kw)
        if len(res) == 4:
            return res[3], cache
        h = res[0]
    else:
        h = stacked_layers(params, cfg, h[:, None], cache, 0, impl,
                           lengths=lengths, max_length=max_length)[:, 0]
    h = _norm(cfg, h, params["norm"], params.get("norm_b"))
    return _head_logits(params, h, impl), cache


@torch.no_grad()
def verify_step_batched(
    params: Params,
    cfg: ModelConfig,
    windows: torch.Tensor,      # [B, W] ids: [current token, d1..d_{W-1}]
    cache: Cache,               # [L, 2, B, n_kv, T, hd] or a KVCache8, in place
    lengths: torch.Tensor,      # [B] int32 per-row lengths (the window's first position)
    impl: str = "auto",
    max_length: Optional[int] = None,
    tp_axis=None,
) -> Tuple[torch.Tensor, Cache]:
    """One speculative VERIFY step for a batch (``awq_tpu/models/llama.py:
    1345``): row ``b``'s window of W tokens forwards at positions
    ``lengths[b] + [0, W)``, reading its cache prefix ``[0, lengths[b])``,
    and the logits of every position come back, ``[B, W, V]`` f32. The
    window's k/v are written into the cache in place at those positions
    (clamped to ``T - W`` as JAX's ``dynamic_update_slice`` clamps), rejected
    drafts included: the cache masks by length, so they are dead until
    overwritten. Over a :class:`KVCache8` the window attends in full
    precision and is quantized into the cache after.

    The stacked path with ``S = W``: the linears on K1 over ``B * W`` rows,
    rope at the per-row positions, and a layer's attention ONE launch of the
    window mode of K2 or K9 (``flash_verify``, ``flash_verify_int8``), which
    appends the window itself: no append launch. ``max_length`` (at least
    ``lengths.max()``, from the caller's host copy) sizes its split. Every
    family of JAX's verify step: rope (with NeoX's partial rope), learned
    positions (OPT's offset of 2) and none; ALiBi raises, as JAX's verify
    has no ALiBi path (its ``BatchEngine`` takes plain decode there), and so
    does ``tp_axis`` (ROADMAP A17b). ``impl`` as in :func:`forward`."""
    _check_step(cfg, cache, impl, tp_axis)
    if cfg.pos_embed == "alibi":
        raise ValueError(f"verify_step_batched of a {cfg.arch} model: the verify step has no "
                         "ALiBi path (JAX asserts rope, learned or none); BatchEngine decodes "
                         "ALiBi models without speculation")
    dev = cache.device
    b, w = windows.shape
    data, _ = mk.split_cache(cache)
    if data.shape[2] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"{b} windows need a cache of {b} slots and lengths [{b}], got "
                         f"{tuple(data.shape)} and {tuple(lengths.shape)}")
    lengths = lengths.to(device=dev, dtype=torch.int32)
    if max_length is None:
        max_length = int(lengths.max())
    max_length = min(max(int(max_length), 0), data.shape[4])
    positions = lengths.long()[:, None] + torch.arange(w, device=dev)
    h = _embed(params, cfg, windows.to(dev), positions)     # [B, W, H]
    h = stacked_layers(params, cfg, h, cache, 0, impl, lengths=lengths, max_length=max_length)
    h = _norm(cfg, h, params["norm"], params.get("norm_b"))
    return _head_logits(params, h, impl), cache


@torch.no_grad()
def decode_step_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,       # [B] one token per row
    pool: torch.Tensor,         # [L, 2, NP, n_kv, page, hd], written in place
    tables: torch.Tensor,       # [B, MP] int32 physical page ids
    lengths: torch.Tensor,      # [B] int32 per-row lengths (write positions)
    impl: str = "auto",
    max_length: Optional[int] = None,
    tp_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step over a PAGED KV cache: row ``b``'s positions
    ``[0, lengths[b])`` live in the pages ``tables[b]`` of the shared pool,
    and its k/v are written in place at page ``tables[b, lengths[b] //
    page]``, offset ``lengths[b] % page``. Returns ``(logits [B, V] f32,
    pool)``. ``tables`` and ``lengths`` live on the pool's device;
    ``max_length`` (at least ``lengths.max()``) comes from the caller's host
    copy, so that no step syncs to read it. A freed row's table is all 0,
    the trash page that no request owns, so its k/v land there.

    2..64 rows under K6's paged gate (on the card, a bf16 pool) are ONE
    launch of K6's paged mode (no append after it); otherwise the stacked
    path with K8 per layer, each appending into the rows' pages. ``impl`` as in
    :func:`forward`. A :class:`KVCache8` pool raises: the JAX package has
    no paged int8 cache either."""
    if isinstance(pool, KVCache8) or pool.dtype == torch.int8:
        raise NotImplementedError(
            "decode_step_paged: int8 KV over a page pool; the JAX package has none "
            "either (awq_tpu/runtime/paged.py:107-109; ROADMAP queue A, item 10)")
    _check_step(cfg, pool, impl, tp_axis)
    dev = pool.device
    b = tokens.shape[0]
    if pool.dim() != 6 or tables.dim() != 2 or tables.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"{b} tokens need a pool [L, 2, NP, n_kv, page, hd], tables "
                         f"[{b}, MP] and lengths [{b}], got {tuple(pool.shape)}, "
                         f"{tuple(tables.shape)} and {tuple(lengths.shape)}")
    lengths = lengths.to(device=dev, dtype=torch.int32)
    tables = tables.to(device=dev, dtype=torch.int32)
    layers = params["layers"]
    h = _embed(params, cfg, tokens.to(dev), lengths)   # [B, H]
    if mkb.megakernel_paged_supported(cfg, layers, pool, b):
        fn = (mkb.w4a16_llama_token_step_batched_plain if impl == "plain"
              else mkb.w4a16_llama_token_step_batched)
        t_max = tables.shape[1] * pool.shape[4]
        cos, sin = _rope_cached(cfg, t_max, dev)
        rows = lengths.long().clamp(0, t_max - 1)
        kw = dict(nq=cfg.num_heads, nkv=cfg.num_kv_heads, eps=cfg.rms_eps,
                  max_length=max_length, tables=tables)
        if mk.head_in_kernel(params):
            kw.update(whead=params["lm_head"], norm_w=params["norm"])
        # the rows' k/v are written into their pages inside the kernel
        res = fn(h, layers["wqkv"], layers["wo"], layers["wgateup"],
                 layers["down"], layers["ln1"], layers["ln2"], cos[rows],
                 sin[rows], pool, lengths, **kw)
        if len(res) == 4:
            return res[3], pool
        h = res[0]
    else:
        h = stacked_layers(params, cfg, h[:, None], pool, 0, impl, lengths=lengths,
                           max_length=max_length, tables=tables)[:, 0]
    h = _norm(cfg, h, params["norm"], params.get("norm_b"))
    return _head_logits(params, h, impl), pool
