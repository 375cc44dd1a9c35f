"""Building blocks of the decoder (PyTorch port of ``awq_tpu/models/layers.py``).

Norms, activations and softmax run in f32 and cast back, as in the JAX
package. These stay plain PyTorch: the JAX package left them to XLA
fusions, and the port has no hand kernel for them. :func:`attention`
sends a one-position step to K14 (``ops/decode_attn.py::flash_decode_layer``,
its plain version on the CPU), as the JAX function dispatches it to
``flash_decode`` on a TPU; with ALiBi :func:`alibi_slopes` it passes the
slopes to K14.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from awq_tpu_torch.config import ModelConfig
from awq_tpu_torch.ops.decode_attn import flash_decode_layer
from awq_tpu_torch.ops.w4a16 import QLinear, qlinear_apply


@dataclasses.dataclass
class Linear:
    """Unquantized linear parameters: ``w [IC, OC]``, ``b [OC]`` or None."""

    w: torch.Tensor
    b: Optional[torch.Tensor] = None


def linear_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Apply a :class:`Linear` or :class:`QLinear` to ``x [..., IC]``."""
    if isinstance(p, QLinear):
        return qlinear_apply(p, x)
    out = torch.matmul(x, p.w.to(x.dtype))
    if p.b is not None:
        out = out + p.b.to(out.dtype)
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """T5/Llama RMSNorm, computed in f32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (mean, biased variance, ``rsqrt``),
    then the weight and the optional bias."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """ALiBi slopes ``[n_heads]`` f32 (MPT, BLOOM; the port's own copy of
    ``awq_tpu/models/layers.py::alibi_slopes``): ``2^(-8 (h + 1) / n)`` for a
    power-of-two ``n``, else the closest power of two's slopes followed by
    every other slope of twice that many heads."""

    def pow2slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        vals = pow2slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        vals = pow2slopes(closest) + pow2slopes(2 * closest)[0::2][: n_heads - closest]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def rope_table(cfg: ModelConfig, max_len: int,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables ``[max_len, rotary_dim]`` in f32.

    HF-llama convention (rotate_half, frequencies duplicated across the two
    halves), llama3-style frequency rescaling and ``rotary_pct``."""
    rotary_dim = int(cfg.head_dim * cfg.rotary_pct) // 2 * 2
    half = rotary_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    inv_freq = 1.0 / (cfg.rope_theta ** exps)
    rs = cfg.rope_scaling
    if rs is not None and rs.rope_type == "llama3":
        low_wl = rs.original_max_position_embeddings / rs.low_freq_factor
        high_wl = rs.original_max_position_embeddings / rs.high_freq_factor
        wavelen = 2 * math.pi / inv_freq
        smooth = (rs.original_max_position_embeddings / wavelen
                  - rs.low_freq_factor) / (rs.high_freq_factor - rs.low_freq_factor)
        inv_freq = torch.where(
            wavelen > low_wl,
            inv_freq / rs.factor,
            torch.where(
                wavelen < high_wl,
                inv_freq,
                (1 - smooth) * inv_freq / rs.factor + smooth * inv_freq,
            ),
        )
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(
    q: torch.Tensor,            # [B, S, n_q, hd]
    k: torch.Tensor,            # [B, S, n_kv, hd]
    cos: torch.Tensor,          # [max_len, rotary_dim]
    sin: torch.Tensor,
    positions: torch.Tensor,    # [S] shared, or [B, S] per row
) -> Tuple[torch.Tensor, torch.Tensor]:
    if positions.dim() == 1:
        c = cos[positions][None, :, None, :]
        s = sin[positions][None, :, None, :]
    else:
        c = cos[positions][:, :, None, :]
        s = sin[positions][:, :, None, :]
    rd = cos.shape[-1]

    def rot(x):
        xf = x[..., :rd].float()
        half = rd // 2
        x1, x2 = xf[..., :half], xf[..., half:]
        rotated = torch.cat([-x2, x1], dim=-1)
        out = (xf * c + rotated * s).to(x.dtype)
        if rd == x.shape[-1]:
            return out
        return torch.cat([out, x[..., rd:]], dim=-1)

    return rot(q), rot(k)


def attention(
    q: torch.Tensor,            # [B, S, n_q, hd]
    k_cache: torch.Tensor,      # [B, n_kv, T, hd]
    v_cache: torch.Tensor,      # [B, n_kv, T, hd]
    start_pos: int,             # the chunk occupies [start, start+S)
    bias: Optional[torch.Tensor] = None,  # e.g. alibi [n_q, 1, T]
    slopes: Optional[torch.Tensor] = None,  # ALiBi [n_q] f32
) -> torch.Tensor:
    """Causal (chunk-offset) attention, GQA-aware, over a static cache that
    already holds the chunk: query ``i`` attends positions ``j <= start_pos
    + i``. Returns ``[B, S, n_q * hd]`` in ``q.dtype``.

    One position (S = 1) with no ``bias`` is :func:`flash_decode_layer` over
    ``[0, start_pos + 1)``, with the ALiBi ``slopes`` where given (the
    score of position ``j`` plus ``slope * j``): K14 on a CUDA tensor, which
    launches or raises (``NotImplementedError`` naming ROADMAP A12 for a
    head_dim other than 64 or 128, or more than 128 query heads per kv
    head), and its plain version (f32 softmax weights) on the CPU.
    Everything else takes the masked path below, the JAX function's (f32
    scores and softmax, the weights rounded to ``q.dtype``), ``slopes`` as
    the bias ``slope * j``; on a CUDA tensor that path takes no ALiBi step
    and raises instead (the model's ALiBi prompts run K3, its decode K2, K14
    or K4)."""
    b, s, n_q, hd = q.shape
    n_kv, t = k_cache.shape[1], k_cache.shape[2]
    if s == 1 and bias is None:
        out = flash_decode_layer(q[:, 0].contiguous(), k_cache, v_cache, start_pos + 1,
                                 slopes=slopes)
        return out.reshape(b, 1, n_q * hd)
    if q.is_cuda and (slopes is not None or bias is not None):
        raise NotImplementedError(
            "attention: a biased (ALiBi) step on the masked path on the card; the model's "
            "ALiBi prompts run K3 and its decode K2, K14 or K4, each with the slopes")
    if slopes is not None:
        bias = slopes.float()[:, None, None] * torch.arange(t, dtype=torch.float32,
                                                            device=q.device)
    groups = n_q // n_kv
    qf = q.reshape(b, s, n_kv, groups, hd).float()
    scores = torch.einsum("bskgh,bkth->bkgst", qf, k_cache.float()) / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias.reshape(1, n_kv, groups, 1, t)
    j = torch.arange(t, device=q.device)[None, :]
    i = torch.arange(s, device=q.device)[:, None]
    scores = scores.masked_fill(~(j <= start_pos + i), float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bkth->bskgh", probs.to(q.dtype).float(),
                       v_cache.float()).to(q.dtype)
    return out.reshape(b, s, n_q * hd)


def update_kv_cache(
    kv: torch.Tensor,           # [2, B, n_kv, T, hd]: one layer, WRITTEN IN PLACE
    k: torch.Tensor,            # [B, S, n_kv, hd]
    v: torch.Tensor,
    start_pos: int,
) -> None:
    """Write the new K/V chunk at ``start_pos`` into the layer's cache view.

    In place: the JAX package returned a new cache
    (``dynamic_update_slice``); here the caller's tensor changes."""
    s = k.shape[1]
    kv[0, :, :, start_pos:start_pos + s] = k.transpose(1, 2).to(kv.dtype)
    kv[1, :, :, start_pos:start_pos + s] = v.transpose(1, 2).to(kv.dtype)


def mlp_swiglu(gate, up, down, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: ``down(silu(gate(x)) * up(x))``, silu in f32."""
    g = linear_apply(gate, x)
    u = linear_apply(up, x)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return linear_apply(down, h)


def activation(h: torch.Tensor, act: str,
               act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain MLP's activation, in f32 and cast back: ``relu``, the tanh
    GELU (``gelu_tanh``) or the exact erf GELU (any other ``act``: falcon,
    mpt, neox); then the AWQ activation-scale fold, the output divided by
    ``act_scale`` (the next linear's weights carry it)."""
    if act == "relu":
        h = torch.clamp_min(h, 0)
    else:
        h = torch.nn.functional.gelu(
            h.float(), approximate="tanh" if act == "gelu_tanh" else "none").to(h.dtype)
    if act_scale is not None:
        h = (h.float() / act_scale).to(h.dtype)
    return h


def mlp_gelu(fc1, fc2, x: torch.Tensor, act: str = "gelu",
             act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain MLP: ``fc2(activation(fc1(x)))``."""
    return linear_apply(fc2, activation(linear_apply(fc1, x), act, act_scale))
