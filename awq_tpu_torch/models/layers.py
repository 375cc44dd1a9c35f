"""Building blocks of the decoder (PyTorch port of ``awq_tpu/models/layers.py``).

Norms and softmax run in f32 and cast back, as in the JAX package. These
stay plain PyTorch: the JAX package left them to XLA fusions, and the
port has no hand kernel for them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from awq_tpu_torch.config import ModelConfig
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
) -> torch.Tensor:
    """Causal (chunk-offset) attention, GQA-aware, masked over the whole
    static cache: query ``i`` attends positions ``j <= start_pos + i``.
    The masked reference; the model runs the flash kernels instead."""
    b, s, n_q, hd = q.shape
    n_kv, t = k_cache.shape[1], k_cache.shape[2]
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
