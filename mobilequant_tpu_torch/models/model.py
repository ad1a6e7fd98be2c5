"""RoPE tables, rotate-half RoPE and the additive causal mask (the parts of
mobilequant_tpu/models/model.py the integer engine uses)."""

from __future__ import annotations

from typing import Optional

import torch

from mobilequant_tpu_torch.models.config import ModelConfig


def rope_cos_sin(positions: torch.Tensor, config: ModelConfig):
    """cos/sin tables for given positions: (..., T, rotary_dim) fp32.

    HF "rotate_half" convention: freqs duplicated [f, f] along the last axis."""
    rd = config.rotary_dim
    ar = torch.arange(0, rd, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (config.rope_theta ** (ar / rd))
    freqs = positions.to(torch.float32)[..., None] * inv_freq   # (..., T, rd/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_dim: int):
    """x: (B,T,H,hd); cos/sin: (B,T,rd). Rotates the first rotary_dim dims only."""
    if rotary_dim == x.shape[-1]:
        xr, x_pass = x, None
    else:
        xr, x_pass = x[..., :rotary_dim], x[..., rotary_dim:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    xr = xr * c + _rotate_half(xr) * s
    if x_pass is None:
        return xr
    return torch.cat([xr, x_pass], dim=-1)


def causal_mask(q_positions: torch.Tensor, kv_len: int, neg_inf: float,
                kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive mask (B, 1, T, S): 0 where kv_pos <= q_pos (and the kv slot is
    valid), else neg_inf."""
    kv_pos = torch.arange(kv_len, device=q_positions.device)[None, None, :]
    q_pos = q_positions[:, :, None]
    ok = kv_pos <= q_pos
    if kv_valid_len is not None:
        ok = ok & (kv_pos < kv_valid_len[:, None, None])
    zero = torch.zeros((), dtype=torch.float32, device=q_positions.device)
    return torch.where(ok, zero, neg_inf)[:, None, :, :]
