# Copyright (c) 2026 touchnet_tpu authors.
# Shared transformer building blocks, ported from
# touchnet_tpu/models/common.py (same math, same conventions: f32 norm and
# rope arithmetic with a cast back, HF [out, in] weights, rotate_half rope).
#
# apply_rope_grouped is not ported: only the JAX package's grouped TPU
# attention layout uses it. swiglu lives in modeling_llama.LlamaMLP, which
# runs each of its matmuls under its residual name for the remat policy.

import math
from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 with cast back (HF Llama semantics)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def rope_frequencies(
    head_dim: int, rope_theta: float = 10000.0, dtype=torch.float32,
    rope_scaling=None, device=None,
) -> torch.Tensor:
    """inv_freq [head_dim // 2].

    ``rope_scaling``: HF rope_scaling dict; 'llama3' frequency scaling
    (transformers modeling_rope_utils._compute_llama3_parameters): low
    frequencies are slowed by `factor`, high ones kept, the band between
    smoothly interpolated."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (rope_theta ** exponent)
    rtype = (rope_scaling or {}).get(
        "rope_type", (rope_scaling or {}).get("type")
    )
    if rtype == "llama3":
        factor = rope_scaling["factor"]
        low = rope_scaling["low_freq_factor"]
        high = rope_scaling["high_freq_factor"]
        orig = rope_scaling["original_max_position_embeddings"]
        low_wavelen = orig / low
        high_wavelen = orig / high
        wavelen = 2 * math.pi / inv_freq
        scaled = torch.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (orig / wavelen - low) / (high - low)
        smoothed = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        medium = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv_freq = torch.where(medium, smoothed, scaled)
    elif rtype not in (None, "default"):
        raise NotImplementedError(f"rope_scaling type {rtype!r}")
    return inv_freq.to(dtype)


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    position_ids: torch.Tensor,
    inv_freq: torch.Tensor,
) -> tuple:
    """Rotary embedding, HF Llama "rotate_half" convention, f32 trig.

    q [B, T, H, D], k [B, T, Hkv, D], position_ids [B, T]."""
    angles = position_ids[..., None].float() * inv_freq  # [B, T, D/2]
    cos = torch.cos(angles).repeat(1, 1, 2)[:, :, None, :]  # [B, T, 1, D]
    sin = torch.sin(angles).repeat(1, 1, 2)[:, :, None, :]

    def rot(x):
        half = x.shape[-1] // 2
        rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
        return (x.float() * cos + rotated.float() * sin).to(x.dtype)

    return rot(q), rot(k)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W^T (+ b). Weight stored HF-style [out, in]."""
    return F.linear(x, weight, bias)


def normal_init(generator: torch.Generator, shape, std=0.02,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """normal(0, std) drawn in f32 from an explicit generator, then cast.
    The generator must live on ``device``."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)
