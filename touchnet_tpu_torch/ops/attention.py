# Copyright (c) 2026 touchnet_tpu authors.
# Packed-document flash attention, forward only (kernel K1).
#
# Port of the forward of touchnet_tpu/ops/attention.py. The Pallas kernels
# _fwd_kernel_dyn (:269) and _fwd_kernel (:159) become one hand-written
# CUDA kernel, csrc/flash_attention.cu; its source note says what bounds
# it on Hopper and what the design does about that. Beside it:
#   - packed_attention_reference: the plain PyTorch version (:75-111),
#     which also returns the row logsumexp;
#   - flash_attention: the wrapper. A CPU tensor goes to the plain version;
#     a CUDA tensor launches the kernel or raises on a shape or dtype the
#     kernel does not take. It never falls back to the plain version.
#   - flash_prefill: the chunked-prefill entry (the role of
#     flash_prefill_grouped, :1983): a chunk's queries attend the halves of
#     the packed KV cache, passed as strided views, never copied.
#
# Layout is the JAX package's public one: q [B, T, H, D], k/v [B, S, Hkv, D]
# (GQA when Hkv < H), segment ids int32 [B, T] / [B, S] with 0 marking
# padding (padding only matches itself). Returns out [B, T, H, D] in q's
# dtype and lse [B, H, T] in f32, base e: the contract a context-parallel
# ring and the later backward kernel rely on.

import math
from typing import Optional

import torch

from touchnet_tpu_torch.ops import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (64, 128)  # head dims the kernel is built for
MAX_GROUP = 64  # query heads per kv head (the kernel's 64-row tile)


def packed_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> tuple:
    """Dense masked attention, the plain version of K1.

    q [B,T,H,D], k/v [B,S,Hkv,D] -> (out [B,T,H,D] in q.dtype, lse [B,H,T]
    f32). Scores and softmax in f32; p is cast to v's dtype for the PV
    product (the JAX reference's precision chain). A row with no valid key
    averages v uniformly (every score is DEFAULT_MASK_VALUE)."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    mask = torch.ones((B, 1, T, S), dtype=torch.bool, device=q.device)
    if causal:
        rows = q_offset + torch.arange(T, device=q.device)[:, None]
        cols = kv_offset + torch.arange(S, device=q.device)[None, :]
        mask = mask & (rows >= cols)
    if segment_ids is not None:
        mask = mask & (
            segment_ids.to(torch.int32)[:, None, :, None]
            == kv_segment_ids.to(torch.int32)[:, None, None, :]
        )
    s.masked_fill_(~mask, DEFAULT_MASK_VALUE)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v)
    return out.to(q.dtype), lse


def _segments(seg: Optional[torch.Tensor], shape, device) -> Optional[torch.Tensor]:
    if seg is None:
        return None
    if tuple(seg.shape) != shape:
        raise ValueError(f"segment ids of shape {tuple(seg.shape)}, expected {shape}")
    return seg.to(device=device, dtype=torch.int32).contiguous()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> tuple:
    """Packed-document flash attention forward (K1).

    q [B,T,H,D]; k, v [B,S,Hkv,D], any strides with a unit last one.
    segment_ids [B,T] (None: one segment); kv_segment_ids [B,S] defaults to
    segment_ids. q_offset / kv_offset: global positions of row / column 0.
    Returns (out [B,T,H,D] in q.dtype, lse [B,H,T] f32, base e).

    CPU tensors take the plain version. CUDA tensors take the kernel, which
    needs D in HEAD_DIMS, bf16 or f32, and H / Hkv <= MAX_GROUP; anything
    else raises. A row with no valid key gets out 0 and lse -inf."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if segment_ids is None:
        kv_segment_ids = None
    elif kv_segment_ids is None:
        kv_segment_ids = segment_ids
    if q.device.type == "cpu":
        return packed_attention_reference(
            q, k, v, segment_ids, causal, scale, kv_segment_ids,
            q_offset, kv_offset,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if tuple(k.shape) != (B, S, Hkv, D) or tuple(v.shape) != (B, S, Hkv, D):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} vs q {tuple(q.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype}: bf16 or f32, all equal")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"{H} query heads over {Hkv} kv heads")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k and v need a unit stride on the head dim")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    q_seg = _segments(segment_ids, (B, T), q.device)
    kv_seg = _segments(kv_segment_ids, (B, S), q.device)
    lib = _build.load_library()
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.tn_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if q_seg is None else q_seg.data_ptr(),
            None if kv_seg is None else kv_seg.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            B, T, S, H, Hkv, D, _build.DTYPE_CODES[q.dtype],
            int(causal), int(q_offset), int(kv_offset), float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def cache_halves(kv_cache: torch.Tensor, head_dim: int) -> tuple:
    """K and V of a packed [B, Hkv, S, 2D] cache layer as [B, S, Hkv, D]
    strided views (no copy)."""
    kv = kv_cache.transpose(1, 2)
    return kv[..., :head_dim], kv[..., head_dim:]


def flash_prefill(
    q: torch.Tensor,  # [B, T, H, D]: one chunk's queries
    kv_cache: torch.Tensor,  # [B, Hkv, S, 2D]: one layer of the packed cache
    segment_ids: torch.Tensor,  # [B, T]
    kv_segment_ids: torch.Tensor,  # [B, S]: 0 marks unwritten slots
    *,
    q_offset: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked prefill: the chunk, at global positions q_offset + t, attends
    the cache prefix and itself, causally. K and V go to flash_attention as
    strided views of the cache halves; a .contiguous() here would copy the
    whole layer's cache on every chunk. Returns out [B, T, H, D]."""
    k, v = cache_halves(kv_cache, q.shape[-1])
    out, _ = flash_attention(
        q, k, v, segment_ids, True, scale, kv_segment_ids, q_offset, 0
    )
    return out
