# Copyright (c) 2026 touchnet_tpu authors.
# Packed-document flash attention: forward (kernel K1) and backward (K2).
#
# Port of touchnet_tpu/ops/attention.py. The Pallas forward kernels
# _fwd_kernel_dyn (:269) and _fwd_kernel (:159) become hand-written CUDA,
# csrc/flash_attention.cu; the six backward kernels (:528-1100) become
# csrc/flash_attention_bwd.cu. bf16 and f16 run on TMA + wgmma (a producer
# warp feeding two consumer warpgroups; one kernel body for both types), f32
# on FMA kernels. Each source note says what
# bounds it on Hopper and what the design does about that. Beside them:
#   - packed_attention_reference: the plain PyTorch version (:75-111),
#     which also returns the row logsumexp;
#   - flash_attention: the wrapper. It calls the custom op
#     touchnet_tpu_torch::flash_attention_fwd (FLASH_FWD_OP), whose CUDA
#     implementation launches K1 and whose CPU implementation is the plain
#     version; its registered backward runs flash_attention_bwd (K2 on the
#     card; the JAX custom_vjp, :1711-1744: only out carries a gradient, lse
#     does not). Being an op of the dispatcher, K1 is visible to a
#     selective activation-checkpoint policy, which can save its (out, lse)
#     so that the backward never re-runs it (the JAX flash_out / flash_lse
#     residual names). The wrapper raises on a shape or dtype the kernels do
#     not take and never falls back to the plain version.
#   - flash_attention_bwd: K2's wrapper (dq, dk, dv from the forward's
#     residuals, or from a context-parallel ring's final out and lse),
#     through the custom op touchnet_tpu_torch::flash_attention_bwd
#     (FLASH_BWD_OP), whose CUDA implementation launches K2 and whose CPU
#     implementation is the plain version, flash_attention_bwd_reference:
#     the kernel's formula from the same inputs in f32.
#   Both ops have fake implementations (shapes only, valid for symbolic B
#     and T), so torch.compile traces a block through them: the compiled
#     graph calls the ops, and the ops the kernels. The launch counts stay
#     in the op bodies, which run at every call, compiled or not (a count
#     in code that dynamo traces would run once, while tracing).
#   - flash_prefill: the chunked-prefill entry (the role of
#     flash_prefill_grouped, :1983): a chunk's queries attend the halves of
#     the packed KV cache, passed as strided views, never copied.
#
# Layout is the JAX package's public one: q [B, T, H, D], k/v [B, S, Hkv, D]
# (GQA when Hkv < H), segment ids int32 [B, T] / [B, S] with 0 marking
# padding (padding only matches itself). Returns out [B, T, H, D] in q's
# dtype and lse [B, H, T] in f32, base e: the contract a context-parallel
# ring and the later backward kernel rely on.

import ctypes
import math
from typing import Optional, Tuple

import torch

from touchnet_tpu_torch.ops import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (64, 128)  # head dims the kernel is built for
MAX_GROUP = 64  # query heads per kv head (the f32 kernels' 64-row tile)


def _mask(B, T, S, device, segment_ids, kv_segment_ids, causal, q_offset, kv_offset):
    """[B, 1, T, S] bool: the pairs the kernels keep (segments equal and,
    when causal, q_offset + t >= kv_offset + s)."""
    mask = torch.ones((B, 1, T, S), dtype=torch.bool, device=device)
    if causal:
        rows = q_offset + torch.arange(T, device=device)[:, None]
        cols = kv_offset + torch.arange(S, device=device)[None, :]
        mask = mask & (rows >= cols)
    if segment_ids is not None:
        mask = mask & (
            segment_ids.to(torch.int32)[:, None, :, None]
            == kv_segment_ids.to(torch.int32)[:, None, None, :]
        )
    return mask


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
    mask = _mask(B, T, S, q.device, segment_ids, kv_segment_ids, causal, q_offset, kv_offset)
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
    needs D in HEAD_DIMS, bf16, f16 or f32, H / Hkv <= MAX_GROUP and, in
    bf16 and f16, 16-byte aligned q, k, v rows (_check_aligned); anything
    else raises (an f16 tensor never reaches the plain version). A
    row with no valid key gets out 0 and lse -inf. out is differentiable
    (K2 on the card); lse carries no gradient."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if segment_ids is None:
        kv_segment_ids = None
    elif kv_segment_ids is None:
        kv_segment_ids = segment_ids
    if q.device.type == "cpu":
        return FLASH_FWD_OP(q, k, v, _segments(segment_ids, (B, T), q.device),
                            _segments(kv_segment_ids, (B, S), q.device), causal,
                            float(scale), int(q_offset), int(kv_offset))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if tuple(k.shape) != (B, S, Hkv, D) or tuple(v.shape) != (B, S, Hkv, D):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} vs q {tuple(q.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype}: bf16, f16 or f32, "
                         "all equal")
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
    return FLASH_FWD_OP(q, k, v, q_seg, kv_seg, causal, float(scale), int(q_offset),
                        int(kv_offset))


def _row_strides(x: torch.Tensor) -> tuple:
    """Strides of the batch, sequence and head dims; 0 for a dim of size 1,
    whose stride no index reads."""
    return tuple(st if n > 1 else 0 for n, st in zip(x.shape[:3], x.stride()[:3]))


def _check_aligned(what: str, **tensors) -> None:
    """The bf16 and f16 kernels read their tiles by TMA: every tensor's start
    and its row strides must be 16-byte aligned. Raises otherwise
    (the kernels take no other route)."""
    for name, x in tensors.items():
        if x.data_ptr() % 16 or any(st % 8 for st in _row_strides(x)):
            raise ValueError(f"{what}: {name} must start on 16 bytes with row strides "
                             f"in multiples of 8 elements (strides {tuple(x.stride())})")


def _flash_fwd(q, k, v, q_seg, kv_seg, causal, scale, q_offset, kv_offset):
    """Launch K1 on validated CUDA tensors."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if q.dtype != torch.float32:
        _check_aligned("flash_attention", q=q, k=k, v=v)
    lib = _build.load_library()
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.tn_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if q_seg is None else q_seg.data_ptr(),
            None if kv_seg is None else kv_seg.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            *_row_strides(q), *_row_strides(k), *_row_strides(v),
            B, T, S, H, Hkv, D, _build.DTYPE_CODES[q.dtype],
            int(causal), q_offset, kv_offset, scale,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


@torch.library.custom_op("touchnet_tpu_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_seg: Optional[torch.Tensor], kv_seg: Optional[torch.Tensor], causal: bool,
                  scale: float, q_offset: int, kv_offset: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on validated CUDA tensors (flash_attention checks them)."""
    return _flash_fwd(q, k, v, q_seg, kv_seg, causal, scale, q_offset, kv_offset)


@_flash_fwd_op.register_kernel("cpu")
def _flash_fwd_cpu(q, k, v, q_seg, kv_seg, causal, scale, q_offset, kv_offset):
    out, lse = packed_attention_reference(q, k, v, q_seg, causal, scale, kv_seg, q_offset,
                                          kv_offset)
    return out.contiguous(), lse.contiguous()  # the kernel's layout, as the fake says


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, q_seg, kv_seg, causal, scale, q_offset, kv_offset):
    """The shapes a compiled graph traces with (B and T may be symbolic)."""
    B, T, H, D = q.shape
    return q.new_empty((B, T, H, D)), q.new_empty((B, H, T), dtype=torch.float32)


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, q_seg, kv_seg, causal, scale, q_offset, kv_offset = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
    ctx.args = (causal, scale, q_offset, kv_offset)
    ctx.mark_non_differentiable(lse)


def _flash_fwd_backward(ctx, dout, _dlse):
    """K2 from the forward's residuals (the plain backward on the CPU),
    through K2's op, so that a compiled graph's backward calls it too."""
    q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
    causal, scale, q_offset, kv_offset = ctx.args
    dq, dk, dv = FLASH_BWD_OP(q.contiguous(), k.contiguous(), v.contiguous(), q_seg, kv_seg,
                              out.contiguous(), lse.contiguous(),
                              dout.to(q.dtype).contiguous(), causal, scale, q_offset,
                              kv_offset)
    return dq, dk, dv, None, None, None, None, None, None


_flash_fwd_op.register_autograd(_flash_fwd_backward, setup_context=_flash_fwd_setup)
# the op as the dispatcher sees it (what a checkpoint policy matches on)
FLASH_FWD_OP = torch.ops.touchnet_tpu_torch.flash_attention_fwd.default


flash_attention.launches = 0


def flash_attention_bwd_reference(q, k, v, segment_ids, kv_segment_ids, out, lse,
                                  dout, causal=True, scale=None, q_offset=0,
                                  kv_offset=0) -> tuple:
    """K2's plain version: (dq, dk, dv) in q's dtype from K2's inputs, in
    f32, as the kernel computes them: p = exp(s - lse), delta = rowsum(dout
    * out), ds = p * (dout v^T - delta) on the kept pairs, dq = ds k, dk =
    ds^T q (times the scale), dv = p^T dout, dk and dv summed over the G
    query heads of their kv head. out and lse need not be this forward's:
    a context-parallel ring hands every step the final out and lse of all
    its steps, and gets that step's share of the gradient. Given None, they
    are packed_attention_reference's (then the result is autograd through
    it: on a row with no valid key p is uniform, as its forward)."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    if out is None or lse is None:
        out, lse = packed_attention_reference(q, k, v, segment_ids, causal, scale,
                                              kv_segment_ids, q_offset, kv_offset)
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    qf, do = q.float(), dout.float()
    mask = _mask(B, T, S, q.device, segment_ids, kv_segment_ids, causal, q_offset, kv_offset)
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    s.masked_fill_(~mask, DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse.float()[..., None])
    delta = (do * out.float()).sum(-1).transpose(1, 2)  # [B, H, T]
    dp = torch.einsum("bthd,bshd->bhts", do, vf)
    ds = (p * (dp - delta[..., None])).masked_fill_(~mask, 0.0) * scale
    dq = torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf).reshape(B, S, Hkv, G, D).sum(3)
    dv = torch.einsum("bhts,bthd->bshd", p, do).reshape(B, S, Hkv, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, segment_ids, kv_segment_ids, out, lse, dout,
                        causal=True, scale=None, q_offset=0, kv_offset=0,
                        events=None) -> tuple:
    """Backward of flash_attention (K2): (dq [B,T,H,D], dk, dv [B,S,Hkv,D])
    in q's dtype from the forward's inputs, its (out, lse) and dout.

    CPU tensors take the plain version. CUDA tensors take the kernel, with
    flash_attention's conditions; q, k, v and out must be contiguous, and
    dout is made contiguous here (autograd may hand it over strided). dk
    and dv are summed over the G query heads of their kv head. Both go
    through the custom op touchnet_tpu_torch::flash_attention_bwd
    (FLASH_BWD_OP). ``events``: four torch.cuda.Event(enable_timing=True)
    the kernel records before its delta pass, after it, after the dk/dv
    kernel and after the dq kernel (their times; the trainer passes none,
    and a call with events launches K2 outside the op)."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, segment_ids, kv_segment_ids, out, lse, dout, causal, scale,
            q_offset, kv_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    if q.dtype not in _build.DTYPE_CODES or any(x.dtype != q.dtype for x in (k, v, out)):
        raise ValueError("flash_attention_bwd: q, k, v and out in one dtype, bf16, f16 or "
                         "f32")
    if D not in HEAD_DIMS or H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"flash_attention_bwd: H={H} Hkv={Hkv} D={D}")
    if not all(x.is_contiguous() for x in (q, k, v, out, lse)):
        raise ValueError("flash_attention_bwd: q, k, v, out and lse must be contiguous")
    q_seg = _segments(segment_ids, (B, T), q.device)
    kv_seg = _segments(kv_segment_ids, (B, S), q.device)
    dout = dout.to(q.dtype).contiguous()
    if events is not None:
        return _flash_bwd(q, k, v, q_seg, kv_seg, out, lse, dout, causal, float(scale),
                          int(q_offset), int(kv_offset), events)
    return FLASH_BWD_OP(q, k, v, q_seg, kv_seg, out, lse, dout, causal, float(scale),
                        int(q_offset), int(kv_offset))


def _flash_bwd(q, k, v, q_seg, kv_seg, out, lse, dout, causal, scale, q_offset, kv_offset,
               events=None):
    """Launch K2 on validated, contiguous CUDA tensors."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if q.dtype != torch.float32:
        _check_aligned("flash_attention_bwd", q=q, k=k, v=v, out=out, dout=dout)
    lib = _build.load_library()
    handles = None
    if events is not None:
        for e in events:  # created at their first record
            e.record()
        handles = (ctypes.c_void_p * 4)(*(e.cuda_event for e in events))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.tn_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(),
            None if q_seg is None else q_seg.data_ptr(),
            None if kv_seg is None else kv_seg.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, T, S, H, Hkv, D, _build.DTYPE_CODES[q.dtype],
            int(causal), int(q_offset), int(kv_offset), float(scale),
            torch.cuda.current_stream().cuda_stream, handles,
        )
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


@torch.library.custom_op("touchnet_tpu_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_seg: Optional[torch.Tensor], kv_seg: Optional[torch.Tensor],
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, causal: bool,
                  scale: float, q_offset: int, kv_offset: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on contiguous CUDA tensors (its callers make them so)."""
    return _flash_bwd(q, k, v, q_seg, kv_seg, out, lse, dout, causal, scale, q_offset,
                      kv_offset)


@_flash_bwd_op.register_kernel("cpu")
def _flash_bwd_cpu(q, k, v, q_seg, kv_seg, out, lse, dout, causal, scale, q_offset,
                   kv_offset):
    grads = flash_attention_bwd_reference(q, k, v, q_seg, kv_seg, out, lse, dout, causal,
                                          scale, q_offset, kv_offset)
    return tuple(g.contiguous() for g in grads)


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, q_seg, kv_seg, out, lse, dout, causal, scale, q_offset,
                    kv_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


FLASH_BWD_OP = torch.ops.touchnet_tpu_torch.flash_attention_bwd.default
flash_attention_bwd.launches = 0


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
