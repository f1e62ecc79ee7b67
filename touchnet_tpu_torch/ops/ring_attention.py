# Copyright (c) 2026 touchnet_tpu authors.
# Ring attention: context parallelism with rotating KV chunks (the
# "alltoall" rotate method).
#
# Port of touchnet_tpu/ops/ring_attention.py: _combine (:56-64), _rotate
# (:67-69), _ring_fwd (:118-141) and _ring_bwd (:144-177) with the custom
# VJP of make_ring_attention (:180-222). Each rank of the cp group holds
# its [B, T/cp, H, D] slice of q, k and v; the kv chunks travel the ring
# p -> p+1 (mod n) while q stays. Step s on rank i works on chunk j = (i - s)
# mod n, whose global offset is j * T/cp, so the causal and packed-segment
# masks stay global.
#   forward   n K1 calls (ops.attention.flash_attention, whose CPU branch
#             is the plain version), each with q_offset = i * T/cp and
#             kv_offset = j * T/cp, merged in f32 log-sum-exp space
#             (combine); n - 1 rotations, each started before the step's K1
#             call and waited for after it. A future chunk gives out 0 and
#             lse -inf on the card (every pair masked); combine's guards
#             take it without a NaN.
#   backward  n K2 calls (ops.attention.flash_attention_bwd), each given the
#             final out and the final lse (-inf clamped to 0: such a row's
#             pairs are all masked), which make K2's p the share of the
#             whole softmax; dq accumulates in f32 on the rank; the dk and dv
#             accumulators are f32 and rotate with their kv chunk, so after
#             n rotations they are home.
# The JAX package's dense ring (ring_attention_jnp) is its CPU fallback;
# here the same code runs on the CPU through the kernels' plain versions.
#
# Transport: torch.distributed point-to-point (batch_isend_irecv) through
# utils/distributed.start_p2p, which the pipeline's stages share. Over a
# gloo group the tensors travel through host buffers: gloo's send and recv
# take CPU tensors only (two ranks on one card can only use gloo; NCCL
# takes one rank a card). Under NCCL they go device to device.

from typing import List

import torch
import torch.distributed as dist

from touchnet_tpu_torch.ops import attention as attn_ops
from touchnet_tpu_torch.utils.distributed import start_p2p


def combine(num, den, m, out_p, lse_p):
    """Merge one step's (out_p [B,T,H,D], lse_p [B,H,T]) into the running
    (num [B,T,H,D] f32, den [B,H,T] f32, m [B,H,T] f32): num and den are
    scaled to the new running max m. A step or a running state of lse
    -inf (no live pair yet) adds nothing and makes no NaN."""
    m_new = torch.maximum(m, lse_p)
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    zero = torch.zeros_like(m_new)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
    beta = torch.where(torch.isfinite(lse_p), torch.exp(lse_p - m_safe), zero)
    a, b = alpha.transpose(1, 2)[..., None], beta.transpose(1, 2)[..., None]
    return num * a + out_p.float() * b, den * alpha + beta, m_new


def start_rotate(tensors: List[torch.Tensor], group):
    """Start one ring step over ``group``: each tensor goes to rank p+1 and
    its counterpart comes from rank p-1 (utils/distributed.start_p2p: host
    buffers over gloo). Returns a wait() that gives the received tensors,
    on the senders' devices."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + 1) % n)
    src = dist.get_global_rank(group, (r - 1) % n)
    return start_p2p([(t, dst, i) for i, t in enumerate(tensors)],
                     [(t.shape, t.dtype, t.device, src, i) for i, t in enumerate(tensors)],
                     group)


class RingAttention(torch.autograd.Function):
    """(out [B,T,H,D] in q's dtype, lse [B,H,T] f32) of causal packed
    attention over the cp group's whole sequence, from this rank's slices
    q [B,T,H,D], k, v [B,T,Hkv,D] and segment ids [B,T] (int32). lse
    carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg, group):
        n, i = dist.get_world_size(group), dist.get_rank(group)
        B, T, H, D = q.shape
        S = k.shape[1]
        num = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
        den = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, T), float("-inf"), dtype=torch.float32, device=q.device)
        k_c, v_c, seg_c = k, v, seg
        for s in range(n):
            j = (i - s) % n
            wait = start_rotate([k_c, v_c, seg_c], group) if s + 1 < n else None
            out_p, lse_p = attn_ops.flash_attention(q, k_c, v_c, seg, True, None, seg_c,
                                                    i * T, j * S)
            num, den, m = combine(num, den, m, out_p, lse_p)
            if wait is not None:
                k_c, v_c, seg_c = wait()
        live = den > 0
        den_safe = torch.where(live, den, torch.ones_like(den))
        out = (num / den_safe.transpose(1, 2)[..., None]).to(q.dtype)
        lse = torch.where(live, m + torch.log(den_safe), torch.full_like(m, float("-inf")))
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.group = group
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, seg, out, lse = ctx.saved_tensors
        group = ctx.group
        n, i = dist.get_world_size(group), dist.get_rank(group)
        T, S = q.shape[1], k.shape[1]
        lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse)).contiguous()
        dout = dout.to(q.dtype).contiguous()
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_c = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_c = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_c, v_c, seg_c = k, v, seg
        for s in range(n):
            j = (i - s) % n
            dq_p, dk_p, dv_p = attn_ops.flash_attention_bwd(
                q, k_c, v_c, seg, seg_c, out, lse, dout, True, None, i * T, j * S)
            dq += dq_p.float()
            dk_c += dk_p.float()
            dv_c += dv_p.float()
            # the accumulators travel with their chunk: n rotations bring them home
            if s + 1 < n:
                k_c, v_c, seg_c, dk_c, dv_c = start_rotate([k_c, v_c, seg_c, dk_c, dv_c],
                                                           group)()
            else:
                dk_c, dv_c = start_rotate([dk_c, dv_c], group)()
        return dq.to(q.dtype), dk_c.to(k.dtype), dv_c.to(v.dtype), None, None
