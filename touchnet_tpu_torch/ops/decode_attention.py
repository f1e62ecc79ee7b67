# Copyright (c) 2026 touchnet_tpu authors.
# Ragged flash-decode: one query step against the packed KV cache (kernel K4).
#
# Port of touchnet_tpu/ops/decode_attention.py. The Pallas kernel _kernel
# (:85) becomes a hand-written CUDA split-KV decode, csrc/
# decode_attention.cu (bf16 and f16: a cp.async ring feeding mma.sync, one
# kernel body for both; f32: FMAs);
# its source note says what bounds it on Hopper and what the design does
# about that. The TPU kernel's host-side block table (live_block_map,
# block_geometry) has no counterpart: split_plan gives every split the same
# budget of live columns, and each CUDA block maps its share of the row's
# live intervals onto cache columns itself (split_columns says which).
#
# The cache is the packed [L, B, Hkv, S, 2D] buffer of
# models/llama/inference_llama.KVCache: K in [0, D), V in [D, 2D). Column c
# of row b is valid iff c < prompt_len[b] or base <= c <= last (the
# [prompt_len, base) gap holds prefill right-padding). A CPU tensor goes to
# the plain version; a CUDA tensor launches the kernel or raises.

import functools
import math
from typing import List, Optional, Tuple

import torch

from touchnet_tpu_torch.ops import _build

NEG_INF = -1e30
# cache capacities round up to this (models/llama/inference_llama.init_cache)
DECODE_BLOCK = 512
HEAD_DIMS = (64, 128)
MAX_GROUP = 16  # query heads per kv head (csrc/decode_attention.cu kMaxG)
SPLIT_ALIGN = 64  # the tensor-core kernel's ring tile (csrc kCols): a split's budget is whole tiles
_SPLIT_BLOCKS_PER_SM = 16  # blocks the grid would hold on each SM if every column were live
_MIN_SPLIT_COLS = 256


def decode_attention_reference(
    q: torch.Tensor,  # [B, H, D]
    kv_cache: torch.Tensor,  # [B, Hkv, S, 2D] or [L, B, Hkv, S, 2D]
    prompt_len: torch.Tensor,  # [B]
    base: int,
    last: int,
    scale: Optional[float] = None,
    layer_idx: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of K4: a dense masked softmax over the whole cache
    (the JAX package's einsum cache path). Scores and softmax in f32, p
    cast to the cache dtype for the PV product. Returns [B, H, D]."""
    B, H, D = q.shape
    if kv_cache.dim() == 5:
        kv_cache = kv_cache[layer_idx]
    Hkv, S = kv_cache.shape[1], kv_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(), kv_cache[..., :D].float()) * scale
    cols = torch.arange(S, device=q.device)
    valid = (cols[None, :] < prompt_len.to(q.device)[:, None]) | (
        (cols >= base) & (cols <= last)
    )[None, :]
    s.masked_fill_(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p.to(kv_cache.dtype), kv_cache[..., D:])
    return out.reshape(B, H, D).to(q.dtype)


def split_plan(batch: int, n_kv_heads: int, seq: int, sm_count: int) -> Tuple[int, int]:
    """(cols_per_split, nsplit) of the kernel's grid, from shapes alone (no
    host sync on prompt_len): every split of a (row, kv head) streams at
    most cols_per_split live columns, a multiple of SPLIT_ALIGN and at least
    _MIN_SPLIT_COLS; nsplit splits cover a full row of `seq` columns, and
    are enough for _SPLIT_BLOCKS_PER_SM blocks on every SM if every column
    were live. A split that starts past its row's live count exits at once,
    so blocks stream about the same bytes whatever the prompt lengths."""
    want = -(-(_SPLIT_BLOCKS_PER_SM * sm_count) // (batch * n_kv_heads))
    cols = -(-max(seq, 1) // want)
    cols = max(_MIN_SPLIT_COLS, -(-cols // SPLIT_ALIGN) * SPLIT_ALIGN)
    return cols, -(-max(seq, 1) // cols)


def split_columns(prompt_len: int, seq: int, base: int, last: int,
                  cols_per_split: int, split: int) -> List[int]:
    """The cache columns that block `split` of a row reads, in order: the
    kernel's own arithmetic (csrc LiveRange). The row's live set is the
    virtual range [0, n): j < plen is column j, j >= plen is column
    max(base, plen) + (j - plen); the split reads [split * cols_per_split,
    (split + 1) * cols_per_split) of it."""
    plen = min(max(prompt_len, 0), seq)
    bstart = max(base, plen)
    n = plen + max(min(last + 1, seq) - bstart, 0)
    j0 = split * cols_per_split
    return [j if j < plen else bstart + (j - plen)
            for j in range(j0, min(n, j0 + cols_per_split))]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def decode_attention(
    q: torch.Tensor,  # [B, H, D]
    kv_cache: torch.Tensor,  # [B, Hkv, S, 2D] or [L, B, Hkv, S, 2D]
    prompt_len: torch.Tensor,  # [B] int
    base: int,  # first decode slot
    last: int,  # current decode slot (inclusive)
    scale: Optional[float] = None,
    layer_idx: Optional[int] = None,  # layer of a rank-5 cache
) -> torch.Tensor:
    """Flash-decode step over the packed ragged cache (K4). Returns [B, H, D].

    With a rank-5 cache the kernel reads layer ``layer_idx`` in place
    through a pointer offset: the caller never slices or copies the cache.
    CUDA tensors need a contiguous cache, D in HEAD_DIMS, bf16, f16 or f32
    and H / Hkv <= MAX_GROUP; anything else raises. A row with no valid
    column gets 0."""
    B, H, D = q.shape
    if kv_cache.dim() == 4:
        kv_cache, layer_idx = kv_cache[None], 0
    if layer_idx is None:
        raise ValueError("a rank-5 cache needs layer_idx")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, kv_cache, prompt_len, base, last, scale, layer_idx
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    L, Bc, Hkv, S, D2 = kv_cache.shape
    if Bc != B or D2 != 2 * D:
        raise ValueError(f"cache {tuple(kv_cache.shape)} vs q {tuple(q.shape)}")
    if q.dtype not in _build.DTYPE_CODES or kv_cache.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} cache {kv_cache.dtype}: bf16, f16 or f32, equal")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"{H} query heads over {Hkv} kv heads")
    if not (q.is_contiguous() and kv_cache.is_contiguous()):
        raise ValueError("decode_attention needs a contiguous q and cache")
    if kv_cache.device != q.device:
        raise ValueError("q and the cache must be on one device")
    if not 0 <= int(layer_idx) < L:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {L})")
    plen = prompt_len.to(device=q.device, dtype=torch.int32).contiguous()
    if tuple(plen.shape) != (B,):
        raise ValueError(f"prompt_len of shape {tuple(plen.shape)}, expected ({B},)")
    if (q.data_ptr() | kv_cache.data_ptr()) % 16:
        raise ValueError("decode_attention: q and the cache must start on 16 bytes")
    lib = _build.load_library()
    cols, nsplit = split_plan(B, Hkv, S, _sm_count(q.device.index))
    out = torch.empty_like(q)
    # the splits' partials, f32, as contiguous slices of one allocation:
    # acc [B, H, nsplit, D], then m and l [B, H, nsplit] each
    n = B * H * nsplit
    parts = torch.empty((n * (D + 2),), dtype=torch.float32, device=q.device)
    part_acc, part_m, part_l = parts[:n * D], parts[n * D:n * (D + 1)], parts[n * (D + 1):]
    layer_ptr = kv_cache.data_ptr() + int(layer_idx) * kv_cache.stride(0) * kv_cache.element_size()
    with torch.cuda.device(q.device):
        err = lib.tn_flash_decode(
            q.data_ptr(), layer_ptr, plen.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            B, H, Hkv, S, D, _build.DTYPE_CODES[q.dtype], int(base), int(last),
            nsplit, cols, float(scale), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
