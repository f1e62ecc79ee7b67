# Copyright (c) 2026 touchnet_tpu authors.
# Fused lm-head + cross-entropy row statistics (kernel K3).
#
# Port of touchnet_tpu/ops/fused_ce.py. The Pallas kernels _fwd_kernel (:86)
# and _bwd_kernel (:175) become csrc/fused_ce.cu; its source note says what
# bounds it on Hopper and how it tiles rows and vocab. fwd_plan and bwd_plan
# choose each direction's mainloop by shape (bf16 or f16 with E a multiple
# of 8: TMA + wgmma; other bf16 or f16: wmma tiles; f32: FMA tiles; the two
# 16-bit types share every plan and one kernel body) and the forward's
# grid. Beside them:
#   - _rows_reference: the plain PyTorch version (:287-301), which
#     materialises the [N, V] f32 logits;
#   - _rows_backward_reference: the plain backward (:337-347);
#   - fused_ce_rows: the wrapper (:358), the custom op
#     touchnet_tpu_torch::fused_ce_fwd with its backward the op
#     touchnet_tpu_torch::fused_ce_bwd (register_autograd), each with a fake
#     implementation, so that a compiled loss traces through them. CPU
#     tensors take the two plain versions; CUDA tensors launch the kernels
#     or raise on what the kernels do not take; the plans (fwd_plan,
#     bwd_plan) are made inside the op bodies, at run time. Unlike the JAX wrapper there is no
#     shape the kernel declines: it masks a ragged vocab tail itself.

from typing import NamedTuple, Tuple

import torch

from touchnet_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
# the backward recomputes dl for this many rows at a time into a scratch
# [rows, dl_stride(V)] buffer of the input dtype; the budget bounds that buffer
DL_SCRATCH_BYTES = 2 * 2**30
_TILE = 64  # the 64x64 kernels' row and column tile
# the TMA + wgmma mainloop's tile (csrc kGemmBM, kGemmBN)
WGMMA_ROW_TILE, WGMMA_COL_TILE = 128, 256
# the forward's raster group of row tiles holds at most this much of h, so
# the blocks in flight keep their rows in L2 (50 MB) beside the tiles of w
FWD_GROUP_BYTES = 16 * 2**20
# a block's set-up (ring fill, partial writes) in the forward's wave model,
# in tiles of work
_BLOCK_SETUP_TILES = 0.25
_sm_count = {}


def _rows_reference(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor) -> tuple:
    """(lse, true_logit, m2, argmax) from the full f32 logits [N, V]
    (the products of the input values, accumulated in f32)."""
    logits = torch.matmul(h.float(), w.float().t())
    m = logits.max(dim=-1).values
    l = torch.exp(logits - m[:, None]).sum(dim=-1)
    lse = m + torch.log(l)
    V = w.shape[0]
    valid = (labels >= 0) & (labels < V)
    safe = labels.clamp(0, V - 1).long()
    tl = torch.where(valid, logits.gather(1, safe[:, None])[:, 0],
                     torch.zeros((), dtype=logits.dtype, device=logits.device))
    ai = torch.argmax(logits, dim=-1).to(torch.int32)  # first index of a tie
    return lse, tl, m * LOG2E, ai


def _rows_backward_reference(h, w, labels, lse, dlse, dtl) -> tuple:
    """(dh, dw) in h's / w's dtypes: dl = dlse softmax + dtl onehot in f32,
    cast to h's dtype, then the two products accumulated in f32."""
    logits = torch.matmul(h.float(), w.float().t())
    p = torch.exp(logits - lse[:, None])
    V = w.shape[0]
    valid = ((labels >= 0) & (labels < V)).float()
    onehot = torch.nn.functional.one_hot(labels.clamp(0, V - 1).long(), V).float()
    onehot = onehot * valid[:, None]
    dl = (dlse[:, None] * p + dtl[:, None] * onehot).to(h.dtype)
    dl = dl.float()
    dh = torch.matmul(dl, w.float())
    dw = torch.matmul(dl.t(), h.float())
    return dh.to(h.dtype), dw.to(w.dtype)


def _check(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor) -> None:
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"fused_ce_rows: h {tuple(h.shape)}, w {tuple(w.shape)}")
    if labels.shape != (h.shape[0],):
        raise ValueError(f"fused_ce_rows: labels {tuple(labels.shape)} for {h.shape[0]} rows")
    if h.dtype not in _build.DTYPE_CODES or w.dtype != h.dtype:
        raise ValueError(f"fused_ce_rows: dtypes h {h.dtype} w {w.dtype}: bf16, f16 or f32, "
                         "equal")
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_ce_rows: h and w must be contiguous")
    if w.device != h.device or labels.device != h.device:
        raise ValueError("fused_ce_rows: h, w and labels must be on one device")


def _sms(device) -> int:
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_count[device]


def _mainloop(E: int, dtype: torch.dtype, what: str) -> str:
    """bf16 or f16 whose rows TMA can describe (E a multiple of 8 elements,
    so 16-byte rows): the TMA + wgmma mainloop; other bf16 or f16 the wmma
    tiles; f32 the FMA tiles."""
    if dtype in (torch.bfloat16, torch.float16):
        return "wgmma" if E % 8 == 0 else "wmma"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"{what}: dtype {dtype}: bf16, f16 or f32")


def split_tiles(tiles: int, splits: int) -> int:
    """Vocab tiles of every split but the last (the kernel's arithmetic)."""
    return -(-tiles // splits)


class FwdPlan(NamedTuple):
    mainloop: str  # "wgmma" (TMA + wgmma), "wmma" or "fma" (64x64 tiles)
    row_tile: int
    col_tile: int  # vocab columns of a tile
    splits: int  # vocab splits, each a run of whole tiles, none empty
    group: int  # row tiles of one raster group of the grid


def fwd_plan(N: int, E: int, V: int, dtype: torch.dtype, sms: int) -> FwdPlan:
    """How K3's forward runs for this shape on a card of `sms` SMs.

    The TMA + wgmma mainloop runs one 128 x 256 tile at a time and one block
    per SM. Its grid is row tiles x vocab splits in raster groups of `group`
    row tiles (row tiles fastest inside a group), a group's h within
    FWD_GROUP_BYTES. There are at least sms / group splits, so the blocks in
    flight hold one group's rows; among those counts, the one whose blocks
    fill whole waves best: the fewest waves x (tiles per split + a block's
    set-up), ties to fewer splits. The 64x64 tiles aim at ~16 blocks per SM,
    row tiles fastest."""
    mainloop = _mainloop(E, dtype, "fused_ce_fwd")
    if mainloop != "wgmma":
        row_tiles, tiles = -(-N // _TILE), -(-V // _TILE)
        splits = max(1, min(tiles, -(-16 * sms // row_tiles)))
        return FwdPlan(mainloop, _TILE, _TILE, -(-tiles // split_tiles(tiles, splits)),
                       row_tiles)
    row_tiles, tiles = -(-N // WGMMA_ROW_TILE), -(-V // WGMMA_COL_TILE)
    group = max(1, min(row_tiles, FWD_GROUP_BYTES // (WGMMA_ROW_TILE * E * 2)))
    best = None
    for splits in range(min(tiles, -(-sms // group)), tiles + 1):
        per = split_tiles(tiles, splits)
        if per * (splits - 1) >= tiles:
            continue  # an empty split
        cost = -(-row_tiles * splits // sms) * (per + _BLOCK_SETUP_TILES)
        if best is None or cost < best[0]:
            best = (cost, splits)
    return FwdPlan(mainloop, WGMMA_ROW_TILE, WGMMA_COL_TILE, best[1], group)


def split_run(plan: FwdPlan, V: int, split: int) -> Tuple[int, int]:
    """(first vocab tile, tiles) that split `split` walks, as the kernels
    compute them: whole tiles of plan.col_tile, the last one's columns >= V
    masked."""
    tiles = -(-V // plan.col_tile)
    per = split_tiles(tiles, plan.splits)
    return split * per, min(per, tiles - split * per)


def fwd_block(plan: FwdPlan, N: int, block: int) -> Tuple[int, int]:
    """(row tile, split) of one block of the TMA + wgmma forward's grid, as
    csrc RowStatsOp::tiles computes them."""
    row_tiles = -(-N // plan.row_tile)
    g, in_group = divmod(block, plan.group * plan.splits)
    rows = min(plan.group, row_tiles - g * plan.group)
    return g * plan.group + in_group % rows, in_group // rows


def fused_ce_fwd(h, w, labels) -> tuple:
    """K3 forward on CUDA tensors: (lse, true_logit, m2, argmax) per row."""
    _check(h, w, labels)
    N, E = h.shape
    V = w.shape[0]
    labels = labels.to(torch.int32).contiguous()
    plan = fwd_plan(N, E, V, h.dtype, _sms(h.device))
    if plan.mainloop == "wgmma" and (h.data_ptr() | w.data_ptr()) % 16:
        raise ValueError("fused_ce_fwd: 16-bit h and w must start on 16 bytes")
    f32 = dict(dtype=torch.float32, device=h.device)
    part = torch.empty((3, plan.splits, N), **f32)
    pai = torch.empty((plan.splits, N), dtype=torch.int32, device=h.device)
    lse, tl, m2 = (torch.empty(N, **f32) for _ in range(3))
    ai = torch.empty(N, dtype=torch.int32, device=h.device)
    lib = _build.load_library()
    with torch.cuda.device(h.device):
        err = lib.tn_ce_fwd(
            h.data_ptr(), w.data_ptr(), labels.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(), pai.data_ptr(),
            lse.data_ptr(), tl.data_ptr(), m2.data_ptr(), ai.data_ptr(),
            N, E, V, plan.splits, plan.group, _build.DTYPE_CODES[h.dtype],
            int(plan.mainloop == "wgmma"), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "fused_ce_fwd")
    fused_ce_fwd.launches += 1
    return lse, tl, m2, ai


fused_ce_fwd.launches = 0


def bwd_chunk_rows(N: int, V: int, itemsize: int, row_tile: int = _TILE) -> int:
    """Rows per dl chunk of the backward: the most whole row tiles whose
    [rows, V] scratch fits DL_SCRATCH_BYTES, and no more than N needs."""
    chunk = max(row_tile, DL_SCRATCH_BYTES // (V * itemsize) // row_tile * row_tile)
    return min(chunk, -(-N // row_tile) * row_tile)


def dl_stride(V: int) -> int:
    """The dl scratch's row stride: V rounded up to 8 elements, so every row
    starts on 16 bytes (TMA's rule) whatever V is."""
    return -(-V // 8) * 8


class BwdPlan(NamedTuple):
    mainloop: str  # "wgmma" (TMA + wgmma), "wmma" or "fma" (64x64 tiles)
    row_tile: int
    chunk: int  # rows per dl chunk, whole row tiles
    ldl: int  # the dl scratch's row stride


def bwd_plan(N: int, E: int, V: int, dtype: torch.dtype) -> BwdPlan:
    """How K3's backward runs for this shape: bf16 or f16 whose rows TMA
    can describe (E a multiple of 8 elements, so 16-byte rows) takes the TMA
    + wgmma mainloop in 128-row tiles; other bf16 or f16 the wmma tiles and
    f32 the FMA tiles, 64 rows each."""
    mainloop = _mainloop(E, dtype, "fused_ce_bwd")
    row_tile = WGMMA_ROW_TILE if mainloop == "wgmma" else _TILE
    ldl = dl_stride(V)
    itemsize = torch.finfo(dtype).bits // 8
    return BwdPlan(mainloop, row_tile, bwd_chunk_rows(N, ldl, itemsize, row_tile), ldl)


def fused_ce_bwd(h, w, labels, lse, dlse, dtl) -> tuple:
    """K3 backward on CUDA tensors: (dh in h's dtype, dw in w's dtype).
    dw is accumulated in an f32 [V, E] buffer, one output tile per block
    and the row chunks in order, so it is the same bit for bit across runs."""
    _check(h, w, labels)
    N, E = h.shape
    V = w.shape[0]
    labels = labels.to(torch.int32).contiguous()
    lse, dlse, dtl = (x.float().contiguous() for x in (lse, dlse, dtl))
    plan = bwd_plan(N, E, V, h.dtype)
    if plan.mainloop == "wgmma" and (h.data_ptr() | w.data_ptr()) % 16:
        raise ValueError("fused_ce_bwd: 16-bit h and w must start on 16 bytes")
    dl = torch.empty((plan.chunk, plan.ldl), dtype=h.dtype, device=h.device)
    dh = torch.empty_like(h)
    dw = torch.empty((V, E), dtype=torch.float32, device=h.device)
    lib = _build.load_library()
    with torch.cuda.device(h.device):
        err = lib.tn_ce_bwd(
            h.data_ptr(), w.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), dlse.data_ptr(), dtl.data_ptr(),
            dh.data_ptr(), dw.data_ptr(), dl.data_ptr(),
            N, E, V, plan.chunk, plan.ldl, _build.DTYPE_CODES[h.dtype],
            int(plan.mainloop == "wgmma"), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "fused_ce_bwd")
    fused_ce_bwd.launches += 1
    return dh, dw.to(w.dtype)


fused_ce_bwd.launches = 0


@torch.library.custom_op("touchnet_tpu_torch::fused_ce_fwd", mutates_args=(),
                         device_types="cuda")
def _ce_fwd_op(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's forward on CUDA tensors."""
    return fused_ce_fwd(h, w, labels)


@_ce_fwd_op.register_kernel("cpu")
def _ce_fwd_cpu(h, w, labels):
    return tuple(x.contiguous() for x in _rows_reference(h, w, labels))


@_ce_fwd_op.register_fake
def _ce_fwd_fake(h, w, labels):
    N = h.shape[0]
    f32 = [h.new_empty((N,), dtype=torch.float32) for _ in range(3)]
    return (*f32, h.new_empty((N,), dtype=torch.int32))


@torch.library.custom_op("touchnet_tpu_torch::fused_ce_bwd", mutates_args=(),
                         device_types="cuda")
def _ce_bwd_op(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
               dlse: torch.Tensor, dtl: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's backward on CUDA tensors."""
    return fused_ce_bwd(h, w, labels, lse, dlse, dtl)


@_ce_bwd_op.register_kernel("cpu")
def _ce_bwd_cpu(h, w, labels, lse, dlse, dtl):
    return tuple(x.contiguous() for x in _rows_backward_reference(h, w, labels, lse, dlse, dtl))


@_ce_bwd_op.register_fake
def _ce_bwd_fake(h, w, labels, lse, dlse, dtl):
    return torch.empty_like(h), torch.empty_like(w)


def _ce_setup(ctx, inputs, output):
    h, w, labels = inputs
    lse, _tl, m2, ai = output
    ctx.save_for_backward(h, w, labels, lse)
    ctx.mark_non_differentiable(m2, ai)


def _ce_backward(ctx, dlse, dtl, _dm2, _dai):
    """lse and true_logit carry gradients to h and w; m2 and argmax do not."""
    h, w, labels, lse = ctx.saved_tensors
    if dlse is None:
        dlse = torch.zeros_like(lse)
    if dtl is None:
        dtl = torch.zeros_like(lse)
    dh, dw = CE_BWD_OP(h, w, labels, lse, dlse.float().contiguous(), dtl.float().contiguous())
    return dh, dw, None


_ce_fwd_op.register_autograd(_ce_backward, setup_context=_ce_setup)
CE_FWD_OP = torch.ops.touchnet_tpu_torch.fused_ce_fwd.default
CE_BWD_OP = torch.ops.touchnet_tpu_torch.fused_ce_bwd.default


class _PlainCERows(torch.autograd.Function):
    """The plain versions of K3's two directions as one autograd Function,
    on any device (chip_smoke holds the kernels to it on the card)."""

    @staticmethod
    def forward(ctx, h, w, labels):
        lse, tl, m2, ai = _rows_reference(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.mark_non_differentiable(m2, ai)
        return lse, tl, m2, ai

    @staticmethod
    def backward(ctx, dlse, dtl, _dm2, _dai):
        h, w, labels, lse = ctx.saved_tensors
        if dlse is None:
            dlse = torch.zeros_like(lse)
        if dtl is None:
            dtl = torch.zeros_like(lse)
        dh, dw = _rows_backward_reference(h, w, labels, lse, dlse, dtl)
        return dh, dw, None


def fused_ce_rows_reference(h: torch.Tensor, w: torch.Tensor,
                            labels: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The plain version of fused_ce_rows on any device (an autograd
    Function over _rows_reference and _rows_backward_reference)."""
    return _PlainCERows.apply(h, w, labels)


def fused_ce_rows(h: torch.Tensor, w: torch.Tensor,
                  labels: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Fused lm-head + CE row statistics without materialising logits (K3).

    h [N, E] and w [V, E] in one dtype (bf16, f16 or f32); labels [N] int, where
    anything outside [0, V) (padding, ignore_index) gives true_logit 0.
    Returns (lse, true_logit, m2 = row max in base 2, argmax) in f32 / int32;
    argmax ties go to the smallest index. Through the custom op
    touchnet_tpu_torch::fused_ce_fwd (CE_FWD_OP; its backward the op
    touchnet_tpu_torch::fused_ce_bwd): the kernels on CUDA tensors, the
    plain versions on CPU tensors; other devices raise. Both ops have fake
    implementations, so a compiled loss calls them from its graph."""
    if h.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_ce_rows: no kernel for device {h.device}")
    return CE_FWD_OP(h, w, labels)
