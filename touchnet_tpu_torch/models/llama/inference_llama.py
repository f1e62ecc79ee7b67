# Copyright (c) 2026 touchnet_tpu authors.
# KV-cache autoregressive generation for the Llama decoder.
#
# Port of touchnet_tpu/models/llama/inference_llama.py, the serving core the
# ASR CLIs call. The JAX module compiles prefill and decode into two static
# programs (lax.scan over stacked layers, lax.while_loop over steps); here
# both run eagerly: a Python loop over the per-layer modules and a Python
# loop over decode steps, with the cache updated in place.
#
# Attention dispatch, per layer:
#   - decode step (decode_valid, one token): ops.decode_attention, the
#     CUDA flash-decode K4 on the card, its plain version on the CPU;
#   - chunked prefill (prefill_ctx): ops.attention.flash_prefill, K1 over
#     the strided halves of the packed cache;
#   - single-shot prefill (flash_prefill): ops.attention.flash_attention, K1
#     over the chunk's own k/v;
#   - anything else (attn_mask, or a multi-token step with neither flag):
#     the dense einsum path _cached_attention.
# There is no other gate: config.attn_implementation is not read here (the
# JAX generate ignores it too), so CUDA tensors always reach the kernels.
# The JAX module's TPU-only gates (backend, 128-lane head dims, a minimum
# context) and its 128-lane prefill-chunk rounding are Mosaic constraints
# and have no counterpart.

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from touchnet_tpu_torch.models.common import linear, rope_frequencies
from touchnet_tpu_torch.models.llama import head_weight
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.ops import attention as attn_ops
from touchnet_tpu_torch.ops import decode_attention as decode_ops

NEG_INF = -1e30
# generate reads its all-rows-done flag (a host sync) once every this many
# steps: a sync each step would keep the host from queueing the next step's
# launches while the card works. Rows already done only emit eos_id.
EOS_CHECK_EVERY = 8


class KVCache(NamedTuple):
    # PACKED [L, B, Hkv, S, 2*Dh]: K in [0, Dh), V in [Dh, 2*Dh) — the JAX
    # package's layout, so the two caches compare slot for slot. Every step
    # writes its new slots into this one tensor in place; kv[li] is a view,
    # so no layer is ever extracted or reinserted.
    kv: torch.Tensor


def init_cache(config: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> KVCache:
    # capacity rounds up to DECODE_BLOCK as in the JAX package (whose TPU
    # kernel needs it). Harmless here: the extra slots are never valid, the
    # CUDA kernels never read them, and the shapes stay equal to JAX's.
    block = decode_ops.DECODE_BLOCK
    max_len = -(-max_len // block) * block
    shape = (config.num_hidden_layers, batch, config.num_key_value_heads,
             max_len, 2 * config.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device))


def rope_inv_freq(config: LlamaConfig, device) -> torch.Tensor:
    return rope_frequencies(config.head_dim, config.rope_theta,
                            rope_scaling=config.rope_scaling, device=device)


def _cached_attention(q, kv_cache, valid_len, scale, attn_mask=None):
    """q [B,Tq,H,D] attends the packed cache layer [B,Hkv,S,2D] at
    positions < valid_len (its own rows causally for Tq > 1); attn_mask
    [B,S] overrides that for a one-token step. GQA-grouped: query heads
    fold into their kv head's contraction, the cache is never expanded."""
    B, Tq, H, D = q.shape
    if attn_mask is not None and Tq != 1:
        raise ValueError(
            f"attn_mask is a per-cache-slot decode mask; Tq={Tq} chunks "
            "must use the causal valid_len path or flash_prefill"
        )
    Hkv, S = kv_cache.shape[1], kv_cache.shape[2]
    qg = q.reshape(B, Tq, Hkv, H // Hkv, D)
    s = torch.einsum(
        "btkgd,bksd->bkgts", qg.float(), kv_cache[..., :D].float()
    ) * scale  # [B,Hkv,G,Tq,S] f32
    if attn_mask is None:
        # rows are at absolute positions valid_len - Tq + t
        rows = valid_len[:, None] - Tq + torch.arange(Tq, device=q.device)[None, :]
        mask = torch.arange(S, device=q.device)[None, None, :] <= rows[:, :, None]
    else:
        mask = attn_mask[:, None, :]
    s.masked_fill_(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bksd->btkgd", p.to(kv_cache.dtype), kv_cache[..., D:])
    return out.reshape(B, Tq, H, D).to(q.dtype)


@torch.no_grad()
def forward_step(
    model,  # LlamaForCausalLM
    inputs_embeds: torch.Tensor,  # [B, Tq, E] (prefill chunk or 1-token step)
    cache: KVCache,
    start_pos: torch.Tensor,  # [B] absolute position of inputs_embeds[:, 0]
    config: LlamaConfig,
    compute_dtype=torch.bfloat16,
    *,
    write_pos: Optional[int] = None,  # uniform cache slot of inputs_embeds[:, 0]
    attn_mask: Optional[torch.Tensor] = None,  # [B, S] cache-slot validity
    flash_prefill: bool = False,  # Tq>1 chunk at start_pos 0: flash kernel
    prefill_ctx: Optional[int] = None,  # chunked prefill: the chunk's offset
    logits_indices: Optional[torch.Tensor] = None,  # [B] project ONLY these
    decode_valid=None,  # (prompt_len [B], base, last): ragged decode mask
    inv_freq: Optional[torch.Tensor] = None,  # rope_inv_freq(config, device)
) -> tuple:
    """Returns (logits [B, Tq, V] f32, cache); the cache is updated in place.

    start_pos drives rope and the default causal validity. write_pos, when
    given, is the slot every row's kv is stored at; without it each row
    writes at its own start_pos (clamped so the chunk fits, as
    lax.dynamic_update_slice does). logits_indices projects one position
    per row ([B, 1, V]): a long prefill's other rows are never projected.
    inv_freq: the rope frequencies, which a loop of steps computes once;
    None computes them here."""
    B, Tq, _ = inputs_embeds.shape
    device = inputs_embeds.device
    Dh = config.head_dim
    kv_all = cache.kv
    S = kv_all.shape[3]
    h = inputs_embeds.to(compute_dtype)
    position_ids = start_pos[:, None] + torch.arange(Tq, device=device)[None, :]
    valid_len = start_pos + Tq
    scale = 1.0 / math.sqrt(Dh)
    if inv_freq is None:
        inv_freq = rope_inv_freq(config, device)
    if decode_valid is not None and Tq != 1:
        raise ValueError(f"decode_valid is a one-token decode mask; got Tq={Tq}")
    if prefill_ctx is not None and Tq > 1:
        # one chunk's validity, shared by every layer: the chunk's rows form
        # one segment; cache slots up to the chunk's end are written (1),
        # later ones are not (0, which only padding rows would match)
        q_seg = torch.ones((B, Tq), dtype=torch.int32, device=device)
        kv_seg = (torch.arange(S, device=device) < prefill_ctx + Tq).to(torch.int32)
        kv_seg = kv_seg.expand(B, S).contiguous()
    row_slots = None
    if write_pos is None:
        row_slots = [min(max(int(sp), 0), S - Tq) for sp in start_pos.tolist()]

    def attend_in(li: int) -> Callable:
        def attend(q, k, v):
            kv_l = kv_all[li]  # a view: writes below land in the cache itself
            kv_new = torch.cat([k, v], dim=-1).transpose(1, 2)  # [B, Hkv, Tq, 2D]
            if write_pos is not None:
                kv_l[:, :, write_pos:write_pos + Tq] = kv_new
            else:
                for b, sp in enumerate(row_slots):
                    kv_l[b, :, sp:sp + Tq] = kv_new[b]
            if decode_valid is not None:
                plen, base, last = decode_valid
                return decode_ops.decode_attention(
                    q[:, 0], kv_all, plen, base, last, scale, layer_idx=li
                )[:, None]
            if prefill_ctx is not None and Tq > 1:
                return attn_ops.flash_prefill(q, kv_l, q_seg, kv_seg,
                                              q_offset=prefill_ctx, scale=scale)
            if flash_prefill and Tq > 1:
                return attn_ops.flash_attention(q, k, v, None, True, scale)[0]
            return _cached_attention(q, kv_l, valid_len, scale, attn_mask)

        return attend

    for li, layer in enumerate(model.model.layers):
        h = layer(h, position_ids, inv_freq, attend_in(li))
    h = model.model.norm(h)
    if logits_indices is not None:
        h = h[torch.arange(B, device=device), logits_indices][:, None]
    logits = linear(h, head_weight(model, config).to(compute_dtype))
    return logits.float(), cache


# ---------------------------------------------------------------------------
# Sampling: temperature / top-k / top-p / repetition penalty (the JAX
# module's sample_token, split so the deterministic parts can be tested)
# ---------------------------------------------------------------------------


def apply_repetition_penalty(logits, repetition_penalty: float,
                             recent_tokens: Optional[torch.Tensor]):
    """Divide positive / multiply negative logits of the tokens in
    recent_tokens [B, W] (-1 = empty) by the penalty."""
    if repetition_penalty == 1.0 or recent_tokens is None:
        return logits
    hits = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    hits.scatter_add_(1, recent_tokens.clamp(min=0).long(),
                      (recent_tokens >= 0).to(torch.int32))
    penalized = torch.where(logits > 0, logits / repetition_penalty,
                            logits * repetition_penalty)
    return torch.where(hits > 0, penalized, logits)


def warp_logits(logits, temperature: float, top_k: int = 0, top_p: float = 0.0):
    """Temperature, then top-k, then the top-p nucleus (the crossing token
    included; every token tied with the cut is kept). Masked logits are
    NEG_INF."""
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if 0.0 < top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        exclusive = torch.cumsum(probs, dim=-1) - probs
        kept = torch.where(exclusive < top_p, desc, torch.inf)
        cut = kept.min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < cut, NEG_INF)
    return logits


def sample_token(
    logits: torch.Tensor,  # [B, V]
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    repetition_penalty: float = 1.0,
    recent_tokens: Optional[torch.Tensor] = None,  # [B, W] (-1 = empty)
    top_p: float = 0.0,
) -> torch.Tensor:
    """Greedy (temperature <= 0) or a draw from ``generator``. Returns [B]."""
    logits = apply_repetition_penalty(logits.float(), repetition_penalty,
                                      recent_tokens)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def ban_repeated_ngrams(logits, out: torch.Tensor, hstep: int, n: int):
    """HF NoRepeatNGramLogitsProcessor over the history out[:, :hstep]: ban
    token v when the last n-1 tokens followed by v already occur."""
    B, T_out = out.shape
    start = min(max(hstep - (n - 1), 0), T_out - (n - 1))
    ctx = out[:, start:start + n - 1]
    nj = T_out - (n - 1)
    match = torch.ones((B, nj), dtype=torch.bool, device=out.device)
    for i in range(n - 1):
        match &= out[:, i:nj + i] == ctx[:, i:i + 1]
    # the ngram's final token must already be in the history
    match &= (torch.arange(nj, device=out.device) + (n - 1) < hstep)[None, :]
    hits = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    hits.scatter_add_(1, out[:, n - 1:].clamp(min=0), match.to(torch.int32))
    return logits.masked_fill(hits > 0, NEG_INF)


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(
    model,
    config: LlamaConfig,
    prompt_embeds: torch.Tensor,  # [B, Tp, E]
    prompt_len: torch.Tensor,  # [B]
    max_new_tokens: int,
    *,
    compute_dtype=torch.bfloat16,
    prefill_chunk: Optional[int] = None,
    inv_freq: Optional[torch.Tensor] = None,
) -> tuple:
    """Fill a fresh cache with the (right-padded) prompts. Returns (cache,
    last_logits [B, V] f32 at position prompt_len - 1, Tp), where Tp, the
    padded prompt length, is the first decode slot.

    prefill_chunk: prefill in [B, chunk] steps; each chunk's queries attend
    the cache prefix through K1 (peak activations O(chunk), not O(Tp))."""
    B, Tp, _ = prompt_embeds.shape
    device = prompt_embeds.device
    if inv_freq is None:
        inv_freq = rope_inv_freq(config, device)
    if prefill_chunk:
        C = min(prefill_chunk, Tp)
        pad = (-Tp) % C
        if pad:
            prompt_embeds = F.pad(prompt_embeds, (0, 0, 0, pad))
        Tp += pad  # decode slots start after the chunk-padded prompt
    cache = init_cache(config, B, Tp + max_new_tokens, compute_dtype, device)
    prompt_len = prompt_len.to(device)
    if prefill_chunk:
        last_idx = prompt_len - 1  # the position whose logits seed decoding
        V = head_weight(model, config).shape[0]
        last_logits = torch.zeros((B, V), dtype=torch.float32, device=device)
        for off in range(0, Tp, C):
            logits, _ = forward_step(
                model, prompt_embeds[:, off:off + C], cache,
                torch.full((B,), off, device=device), config, compute_dtype,
                write_pos=off, prefill_ctx=off,
                logits_indices=(last_idx - off).clamp(0, C - 1), inv_freq=inv_freq,
            )
            in_chunk = (last_idx >= off) & (last_idx < off + C)
            last_logits = torch.where(in_chunk[:, None], logits[:, 0], last_logits)
    else:
        # start_pos 0 for all rows: padded rows attend causally; what lies
        # beyond prompt_len is never read back
        logits, _ = forward_step(
            model, prompt_embeds, cache,
            torch.zeros((B,), dtype=torch.long, device=device), config,
            compute_dtype, write_pos=0, flash_prefill=True,
            logits_indices=prompt_len - 1, inv_freq=inv_freq,
        )
        last_logits = logits[:, 0]
    return cache, last_logits, Tp


@torch.no_grad()
def decode_step(model, config: LlamaConfig, cache: KVCache,
                token_embeds: torch.Tensor, prompt_len: torch.Tensor, Tp: int,
                step: int, compute_dtype=torch.bfloat16,
                inv_freq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step for token_embeds [B, 1, E]. Its kv lands at the
    uniform slot Tp + step (in place); its rope position is the row's
    prompt_len + step. Valid slots: the row's prompt [0, prompt_len) and
    the decoded slots [Tp, Tp + step]; the gap holds prompt padding.
    Returns logits [B, V] f32."""
    logits, _ = forward_step(
        model, token_embeds, cache, prompt_len + step, config, compute_dtype,
        write_pos=Tp + step, decode_valid=(prompt_len, Tp, Tp + step),
        inv_freq=inv_freq,
    )
    return logits[:, 0]


@torch.no_grad()
def generate(
    model,
    config: LlamaConfig,
    prompt_embeds: torch.Tensor,  # [B, Tp, E] (fused multimodal prompts allowed)
    prompt_len: torch.Tensor,  # [B] true lengths (right padding)
    max_new_tokens: int,
    *,
    eos_id: int,
    embed_fn: Optional[Callable] = None,  # token -> embedding for decode steps
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    repetition_penalty: float = 1.0,
    repetition_window: int = 16,
    no_repeat_ngram_size: int = 0,
    seed: int = 0,
    compute_dtype=torch.bfloat16,
    prefill_chunk: Optional[int] = None,
    prime_tokens: Optional[tuple] = None,
) -> torch.Tensor:
    """Batch greedy/sampled decode. Returns [B, max_new_tokens] (eos-padded).

    prime_tokens: token ids treated as already-generated history before
    step 0: they seed the repetition-penalty window and the no-repeat-ngram
    history (the window grows by len(prime_tokens)). Draws come from a
    torch.Generator seeded with ``seed`` on the prompts' device; they
    differ from jax.random's for the same seed. The loop stops early once
    every row has emitted eos_id, checked every EOS_CHECK_EVERY steps."""
    B = prompt_embeds.shape[0]
    device = prompt_embeds.device
    prompt_len = prompt_len.to(device)
    if embed_fn is None:
        embed_fn = lambda tok: F.embedding(tok, model.model.embed_tokens.weight)  # noqa: E731
    inv_freq = rope_inv_freq(config, device)
    cache, last_logits, Tp = prefill(
        model, config, prompt_embeds, prompt_len, max_new_tokens,
        compute_dtype=compute_dtype, prefill_chunk=prefill_chunk, inv_freq=inv_freq,
    )

    prime = tuple(int(t) for t in (prime_tokens or ()))
    P = len(prime)
    window = max(repetition_window, 1) + P
    out = torch.full((B, P + max_new_tokens), eos_id, dtype=torch.long, device=device)
    recent = torch.full((B, window), -1, dtype=torch.long, device=device)
    if P:
        prime_row = torch.tensor(prime, dtype=torch.long, device=device)
        out[:, :P] = prime_row
        recent[:, window - P:] = prime_row
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    for step in range(max_new_tokens):
        if step % EOS_CHECK_EVERY == 0 and bool(done.all()):
            break
        if no_repeat_ngram_size >= 2:
            last_logits = ban_repeated_ngrams(last_logits, out, step + P,
                                              no_repeat_ngram_size)
        tok = sample_token(last_logits, generator, temperature, top_k,
                           repetition_penalty, recent, top_p)
        tok = torch.where(done, eos_id, tok)
        out[:, P + step] = tok
        done |= tok == eos_id
        recent = torch.cat([recent[:, 1:], tok[:, None]], dim=1)
        last_logits = decode_step(model, config, cache, embed_fn(tok)[:, None],
                                  prompt_len, Tp, step, compute_dtype, inv_freq)
    return out[:, P:]
