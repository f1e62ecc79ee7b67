# Copyright (c) 2026 touchnet_tpu authors.
# Dual-stream (text + audio) KV-cache generation for Kimi-Audio.
#
# Port of touchnet_tpu/models/kimi_audio/generate_kimi_audio.py:
# SamplerSettings (:32), init_dual_cache (:41), forward_step_dual (:52) and
# generate_dual (:131). Each step samples the text head (the main stack)
# and the audio head (the mimo stack) with their own settings, holds the
# audio stream at <|im_kimia_text_blank|> for the first
# kimia_mimo_audiodelaytokens steps (and always when output_type is
# "text"), and feeds embed(text) + embed(audio) back as the next input.
#
# The main (L) and mimo (L_mimo) stacks share ONE packed cache [L + L_mimo,
# B, Hkv, S, 2D]: rows [0, L) hold the main layers, [L, L + L_mimo) the
# mimo layers, which fork from the hidden state after layer
# kimia_mimo_transformer_from_layer_index. Every layer of both stacks
# attends through inference_llama.cached_attention, the same per-layer
# step as llama serving, with the layer index running on into the mimo
# rows: K1 for prefill (single-shot or chunked), K4 for decode, which reads
# row layer_idx of the whole cache in place.
#
# As the port's generate: a Python loop over steps that reads its
# all-rows-done flag every inference_llama.EOS_CHECK_EVERY steps (a done
# row only emits blanks, which is what the JAX while_loop leaves in its
# buffers), and draws from a torch.Generator seeded with ``seed`` on the
# prompts' device, whose draws differ from jax.random's: tokens equal
# JAX's under greedy samplers only. With output_type "text" the audio head
# is not sampled (its token is held at blank either way).

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig
from touchnet_tpu_torch.models.llama import inference_llama as inf


class SamplerSettings(NamedTuple):
    """One stream's sampling knobs (reference KimiASampler fields)."""

    temperature: float = 0.0
    top_k: int = 0
    repetition_penalty: float = 1.0
    repetition_window: int = 16


def init_dual_cache(config: KimiAudioConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16, device="cuda") -> inf.KVCache:
    """inference_llama.init_cache with a row for each layer of both stacks."""
    tc = config.text_config
    both = dataclasses.replace(tc, num_hidden_layers=tc.num_hidden_layers
                               + config.kimia_mimo_layers)
    return inf.init_cache(both, batch, max_len, dtype, device)


@torch.no_grad()
def forward_step_dual(
    model,  # KimiAudioForCausalLM
    inputs_embeds: torch.Tensor,  # [B, Tq, E]
    cache: inf.KVCache,
    start_pos: torch.Tensor,  # [B]
    config: KimiAudioConfig,
    compute_dtype=torch.bfloat16,
    *,
    write_pos: Optional[int] = None,
    flash_prefill: bool = False,
    prefill_ctx: Optional[int] = None,  # chunked prefill: the chunk's offset
    logits_indices: Optional[torch.Tensor] = None,
    decode_valid=None,
    inv_freq: Optional[torch.Tensor] = None,
) -> tuple:
    """(text_logits, audio_logits, cache), both [B, Tq, V] f32 ([B, 1, V]
    with logits_indices); the cache is updated in place. The arguments are
    inference_llama.forward_step's."""
    tc = config.text_config
    mp = model.model
    Tq = inputs_embeds.shape[1]
    device = inputs_embeds.device
    h = inputs_embeds.to(compute_dtype)
    position_ids = start_pos[:, None] + torch.arange(Tq, device=device)[None, :]
    if inv_freq is None:
        inv_freq = inf.rope_inv_freq(tc, device)
    attend_in = inf.cached_attention(
        cache, start_pos, Tq, tc, write_pos=write_pos, flash_prefill=flash_prefill,
        prefill_ctx=prefill_ctx, decode_valid=decode_valid)
    L = tc.num_hidden_layers
    fork = config.kimia_mimo_transformer_from_layer_index + 1
    for li in range(fork):
        h = mp.layers[li](h, position_ids, inv_freq, attend_in(li))
    h_mimo = h
    for li in range(fork, L):
        h = mp.layers[li](h, position_ids, inv_freq, attend_in(li))
    # the mimo stream continues the cache at rows [L, L + L_mimo)
    for j, layer in enumerate(mp.mimo_layers):
        h_mimo = layer(h_mimo, position_ids, inv_freq, attend_in(L + j))
    text_logits = inf.project_rows(h, mp.norm, model.lm_head.weight, logits_indices,
                                   compute_dtype)
    audio_logits = inf.project_rows(h_mimo, mp.mimo_norm, model.mimo_output.weight,
                                    logits_indices, compute_dtype)
    return text_logits, audio_logits, cache


@torch.no_grad()
def prefill_dual(model, config: KimiAudioConfig, prompt_embeds: torch.Tensor,
                 prompt_len: torch.Tensor, max_new_tokens: int, *,
                 compute_dtype=torch.bfloat16, prefill_chunk: Optional[int] = None,
                 inv_freq: Optional[torch.Tensor] = None) -> tuple:
    """Fill a fresh dual cache with the right-padded prompts. Returns (cache,
    text logits [B, V], audio logits [B, V], Tp): the logits at position
    prompt_len - 1, and the first decode slot Tp (the chunk-padded prompt
    length). As inference_llama.prefill, over both stacks."""
    B, Tp, _ = prompt_embeds.shape
    device = prompt_embeds.device
    if prefill_chunk:
        C = min(prefill_chunk, Tp)
        pad = (-Tp) % C
        if pad:
            prompt_embeds = F.pad(prompt_embeds, (0, 0, 0, pad))
        Tp += pad
    cache = init_dual_cache(config, B, Tp + max_new_tokens, compute_dtype, device)
    if not prefill_chunk:
        tl, al, _ = forward_step_dual(
            model, prompt_embeds, cache, torch.zeros((B,), dtype=torch.long, device=device),
            config, compute_dtype, write_pos=0, flash_prefill=True,
            logits_indices=prompt_len - 1, inv_freq=inv_freq)
        return cache, tl[:, 0], al[:, 0], Tp
    last_idx = prompt_len - 1
    V = model.lm_head.weight.shape[0]
    tl = torch.zeros((B, V), dtype=torch.float32, device=device)
    al = torch.zeros((B, model.mimo_output.weight.shape[0]), dtype=torch.float32,
                     device=device)
    for off in range(0, Tp, C):
        t2, a2, _ = forward_step_dual(
            model, prompt_embeds[:, off:off + C], cache, torch.full((B,), off, device=device),
            config, compute_dtype, write_pos=off, prefill_ctx=off,
            logits_indices=(last_idx - off).clamp(0, C - 1), inv_freq=inv_freq)
        in_chunk = ((last_idx >= off) & (last_idx < off + C))[:, None]
        tl = torch.where(in_chunk, t2[:, 0], tl)
        al = torch.where(in_chunk, a2[:, 0], al)
    return cache, tl, al, Tp


@torch.no_grad()
def generate_dual(
    model,  # KimiAudioForCausalLM
    config: KimiAudioConfig,
    prompt_embeds: torch.Tensor,  # [B, Tp, E] (audio + text streams summed)
    prompt_len: torch.Tensor,  # [B]
    max_new_tokens: int,
    *,
    blank_id: int,  # <|im_kimia_text_blank|> (reference hardcodes 151666)
    eos_id: int,    # <|im_kimia_text_eos|>   (reference hardcodes 151667)
    # defaults = the reference generate() signature's sampler knobs
    # (reference touchnet/models/kimi_audio/modeling_kimi_audio.py:1084-1100:
    # text greedy WITH repetition penalty 1.1/window 16 — the penalty runs
    # before the argmax; audio temp 0.8 / top-k 10 / window 64). Deviation,
    # kept from the JAX package: the reference arms its penalty only once
    # MORE than `window` tokens exist; this windowed buffer penalizes from
    # the first token over whatever history exists (stricter for the first
    # `window` steps).
    text_sampler: SamplerSettings = SamplerSettings(
        temperature=0.0, top_k=5, repetition_penalty=1.1, repetition_window=16),
    audio_sampler: SamplerSettings = SamplerSettings(
        temperature=0.8, top_k=10, repetition_penalty=1.0, repetition_window=64),
    output_type: str = "both",  # "text" holds the audio stream at blank
    audio_delay_tokens: Optional[int] = None,
    seed: int = 0,
    compute_dtype=torch.bfloat16,
    prefill_chunk: Optional[int] = None,
) -> tuple:
    """Returns (text_tokens [B, N], audio_tokens [B, N]), blank-padded.

    Text eos finishes a row (its text stream emits blank after); the audio
    stream starts after `kimia_mimo_audiodelaytokens` blanks (the reference's
    semantics). Audio tokens are VQ codes offset by kimia_token_offset, for
    a vocoder (out of scope, as in the reference's ASR recipes)."""
    tc = config.text_config
    delay = (config.kimia_mimo_audiodelaytokens
             if audio_delay_tokens is None else audio_delay_tokens)
    B = prompt_embeds.shape[0]
    device = prompt_embeds.device
    prompt_len = prompt_len.to(device)
    embed_w = model.model.embed_tokens.weight
    inv_freq = inf.rope_inv_freq(tc, device)
    cache, tl, al, Tp = prefill_dual(
        model, config, prompt_embeds, prompt_len, max_new_tokens,
        compute_dtype=compute_dtype, prefill_chunk=prefill_chunk, inv_freq=inv_freq)

    text_only = output_type == "text"
    N = max_new_tokens
    text_out = torch.full((B, N), blank_id, dtype=torch.long, device=device)
    audio_out = torch.full((B, N), blank_id, dtype=torch.long, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    trecent = torch.full((B, max(text_sampler.repetition_window, 1)), -1, dtype=torch.long,
                         device=device)
    arecent = torch.full((B, max(audio_sampler.repetition_window, 1)), -1, dtype=torch.long,
                         device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    blank = torch.full((B,), blank_id, dtype=torch.long, device=device)
    for step in range(N):
        if step % inf.EOS_CHECK_EVERY == 0 and bool(done.all()):
            break
        t_tok = inf.sample_token(tl, generator, text_sampler.temperature, text_sampler.top_k,
                                 text_sampler.repetition_penalty, trecent)
        t_tok = torch.where(done, blank_id, t_tok)
        done |= t_tok == eos_id
        # the audio stream: blank during the delay ramp, once the row is
        # done, and always when only text is wanted (reference
        # _generate_loop:1194-1199)
        if text_only or step < delay:
            a_tok = blank
        else:
            a_tok = inf.sample_token(al, generator, audio_sampler.temperature,
                                     audio_sampler.top_k, audio_sampler.repetition_penalty,
                                     arecent)
            a_tok = torch.where(done, blank_id, a_tok)
        text_out[:, step] = t_tok
        audio_out[:, step] = a_tok
        trecent = torch.cat([trecent[:, 1:], t_tok[:, None]], dim=1)
        arecent = torch.cat([arecent[:, 1:], a_tok[:, None]], dim=1)
        emb = (F.embedding(t_tok, embed_w) + F.embedding(a_tok, embed_w))[:, None]
        tl2, al2, _ = forward_step_dual(
            model, emb, cache, prompt_len + step, config, compute_dtype,
            write_pos=Tp + step, decode_valid=(prompt_len, Tp, Tp + step), inv_freq=inv_freq)
        tl, al = tl2[:, 0], al2[:, 0]
    return text_out, audio_out
