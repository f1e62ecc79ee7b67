# Copyright (c) 2026 touchnet_tpu authors.
# Batch ASR inference for Kimi-Audio, on the card: stage 4 of the SFT
# recipe with model_type kimi_audio, as examples/audio/sft/asr/wenetspeech/
# run.sh:172-181 writes it (the config and the tokenizer come from the
# export, utils/inference.resolve_model_files):
#
#     python -m touchnet_tpu_torch.models.kimi_audio.inference_kimi_audio \
#         --model_path <HF dir with config.json and the tokenizer> \
#         --model_dtype float32 --instruct "Generate the transcription:" \
#         --data_list <jsonl of {key, wav, txt}> --output_dir <dir> \
#         --batch_size 1 --inference_enable_liger_kernel true \
#         --num_workers 16 --prefetch 8 [--output_type text|both]
#
# Port of touchnet_tpu/models/kimi_audio/inference_kimi_audio.py (main,
# :42-173). On prefetch threads each wav becomes whisper features (padded to
# 30 s) and the two parallel prompt streams: the text stream holds the
# instruct and a blank per audio token, the audio stream a blank per
# instruct token and the audio tokens between the media markers
# (n_tok = frame_mask[::2][::4].sum()). Each batch runs
# prepare_audio_input_embs (the tower through K1, the adaptor, the frozen
# speech tokenizer's codes) and sums the streams' embeddings. Then
#   --output_type text (ASR): the port's generate over the text stack (K1
#     prefill, K4 decode) with the audio stream held at blank through
#     embed_fn, greedy with repetition penalty 1.1 over 16 tokens;
#   --output_type both: generate_dual over both stacks, whose rows also
#     carry "audio_codes" (the sampled audio ids >= kimia_token_offset,
#     minus it).
# Results land in <output_dir>/part_0 (one process: rank 0 of 1).
#
# Checks the JAX CLI lacks, each turning silent wrong output into an error:
#   - setup (check_special_tokens): <|im_kimia_text_blank|> and
#     <|im_kimia_text_eos|> must each be one id (the JAX CLI takes the
#     first id of whatever they tokenize to), and <|im_media_begin|> /
#     <|im_media_end|> exactly [kimia_media_begin] / [kimia_media_end] (the
#     model finds the speech span by those ids, and the JAX
#     _mask_between_markers switches the span off when one is missing);
#   - each utterance (prompt_streams): the two streams must be equally long
#     (the JAX CLI pads each to its own longest and adds them, misaligned),
#     the span between the markers must hold the n_tok audio ids, and an
#     utterance past 30 s raises naming its key and seconds (the speech
#     tokenizer's position table holds 1500 frames; the JAX forward fails
#     there with a shape error that takes its whole batch with it);
#   - the command line needs a card: main(argv, device=None) raises a
#     RuntimeError without one (pass device=torch.device("cpu") to run on
#     the CPU, as the tests do).
# The weights are read with the port's safetensors reader into host memory
# in their stored dtype and copied one tensor at a time onto a model built
# on the meta device in --model_dtype, each cast on the card
# (load_state_streamed): the host holds the file once, never an f32 copy.

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig
from touchnet_tpu_torch.models.kimi_audio.generate_kimi_audio import generate_dual
from touchnet_tpu_torch.models.kimi_audio.modeling_kimi_audio import (
    prepare_audio_input_embs,
)
from touchnet_tpu_torch.models.kimi_audio.processing_kimi_audio import (
    KIMI_AUDIO_TEMPLATE_FOR_S2T,
    KIMI_TEXT_TEMPLATE_FOR_S2T,
)
from touchnet_tpu_torch.models.llama.inference_llama import generate
from touchnet_tpu_torch.models.qwen2_audio.processing_qwen2_audio import whisper_features
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
from touchnet_tpu_torch.utils.cli import parse_args_into_dataclasses
from touchnet_tpu_torch.utils.inference import (
    AudioJsonlDataset,
    InferenceConfig,
    batched,
    load_state_streamed,
    pad_right,
    part_file,
    prefetch_map,
    resolve_model_files,
    torch_dtype,
    write_results,
)
from touchnet_tpu_torch.utils.logging import init_logger, logger

BLANK = "<|im_kimia_text_blank|>"
EOS = "<|im_kimia_text_eos|>"
MEDIA_BEGIN, MEDIA_END = "<|im_media_begin|>", "<|im_media_end|>"
# the decode settings of the text stream: the reference generate()'s text
# defaults, greedy WITH repetition penalty 1.1 over a 16-token window
# (touchnet/models/kimi_audio/modeling_kimi_audio.py:1084-1100, applied
# before the argmax)
TEXT_DECODE = dict(temperature=0.0, repetition_penalty=1.1, repetition_window=16)


def _ids(tokenizer, text: str) -> list:
    return list(tokenizer.tokenize(text, add_special_tokens=False))


def check_special_tokens(tokenizer, config: KimiAudioConfig) -> tuple:
    """(blank_id, eos_id); raises unless blank and eos are one id each and
    the media markers are exactly the config's ids."""
    found = {}
    for token in (BLANK, EOS):
        ids = _ids(tokenizer, token)
        if len(ids) != 1:
            raise ValueError(f"the tokenizer maps {token!r} to {ids[:8]}, not to one id")
        found[token] = ids[0]
    for token, want in ((MEDIA_BEGIN, config.kimia_media_begin),
                        (MEDIA_END, config.kimia_media_end)):
        ids = _ids(tokenizer, token)
        if ids != [want]:
            raise ValueError(f"the tokenizer maps {token!r} to {ids[:8]}, not to [{want}] (the "
                             "config's marker id): the speech span would not be found")
    return found[BLANK], found[EOS]


def prompt_streams(tokenizer, instruct: str, n_tok: int, config: KimiAudioConfig) -> tuple:
    """(text ids, audio ids), int64, of one utterance with n_tok audio
    tokens: the two S2T templates (the JAX CLI's prepare). Raises when the
    streams differ in length or the span between the markers does not hold
    the n_tok audio positions."""
    text = KIMI_TEXT_TEMPLATE_FOR_S2T.replace("<|INSTRUCT|>", instruct).replace(
        "<|AUDIO|>", BLANK * n_tok)
    audio = KIMI_AUDIO_TEMPLATE_FOR_S2T.replace(
        "<|INSTRUCT|>", BLANK * len(_ids(tokenizer, instruct))).replace("<|AUDIO|>", BLANK * n_tok)
    text_ids = np.asarray(_ids(tokenizer, text), np.int64)
    audio_ids = np.asarray(_ids(tokenizer, audio), np.int64)
    if len(text_ids) != len(audio_ids):
        raise ValueError(f"the text stream has {len(text_ids)} ids, the audio stream "
                         f"{len(audio_ids)}: the streams would be summed misaligned")
    begin = np.flatnonzero(audio_ids == config.kimia_media_begin)
    end = np.flatnonzero(audio_ids == config.kimia_media_end)
    span = int(end[0] - begin[0] - 1) if len(begin) == 1 and len(end) == 1 else None
    if span != n_tok:
        raise ValueError(f"the audio stream holds {len(begin)} begin and {len(end)} end "
                         f"markers around {span} positions for {n_tok} audio tokens")
    return text_ids, audio_ids


def load_params(config: InferenceConfig, model_config: KimiAudioConfig, dtype, device):
    """The KimiAudioForCausalLM of the HF directory --model_path, in
    ``dtype`` on ``device``, eval mode, no gradients: built on the meta
    device, each tensor of the file cast on ``device`` (load_state_streamed)."""
    from touchnet_tpu_torch.bin.convert_hf_to_ckpt import load_hf_state_dict
    from touchnet_tpu_torch.models.kimi_audio.convert import params_from_hf_state_dict
    from touchnet_tpu_torch.models.kimi_audio.modeling_kimi_audio import empty_model

    state = params_from_hf_state_dict(model_config, load_hf_state_dict(config.model_path))
    model = empty_model(model_config, dtype, device)
    load_state_streamed(model, state)
    return model


def main(argv=None, device: Optional[torch.device] = None) -> str:
    """Transcribe --data_list; returns the part file written."""
    (config, data_config, tok_config) = parse_args_into_dataclasses(
        [InferenceConfig, DataConfig, TokenizerConfig], argv)
    del data_config  # parsed for recipe-flag compatibility only, as in JAX
    init_logger()
    if config.output_type not in ("text", "both"):
        raise ValueError(f"output_type={config.output_type!r}: must be 'text' (ASR) or 'both' "
                         "(dual-stream with VQ audio codes)")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("inference_kimi_audio: no CUDA card "
                               "(torch.cuda.is_available() is False)")
        device = torch.device("cuda")
    model_config, tok_config = resolve_model_files(config, tok_config, KimiAudioConfig,
                                                   "kimi_audio")
    tokenizer = build_tokenizer(tok_config)
    blank_id, eos_id = check_special_tokens(tokenizer, model_config)
    dtype = torch_dtype(config.model_dtype)
    model = load_params(config, model_config, dtype, device)
    embed_w = model.model.embed_tokens.weight
    blank_emb = embed_w[blank_id]

    def embed_fn(toks):
        # decode feeds the text stream's token; the audio stream stays blank
        return F.embedding(toks, embed_w) + blank_emb[None]

    rank, world = 0, 1
    dataset = AudioJsonlDataset(config.data_list, rank, world)
    n_mels = model_config.speech_encoder_config.num_mel_bins
    max_frames = 2 * model_config.speech_tokenizer_config.max_source_positions

    def prepare(raw):
        s = dataset.load(raw)
        feats, fmask = whisper_features(s["waveform"], s["sample_rate"], n_mels)
        if feats.shape[0] > max_frames:
            seconds = np.asarray(s["waveform"]).size / s["sample_rate"]
            raise ValueError(f"utterance {s['key']!r}: {seconds:.2f} s of audio; the speech "
                             f"tokenizer's position table holds {max_frames // 2} frames "
                             f"({max_frames / 100:.0f} s)")
        n_tok = int(fmask[::2][::4].sum())
        text_ids, audio_ids = prompt_streams(tokenizer, config.instruct, n_tok, model_config)
        return s, text_ids, audio_ids, feats, fmask

    results = []
    stream = prefetch_map(prepare, dataset.samples, config.num_workers,
                          max(config.prefetch, 1) * config.batch_size)
    for rows in batched(stream, config.batch_size):
        batch = [r[0] for r in rows]
        lens = torch.tensor([len(r[1]) for r in rows], dtype=torch.long, device=device)
        text_ids = torch.from_numpy(pad_right([r[1] for r in rows], 0)).to(device)
        audio_ids = torch.from_numpy(pad_right([r[2] for r in rows], 0)).to(device)
        feats = torch.from_numpy(pad_right([r[3] for r in rows], 0.0)).to(device).transpose(1, 2)
        fmask = torch.from_numpy(pad_right([r[4] for r in rows], 0)).to(device)
        with torch.no_grad():
            audio_embs = F.embedding(audio_ids, embed_w).to(dtype)
            audio_embs = prepare_audio_input_embs(model, audio_ids, audio_embs, feats, fmask,
                                                  model_config, dtype)
            prompt = audio_embs + F.embedding(text_ids, embed_w)
        audio_codes = None
        if config.output_type == "both":
            out, audio_out = generate_dual(
                model, model_config, prompt, lens, config.max_length, blank_id=blank_id,
                eos_id=eos_id, output_type="both", compute_dtype=dtype,
                prefill_chunk=config.inference_prefill_chunk or None)
            audio_codes = audio_out.tolist()
        else:
            out = generate(model, model_config.text_config, prompt, lens, config.max_length,
                           eos_id=eos_id, embed_fn=embed_fn, compute_dtype=dtype,
                           prefill_chunk=config.inference_prefill_chunk or None, **TEXT_DECODE)
        for i, (s, toks) in enumerate(zip(batch, out.tolist())):
            row = {"key": s["key"], "txt": s.get("txt", ""),
                   "hyp": tokenizer.detokenize([t for t in toks if t not in (eos_id, blank_id)])}
            if audio_codes is not None:
                off = model_config.kimia_token_offset
                row["audio_codes"] = [t - off for t in audio_codes[i]
                                      if t != blank_id and t >= off]
            results.append(row)
        logger.info(f"decoded {len(results)}/{len(dataset)}")
    path = part_file(config.output_dir, rank)
    write_results(path, results)
    return path


if __name__ == "__main__":
    main()
