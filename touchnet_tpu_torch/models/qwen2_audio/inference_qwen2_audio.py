# Copyright (c) 2026 touchnet_tpu authors.
# Batch ASR inference for Qwen2AudioForConditionalGeneration, on the card.
#
#     python -m touchnet_tpu_torch.models.qwen2_audio.inference_qwen2_audio \
#         --model_path <HF dir> --model_dtype bfloat16 \
#         --instruct "Generate the transcription:" \
#         --data_list <jsonl of {key, wav, txt}> --output_dir <dir> \
#         --batch_size 16 --inference_enable_liger_kernel true \
#         --num_workers 16 --prefetch 8 \
#         [--training_model_config_path <cfg>] [--tokenizer_model <dir>]
#
# (stage 4 of examples/audio/sft/asr/wenetspeech/run.sh, :172-181: without
# the two bracketed flags the config and the tokenizer are the export's,
# utils/inference.resolve_model_files)
#
# Port of touchnet_tpu/models/qwen2_audio/inference_qwen2_audio.py (main,
# :41-124). On prefetch threads each wav becomes whisper features (padded to
# 30 s) and the prompt's ids: the template "<|audio_bos|><|AUDIO|>
# <|audio_eos|>{instruct}" with <|AUDIO|> repeated once per pooled audio
# frame. Each batch runs one encode_audio over its padded features (the
# causal whisper tower through K1, the pool, the projector), merges the
# audio into the prompt's embeddings, and generates greedily with the
# port's generate (K1 prefill, K4 decode), as JAX does. Results land in
# <output_dir>/part_<rank> as {"key", "txt", "hyp"} lines: under torchrun
# each process (RANK of WORLD_SIZE, on cuda:LOCAL_RANK) transcribes every
# WORLD_SIZE-th utterance of the jsonl, as JAX splits it by
# jax.process_index() (:65); stage 4's `cat part*` joins them.
#
# Checks the JAX CLI lacks:
#   - the tokenizer must map "<|AUDIO|>" to exactly [audio_token_index]
#     (check_audio_token, at setup), and each prompt must hold as many audio
#     ids as the utterance has pooled frames: a tokenizer that splits or
#     merges the token would otherwise leave audio frames out of the prompt
#     without a word (the reference's span guards switch off the same way);
#   - the command line needs a card: main(argv, device=None) raises a
#     RuntimeError without one (pass device=torch.device("cpu") to run on
#     the CPU, as the tests do).

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.models.llama.inference_llama import generate
from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import Qwen2AudioConfig
from touchnet_tpu_torch.models.qwen2_audio.modeling_qwen2_audio import (
    encode_audio,
    get_feat_extract_output_lengths,
    merge_audio_into_text,
)
from touchnet_tpu_torch.models.qwen2_audio.processing_qwen2_audio import (
    QWEN2_AUDIO_TEMPLATE_FOR_S2T,
    ManualQwen2AudioFrontend,
    check_audio_token,
    whisper_features,
)
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
from touchnet_tpu_torch.utils.cli import parse_args_into_dataclasses
from touchnet_tpu_torch.utils.distributed import local_cuda_device, rank_and_world
from touchnet_tpu_torch.utils.inference import (
    AudioJsonlDataset,
    InferenceConfig,
    batched,
    pad_right,
    part_file,
    prefetch_map,
    resolve_model_files,
    torch_dtype,
    write_results,
)
from touchnet_tpu_torch.utils.logging import init_logger, logger

AUDIO_TOKEN = "<|AUDIO|>"


def load_params(config: InferenceConfig, model_config: Qwen2AudioConfig, dtype, device):
    """The Qwen2AudioForConditionalGeneration of the HF directory
    --model_path, in ``dtype`` on ``device``, eval mode, no gradients."""
    from touchnet_tpu_torch.bin.convert_hf_to_ckpt import load_hf_state_dict
    from touchnet_tpu_torch.models.qwen2_audio.convert import params_from_hf_state_dict
    from touchnet_tpu_torch.models.qwen2_audio.modeling_qwen2_audio import empty_model

    state = params_from_hf_state_dict(model_config, load_hf_state_dict(config.model_path),
                                      dtype=dtype)
    model = empty_model(model_config, dtype, device)
    model.load_state_dict(state)
    return model


def prompt_ids(tokenizer, instruct: str, audio_len: int, audio_token_index: int) -> np.ndarray:
    """The prompt's ids for an utterance of ``audio_len`` mel frames: the
    template with one <|AUDIO|> per pooled frame (the JAX CLI's prepare).
    Raises when the ids hold another number of audio ids."""
    n_tok = int(get_feat_extract_output_lengths(audio_len)[1])
    text = QWEN2_AUDIO_TEMPLATE_FOR_S2T.replace("<|INSTRUCT|>", instruct).replace(
        AUDIO_TOKEN, AUDIO_TOKEN * n_tok, 1)
    ids = np.asarray(tokenizer.tokenize(text, add_special_tokens=False), np.int64)
    got = int((ids == audio_token_index).sum())
    if got != n_tok:
        raise ValueError(f"the prompt holds {got} audio ids for {n_tok} audio frames")
    return ids


def main(argv=None, device: Optional[torch.device] = None) -> str:
    """Transcribe --data_list; returns the part file written."""
    (config, data_config, tok_config) = parse_args_into_dataclasses(
        [InferenceConfig, DataConfig, TokenizerConfig], argv)
    del data_config  # parsed for recipe-flag compatibility only, as in JAX
    init_logger()
    if config.output_type != "text":
        raise ValueError("output_type='both' is a Kimi-Audio dual-stream feature; this "
                         "model has no audio head")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("inference_qwen2_audio: no CUDA card "
                               "(torch.cuda.is_available() is False)")
        device = local_cuda_device()  # cuda:LOCAL_RANK
    model_config, tok_config = resolve_model_files(config, tok_config, Qwen2AudioConfig,
                                                   "qwen2_audio")
    tokenizer = build_tokenizer(tok_config)
    check_audio_token(ManualQwen2AudioFrontend(tokenizer), model_config.audio_token_index)
    dtype = torch_dtype(config.model_dtype)
    model = load_params(config, model_config, dtype, device)
    embed_w = model.language_model.model.embed_tokens.weight

    rank, world = rank_and_world()
    dataset = AudioJsonlDataset(config.data_list, rank, world)
    n_mels = model_config.audio_config.num_mel_bins

    def prepare(raw):
        s = dataset.load(raw)
        feats, fmask = whisper_features(s["waveform"], s["sample_rate"], n_mels)
        ids = prompt_ids(tokenizer, config.instruct, int(fmask.sum()),
                         model_config.audio_token_index)
        return s, ids, feats

    results = []
    stream = prefetch_map(prepare, dataset.samples, config.num_workers,
                          max(config.prefetch, 1) * config.batch_size)
    for triples in batched(stream, config.batch_size):
        batch = [s for s, _, _ in triples]
        ids_list = [i for _, i, _ in triples]
        lens = torch.tensor([len(i) for i in ids_list], dtype=torch.long, device=device)
        ids = torch.from_numpy(pad_right(ids_list, 0)).to(device)
        feats = torch.from_numpy(pad_right([f for _, _, f in triples], 0.0)).to(device)
        with torch.no_grad():
            audio = encode_audio(model, feats.transpose(1, 2), model_config, dtype)
            prompt = merge_audio_into_text(F.embedding(ids, embed_w), audio, ids,
                                           model_config.audio_token_index)
        out = generate(model.language_model, model_config.text_config, prompt, lens,
                       config.max_length, eos_id=tokenizer.eos, compute_dtype=dtype,
                       prefill_chunk=config.inference_prefill_chunk or None)
        for s, toks in zip(batch, out.tolist()):
            toks = [t for t in toks if t != tokenizer.eos]
            results.append({"key": s["key"], "txt": s.get("txt", ""),
                            "hyp": tokenizer.detokenize(toks)})
        logger.info(f"decoded {len(results)}/{len(dataset)}")
    path = part_file(config.output_dir, rank)
    write_results(path, results)
    return path


if __name__ == "__main__":
    main()
