# Copyright (c) 2026 touchnet_tpu authors.
# Batch ASR inference for TouchAudioForCausalLM, on the card.
#
#     python -m touchnet_tpu_torch.models.touch_audio.inference_touch_audio \
#         --model_path <HF dir> --data_list <jsonl of {key, wav, txt}> \
#         --output_dir <dir> --batch_size 16 --max_length 64 \
#         [--training_model_config_path <cfg>] [<tokenizer and frontend flags>]
#
# (without --training_model_config_path, and for an HF tokenizer without
# --tokenizer_model, the config and the tokenizer are the export's, as
# stage 4 of examples/audio/sft/asr/wenetspeech/run.sh needs:
# utils/inference.resolve_model_files)
#
# Port of touchnet_tpu/models/touch_audio/inference_touch_audio.py:
# compute_features (:28-38), load_params (:41-46) and main (:49-135). A
# jsonl of wavs goes through the fbank chain (resample, the frontend, the
# low-frame-rate stack; no augmentation) on prefetch threads; each row's
# prompt is its projected features followed by the bos embedding, computed
# in f32 on the host from the weights in the model's dtype, as JAX does;
# right-padded batches go through the port's generate (K1 prefill, K4
# decode) with JAX's decode settings: greedy, no repeated bigrams,
# repetition penalty 1.5 over the whole generated history, the prompt's
# pad/bos ids primed into both. Results land in <output_dir>/part_<rank>:
# under torchrun each process (RANK of WORLD_SIZE, on cuda:LOCAL_RANK)
# transcribes every WORLD_SIZE-th utterance of the jsonl, as JAX splits it
# by jax.process_index() (:82); stage 4's `cat part*` joins them.
#
# Two checks the JAX CLI lacks: the stacked features must be as wide as
# the projector's input (touch_audio.check_feature_width), and the command
# line needs a card: main(argv, device=None) raises a RuntimeError without
# one (pass device=torch.device("cpu") to run on the CPU, as the tests do).

import copy
from typing import Optional

import numpy as np
import torch

from touchnet_tpu_torch.data import DataConfig, functions
from touchnet_tpu_torch.models.llama.inference_llama import generate
from touchnet_tpu_torch.models.touch_audio import check_feature_width
from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import TouchAudioConfig
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


def compute_features(sample, data_config: DataConfig) -> np.ndarray:
    """[frames, width] stacked features of one loaded sample."""
    chain = iter([sample])
    chain = functions.audio_resample(chain, data_config)
    chain = functions.feature_function(data_config)(chain, data_config)
    chain = functions.audiofeat_stack(chain, data_config)
    return next(chain)["audiofeat"]


def load_params(config: InferenceConfig, model_config: TouchAudioConfig, dtype, device):
    """The TouchAudioForCausalLM of the HF directory --model_path, in
    ``dtype`` on ``device``, eval mode, no gradients."""
    from touchnet_tpu_torch.bin.convert_hf_to_ckpt import load_hf_state_dict
    from touchnet_tpu_torch.models.touch_audio.convert import params_from_hf_state_dict
    from touchnet_tpu_torch.models.touch_audio.modeling_touch_audio import empty_model

    state = params_from_hf_state_dict(model_config, load_hf_state_dict(config.model_path),
                                      dtype=dtype)
    model = empty_model(model_config, dtype, device)
    model.load_state_dict(state)
    return model


def prompt_parts(model, tokenizer):
    """(projector weight, bos embedding [1, E]) as f32 numpy: the prompt is
    built from the weights in the model's dtype, upcast."""
    proj = model.projector.weight.detach().float().cpu().numpy()
    embed = model.language_model.model.embed_tokens.weight
    bos = embed[tokenizer.bos].detach().float().cpu().numpy()[None]
    return proj, bos


def make_prompt(features: np.ndarray, proj: np.ndarray, bos_emb: np.ndarray) -> np.ndarray:
    """Projected audio features followed by the bos embedding, [T + 1, E] f32."""
    return np.concatenate([features.astype(np.float32) @ proj.T, bos_emb], axis=0)


def decode_kwargs(tokenizer, max_length: int) -> dict:
    """The CLI's fixed decode settings (the JAX CLI's, :283-307): greedy, no
    repeated bigrams, repetition penalty 1.5 over the whole generated
    history, and the reference prompt's pad, pad, bos ids primed into both
    (bos alone when there is no pad)."""
    return dict(
        eos_id=tokenizer.eos,
        no_repeat_ngram_size=2,
        repetition_penalty=1.5,
        repetition_window=max_length,
        prime_tokens=((tokenizer.pad, tokenizer.pad, tokenizer.bos)
                      if tokenizer.pad is not None else (tokenizer.bos,)),
    )


def main(argv=None, device: Optional[torch.device] = None) -> str:
    """Transcribe --data_list; returns the part file written."""
    (config, data_config, tok_config) = parse_args_into_dataclasses(
        [InferenceConfig, DataConfig, TokenizerConfig], argv)
    init_logger()
    if config.output_type != "text":
        raise ValueError("output_type='both' is a Kimi-Audio dual-stream feature; this "
                         "model has no audio head")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("inference_touch_audio: no CUDA card "
                               "(torch.cuda.is_available() is False)")
        device = local_cuda_device()  # cuda:LOCAL_RANK
    model_config, tok_config = resolve_model_files(config, tok_config, TouchAudioConfig,
                                                   "touch_audio")
    check_feature_width(model_config, data_config)
    tokenizer = build_tokenizer(tok_config)
    dtype = torch_dtype(config.model_dtype)
    model = load_params(config, model_config, dtype, device)

    data_config = copy.deepcopy(data_config)
    data_config.audio_speed_perturb = False
    data_config.audiofeat_spec_aug = False
    data_config.audiofeat_spec_sub = False
    data_config.audiofeat_spec_trim = False

    rank, world = rank_and_world()
    dataset = AudioJsonlDataset(config.data_list, rank, world)
    proj, bos_emb = prompt_parts(model, tokenizer)

    def prepare(raw):
        s = dataset.load(raw)
        return s, make_prompt(compute_features(s, data_config), proj, bos_emb)

    kwargs = decode_kwargs(tokenizer, config.max_length)
    results = []
    stream = prefetch_map(prepare, dataset.samples, config.num_workers,
                          max(config.prefetch, 1) * config.batch_size)
    for pairs in batched(stream, config.batch_size):
        batch = [s for s, _ in pairs]
        prompts = [p for _, p in pairs]
        lens = torch.tensor([p.shape[0] for p in prompts], dtype=torch.long, device=device)
        prompt = torch.from_numpy(pad_right(prompts, 0.0)).to(device)
        out = generate(model.language_model, model_config.text_config, prompt, lens,
                       config.max_length, compute_dtype=dtype,
                       prefill_chunk=config.inference_prefill_chunk or None, **kwargs)
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
