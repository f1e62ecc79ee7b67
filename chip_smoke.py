#!/usr/bin/env python3
# Copyright (c) 2026 touchnet_tpu authors.
"""End-to-end smoke run of touchnet_tpu_torch on one CUDA card.

    python3 chip_smoke.py              # the phases below
    python3 chip_smoke.py --profile    # only the step profile, op_small beside full
                                       # (profile_training)
    python3 chip_smoke.py --faults     # faulty kernel copies must fail (check_faults)
    python3 chip_smoke.py --tune       # K3/K4 registers, and times their design variants
                                       # (K3 forward: splits, raster group, ring depth)
    python3 chip_smoke.py --two-ranks  # only phase 16 (two ranks on the card over gloo)

Phases, one or more lines each; any failure raises and exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA
     versions, the schemas of the yardstick calls; a CUDA card is
     required, there is no CPU fallback;
  2. build: nvcc builds the kernels of ops/csrc from this checkout, one
     process per source, in parallel;
  3. K1 (packed flash-attention forward) against its plain version, also at
     phase 8's own shape (B1 T16384, 10 packed documents; the plain version
     one kv head at a time), and in float16 at that shape, (d16), and at
     qwen2_audio's prefill shape, (g16) (B16 T401 H28/4 D128);
  4. K4 (ragged flash-decode) against its plain version, and two launches
     against each other bit for bit; in float16 too at (a)'s shape, (a16);
  5. the serving slice: Llama-3.2-1B at full width (random bf16 weights
     from a seed) generates for 8 prompts, with single-shot and chunked
     prefill, and single-shot on the same weights cast to float16 (an f16
     packed cache; K1 prefill, K4 decode); launch counts, logits against
     the plain-attention path,
     timings and peak memory. The plain-attention path is the same code
     with the kernels' wrappers swapped for their plain versions inside
     this script (plain_kernels); the package itself has no such switch;
  6. K2 (flash-attention backward) against autograd through the plain
     forward, at the training shape's heads, and at phase 8's own shape
     (B1 T16384, 10 packed documents; the plain version one kv head at a
     time so its f32 scores fit), in bf16 and in float16, (d16); at the
     timed shapes also each of its
     three kernels (delta, dkv, dq) per launch, by CUDA events the
     launcher records between them, each against its own bound; then (p),
     context parallelism's calls at cp 2 of Llama-3.2-1B's 1 x 8192 (B1
     T4096 a rank, H32/8 D64 bf16, packed): K1 on a rank's own chunk
     (q_offset = kv_offset = 4096), its past chunk (4096, 0), the future
     chunk (0, 4096: out 0 and lse -inf, no NaN) and the allgather call
     (4096 queries at 4096 over 8192 keys), the ring's combine of each
     rank's two steps against the allgather call, and K2 on each step and
     on the allgather call given the final out and lse, each against its
     plain version given the same, the future step's gradients 0 and the
     steps' sum equal to the allgather call's (check_cp_cases);
  7. K3 (fused lm-head + cross-entropy, forward and backward) against its
     plain versions at the training shape's vocab, and at phase 8's own
     N = 16384 rows, where the forward's blocks walk vocab splits of 14
     tiles and the backward accumulates dw over two dl row chunks (an f32
     case forces four), in bf16 and in float16, (d16), each with the share
     of its dw that is exactly zero under the mean CE's cotangents (f16
     flushes dl below 2^-24, as JAX's cast does); argmax ties in f32 and in
     bf16 (the TMA + wgmma
     forward: two lanes of a quad, two tiles of a split, two splits), and
     two backward runs against each other bit for bit; and at the audio
     path's vocab, V=1025 (1024 BEST-RQ codes + 1: four whole 256-column
     tiles and one live column in a fifth), at N8192 (the audio training
     shape), N256 in bf16 and in f32 with 64-row dl chunks, and a tie on
     column 1024; then (o), tensor parallelism's loss: the head split into
     2 and 4 vocab shards at N16384, K3 on each shard with offset labels,
     merged by parallel/loss_parallel.combine_vocab_shards over a stacked
     shard axis (standing in for the tp group): loss, dh and dw against
     whole-vocab K3 and the plain version, a tie across the shard boundary
     to the smaller id, and one shard's forward and backward timed; the
     same at tp 2 in float16, (o16); and (q), touch_audio's SFT head
     (phase 18): N16384 E4096 V128256 bf16, timed, and a tie at E4096;
 17. (run after 7) ops/frontend.py on the card against the host path (the
     loaders' map functions with the native frontend), 16 rows of seeded
     speech at each recipe's features: the SFT recipe's log-mel 128 over
     30 s rows, and BEST-RQ's fbank 80 with stack 5 stride 4 through
     device_frontend from a numpy batch; errors within the CPU tests'
     tolerances (FRONTEND_*_TOL), ms a batch on the card beside the host
     path's;
  8. the training slice: bin.train.main, the port's trainer, takes 10
     packed Llama-3.2-1B steps at 1x16384 (the recipe's batch geometry,
     examples/text/pretrain/fineweb-edu/run.sh:46) under the recipe's
     remat op_small on TouchDataset shards this script writes (seeded,
     learnable documents); then the remat sweep: 5 of the same steps
     (SWEEP_STEPS) under none, op_small and full, each with its step time,
     tokens/s, MFU, peak memory and K1 launches per step, and op_small once
     more under --training_deterministic true (no op may raise); then the trainer's
     single-device modes, the same 10 steps under op_small with one flag
     each, with the same figures and the launches of each kernel per step:
     --training_gradient_accumulation_steps 2 (2L, 2L, 2, 2; losses finite
     and falling), --training_mixed_precision_reduce bfloat16 (losses
     falling, step 1's loss equal to the main run's bit for bit, steps 5
     and 10 within bounds of it), --training_mixed_precision_param float16
     (f16 K1, K2, K3 a step; losses falling, step 1's within
     STEP_BF16_LOSS of the bf16 run's) and --training_enable_cpu_offload true (its
     pinned host bytes; a sync checkpoint at step 1 alone with the time the
     loop blocked in it; losses and final params, mu, nu and count equal
     the main run's bit for bit, and so are those of a fresh run resumed
     from its step 1);
     then one step's loss, grad norm and gradients of the kernel path
     against the plain path at B1 T4096, full width and depth, in f32,
     bf16 and float16, with the share of K3's dw that is exactly zero in
     the f16 step beside the bf16 one;
  9. the recipe's stages 0-3 on one card (run.sh:60-175, cut to dp 1):
     stage 0, python -m touchnet_tpu_torch.bin.make_data (a subprocess, 4
     workers, RawTokenizer at vocab 128256) over a jsonl of phase 8's
     seeded documents as pre-tokenized ids: the shards read back equal the
     ids, data.list has a line a shard; stage 1, an HF directory of seeded
     random bf16 weights (the port's safetensors writer and
     hf_config_dict) through convert_hf_to_ckpt to step_0; an in-process
     Trainer from step_0 (no process group: its params at init equal the
     HF tensors upcast, bit for bit) for the first 3 of the 10 steps;
     stage 2 as torchrun --standalone --nproc_per_node 1 -m
     touchnet_tpu_torch.bin.train with the recipe's layout flags
     (dp_shard -1, loss parallel; FSDP2 at world 1 over NCCL), 10 steps at
     1x16384 with its checkpoint flags (interval 5 here, keep 2, async),
     a dev list of seeded shards, profiling (freq 5, keep 1) and memory
     snapshots, from step_0; its first 3 losses against the in-process
     run's (bit-equal). Checks the saves at 1, 5 and 10 with a finite dev
     line after each, a trace naming K1, K2 and K3 kernels and the snapshot
     files (no resumed run, for the script's clock: phase 16 resumes a
     sharded checkpoint of two ranks, phases 8 and 10 one of one); the
     launches are the torchrun process's own (its
     train_summary_rank0.json). Prints the bytes of a checkpoint, how long
     the loop blocked in each save, the step times and the peak memory.
     Stage 3, convert_ckpt_to_hf --step -1 --config on step_10 (its
     params, mu, nu and count read back as integer checksums of their
     bits): its tensors, read back with the port's reader, equal the
     final params bit for bit, and greedy generate (K1, K4) from the
     export gives the checkpoint's model's tokens (2 prompts, 16 new
     tokens). Each stage prints its seconds and bytes. The model is
     Llama-3.2-1B at full width and RECIPE_MAX_LAYERS of its 16 layers
     (phase 8 trains all 16). The temp directory's free space is printed
     first; without room for three checkpoints (two kept, one being
     written), the seed, step_0 and the export, the phase runs fewer
     layers still, and says so;
 10. the BEST-RQ audio pretraining recipe's stages 0, 2 and 3 on one card
     (examples/audio/pretrain/wenetspeech/run.sh, dp 1; stage 1 is skipped
     without pretrained weights, as there): Touch-Audio-1B at full width
     and AUDIO_MAX_LAYERS (4) of its 16 layers (976,064,512 params at 16);
     ~3600 s of seeded synthetic speech
     (voiced tones of a drifting pitch plus noise, 1-15 s, 16 kHz int16
     wavs) through make_data (a subprocess, audio+metainfo, 16 shards) and
     a dev list; bin.train.main with the recipe's flags (1x8192 packed,
     fbank 80 bins, stack 5 stride 4, speed perturb 0.9/1.0/1.1, BEST-RQ
     1024 x 16 from 400, seed 2025, remat none, max_norm 5, AdamW fused lr
     8e-4, WSD linear, 12 loader threads; their prefetch 12 cut to 1,
     AUDIO_PREFETCH), 10 steps with checkpoints every 5 (keep 2, async)
     and a dev pass after each, then a fresh run resumed from step 5: step
     ms, tokens/s, MFU (phase 8's
     count), peak memory, the data-wait share per step, launches per step,
     losses finite and falling, the resumed run's losses and final state
     equal the first's bit for bit; what holds its step back: LOADER_STEPS
     steps without checkpoints or dev under 2 loader threads, and on
     batches made first and held in host memory; stage 3, convert_ckpt_to_hf
     --model_type touch_audio: the export equals the final params bit for
     bit; then one step at 1x4096, kernel path against plain path, under
     phase 8's limits;
 11. (run after 18, on its stage-3 export) the ASR CLI (python -m
     touchnet_tpu_torch.models.touch_audio.inference_touch_audio, run
     through its main; the SFT recipe's stage 4 with model_type
     touch_audio and stage4_argv's flags: bf16, batch 16, an empty
     instruct, the export's config and tokenizer; plus max_length 64 and
     fbank 80 x stack 5 stride 4, which the recipe's stage 4 does not pass):
     phase 18's Touch-Audio-7B export (full width, phase 18's 2 text
     layers, its trained f32 weights loaded in bf16), 32 synthetic wavs,
     then trans.txt, raw_rec.txt, textnorm_zh and error_rate_zh as phase
     12: a part file with a hyp for every key, K1 and K4 launched, a pair
     scored for every key; the first batch's prefill and first decode step
     on the kernel path against the plain path (bf16 both, rel L2 <= 5e-2,
     the serving limit); prefill ms, decode ms/step and peak memory;
 12. qwen2_audio's ASR stage (python -m touchnet_tpu_torch.models.
     qwen2_audio.inference_qwen2_audio, run through its main; the SFT
     recipe's stage 4 with model_type qwen2_audio, then its scoring), run
     after phase 14 on its stage-3 export (the recipe's chain: the whisper
     tower at phase 14's SFT_TOWER_LAYERS, the text model at phase 14's depth, f32 weights
     loaded in bf16, its char-level `tokenizers` tokenizer with
     Qwen2-Audio's special ids; without that export, on one of seeded
     random bf16 weights at full depth), 32 synthetic wavs (1-15 s and one of 35 s: the tiled position
     table, T 1750), batch 16, max_length 64, bf16, the recipe's instruct;
     then trans.txt and raw_rec.txt, textnorm_zh on both sides and
     error_rate_zh --tokenizer char (a pair scored for every key). Checks
     a hyp for every key, K1 launched (tower + L prefill) a batch and K4
     L a decode step, no plain version called; then the first batch's
     projected audio, last prefill and first decode step on the kernel path
     against the plain path (bf16 kernel <= 1.5x the bf16 plain path's
     error against the f32 plain path, and within 5e-2 of the bf16 plain
     path); export bytes and seconds, load seconds, host feature ms per
     utterance, encode_audio ms per batch, prefill ms, decode ms/step, the
     CLI's seconds, peak memory; and K1 and K4 at this path's shapes: (f)
     the tower's causal MHA (library: scaled_dot_product_attention), (g)
     the G 7 prefill, (h) the G 7 decode;
 13. (run after 15, on its stage-3 export) kimi_audio's ASR stage (python
     -m touchnet_tpu_torch.models.kimi_audio.inference_kimi_audio, run
     through its main with the recipe's stage-4 flags exactly, stage4_argv:
     f32, batch 1, no config and no tokenizer flag, plus max_length 64; then
     its scoring): phase 15's HF export (Kimi-Audio-7B at full width with
     phase 15's text and mimo depth, its SFT-trained weights, config.json
     and the char-level `tokenizers` tokenizer with Kimi's special ids),
     loaded in f32 (the host's peak resident memory during the load
     printed); output_type text over 8
     synthetic wavs of 1-30 s, then trans.txt, raw_rec.txt, textnorm_zh and
     error_rate_zh as phase 12; output_type both over 2 of them on the same
     loaded model. Checks a hyp for every key (audio codes under both), K1
     launched tower + L (text) or L + 6 (both stacks) an utterance and
     K4 L (or L + 6) a decode step, no plain version called; then the first
     utterance outside the CLI, f32 kernel path against the f32 plain path
     on the same weights: the adaptor's output, the last prefill's text
     logits and the first decode step's text and audio logits (both
     stacks), relative L2 <= KIMI_RTOL, the first two greedy text tokens
     equal, the VQ codes (plain PyTorch on both paths) counted where they
     differ; the encode split (tower, speech tokenizer, adaptor), prefill
     and decode ms for text and for both, host features, peak memory; and
     K1 and K4 at this path's f32 shapes, bounded at the FP32 peak: (i) the
     tower's non-causal MHA (library SDPA), (j) the G 7 prefill (SDPA with
     enable_gqa), (k) the G 7 decode on a main and a mimo row of the 34-row
     cache (SDPA on a gathered copy);
 14. (run after 10, before 12) qwen2_audio's SFT, stages 0-3 of the SFT
     recipe with model_type qwen2_audio (run_qwen2_sft): Qwen2-Audio-7B at
     full width (the whisper tower cut to SFT_TOWER_LAYERS (8) of its 32
     layers, vocab 156032) and the text depth of sft_depth (at most 2; the
     disk and the card), random bf16
     weights; stage 0, seeded synthetic speech (1-15 s, txt in the char
     tokenizer's alphabet) through make_data audio+metainfo (a subprocess)
     with a dev set and data.list.raw; stage 1, an HF directory through
     convert_hf_to_ckpt --model_type qwen2_audio to step_0 (the params at
     init equal the HF tensors upcast, bit for bit); stage 2,
     bin.train.main with the recipe's stage-2 flags (sft_argv: the
     qwen2_audio datapipe's dynamic batches of right-padded rows under 2 x
     8192 tokens, each row's whisper features padded to 30 s, the
     full-logits loss, AdamW fused) cut as sft_argv says, 4 steps with one
     sync save at the last, the model alone (no resumed run: phase 15 holds
     the SFT resume): per step its ms, label tokens/s, MFU as the reference
     counts it, the tower's and the text model's TFLOP, the data-wait share,
     rows, launches (K1 2 x (16 + L), K2 16 + L, K3 0: no head weight, as
     in JAX); stage 3, convert_ckpt_to_hf --model_type qwen2_audio
     --tokenizer_model: the export equals the final params bit for bit;
     step 1's loss, grad norm and gradients on the first rows of its batch
     (1200 positions, SFT_CHECK_SEQLEN) and its weights before the update,
     kernel path against the plain path in bf16 and in f32, under phase 8's
     limits (first_step_checked); K2 (l) at
     the tower's training shape and K1 and K2 (m) at the text layers'
     (right-padded rows);
 15. (run after 12, before 13) kimi_audio's SFT, stages 0-3 of the SFT
     recipe with model_type kimi_audio (run_kimi_sft): Kimi-Audio-7B at full
     width (the whisper tower cut to SFT_TOWER_LAYERS (8) of its 32
     layers, the 16-layer WhisperVQ speech
     tokenizer, frozen, the adaptor, hidden 3584, vocab 168448) cut as
     kimi_sft_depth reckons the disk and the card: text layers 28 -> 1
     (KIMI_SFT_MAX_LAYERS) and mimo layers 6 -> 1 forked after the last text
     layer, the recipe's 2 x 8192 budget unless the card forces 1 x 8192
     (it does: KIMI_SFT_LOGIT_BYTES); random bf16 weights; stage
     0 is phase 14's (its shards, dev list and data.list.raw); stage 1, an
     HF directory through convert_hf_to_ckpt --model_type kimi_audio to
     step_0 (the params at init equal the HF tensors upcast, bit for bit);
     stage 2, bin.train.main with the recipe's stage-2 flags (kimi_sft_argv:
     sft_argv's cuts, datapipe and model kimi_audio: right-padded rows of
     the text and audio streams, 30 s whisper features, the full-logits
     loss, AdamW fused, whose semantics are the optax chain's with a frozen
     tensor), 3 steps with one sync save, at the last, holding the model
     alone (no resumed run: the script's clock): per step its
     ms, label tokens/s, MFU as the reference counts it, the tower's, the
     tokenizer's and the text model's TFLOP, peak memory, the data-wait
     share, rows, launches (K1 2 x (32 + L), K2 32 + L, K3 0); after the
     last step the speech tokenizer bit-equal to the
     seed, the mimo stack (no gradient reaches it) equal to the seed times
     prod(1 - lr_t wd), every other tensor moved; stage 3,
     convert_ckpt_to_hf --model_type kimi_audio --tokenizer_model: the
     export equals the final params bit for bit; step 1's loss, grad norm
     and gradients on the first rows of its batch (1200 positions) before
     the update, kernel path against the plain path in bf16 and in f32,
     under phase 8's limits (first_step_checked); K1 and K2 (n) at the
     tower's training shape (non-causal, no segment ids).
 18. (run after 13, before 11) touch_audio's SFT, stages 1-3 of the SFT
     recipe with model_type touch_audio (run_touch_sft): Touch-Audio-7B at
     full width (E 4096, H 32/8, D 128, MLP 14336, V 128256, untied head,
     the projector from 400) and TOUCH_SFT_LAYERS (2) of its 32 text layers
     (a full-depth step's f32 state is 128 GB), random bf16 weights; stage
     0 is phase 14's (its shards and dev list); features fbank 80 x stack
     5 stride 4 (the recipe's log-mel 128 x stack 7 is 896 wide against the
     projector's 400); stage 1, an HF text backbone with its lm_head
     through convert_hf_to_ckpt --model_type touch_audio to step_0 (the
     params at init equal the HF tensors upcast and the converter's
     projector, bit for bit); stage 2, bin.train.main with the recipe's
     stage-2 flags (touch_sft_argv: sft_argv's cuts but the recipe's remat
     none and the moments on the card; the touch_audio datapipe's dynamic
     batches of right-padded rows under 2 x 8192 tokens; liger on: K3 at
     the head), TOUCH_SFT_STEPS (4) steps with one sync save at the last,
     the model alone, a dev pass after it: per step its loss, ms, tokens/s,
     MFU (the metrics line's), peak memory, the data-wait share, rows and
     launches (K1 L, K2 L, K3 1 + 1 every step); step 1's loss, grad norm
     and gradients on the first rows of its batch (TOUCH_CHECK_TOKENS
     positions) and its weights before the update, kernel path against the
     plain path in bf16 and in f32 (phase 8's bf16
     limits: the loss within STEP_BF16_LOSS of the f32 plain loss, the
     gradients' rel L2 to the f32 plain path at most STEP_BF16_RATIO times
     the bf16 plain path's, the grad norm within STEP_F16_GNORM of the bf16
     plain path's); stage 3, convert_ckpt_to_hf --model_type touch_audio
     --tokenizer_model: the export reloads equal to the final params bit
     for bit; seconds a stage;
 18b. (after 11) the ASR closed loop, JAX's test_asr_task_metric_closed_loop
     (tests/touchnet_tpu/bin/test_task_metric_loop.py) through the port's
     entry points (closed_loop): 96 training and 8 test utterances of a tone
     language (each character a pure tone) through bin.make_data, packed
     touch_audio SFT for 200 steps with JAX's flags (f32, 1 x 256, lr 5e-3),
     convert_ckpt_to_hf, then the CLI, textnorm_zh and error_rate_zh on the
     seed's weights and on the trained export; at world 1 (JAX's: dp_shard
     4 x tp 2) and on the tiny config's width in one head of 64
     (loop_config: K1 and K4 take D 64 and 128, not the tiny config's 16):
     CER at step 0 >= 60, trained <= 50 and below half of step 0's (JAX's
     margins); K1, K2 and K4 on their f32 bodies (JAX's flags leave liger
     off, so K3 does not run);
 16. (last) two ranks on the one card: Llama-3.2-1B at full width and
     TWO_RANK_LAYERS (2) layers, 2 steps of bin.train.main a layout, in one
     pair of processes over a gloo process group on cuda:0 (gloo takes CUDA
     tensors for FSDP2's all-gather and reduce-scatter, not for
     point-to-point, which the ring stages through the host; NCCL takes one
     rank a card): tp 2 at 1x4096 (the TP plan: each rank's K1/K2 on its
     heads, K3 on its vocab shard, merged by the vocab-parallel combine);
     dp_shard 2 at 1x4096 a rank (FSDP2 over both ranks, each its own dp
     loader stream) with a sync save and a dev pass after each step, then a
     run resumed from its step 1 (the sharded DCP checkpoint read back by
     both ranks): step 2's loss, grad norm and dev line and each rank's
     shards of the final params, mu, nu and count equal bit for bit; cp 2
     at 1x8192 (4096 a rank) with each rotate method, 1 step each,
     allgather (FSDP2 over the flattened dp_shard x cp mesh of both ranks)
     and alltoall (the ring): losses finite and equal on both ranks, K1, K2 and K3
     launched by each, the cp layouts' step-1 loss and grad norm against
     one process (world 1) on the same 1x8192 batch and against each
     other (CP_LOSS_RTOL, CP_GRAD_NORM_RTOL); pp 2 at 2x4096 (one layer a
     stage, 2 microbatches under 1F1B, the full-logits loss on the last
     stage, the tied embedding's gradients summed over pp in f32): K1 and
     K2 launched on both ranks and K3 on neither, step 1's loss and grad
     norm against one process on the same rows with the same loss
     (PP_LOSS_RTOL, PP_GRAD_NORM_RTOL); step ms and peak memory.
Each phase prints its wall seconds ("[phase N] wall"), and the script its
whole ("[all phases] wall").
Then one JSON line of per-kernel results, the card line, and the last
line {"ok": true, "device": {...}}. A kernel's "launches" is its count over
the main paths that run it (K1: serving, training, the single-device
modes, the recipe run with its generate from the export, the audio recipe
run, the ASR CLI and the qwen2_audio and kimi_audio ASR stages; K4:
serving, that generate, the ASR CLI, the two ASR stages and the closed
loop; K2, K3: training, the modes, the recipe run (its torchrun process),
the audio recipe run, phase 16's ranks (every layout) and touch_audio's
SFT run; K1 and K2 also qwen2_audio's and kimi_audio's SFT runs and the
closed loop), each path driven with the counts set to 0 just before it.
Its other numbers are those of its case at the training path's shape (K4:
the decode case), with every timed case under "cases":
  - bound_ms: the larger of its operations over 989 TFLOP/s (bf16 tensor
    cores; phase 13's f32 rows (i)-(k) over the FP32 peak, 66.9 TFLOP/s,
    the rate of the f32 FMA kernels; the earlier f32 cases keep the bf16
    peak) and its bytes (each input read once, each output written once)
    over 3.35 TB/s, and bound_by, which of the two. Attention counts the
    live (row, column) pairs of these inputs under the causal and segment
    mask (live_pairs, from the segment runs), and K1's bytes and (p)'s K2
    bytes those of the rows and columns that hold a live pair (live_bytes:
    a chunk that causality masks whole reads nothing and writes its
    outputs): K1 4·D·H·pairs, K2
    10·D·H·pairs (the work of one fused pass; K2's "parts" count what its
    split design does: dkv 8·D·H·pairs for S, dP, dV and dK, dq
    6·D·H·pairs for S, dP and dQ, delta the bytes of out, dout and delta);
    K3 2·N·E·V forward, 6·N·E·V backward; K4 is bound by the bytes of the
    live cache it reads;
  - library_ms: one PyTorch call computing the same function, timed here
    and used nowhere in the port: varlen flash attention over the
    document runs (aten._flash_attention_forward / _backward) for K1 and
    K2 (scaled_dot_product_attention, is_causal, for K1's case (f)), the
    same over a copy of each row's live cache columns for K4 (the copy made
    outside the timed window; in f32, which it does not take, one
    scaled_dot_product_attention call on that copy), none for K3; phase
    13's f32 K1 rows scaled_dot_product_attention (with enable_gqa at G 7). Before it is timed
    its output is held to the kernel's under the bf16 limits; a mismatch
    fails the run as the yardstick's fault. K3 adds gemm_ms, informational:
    cuBLAS bf16 h w^T over the same rows for the forward, the three
    products (gemm_yardstick) for the backward.

Tolerances on the card, each against the plain version on the same inputs:
  - bf16 and f16 kernels vs the plain version run in f32 on the same
    rounded inputs: max abs 2e-2 and mean abs 2e-3 on out at unit-scale inputs
    (the kernel rounds its f32 result to bf16 once: half an ulp is up to
    2^-9 relative, ~1.6e-2 at |out| near 4; f16 keeps 3 more bits, and is
    held to the same limits), lse 1e-3 (f32 throughout; only summation
    order differs);
  - f32 kernels: 1e-4, with TF32 off for the plain version's matmuls;
  - gradients (K2's dq, dk, dv; K3's dh, dw): the largest error relative to
    the largest reference value, f32 1e-4 (summation order only), bf16 and
    f16 1e-2 (one bf16 rounding of each output, 2e-3 of the value, plus
    K2's delta reading K1's bf16 out where the plain version recomputes
    it);
  - K3's row statistics (lse, label logit, base-2 row max): 1e-3 absolute
    (f32 sums of E products and of 128256 exponentials in another order;
    |lse| ~ 12); argmax agreement >= 0.999 on random rows, and exactly the
    smallest index on a constructed tie;
  - slice logits, per prefill and per teacher-forced decode step, by
    relative L2 error. With the weights in f32 and f32 compute, the kernel
    path against the plain-attention path: 1e-4 (only the kernels differ,
    and each is held to 1e-4 alone). In bf16 the two paths round
    differently inside attention, and the residual stream's bf16 roundings
    then decorrelate (about 3e-2 relative L2 after 16 layers between two
    equally valid bf16 runs, measured on this script's first H100 run). So
    bf16 is held to the f32 path as reference: the kernel path's error may
    be at most 1.5x the plain path's own error. And at an absolute limit:
    the last prefill's logits of the bf16 kernel path against the bf16
    plain path, 5e-2 (that rounding noise, ~3e-2, with room; a kernel
    fault beyond rounding moves them by far more, see PERF.md);
  - phase 13 (Kimi-Audio-7B in f32, the recipe's dtype), the kernel path
    against the plain path on the same f32 weights: the adaptor's output
    and the logits, relative L2 1e-3 (KIMI_RTOL: only K1 and K4 differ,
    each within 1e-4 of its plain version alone; 60 layers of f32 rounding
    in another summation order read ~1e-5, and a kernel fault beyond
    rounding moves them by 1e-2 or more), and the first greedy text tokens
    equal; TF32 off for both paths' matmuls and convolutions (set here);
  - the training step at B1 T4096 (set before the first run of phase 8),
    kernel path against the plain path on the same weights and batch:
    f32: loss relative 1e-5 and grad norm relative 1e-4 (only the kernels
    differ, each held to 1e-4 alone; the norm sums 1.24e9 squares), and the
    whole gradient (every parameter's, as one vector) relative L2 1e-4.
    bf16, held to the f32 plain path as reference as the serving check is:
    the bf16 kernel path's whole-gradient relative L2 error at most 1.5x
    the bf16 plain path's own, and its loss within 2e-2 of the f32 plain
    loss (~11.8 at init; bf16 rounding of the hidden state moves the mean
    over 4k tokens by ~1e-3);
  - the 10 training steps: every logged loss finite and the last below the
    first; launches per step K1 = L (op_small saves K1's out and lse, so
    the backward never re-runs it), K2 = L, K3 forward 1 and backward 1; no
    plain version called. The sweep: K1 = L per step under none and
    op_small, 2L under full, and the three modes' losses equal bit for bit
    (remat changes no value: the recompute runs the same kernels on the
    same inputs);
  - the recipe run: its launcher's first steps equal the in-process run's
    bit for bit; the audio recipe run (phase 10) and the offload mode
    (phase 8): their resumed steps' losses and final state equal the
    straight run's bit for bit (every kernel of the step gives the same
    bits twice).
Timings are the median of 7 runs after 2 warmup runs, with CUDA events;
the training step's is the median host time of steps 3-10 (each ends in
the logging sync).
"""

import contextlib
import copy
import gc
import json
import os
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
CONFIG = HERE / "examples/text/pretrain/fineweb-edu/config/Llama-3_2-1B.json"
SEED = 0
BF16_MAX, BF16_MEAN, LSE_TOL, F32_TOL = 2e-2, 2e-3, 1e-3, 1e-4
F32_LOGITS_RTOL, BF16_NOISE_RATIO, BF16_PREFILL_RTOL = 1e-4, 1.5, 5e-2


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def host_rss() -> int:
    """This process's resident memory in bytes (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def free_caches() -> None:
    """Frees what finished work left cached: the card allocator's blocks and
    the pinned host blocks PyTorch keeps for reuse (a trainer's offloaded
    moments and checkpoint staging leave tens of GB of them, which the page
    cache, and so the next checkpoint load or read-back, would contend
    with)."""
    gc.collect()
    torch.cuda.empty_cache()
    # the pinned host cache's release (a private binding in older releases,
    # torch.accelerator.empty_host_cache in newer ones)
    empty_host = getattr(torch._C, "_host_emptyCache", None) or \
        getattr(getattr(torch, "accelerator", None), "empty_host_cache", None)
    if empty_host is not None:
        empty_host()


@contextlib.contextmanager
def phase_clock(label: str):
    """Prints the wall seconds of the phases run inside, on a line of their
    own, when they end (also when one raises), after free_caches(); then
    the process's resident memory."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        free_caches()
        print(f"  [{label}] wall {time.perf_counter() - t0:.1f} s; host resident memory after "
              f"{host_rss() / 1e9:.2f} GB", flush=True)


def time_ms(fn, iters=7, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, want, dtype, failures, valid=None):
    """max / mean abs error of got vs want (on rows `valid`), checked
    against the dtype's tolerance; returns the max abs error."""
    got, want = got.float(), want.float()
    if valid is not None:
        got, want = got[valid], want[valid]
    err = (got - want).abs()
    mx, mean = err.max().item(), err.mean().item()
    finite = bool(torch.isfinite(got).all())
    ok = finite and (mx <= BF16_MAX and mean <= BF16_MEAN if dtype != torch.float32
                     else mx <= F32_TOL)
    print(f"  {name}: max_abs_err={mx:.3e} mean_abs_err={mean:.3e} finite={finite} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    return mx


# H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): bf16 tensor cores, FP32
# outside the tensor cores (the rate of the f32 FMA kernels), and HBM3
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_HBM_BYTES = 989e12, 66.9e12, 3.35e12


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations over
    `peak` (the bf16 peak unless the row gives the f32 one) and the bytes
    (each input read once, each output written once) over the memory rate,
    and which of the two it is."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "flops": flops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def seg_runs(row):
    """(value, start, end) of each run of equal ids in a 1-D segment row."""
    row = np.asarray(row)
    cuts = [0, *(np.flatnonzero(row[1:] != row[:-1]) + 1).tolist(), len(row)]
    return [(int(row[a]), a, b) for a, b in zip(cuts[:-1], cuts[1:])]


def _clamped_sum(x0, x1, n):
    """sum of min(max(x, 0), n) for x in [x0, x1]."""
    def upto(x):  # sum over x' in [1, x]
        if x <= 0:
            return 0
        if x <= n:
            return x * (x + 1) // 2
        return n * (n + 1) // 2 + (x - n) * n
    return upto(x1) - upto(x0 - 1) if x1 >= x0 else 0


def live_pairs(q_seg, kv_seg, causal, q_offset=0, kv_offset=0, T=None, S=None, B=1) -> int:
    """Live (row, column) pairs of one head summed over the batch: q_seg
    [B, T] and kv_seg [B, S] equal (segment 0 only matches itself) and, when
    causal, q_offset + t >= kv_offset + s. None is one segment (give T, S
    and B).
    O(T + S) per row from the segment runs, never a [T, S] mask."""
    if q_seg is None:
        q_seg = np.ones((B, T), np.int64)
        kv_seg = np.ones((B, S), np.int64)
    q_seg = np.asarray(q_seg.cpu() if hasattr(q_seg, "cpu") else q_seg)
    kv_seg = np.asarray(kv_seg.cpu() if hasattr(kv_seg, "cpu") else kv_seg)
    total = 0
    for qrow, krow in zip(q_seg, kv_seg):
        kv_runs = {}
        for val, c, d in seg_runs(krow):
            kv_runs.setdefault(val, []).append((c, d))
        for val, a, b in seg_runs(qrow):
            for c, d in kv_runs.get(val, ()):
                if not causal:
                    total += (b - a) * (d - c)
                else:  # row t sees q_offset + t - kv_offset - c + 1 columns of [c, d)
                    x0 = q_offset + a - kv_offset - c + 1
                    total += _clamped_sum(x0, x0 + (b - a) - 1, d - c)
    return total


def live_extent(q_seg, kv_seg, causal, q_offset=0, kv_offset=0, T=None, S=None, B=1) -> tuple:
    """(query rows, key columns) that hold at least one live pair, summed
    over the batch, under live_pairs' rule (None is one segment)."""
    if q_seg is None:
        q_seg = np.ones((B, T), np.int64)
        kv_seg = np.ones((B, S), np.int64)
    q_seg = np.asarray(q_seg.cpu() if hasattr(q_seg, "cpu") else q_seg)
    kv_seg = np.asarray(kv_seg.cpu() if hasattr(kv_seg, "cpu") else kv_seg)
    rows = cols = 0
    for qrow, krow in zip(q_seg, kv_seg):
        q_runs, kv_runs = {}, {}
        for val, a, b in seg_runs(qrow):
            q_runs.setdefault(val, []).append((a, b))
        for val, c, d in seg_runs(krow):
            kv_runs.setdefault(val, []).append((c, d))
        for val, runs in q_runs.items():
            if val in kv_runs:  # row t is live iff q_offset + t >= kv_offset + the first column
                lo = kv_offset + min(c for c, _ in kv_runs[val]) - q_offset if causal else 0
                rows += sum(max(0, b - max(a, lo)) for a, b in runs)
        for val, runs in kv_runs.items():
            if val in q_runs:  # column s is live iff the last row reaches it
                hi = q_offset + max(b for _, b in q_runs[val]) - kv_offset if causal else len(krow)
                cols += sum(max(0, min(d, hi) - c) for c, d in runs)
    return rows, cols


def live_bytes(q_side, kv_side, written, seg, kv_seg, causal, q_offset=0, kv_offset=0) -> float:
    """The bytes an attention function must move for this run's data: the
    query-side inputs ([B, T, ...]) of the rows that hold a live pair, the
    key-side inputs ([B, S, ...]) of the columns that do, each read once,
    every output written once, and the segment ids in full unless no pair
    is live (a chunk that causality alone masks needs no input: its out is
    0 and its lse -inf, its gradients 0)."""
    B, T = q_side[0].shape[:2]
    S = kv_side[0].shape[1]
    rows, cols = live_extent(seg, kv_seg, causal, q_offset, kv_offset, T, S, B)
    read = sum(nbytes(t) * rows / (B * T) for t in q_side) + \
        sum(nbytes(t) * cols / (B * S) for t in kv_side)
    return read + nbytes(*written) + (nbytes(seg, kv_seg) if rows else 0)


def attention_library(q, k, v, q_runs, k_runs, causal, scale=None):
    """The yardstick of K1/K2: PyTorch's varlen flash attention over the
    document runs (q/k/v flattened to [total, heads, D], native GQA). The
    copies into that layout are made here, outside any timed window.
    Returns (fwd, bwd): fwd() gives the aten outputs, bwd(outs, g) the
    gradients from them."""
    dev = q.device
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.reshape(-1, q.shape[2], D).contiguous()
    kf = k.reshape(-1, k.shape[2], D).contiguous()
    vf = v.reshape(-1, v.shape[2], D).contiguous()
    cq = torch.tensor([0, *np.cumsum(q_runs)], dtype=torch.int32, device=dev)
    ck = torch.tensor([0, *np.cumsum(k_runs)], dtype=torch.int32, device=dev)
    mq, mk = int(max(q_runs)), int(max(k_runs))
    assert int(cq[-1]) == qf.shape[0] and int(ck[-1]) == kf.shape[0]

    def fwd():
        return torch.ops.aten._flash_attention_forward(
            qf, kf, vf, cq, ck, mq, mk, 0.0, causal, False, scale=scale)

    def bwd(outs, g):
        out, lse, rng, unused = outs[:4]
        return torch.ops.aten._flash_attention_backward(
            g.reshape(out.shape).contiguous(), qf, kf, vf, out, lse, cq, ck, mq, mk, 0.0,
            causal, rng, unused, scale=scale)

    return fwd, bwd


def yardstick_checkable(name, failures, n_failed) -> bool:
    """A yardstick is held to the kernel only where the kernel passed its
    own check (failures has not grown since n_failed); else a mismatch
    would be the kernel's, and the yardstick is neither checked nor timed."""
    if len(failures) > n_failed:
        print(f"  {name} yardstick: not checked or timed, the kernel failed its own check")
        return False
    return True


def check_yardstick(name, got_out, got_lse, outs, B, T, H, failures):
    """The library call must compute the kernel's function before it is
    timed: its out (and lse, where its layout allows) against the kernel's
    under the bf16 limits. A mismatch is the yardstick's failure."""
    lib_out = outs[0].view(got_out.shape)
    yard = []
    compare(f"{name} yardstick out vs kernel", lib_out, got_out, torch.bfloat16, yard)
    lse = outs[1]
    if lse is None or tuple(lse.shape) != (H, B * T):  # none, or not the varlen [H, total]
        layout = "none" if lse is None else f"layout {tuple(lse.shape)}"
        print(f"  {name} yardstick lse {layout}: not compared")
    else:
        lse = lse.view(H, B, T).permute(1, 0, 2)
        fin = torch.isfinite(got_lse)
        err = (lse[fin] - got_lse[fin]).abs().max().item()
        print(f"  {name} yardstick lse vs kernel: max_abs_err={err:.3e} "
              f"{'ok' if err <= LSE_TOL else 'FAIL'}")
        if err > LSE_TOL:
            yard.append(f"{name} lse")
    failures.extend(f"yardstick (not the kernel): {n}" for n in yard)
    return not yard


def packed_segments(B, T, dev, docs=3):
    """`docs` documents then a padding tail (segment 0) in every row."""
    rng = np.random.default_rng(SEED + T)
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        ends = np.sort(rng.choice(np.arange(1, T - 64), docs, replace=False))
        for i, (start, end) in enumerate(zip([0, *ends[:-1]], ends)):
            seg[b, start:end] = i + 1
    return torch.from_numpy(seg).to(dev)


def grouped_forward_reference(attn, q, k, v, seg, kv_seg, causal, q_off, kv_off=0):
    """The plain forward one kv head at a time (its G query heads against
    it), in f32, so the scores of a long sequence fit."""
    G = q.shape[2] // k.shape[2]
    outs, lses = [], []
    for j in range(k.shape[2]):
        o, l = attn.packed_attention_reference(
            q[:, :, j * G:(j + 1) * G].float(), k[:, :, j:j + 1].float(),
            v[:, :, j:j + 1].float(), seg, causal, None, kv_seg, q_off, kv_off)
        outs.append(o)
        lses.append(l)
    return torch.cat(outs, 2), torch.cat(lses, 1)


def timed_row(name, err, ms, plain, lib, bnd, card):
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": lib,
           "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
           "tflops": bnd["flops"] / (ms * 1e-3) / 1e12}
    plain_s = "n/a" if plain is None else f"{plain:.3f} ms"
    lib_s = "none" if lib is None else f"{lib:.3f} ms"
    print(f"  {name} time: kernel {ms:.3f} ms, plain {plain_s}, library {lib_s}, "
          f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), {row['tflops']:.1f} TFLOP/s, "
          f"{100 * bnd['bound_ms'] / ms:.1f}% of bound  [{card}]")
    return row


def k1_case(attn, dev, failures, card, rows, name, q, k, v, seg, kv_seg, causal, q_off,
            timed=False, grouped=False, runs=None, library=None, peak=PEAK_BF16_FLOPS,
            kv_off=0, keep=False):
    """K1 on (q, k, v) against its plain version; when timed, its row in
    `rows`: kernel, plain and library times and the bound (operations at
    `peak`). The library is varlen flash attention over `runs(q, k, v)`, or
    `library`, a call that returns (out [B, T, H, D], None) for the same
    inputs; none when both are None. Returns the max abs error, and with
    `keep` the kernel's out and lse beside it."""
    n_failed = len(failures)
    out, lse = attn.flash_attention(q, k, v, seg, causal, None, kv_seg, q_off, kv_off)
    torch.cuda.synchronize()
    want, want_lse = grouped_forward_reference(attn, q, k, v, seg, kv_seg, causal, q_off,
                                               kv_off)
    B, T, H, D = q.shape
    S = k.shape[1]
    m = torch.ones((B, T, S), dtype=torch.bool, device=dev)
    if causal:
        m &= (q_off + torch.arange(T, device=dev))[:, None] >= \
            kv_off + torch.arange(S, device=dev)
    if seg is not None:
        m &= seg[:, :, None] == kv_seg[:, None, :]
    valid = m.any(-1)
    del m
    mx = compare(f"{name} out", out, want, q.dtype, failures, valid)
    lv = valid[:, None, :].expand(B, H, T)
    lse_err = (lse[lv] - want_lse[lv]).abs().max().item()
    print(f"  {name} lse: max_abs_err={lse_err:.3e} "
          f"{'ok' if lse_err <= LSE_TOL else 'FAIL'}")
    if lse_err > LSE_TOL:
        failures.append(f"{name} lse")
    del want, want_lse
    if timed:
        pairs = live_pairs(seg, kv_seg, causal, q_off, kv_off, T, S, B)
        bnd = bound(4 * D * H * pairs, live_bytes((q,), (k, v), (out, lse), seg, kv_seg, causal,
                                                  q_off, kv_off), peak)
        ms = time_ms(lambda: attn.flash_attention(q, k, v, seg, causal, None, kv_seg,
                                                  q_off, kv_off))
        if grouped:
            plain = time_ms(lambda: grouped_forward_reference(
                attn, q, k, v, seg, kv_seg, causal, q_off, kv_off), 3, 1)
        else:
            plain = time_ms(lambda: attn.packed_attention_reference(
                q, k, v, seg, causal, None, kv_seg, q_off, kv_off))
        if library is None and runs is not None:
            q_runs, k_runs, kk, vv = runs(q, k, v)
            library, _ = attention_library(q, kk, vv, q_runs, k_runs, causal)
        lib = None
        if library is not None and yardstick_checkable(name, failures, n_failed) and \
                check_yardstick(name, out, lse, library(), B, T, H, failures):
            lib = time_ms(library)
        rows[name] = timed_row(name, mx, ms, plain, lib, bnd, card)
        torch.cuda.empty_cache()
    return (mx, out, lse) if keep else mx


def check_k1(attn, dev, gen, failures, card):
    print("[3] K1 flash_attention vs packed_attention_reference")
    rows = {}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def case(*args, **kw):
        return k1_case(attn, dev, failures, card, rows, *args, **kw)

    def doc_runs(seg):
        def runs(q, k, v):
            r = [e - a for row in seg.cpu().numpy() for _, a, e in seg_runs(row)]
            return r, r, k, v
        return runs

    bf = torch.bfloat16
    B, T, H, Hkv, D = 8, 2048, 32, 8, 64
    seg = packed_segments(B, T, dev)
    case("(a) B8 T2048 H32/8 D64 bf16 causal packed",
         randn(B, T, H, D, dtype=bf), randn(B, T, Hkv, D, dtype=bf),
         randn(B, T, Hkv, D, dtype=bf), seg, seg, True, 0, timed=True, runs=doc_runs(seg))
    case("(b) B4 T=S=1500 H16/4 D128 bf16 non-causal",
         randn(4, 1500, 16, 128, dtype=bf), randn(4, 1500, 4, 128, dtype=bf),
         randn(4, 1500, 4, 128, dtype=bf), None, None, False, 0, timed=True,
         runs=lambda q, k, v: ([1500] * 4, [1500] * 4, k, v))
    # (c) a 1024-row chunk at offset 2048 over the strided K/V halves of a
    # packed cache layer: the chunked-prefill call of the slice. The library
    # reads a contiguous copy of the live 3072 columns (made untimed); its
    # causal mask is bottom-right aligned, which is the chunk's offset.
    Sc, C, off = 4096, 1024, 2048
    cache = randn(B, Hkv, Sc, 2 * D, dtype=bf)
    k_c, v_c = attn.cache_halves(cache, D)
    assert k_c.data_ptr() == cache.data_ptr() and not k_c.is_contiguous()
    q_seg = torch.ones((B, C), dtype=torch.int32, device=dev)
    kv_seg = (torch.arange(Sc, device=dev) < off + C).int().expand(B, Sc).contiguous()
    qc = randn(B, C, H, D, dtype=bf)
    case("(c) chunk 1024 @2048 over cache halves [8,8,4096,128] bf16",
         qc, k_c, v_c, q_seg, kv_seg, True, off, timed=True,
         runs=lambda q, k, v: ([C] * B, [off + C] * B, k[:, :off + C], v[:, :off + C]))
    out_p = attn.flash_prefill(qc, cache, q_seg, kv_seg, q_offset=off)
    out_d, _ = attn.flash_attention(qc, k_c, v_c, q_seg, True, None, kv_seg, off, 0)
    if not torch.equal(out_p, out_d):
        failures.append("(c) flash_prefill entry")
    del cache, k_c, v_c, qc, out_p, out_d
    T = TRAIN_T
    seg = packed_segments(1, T, dev, docs=10)
    case(f"(d) main path: B1 T{T} H32/8 D64 bf16 causal, 10 packed documents",
         randn(1, T, H, D, dtype=bf), randn(1, T, Hkv, D, dtype=bf),
         randn(1, T, Hkv, D, dtype=bf), seg, seg, True, 0, timed=True, grouped=True,
         runs=doc_runs(seg))
    # float16 (the trainer's and the CLIs' float16): the main path's shape
    # and qwen2_audio's prefill shape (G 7, D 128; 401 tokens as the kernel
    # tests' (g))
    f16 = torch.float16
    case(f"(d16) main path in f16: B1 T{T} H32/8 D64 f16 causal, 10 packed documents",
         randn(1, T, H, D, dtype=f16), randn(1, T, Hkv, D, dtype=f16),
         randn(1, T, Hkv, D, dtype=f16), seg, seg, True, 0, timed=True, grouped=True,
         runs=doc_runs(seg))
    q, k, v = randn(16, 401, 28, 128, dtype=f16), randn(16, 401, 4, 128, dtype=f16), \
        randn(16, 401, 4, 128, dtype=f16)
    case("(g16) qwen2_audio prefill shape in f16: B16 T401 H28/4 (G7) D128 f16 causal",
         q, k, v, None, None, True, 0, timed=True,
         runs=lambda q, k, v: ([401] * 16, [401] * 16, k, v))
    del q, k, v
    f32 = torch.float32
    seg = packed_segments(2, 300, dev)
    case("(e) B2 T300 H8/2 D64 f32 causal packed",
         randn(2, 300, 8, 64, dtype=f32), randn(2, 300, 2, 64, dtype=f32),
         randn(2, 300, 2, 64, dtype=f32), seg, seg, True, 0)
    case("(e) B2 T200 H6/3 D128 f32 non-causal",
         randn(2, 200, 6, 128, dtype=f32), randn(2, 200, 3, 128, dtype=f32),
         randn(2, 200, 3, 128, dtype=f32), None, None, False, 0)
    torch.cuda.empty_cache()
    return rows


def k4_case(dec, dev, gen, failures, card, rows, name, B, L, Hkv, G, D, S, plen, base, last,
            layer, dtype, timed=False, timing=True, peak=PEAK_BF16_FLOPS):
    """K4 on a random cache against its plain version, and two launches bit
    for bit; when timed, its row in `rows` (the library on a gathered copy of
    each row's live columns; the bound's operations at `peak`)."""
    n_failed = len(failures)
    q = torch.randn((B, Hkv * G, D), generator=gen, device=dev).to(dtype)
    kv = torch.randn((L, B, Hkv, S, 2 * D), generator=gen, device=dev, dtype=dtype)
    plen = torch.tensor(plen, dtype=torch.int32, device=dev)
    got = dec.decode_attention(q, kv, plen, base, last, layer_idx=layer)
    again = dec.decode_attention(q, kv, plen, base, last, layer_idx=layer)
    torch.cuda.synchronize()
    want = dec.decode_attention_reference(q.float(), kv[layer].float(), plen, base, last)
    mx = compare(name, got, want, dtype, failures)
    same = torch.equal(got, again)
    print(f"  {name}: two launches equal bit for bit: {same} {'ok' if same else 'FAIL'}")
    if not same:
        failures.append(f"{name} bit-stable")
    if timed and timing:
        ms = time_ms(lambda: dec.decode_attention(q, kv, plen, base, last, layer_idx=layer))
        plain = time_ms(lambda: dec.decode_attention_reference(
            q, kv, plen, base, last, layer_idx=layer))
        # the live columns of each row, gathered (untimed) into the
        # library's varlen layout [total, Hkv, D]: it cannot skip the
        # [prompt_len, base) gap of the cache in place
        cols = torch.arange(S, device=dev)
        live = (cols[None] < plen[:, None]) | ((cols >= base) & (cols <= last))[None]
        k_runs = live.sum(1).tolist()
        k_l = torch.cat([kv[layer, b][:, live[b], :D].transpose(0, 1) for b in range(B)])
        v_l = torch.cat([kv[layer, b][:, live[b], D:].transpose(0, 1) for b in range(B)])
        bnd = bound(4 * D * Hkv * G * sum(k_runs),
                    nbytes(k_l, v_l, q, got, plen), peak)  # the live cache, read once
        if dtype == torch.float32:
            # varlen flash attention takes no f32: one SDPA call (GQA) on the
            # gathered copy of the one row's live columns
            assert B == 1, "the f32 yardstick takes one row"
            k4d, v4d = k_l.transpose(0, 1)[None], v_l.transpose(0, 1)[None]

            def fwd():
                return (F.scaled_dot_product_attention(q[:, :, None], k4d, v4d,
                                                       enable_gqa=True),)
        else:
            fwd, _ = attention_library(q[:, None], k_l[None], v_l[None], [1] * B, k_runs,
                                       False)
        lib = None
        if yardstick_checkable(name, failures, n_failed):
            yard = []
            # under the bf16 limits, as check_yardstick holds K1's
            compare(f"{name} yardstick vs kernel", fwd()[0].view(got.shape), got,
                    torch.bfloat16, yard)
            failures.extend(f"yardstick (not the kernel): {n}" for n in yard)
            lib = None if yard else time_ms(fwd)
        name += " (library on a gathered copy of the live columns)"
        rows[name] = timed_row(name, mx, ms, plain, lib, bnd, card)
    return mx


def check_k4(dec, dev, gen, failures, card, timing=True):
    print("[4] K4 decode_attention vs decode_attention_reference")
    rows = {}

    def case(*args, timed=False):
        return k4_case(dec, dev, gen, failures, card, rows, *args, timed=timed, timing=timing)

    plen = torch.randint(2048, 8192, (32,), generator=torch.Generator().manual_seed(SEED))
    case("(a) B32 L16 H32/8 D64 S8192 bf16 layer 7",
         32, 16, 8, 4, 64, 8192, plen.tolist(), 7936, 8000, 7, torch.bfloat16, timed=True)
    case("(a16) B32 L16 H32/8 D64 S8192 f16 layer 7 (an f16 packed cache)",
         32, 16, 8, 4, 64, 8192, plen.tolist(), 7936, 8000, 7, torch.float16, timed=True)
    for Hkv in (5, 7):
        case(f"(b) B3 Hkv{Hkv} G2 D128 S2048 bf16",
             3, 2, Hkv, 2, 128, 2048, [1500, 700, 1], 1536, 1600, 1, torch.bfloat16)
    case("(c) prompt_len 1 row, B2 Hkv8 G4 D64 S1024 f32",
         2, 1, 8, 4, 64, 1024, [1, 600], 640, 700, 0, torch.float32)
    case("(d) G16 D128, 4x spread of prompt lengths, B4 Hkv2 S8192 bf16",
         4, 1, 2, 16, 128, 8192, [2048, 8191, 4000, 6000], 7936, 8000, 0, torch.bfloat16)
    return rows


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@contextlib.contextmanager
def plain_kernels():
    """The reference route of both slices: while it is open, the kernel
    wrappers the model code calls (flash_attention, which flash_prefill also
    goes through and whose backward is K2; decode_attention; fused_ce_rows)
    are their plain versions, which take the same arguments, run on the
    card and are differentiable."""
    from touchnet_tpu_torch.ops import attention as attn
    from touchnet_tpu_torch.ops import decode_attention as dec
    from touchnet_tpu_torch.ops import fused_ce

    saved = attn.flash_attention, dec.decode_attention, fused_ce.fused_ce_rows
    attn.flash_attention = attn.packed_attention_reference
    dec.decode_attention = dec.decode_attention_reference
    fused_ce.fused_ce_rows = fused_ce.fused_ce_rows_reference
    try:
        yield
    finally:
        attn.flash_attention, dec.decode_attention, fused_ce.fused_ce_rows = saved


def run_slice(dev, card, failures):
    from touchnet_tpu_torch.models.llama import inference_llama as inf
    from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
    from touchnet_tpu_torch.models.llama.modeling_llama import get_num_params, init_params
    from touchnet_tpu_torch.ops.attention import flash_attention
    from touchnet_tpu_torch.ops.decode_attention import decode_attention

    print("[5] slice: Llama-3.2-1B generate")
    cfg = LlamaConfig.from_json_file(str(CONFIG))
    L = cfg.num_hidden_layers
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        torch.bfloat16, dev)
    print(f"  config {CONFIG.relative_to(HERE)}: L={L} E={cfg.hidden_size} "
          f"H={cfg.num_attention_heads}/{cfg.num_key_value_heads} D={cfg.head_dim} "
          f"V={cfg.vocab_size}, {get_num_params(cfg) / 1e9:.3f} B params, bf16, seed {SEED}")
    B, NEW, EOS = 8, 64, 128001
    rng = np.random.default_rng(SEED)
    lens = rng.integers(512, 3073, B)
    Tp = int(lens.max())
    ids = torch.from_numpy(rng.integers(0, 128000, (B, Tp))).to(dev)
    ids[torch.arange(Tp, device=dev)[None, :] >= torch.from_numpy(lens).to(dev)[:, None]] = 0
    emb = F.embedding(ids, model.model.embed_tokens.weight)
    plen = torch.from_numpy(lens).to(dev)
    print(f"  prompts: B={B}, lengths {lens.tolist()}")
    gen_kw = dict(eos_id=EOS, repetition_penalty=1.5, no_repeat_ngram_size=2,
                  repetition_window=NEW, compute_dtype=torch.bfloat16)

    # float16 (the CLIs' --model_dtype float16): the same weights cast to
    # f16, an f16 packed cache, K1's prefill and K4's decode in f16
    model16 = copy.deepcopy(model).half()
    bf, f16 = torch.bfloat16, torch.float16
    # warm cuBLAS and the allocator on a short prompt (not measured)
    for m, dt in ((model, bf), (model16, f16)):
        inf.generate(m, cfg, emb[:2, :128].to(dt), torch.full((2,), 128, device=dev), 2,
                     **{**gen_kw, "compute_dtype": dt})
    torch.cuda.synchronize()
    modes = [("single-shot", None, bf), ("chunked 1024", 1024, bf),
             ("single-shot f16", None, f16)]
    models = {bf: model, f16: model16}
    outs, counts, gen_s, peaks = {}, {}, {}, {}
    # the main path: every launch count is zeroed here and read just after
    flash_attention.launches = 0
    decode_attention.launches = 0
    for mode, chunk, dt in modes:
        before = (flash_attention.launches, decode_attention.launches)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = inf.generate(models[dt], cfg, emb.to(dt), plen, NEW, prefill_chunk=chunk,
                           **{**gen_kw, "compute_dtype": dt})
        torch.cuda.synchronize()
        gen_s[mode] = time.perf_counter() - t0
        peaks[mode] = torch.cuda.max_memory_allocated()
        outs[mode] = out
        counts[mode] = (flash_attention.launches - before[0],
                        decode_attention.launches - before[1])
    main_counts = {"K1": flash_attention.launches, "K4": decode_attention.launches}
    model32 = copy.deepcopy(model).float()  # the same weights, for the f32 checks

    for mode, chunk, dt in modes:
        out = outs[mode]
        assert out.shape == (B, NEW) and ((out >= 0) & (out < cfg.vocab_size)).all()
        # generate stops at the first all-done check after every row's eos
        first_eos = [(row == EOS).nonzero() for row in out]
        every = inf.EOS_CHECK_EVERY
        steps = NEW if any(len(f) == 0 for f in first_eos) else \
            min(NEW, -(-(max(int(f[0]) for f in first_eos) + 1) // every) * every)
        nchunks = 1 if chunk is None else math.ceil(Tp / min(chunk, Tp))
        k1, k4 = counts[mode]
        ok = k1 == L * nchunks and k4 == L * steps
        print(f"  {mode}: launches K1={k1} (want {L}x{nchunks}) K4={k4} (want {L}x{steps}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{mode} launch counts")

        # teacher forcing: every path reads the same tokens (the ones this
        # run generated) step by step, from the same weights
        def forced(m, dtype):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, last, Tpp = inf.prefill(m, cfg, emb.to(dtype), plen, NEW,
                                           compute_dtype=dtype, prefill_chunk=chunk)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits = [last]
            for s in range(steps):
                tok_emb = F.embedding(out[:, s], m.model.embed_tokens.weight)[:, None]
                logits.append(inf.decode_step(m, cfg, cache, tok_emb, plen, Tpp, s, dtype))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            return torch.stack(logits), (t1 - t0) * 1e3, (t2 - t1) * 1e3 / steps

        def forced_plain(m, dtype):
            before = (flash_attention.launches, decode_attention.launches)
            with plain_kernels():
                res = forced(m, dtype)[0]
            if (flash_attention.launches, decode_attention.launches) != before:
                failures.append(f"{mode} plain path launched a kernel")
            return res

        def worst(a, b):
            return max(rel_l2(a[i], b[i]) for i in range(a.shape[0]))

        # the 16-bit path (bf16, or f16 on the same weights cast) against the
        # f32 plain path, under the bf16 limits; f32 kernel vs f32 plain on
        # the bf16 modes
        ty = "bf16" if dt == bf else "f16"
        got, prefill_ms, step_ms = forced(models[dt], dt)
        plain = forced_plain(models[dt], dt)
        ref = forced_plain(model32, torch.float32)
        got32 = forced(model32, torch.float32)[0] if dt == bf else None
        finite = bool(torch.isfinite(got).all() and (got32 is None or
                                                      torch.isfinite(got32).all()))
        e32 = worst(got32, ref) if got32 is not None else 0.0
        e_kp = worst(got, plain)
        e_k, e_p = worst(got, ref), worst(plain, ref)
        e_pre = rel_l2(got[0], plain[0])
        agree = (got.argmax(-1) == plain.argmax(-1)).float().mean().item()
        ok = (finite and e32 <= F32_LOGITS_RTOL and e_k <= BF16_NOISE_RATIO * e_p
              and e_pre <= BF16_PREFILL_RTOL)
        f32_note = (f"f32 kernel vs f32 plain {e32:.3e} (<= {F32_LOGITS_RTOL:.0e}); "
                    if got32 is not None else "")
        print(f"  {mode}: logits rel_l2 (worst of prefill + {steps} steps): {f32_note}"
              f"vs f32 plain: {ty} kernel {e_k:.3e}, {ty} plain {e_p:.3e} "
              f"(kernel <= {BF16_NOISE_RATIO}x plain); {ty} kernel vs {ty} plain {e_kp:.3e}, "
              f"last prefill only {e_pre:.3e} (<= {BF16_PREFILL_RTOL:.0e}); "
              f"finite={finite} {'ok' if ok else 'FAIL'}")
        print(f"  {mode}: greedy argmax agreement, {ty} kernel vs {ty} plain "
              f"(teacher-forced on the generated tokens) {agree:.4f}")
        if not ok:
            failures.append(f"{mode} logits")
        print(f"  {mode}: prefill {prefill_ms:.1f} ms, decode {step_ms:.3f} ms/step, "
              f"generate {gen_s[mode]:.3f} s for {B}x{steps} tokens = "
              f"{B * steps / gen_s[mode]:.1f} generated tok/s, "
              f"peak {peaks[mode] / 2**30:.2f} GiB allocated  [{card}]")
    return main_counts


GRAD_TOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 1e-4}
CE_STAT_TOL, ARGMAX_AGREE = 1e-3, 0.999
STEP_F32_LOSS, STEP_F32_GNORM, STEP_F32_GRADS = 1e-5, 1e-4, 1e-4
STEP_BF16_RATIO, STEP_BF16_LOSS = 1.5, 2e-2
# the f16 step's grad norm, kernel path against the f16 plain path: the two
# round P and dS (K2) in different places, ~1e-3 of the norm predicted
# before the first card run; the limit is ten times that
STEP_F16_GNORM = 1e-2
TRAIN_STEPS, TRAIN_T, CHECK_T, DOC_RANGE = 10, 16384, 4096, 1000
# the remat sweep's and the deterministic run's steps (cut from 10 for the
# script's time: their checks read every step's loss and the launches a step)
SWEEP_STEPS = 5


def compare_grad(name, got, want, dtype, failures):
    """Largest error relative to the largest reference value; returns the
    max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    finite = bool(torch.isfinite(got).all())
    ok = finite and rel <= GRAD_TOL[dtype]
    print(f"  {name}: max_abs_err={err:.3e} rel_to_max={rel:.3e} finite={finite} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    return err


K2_PARTS = ("delta", "dkv", "dq")


def k2_part_bounds(D, H, pairs, q, k, v, out, g, lse, seg, dq, dk, dv) -> dict:
    """The bound of each of K2's three kernels: delta reads out and dout
    and writes delta (lse's size); dkv does S, dP, dV and dK on each live
    pair (8·D·H·pairs) and writes dk, dv; dq does S, dP and dQ
    (6·D·H·pairs) and writes dq. Both read q, k, v, dout, lse, delta and
    the segment ids once."""
    reads = nbytes(q, k, v, g, lse, lse, seg)
    return {"delta": bound(2 * out.numel(), nbytes(out, g, lse)),
            "dkv": bound(8 * D * H * pairs, reads + nbytes(dk, dv)),
            "dq": bound(6 * D * H * pairs, reads + nbytes(dq))}


def k2_parts(attn, q, k, v, seg, out, lse, g, causal, got, pairs, name, card,
             iters=7, warmup=2) -> dict:
    """Each of K2's kernels per launch: the launcher records four CUDA
    events (before delta, after it, after dkv, after dq); the median of
    `iters` launches after `warmup`, each part against its bound."""
    def once():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        attn.flash_attention_bwd(q, k, v, seg, seg, out, lse, g, causal, events=ev)
        ev[3].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    for _ in range(warmup):
        once()
    runs = [once() for _ in range(iters)]
    bounds = k2_part_bounds(q.shape[3], q.shape[2], pairs, q, k, v, out, g, lse, seg, *got)
    parts = {}
    for i, part in enumerate(K2_PARTS):
        ms = statistics.median(r[i] for r in runs)
        b = bounds[part]
        parts[part] = {"ms": ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
        print(f"  {name} {part}: {ms:.3f} ms per launch, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}), {100 * b['bound_ms'] / ms:.1f}% of bound  [{card}]")
    return parts


def k2_grouped_reference(attn, q, k, v, seg, g, causal):
    """K2's plain backward one kv head at a time (its G query heads against
    it), so the f32 scores of a long sequence fit."""
    G = q.shape[2] // k.shape[2]
    dq, dk, dv = (torch.empty(x.shape, device=q.device) for x in (q, k, v))
    for j in range(k.shape[2]):
        hs, ks = slice(j * G, (j + 1) * G), slice(j, j + 1)
        dq[:, :, hs], dk[:, :, ks], dv[:, :, ks] = attn.flash_attention_bwd_reference(
            q[:, :, hs].float(), k[:, :, ks].float(), v[:, :, ks].float(), seg, seg,
            None, None, g[:, :, hs].float(), causal)
    return dq, dk, dv


def k2_case(attn, dev, gen, failures, card, rows, name, B, T, H, Hkv, D, dtype, causal, seg,
            timed=False, grouped=False):
    """K2 on random q, k, v, dout (segment ids `seg` or None) against
    autograd through the plain forward; when timed, its row in `rows`:
    kernel, plain and library times, each of its three kernels, the bound
    (10·D·H a live pair)."""
    n_failed = len(failures)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    q, k, v = randn(B, T, H, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D)
    g = randn(B, T, H, D)
    out, lse = attn.flash_attention(q, k, v, seg, causal)
    got = attn.flash_attention_bwd(q, k, v, seg, seg, out, lse, g, causal)
    torch.cuda.synchronize()
    if grouped:
        want = k2_grouped_reference(attn, q, k, v, seg, g, causal)
    else:
        want = attn.flash_attention_bwd_reference(q.float(), k.float(), v.float(), seg,
                                                  seg, None, None, g.float(), causal)
    errs = [compare_grad(f"{name} {n}", a, b, dtype, failures)
            for n, a, b in zip(("dq", "dk", "dv"), got, want)]
    del want
    if timed:
        pairs = live_pairs(seg, seg, causal, 0, 0, T, T, B)
        bnd = bound(10 * D * H * pairs, nbytes(q, k, v, out, g, lse, seg, *got))
        ms = time_ms(lambda: attn.flash_attention_bwd(q, k, v, seg, seg, out, lse, g,
                                                      causal))
        parts = k2_parts(attn, q, k, v, seg, out, lse, g, causal, got, pairs, name, card)
        if grouped:
            plain = time_ms(lambda: k2_grouped_reference(attn, q, k, v, seg, g, causal), 3, 1)
        else:
            plain = time_ms(lambda: attn.flash_attention_bwd_reference(
                q, k, v, seg, seg, None, None, g, causal))
        runs = [e - a for row in seg.cpu().numpy() for _, a, e in seg_runs(row)] \
            if seg is not None else [T] * B
        fwd, bwd = attention_library(q, k, v, runs, runs, causal)
        outs = fwd()
        lib = None
        if yardstick_checkable(name, failures, n_failed):
            yard = []
            for n, a, b in zip(("dq", "dk", "dv"), bwd(outs, g), got):
                compare_grad(f"{name} yardstick {n} vs kernel", a.view(b.shape), b, dtype,
                             yard)
            failures.extend(f"yardstick (not the kernel): {n}" for n in yard)
            if not yard:
                lib = time_ms(lambda: bwd(outs, g))
        rows[name] = timed_row(name, max(errs), ms, plain, lib, bnd, card)
        rows[name]["parts"] = parts
    del got
    torch.cuda.empty_cache()


def check_k2(attn, dev, gen, failures, card):
    print("[6] K2 flash_attention_bwd vs autograd through packed_attention_reference")
    rows = {}

    def case(name, B, T, H, Hkv, D, dtype, causal, packed, timed=False, docs=3,
             grouped=False):
        seg = packed_segments(B, T, dev, docs) if packed else None
        k2_case(attn, dev, gen, failures, card, rows, name, B, T, H, Hkv, D, dtype, causal,
                seg, timed, grouped)

    case("(a) B1 T4096 H32/8 D64 bf16 causal packed", 1, 4096, 32, 8, 64, torch.bfloat16,
         True, True, timed=True)
    case("(b) B1 T4096 H32/8 D64 f32 causal packed", 1, 4096, 32, 8, 64, torch.float32,
         True, True)
    case("(c) B2 T1500 H16/4 D128 bf16 non-causal", 2, 1500, 16, 4, 128, torch.bfloat16,
         False, False)
    case(f"(d) main path: B1 T{TRAIN_T} H32/8 D64 bf16 causal, 10 packed documents",
         1, TRAIN_T, 32, 8, 64, torch.bfloat16, True, True, timed=True, docs=10, grouped=True)
    case(f"(d16) main path in f16: B1 T{TRAIN_T} H32/8 D64 f16 causal, 10 packed documents",
         1, TRAIN_T, 32, 8, 64, torch.float16, True, True, timed=True, docs=10, grouped=True)
    torch.cuda.empty_cache()
    return rows


# (p) context parallelism at cp 2: a rank's slice of Llama-3.2-1B's attention
# (phase 16's cp layouts: 1 x 8192 global, 4096 a rank)
CP_T, CP_DOCS = 4096, 4


def k2_final_reference(attn, q, k, v, q_seg, kv_seg, out, lse, g, q_off, kv_off):
    """K2's plain version one kv head at a time, in f32, given the ring's
    final out and lse (so the f32 scores of 4096 x 8192 fit)."""
    G = q.shape[2] // k.shape[2]
    dq, dk, dv = (torch.empty(x.shape, device=q.device) for x in (q, k, v))
    for j in range(k.shape[2]):
        hs, ks = slice(j * G, (j + 1) * G), slice(j, j + 1)
        dq[:, :, hs], dk[:, :, ks], dv[:, :, ks] = attn.flash_attention_bwd_reference(
            q[:, :, hs].float(), k[:, :, ks].float(), v[:, :, ks].float(), q_seg, kv_seg,
            out[:, :, hs].float(), lse[:, hs], g[:, :, hs].float(), True, None, q_off, kv_off)
    return dq, dk, dv


def cp_runs(seg, T):
    """The varlen runs of the allgather case: rank 1's queries (global
    positions T..2T) per document, and each document's keys from its global
    start (bottom-right causal alignment is the queries' offset); the keys'
    first row."""
    row = seg[0].cpu().numpy()
    starts = {}
    for val, a, e in seg_runs(row):
        starts.setdefault((val, e), a)
    q_runs, k_runs = [], []
    for val, a, e in seg_runs(row[T:]):
        (gs,) = [st for (vv, ee), st in starts.items() if vv == val and ee == T + e]
        q_runs.append(e - a)
        k_runs.append(T + e - gs)
    first = 2 * T - sum(k_runs)
    return q_runs, k_runs, first


def check_cp_cases(attn, dev, gen, failures, card) -> tuple:
    """(p): K1 and K2 on the offsets context parallelism gives them at cp 2,
    B1 T4096 a rank (8192 global) H32/8 D64 bf16, CP_DOCS packed documents
    and a padding tail over the global row. K1 on rank 1's own chunk
    (q_offset = kv_offset = 4096), its past chunk (4096, 0), rank 0's future
    chunk (0, 4096: every pair masked, out 0 and lse -inf, no NaN) and the
    allgather call (4096 queries at 4096 against 8192 keys), each against
    its plain version; the ring's combine of each rank's two steps against
    the allgather call (rank 1) and the own chunk alone (rank 0); then K2 on
    each ring step and on the allgather call, given the final out and lse
    (-inf clamped to 0), against the plain version given the same; the
    future step's gradients exactly 0. Library: varlen flash attention where
    its runs and causal alignment express the case (own chunk; allgather),
    its backward given the same final out and lse; none for the past and
    future chunks (their documents pair across chunks). Returns the K1 and
    K2 rows."""
    from touchnet_tpu_torch.ops.ring_attention import combine

    print("[6] (p) context parallelism at cp 2: K1 and K2 at the ring's and the allgather's "
          "offsets")
    k1_rows, k2_rows = {}, {}
    T, H, Hkv, D, bf = CP_T, 32, 8, 64, torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf)

    seg = packed_segments(1, 2 * T, dev, docs=CP_DOCS)
    q, k, v, g = randn(1, 2 * T, H, D), randn(1, 2 * T, Hkv, D), randn(1, 2 * T, Hkv, D), \
        randn(1, 2 * T, H, D)
    half = [slice(0, T), slice(T, 2 * T)]
    qs, ks, vs, gs, segs = ([x[:, h].contiguous() for h in half] for x in (q, k, v, g, seg))
    tag = f"B1 T{T} H32/8 D64 bf16 packed, cp 2 of 1x{2 * T}"

    def chunk_runs(sg):
        def runs(q_, k_, v_):
            r = [e - a for _, a, e in seg_runs(sg[0].cpu().numpy())]
            return r, r, k_, v_
        return runs

    def k1(name, qq, kk, vv, q_seg, kv_seg, q_off, kv_off, runs=None):
        return k1_case(attn, dev, failures, card, k1_rows, f"(p) {name}: {tag}", qq, kk, vv,
                       q_seg, kv_seg, True, q_off, timed=True, grouped=True, runs=runs,
                       kv_off=kv_off, keep=True)

    _, out_own1, lse_own1 = k1("own chunk @4096/@4096", qs[1], ks[1], vs[1], segs[1], segs[1],
                               T, T, runs=chunk_runs(segs[1]))
    _, out_past1, lse_past1 = k1("past chunk @4096/@0", qs[1], ks[0], vs[0], segs[1], segs[0],
                                 T, 0)
    q_runs, k_runs, first = cp_runs(seg, T)
    _, out_ag, lse_ag = k1("allgather @4096 over 8192 keys", qs[1], k, v, segs[1], seg, T, 0,
                           runs=lambda q_, k_, v_: (q_runs, k_runs, k_[:, first:],
                                                    v_[:, first:]))
    # the future chunk: every pair masked
    name = f"(p) future chunk @0/@4096: {tag}"
    out_fut, lse_fut = attn.flash_attention(qs[0], ks[1], vs[1], segs[0], True, None, segs[1],
                                            0, T)
    torch.cuda.synchronize()
    ok = bool((out_fut == 0).all()) and bool(torch.isneginf(lse_fut).all()) and \
        not bool(torch.isnan(out_fut.float()).any())
    print(f"  {name}: out all 0, lse all -inf, no NaN: {ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    ms = time_ms(lambda: attn.flash_attention(qs[0], ks[1], vs[1], segs[0], True, None,
                                              segs[1], 0, T))
    plain = time_ms(lambda: grouped_forward_reference(attn, qs[0], ks[1], vs[1], segs[0],
                                                      segs[1], True, 0, T), 3, 1)
    k1_rows[name] = timed_row(name, 0.0, ms, plain, None, bound(
        0, live_bytes((qs[0],), (ks[1], vs[1]), (out_fut, lse_fut), segs[0], segs[1], True, 0,
                      T)), card)
    out_own0, lse_own0 = attn.flash_attention(qs[0], ks[0], vs[0], segs[0])

    # the ring's combine: rank 1 (own, then past) is the allgather call; rank
    # 0 (own, then future) is its own chunk, bit for bit
    def ring(steps):
        num = torch.zeros((1, T, H, D), dtype=torch.float32, device=dev)
        den = torch.zeros((1, H, T), dtype=torch.float32, device=dev)
        m = torch.full((1, H, T), float("-inf"), device=dev)
        for o, l in steps:
            num, den, m = combine(num, den, m, o, l)
        live = den > 0
        den1 = torch.where(live, den, torch.ones_like(den))
        return (num / den1.transpose(1, 2)[..., None]).to(bf), \
            torch.where(live, m + torch.log(den1), torch.full_like(m, float("-inf")))

    out_f1, lse_f1 = ring([(out_own1, lse_own1), (out_past1, lse_past1)])
    out_f0, lse_f0 = ring([(out_own0, lse_own0), (out_fut, lse_fut)])
    compare("(p) ring combine, rank 1, vs the allgather call: out", out_f1, out_ag, bf, failures)
    lerr = (lse_f1 - lse_ag).abs().max().item()
    print(f"  (p) ring combine, rank 1, vs the allgather call: lse max_abs_err={lerr:.3e} "
          f"{'ok' if lerr <= LSE_TOL else 'FAIL'}")
    same0 = torch.equal(out_f0, out_own0) and torch.equal(lse_f0, lse_own0)
    print(f"  (p) ring combine, rank 0: own chunk and the future chunk give the own chunk's "
          f"out and lse bit for bit: {same0} {'ok' if same0 else 'FAIL'}")
    if lerr > LSE_TOL:
        failures.append("(p) ring combine lse")
    if not same0:
        failures.append("(p) ring combine rank 0")
    del out_own1, out_past1, out_fut

    # K2 on each step, given the final out and lse
    def k2(name, qq, kk, vv, q_seg, kv_seg, out, lse, gg, q_off, kv_off, runs=None,
           zero=False):
        name = f"(p) K2 {name}: {tag}, the final lse"
        n_failed = len(failures)
        lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse)).contiguous()
        got = attn.flash_attention_bwd(qq, kk, vv, q_seg, kv_seg, out, lse, gg, True, None,
                                       q_off, kv_off)
        torch.cuda.synchronize()
        if zero:
            ok = all(bool((x == 0).all()) for x in got)
            print(f"  {name}: dq, dk, dv all 0: {ok} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(name)
            errs = [0.0]
        else:
            want = k2_final_reference(attn, qq, kk, vv, q_seg, kv_seg, out, lse, gg, q_off,
                                      kv_off)
            errs = [compare_grad(f"{name} {n}", a, b, bf, failures)
                    for n, a, b in zip(("dq", "dk", "dv"), got, want)]
            del want
        S = kk.shape[1]
        pairs = live_pairs(q_seg, kv_seg, True, q_off, kv_off, T, S, 1)
        bnd = bound(10 * D * H * pairs, live_bytes((qq, out, gg, lse), (kk, vv),
                                                   got, q_seg, kv_seg, True, q_off, kv_off))
        ms = time_ms(lambda: attn.flash_attention_bwd(qq, kk, vv, q_seg, kv_seg, out, lse, gg,
                                                      True, None, q_off, kv_off))
        plain = time_ms(lambda: k2_final_reference(attn, qq, kk, vv, q_seg, kv_seg, out, lse,
                                                   gg, q_off, kv_off), 3, 1)
        lib = None
        if runs is not None and yardstick_checkable(name, failures, n_failed):
            qr, kr, kk2, vv2 = runs
            fwd, bwd = attention_library(qq, kk2, vv2, qr, kr, True)
            rng_state, unused = fwd()[2:4]
            outs = (out.reshape(-1, H, D), lse[0], rng_state, unused)
            yard = []
            for n, a, b in zip(("dq", "dk", "dv"), bwd(outs, gg), got):
                b = b if n == "dq" else b[:, S - kk2.shape[1]:]
                compare_grad(f"{name} yardstick {n} vs kernel", a.view(b.shape), b, bf, yard)
            failures.extend(f"yardstick (not the kernel): {n}" for n in yard)
            if not yard:
                lib = time_ms(lambda: bwd(outs, gg))
        k2_rows[name] = timed_row(name, max(errs), ms, plain, lib, bnd, card)
        return got

    own_runs = [e - a for _, a, e in seg_runs(segs[1][0].cpu().numpy())]
    d_own = k2("own chunk @4096/@4096", qs[1], ks[1], vs[1], segs[1], segs[1], out_f1, lse_f1,
               gs[1], T, T, runs=(own_runs, own_runs, ks[1], vs[1]))
    d_past = k2("past chunk @4096/@0", qs[1], ks[0], vs[0], segs[1], segs[0], out_f1, lse_f1,
                gs[1], T, 0)
    k2("future chunk @0/@4096", qs[0], ks[1], vs[1], segs[0], segs[1], out_f0, lse_f0, gs[0],
       0, T, zero=True)
    d_ag = k2("allgather @4096 over 8192 keys", qs[1], k, v, segs[1], seg, out_f1, lse_f1,
              gs[1], T, 0, runs=(q_runs, k_runs, k[:, first:], v[:, first:]))
    # the ring's steps add up to the allgather call's gradients
    for n, i in (("dq", 0), ("dk", 1), ("dv", 2)):
        ring_sum = torch.cat([d_past[i].float(), d_own[i].float()], 1) if i else \
            d_own[0].float() + d_past[0].float()
        compare_grad(f"(p) K2 ring steps summed vs the allgather call {n}", ring_sum,
                     d_ag[i].float(), bf, failures)
    torch.cuda.empty_cache()
    return k1_rows, k2_rows


def gemm_yardstick(h, w, chunk):
    """The backward's three products alone, on cuBLAS (torch.matmul, bf16 in
    and out), at the kernel's shapes and chunks: t = h w^T, dh = t w, dw =
    t^T h per chunk. Not a library_ms (no call computes K3's function: this
    has no epilogue, no softmax, no f32 dw); it says how far the mainloop is
    from a tuned GEMM. Used nowhere in the port. Returns a function to time."""
    N = h.shape[0]
    t = torch.empty((chunk, w.shape[0]), dtype=h.dtype, device=h.device)
    dh = torch.empty_like(h)
    dw = torch.empty_like(w)

    def run():
        for c0 in range(0, N, chunk):
            hc = h[c0:c0 + chunk]
            tc = t[:hc.shape[0]]
            torch.matmul(hc, w.t(), out=tc)
            torch.matmul(tc, w, out=dh[c0:c0 + chunk])
            torch.matmul(tc.t(), hc, out=dw)
    return run


def check_k3(fused_ce, dev, gen, failures, card, timing=True):
    print("[7] K3 fused_ce fwd/bwd vs _rows_reference / _rows_backward_reference")
    rows = {}

    def case(name, N, E, V, dtype, tie=(), timed=False, chunk_rows=None, min_chunks=1):
        saved = fused_ce.DL_SCRATCH_BYTES
        if chunk_rows:  # a smaller dl scratch: the backward runs in row chunks
            fused_ce.DL_SCRATCH_BYTES = chunk_rows * fused_ce.dl_stride(V) * \
                torch.finfo(dtype).bits // 8
        plan = fused_ce.bwd_plan(N, E, V, dtype)
        fplan = fused_ce.fwd_plan(N, E, V, dtype, torch.cuda.get_device_properties(dev)
                                  .multi_processor_count)
        chunks = -(-N // plan.chunk)
        ok = chunks >= min_chunks
        print(f"  {name}: forward on the {fplan.mainloop} mainloop, {fplan.splits} vocab "
              f"splits of {fused_ce.split_run(fplan, V, 0)[1]} {fplan.col_tile}-column tiles; "
              f"backward on the {plan.mainloop} mainloop in {chunks} dl row "
              f"chunk(s) of {plan.chunk} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} chunks")
        try:
            body(name, N, E, V, dtype, tie, timed and timing, plan.chunk)
        finally:
            fused_ce.DL_SCRATCH_BYTES = saved

    def body(name, N, E, V, dtype, tie, timed, chunk):
        h = torch.randn((N, E), generator=gen, device=dev).to(dtype)
        w = (0.02 * torch.randn((V, E), generator=gen, device=dev)).to(dtype)
        labels = torch.randint(0, V, (N,), generator=gen, device=dev, dtype=torch.int32)
        labels[::9] = -100
        if tie:  # the rows of w in `tie` equal and dominant for every row
            h[:, 0] = 4.0
            w[list(tie)] = 0.0
            w[list(tie), 0] = 8.0
        lse, tl, m2, ai = fused_ce.fused_ce_fwd(h, w, labels)
        torch.cuda.synchronize()
        want = fused_ce._rows_reference(h, w, labels)
        stat_err = 0.0
        for n, a, b in zip(("lse", "true_logit", "m2"), (lse, tl, m2), want[:3]):
            err = (a - b).abs().max().item()
            stat_err = max(stat_err, err)
            ok = err <= CE_STAT_TOL and bool(torch.isfinite(a).all())
            print(f"  {name} {n}: max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{name} {n}")
        agree = (ai == want[3]).float().mean().item()
        ok = (ai == min(tie)).all().item() if tie else agree >= ARGMAX_AGREE
        print(f"  {name} argmax: agreement {agree:.5f}"
              f"{f' (tie of {tie}: all rows pick {min(tie)})' if tie else ''} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} argmax")
        del want
        valid = (labels != -100).float()
        dlse, dtl = valid / N, -valid / N  # the mean CE's cotangents
        dh, dw = fused_ce.fused_ce_bwd(h, w, labels, lse, dlse, dtl)
        torch.cuda.synchronize()
        wdh, wdw = fused_ce._rows_backward_reference(h, w, labels, lse, dlse, dtl)
        e_dh = compare_grad(f"{name} dh", dh, wdh, dtype, failures)
        e_dw = compare_grad(f"{name} dw", dw, wdw, dtype, failures)
        # the mean CE's dl = p / N rounds to the input type: in f16 what
        # falls below 2^-24 flushes to 0 (as in JAX), where bf16 keeps it
        zero = (dw == 0).float().mean().item(), (wdw == 0).float().mean().item()
        print(f"  {name} dw: share exactly zero {zero[0]:.6f} (plain version {zero[1]:.6f})")
        del wdh, wdw
        dh2, dw2 = fused_ce.fused_ce_bwd(h, w, labels, lse, dlse, dtl)
        same = torch.equal(dw, dw2) and torch.equal(dh, dh2)
        print(f"  {name}: dh, dw of two runs equal bit for bit: {same} "
              f"{'ok' if same else 'FAIL'}")
        if not same:
            failures.append(f"{name} bit-stable")
        grad_bytes = nbytes(dh, dw)
        del dh, dw, dh2, dw2
        if timed:
            fwd = time_ms(lambda: fused_ce.fused_ce_fwd(h, w, labels))
            fwd_p = time_ms(lambda: fused_ce._rows_reference(h, w, labels))
            bwd = time_ms(lambda: fused_ce.fused_ce_bwd(h, w, labels, lse, dlse, dtl), 3, 1)
            bwd_p = time_ms(lambda: fused_ce._rows_backward_reference(
                h, w, labels, lse, dlse, dtl), 3, 1)
            # no one PyTorch call gives lse, label logit and argmax without [N, V]
            stats = nbytes(lse, tl, m2, ai)
            rows[name] = {
                "fwd": timed_row(f"{name} fwd", stat_err, fwd, fwd_p, None,
                                 bound(2 * N * E * V, nbytes(h, w, labels) + stats), card),
                "bwd": timed_row(f"{name} bwd", max(e_dh, e_dw), bwd, bwd_p, None,
                                 bound(6 * N * E * V,
                                       nbytes(h, w, labels, lse, dlse, dtl) + grad_bytes),
                                 card)}
            rows[name]["bwd"]["dw_zero_share"] = zero[0]
            if dtype != torch.float32:
                t = torch.empty((N, V), dtype=dtype, device=dev)
                gemm = time_ms(lambda: torch.matmul(h, w.t(), out=t))
                del t
                rows[name]["fwd"]["gemm_ms"] = gemm
                print(f"  {name} fwd: gemm_ms {gemm:.3f} (cuBLAS {dtype} h w^T over the same "
                      f"rows, no epilogue; informational, not a library_ms)  [{card}]")
                gemm = time_ms(gemm_yardstick(h, w, chunk), 3, 1)
                rows[name]["bwd"]["gemm_ms"] = gemm
                print(f"  {name} bwd: gemm_ms {gemm:.3f} (cuBLAS {dtype} on the three "
                      f"products' shapes, no epilogue; informational, not a library_ms)  "
                      f"[{card}]")
        del h, w
        torch.cuda.empty_cache()

    case("(a) N4096 E2048 V128256 bf16", 4096, 2048, 128256, torch.bfloat16, timed=True)
    case("(b) N2048 E2048 V128256 f32, 576-row dl chunks", 2048, 2048, 128256,
         torch.float32, chunk_rows=576, min_chunks=4)
    case("(c) argmax tie N256 E2048 V128256 f32", 256, 2048, 128256, torch.float32,
         tie=(5, 128255))
    # columns 5 and 7 lie in two lanes of a quad, 261 in the next tile of
    # the same split, 128255 in the last split
    case("(c) argmax tie N256 E2048 V128256 bf16", 256, 2048, 128256, torch.bfloat16,
         tie=(7, 5, 261, 128255))
    case("(d) main path: N16384 E2048 V128256 bf16", 16384, 2048, 128256, torch.bfloat16,
         timed=True, min_chunks=2)
    case("(d16) main path in f16: N16384 E2048 V128256 f16", 16384, 2048, 128256,
         torch.float16, timed=True, min_chunks=2)
    # touch_audio's SFT head (phase 18): Touch-Audio-7B's E 4096 and V 128256
    # at the recipe's 2 x 8192 rows, and ties at that width
    case("(q) touch_audio SFT head: N16384 E4096 V128256 bf16", 16384, 4096, 128256,
         torch.bfloat16, timed=True)
    case("(q) argmax tie N256 E4096 V128256 bf16", 256, 4096, 128256, torch.bfloat16,
         tie=(7, 5, 261, 128255))
    # the audio pretraining path's vocab: 1024 BEST-RQ codes + 1 = 4 whole
    # 256-column tiles and one live column in the fifth, the last split's
    # only tile; dl's row stride rounds 1025 up to 1032
    case("(e) audio main path: N8192 E2048 V1025 bf16", 8192, 2048, 1025, torch.bfloat16,
         timed=True)
    case("(f) ragged tail: N256 E2048 V1025 bf16", 256, 2048, 1025, torch.bfloat16)
    case("(f) ragged tail: N256 E2048 V1025 f32, 64-row dl chunks", 256, 2048, 1025,
         torch.float32, chunk_rows=64, min_chunks=4)
    # column 1024 is the last tile's one live column
    case("(f) argmax tie N256 E2048 V1025 bf16", 256, 2048, 1025, torch.bfloat16,
         tie=(1024,))
    if timing:
        rows.update(check_k3_shards(fused_ce, dev, gen, failures, card))
        rows.update(check_k3_shards(fused_ce, dev, gen, failures, card, torch.float16, (2,)))
    return rows



def _stacked_reduce(t, op):
    """combine_vocab_shards' all-reduce over a leading axis of shards held in
    one process: the group's reduction, each shard given the result."""
    if op == "sum":
        return t.sum(0, keepdim=True).expand_as(t)
    red = t.amax(0, keepdim=True) if op == "max" else t.amin(0, keepdim=True)
    return red.expand_as(t)


def check_k3_shards(fused_ce, dev, gen, failures, card, dtype=torch.bfloat16,
                    tps=(2, 4)) -> dict:
    """Phase 7 (o): K3 on Llama-3.2-1B's head split into `tps` vocab shards
    (tensor parallelism's loss), at the main path's rows. Each shard's K3
    takes labels - its first id; the shards' statistics are merged by the
    port's own combine (parallel/loss_parallel.combine_vocab_shards) with a
    reduction over a stacked shard axis standing in for the tp group. The
    mean CE's loss, dh and dw are held to whole-vocab K3 and to the plain
    version under phase 7's limits; the label logit, lse and argmax too,
    rows 0-63 holding a tie across the boundary of shards 0 and 1 (the
    smaller id must win). One shard's forward and backward are timed. In
    `dtype` (bf16; f16 as (o16) at tp 2)."""
    from touchnet_tpu_torch.parallel.loss_parallel import combine_vocab_shards

    N, E, V = TRAIN_T, 2048, 128256
    tag, ty = ("(o)", "bf16") if dtype == torch.bfloat16 else ("(o16)", "f16")
    print(f"  {tag} K3 on vocab shards: N{N} E{E} V{V} {ty} split over tp {tps}, combined by "
          "loss_parallel.combine_vocab_shards over a stacked shard axis")
    h = torch.randn((N, E), generator=gen, device=dev).to(dtype)
    w = (0.02 * torch.randn((V, E), generator=gen, device=dev)).to(dtype)
    labels = torch.randint(0, V, (N,), generator=gen, device=dev, dtype=torch.int32)
    labels[::9] = -100
    valid = labels != -100
    rows = {}
    for tp in tps:
        vl = V // tp
        ht, wt, lab = h.clone(), w.clone(), labels.clone()
        ht[:64, 0] = 4.0  # ids vl-1 and vl: equal and dominant for rows 0-63
        wt[[vl - 1, vl]] = 0.0
        wt[[vl - 1, vl], 0] = 8.0
        lab[0:64:2], lab[1:64:2] = vl - 1, vl
        starts = torch.arange(tp, device=dev, dtype=torch.int32)[:, None] * vl

        def sharded(hs, ws, lab=lab, vl=vl, tp=tp, starts=starts):
            stats = [fused_ce.fused_ce_rows(hs, ws[s * vl:(s + 1) * vl], lab - s * vl)
                     for s in range(tp)]
            lse, tl, m2, ai = (torch.stack(x) for x in zip(*stats))
            lse, tl, ai = combine_vocab_shards(lse, tl, m2, ai, starts, _stacked_reduce)
            return lse[0], tl[0], ai[0]

        def whole(hs, ws, lab=lab):
            lse, tl, _, ai = fused_ce.fused_ce_rows(hs, ws, lab)
            return lse, tl, ai

        def plain(hs, ws, lab=lab):
            lse, tl, _, ai = fused_ce.fused_ce_rows_reference(hs, ws, lab)
            return lse, tl, ai

        out = {}
        for name, fn in (("shards", sharded), ("whole", whole), ("plain", plain)):
            hs, ws = ht.clone().requires_grad_(), wt.clone().requires_grad_()
            lse, tl, ai = fn(hs, ws)
            loss = ((lse - tl) * valid).sum() / valid.sum()
            loss.backward()
            out[name] = (loss.detach(), lse.detach(), tl.detach(), ai, hs.grad, ws.grad)
            del hs, ws, lse, tl, loss
            torch.cuda.synchronize()
        got = out["shards"]
        errs = []
        for ref_name in ("whole", "plain"):
            ref = out[ref_name]
            stat = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(got[:3], ref[:3]))
            agree = (got[3] == ref[3]).float().mean().item()
            ok = stat <= CE_STAT_TOL and agree >= ARGMAX_AGREE
            what = "the plain version" if ref_name == "plain" else "whole-vocab K3"
            print(f"  {tag} tp {tp} vs {what}: loss {got[0].item():.6f} vs "
                  f"{ref[0].item():.6f}, loss/lse/label logit max_abs_err={stat:.3e}, argmax "
                  f"agreement {agree:.5f} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{tag} tp {tp} statistics vs {ref_name}")
            errs.append(stat)
            errs.append(compare_grad(f"{tag} tp {tp} dh vs {ref_name}", got[4], ref[4],
                                     dtype, failures))
            errs.append(compare_grad(f"{tag} tp {tp} dw vs {ref_name}", got[5], ref[5],
                                     dtype, failures))
        tie = bool((got[3][:64] == vl - 1).all())
        print(f"  {tag} tp {tp}: rows 0-63 tie ids {vl - 1} and {vl} across the shard boundary: "
              f"all pick {vl - 1}: {tie} {'ok' if tie else 'FAIL'}")
        if not tie:
            failures.append(f"{tag} tp {tp} tie across shards")
        del out
        # one shard's kernels at the shape each rank's K3 sees
        w0, l0 = wt[:vl].contiguous(), lab
        lse, tl, m2, ai = fused_ce.fused_ce_fwd(ht, w0, l0)
        dlse, dtl = valid.float() / N, -valid.float() / N
        fwd = time_ms(lambda: fused_ce.fused_ce_fwd(ht, w0, l0))
        fwd_p = time_ms(lambda: fused_ce._rows_reference(ht, w0, l0))
        bwd = time_ms(lambda: fused_ce.fused_ce_bwd(ht, w0, l0, lse, dlse, dtl), 3, 1)
        bwd_p = time_ms(lambda: fused_ce._rows_backward_reference(ht, w0, l0, lse, dlse, dtl),
                        3, 1)
        name = f"{tag} tp {tp} vocab shard: N{N} E{E} V{vl} {ty}"
        rows[name] = {
            "fwd": timed_row(f"{name} fwd", max(errs), fwd, fwd_p, None,
                             bound(2 * N * E * vl, nbytes(ht, w0, l0, lse, tl, m2, ai)), card),
            "bwd": timed_row(f"{name} bwd", max(errs), bwd, bwd_p, None,
                             bound(6 * N * E * vl, nbytes(ht, w0, l0, lse, dlse, dtl)
                                   + nbytes(ht, w0)), card)}
        del ht, wt, w0, lse, tl, m2, ai
        torch.cuda.empty_cache()
    return rows

def seeded_documents(seed: int, count: int) -> list:
    """`count` documents, lengths 200-3000, each an ascending run of ids mod
    DOC_RANGE (a learnable next-token rule over a small id range)."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(count):
        n = int(rng.integers(200, 3001))
        start = int(rng.integers(0, DOC_RANGE))
        docs.append((np.arange(n) + start) % DOC_RANGE + 3)
    return docs


def write_shards(root: Path, vocab: int, seed: int, shards: int = 4, docs: int = 120) -> Path:
    """TouchDataset texttoken shards through the port's DataBuilder:
    `shards` shards of `docs` seeded_documents each."""
    from touchnet_tpu_torch.bin.make_data import DataBuilder

    all_docs = seeded_documents(seed, shards * docs)
    lines = []
    for s in range(shards):
        d = root / f"{s:09d}"
        d.mkdir(parents=True)
        b = DataBuilder(str(d / "texttoken.bin"), np.int32)
        for doc in all_docs[s * docs:(s + 1) * docs]:
            b.add_item(doc)
            b.end_document()
        b.finalize(str(d / "texttoken.idx"))
        lines.append(f"{d} texttoken\n")
    listfile = root / "data.list"
    listfile.write_text("".join(lines))
    return listfile


def train_argv(listfile, exp, seqlen, steps, dtype, vocab, remat="op_small", **extra) -> list:
    """The recipe's flags (run.sh stage 2) on one card (dp 1): its remat
    op_small (or `remat`), 10 steps at lr 1e-3, no checkpoints, dev set,
    profiling or tensorboard unless `extra` (flag: value) adds them."""
    args = {
        "tokenizer_type": "RawTokenizer", "tokenizer_raw_vocab_size": vocab,
        "datapipe_type": "causal_lm", "datalist_path": listfile,
        "datalist_sharding": "true", "datalist_epoch": 10000,
        "datalist_shuffling": "true", "dataset_shuffling": "true", "dataset_mmap": "true",
        "dataset_batchsize": 1, "dataset_text_seqlen": seqlen,
        "text_max_length_in_tokens_for_filter": seqlen - 2,
        "text_min_length_in_tokens_for_filter": 1,
        "dataloader_num_workers": 2, "dataloader_prefetch_factor": 2,
        "training_seed": 2025, "training_model_name": "llama",
        "training_model_config_path": CONFIG, "training_trace_dump_folder": exp,
        "training_data_parallel_shard_degree": 1, "training_enable_loss_parallel": "true",
        "training_enable_liger_kernel": "true", "training_log_freq": 1,
        "training_mixed_precision_param": dtype, "training_mixed_precision_reduce": "float32",
        "training_max_norm": 1.0, "training_activation_checkpoint_mode": remat,
        "training_activation_checkpoint_selective_ac_option": "op",
        "optimizer_name": "AdamW", "optimizer_lr": 1e-3, "optimizer_impl": "fused",
        "lr_scheduler_steps": steps, "lr_scheduler_warmup_steps": 2,
        "lr_scheduler_decay_type": "linear", "lr_scheduler_lr_min": 0.0, **extra,
    }
    return [x for k, v in args.items() for x in (f"--{k}", str(v))]


@contextlib.contextmanager
def count_plain_calls():
    """Counts calls of every plain version while open (the training and
    serving paths must make none)."""
    from touchnet_tpu_torch.ops import attention as attn
    from touchnet_tpu_torch.ops import decode_attention as dec
    from touchnet_tpu_torch.ops import fused_ce

    calls = {}
    targets = [(attn, "packed_attention_reference"), (attn, "flash_attention_bwd_reference"),
               (fused_ce, "_rows_reference"), (fused_ce, "_rows_backward_reference"),
               (dec, "decode_attention_reference")]
    saved = [getattr(m, n) for m, n in targets]

    def counted(fn, name):
        def wrap(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrap

    for (m, n), fn in zip(targets, saved):
        setattr(m, n, counted(fn, n))
    try:
        yield calls
    finally:
        for (m, n), fn in zip(targets, saved):
            setattr(m, n, fn)


def step_grads(train, argv, plain, dev):
    """One step's (loss, grad norm, flat f32 gradient) through the port's
    Trainer built from `argv`: the first batch of the loader, loss and
    backward as train_step runs them, no optimizer update."""
    from touchnet_tpu_torch.bin import TrainConfig
    from touchnet_tpu_torch.data import DataConfig
    from touchnet_tpu_torch.tokenizer import TokenizerConfig
    from touchnet_tpu_torch.utils.cli import parse_args_into_dataclasses
    from touchnet_tpu_torch.utils.optimizer import global_grad_norm

    tok, data, job = parse_args_into_dataclasses([TokenizerConfig, DataConfig, TrainConfig],
                                                 argv)
    trainer = train.Trainer(tok, data, job, dev)
    it = iter(trainer.dataloader)
    batch, num_sentence = trainer._put_batch(next(it))
    trainer.close()
    with plain_kernels() if plain else contextlib.nullcontext():
        loss, _, _ = trainer._loss_and_acc(batch, num_sentence)
        loss.backward()
    # a tensor the loss does not reach (kimi_audio's mimo stack) has none
    grads = [p.grad for p in trainer.params if p.grad is not None]
    gnorm = global_grad_norm(grads).item()
    flat = torch.cat([g.float().flatten() for g in grads])
    out = loss.item(), gnorm, flat
    del trainer, grads, batch, loss
    torch.cuda.empty_cache()
    return out


SWEEP_MODES = ("none", "op_small", "full")


def step_stats(trainer, skip=()) -> tuple:
    """(step ms, tokens/s, MFU %) as medians of steps 3-10 of a run's
    logged metrics, less the steps in `skip`."""
    timed = [h for h in trainer.metrics_processor.history[2:] if h["step"] not in skip]
    return (statistics.median(h["time/step_s"] for h in timed) * 1e3,
            statistics.median(h["throughput/tps"] for h in timed),
            statistics.median(h.get("throughput/mfu_pct", float("nan")) for h in timed))


def remat_sweep(train, attn, listfile, tmp: Path, L, card, failures):
    """Phase 8's 10 steps under each remat mode of SWEEP_MODES, in this
    order, one process: step ms, tokens/s, MFU, peak memory and K1 launches
    per step (none and op_small L, full 2L); the modes' losses must be
    equal bit for bit."""
    print(f"  remat sweep: {SWEEP_STEPS} steps at 1x{TRAIN_T} bf16 each, full width and depth")
    losses = {}
    for mode in SWEEP_MODES:
        argv = train_argv(listfile, tmp / f"sweep_{mode}", TRAIN_T, SWEEP_STEPS, "bfloat16",
                          128256, remat=mode)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = attn.flash_attention.launches
        trainer = train.main(argv)
        k1 = (attn.flash_attention.launches - before) / trainer.step
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_ms, tps, mfu = step_stats(trainer)
        losses[mode] = [h["loss/per_sample"] for h in trainer.metrics_processor.history]
        want = 2 * L if mode == "full" else L
        ok = k1 == want and trainer.step == SWEEP_STEPS
        print(f"  {mode}: step {step_ms:.1f} ms (median of steps 3-{trainer.step}), "
              f"{tps:,.0f} tokens/s, MFU {mfu:.2f}%, peak {peak:.2f} GiB allocated, "
              f"K1 {k1:g} launches/step (want {want}) {'ok' if ok else 'FAIL'}  [{card}]")
        if not ok:
            failures.append(f"remat sweep {mode}")
        del trainer
        torch.cuda.empty_cache()
    same = all(v == losses[SWEEP_MODES[0]] for v in losses.values())
    print(f"  remat sweep: the modes' losses equal bit for bit: {same} {'ok' if same else 'FAIL'}")
    if not same:
        failures.append("remat sweep losses differ")

    # --training_deterministic true: PyTorch's deterministic algorithms only
    # (an op without one raises, which fails this run) and cuBLAS's fixed
    # workspace; process-wide, so switched off again after the run
    argv = train_argv(listfile, tmp / "sweep_det", TRAIN_T, SWEEP_STEPS, "bfloat16", 128256,
                      training_deterministic="true")
    torch.cuda.empty_cache()
    try:
        trainer = train.main(argv)
    finally:
        torch.use_deterministic_algorithms(False)
    step_ms, tps, mfu = step_stats(trainer)
    det = [h["loss/per_sample"] for h in trainer.metrics_processor.history]
    ok = trainer.step == SWEEP_STEPS and all(math.isfinite(x) for x in det)
    print(f"  op_small under --training_deterministic true: no op raised; step {step_ms:.1f} ms, "
          f"{tps:,.0f} tokens/s, MFU {mfu:.2f}%; losses equal the default run's bit for bit: "
          f"{det == losses['op_small']} {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("deterministic run")
    del trainer
    torch.cuda.empty_cache()


# the trainer's single-device modes, each a run of phase 8's steps under
# op_small with one flag added
MODE_RUNS = (("gradient accumulation G=2", {"training_gradient_accumulation_steps": 2}),
             ("bf16 reduce", {"training_mixed_precision_reduce": "bfloat16"}),
             ("cpu offload", {"training_enable_cpu_offload": "true"}),
             ("float16 compute", {"training_mixed_precision_param": "float16"}))
# the bf16-reduce run's losses at steps 5 and 10 against the f32-reduce
# run's, relative. The two runs part slowly as the rounded gradients steer
# the weights apart: 3.3e-4 at step 5 and 2.28e-2 at step 10 on an H100
# 80GB HBM3 at 700 W (PERF.md, PR 7); each bound is a few times its reading
BF16_REDUCE_LOSS = {5: 2e-3, 10: 5e-2}
# the offload run's checkpoints: a sync save at step 1 alone (this script
# skips the trainer's last saves, which nothing reads), then a fresh run
# resumes from it (cut from saves at 1, 5 and 10 and a resume from 5, then
# from saves at 1 and 10 and the resumed run's at 10, for the script's
# time: 15 GB a save)
OFFLOAD_CKPT = {"training_enable_ckpt": "true", "training_ckpt_interval": 10,
                "training_ckpt_keep_latest_k": 2, "training_ckpt_async_mode": "disabled"}
OFFLOAD_RESUME = 1


def kernel_counters():
    from touchnet_tpu_torch.ops import attention as attn
    from touchnet_tpu_torch.ops import fused_ce

    return {"K1": attn.flash_attention, "K2": attn.flash_attention_bwd,
            "K3 fwd": fused_ce.fused_ce_fwd, "K3 bwd": fused_ce.fused_ce_bwd}


@contextlib.contextmanager
def timed_saves(train):
    """{step: (ms the loop blocked in Trainer.save, s of the disk write)}
    of every saving call while open."""
    from touchnet_tpu_torch.utils.checkpoint import CheckpointManager

    times, writes = {}, {}
    real_save, real_write = train.Trainer.save, CheckpointManager._write

    def save(self, force=False):
        t0 = time.perf_counter()
        saved = real_save(self, force)
        if saved:
            times[self.step] = ((time.perf_counter() - t0) * 1e3, writes.get(self.step, 0.0))
        return saved

    def write(self, step, host, items):
        t0 = time.perf_counter()
        real_write(self, step, host, items)
        writes[step] = time.perf_counter() - t0

    train.Trainer.save, CheckpointManager._write = save, write
    try:
        yield times
    finally:
        train.Trainer.save, CheckpointManager._write = real_save, real_write


@contextlib.contextmanager
def saves_where(keep):
    """While open, a trainer saves at a step only when keep(step, force) (its
    cadence's other saves skipped; force: its last step or a preemption);
    `keep` None changes nothing."""
    from touchnet_tpu_torch.utils.checkpoint import CheckpointManager

    real = CheckpointManager._should_save
    if keep is not None:
        CheckpointManager._should_save = \
            lambda self, step, force=False: self.enabled and keep(step, force)
    try:
        yield
    finally:
        CheckpointManager._should_save = real


def mode_runs(train, listfile, tmp: Path, L, card, failures, resident) -> dict:
    """Phase 8's 10 steps at 1x16384 under op_small with each of MODE_RUNS:
    step ms, tokens/s, MFU, peak memory and launches per step. Checks:
    accumulation launches 2L, 2L, 2, 2 a step with finite, falling losses;
    bf16 reduce's losses falling, its step-1 loss equal to the f32-reduce
    run's (`resident`, phase 8's main run) bit for bit (the forward reads
    the same bf16 weights) and its losses at steps 5 and 10 within
    BF16_REDUCE_LOSS of it; cpu offload's losses and final params, mu, nu and count equal the
    resident run's bit for bit, with a sync checkpoint at step 1 (the
    trainer's last save skipped here), and a fresh run resumed from it equal
    to it too (the host moments saved after their last copy back, and loaded
    in place); float16 compute (f16 K1, K2, K3 and matmuls over the f32
    masters, no loss scaler, as JAX) launches L, L, 1, 1 a step, its losses
    finite and falling, its step-1 loss within STEP_BF16_LOSS of the bf16
    run's (both round the same f32 weights once, into 16 bits). Each run is
    a main path: the counts are zeroed just before it and read just after
    (after the resume for offload); returns their sums."""
    counters = kernel_counters()
    totals = dict.fromkeys(counters, 0)
    print(f"  single-device modes: {TRAIN_STEPS} steps at 1x{TRAIN_T} under op_small each (bf16 "
          "compute but in the float16 run), full width and depth")
    for i, (mode, extra) in enumerate(MODE_RUNS):
        offload = "training_enable_cpu_offload" in extra
        exp = tmp / f"mode_{i}"
        argv = train_argv(listfile, exp, TRAIN_T, TRAIN_STEPS, "bfloat16", 128256,
                          **extra, **(OFFLOAD_CKPT if offload else {}))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        # the offload run saves only the step its resumed run reads
        resume_save = (lambda step, force: step == OFFLOAD_RESUME) if offload else None
        with timed_saves(train) as saves, saves_where(resume_save):
            trainer = train.main(argv)
        got = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = trainer.step
        per_step = tuple(n / steps for n in got.values())
        # under offload the sync save at the resume step sits in the next step's time
        step_ms, tps, mfu = step_stats(trainer, skip=(OFFLOAD_RESUME + 1,) if offload else ())
        losses = [h["loss/per_sample"] for h in trainer.metrics_processor.history]
        G = extra.get("training_gradient_accumulation_steps", 1)
        want = (G * L, G * L, G, G)
        ok = per_step == want and steps == TRAIN_STEPS and \
            all(math.isfinite(x) for x in losses)
        note = ""
        if G > 1:
            ok = ok and losses[-1] < losses[0]
            note = f"losses {[round(x, 4) for x in losses]} (finite, falling)"
        elif extra.get("training_mixed_precision_param") == "float16":
            d1 = abs(losses[0] - resident[0][0])
            ok = ok and losses[-1] < losses[0] and d1 <= STEP_BF16_LOSS
            note = (f"losses {[round(x, 4) for x in losses]} (finite, falling), the bf16 run's "
                    f"{[round(x, 4) for x in resident[0]]}; step-1 loss {losses[0]!r} vs bf16 "
                    f"{resident[0][0]!r}: |diff| {d1:.3e} (<= {STEP_BF16_LOSS})")
        elif not offload:
            same = losses[0] == resident[0][0]
            rel = {s: abs(losses[s - 1] - resident[0][s - 1]) / resident[0][s - 1]
                   for s in BF16_REDUCE_LOSS}
            ok = ok and same and losses[-1] < losses[0] and \
                all(rel[s] <= b for s, b in BF16_REDUCE_LOSS.items())
            note = (f"losses {[round(x, 4) for x in losses]} (falling), the f32-reduce run's "
                    f"{[round(x, 4) for x in resident[0]]}; step-1 loss {losses[0]!r} vs "
                    f"{resident[0][0]!r}: bit-equal {same}; " + ", ".join(
                        f"step-{s} loss {losses[s - 1]!r} vs {resident[0][s - 1]!r}: rel "
                        f"{rel[s]:.3e} (<= {b})" for s, b in BF16_REDUCE_LOSS.items()))
        else:
            bits = bits_checksums({**trainer.model.state_dict(), **trainer._opt_state()})
            differ = sorted(k for k in bits if bits[k] != resident[1].get(k))
            same = losses == resident[0] and not differ and len(bits) == len(resident[1])
            ok = ok and same
            pinned = trainer.offload.pinned_bytes
            note = (f"{pinned} bytes of pinned host memory ({pinned / 1e9:.2f} GB, mu and nu); "
                    f"losses and final params, mu, nu, count ({len(bits)} tensors) equal the "
                    f"resident run's bit for bit: {same}, differ in {differ[:5] or 'none'}; "
                    "sync saves, the loop blocked " + ", ".join(
                        f"step {s} {ms:.1f} ms ({w:.2f} s of it the disk write)"
                        for s, (ms, w) in sorted(saves.items())))
            ok = ok and sorted(saves) == [OFFLOAD_RESUME]
        print(f"  {mode}: step {step_ms:.1f} ms (median of steps 3-{steps}"
              f"{f' less {OFFLOAD_RESUME + 1}' if offload else ''}), {tps:,.0f} "
              f"tokens/s, MFU {mfu:.2f}%, peak {peak:.2f} GiB allocated; launches per step "
              f"K1/K2/K3 fwd/K3 bwd {per_step} (want {want}); {note} "
              f"{'ok' if ok else 'FAIL'}  [{card}]")
        if not ok:
            failures.append(f"mode run: {mode}")
        del trainer
        torch.cuda.empty_cache()
        if offload:
            with saves_where(resume_save):
                resumed = train.main(train_argv(
                    listfile, exp, TRAIN_T, TRAIN_STEPS, "bfloat16", 128256, **extra,
                    **{**OFFLOAD_CKPT, "training_ckpt_load_step": OFFLOAD_RESUME}))
            got = {k: c.launches for k, c in counters.items()}
            hist = resumed.metrics_processor.history
            bits = bits_checksums({**resumed.model.state_dict(), **resumed._opt_state()})
            del resumed
            torch.cuda.empty_cache()
            differ = sorted(k for k in bits if bits[k] != resident[1].get(k))
            ok = ([h["step"] for h in hist] == list(range(OFFLOAD_RESUME + 1, TRAIN_STEPS + 1))
                  and [h["loss/per_sample"] for h in hist] == resident[0][OFFLOAD_RESUME:]
                  and not differ and len(bits) == len(resident[1]))
            print(f"  cpu offload, a fresh run resumed from step {OFFLOAD_RESUME} (its pinned "
                  f"moments loaded in place): steps {[h['step'] for h in hist]}, losses and final "
                  f"params, mu, nu, count equal the resident run's bit for bit: {ok}, differ in "
                  f"{differ[:5] or 'none'}; {tree_bytes(exp / 'checkpoint')} bytes of "
                  f"checkpoints {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append("mode run: cpu offload resume")
            shutil.rmtree(exp / "checkpoint")
        for k, n in got.items():
            totals[k] += n
    return totals


def run_training(dev, card, failures, tmp: Path):
    from touchnet_tpu_torch.bin import train
    from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
    from touchnet_tpu_torch.ops import attention as attn
    from touchnet_tpu_torch.ops import fused_ce

    print("[8] slice: Llama-3.2-1B training, bin.train.main")
    cfg = LlamaConfig.from_json_file(str(CONFIG))
    L = cfg.num_hidden_layers
    listfile = write_shards(tmp / "shards", cfg.vocab_size, SEED)
    argv = train_argv(listfile, tmp / "exp", TRAIN_T, TRAIN_STEPS, "bfloat16", cfg.vocab_size)
    print(f"  {TRAIN_STEPS} steps, 1x{TRAIN_T} packed, bf16 compute over f32 masters, "
          "remat op_small, fused CE, AdamW fused, WSD linear, lr 1e-3, warmup 2")
    counters = (attn.flash_attention, attn.flash_attention_bwd, fused_ce.fused_ce_fwd,
                fused_ce.fused_ce_bwd)
    torch.cuda.reset_peak_memory_stats()
    # the main path: every launch count is zeroed here and read just after
    for c in counters:
        c.launches = 0
    with count_plain_calls() as plain_calls:
        trainer = train.main(argv)
    k1, k2, k3f, k3b = (c.launches for c in counters)
    hist = trainer.metrics_processor.history
    losses = [h["loss/per_sample"] for h in hist]
    steps = trainer.step
    want = (L * steps, L * steps, steps, steps)
    ok = (k1, k2, k3f, k3b) == want and not plain_calls and steps == TRAIN_STEPS
    print(f"  launches over {steps} steps: K1={k1} K2={k2} K3 fwd={k3f} K3 bwd={k3b} "
          f"(want {want}); plain versions called: {plain_calls or 'none'} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("training launch counts / plain calls")
    ok = len(losses) == steps and all(math.isfinite(x) for x in losses) and \
        losses[-1] < losses[0]
    print(f"  loss per step: {[round(x, 4) for x in losses]} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("training loss")
    step_ms, tps, mfu = step_stats(trainer)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  step {step_ms:.1f} ms (median of steps 3-{steps}), {tps:,.0f} tokens/s, "
          f"MFU {mfu:.2f}% of 989 TFLOP/s bf16, peak {peak:.2f} GiB allocated  [{card}]")
    train_counts = {"K1": k1, "K2": k2, "K3 fwd": k3f, "K3 bwd": k3b}
    resident = losses, bits_checksums({**trainer.model.state_dict(), **trainer._opt_state()})
    del trainer
    torch.cuda.empty_cache()
    remat_sweep(train, attn, listfile, tmp, L, card, failures)
    for name, n in mode_runs(train, listfile, tmp, L, card, failures, resident).items():
        train_counts[name] += n

    print(f"  one step at B1 T{CHECK_T}, full width and depth: kernel vs plain path")
    check_step(train, lambda dtype: train_argv(listfile, tmp / "chk", CHECK_T, 1, dtype, 128256),
               dev, failures, f16=True)
    return train_counts


def check_step(train, argv_of, dev, failures, what="", f16=False):
    """One step's loss, grad norm and gradients of the kernel path against
    the plain path (plain_kernels) on the trainer built from argv_of(dtype):
    f32 under STEP_F32_*, bf16 against the f32 plain path under STEP_BF16_*;
    with f16, check_step_f16 too."""
    f32k = step_grads(train, argv_of("float32"), plain=False, dev=dev)
    f32p = step_grads(train, argv_of("float32"), plain=True, dev=dev)
    e_loss = abs(f32k[0] - f32p[0]) / abs(f32p[0])
    e_gn = abs(f32k[1] - f32p[1]) / f32p[1]
    e_g = ((f32k[2] - f32p[2]).norm() / f32p[2].norm()).item()
    ok = e_loss <= STEP_F32_LOSS and e_gn <= STEP_F32_GNORM and e_g <= STEP_F32_GRADS
    print(f"  f32: loss {f32k[0]:.6f} vs {f32p[0]:.6f} (rel {e_loss:.2e} <= {STEP_F32_LOSS:.0e}), "
          f"grad norm {f32k[1]:.6f} vs {f32p[1]:.6f} (rel {e_gn:.2e} <= {STEP_F32_GNORM:.0e}), "
          f"gradients rel L2 {e_g:.2e} (<= {STEP_F32_GRADS:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{what}f32 train step")
    del f32k
    with k3_dw_zero_share() as z_bf:
        bfk = step_grads(train, argv_of("bfloat16"), plain=False, dev=dev)
    bfp = step_grads(train, argv_of("bfloat16"), plain=True, dev=dev)
    e_k = ((bfk[2] - f32p[2]).norm() / f32p[2].norm()).item()
    e_p = ((bfp[2] - f32p[2]).norm() / f32p[2].norm()).item()
    e_kp = ((bfk[2] - bfp[2]).norm() / bfp[2].norm()).item()
    d_loss = abs(bfk[0] - f32p[0])
    ok = e_k <= STEP_BF16_RATIO * e_p and d_loss <= STEP_BF16_LOSS and \
        math.isfinite(bfk[1])
    print(f"  bf16: gradients rel L2 vs f32 plain: kernel {e_k:.3e}, plain {e_p:.3e} "
          f"(kernel <= {STEP_BF16_RATIO}x plain); bf16 kernel vs bf16 plain {e_kp:.3e}; "
          f"loss {bfk[0]:.6f} vs f32 plain {f32p[0]:.6f} (|diff| {d_loss:.2e} <= "
          f"{STEP_BF16_LOSS:.0e}); grad norm {bfk[1]:.6f} / bf16 plain {bfp[1]:.6f} / "
          f"f32 plain {f32p[1]:.6f} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{what}bf16 train step")
    if f16:
        check_step_f16(train, argv_of, dev, failures, f32p, bfk, bfp, z_bf)
    del f32p, bfk, bfp
    torch.cuda.empty_cache()


@contextlib.contextmanager
def k3_dw_zero_share():
    """While open, the share of exactly-zero entries of each K3 backward's
    dw (the kernel's or the plain version's), in a list."""
    from touchnet_tpu_torch.ops import fused_ce

    shares = []
    real = fused_ce.fused_ce_bwd, fused_ce._rows_backward_reference

    def recorded(fn):
        def bwd(*a, **kw):
            dh, dw = fn(*a, **kw)
            shares.append((dw == 0).float().mean().item())
            return dh, dw
        bwd.launches = getattr(fn, "launches", 0)  # the kernel wrapper counts through its name
        return bwd

    fused_ce.fused_ce_bwd, fused_ce._rows_backward_reference = (recorded(f) for f in real)
    try:
        yield shares
    finally:
        real[0].launches = fused_ce.fused_ce_bwd.launches
        fused_ce.fused_ce_bwd, fused_ce._rows_backward_reference = real


def check_step_f16(train, argv_of, dev, failures, f32p, bfk, bfp, z_bf):
    """check_step's float16 half (phase 8): one step of the f16 kernel path
    against the f16 plain path and the f32 plain path (f32p), as bf16 is
    held: the whole gradient's error at most STEP_BF16_RATIO x the f16 plain
    path's, the loss within STEP_BF16_LOSS of the f32 plain loss, and the
    grad norm within STEP_F16_GNORM of the f16 plain path's; then the share
    of K3's dw that is exactly zero in the f16 step (its dl, ~p / N, rounds
    to f16, which flushes what falls below 2^-24) beside bf16's (z_bf, of
    check_step's bf16 kernel step bfk; bfp its plain step)."""
    with k3_dw_zero_share() as z_k:
        fk = step_grads(train, argv_of("float16"), plain=False, dev=dev)
    with k3_dw_zero_share() as z_p:
        fp = step_grads(train, argv_of("float16"), plain=True, dev=dev)
    e_k = ((fk[2] - f32p[2]).norm() / f32p[2].norm()).item()
    e_p = ((fp[2] - f32p[2]).norm() / f32p[2].norm()).item()
    e_kp = ((fk[2] - fp[2]).norm() / fp[2].norm()).item()
    d_loss, e_gn = abs(fk[0] - f32p[0]), abs(fk[1] - fp[1]) / fp[1]
    ok = (e_k <= STEP_BF16_RATIO * e_p and d_loss <= STEP_BF16_LOSS and
          e_gn <= STEP_F16_GNORM and math.isfinite(fk[1]))
    print(f"  f16: gradients rel L2 vs f32 plain: kernel {e_k:.3e}, plain {e_p:.3e} "
          f"(kernel <= {STEP_BF16_RATIO}x plain); f16 kernel vs f16 plain {e_kp:.3e}; "
          f"loss {fk[0]:.6f} vs f16 plain {fp[0]:.6f} and f32 plain {f32p[0]:.6f} (|diff| "
          f"{d_loss:.2e} <= {STEP_BF16_LOSS:.0e}); grad norm {fk[1]:.6f} vs f16 plain "
          f"{fp[1]:.6f} (rel {e_gn:.2e} <= {STEP_F16_GNORM:.0e}), bf16 {bfk[1]:.6f}, f32 plain "
          f"{f32p[1]:.6f} {'ok' if ok else 'FAIL'}")
    print(f"  K3 dw exactly zero (share of its entries, this step): f16 kernel {z_k}, f16 "
          f"plain {z_p}, bf16 kernel {z_bf}; whole gradient exactly zero: f16 kernel "
          f"{(fk[2] == 0).float().mean().item():.6f}, f16 plain "
          f"{(fp[2] == 0).float().mean().item():.6f}, bf16 kernel "
          f"{(bfk[2] == 0).float().mean().item():.6f}, bf16 plain "
          f"{(bfp[2] == 0).float().mean().item():.6f}")
    if not ok:
        failures.append("f16 train step")
    del fk, fp


RECIPE_STEPS, RECIPE_INTERVAL = 10, 5
# phase 9's text depth: phase 8 trains Llama-3.2-1B at its full 16 layers;
# the recipe's stages around it (four checkpoint writes, the seed, the
# export, three trainers, two of them started by torchrun) run at full
# width and 2 layers, for the script's clock (4 before stage 2 went
# through the launcher)
RECIPE_MAX_LAYERS = 2
# the kernel groups (PROFILE_GROUPS) the recipe run's trace must name
RECIPE_TRACE_GROUPS = ("K1", "K2", "K3 fwd", "K3 bwd, TMA + wgmma mainloop (ce_gemm)")


def bits_checksums(tensors: dict) -> dict:
    """Per tensor of 4-byte elements, two integer checksums of its raw bits,
    computed on the card where there is one (a host tensor is copied there
    first): the sum of
    its 32-bit words, and their
    sum weighted by position mod 65521 plus 1 (a reordering moves the
    second), both mod 2^64."""
    out = {}
    for name, t in tensors.items():
        t = t.detach().to("cuda") if torch.cuda.is_available() else t.detach()
        words = t.reshape(-1).view(torch.int32).to(torch.int64)
        weights = torch.arange(words.numel(), device=words.device) % 65521 + 1
        out[name] = (int(words.sum()), int((words * weights).sum()))
        del words, weights
    return out


def recipe_depth(cfg, free: int) -> tuple:
    """(layers, bytes of one checkpoint, bytes needed) for phase 9:
    RECIPE_MAX_LAYERS when `free` holds three checkpoints (two kept, one
    being written: f32 params, mu and nu), the stage-1 HF seed (bf16), its
    step_0 (f32 params), the stage-3 export (f32) and 2 GiB of shards,
    traces and snapshots, else the most layers that fit, at full width (0
    when none do)."""
    from touchnet_tpu_torch.models.llama.modeling_llama import get_num_params

    c = copy.copy(cfg)
    for layers in range(min(RECIPE_MAX_LAYERS, cfg.num_hidden_layers), 0, -1):
        c.num_hidden_layers = layers
        n = get_num_params(c)
        ckpt = 3 * 4 * n
        need = 3 * ckpt + (2 + 4 + 4) * n + 2**31
        if need <= free:
            return layers, ckpt, need
    return 0, ckpt, need


def tree_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def run_cli(module: str, args: list, failures, what: str) -> float:
    """python -m <module> <args> from the checkout, as the recipe's shell
    runs it; returns its seconds. A non-zero exit is a failure, with the end
    of its output printed."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", module] + [str(a) for a in args], cwd=HERE,
                         capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        print(f"  {what}: python -m {module} exited {res.returncode}:\n"
              f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        failures.append(f"recipe {what}")
    return secs


def run_main(module: str, args: list, failures, what: str) -> float:
    """<module>.main(args) in this process, as python -m <module> <args>
    runs it; returns its seconds. A raise is a failure, with its message
    printed. The recipe phases run the converters so: a subprocess pays
    torch's import again, 20-30 s a call on the card's host (a whole run of
    this script, converters as subprocesses, on an H100's host), and python
    -m runs this same main; make_data, the scoring tools and phase 9's
    torchrun keep their command lines."""
    import importlib

    t0 = time.perf_counter()
    try:
        importlib.import_module(module).main([str(a) for a in args])
    except Exception as e:  # the recipe's stage failed: the script goes on
        print(f"  {what}: {module}.main raised {e!r}")
        failures.append(f"recipe {what}")
    return time.perf_counter() - t0


def recipe_stage0(tmp: Path, failures) -> Path:
    """Stage 0 (run.sh:60-84): jsonl -> shards through make_data, on
    pre-tokenized ids (RawTokenizer at the model's vocab), 4 workers. The
    jsonl holds the seeded documents of write_shards, 120 to a shard, so the
    shards are phase 8's. Checks the ids read back and data.list."""
    from touchnet_tpu_torch.data.dataset import TouchDataset

    docs = seeded_documents(SEED, 4 * 120)
    jsonl = tmp / "train.jsonl"
    with open(jsonl, "w") as f:
        for i, d in enumerate(docs):
            f.write(json.dumps({"key": f"doc{i}", "text": d.tolist()}) + "\n")
    save = tmp / "data"
    secs = run_cli("touchnet_tpu_torch.bin.make_data",
                   ["--save_dir", save, "--jsonl_path", jsonl, "--tokenizer_type",
                    "RawTokenizer", "--tokenizer_raw_vocab_size", 128256,
                    "--num_utt_per_shard", 120, "--num_workers", 4, "--datatypes", "texttoken"],
                   failures, "stage 0")
    listfile = save / "data.list"
    lines = listfile.read_text().splitlines() if listfile.exists() else []
    shards = [ln.split()[0] for ln in lines]
    got = []
    for shard in shards:
        ds = TouchDataset(shard, mmap=False, datatypes="texttoken")
        got += [ds.get(i, "texttoken") for i in range(len(ds))]
    ok = (len(lines) == 4 and all(ln.endswith(" texttoken") for ln in lines)
          and len(got) == len(docs) and all(np.array_equal(a, b) for a, b in zip(got, docs)))
    print(f"  stage 0 (make_data, subprocess, 4 workers): {len(docs)} jsonl documents "
          f"({jsonl.stat().st_size} bytes) -> {len(lines)} shards, {tree_bytes(save)} bytes, "
          f"in {secs:.2f} s; ids read back equal the jsonl's, data.list one line a shard "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recipe stage 0")
    return listfile


def recipe_stage1(cfg, config: Path, exp: Path, tmp: Path, dev, failures) -> dict:
    """Stage 1 (run.sh:86-94): an HF directory of seeded random weights in
    bf16 (as the published checkpoint), written with the port's safetensors
    writer and hf_config_dict, through convert_hf_to_ckpt to
    <exp>/checkpoint/step_0. Returns the checksums of the HF tensors upcast
    to f32, which the run's params at init must equal."""
    from touchnet_tpu_torch.models.llama.convert import hf_config_dict, params_to_hf_state_dict
    from touchnet_tpu_torch.models.llama.modeling_llama import init_params
    from touchnet_tpu_torch.utils.safetensors_io import write_safetensors

    hf = tmp / "hf_seed"
    hf.mkdir()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 2), torch.bfloat16,
                        dev)
    sd = params_to_hf_state_dict(cfg, model.state_dict())
    t0 = time.perf_counter()
    nbytes = write_safetensors(sd, str(hf / "model.safetensors"))
    (hf / "config.json").write_text(json.dumps(hf_config_dict(cfg, "bfloat16"), indent=2))
    write_s = time.perf_counter() - t0
    want = bits_checksums({k: v.float() for k, v in sd.items()})
    del model, sd
    torch.cuda.empty_cache()
    secs = run_main("touchnet_tpu_torch.bin.convert_hf_to_ckpt",
                    ["--ckpt_dir", exp, "--huggingface_model", hf, "--training_model_config_path",
                     config, "--model_type", "causal_lm"], failures, "stage 1")
    seed = exp / "checkpoint" / "step_0"
    print(f"  stage 1: HF seed (random bf16 weights, seed {SEED + 2}) {nbytes} bytes written in "
          f"{write_s:.2f} s; convert_hf_to_ckpt (in-process main) -> step_0, "
          f"{tree_bytes(seed) if seed.exists() else 0} bytes (f32), in {secs:.2f} s")
    return want


def recipe_stage3(cfg, config: Path, exp: Path, final: dict, model, dev, card,
                  failures) -> dict:
    """Stage 3 (run.sh:168-175): convert_ckpt_to_hf --step -1 --config on
    the run's last step. Its tensors, read back with the port's reader,
    must equal `final` (the trained params' checksums) bit for bit, and
    greedy generate (K1, K4) from the export must give the trainer's
    model's tokens, 2 prompts x 16 new tokens. Returns the launches of the
    two generate calls (each a main path)."""
    import torch.nn.functional as F

    from touchnet_tpu_torch.models.llama import inference_llama as inf
    from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
    from touchnet_tpu_torch.models.llama.convert import params_from_hf_state_dict
    from touchnet_tpu_torch.models.llama.modeling_llama import empty_model
    from touchnet_tpu_torch.ops.attention import flash_attention
    from touchnet_tpu_torch.ops.decode_attention import decode_attention
    from touchnet_tpu_torch.utils.safetensors_io import read_safetensors

    secs = run_main("touchnet_tpu_torch.bin.convert_ckpt_to_hf",
                    ["--ckpt_dir", exp, "--step", -1, "--config", config,
                     "--model_type", "causal_lm"], failures, "stage 3")
    out = exp / "checkpoint_hf" / f"step-{RECIPE_STEPS}"
    t0 = time.perf_counter()
    tensors = read_safetensors(str(out / "model.safetensors"))
    read_s = time.perf_counter() - t0
    bits = bits_checksums(tensors)
    differ = sorted(k for k in final if bits.get(k) != final[k]) + sorted(set(bits) - set(final))
    exported = LlamaConfig.from_json_file(str(out / "config.json"))
    ok = not differ and exported.rope_scaling == cfg.rope_scaling and \
        exported.to_dict() == {**cfg.to_dict(), "attn_implementation": "flash"}
    print(f"  stage 3: convert_ckpt_to_hf --step -1 --config (in-process main) -> {out.name}, "
          f"{tree_bytes(out)} bytes, in {secs:.2f} s (read back in {read_s:.2f} s); its "
          f"{len(bits)} tensors equal the final params bit for bit: {not differ} "
          f"(differ in {differ[:5] or 'none'}); config.json round-trips with rope_scaling "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recipe stage 3: export")
    hf_model = empty_model(exported, torch.float32, dev)
    hf_model.load_state_dict(params_from_hf_state_dict(exported, tensors))
    del tensors
    rng = np.random.default_rng(SEED + 3)
    lens = torch.from_numpy(rng.integers(256, 1025, 2)).to(dev)
    ids = torch.from_numpy(rng.integers(0, DOC_RANGE, (2, int(lens.max())))).to(dev)
    gen = {}
    flash_attention.launches = decode_attention.launches = 0
    with torch.no_grad():
        for name, m in (("export", hf_model), ("trainer", model)):
            emb = F.embedding(ids, m.model.embed_tokens.weight)
            gen[name] = inf.generate(m, exported, emb, lens, 16, eos_id=128001,
                                     compute_dtype=torch.bfloat16)
    counts = {"K1": flash_attention.launches, "K4": decode_attention.launches}
    L = cfg.num_hidden_layers
    same = torch.equal(gen["export"], gen["trainer"])
    ok = same and counts["K1"] == 2 * L and 0 < counts["K4"] <= 2 * 16 * L
    print(f"  stage 3: greedy generate from the export and from the trainer's model, prompts "
          f"{lens.tolist()}, 16 new tokens: equal {same}; tokens {gen['export'].tolist()}; "
          f"launches K1={counts['K1']} K4={counts['K4']} {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("recipe stage 3: generate")
    del hf_model
    torch.cuda.empty_cache()
    return counts


# the fineweb-edu recipe's stage-2 layout flags (run.sh:118-125), cut to one
# card: dp_shard -1 fills the world (1), loss parallel does nothing at tp 1
RECIPE_LAYOUT = dict(training_fsdp_reshard_after_forward="default",
                     training_context_parallel_degree=1,
                     training_context_parallel_rotate_method="allgather",
                     training_tensor_parallel_degree=1, training_data_parallel_shard_degree=-1,
                     training_enable_loss_parallel="true", training_pipeline_parallel_degree=1,
                     training_pipeline_parallel_schedule="1F1B", training_tb_rank_0_only="true",
                     training_print_args="true")
# the in-process run beside the launcher's: its first steps, no checkpoints;
# their losses bit-equal (FSDP2's root unit holds f32 parameters, so the tied
# embedding's two gradients add up in f32 on both paths)
INPROC_STEPS = 3


def torchrun_train(argv: list, exp: Path, failures, what: str, nproc: int = 1,
                   timeout: int = 900, env=None) -> tuple:
    """torchrun --standalone --nproc_per_node N -m touchnet_tpu_torch.bin.train
    <argv> from the checkout (python -m torch.distributed.run is torchrun).
    Returns (each rank's train_summary_rank<R>.json, or None when it failed;
    the command's seconds)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), "-m", "touchnet_tpu_torch.bin.train"] + [str(a) for a in argv]
    free_caches()
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=timeout,
                         env=env)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        print(f"  {what}: torchrun exited {res.returncode}:\n{res.stdout[-4000:]}\n"
              f"{res.stderr[-4000:]}")
        failures.append(f"{what}: torchrun")
        return None, secs
    return [json.loads((exp / f"train_summary_rank{r}.json").read_text())
            for r in range(nproc)], secs


def ckpt_checksums(step_dir: Path) -> dict:
    """bits_checksums of every tensor of a checkpoint step (model, then
    optimizer, keyed as the trainer's state: the model's names, mu.<name>,
    nu.<name>, count), read back in one process."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    out = {}
    for part in ("model", "optimizer"):
        reader = FileSystemReader(str(step_dir / part))
        md = reader.read_metadata().state_dict_metadata
        state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in md.items()}
        dcp.load(state, storage_reader=reader, no_dist=True)
        out.update(bits_checksums(state))
        del state
    return out


def load_model(cfg, step_dir: Path, dev):
    """The model of a checkpoint step on the card, in f32."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    from touchnet_tpu_torch.models.llama.modeling_llama import empty_model

    model = empty_model(cfg, torch.float32, dev)
    state = model.state_dict()
    dcp.load(state, storage_reader=FileSystemReader(str(step_dir / "model")), no_dist=True)
    return model


def inprocess_run(train, argv, seed_dir: Path, seed_bits: dict, failures) -> dict:
    """The same configuration without the launcher: a Trainer in this
    process (no process group, no FSDP) from the stage-1 seed, the first
    INPROC_STEPS steps of the same schedule and data, no checkpoints.
    Checks that its params at init equal the HF tensors upcast."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    from touchnet_tpu_torch.bin import TrainConfig
    from touchnet_tpu_torch.data import DataConfig
    from touchnet_tpu_torch.tokenizer import TokenizerConfig

    tok, data, job = train.parse_args_into_dataclasses(
        [TokenizerConfig, DataConfig, TrainConfig], [str(a) for a in argv])
    trainer = train.Trainer(tok, data, job)
    try:
        state = trainer.model.state_dict()
        dcp.load(state, storage_reader=FileSystemReader(str(seed_dir / "model")), no_dist=True)
        init = bits_checksums(trainer.model.state_dict())
        seeded = init == seed_bits
        print(f"  in-process run starts from step_0: its params ({len(init)} tensors) equal the HF "
              f"tensors upcast to f32 bit for bit: {seeded} {'ok' if seeded else 'FAIL'}")
        if not seeded:
            failures.append("recipe stage 2: not started from the seed")
        # the loop's length only: the schedule was built for the run's steps
        trainer.job_config.lr_scheduler_steps = INPROC_STEPS
        torch.cuda.reset_peak_memory_stats()
        trainer.train()
    finally:
        trainer.close()
    hist = trainer.metrics_processor.history
    del trainer
    free_caches()
    return hist


# --two-ranks: two ranks of Llama-3.2-1B at full width on the one card, over
# gloo (which takes CUDA tensors for FSDP2's collectives, not for
# point-to-point: the ring stages through the host; NCCL takes one rank a
# card), each layout from the same seeded weights and data: name ->
# (dataset_text_seqlen, steps, flags). dp_shard 2 gives each rank its own
# rows (num_sentence summed over dp) with a sync checkpoint after each step
# and a dev pass after each save; its resumed run loads step 1 from a copy
# of its checkpoint folder (hard links) and runs step 2. The cp layouts split
# 1 x 8192 into 4096 a rank; cp 2 allgather runs FSDP2 over the flattened
# dp_shard x cp mesh of both ranks; each runs its first step alone (cut from
# 2 for the script's clock, the allgather's to make room for pp 2: step 1 is
# what is compared).
# pp 2 holds one layer a stage, 2 x 4096 rows split into 2 microbatches
# under 1F1B (the pretraining recipes' schedule); the full-logits loss on
# the last stage (no K3 under pp, as in JAX), the tied embedding's two
# gradients summed over pp in f32.
TWO_RANK_LAYERS, TWO_RANK_STEPS, TWO_RANK_T = 2, 2, 4096
TWO_RANK_CKPT = dict(training_enable_ckpt="true", training_ckpt_interval=1,
                     training_ckpt_keep_latest_k=2, training_ckpt_async_mode="disabled")
TWO_RANK_RESUME = 1
TWO_RANK_LAYOUTS = {
    "tp 2": (TWO_RANK_T, TWO_RANK_STEPS, dict(training_tensor_parallel_degree=2,
                                              training_data_parallel_shard_degree=1)),
    "dp_shard 2": (TWO_RANK_T, TWO_RANK_STEPS, dict(training_data_parallel_shard_degree=2,
                                                    **TWO_RANK_CKPT)),
    "dp_shard 2 resumed": (TWO_RANK_T, TWO_RANK_STEPS, dict(
        training_data_parallel_shard_degree=2, training_ckpt_load_step=TWO_RANK_RESUME,
        **TWO_RANK_CKPT)),
    "cp 2 allgather": (2 * TWO_RANK_T, 1, dict(
        training_context_parallel_degree=2, training_data_parallel_shard_degree=1,
        training_context_parallel_rotate_method="allgather")),
    "cp 2 alltoall": (2 * TWO_RANK_T, 1, dict(
        training_context_parallel_degree=2, training_data_parallel_shard_degree=1,
        training_context_parallel_rotate_method="alltoall")),
    "pp 2": (TWO_RANK_T, TWO_RANK_STEPS, dict(
        training_pipeline_parallel_degree=2, training_data_parallel_shard_degree=1,
        training_pipeline_parallel_schedule="1F1B", training_pipeline_parallel_microbatches=2,
        dataset_batchsize=2)),
}
# the layouts that run K3 (under pp the last stage computes the full-logits
# loss, as JAX's trainer does: K3 must launch on neither rank there)
NO_K3 = ("pp 2",)
# the cp layouts' step 1 against one process on the whole 1 x 8192 row (the
# same weights and data), relative: loss/per_sample and grad_norm differ only
# by the bf16 rounding of the attention's outputs and gradients in another
# order. On an H100 80GB HBM3 at 700 W (PERF.md) the loss read 0
# (allgather) and 1.0e-6 (alltoall), the grad norm 1.6e-5 (both); each
# limit a few times its reading
CP_LOSS_RTOL, CP_GRAD_NORM_RTOL = 5e-6, 1e-4
# pp 2's step 1 against one process on the same 2 x 4096 rows with the same
# full-logits loss (liger off): the microbatches of 1 x 4096 against one
# pass over both rows, and the f32 sum over pp of the tied embedding's two
# gradients, differ by bf16 rounding alone. On an H100 80GB HBM3 at 700 W
# (PERF.md) the loss read 7.8e-8 and the grad norm 3.7e-6; each limit a few
# times its reading
PP_LOSS_RTOL, PP_GRAD_NORM_RTOL = 5e-7, 2e-5
# the dev list of dp_shard 2 (a shard a rank): its forward under FSDP2
# gathers every weight through gloo's host staging, ~2 s a batch, so the
# list is kept to a few documents (20 a shard cost ~18 s a dev pass)
TWO_RANK_DEV_DOCS = 4


def gloo_rank_worker(argv: list) -> int:
    """One rank of --two-ranks (its own process): a gloo process group over
    a FileStore, then bin.train.main on cuda:0 for each run of the JSON
    list at argv[2], in order (the trainer keeps a group its caller
    started), each with the kernels' counts and the peak memory reset
    before it (its train_summary_rank<R>.json holds its own launches). A
    run is {"argv": [...], "link": [src, dst] or null, "state": path or
    null}: rank 0 first hard-links the folder src as dst; with "state" each
    rank writes bits_checksums of its shards of the final params, mu, nu
    and count to the path (its {rank} filled in)."""
    import torch.distributed as dist

    rank, store = int(argv[0]), argv[1]
    runs = json.loads(Path(argv[2]).read_text())
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    sys.path.insert(0, str(HERE))
    from touchnet_tpu_torch.bin import train

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    try:
        for run in runs:
            if run["link"] and rank == 0:
                shutil.copytree(run["link"][0], run["link"][1], copy_function=os.link)
            dist.barrier()
            for counter in kernel_counters().values():
                counter.launches = 0
            torch.cuda.reset_peak_memory_stats()
            trainer = train.main(run["argv"], device=torch.device("cuda", 0))
            if run["state"]:
                state = {**trainer._model_state(), **trainer._opt_state()}
                local = {k: v.to_local() if hasattr(v, "to_local") else v
                         for k, v in state.items()}
                Path(run["state"].format(rank=rank)).write_text(json.dumps(bits_checksums(local)))
                del state, local
            del trainer
            free_caches()
    finally:
        dist.destroy_process_group()
    return 0


def world_one_reference(train, listfile, tmp: Path, config, vocab, seqlen: int,
                        name: str, **extra) -> list:
    """A layout's batch (1 x 8192 for cp, 2 x 4096 for pp with ``extra``'s
    flags) in this process at world 1 (no process group, no FSDP), the same
    weights, data and flags: its history."""
    argv = train_argv(listfile, tmp / name, seqlen, TWO_RANK_STEPS, "bfloat16", vocab,
                      training_model_config_path=config, **extra)
    trainer = train.main([str(a) for a in argv])
    hist = trainer.metrics_processor.history
    del trainer
    free_caches()
    return hist


def run_two_ranks(card, failures, tmp: Path) -> dict:
    """Phase 16: the layouts of TWO_RANK_LAYOUTS, one after another in one
    pair of processes on the card (a process's start and its group's set-up
    paid once): for each, losses finite and equal on both ranks, K1, K2 and
    K3 launched on each (pp 2: K3 on neither), the step times and peak
    memory (max over ranks) printed. dp_shard 2: saves and dev lines at steps 1 and 2; its resumed
    run's step-2 loss, grad norm and dev line, and each rank's shards of the
    final params, mu, nu and count, equal the straight run's bit for bit.
    The cp layouts' step-1 loss and grad norm within CP_LOSS_RTOL and
    CP_GRAD_NORM_RTOL of one process on the same 1 x 8192 batch
    (world_one_reference, run first), and of each other; pp 2's within
    PP_LOSS_RTOL and PP_GRAD_NORM_RTOL of one process on its 2 x 4096 rows
    with the full-logits loss. Returns the launches
    of every rank of every layout (each run counts its own, from zero)."""
    from touchnet_tpu_torch.bin import train
    from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig

    raw = json.loads(CONFIG.read_text())
    raw["num_hidden_layers"] = TWO_RANK_LAYERS
    config = tmp / "config.json"
    config.write_text(json.dumps(raw))
    cfg = LlamaConfig.from_json_file(str(config))
    listfile = write_shards(tmp / "data", cfg.vocab_size, SEED)
    devlist = write_shards(tmp / "dev", cfg.vocab_size, SEED + 1, shards=2,
                           docs=TWO_RANK_DEV_DOCS)
    print(f"[16] two ranks: Llama-3.2-1B at full width and {TWO_RANK_LAYERS} layers, "
          f"{TWO_RANK_STEPS} steps a layout (the cp layouts 1), two processes on one card over "
          "gloo; one process on the cp and pp layouts' batches first")
    refs = {}
    for name, seqlen, extra in (
            ("cp", 2 * TWO_RANK_T, {}),
            ("pp", TWO_RANK_T, dict(dataset_batchsize=2, training_enable_liger_kernel="false"))):
        t0 = time.perf_counter()
        refs[name] = one = world_one_reference(train, listfile, tmp, config, cfg.vocab_size,
                                               seqlen, f"world1_{name}", **extra)
        print(f"  one process (world 1, no FSDP), the {name} layouts' "
              f"{extra.get('dataset_batchsize', 1)}x{seqlen}"
              f"{' (full-logits loss)' if extra else ''}: losses "
              f"{[h['loss/per_sample'] for h in one]}, grad norms "
              f"{[h['grad_norm'] for h in one]}; {time.perf_counter() - t0:.1f} s")
    counts = {k: 0 for k in ("K1", "K2", "K3 fwd", "K3 bwd")}
    exps = {name: tmp / name.replace(" ", "_") for name in TWO_RANK_LAYOUTS}
    straight, resumed = exps["dp_shard 2"], exps["dp_shard 2 resumed"]
    step_dir = f"checkpoint/step_{TWO_RANK_RESUME}"
    runs = []
    for name, (seqlen, steps, layout) in TWO_RANK_LAYOUTS.items():
        extra = dict(datalist_dev_path=devlist) if "dp_shard" in name else {}
        runs.append({
            "argv": [str(a) for a in train_argv(
                listfile, exps[name], seqlen, steps, "bfloat16", cfg.vocab_size,
                training_model_config_path=config, **layout, **extra)],
            "link": [str(straight / step_dir), str(resumed / step_dir)]
            if exps[name] == resumed else None,
            "state": str(exps[name] / "state_rank{rank}.json") if "dp_shard" in name else None})
    (tmp / "runs.json").write_text(json.dumps(runs))
    free_caches()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--gloo-rank",
                               str(r), str(tmp / "store"), str(tmp / "runs.json")], cwd=HERE,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    print(f"  both processes: {time.perf_counter() - t0:.1f} s for the "
          f"{len(TWO_RANK_LAYOUTS)} runs, exit codes {[p.returncode for p in procs]}")
    if any(p.returncode for p in procs):
        print("\n".join(o[-3000:] for o in outs))
    sums = {}
    for name, (seqlen, steps, layout) in TWO_RANK_LAYOUTS.items():
        paths = [exps[name] / f"train_summary_rank{r}.json" for r in range(2)]
        if not all(p.exists() for p in paths):
            print(f"  {name}: no summary from {[str(p) for p in paths if not p.exists()]} FAIL")
            failures.append(f"two ranks {name}")
            continue
        sums[name] = both = [json.loads(p.read_text()) for p in paths]
        for sm in both:
            for k in counts:
                counts[k] += sm["launches"][k]
        losses = [[h["loss/per_sample"] for h in s["history"]] for s in both]
        first = TWO_RANK_RESUME + 1 if exps[name] == resumed else 1
        launched = all(all(s["launches"][k] > 0 for k in ("K1", "K2")) and
                       all((s["launches"][k] > 0) != (name in NO_K3)
                           for k in ("K3 fwd", "K3 bwd")) for s in both)
        ok = (losses[0] == losses[1] and all(math.isfinite(x) for x in losses[0]) and launched
              and [h["step"] for h in both[0]["history"]] == list(range(first, steps + 1)))
        hist = both[0]["history"]
        print(f"  {name} ({layout.get('dataset_batchsize', 1)}x{seqlen}): steps "
              f"{[h['step'] for h in hist]}, losses {losses[0]} on "
              f"both ranks: {losses[0] == losses[1]}; launches "
              f"rank 0 {both[0]['launches']}, rank 1 {both[1]['launches']}; step ms "
              f"{[round(h['time/step_s'] * 1e3, 1) for h in hist]}; peak "
              f"{max(h.get('memory/peak_gib', 0) for h in hist):.2f} GiB (max over ranks) "
              f"{'ok' if ok else 'FAIL'}  [{card}]")
        if not ok:
            failures.append(f"two ranks {name}")
    if {"dp_shard 2", "dp_shard 2 resumed"} <= set(sums):
        check_sharded_resume(sums["dp_shard 2"], sums["dp_shard 2 resumed"], straight, resumed,
                             card, failures)
    cp = {n: sums[n][0]["history"][0] for n in ("cp 2 allgather", "cp 2 alltoall") if n in sums}
    for key, rtol in (("loss/per_sample", CP_LOSS_RTOL), ("grad_norm", CP_GRAD_NORM_RTOL)):
        want = refs["cp"][0][key]
        rels = {n: abs(h[key] - want) / abs(want) for n, h in cp.items()}
        if len(cp) == 2:
            a, b = (h[key] for h in cp.values())
            rels["allgather vs alltoall"] = abs(a - b) / abs(a)
        ok = len(cp) == 2 and all(r <= rtol for r in rels.values())
        print(f"  cp 2 step 1 {key}: one process {want!r}, " +
              ", ".join(f"{n} {h[key]!r}" for n, h in cp.items()) + "; relative " +
              ", ".join(f"{n} {r:.3e}" for n, r in rels.items()) +
              f" (<= {rtol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"two ranks: the cp layouts' step-1 {key}")
    for key, rtol in (("loss/per_sample", PP_LOSS_RTOL), ("grad_norm", PP_GRAD_NORM_RTOL)):
        want = refs["pp"][0][key]
        got = sums["pp 2"][0]["history"][0][key] if "pp 2" in sums else float("nan")
        rel = abs(got - want) / abs(want)
        ok = rel <= rtol
        print(f"  pp 2 step 1 {key}: one process {want!r}, pp 2 {got!r}; relative {rel:.3e} "
              f"(<= {rtol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"two ranks: pp 2's step-1 {key}")
    return counts


def check_sharded_resume(straight, resumed, straight_exp: Path, resumed_exp: Path, card,
                         failures) -> None:
    """dp_shard 2's saves (steps 1 and 2, sync) and dev lines (after each),
    and its resumed run (step 2 from the saved step 1) against it bit for
    bit: the step's loss and grad norm, the dev line, and each rank's shards
    of the final params, mu, nu and count."""
    dev = straight[0]["dev_history"]
    saves = sorted(int(k) for k in straight[0]["checkpoint_times"])
    ok = (saves == [1, TWO_RANK_STEPS] and [d["step"] for d in dev] == [1, TWO_RANK_STEPS]
          and all(math.isfinite(v) for d in dev for v in d.values())
          and all(s["dev_history"] == dev for s in straight))
    print(f"  dp_shard 2: sync saves at steps {saves} (the loop blocked " + ", ".join(
        f"{t['blocked_ms']:.1f} ms" for _, t in sorted(straight[0]["checkpoint_times"].items()))
        + "); dev lines " + "; ".join(
            f"step {d['step']} loss {d['loss_per_sample']:.4f} acc {d['acc']:.4f}" for d in dev)
        + f", equal on both ranks {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("two ranks: dp_shard 2 saves and dev lines")
    last = {k: straight[0]["history"][-1][k] for k in ("loss/per_sample", "grad_norm")}
    again = {k: resumed[0]["history"][-1][k] for k in last}
    states = [[json.loads((exp / f"state_rank{r}.json").read_text()) for r in range(2)]
              for exp in (straight_exp, resumed_exp)]
    differ = [f"rank {r} {k}" for r in range(2) for k in sorted(states[0][r])
              if states[0][r][k] != states[1][r].get(k)]
    differ += [f"rank {r} {k}" for r in range(2) for k in sorted(set(states[1][r]) -
                                                                 set(states[0][r]))]
    same_dev = resumed[0]["dev_history"] == dev[-1:]
    ok = again == last and not differ and same_dev
    print(f"  dp_shard 2 resumed from step {TWO_RANK_RESUME} (its checkpoint's shards read by "
          f"both ranks): step {TWO_RANK_STEPS} loss and grad norm {again} vs {last}: equal "
          f"{again == last}; dev line equal: {same_dev}; each rank's shards of the final params, "
          f"mu, nu, count ({len(states[0][0])} tensors a rank, checksums of their bits) differ "
          f"in {differ[:5] or 'none'} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("two ranks: dp_shard 2 resume not bit-equal")


def run_recipe(dev, card, failures, tmp: Path) -> dict:
    """Phase 9: the recipe's stages 0-3 at full width: make_data, the HF
    seed through convert_hf_to_ckpt, a short in-process run from that seed,
    then stage 2 as torchrun --standalone --nproc_per_node 1 -m
    touchnet_tpu_torch.bin.train (world 1: FSDP2 over NCCL, the recipe's
    layout flags) with checkpoints, dev eval, profiling and memory
    snapshots, its first losses held to the in-process run's, and the
    export through convert_ckpt_to_hf with generate from it. Returns the
    kernels' launches over its main paths (the launcher's run, read from
    its train_summary_rank0.json, and the generate)."""
    from touchnet_tpu_torch.bin import train
    from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig

    print("[9] the recipe's stages 0-3 on one card (run.sh:60-175, dp 1): make_data, the HF "
          "seed, an in-process run, bin.train through torchrun (FSDP2 at world 1) with "
          "checkpoints, dev eval, profiling and memory snapshots, the HF export")
    cfg = LlamaConfig.from_json_file(str(CONFIG))
    free = shutil.disk_usage(tmp).free
    L, ckpt_bytes, need = recipe_depth(cfg, free)
    config = CONFIG
    depth = (f"CUT to {L} of {cfg.num_hidden_layers} layers at full width ("
             + ("phase 8 trains the full depth; the script's clock)" if L == RECIPE_MAX_LAYERS
                else "too little room)"))
    print(f"  temp dir: {free / 1e9:.2f} GB free; a checkpoint ~{ckpt_bytes / 1e9:.2f} GB, "
          f"{need / 1e9:.2f} GB needed with the seed, step_0 and the export: {depth}")
    if L == 0:
        failures.append("recipe run: no room for its checkpoints")
        return {}
    if L != cfg.num_hidden_layers:
        raw = json.loads(CONFIG.read_text())
        raw["num_hidden_layers"] = L
        config = tmp / "config.json"
        config.write_text(json.dumps(raw))
        cfg = LlamaConfig.from_json_file(str(config))
    exp = tmp / "exp"
    listfile = recipe_stage0(tmp, failures)
    seed_bits = recipe_stage1(cfg, config, exp, tmp, dev, failures)
    devlist = write_shards(tmp / "dev", cfg.vocab_size, SEED + 1, shards=2, docs=20)
    flags = dict(training_model_config_path=config, datalist_dev_path=devlist,
                 training_enable_ckpt="true", training_ckpt_load_step=-1,
                 training_ckpt_interval=RECIPE_INTERVAL, training_ckpt_keep_latest_k=2,
                 training_ckpt_async_mode="async", training_enable_profiling="true",
                 training_profiling_freq=5, training_profiling_keep_first_k=1,
                 training_enable_memory_snapshot="true", training_enable_tensorboard="true",
                 training_gc_freq=1000, training_deterministic="false", **RECIPE_LAYOUT)

    inproc = inprocess_run(train, train_argv(
        listfile, tmp / "inproc", TRAIN_T, RECIPE_STEPS, "bfloat16", cfg.vocab_size,
        training_model_config_path=config, **RECIPE_LAYOUT), exp / "checkpoint" / "step_0",
        seed_bits, failures)
    peak0 = torch.cuda.max_memory_allocated() / 2**30

    print(f"  {RECIPE_STEPS} steps at 1x{TRAIN_T}, remat op_small, checkpoints every "
          f"{RECIPE_INTERVAL} (keep 2, async), dev list of 2 seeded shards, profiling freq 5 "
          "keep 1, memory snapshots, tensorboard (a warning where the package is missing), "
          "from the stage-1 seed, through torchrun --standalone --nproc_per_node 1 -m "
          "touchnet_tpu_torch.bin.train")
    argv1 = train_argv(listfile, exp, TRAIN_T, RECIPE_STEPS, "bfloat16", cfg.vocab_size, **flags)
    sums1, secs1 = torchrun_train(argv1, exp, failures, "recipe run 1")
    if sums1 is None:
        return {}
    ckpt = exp / "checkpoint"
    state1 = ckpt_checksums(ckpt / f"step_{RECIPE_STEPS}")
    run1 = sums1[0]
    hist1, dev1 = run1["history"], run1["dev_history"]
    print(f"  torchrun command: {secs1:.1f} s (with the launcher's start, the process group, "
          "FSDP2's wrap and the model's build)")

    losses1 = [h["loss/per_sample"] for h in hist1]
    lin = [h["loss/per_sample"] for h in inproc]
    same = lin == losses1[:INPROC_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lin, losses1))
    ok = len(lin) == INPROC_STEPS and same
    print(f"  in-process (one process, no FSDP) vs torchrun (FSDP2, world 1), steps 1-"
          f"{INPROC_STEPS}: losses {lin} vs {losses1[:INPROC_STEPS]}: bit-equal {same} "
          f"(largest relative difference {rel:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recipe run: launcher losses")
    print(f"  step ms: in-process {[round(h['time/step_s'] * 1e3, 1) for h in inproc]}; "
          f"torchrun {[round(h['time/step_s'] * 1e3, 1) for h in hist1[:INPROC_STEPS]]}; peak "
          f"GiB allocated: in-process {peak0:.2f}, torchrun run 1 "
          f"{max(h.get('memory/peak_gib', 0) for h in hist1):.2f} (memory history recording on)"
          f"  [{card}]")

    async_ms = {int(k): v for k, v in run1["checkpoint_times"].items()}
    kept = {p.name for p in ckpt.iterdir() if p.name.startswith("step_")}
    ok = (sorted(async_ms) == [1, RECIPE_INTERVAL, RECIPE_STEPS] and len(losses1) == RECIPE_STEPS
          and all(math.isfinite(x) for x in losses1) and kept == {"step_5", "step_10"})
    print(f"  run 1: losses {[round(x, 4) for x in losses1]}; saves at steps {sorted(async_ms)}, "
          f"kept {sorted(kept)} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recipe run: saves")
    ok = [d["step"] for d in dev1] == [1, RECIPE_INTERVAL, RECIPE_STEPS] and \
        all(math.isfinite(v) for d in dev1 for v in d.values())
    print("  dev lines: " + "; ".join(
        f"step {d['step']} loss {d['loss_per_sample']:.4f}/{d['loss_per_token']:.4f} "
        f"acc {d['acc']:.4f}" for d in dev1) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recipe run: dev lines")
    files = [f for f in (ckpt / "step_10").rglob("*") if f.is_file()]
    size = sum(f.stat().st_size for f in files)
    print(f"  checkpoint step_10: {size} bytes ({size / 1e9:.3f} GB) in {len(files)} files")

    def blocked(times):
        return ", ".join(f"step {s} {t['blocked_ms']:.1f} ms ({t['waited_ms']:.1f} waiting for "
                         "the previous write)" for s, t in sorted(times.items()))

    print(f"  the loop blocked in save(): async {blocked(async_ms)}. Step 1 also allocates "
          f"the pinned staging buffers  [{card}]")
    print("  each write to disk (a background thread): " + ", ".join(
        f"step {s} {t['write_s']:.2f} s ({size / t['write_s'] / 1e9:.2f} GB/s)"
        for s, t in sorted(async_ms.items())))
    print(f"  step times of run 1, ms (each includes the save, trace and dev pass after the "
          f"step before it): {[round(h['time/step_s'] * 1e3, 1) for h in hist1]}")

    trace = exp / "profile_traces" / f"iteration_{RECIPE_INTERVAL}" / "trace.json"
    traces = sorted(p.name for p in (exp / "profile_traces").iterdir())
    with open(trace) as f:
        kernels = {e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
    named = {profile_group(n) for n in kernels}
    missing = [g for g in RECIPE_TRACE_GROUPS if g not in named]
    ok = traces == [f"iteration_{RECIPE_INTERVAL}"] and not missing
    print(f"  profiler traces {traces}: {len(kernels)} kernel names, groups "
          f"{sorted(named)}; missing {missing or 'none'} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recipe run: trace")
    snaps = sorted((exp / "memory_snapshot").glob("*.pickle"))
    ok = [p.name for p in snaps] == ["step_10.pickle", "step_5.pickle"]
    print("  memory snapshots: " + ", ".join(f"{p.name} {p.stat().st_size} bytes" for p in snaps) +
          f" {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recipe run: memory snapshots")

    k1, k2, k3f, k3b = (run1["launches"][k] for k in ("K1", "K2", "K3 fwd", "K3 bwd"))
    steps = RECIPE_STEPS
    dev_fwd = k3f - steps  # each dev batch runs K3's forward once and K1 L times
    ok = k2 == L * steps and k3b == steps and dev_fwd > 0 and k1 == L * (steps + dev_fwd)
    print(f"  launches of the torchrun run ({steps} steps, {dev_fwd} dev batches over 3 dev "
          f"passes; the process counts its own): K1={k1} K2={k2} K3 fwd={k3f} "
          f"K3 bwd={k3b} (want K1 = {L}x(steps + dev batches), K2 = {L}x steps, K3 bwd = steps; "
          f"no backward kernel in dev) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recipe run: launch counts")
    final_model = load_model(cfg, ckpt / f"step_{RECIPE_STEPS}", dev)
    final = {k: state1[k] for k in final_model.state_dict()}
    gen_counts = recipe_stage3(cfg, config, exp, final, final_model, dev, card, failures)
    del final_model
    torch.cuda.empty_cache()
    return {"K1": k1 + gen_counts["K1"], "K2": k2, "K3 fwd": k3f, "K3 bwd": k3b,
            "K4": gen_counts["K4"]}


# -- phase 10: the audio pretraining recipe (examples/audio/pretrain/wenetspeech/run.sh) --

AUDIO_CONFIG = HERE / "examples/audio/pretrain/wenetspeech/config/Touch-Audio-1B.json"
ASR_CONFIG = HERE / "examples/audio/sft/asr/wenetspeech/config/Touch-Audio-7B.json"
SR = 16000
AUDIO_T, AUDIO_STEPS, AUDIO_INTERVAL, AUDIO_RESUME = 8192, 10, 5, 5
# seconds of audio in one 1x8192 row: 8192 frames x stride 4 x 10 ms
ROW_SECONDS = AUDIO_T * 4 * 10 / 1000
AUDIO_WORKERS = 12  # the recipe's num_workers (run.sh:22)
# the loader's queue depth a worker: the recipe's prefetch 12 (run.sh:23) is
# cut for the script's time: 12 x 12 queued batches cost a run's first step
# ~70 s of loader fill on threads that take the GIL from the launch thread
# (12 x 2: ~23 s), and the queue depth changes no batch, so no check reads it
AUDIO_PREFETCH = 1
# phase 10's text depth: Touch-Audio-1B's 16 layers cut for the script's
# clock (its checkpoints, their load and the export shrink with it): 8 at
# first, 4 since the float16 cases and phase 17 took their seconds
AUDIO_MAX_LAYERS = 4
# the steps of phase 10's two runs that measure what holds its step back
# (cut from AUDIO_STEPS for the script's clock: the medians of steps 3-6)
LOADER_STEPS = 6


def synth_speech(rng, n: int) -> np.ndarray:
    """n samples of 16 kHz int16 speech-like signal: voiced tones
    (harmonics 1-5 of a pitch drifting +-30 % around 90-220 Hz, with a
    syllable-rate envelope) plus noise, drawn from `rng`."""
    t = np.arange(n, dtype=np.float32) / SR
    f0 = rng.uniform(90, 220) * (1 + 0.3 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t
                                                  + rng.uniform(0, 6)))
    phase = (2 * np.pi / SR) * np.cumsum(f0, dtype=np.float64)
    x = sum(np.sin(k * phase) / k for k in range(1, 6)) * 0.25
    x *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * rng.uniform(1, 4) * t))
    x += 0.01 * rng.standard_normal(n)
    return np.clip(x * 20000, -32768, 32767).astype(np.int16)


# phase 17: a batch of each recipe's features; the tolerances are the CPU
# tests' (tests/touchnet_tpu/ops/test_frontend.py): fbank 2e-3 (the log of
# a power spectrum from an f32 FFT, where a bin's power is small), log-mel
# and the LFR stack 2e-4
FRONTEND_ROWS, FRONTEND_FBANK_TOL, FRONTEND_LOGMEL_TOL = 16, 2e-3, 2e-4


def check_frontend(dev, card, failures) -> None:
    """Phase 17: ops/frontend.py on the card against the host path (the
    loaders' map functions of data/functions.py: the native frontend, then
    audiofeat_stack), each recipe's features on FRONTEND_ROWS rows of
    seeded speech: (a) the SFT recipe's log-mel, 128 bins, n_fft 400, hop
    160 (examples/audio/sft/asr/wenetspeech/run.sh:98-101) on rows of 1-30 s
    zero-padded to 30 s as whisper features are, log_mel_spectrogram; (b)
    BEST-RQ's fbank, 80 bins, stack 5, stride 4, normalised
    (examples/audio/pretrain/wenetspeech/run.sh:73-78, phase 10's flags) on
    rows of 15 s, device_frontend from a numpy batch (which it puts on the
    card). Each within its tolerance; ms a batch on the card (the batch on
    the card; its copy from the host apart) beside the host path's seconds
    on one thread."""
    from touchnet_tpu_torch.data import DataConfig, functions
    from touchnet_tpu_torch.ops import frontend

    print("[17] ops/frontend on the card vs the host path (data/functions, native frontend)")
    rng = np.random.default_rng(SEED + 17)
    B = FRONTEND_ROWS
    logmel = np.zeros((B, 30 * SR), np.float32)
    for b in range(B):
        x = synth_speech(rng, int(rng.uniform(1.0, 30.0) * SR))
        logmel[b, :len(x)] = x / 32768.0
    fbank = np.stack([synth_speech(rng, 15 * SR) for _ in range(B)]).astype(np.float32) / 32768.0
    cases = (
        ("(a) SFT log-mel 128 over 30 s rows",
         DataConfig(audio_feat_type="log_mel_spectrogram", audiofeat_num_mel_bins=128,
                    audiofeat_n_fft=400, audiofeat_hop_length=160), logmel,
         FRONTEND_LOGMEL_TOL,
         lambda wav, cfg: frontend.log_mel_spectrogram(
             wav, cfg.audio_resample_rate, cfg.audiofeat_n_fft, cfg.audiofeat_hop_length,
             cfg.audiofeat_num_mel_bins),
         lambda rows, cfg: functions.audio_compute_log_mel_spectrogram(rows, cfg)),
        ("(b) BEST-RQ fbank 80, stack 5 stride 4, 15 s rows",
         DataConfig(audio_feat_type="fbank", audiofeat_num_mel_bins=80, audiofeat_dither=0.0,
                    audiofeat_stack_length=5, audiofeat_stride_length=4,
                    audiofeat_normalize=True), fbank, FRONTEND_FBANK_TOL,
         frontend.device_frontend,
         lambda rows, cfg: functions.audiofeat_stack(functions.audio_compute_fbank(rows, cfg),
                                                     cfg)),
    )
    for name, cfg, wav, tol, on_card, on_host in cases:
        t0 = time.perf_counter()
        host = [s["audiofeat"] for s in on_host(
            ({"sample_rate": SR, "waveform": w} for w in wav), cfg)]
        host_s = time.perf_counter() - t0
        got = on_card(wav, cfg) if on_card is frontend.device_frontend else \
            on_card(torch.from_numpy(wav).to(dev), cfg)
        torch.cuda.synchronize()
        err = max((got[b].float().cpu() - torch.from_numpy(host[b])).abs().max().item()
                  for b in range(B))
        ok = (got.device.type == "cuda" and tuple(got.shape) == (B, *host[0].shape)
              and bool(torch.isfinite(got).all()) and err <= tol)
        wav_dev = torch.from_numpy(wav).to(dev)
        ms = time_ms(lambda: on_card(wav_dev, cfg))
        copy_ms = time_ms(lambda: torch.from_numpy(wav).to(dev))
        print(f"  {name}: [{B}, {wav.shape[1]}] -> {tuple(got.shape)}, max_abs_err vs host "
              f"{err:.3e} (<= {tol:.0e}) {'ok' if ok else 'FAIL'}; card {ms:.3f} ms a batch "
              f"(+ {copy_ms:.3f} ms to copy it from the host), host path "
              f"{host_s * 1e3:.1f} ms a batch on one thread  [{card}]")
        if not ok:
            failures.append(f"frontend {name}")
        del got, wav_dev


def synth_utterances(root: Path, count: int, seed: int, lo=1.0, hi=15.0,
                     txt_vocab=None, long=None) -> tuple:
    """`count` seeded 16 kHz int16 wavs of lo-hi seconds under root: voiced
    tones (harmonics 1-5 of a pitch drifting +-30 % around 90-220 Hz, with a
    syllable-rate envelope) plus noise, so the BEST-RQ codes spread; and a
    jsonl of {key, wav, txt} lines (txt: ids below txt_vocab, else a word).
    long=(index, seconds) gives that utterance its own length. Returns
    (jsonl path, seconds of audio)."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    lines, total = [], 0.0
    for i in range(count):
        seconds = float(rng.uniform(lo, hi))
        if long is not None and i == long[0]:
            seconds = float(long[1])
        path = root / f"utt{i}.wav"
        wavfile.write(path, SR, synth_speech(rng, int(seconds * SR)))
        txt = ([int(v) for v in rng.integers(3, txt_vocab, int(rng.integers(4, 30)))]
               if txt_vocab else f"utterance {i}")
        lines.append(json.dumps({"key": f"utt{i}", "wav": str(path), "txt": txt}))
        total += seconds
    jsonl = root / "data.jsonl"
    jsonl.write_text("\n".join(lines) + "\n")
    return jsonl, total


def audio_argv(listfile, exp, seqlen, steps, dtype, config=AUDIO_CONFIG, **extra) -> list:
    """The recipe's stage-2 flags (run.sh:98-192, BEST-RQ vocab 1024 emb 16
    input 400 seed 2025, touch_audio packed 1x<seqlen>, fbank 80 bins dither
    0, stack 5 stride 4 normalised, speed perturb 0.9/1.0/1.1, SpecAug,
    SpecSub and SpecTrim off, remat none, max_norm 5, AdamW fused lr 8e-4,
    WSD linear) on one card (dp 1, cp 1, tp 1, pp 1), `steps` steps with 2
    warmup, the model config `config`; `extra` (flag: value) adds or
    replaces flags. The recipe passes
    no --dataset_enable_pack, so it would train the dynamic batcher
    (batch_audio); its exp id names 1x8192 packed, which this passes."""
    stride, stack, bins = 4, 5, 80
    args = {
        "tokenizer_type": "BestRQTokenizer", "tokenizer_bestrq_vocab_size": 1024,
        "tokenizer_bestrq_input_size": stack * bins, "tokenizer_bestrq_emb_size": 16,
        "tokenizer_bestrq_init_seed": 2025, "tokenizer_bestrq_init_method": "default",
        "datapipe_type": "touch_audio", "datalist_path": listfile, "datalist_sharding": "true",
        "datalist_epoch": 10000, "datalist_shuffling": "true",
        "dataset_random_cut_audio": "false", "dataset_shuffling": "true",
        "dataset_mmap": "true", "dataset_enable_pack": "true", "dataset_batchsize": 1,
        "dataset_audio_seqlen": seqlen, "dataset_text_seqlen": seqlen,
        "audio_max_length_in_ms_for_filter": seqlen * stride * 10 - 200,
        "audio_min_length_in_ms_for_filter": 200,
        "text_max_length_in_tokens_for_filter": seqlen - 1,
        "text_min_length_in_tokens_for_filter": 1, "max_text_audio_ratio": 1.0,
        "min_text_audio_ratio": 0.0005, "audio_resample_rate": SR,
        "audio_speed_perturb": "true", "audio_feat_type": "fbank",
        "audiofeat_spec_aug": "false", "audiofeat_spec_sub": "false",
        "audiofeat_spec_trim": "false", "audiofeat_num_mel_bins": bins,
        "audiofeat_frame_length": 25, "audiofeat_frame_shift": 10, "audiofeat_dither": 0.0,
        "audiofeat_stack_length": stack, "audiofeat_stride_length": stride,
        "audiofeat_normalize": "true", "dataloader_num_workers": AUDIO_WORKERS,
        "dataloader_prefetch_factor": AUDIO_PREFETCH,
        "training_description": "wenetspeech ssl", "training_seed": 2025,
        "training_model_name": "touch_audio", "training_model_config_path": config,
        "training_trace_dump_folder": exp, "training_context_parallel_degree": 1,
        "training_tensor_parallel_degree": 1, "training_data_parallel_shard_degree": 1,
        "training_pipeline_parallel_degree": 1, "training_enable_loss_parallel": "true",
        "training_enable_liger_kernel": "true", "training_log_freq": 1,
        "training_mixed_precision_param": dtype, "training_mixed_precision_reduce": "float32",
        "training_compile": "true", "training_gc_freq": 1000,
        "training_deterministic": "false", "training_max_norm": 5.0,
        "training_activation_checkpoint_mode": "none",
        "training_activation_checkpoint_selective_ac_option": "op",
        "optimizer_name": "AdamW", "optimizer_lr": 8e-4, "optimizer_impl": "fused",
        "lr_scheduler_steps": steps, "lr_scheduler_warmup_steps": 2,
        "lr_scheduler_decay_type": "linear", "lr_scheduler_lr_min": 0.0, **extra,
    }
    return [x for k, v in args.items() for x in (f"--{k}", str(v))]


def audio_stage0(tmp: Path, name: str, seconds: float, seed: int, shards: int,
                 failures) -> Path:
    """Synthesised utterances (1-15 s) holding about `seconds` of audio,
    through make_data (a subprocess, audio+metainfo, 8 workers) into
    `shards` shards. Checks data.list and the utterance count read back."""
    from touchnet_tpu_torch.data.dataset import TouchDataset

    count = int(seconds / 8.0) + 1  # uniform 1-15 s: 8 s on average
    t0 = time.perf_counter()
    jsonl, total = synth_utterances(tmp / f"{name}_wav", count, seed)
    synth_s = time.perf_counter() - t0
    save = tmp / name
    per_shard = -(-count // shards)
    secs = run_cli("touchnet_tpu_torch.bin.make_data",
                   ["--save_dir", save, "--jsonl_path", jsonl, "--num_utt_per_shard",
                    per_shard, "--num_workers", 8, "--datatypes", "audio+metainfo"],
                   failures, f"audio stage 0 ({name})")
    listfile = save / "data.list"
    lines = listfile.read_text().splitlines() if listfile.exists() else []
    n = sum(len(TouchDataset(ln.split()[0], datatypes="audio+metainfo")) for ln in lines)
    ok = len(lines) == -(-count // per_shard) and n == count
    print(f"  stage 0 ({name}): {count} utterances, {total:.1f} s of audio synthesised in "
          f"{synth_s:.1f} s; make_data (subprocess, 8 workers) -> {len(lines)} shards, "
          f"{tree_bytes(save)} bytes, in {secs:.2f} s; {n} utterances read back "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"audio stage 0 ({name})")
    return listfile


def run_audio_recipe(dev, card, failures, tmp: Path) -> dict:
    """Phase 10: the BEST-RQ audio pretraining recipe's stages 0, 2 and 3 on
    one card at Touch-Audio-1B's full width and AUDIO_MAX_LAYERS of its 16
    layers: make_data over
    synthesised utterances; bin.train.main with the recipe's flags (1x8192
    packed, speed perturb on, remat none), checkpoints every 5 (async, keep
    2) and a dev list, then a fresh run resumed from step 5 held to it bit
    for bit; convert_ckpt_to_hf --model_type touch_audio on step 10, held
    to the final params bit for bit; one step at 1x4096 on the kernel path
    against plain_kernels(). Returns the kernels' launches over its two
    training runs (the main path)."""
    from touchnet_tpu_torch.bin import train
    from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import (
        TouchAudioConfig,
    )
    from touchnet_tpu_torch.models.touch_audio.modeling_touch_audio import get_num_params
    from touchnet_tpu_torch.utils.safetensors_io import read_safetensors

    raw = json.loads(AUDIO_CONFIG.read_text())
    full = raw["text_config"]["num_hidden_layers"]
    raw["text_config"]["num_hidden_layers"] = L = min(AUDIO_MAX_LAYERS, full)
    config = tmp / "audio_config.json"
    config.write_text(json.dumps(raw))
    cfg = TouchAudioConfig.from_json_file(str(config))
    tc = cfg.text_config
    print(f"[10] the audio pretraining recipe's stages 0, 2, 3 on one card "
          f"(examples/audio/pretrain/wenetspeech/run.sh, dp 1): "
          f"{AUDIO_CONFIG.relative_to(HERE)}: L={L} (CUT from {full}: the script's clock) "
          f"E={tc.hidden_size} H={tc.num_attention_heads}/{tc.num_key_value_heads} "
          f"D={tc.head_dim} V={tc.vocab_size} tied={tc.tie_word_embeddings}, projector "
          f"{cfg.audio_config.input_size} -> {tc.hidden_size}, {get_num_params(cfg):,} params")
    listfile = audio_stage0(tmp, "train", 1.1 * AUDIO_STEPS * ROW_SECONDS, SEED + 10, 16,
                            failures)
    devlist = audio_stage0(tmp, "dev", 0.6 * ROW_SECONDS, SEED + 11, 1, failures)
    exp = tmp / "exp"
    flags = dict(datalist_dev_path=devlist, training_enable_ckpt="true",
                 training_ckpt_load_step=-1, training_ckpt_interval=AUDIO_INTERVAL,
                 training_ckpt_keep_latest_k=2, training_ckpt_async_mode="async",
                 training_enable_tensorboard="true", training_enable_profiling="true",
                 training_profiling_freq=100, training_profiling_keep_first_k=10)
    print(f"  stage 2: {AUDIO_STEPS} steps at 1x{AUDIO_T} packed with the recipe's flags, "
          f"{AUDIO_WORKERS} loader workers (prefetch {AUDIO_PREFETCH}, cut from 12), "
          f"checkpoints every "
          f"{AUDIO_INTERVAL} (keep 2, async), a dev list; memory snapshots off (phase 9 "
          "runs them)")
    counters = kernel_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the main path (both runs): every launch count is zeroed here and read
    # after the resumed run
    for c in counters.values():
        c.launches = 0
    with count_plain_calls() as plain_calls, timed_saves(train) as saves:
        first = train.main(audio_argv(listfile, exp, AUDIO_T, AUDIO_STEPS, "bfloat16", config,
                                      **flags))
        peak = torch.cuda.max_memory_allocated() / 2**30
        first_counts = {k: c.launches for k, c in counters.items()}
        step_ms, tps, mfu = step_stats(first)
        saves1 = dict(saves)
        hist1 = first.metrics_processor.history
        dev1 = first.metrics_processor.dev_history
        state1 = bits_checksums({**first.model.state_dict(), **first._opt_state()})
        del first
        torch.cuda.empty_cache()
        resumed = train.main(audio_argv(
            listfile, exp, AUDIO_T, AUDIO_STEPS, "bfloat16", config,
            **{**flags, "training_ckpt_load_step": AUDIO_RESUME,
               "training_ckpt_async_mode": "disabled"}))
    counts = {k: c.launches for k, c in counters.items()}
    hist2 = resumed.metrics_processor.history
    state2 = bits_checksums({**resumed.model.state_dict(), **resumed._opt_state()})
    final = {k: state2[k] for k in resumed.model.state_dict()}
    del resumed
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    ok = left < 1.0
    print(f"  after both runs {left:.2f} GiB stay allocated on the card (each Trainer freed "
          f"with its last reference) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("audio recipe: a finished run's memory stays allocated")

    losses1 = [h["loss/per_sample"] for h in hist1]
    ok = (len(losses1) == AUDIO_STEPS and all(math.isfinite(x) for x in losses1)
          and losses1[-1] < losses1[0])
    print(f"  run 1 losses per step: {[round(x, 4) for x in losses1]} (finite, step "
          f"{AUDIO_STEPS} below step 1) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("audio recipe: losses")
    wait = [h["time/data_loading_pct"] for h in hist1]
    print(f"  run 1: step {step_ms:.1f} ms (median of steps 3-{AUDIO_STEPS}), {tps:,.0f} "
          f"label tokens/s, MFU {mfu:.2f}% of 989 TFLOP/s bf16 (the phase-8 count, "
          f"6N + 12 L H D T at T {AUDIO_T}), peak {peak:.2f} GiB allocated  [{card}]")
    print(f"  run 1: data-wait share (the loop's wait for the next batch over the step's "
          f"time) per step, %: {[round(x, 1) for x in wait]}; median of steps 3-"
          f"{AUDIO_STEPS} {statistics.median(wait[2:]):.1f}%; step times, ms: "
          f"{[round(h['time/step_s'] * 1e3, 1) for h in hist1]}  [{card}]")
    per_step = {k: v / AUDIO_STEPS for k, v in first_counts.items()}
    dev_batches = first_counts["K3 fwd"] - AUDIO_STEPS
    ok = (first_counts["K2"] == L * AUDIO_STEPS and first_counts["K3 bwd"] == AUDIO_STEPS
          and dev_batches > 0 and first_counts["K1"] == L * (AUDIO_STEPS + dev_batches)
          and not plain_calls)
    print(f"  run 1 launches: {first_counts} over {AUDIO_STEPS} steps and {dev_batches} dev "
          f"batches (per step K2 {per_step['K2']:g}, K3 bwd {per_step['K3 bwd']:g}; K1 = "
          f"{L} x (steps + dev batches), K3 fwd = steps + dev batches; remat none: no "
          f"recompute); plain versions called: {plain_calls or 'none'} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("audio recipe: launch counts")
    ok = [d["step"] for d in dev1] == [1, AUDIO_INTERVAL, AUDIO_STEPS] and \
        all(math.isfinite(v) for d in dev1 for v in d.values())
    print("  dev lines: " + "; ".join(f"step {d['step']} loss {d['loss_per_sample']:.4f} acc "
                                      f"{d['acc']:.4f}" for d in dev1) +
          f" {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("audio recipe: dev lines")
    print("  saves, the loop blocked in save(): " + ", ".join(
        f"step {s} {ms:.1f} ms (write {w:.2f} s)" for s, (ms, w) in sorted(saves1.items())) +
        f"; a checkpoint is {tree_bytes(exp / 'checkpoint' / f'step_{AUDIO_STEPS}')} bytes")
    losses2 = [h["loss/per_sample"] for h in hist2]
    differ = sorted(k for k in state1 if state1[k] != state2.get(k)) + \
        sorted(set(state2) - set(state1))
    same = ([h["step"] for h in hist2] == list(range(AUDIO_RESUME + 1, AUDIO_STEPS + 1))
            and losses2 == losses1[AUDIO_RESUME:] and not differ)
    print(f"  resumed from step {AUDIO_RESUME}: losses {[round(x, 4) for x in losses2]} equal "
          f"run 1's bit for bit, and the final params, mu, nu, count ({len(state1)} tensors, "
          f"checksums of their bits) differ in {differ[:5] or 'none'}: {same} "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        failures.append("audio recipe: resume not bit-equal")

    secs = run_main("touchnet_tpu_torch.bin.convert_ckpt_to_hf",
                   ["--ckpt_dir", exp, "--step", -1, "--config", config,
                    "--model_type", "touch_audio"], failures, "audio stage 3")
    out = exp / "checkpoint_hf" / f"step-{AUDIO_STEPS}"
    tensors = read_safetensors(str(out / "model.safetensors"))
    bits = bits_checksums(tensors)
    del tensors
    differ = sorted(k for k in final if bits.get(k) != final[k]) + sorted(set(bits) - set(final))
    exported = TouchAudioConfig.from_json_file(str(out / "config.json"))
    ok = not differ and exported.to_dict() == cfg.to_dict()
    print(f"  stage 3: convert_ckpt_to_hf --model_type touch_audio --step -1 (in-process main) -> "
          f"{out.name}, {tree_bytes(out)} bytes in {secs:.2f} s; its {len(bits)} tensors "
          f"equal the final params bit for bit, config.json round-trips: {not differ} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("audio recipe: export")

    # what holds the step back: the same steps without checkpoints or dev
    # passes under 2 loader threads, and with the batches made first and
    # held in host memory (no loader thread running while the steps do)
    torch.cuda.empty_cache()
    run = train.main(audio_argv(listfile, tmp / "threads2", AUDIO_T, LOADER_STEPS, "bfloat16",
                                config, dataloader_num_workers=2,
                                dataloader_prefetch_factor=2))
    step_ms, tps, mfu = step_stats(run)
    hist = run.metrics_processor.history
    del run
    print(f"  {LOADER_STEPS} steps, no checkpoints or dev, 2 loader threads and prefetch 2: "
          f"step {step_ms:.1f} ms (median of steps 3-{LOADER_STEPS}), {tps:,.0f} label "
          f"tokens/s, MFU {mfu:.2f}%; step times, ms: "
          f"{[round(h['time/step_s'] * 1e3, 1) for h in hist]}; data-wait share, %: "
          f"{[round(h['time/data_loading_pct'], 1) for h in hist]}  [{card}]")
    held_steps(train, listfile, tmp, dev, card, config)

    # remat full here (both paths): under the recipe's none the plain
    # attention keeps each layer's f32 [32, 4096, 4096] scores and weights
    # for the backward, more than the card holds; remat changes no value
    print(f"  one step at 1x{CHECK_T}, full width, {L} layers, remat full: kernel vs plain "
          "path")
    check_step(train, lambda dtype: audio_argv(listfile, tmp / "chk", CHECK_T, 1, dtype, config,
                                               dataloader_num_workers=1,
                                               audio_speed_perturb="false",
                                               training_activation_checkpoint_mode="full"),
               dev, failures, "audio ")
    return counts


def held_steps(train, listfile, tmp: Path, dev, card, config):
    """Phase 10's steps on batches made first and held in host memory: a
    Trainer with the recipe's flags, LOADER_STEPS batches pulled from its
    loader, the loader shut down, then each batch staged and trained with
    a sync after it (host clock). The step without the loader's threads."""
    from touchnet_tpu_torch.bin import TrainConfig
    from touchnet_tpu_torch.data import DataConfig
    from touchnet_tpu_torch.tokenizer import TokenizerConfig
    from touchnet_tpu_torch.utils.cli import parse_args_into_dataclasses

    tok, data, job = parse_args_into_dataclasses(
        [TokenizerConfig, DataConfig, TrainConfig],
        audio_argv(listfile, tmp / "held", AUDIO_T, LOADER_STEPS, "bfloat16", config))
    trainer = train.Trainer(tok, data, job, dev)
    try:
        it = iter(trainer.dataloader)
        batches = [next(it) for _ in range(LOADER_STEPS)]
    finally:
        trainer.dataloader.shutdown()
    times = []
    for batch in batches:
        t0 = time.perf_counter()
        device_batch, num_sentence = trainer._put_batch(batch)
        trainer.train_step(device_batch, num_sentence)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    tokens = statistics.median(int((b["labels"] != -100).sum()) for b in batches)
    step_ms = statistics.median(times[2:])
    mfu = 100 * trainer.num_flop_per_token * tokens / (step_ms * 1e-3) / PEAK_BF16_FLOPS
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    print(f"  {LOADER_STEPS} steps on batches held in host memory (no loader thread running): "
          f"step {step_ms:.1f} ms (median of steps 3-{LOADER_STEPS}), "
          f"{tokens / step_ms * 1e3:,.0f} label tokens/s, MFU {mfu:.2f}%; step times, ms: "
          f"{[round(t, 1) for t in times]}  [{card}]")


# -- phase 11: the ASR inference CLI (examples/audio/sft/asr/wenetspeech/run.sh stage 4) --

ASR_UTTS, ASR_BATCH, ASR_NEW = 32, 16, 64
# the decode timing: greedy steps after the prefill, kernel path
ASR_TIMED_STEPS = 32


def run_asr_cli(dev, card, failures, tmp: Path, export) -> dict:
    """Phase 11: the SFT recipe's stage 4 with model_type touch_audio on
    phase 18's export (Touch-Audio-7B at full width and phase 18's text
    depth, its trained f32 weights loaded in bf16, config.json and the
    tokenizer beside them): python -m touchnet_tpu_torch.models.touch_audio.
    inference_touch_audio, run in-process through its main, with
    stage4_argv's flags (bf16, batch 16, an empty instruct, the config and
    the tokenizer the export's) plus max_length 64 and fbank 80 x stack 5
    stride 4 (the recipe's stage 4 passes no feature flags: the defaults
    give 161-wide features against the projector's 400), over 32
    synthesised wavs; then trans.txt, raw_rec.txt, textnorm_zh and
    error_rate_zh as the recipe scores. Checks a part file with a hyp for
    every key and K1 and K4 launched; then the first batch's prefill and
    first decode step on the kernel path against plain_kernels() under the
    serving limit, and prefill ms, decode ms/step and peak memory. Returns
    the launches of the CLI run (the main path)."""
    import torch.nn.functional as F

    from touchnet_tpu_torch.data import DataConfig
    from touchnet_tpu_torch.models.llama import inference_llama as inf
    from touchnet_tpu_torch.models.touch_audio import inference_touch_audio as cli
    from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import (
        TouchAudioConfig,
    )
    from touchnet_tpu_torch.models.touch_audio.modeling_touch_audio import get_num_params
    from touchnet_tpu_torch.ops.attention import flash_attention
    from touchnet_tpu_torch.ops.decode_attention import decode_attention
    from touchnet_tpu_torch.tokenizer import TokenizerConfig
    from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
    from touchnet_tpu_torch.utils.inference import AudioJsonlDataset, pad_right

    if export is None:
        print("[11] ASR CLI: phase 18 left no export FAIL")
        failures.append("asr cli: no export")
        return {}
    cfg = TouchAudioConfig.from_json_file(str(export / "config.json"))
    tc = cfg.text_config
    L = tc.num_hidden_layers
    print(f"[11] ASR CLI (examples/audio/sft/asr/wenetspeech/run.sh stage 4, touch_audio) on "
          f"phase 18's export {export.name} ({tree_bytes(export)} bytes, f32): L={L} "
          f"E={tc.hidden_size} H={tc.num_attention_heads}/{tc.num_key_value_heads} "
          f"D={tc.head_dim} V={tc.vocab_size}, {get_num_params(cfg):,} params, loaded in bf16; "
          f"CUT to phase 18's {L} of 32 text layers (8 before phase 18 trained this export)")
    jsonl, total = synth_utterances(tmp / "asr_wav", ASR_UTTS, SEED + 21)
    print(f"  {ASR_UTTS} wavs, {total:.1f} s of audio")
    argv = stage4_argv("touch_audio", export, jsonl, tmp / "asr_out") + \
        ["--max_length", str(ASR_NEW)] + [x for k, v in TOUCH_FEATS.items()
                                          for x in (f"--{k}", str(v))]
    loaded = {}
    real_load = cli.load_params

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        loaded["model"] = real_load(*a, **kw)
        loaded["s"] = time.perf_counter() - t0
        return loaded["model"]

    cli.load_params = timed_load
    torch.cuda.reset_peak_memory_stats()
    # the main path: every launch count is zeroed here and read just after
    flash_attention.launches = decode_attention.launches = 0
    try:
        t0 = time.perf_counter()
        path = cli.main(argv)
        cli_s = time.perf_counter() - t0
    finally:
        cli.load_params = real_load
    counts = {"K1": flash_attention.launches, "K4": decode_attention.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = [json.loads(ln) for ln in open(path)]
    keys = [json.loads(ln)["key"] for ln in open(jsonl)]
    batches = -(-ASR_UTTS // ASR_BATCH)
    ok = ([r["key"] for r in rows] == keys and all(isinstance(r.get("hyp"), str) for r in rows)
          and counts["K1"] == batches * L and 0 < counts["K4"] <= batches * ASR_NEW * L)
    print(f"  CLI (stage4_argv: {' '.join(argv[2:])}): {cli_s:.2f} s in all ({loaded['s']:.2f} "
          f"s loading the export onto the card); {path} has {len(rows)} lines, a hyp for every "
          f"key: {[r['key'] for r in rows] == keys}; first hyp {rows[0]['hyp'][:16]!r}; "
          f"launches K1={counts['K1']} (want {batches}x{L}, single-shot prefill) "
          f"K4={counts['K4']} (<= {batches}x{ASR_NEW}x{L}); peak {peak:.2f} GiB allocated "
          f"{'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("asr cli: output / launches")
    score_cer(tmp / "asr_out", write_ark(path, tmp / "asr_out"), failures, "touch_audio asr")

    # the first batch again, outside the CLI: prefill and the first decode
    # step, kernel path against plain_kernels(), and the timings
    model = loaded.pop("model")
    lm = model.language_model
    tok = build_tokenizer(TokenizerConfig(tokenizer_type="HuggingFaceTokenizer",
                                          tokenizer_model=str(export)))
    proj, bos_emb = cli.prompt_parts(model, tok)
    data_cfg = DataConfig(**TOUCH_FEATS)
    samples = [AudioJsonlDataset.load(s) for s in AudioJsonlDataset(str(jsonl)).samples]
    prompts = [cli.make_prompt(cli.compute_features(s, data_cfg), proj, bos_emb)
               for s in samples[:ASR_BATCH]]
    lens = torch.tensor([p.shape[0] for p in prompts], device=dev)
    emb = torch.from_numpy(pad_right(prompts, 0.0)).to(dev)

    def forced(steps, toks=None):
        """prefill logits and `steps` decode steps' logits, each step fed
        toks[s] (greedy from its own logits when toks is None); with the
        prefill ms and the decode ms/step."""
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, last, Tp = inf.prefill(lm, tc, emb, lens, steps,
                                          compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, fed = [last], []
            for s in range(steps):
                fed.append(logits[-1].argmax(-1) if toks is None else toks[s])
                tok_emb = F.embedding(fed[-1], lm.model.embed_tokens.weight)[:, None]
                logits.append(inf.decode_step(lm, tc, cache, tok_emb, lens, Tp, s,
                                              torch.bfloat16))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        return logits, fed, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(steps, 1)

    forced(1)  # warm the shapes (not measured)
    logits, fed, prefill_ms, step_ms = forced(ASR_TIMED_STEPS)
    before = (flash_attention.launches, decode_attention.launches)
    with plain_kernels():
        plain, _, _, _ = forced(1, fed)
    launched = (flash_attention.launches, decode_attention.launches) != before
    e_pre, e_step = rel_l2(logits[0], plain[0]), rel_l2(logits[1], plain[1])
    finite = bool(torch.isfinite(logits[0]).all() and torch.isfinite(logits[1]).all())
    ok = finite and not launched and e_pre <= BF16_PREFILL_RTOL and e_step <= BF16_PREFILL_RTOL
    print(f"  first batch (B={ASR_BATCH}, prompts {lens.min().item()}-{lens.max().item()}): "
          f"bf16 kernel vs bf16 plain logits rel_l2: prefill {e_pre:.3e}, first decode step "
          f"{e_step:.3e} (each <= {BF16_PREFILL_RTOL:.0e}); finite={finite}; the plain path "
          f"launched no kernel: {not launched} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("asr cli: logits")
    print(f"  first batch: prefill {prefill_ms:.1f} ms, decode {step_ms:.3f} ms/step (greedy, "
          f"{ASR_TIMED_STEPS} steps)  [{card}]")
    del model, lm, logits, plain
    torch.cuda.empty_cache()
    return counts


# -- phase 12: qwen2_audio's ASR stage (examples/audio/sft/asr/wenetspeech/run.sh stage 4,
# model_type qwen2_audio: inference, then textnorm and CER) --

QWEN2_CONFIG = HERE / "examples/audio/sft/asr/wenetspeech/config/Qwen2-Audio-7B.json"
# Qwen2-Audio's special tokens at their published ids (<|AUDIO|> is the
# config's audio_token_index); its tokenizer is not in the repo
QWEN2_SPECIALS = {"<|endoftext|>": 151643, "<|AUDIO|>": 151646, "<|audio_bos|>": 151647,
                  "<|audio_eos|>": 151648}
QWEN2_EOS = "<|endoftext|>"
QWEN2_INSTRUCT = "Generate the transcription:"  # run.sh:163
# one utterance past 30 s, in the first batch: the tower's position table
# is tiled and that batch runs at T = 1750
QWEN2_LONG = (3, 35.0)
# characters of the tokenizer's ids: ASCII, CJK ideographs (and extension
# A), Hangul, then the two supplementary private-use planes
CHAR_BLOCKS = ((0x20, 0x7F), (0x4E00, 0xA000), (0x3400, 0x4DC0), (0xAC00, 0xD7A4),
               (0xF0000, 0xFFFFE), (0x100000, 0x10FFFE))


def write_char_tokenizer(root: Path, vocab_size: int, specials: dict, eos: str,
                         first_chars: str = "", bos: str = None, pad: str = None) -> Path:
    """An HF tokenizer directory (tokenizer.json, tokenizer_config.json): a
    `tokenizers` WordLevel model over single characters, with `specials` at
    their ids and every other id below vocab_size one character (those of
    first_chars first, then CHAR_BLOCKS); text splits into characters
    after the special tokens, and decoding joins them. eos is also the
    unknown token, and the pad unless `pad` names another special; no bos
    unless `bos` names one (Qwen2's tokenizer has none). The port's
    HuggingFaceTokenizer loads it."""
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers

    order = list(dict.fromkeys(first_chars))
    chars = iter(order + [chr(c) for a, b in CHAR_BLOCKS for c in range(a, b)
                          if chr(c) not in order])
    taken = set(specials.values())
    vocab = dict(specials)
    for i in range(vocab_size):
        if i not in taken:
            vocab[next(chars)] = i
    tok = Tokenizer(models.WordLevel(vocab, unk_token=eos))
    tok.pre_tokenizer = pre_tokenizers.Split(Regex("."), behavior="isolated")
    tok.decoder = decoders.Fuse()
    tok.add_special_tokens(list(specials))
    root.mkdir(parents=True, exist_ok=True)
    tok.save(str(root / "tokenizer.json"))
    (root / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "eos_token": eos, "pad_token": pad or eos,
        "bos_token": bos, "unk_token": eos, "model_max_length": 1 << 20}))
    return root


def write_ark(part: str, out: Path) -> list:
    """trans.txt and raw_rec.txt ("key<TAB>text" lines of txt and hyp) from
    the CLI's part file, as the recipe writes them (run.sh:185-195); the
    keys."""
    keys = []
    with open(part, encoding="utf8") as f, open(out / "trans.txt", "w", encoding="utf8") as t, \
            open(out / "raw_rec.txt", "w", encoding="utf8") as r:
        for line in f:
            rec = json.loads(line)
            keys.append(rec["key"])
            t.write(f"{rec['key']}\t{rec.get('txt', '')}\n")
            r.write(f"{rec['key']}\t{rec.get('hyp', '')}\n")
    return keys


def score_cer(out: Path, keys: list, failures, what: str = "qwen2 asr") -> str:
    """The recipe's scoring (run.sh:197-212) with the port's tools:
    textnorm_zh on both sides, the empty hyps dropped, error_rate_zh
    --tokenizer char. Checks that the scorer read a pair for every key;
    returns its summary line."""
    for src, dst in (("trans.txt", "ref.txt"), ("raw_rec.txt", "rec.txt")):
        run_cli("touchnet_tpu_torch.bin.textnorm_zh",
                ["--format=ark", "--to_upper", "--to_banjiao", "--remove_fillers",
                 "--remove_erhua", out / src, out / dst], failures, f"textnorm {src}")
    lines = (out / "rec.txt").read_text(encoding="utf8").splitlines()
    (out / "rec_non_empty.txt").write_text(
        "".join(ln + "\n" for ln in lines if not ln.endswith("\t")), encoding="utf8")
    res = subprocess.run(
        [sys.executable, "-m", "touchnet_tpu_torch.bin.error_rate_zh", "--tokenizer", "char",
         "--ref", str(out / "ref.txt"), "--hyp", str(out / "rec_non_empty.txt"),
         "--detail", str(out / "DETAILS.txt")],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    (out / "RESULTS.txt").write_text(res.stdout, encoding="utf8")
    overall = [ln for ln in res.stdout.splitlines() if ln.startswith("Overall -> ")]
    n_utts = [ln for ln in res.stdout.splitlines() if ln.startswith("num_eval_utts:")]
    ok = (res.returncode == 0 and len(overall) == 1
          and n_utts == [f"num_eval_utts: {len(keys)}"])
    print(f"  error_rate_zh --tokenizer char: {overall[0] if overall else res.stderr[-500:]}; "
          f"{n_utts[0] if n_utts else 'no summary'} (want {len(keys)}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{what}: scoring")
    return overall[0] if overall else ""


def qwen2_kernel_rows(attn, dec, dev, failures, card, B, Tp, lens, S) -> tuple:
    """K1 and K4 at this path's shapes, each against its plain version and a
    library call: (f) the tower's causal MHA, B16 T1500 H20 D64 (the library
    is scaled_dot_product_attention, is_causal); (g) the prefill of the first
    batch, B16 T=Tp H28/4 D128 causal over every padded row (generate passes
    no segment ids); (h) the last decode step of that batch, its prompt
    lengths, G 7. Returns (K1 rows, K4 rows)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    bf = torch.bfloat16
    k1_rows, k4_rows = {}, {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf)

    q, k, v = (randn(B, 1500, 20, 64) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True).transpose(1, 2), None

    k1_case(attn, dev, failures, card, k1_rows,
            f"(f) qwen2_audio tower: B{B} T1500 H20/20 D64 bf16 causal, library SDPA",
            q, k, v, None, None, True, 0, timed=True, library=sdpa)
    del q, k, v, qt, kt, vt
    q, k, v = randn(B, Tp, 28, 128), randn(B, Tp, 4, 128), randn(B, Tp, 4, 128)
    k1_case(attn, dev, failures, card, k1_rows,
            f"(g) qwen2_audio prefill: B{B} T{Tp} H28/4 (G7) D128 bf16 causal, prompts "
            f"{min(lens)}-{max(lens)}", q, k, v, None, None, True, 0, timed=True,
            runs=lambda q, k, v: ([Tp] * B, [Tp] * B, k, v))
    del q, k, v
    k4_case(dec, dev, gen, failures, card, k4_rows,
            f"(h) qwen2_audio decode: B{B} H28/4 (G7) D128 S{S} bf16, prompts "
            f"{min(lens)}-{max(lens)}, step {ASR_NEW}", B, 1, 4, 7, 128, S, lens, Tp,
            Tp + ASR_NEW - 1, 0, bf, timed=True)
    torch.cuda.empty_cache()
    return k1_rows, k4_rows


def run_qwen2_cli(dev, card, failures, tmp: Path, export) -> tuple:
    """Phase 12: qwen2_audio's ASR stage (python -m touchnet_tpu_torch.
    models.qwen2_audio.inference_qwen2_audio, run in-process through its
    main) on phase 14's stage-3 export (the recipe's chain: stage 4 reads
    what stage 3 wrote; Qwen2-Audio-7B at full width with phase 14's text
    depth, f32 weights loaded in bf16, the char tokenizer saved beside
    them), 32 synthesised wavs (one of 35 s), batch 16, max_length 64, bf16,
    the recipe's instruct; then the recipe's scoring. Checks a hyp for every
    key, the scorer's pairs, the launches (K1: the tower's layers and the
    text layers a batch; K4: the text layers a decode step) and no plain
    version called; then the first batch outside the CLI: the projected
    audio, the last prefill's and the first decode step's logits on the
    kernel path against plain_kernels(), with the timings, and the kernel
    rows (f), (g), (h). Returns (the CLI run's launches, K1 rows, K4 rows)."""
    from touchnet_tpu_torch.models.llama import inference_llama as inf
    from touchnet_tpu_torch.models.qwen2_audio import inference_qwen2_audio as cli
    from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import (
        Qwen2AudioConfig,
    )
    from touchnet_tpu_torch.models.qwen2_audio.modeling_qwen2_audio import (
        empty_model,
        encode_audio,
        get_num_params,
        merge_audio_into_text,
    )
    from touchnet_tpu_torch.ops import attention as attn
    from touchnet_tpu_torch.ops import decode_attention as dec
    from touchnet_tpu_torch.tokenizer import TokenizerConfig
    from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
    from touchnet_tpu_torch.utils.inference import AudioJsonlDataset, pad_right

    if export is None:
        print("[12] qwen2_audio ASR: phase 14 left no stage-3 export to run stage 4 on FAIL")
        failures.append("qwen2 asr: no export")
        return {}, {}, {}
    hf = tok_dir = Path(export)
    config = hf / "config.json"
    cfg = Qwen2AudioConfig.from_json_file(str(config))
    tc, ac = cfg.text_config, cfg.audio_config
    L, tower_L = tc.num_hidden_layers, ac.encoder_layers
    n_bytes = (hf / "model.safetensors").stat().st_size
    print(f"[12] qwen2_audio ASR stage (examples/audio/sft/asr/wenetspeech/run.sh stage 4) on "
          f"phase 14's stage-3 export: {QWEN2_CONFIG.relative_to(HERE)}: tower {tower_L} layers "
          f"d{ac.d_model} H{ac.encoder_attention_heads} mel {ac.num_mel_bins}; text L={L} (phase "
          f"14's depth) E={tc.hidden_size} H={tc.num_attention_heads}/{tc.num_key_value_heads} "
          f"D={tc.head_dim} V={tc.vocab_size}; {get_num_params(cfg):,} params, {n_bytes} bytes "
          f"({n_bytes / 1e9:.2f} GB) of f32 weights loaded in bf16")
    jsonl, total = synth_utterances(tmp / "qwen2_wav", ASR_UTTS, SEED + 31, long=QWEN2_LONG)
    print(f"  {ASR_UTTS} wavs, {total:.1f} s of audio (utt{QWEN2_LONG[0]} "
          f"{QWEN2_LONG[1]:.0f} s)  [{card}]")

    tok_flags = {"tokenizer_type": "HuggingFaceTokenizer", "tokenizer_model": str(tok_dir)}
    out = tmp / "qwen2_out"
    # the recipe's stage-4 flags (run.sh:157-182) with max_length 64
    args = {"model_path": hf, "model_dtype": "bfloat16", "instruct": QWEN2_INSTRUCT,
            "data_list": jsonl, "output_dir": out, "batch_size": ASR_BATCH,
            "max_length": ASR_NEW, "num_workers": 16, "prefetch": 8,
            "training_model_config_path": config, **tok_flags}
    loaded, feat_s = {}, []
    real_load, real_feats = cli.load_params, cli.whisper_features

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        loaded["model"] = real_load(*a, **kw)
        loaded["s"] = time.perf_counter() - t0
        return loaded["model"]

    def timed_feats(*a, **kw):
        t0 = time.perf_counter()
        res = real_feats(*a, **kw)
        feat_s.append(time.perf_counter() - t0)
        return res

    cli.load_params, cli.whisper_features = timed_load, timed_feats
    torch.cuda.reset_peak_memory_stats()
    # the main path: every launch count is zeroed here and read just after
    attn.flash_attention.launches = dec.decode_attention.launches = 0
    try:
        with count_plain_calls() as plain_calls:
            t0 = time.perf_counter()
            path = cli.main([x for k, v in args.items() for x in (f"--{k}", str(v))])
            cli_s = time.perf_counter() - t0
    finally:
        cli.load_params, cli.whisper_features = real_load, real_feats
    counts = {"K1": attn.flash_attention.launches, "K4": dec.decode_attention.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = [json.loads(ln) for ln in open(path, encoding="utf8")]
    keys = [json.loads(ln)["key"] for ln in open(jsonl)]
    batches = -(-ASR_UTTS // ASR_BATCH)
    ok = ([r["key"] for r in rows] == keys and all(isinstance(r.get("hyp"), str) for r in rows)
          and counts["K1"] == batches * (tower_L + L) and counts["K4"] % L == 0
          and 0 < counts["K4"] <= batches * ASR_NEW * L and not plain_calls)
    print(f"  CLI: {cli_s:.2f} s for {ASR_UTTS} wavs ({loaded['s']:.2f} s loading the export onto "
          f"the card); host features {1e3 * statistics.mean(feat_s):.1f} ms per utterance "
          f"(whisper_features on {args['num_workers']} prefetch threads, {len(feat_s)} calls); "
          f"{path} has {len(rows)} lines, a hyp for every key: "
          f"{[r['key'] for r in rows] == keys}; first hyp {rows[0]['hyp'][:12]!r}; launches "
          f"K1={counts['K1']} (want {batches}x({tower_L} tower + {L} prefill)) K4={counts['K4']} "
          f"({counts['K4'] // L} decode steps x {L}, <= {batches}x{ASR_NEW}); plain versions "
          f"called: {plain_calls or 'none'}; peak {peak:.2f} GiB allocated "
          f"{'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("qwen2 asr: output / launches")
    cer = score_cer(out, write_ark(path, out), failures)

    # the first batch again, outside the CLI: the projected audio, the last
    # prefill's and the first decode step's logits, kernel path against
    # plain_kernels(), and the timings
    model = loaded.pop("model")
    tok = build_tokenizer(TokenizerConfig(**tok_flags))
    samples = [AudioJsonlDataset.load(s) for s in AudioJsonlDataset(str(jsonl)).samples]
    feats, ids = [], []
    for s in samples[:ASR_BATCH]:
        f, mask = cli.whisper_features(s["waveform"], s["sample_rate"], ac.num_mel_bins)
        feats.append(f)
        ids.append(cli.prompt_ids(tok, QWEN2_INSTRUCT, int(mask.sum()), cfg.audio_token_index))
    lens = [len(i) for i in ids]
    lens_t = torch.tensor(lens, device=dev)
    ids = torch.from_numpy(pad_right(ids, 0)).to(dev)
    feats = torch.from_numpy(pad_right(feats, 0.0)).to(dev).transpose(1, 2)

    def prompt_of(m, dtype):
        with torch.no_grad():
            audio = encode_audio(m, feats, cfg, dtype)
            embed = F.embedding(ids, m.language_model.model.embed_tokens.weight)
            return audio, merge_audio_into_text(embed, audio, ids, cfg.audio_token_index)

    def forced(m, prompt, dtype, steps, toks=None):
        """prefill logits and `steps` decode steps' logits (each fed toks[s],
        or greedy from its own logits); the prefill ms and decode ms/step."""
        lm = m.language_model
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, last, Tp = inf.prefill(lm, tc, prompt, lens_t, steps, compute_dtype=dtype)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, fed = [last], []
            for s in range(steps):
                fed.append(logits[-1].argmax(-1) if toks is None else toks[s])
                emb = F.embedding(fed[-1], lm.model.embed_tokens.weight)[:, None]
                logits.append(inf.decode_step(lm, tc, cache, emb, lens_t, Tp, s, dtype))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        return logits, fed, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(steps, 1)

    bf = torch.bfloat16
    audio_k, prompt_k = prompt_of(model, bf)
    tower_ms = time_ms(lambda: prompt_of(model, bf), 5, 1)
    forced(model, prompt_k, bf, 1)  # warm the shapes (not measured)
    logits_k, fed, prefill_ms, step_ms = forced(model, prompt_k, bf, ASR_TIMED_STEPS)
    before = (attn.flash_attention.launches, dec.decode_attention.launches)
    with plain_kernels():
        audio_p, prompt_p = prompt_of(model, bf)
        logits_p = forced(model, prompt_p, bf, 1, fed)[0]
        model32 = empty_model(cfg, torch.float32, dev)
        model32.load_state_dict(model.state_dict())  # the same weights, upcast
        audio_r, prompt_r = prompt_of(model32, torch.float32)
        logits_r = forced(model32, prompt_r, torch.float32, 1, fed)[0]
        del model32, prompt_r
    launched = (attn.flash_attention.launches, dec.decode_attention.launches) != before
    ok = not launched
    for what, got, plain, ref in (("projected audio", audio_k, audio_p, audio_r),
                                  ("last prefill logits", logits_k[0], logits_p[0], logits_r[0]),
                                  ("first decode step logits", logits_k[1], logits_p[1],
                                   logits_r[1])):
        e_k, e_p, e_kp = rel_l2(got, ref), rel_l2(plain, ref), rel_l2(got, plain)
        finite = bool(torch.isfinite(got).all())
        good = finite and e_k <= BF16_NOISE_RATIO * e_p and e_kp <= BF16_PREFILL_RTOL
        ok &= good
        print(f"  first batch {what}: rel_l2 vs the f32 plain path: bf16 kernel {e_k:.3e}, "
              f"bf16 plain {e_p:.3e} (kernel <= {BF16_NOISE_RATIO}x plain); bf16 kernel vs bf16 "
              f"plain {e_kp:.3e} (<= {BF16_PREFILL_RTOL:.0e}); finite={finite} "
              f"{'ok' if good else 'FAIL'}")
    print(f"  first batch (B={ASR_BATCH}, features T={feats.shape[2]}, prompts {min(lens)}-"
          f"{max(lens)}): the plain paths launched no kernel: {not launched}; encode_audio "
          f"(tower, pool, projector) {tower_ms:.1f} ms per batch, prefill {prefill_ms:.1f} ms, "
          f"decode {step_ms:.3f} ms/step (greedy, {ASR_TIMED_STEPS} steps) "
          f"{'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("qwen2 asr: kernel path vs plain path")
    Tp = ids.shape[1]
    S = -(-(Tp + ASR_NEW) // dec.DECODE_BLOCK) * dec.DECODE_BLOCK  # init_cache's capacity
    del model, logits_k, logits_p, logits_r, audio_k, audio_p, audio_r, prompt_k, prompt_p
    torch.cuda.empty_cache()
    k1_rows, k4_rows = qwen2_kernel_rows(attn, dec, dev, failures, card, ASR_BATCH, Tp, lens, S)
    print(f"  phase 12: export {n_bytes} bytes, load {loaded['s']:.2f} s, "
          f"host features {1e3 * statistics.mean(feat_s):.1f} ms/utterance, encode_audio "
          f"{tower_ms:.1f} ms/batch, prefill {prefill_ms:.1f} ms, decode {step_ms:.3f} ms/step, "
          f"CLI {cli_s:.2f} s for {ASR_UTTS} wavs, peak {peak:.2f} GiB, launches K1="
          f"{counts['K1']} K4={counts['K4']}; {cer}  [{card}]")
    return counts, k1_rows, k4_rows


# -- phase 13: kimi_audio's ASR stage (examples/audio/sft/asr/wenetspeech/run.sh stage 4,
# model_type kimi_audio: f32 at batch 1, inference then textnorm and CER) --

KIMI_CONFIG = HERE / "examples/audio/sft/asr/wenetspeech/config/Kimi-Audio-7B.json"
# Kimi-Audio's special tokens: the media markers at the config's ids, blank
# and eos at the ids the reference hardcodes (151666, 151667), the others at
# unused ids below kimia_token_offset; its tokenizer is not in the repo
KIMI_SPECIALS = {"<|im_media_begin|>": 151661, "<|im_media_end|>": 151663,
                 "<|im_kimia_text_blank|>": 151666, "<|im_kimia_text_eos|>": 151667,
                 "<|im_kimia_user_msg_start|>": 151670,
                 "<|im_kimia_assistant_msg_start|>": 151671,
                 "<|im_kimia_speech_ct_id|>": 151672, "<|im_msg_end|>": 151673}
KIMI_EOS = "<|im_kimia_text_eos|>"
KIMI_UTTS, KIMI_BOTH_UTTS = 8, 2
# the recipe's instruct for qwen2_audio and kimi_audio (run.sh:160-164)
STAGE4_INSTRUCT = "Generate the transcription:"


def stage4_argv(model_type: str, model_path, data_list, output_dir) -> list:
    """The flags stage 4 of the SFT recipe passes its ASR CLI
    (examples/audio/sft/asr/wenetspeech/run.sh:156-181), exactly: Kimi in
    f32 at batch 1, the others in bf16 at batch 16; touch_audio's instruct
    empty; no config and no tokenizer flag (the CLI reads both from the
    export)."""
    kimi = model_type == "kimi_audio"
    return ["--model_path", str(model_path), "--model_dtype", "float32" if kimi else "bfloat16",
            "--instruct", "" if model_type == "touch_audio" else STAGE4_INSTRUCT,
            "--data_list", str(data_list), "--output_dir", str(output_dir),
            "--batch_size", "1" if kimi else "16", "--inference_enable_liger_kernel", "true",
            "--num_workers", "16", "--prefetch", "8"]


# relative L2 limit of the kernel path against the plain path, both f32 on
# the same weights (only K1 and K4 differ, each held to 1e-4 max abs alone;
# 60 layers of f32 rounding in another order move the logits by ~1e-5, a
# kernel fault moves them by 1e-2 or more)
KIMI_RTOL = 1e-3


class HostPeak:
    """The most resident memory of this process seen while open, sampled
    every 20 ms from /proc/self/statm (a load's own peak: the process's
    lifetime peak, ru_maxrss, holds the earlier phases')."""

    def __enter__(self):
        import threading

        self.before = self.peak = host_rss()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        return self

    def _run(self):
        while not self.stop.wait(0.02):
            self.peak = max(self.peak, host_rss())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=5)
        self.peak = max(self.peak, host_rss())


def kimi_kernel_rows(attn, dec, dev, failures, card, Tp, S, L, L_mimo) -> tuple:
    """K1 and K4 at the Kimi path's f32 shapes, each against its plain version
    and a library call checked first, bounds at the FP32 peak: (i) the
    tower, B1 T1500 H20 D64 non-causal (SDPA); (j) the prefill of the first
    utterance, B1 T=Tp H28/4 D128 causal (SDPA with enable_gqa); (k) its
    last decode step, G 7 D128, on a main layer and a mimo layer of the
    packed cache (SDPA on a gathered copy of the live columns). Returns
    (K1 rows, K4 rows)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    f32 = torch.float32
    k1_rows, k4_rows = {}, {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f32)

    q, k, v = (randn(1, 1500, 20, 64) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2), None

    k1_case(attn, dev, failures, card, k1_rows,
            "(i) kimi_audio tower: B1 T1500 H20/20 D64 f32 non-causal, library SDPA",
            q, k, v, None, None, False, 0, timed=True, library=sdpa, peak=PEAK_F32_FLOPS)
    q, k, v = randn(1, Tp, 28, 128), randn(1, Tp, 4, 128), randn(1, Tp, 4, 128)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa_gqa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True).transpose(1, 2), None

    k1_case(attn, dev, failures, card, k1_rows,
            f"(j) kimi_audio prefill: B1 T{Tp} H28/4 (G7) D128 f32 causal, library SDPA "
            "(enable_gqa)", q, k, v, None, None, True, 0, timed=True, library=sdpa_gqa,
            peak=PEAK_F32_FLOPS)
    del q, k, v, qt, kt, vt
    for what, layer in (("main layer 0", 0), (f"mimo layer {L + L_mimo - 1}", L + L_mimo - 1)):
        k4_case(dec, dev, gen, failures, card, k4_rows,
                f"(k) kimi_audio decode: B1 H28/4 (G7) D128 S{S} f32, {L + L_mimo} cache rows, "
                f"{what}, prompt {Tp}, step {ASR_NEW}", 1, L + L_mimo, 4, 7, 128, S, [Tp],
                Tp, Tp + ASR_NEW - 1, layer, f32, timed=True, peak=PEAK_F32_FLOPS)
    torch.cuda.empty_cache()
    return k1_rows, k4_rows


def run_kimi_cli(dev, card, failures, tmp: Path, export) -> tuple:
    """Phase 13: kimi_audio's ASR stage (python -m touchnet_tpu_torch.models.
    kimi_audio.inference_kimi_audio, run in-process through its main with the
    recipe's exact stage-4 flags, stage4_argv, plus max_length 64) on
    phase 15's stage-3 export (the recipe's chain: Kimi-Audio-7B at full
    width with phase 15's text and mimo depth, its SFT-trained f32 weights,
    config.json and the char-level tokenizer with Kimi's special ids): f32,
    batch 1, output_type text over 8 synthesised wavs of 1-30 s, then the
    recipe's scoring, then output_type both over 2 of them (the weights
    loaded once: the second run takes the first's model). Checks a hyp for
    every key (and audio codes under both), the launches (K1: the tower's
    layers and the prefill's, over the text stack or both stacks; K4: the
    stack's layers a decode step) and no plain version called; then the
    first utterance outside the CLI, kernel path against plain_kernels() on
    the same f32 weights: the adaptor's output, the last prefill's text
    logits, the first decode step's text and audio logits (dual path) by
    relative L2 <= KIMI_RTOL, the first greedy text tokens equal, the VQ
    codes (plain PyTorch on both paths) counted where they differ; with the
    encode split (tower, tokenizer, adaptor), prefill and decode timings;
    and the kernel rows (i)-(k). Returns (the CLI runs' launches, K1 rows,
    K4 rows)."""
    from touchnet_tpu_torch.models import whisper_encoder
    from touchnet_tpu_torch.models.kimi_audio import generate_kimi_audio as kgen
    from touchnet_tpu_torch.models.kimi_audio import inference_kimi_audio as cli
    from touchnet_tpu_torch.models.kimi_audio import modeling_kimi_audio as km
    from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig
    from touchnet_tpu_torch.models.llama import inference_llama as inf
    from touchnet_tpu_torch.ops import attention as attn
    from touchnet_tpu_torch.ops import decode_attention as dec
    from touchnet_tpu_torch.tokenizer import TokenizerConfig
    from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
    from touchnet_tpu_torch.utils.inference import AudioJsonlDataset

    if export is None:
        print("[13] kimi_audio ASR: no stage-3 export from phase 15 FAIL")
        failures.append("kimi asr: no export")
        return {}, {}, {}
    hf = Path(export)
    cfg = KimiAudioConfig.from_json_file(str(hf / "config.json"))
    tc = cfg.text_config
    full = json.loads(KIMI_CONFIG.read_text())["num_hidden_layers"]
    L, L_mimo = tc.num_hidden_layers, cfg.kimia_mimo_layers
    tower_L = cfg.speech_encoder_config.encoder_layers
    fork = cfg.kimia_mimo_transformer_from_layer_index + 1
    n_bytes = tree_bytes(hf)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print(f"[13] kimi_audio ASR stage (examples/audio/sft/asr/wenetspeech/run.sh stage 4) on "
          f"phase 15's stage-3 export: {KIMI_CONFIG.relative_to(HERE)}: text L={L} (phase 15's "
          f"depth, of {full}) E={tc.hidden_size} H={tc.num_attention_heads}/"
          f"{tc.num_key_value_heads} D={tc.head_dim} V={tc.vocab_size}, mimo {L_mimo} layers "
          f"forked after layer {fork - 1}; tower {tower_L} layers, speech tokenizer "
          f"{cfg.speech_tokenizer_config.quantize_position} layers; "
          f"{km.get_num_params(cfg):,} params, {n_bytes} bytes ({n_bytes / 1e9:.2f} GB) of f32 "
          f"weights loaded in f32 (the recipe's); TF32 for cuBLAS matmuls {tf32[0]}, for cuDNN "
          f"convolutions {tf32[1]} (this script turns both off; the package sets neither)")
    jsonl, total = synth_utterances(tmp / "kimi_wav", KIMI_UTTS, SEED + 41, lo=1.0, hi=30.0)
    both_jsonl = tmp / "kimi_wav" / "both.jsonl"
    both_jsonl.write_text("".join(open(jsonl).readlines()[:KIMI_BOTH_UTTS]))
    print(f"  {KIMI_UTTS} wavs, {total:.1f} s of audio  [{card}]")

    loaded, feat_s = {}, []
    real_load, real_feats = cli.load_params, cli.whisper_features

    def timed_load(*a, **kw):
        with HostPeak() as host:
            t0 = time.perf_counter()
            loaded["model"] = real_load(*a, **kw)
            loaded["s"] = time.perf_counter() - t0
        loaded["host"] = host
        return loaded["model"]

    def timed_feats(*a, **kw):
        t0 = time.perf_counter()
        res = real_feats(*a, **kw)
        feat_s.append(time.perf_counter() - t0)
        return res

    def run(jsonl_path, out, output_type, load):
        """One CLI run on the main path: the launch counts zeroed just before
        and read just after."""
        argv = stage4_argv("kimi_audio", hf, jsonl_path, out) + [
            "--max_length", str(ASR_NEW), "--output_type", output_type]
        cli.load_params, cli.whisper_features = load, timed_feats
        attn.flash_attention.launches = dec.decode_attention.launches = 0
        try:
            with count_plain_calls() as plain_calls:
                t0 = time.perf_counter()
                path = cli.main(argv)
                secs = time.perf_counter() - t0
        finally:
            cli.load_params, cli.whisper_features = real_load, real_feats
        counts = {"K1": attn.flash_attention.launches, "K4": dec.decode_attention.launches}
        return path, secs, counts, plain_calls

    torch.cuda.reset_peak_memory_stats()
    out_text, out_both = tmp / "kimi_out_text", tmp / "kimi_out_both"
    path, cli_s, counts, plain_calls = run(jsonl, out_text, "text", timed_load)
    peak = torch.cuda.max_memory_allocated() / 2**30
    host, load_s = loaded["host"], loaded["s"]
    rows = [json.loads(ln) for ln in open(path, encoding="utf8")]
    keys = [json.loads(ln)["key"] for ln in open(jsonl)]
    steps = counts["K4"] // L
    ok = ([r["key"] for r in rows] == keys and all(isinstance(r.get("hyp"), str) for r in rows)
          and counts["K1"] == KIMI_UTTS * (tower_L + L) and counts["K4"] % L == 0
          and 0 < steps <= KIMI_UTTS * ASR_NEW and not plain_calls)
    print(f"  CLI, output_type text: {cli_s:.2f} s for {KIMI_UTTS} wavs ({load_s:.2f} s "
          f"loading the export onto the card in f32; host RSS {host.before / 1e9:.2f} GB before "
          f"the load, peak {host.peak / 1e9:.2f} GB during it); host features "
          f"{1e3 * statistics.mean(feat_s):.1f} ms per utterance ({len(feat_s)} calls on 16 "
          f"prefetch threads); {path} has {len(rows)} lines, a hyp for every key: "
          f"{[r['key'] for r in rows] == keys}; first hyp {rows[0]['hyp'][:12]!r}; launches "
          f"K1={counts['K1']} (want {KIMI_UTTS}x({tower_L} tower + {L} prefill)) "
          f"K4={counts['K4']} ({steps} decode steps x {L}, <= {KIMI_UTTS}x{ASR_NEW}); plain "
          f"versions called: {plain_calls or 'none'}; peak {peak:.2f} GiB allocated "
          f"{'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("kimi asr text: output / launches")
    cer = score_cer(out_text, write_ark(path, out_text), failures, "kimi asr")

    model = loaded.pop("model")
    feat_text = statistics.mean(feat_s)
    path, both_s, both_counts, plain_calls = run(both_jsonl, out_both, "both",
                                                 lambda *a, **kw: model)
    rows = [json.loads(ln) for ln in open(path, encoding="utf8")]
    Ld = L + L_mimo
    steps_both = both_counts["K4"] // Ld
    codes_ok = all(isinstance(r.get("audio_codes"), list) and
                   all(0 <= c < tc.vocab_size - cfg.kimia_token_offset for c in r["audio_codes"])
                   for r in rows)
    ok = (len(rows) == KIMI_BOTH_UTTS and codes_ok and all(isinstance(r["hyp"], str) for r in rows)
          and both_counts["K1"] == KIMI_BOTH_UTTS * (tower_L + Ld)
          and both_counts["K4"] % Ld == 0 and 0 < steps_both <= KIMI_BOTH_UTTS * ASR_NEW
          and not plain_calls)
    print(f"  CLI, output_type both (the loaded model reused): {both_s:.2f} s for "
          f"{KIMI_BOTH_UTTS} wavs; audio codes per row {[len(r['audio_codes']) for r in rows]}, "
          f"in range: {codes_ok}; launches K1={both_counts['K1']} (want {KIMI_BOTH_UTTS}x"
          f"({tower_L} tower + {Ld} prefill over both stacks)) K4={both_counts['K4']} "
          f"({steps_both} decode steps x {Ld}); plain versions called: {plain_calls or 'none'} "
          f"{'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("kimi asr both: output / launches")
    counts = {k: counts[k] + both_counts[k] for k in counts}

    # the first utterance again, outside the CLI: kernel path against the
    # plain path on the same f32 weights, and the timings
    f32 = torch.float32
    tok = build_tokenizer(TokenizerConfig(tokenizer_type="HuggingFaceTokenizer",
                                          tokenizer_model=str(hf)))
    blank_id, _ = cli.check_special_tokens(tok, cfg)
    s = AudioJsonlDataset.load(AudioJsonlDataset(str(jsonl)).samples[0])
    feats_np, fmask_np = cli.whisper_features(s["waveform"], s["sample_rate"],
                                              cfg.speech_encoder_config.num_mel_bins)
    n_tok = int(fmask_np[::2][::4].sum())
    text_np, audio_np = cli.prompt_streams(tok, STAGE4_INSTRUCT, n_tok, cfg)
    Tp = len(text_np)
    lens = torch.tensor([Tp], device=dev)
    text_ids = torch.from_numpy(text_np[None]).to(dev)
    audio_ids = torch.from_numpy(audio_np[None]).to(dev)
    feats = torch.from_numpy(feats_np[None]).to(dev).transpose(1, 2)
    fmask = torch.from_numpy(fmask_np[None]).to(dev)
    embed_w = model.model.embed_tokens.weight
    blank_emb = embed_w[blank_id]

    def prompt_of():
        """The CLI's encode step: the speech merged into the audio stream
        (the tower, the adaptor, the tokenizer's codes), plus the text
        stream."""
        with torch.no_grad():
            embs = km.prepare_audio_input_embs(model, audio_ids, F.embedding(audio_ids, embed_w),
                                               feats, fmask, cfg, f32)
            return embs + F.embedding(text_ids, embed_w)

    def encode():
        with torch.no_grad():
            return (*km.encode_speech(model, feats, fmask, cfg, f32), prompt_of())

    def text_path(prompt, steps, toks=None):
        """The CLI's text path: prefill over the text stack, then `steps`
        decode steps fed toks[i] (greedy when None) with the audio stream at
        blank; logits, the fed tokens, prefill ms, decode ms/step."""
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, last, Tpad = inf.prefill(model, tc, prompt, lens, steps, compute_dtype=f32)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, fed = [last], []
            for i in range(steps):
                fed.append(logits[-1].argmax(-1) if toks is None else toks[i])
                emb = (F.embedding(fed[-1], embed_w) + blank_emb)[:, None]
                logits.append(inf.decode_step(model, tc, cache, emb, lens, Tpad, i, f32))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        return logits, fed, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(steps, 1)

    def dual_path(prompt, steps, toks=None):
        """Both stacks: prefill, then `steps` decode steps fed the (text,
        audio) pair toks[i] (greedy when None); per step (text, audio)
        logits, the fed pairs, prefill ms, decode ms/step."""
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, tl, al, Tpad = kgen.prefill_dual(model, cfg, prompt, lens, steps,
                                                    compute_dtype=f32)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, fed = [(tl, al)], []
            for i in range(steps):
                pair = ((logits[-1][0].argmax(-1), logits[-1][1].argmax(-1))
                        if toks is None else toks[i])
                fed.append(pair)
                emb = (F.embedding(pair[0], embed_w) + F.embedding(pair[1], embed_w))[:, None]
                tl, al, _ = kgen.forward_step_dual(
                    model, emb, cache, lens + i, cfg, f32, write_pos=Tpad + i,
                    decode_valid=(lens, Tpad, Tpad + i))
                logits.append((tl[:, 0], al[:, 0]))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        return logits, fed, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(steps, 1)

    cont_k, codes_k, prompt_k = encode()
    with torch.no_grad():
        tower_ms = time_ms(lambda: whisper_encoder.forward(
            model.speech_encoder, feats, cfg.speech_encoder_config, compute_dtype=f32,
            causal=False, apply_final_layer_norm=True), 3, 1)
        tok_ms = time_ms(lambda: km.speech_tokenizer_forward(
            model.speech_tokenizer, feats, fmask, cfg.speech_tokenizer_config, f32), 3, 1)
        stacked = torch.randn((1, 375, cfg.kimia_adaptor_input_dim), device=dev)
        adaptor_ms = time_ms(lambda: km.vq_adaptor_forward(model.model.vq_adaptor, stacked,
                                                           tc.rms_norm_eps), 3, 1)
        encode_ms = time_ms(prompt_of, 3, 1)
    text_path(prompt_k, 1)  # warm the shapes (not measured)
    logits_k, fed, prefill_ms, step_ms = text_path(prompt_k, ASR_TIMED_STEPS)
    dual_path(prompt_k, 1)
    dual_k, fed_dual, prefill_both_ms, step_both_ms = dual_path(prompt_k, ASR_TIMED_STEPS)
    before = (attn.flash_attention.launches, dec.decode_attention.launches)
    with plain_kernels():
        cont_p, codes_p, prompt_p = encode()
        logits_p = text_path(prompt_p, 1, fed)[0]
        dual_p = dual_path(prompt_p, 1, fed_dual)[0]
    launched = (attn.flash_attention.launches, dec.decode_attention.launches) != before
    ok = not launched
    for what, got, plain in (("adaptor output", cont_k, cont_p),
                             ("last prefill text logits", logits_k[0], logits_p[0]),
                             ("first decode step text logits", dual_k[1][0], dual_p[1][0]),
                             ("first decode step audio logits", dual_k[1][1], dual_p[1][1])):
        err, finite = rel_l2(got, plain), bool(torch.isfinite(got).all())
        good = finite and err <= KIMI_RTOL
        ok &= good
        print(f"  first utterance {what}: f32 kernel vs f32 plain rel_l2 {err:.3e} "
              f"(<= {KIMI_RTOL:.0e}); finite={finite} {'ok' if good else 'FAIL'}")
    greedy = [int(logits_p[0].argmax(-1)), int(logits_p[1].argmax(-1))]
    same = greedy == [int(fed[0]), int(fed[1])]
    n_codes = int((codes_k != codes_p).sum())
    ok &= same
    print(f"  first utterance (features T={feats.shape[2]}, {n_tok} audio tokens, prompt {Tp}): "
          f"first greedy text tokens kernel {[int(t) for t in fed[:2]]}, plain {greedy}, equal: "
          f"{same}; VQ codes (plain PyTorch on both paths) differing: {n_codes} of "
          f"{codes_k.numel()}; the plain paths launched no kernel: {not launched}; encode "
          f"{encode_ms:.1f} ms (tower {tower_ms:.1f}, speech tokenizer {tok_ms:.1f}, adaptor "
          f"{adaptor_ms:.2f}); text: prefill {prefill_ms:.1f} ms, decode {step_ms:.3f} ms/step; "
          f"both: prefill {prefill_both_ms:.1f} ms, decode {step_both_ms:.3f} ms/step (greedy, "
          f"{ASR_TIMED_STEPS} steps) {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("kimi asr: kernel path vs plain path")
    S = -(-(Tp + ASR_NEW) // dec.DECODE_BLOCK) * dec.DECODE_BLOCK  # init_cache's capacity
    del model, embed_w, blank_emb, logits_k, logits_p, dual_k, dual_p, prompt_k, prompt_p
    del cont_k, cont_p
    torch.cuda.empty_cache()
    k1_rows, k4_rows = kimi_kernel_rows(attn, dec, dev, failures, card, Tp, S, L, L_mimo)
    print(f"  phase 13: phase 15's export {n_bytes} bytes, load {load_s:.2f} s (host "
          f"RSS peak {host.peak / 1e9:.2f} GB), host features {1e3 * feat_text:.1f} "
          f"ms/utterance, encode {encode_ms:.1f} ms (tower {tower_ms:.1f}, tokenizer "
          f"{tok_ms:.1f}, adaptor {adaptor_ms:.2f}), text prefill {prefill_ms:.1f} ms and decode "
          f"{step_ms:.3f} ms/step, both prefill {prefill_both_ms:.1f} ms and decode "
          f"{step_both_ms:.3f} ms/step, CLI {cli_s:.2f} s (text, {KIMI_UTTS} wavs) and "
          f"{both_s:.2f} s (both, {KIMI_BOTH_UTTS} wavs), peak {peak:.2f} GiB, launches "
          f"K1={counts['K1']} K4={counts['K4']}; {cer}  [{card}]")
    return counts, k1_rows, k4_rows


# device kernels of a step, by the part of the port that launches them (the
# first group whose key a kernel's name holds; K3's come before cuBLAS's).
# Both directions of K3 run the mainloop ce_gemm<Op>: its epilogue class,
# which the demangled name holds, says which.
PROFILE_GROUPS = (("K1", ("flash_fwd",)), ("K2", ("dkv_", "dq_mma", "dq_kernel", "delta_kernel")),
                  ("K3 fwd", ("ce_fwd", "RowStatsOp")),
                  ("K3 bwd, TMA + wgmma mainloop (ce_gemm)", ("DlogitsOp", "DhOp", "DwOp")),
                  ("K3 bwd, 64x64 tiles", ("ce_bwd_dlogits", "ce_gemm_")),
                  ("cuBLAS", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
                  ("copies", ("Memcpy", "Memset")))


@contextlib.contextmanager
def model_only_saves():
    """While open, every checkpoint a trainer writes holds the model alone,
    no AdamW moments: the SFT phases' last saves, which only stage 3 reads
    (phase 15's save that its resume reads holds the whole state)."""
    from touchnet_tpu_torch.utils.checkpoint import CheckpointManager

    real = CheckpointManager.save

    def save(self, step, model, optimizer, force=False, before_stage=None):
        return real(self, step, model, {}, force, before_stage)

    CheckpointManager.save = save
    try:
        yield
    finally:
        CheckpointManager.save = real


# -- phase 14: qwen2_audio's SFT stages 0-3 (examples/audio/sft/asr/wenetspeech/run.sh with
# model_type qwen2_audio: make_data, the HF seed, the SFT run, the HF export) --

SFT_STEPS, SFT_MAX_LAYERS = 4, 2
# the whisper tower's depth in phases 14 and 15 (and so in 12 and 13, which
# run their exports): 32 layers cut to 16, then to 8 when phases 18 and 18b
# came, for the script's clock (the steps, the checkpoints, the exports);
# the widths, the vocab and the tower's 1500 frames a row stay
SFT_TOWER_LAYERS = 8
SFT_UTTS, SFT_DEV_UTTS, SFT_PER_SHARD = 200, 16, 25
# the recipe's loader is 12 workers with prefetch 12 (run.sh:22-23): in a
# run of 4 steps they would fill 144 batches of ~40 rows (~5,800 whisper
# features) on threads that take the GIL from the launch thread (phase 10's
# first step: 73 s of loader fill); cut to 2 and 2
SFT_WORKERS = 2
# the kernel-vs-plain check: the first rows of step 1's batch that hold
# 1200 positions (~3 rows; first_step_checked)
SFT_CHECK_SEQLEN = 1200
# the card's share of the step that is not the params, gradients or logits:
# the tower's saved layer inputs under remat full, one layer's recompute
SFT_ACTIVATIONS = 16 * 2**30
# the most the phase puts on disk at once, so that it fits a 45 GiB scratch
# disk whatever the temp dir reports free
SFT_DISK_CAP = 40 * 2**30


def sft_depth(cfg, free: int, card_bytes: int, get_num_params) -> tuple:
    """(text layers, bytes of one checkpoint, disk bytes needed, card bytes
    needed) of phase 14: the most text layers, at most SFT_MAX_LAYERS (a
    checkpoint is 12 bytes a parameter, written at ~1 GB/s), for which the
    temp dir, up to SFT_DISK_CAP, holds one checkpoint (the phase removes
    each step once it is read) and 2 GiB, and the card the f32 params and
    gradients (8 bytes a parameter), the full-logits loss of the recipe's
    2 x 8192 tokens (bf16 logits, their f32 copy and two f32 gradients: 14
    bytes a logit) and SFT_ACTIVATIONS; the tower and the vocab stay full.
    0 layers when none fit."""
    c = copy.deepcopy(cfg)
    logits = 2 * 8192 * cfg.text_config.vocab_size * 14
    for layers in range(min(SFT_MAX_LAYERS, cfg.text_config.num_hidden_layers), 0, -1):
        c.text_config.num_hidden_layers = layers
        n = get_num_params(c)
        ckpt = 12 * n
        disk, card = ckpt + 2**31, 8 * n + logits + SFT_ACTIVATIONS
        if disk <= min(free, SFT_DISK_CAP) and card <= card_bytes:
            return layers, ckpt, disk, card
    return 0, ckpt, disk, card


def sft_argv(listfile, exp, config, tok_dir, dtype="bfloat16", **extra) -> list:
    """The recipe's stage-2 flags (run.sh:76-141, model_type qwen2_audio)
    on one card, with phase 14's cuts: dp 8 -> 1, SFT_STEPS steps (warmup
    2, the recipe's 30000 and 1000 cut), remat none -> full and the AdamW
    moments in host memory (the card's memory), sync checkpoints (the
    recipe's async, so the save is timed whole), a log line every step (the
    recipe's 100), SFT_WORKERS loader workers and prefetch (the recipe's
    12); `extra` (flag: value) adds or replaces flags."""
    args = {
        "tokenizer_type": "HuggingFaceTokenizer", "tokenizer_model": tok_dir,
        "datapipe_type": "qwen2_audio", "datalist_path": listfile,
        "datalist_sharding": "true", "datalist_epoch": 10000, "datalist_shuffling": "true",
        "dataset_shuffling": "true", "dataset_mmap": "true", "dataset_batchsize": 2,
        "dataset_audio_seqlen": 8192, "dataset_text_seqlen": 8192,
        "audio_max_length_in_ms_for_filter": 30000, "audio_min_length_in_ms_for_filter": 200,
        "text_max_length_in_tokens_for_filter": 400, "text_min_length_in_tokens_for_filter": 1,
        "max_text_audio_ratio": 1.0, "min_text_audio_ratio": 0.0005,
        "audio_resample_rate": SR, "audio_speed_perturb": "false",
        "audio_feat_type": "log_mel_spectrogram", "audiofeat_num_mel_bins": 128,
        "audiofeat_n_fft": 400, "audiofeat_hop_length": 160,
        "dataloader_num_workers": SFT_WORKERS, "dataloader_prefetch_factor": SFT_WORKERS,
        "training_description": "wenetspeech asr sft (qwen2_audio)", "training_seed": 2025,
        "training_model_name": "qwen2_audio", "training_model_config_path": config,
        "training_print_args": "true", "training_trace_dump_folder": exp,
        "training_fsdp_reshard_after_forward": "default",
        "training_context_parallel_degree": 1, "training_tensor_parallel_degree": 1,
        "training_data_parallel_shard_degree": 1, "training_pipeline_parallel_degree": 1,
        "training_enable_liger_kernel": "true", "training_enable_ckpt": "true",
        "training_ckpt_load_step": -1, "training_ckpt_interval": 2000,
        "training_ckpt_keep_latest_k": 2, "training_ckpt_async_mode": "disabled",
        "training_log_freq": 1, "training_enable_tensorboard": "true",
        "training_save_tb_folder": "tensorboard", "training_tb_rank_0_only": "true",
        "training_mixed_precision_param": dtype, "training_mixed_precision_reduce": "float32",
        "training_compile": "true", "training_gc_freq": 1000, "training_deterministic": "false",
        "training_max_norm": 1.0, "training_activation_checkpoint_mode": "full",
        "training_enable_profiling": "true", "training_profiling_freq": 100,
        "training_enable_memory_snapshot": "false", "training_enable_cpu_offload": "true",
        "optimizer_name": "AdamW", "optimizer_lr": 2e-5, "optimizer_impl": "fused",
        "lr_scheduler_steps": SFT_STEPS, "lr_scheduler_warmup_steps": 2,
        "lr_scheduler_decay_type": "linear", "lr_scheduler_lr_min": 0.0, **extra,
    }
    return [x for k, v in args.items() for x in (f"--{k}", str(v))]


def sft_stage0(tmp: Path, failures) -> tuple:
    """Stage 0 (run.sh:46-61): seeded synthetic speech (1-15 s, txt in the
    char tokenizer's alphabet) through make_data --datatypes audio+metainfo
    (a subprocess; SFT_PER_SHARD utterances a shard, so each loader worker
    has shards: the recipe's 2000 a shard would make one), a train and a
    dev set, each jsonl copied beside its shards as data.list.raw. Returns
    (train data.list, dev data.list)."""
    from touchnet_tpu_torch.data.dataset import TouchDataset

    lists = []
    for name, count, seed in (("train", SFT_UTTS, SEED + 40), ("dev", SFT_DEV_UTTS, SEED + 41)):
        t0 = time.perf_counter()
        jsonl, total = synth_utterances(tmp / f"sft_{name}_wav", count, seed)
        synth_s = time.perf_counter() - t0
        save = tmp / f"sft_{name}"
        secs = run_cli("touchnet_tpu_torch.bin.make_data",
                       ["--save_dir", save, "--jsonl_path", jsonl, "--num_utt_per_shard",
                        SFT_PER_SHARD, "--num_workers", 8, "--datatypes", "audio+metainfo"],
                       failures, f"qwen2 sft stage 0 ({name})")
        shutil.copy(jsonl, save / "data.list.raw")
        listfile = save / "data.list"
        lines = listfile.read_text().splitlines() if listfile.exists() else []
        n = sum(len(TouchDataset(ln.split()[0], datatypes="audio+metainfo")) for ln in lines)
        ok = n == count and len(lines) == -(-count // SFT_PER_SHARD)
        print(f"  stage 0 ({name}): {count} utterances, {total:.1f} s of audio synthesised in "
              f"{synth_s:.1f} s; make_data (subprocess, 8 workers) -> {len(lines)} shards, "
              f"{tree_bytes(save)} bytes, in {secs:.2f} s; {n} utterances read back, "
              f"data.list.raw beside them {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"qwen2 sft stage 0 ({name})")
        lists.append(listfile)
    return tuple(lists)


def sft_kernel_rows(attn, dev, failures, card, B, L, seg) -> tuple:
    """K2 (l) at the tower's training shape, B rows x T1500 H20/20 D64 bf16
    causal with no segment ids, and K1 and K2 (m) at the text layers'
    training shape, B x L H28/4 D128 bf16 causal with the batch's
    right-padded segment ids (1 on tokens, 0 on padding), each against its
    plain version (one kv head at a time), timed beside FlashAttention-2
    varlen over the same runs. Returns (K1 rows, K2 rows)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    bf = torch.bfloat16
    k1_rows, k2_rows = {}, {}
    k2_case(attn, dev, gen, failures, card, k2_rows,
            f"(l) qwen2_audio tower training: B{B} T1500 H20/20 D64 bf16 causal", B, 1500, 20,
            20, 64, bf, True, None, timed=True, grouped=True)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf)

    name = (f"(m) qwen2_audio text training: B{B} T{L} H28/4 (G7) D128 bf16 causal, "
            f"right-padded rows of {int(seg.sum(1).min())}-{int(seg.sum(1).max())} tokens")
    runs = [e - a for row in seg.cpu().numpy() for _, a, e in seg_runs(row)]
    k1_case(attn, dev, failures, card, k1_rows, name, randn(B, L, 28, 128), randn(B, L, 4, 128),
            randn(B, L, 4, 128), seg, seg, True, 0, timed=True, grouped=True,
            runs=lambda q, k, v: (runs, runs, k, v))
    k2_case(attn, dev, gen, failures, card, k2_rows, name, B, L, 28, 4, 128, bf, True, seg,
            timed=True, grouped=True)
    return k1_rows, k2_rows


def sft_step_split(trace: Path, step_ms: float, card, failures) -> None:
    """The device time of the traced SFT step by kernel group
    (profile_group), each group's share of the step, and the device's busy
    share (kernel time over the step's host time)."""
    try:
        with open(trace) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    except (OSError, ValueError, KeyError) as e:
        print(f"  the traced step: no kernel trace at {trace} ({e!r}) FAIL")
        failures.append("qwen2 sft: trace")
        return
    groups = {}
    for e in events:
        g = profile_group(e["name"])
        groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3
    busy = sum(groups.values())
    print(f"  the traced step (run 1's last, under the profiler): {step_ms:.1f} ms, "
          f"{len(events)} kernels, device busy {busy:.1f} ms ({100 * busy / step_ms:.1f}%): " +
          ", ".join(f"{g} {ms:.1f} ms ({100 * ms / step_ms:.1f}%)"
                    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])) + f"  [{card}]")


def run_qwen2_sft(dev, card, failures, tmp: Path) -> dict:
    """Phase 14: stages 0-3 of the SFT recipe with model_type qwen2_audio on
    one card, Qwen2-Audio-7B at full width (the whisper tower cut to
    SFT_TOWER_LAYERS of its 32 layers, the vocab of 156032) and the text
    depth of sft_depth: make_data over
    synthesised speech; a seeded random bf16 HF directory through
    convert_hf_to_ckpt to step_0; bin.train.main with the recipe's stage-2
    flags (sft_argv) from it, SFT_STEPS steps whose last save holds the
    model alone (phase 15 holds the SFT resume); convert_ckpt_to_hf on that
    save, held to the final params bit for bit (the run removes step_0 once
    its init has read it, so one checkpoint is on disk at a time); step 1's
    first rows on the kernel path against plain_kernels() before its update
    (first_step_checked); K2 (l) and
    K1 and K2 (m). Returns the launches of the run (the main path), the
    kernel rows, the export and the stage-0 lists."""
    from touchnet_tpu_torch.bin import train
    from touchnet_tpu_torch.models import whisper_encoder
    from touchnet_tpu_torch.models.qwen2_audio import convert
    from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import (
        Qwen2AudioConfig,
    )
    from touchnet_tpu_torch.models.qwen2_audio.modeling_qwen2_audio import (
        get_num_params,
        init_params,
    )
    from touchnet_tpu_torch.ops import attention as attn
    from touchnet_tpu_torch.utils.safetensors_io import read_safetensors, write_safetensors

    t_phase = time.perf_counter()
    cfg = Qwen2AudioConfig.from_json_file(str(QWEN2_CONFIG))
    full = cfg.text_config.num_hidden_layers
    free = shutil.disk_usage(tmp).free
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    L, ckpt_bytes, disk, need = sft_depth(cfg, free, card_bytes, get_num_params)
    out = {"counts": {}, "k1": {}, "k2": {}, "export": None, "lists": None}
    if L == 0:
        print(f"[14] qwen2_audio SFT: {free / 1e9:.2f} GB free in the temp dir, too little for "
              "two checkpoints of one text layer FAIL")
        failures.append("qwen2 sft: no room")
        return out
    raw = json.loads(QWEN2_CONFIG.read_text())
    raw["text_config"]["num_hidden_layers"] = L
    tower_full = raw["audio_config"]["encoder_layers"]
    raw["audio_config"]["encoder_layers"] = min(SFT_TOWER_LAYERS, tower_full)
    config = tmp / "qwen2_sft_config.json"
    config.write_text(json.dumps(raw))
    cfg = Qwen2AudioConfig.from_json_file(str(config))
    tc, ac = cfg.text_config, cfg.audio_config
    n_params = get_num_params(cfg)
    print(f"[14] qwen2_audio SFT, stages 0-3 (examples/audio/sft/asr/wenetspeech/run.sh with "
          f"model_type qwen2_audio) on one card: {QWEN2_CONFIG.relative_to(HERE)} at full width "
          f"(tower {ac.encoder_layers} of {tower_full} layers d{ac.d_model}; text E={tc.hidden_size} "
          f"H={tc.num_attention_heads}/{tc.num_key_value_heads} D={tc.head_dim} "
          f"V={tc.vocab_size}), text depth CUT {full} -> {L}; {n_params:,} params; a checkpoint "
          f"~{ckpt_bytes / 1e9:.2f} GB; temp dir {free / 1e9:.2f} GB free, the phase's cap "
          f"{SFT_DISK_CAP / 1e9:.2f} GB ({disk / 1e9:.2f} GB needed), card "
          f"{card_bytes / 1e9:.2f} GB ({need / 1e9:.2f} GB reckoned)")
    print(f"  cuts: dp 8 -> 1 (one card); text layers {full} -> {L} (sft_depth: at most "
          f"{SFT_MAX_LAYERS}, a checkpoint's write time; disk and memory); tower layers "
          f"{tower_full} -> {ac.encoder_layers} (SFT_TOWER_LAYERS, the script's clock); "
          f"{SFT_STEPS} steps of "
          f"30000, warmup 2 of 1000; remat none -> full and the AdamW moments in host memory "
          "(the card's memory); loader 12 workers, prefetch 12 -> "
          f"{SFT_WORKERS}, {SFT_WORKERS} (the loader's fill); checkpoints sync (the recipe's "
          "async), one save, at the last step, holding the model alone (this script skips "
          "the trainer's step-1 save; stage 3 reads nothing else), and no resumed run "
          "(phase 15 holds the SFT resume: the script's clock); log every step (100); the "
          f"profiler traces the last step (freq {SFT_STEPS}; 100); make_data "
          f"{SFT_PER_SHARD} utterances a shard (2000)")

    t0 = time.perf_counter()
    listfile, devlist = sft_stage0(tmp, failures)
    stage0_s = time.perf_counter() - t0

    # stage 1: an HF directory of seeded random bf16 weights -> step_0
    t0 = time.perf_counter()
    exp, hf = tmp / "sft_exp", tmp / "sft_hf"
    hf.mkdir()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 43), torch.bfloat16,
                        dev)
    state = model.state_dict()
    n_bytes = write_safetensors(convert.params_to_hf_state_dict(cfg, state),
                                str(hf / "model.safetensors"))
    (hf / "config.json").write_text(json.dumps(convert.hf_config_dict(cfg, "bfloat16")))
    seed_bits = bits_checksums({k: v.float() for k, v in state.items()})
    del model, state
    torch.cuda.empty_cache()
    secs = run_main("touchnet_tpu_torch.bin.convert_hf_to_ckpt",
                   ["--ckpt_dir", exp, "--huggingface_model", hf, "--training_model_config_path",
                    config, "--model_type", "qwen2_audio"], failures, "qwen2 sft stage 1")
    step0 = exp / "checkpoint" / "step_0"
    print(f"  stage 1: HF seed (random bf16 weights, seed {SEED + 43}) {n_bytes} bytes; "
          f"convert_hf_to_ckpt --model_type qwen2_audio (in-process main) -> step_0, "
          f"{tree_bytes(step0) if step0.exists() else 0} bytes (f32), in {secs:.2f} s; stage 1 "
          f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(hf)  # its tensors are in step_0 now
    tok_dir = write_char_tokenizer(tmp / "sft_tokenizer", tc.vocab_size, QWEN2_SPECIALS,
                                   QWEN2_EOS, QWEN2_INSTRUCT)

    # stage 2: one run, whose last save (the trainer's cadence; its step-1
    # save skipped here) holds the model alone, which stage 3 exports
    counters = kernel_counters()
    steps, devs, init_bits, check = [], [], [], {}
    real = (train.Trainer.train_step, train.Trainer.dev, train.Trainer.train)

    def counted_step(self, batch, num_sentence):
        before = {k: c.launches for k, c in counters.items()}
        res = real[0](self, batch, num_sentence)
        ids = batch["input_ids"]
        steps.append({"launches": {k: c.launches - before[k] for k, c in counters.items()},
                      "rows": ids.shape[0], "L": ids.shape[1],
                      "seg": batch["attention_mask"].cpu() if not steps else None})
        return res

    def counted_dev(self):
        before = {k: c.launches for k, c in counters.items()}
        real[1](self)
        devs.append({k: c.launches - before[k] for k, c in counters.items()})

    def checked_train(self):
        init_bits.append(bits_checksums(self.model.state_dict()))
        # the init has read step_0: off the disk with it
        shutil.rmtree(exp / "checkpoint" / f"step_{self.step}")
        return real[2](self)

    train.Trainer.train_step, train.Trainer.dev, train.Trainer.train = (
        counted_step, counted_dev, checked_train)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        # the main path: every launch count is zeroed here and read after it
        for c in counters.values():
            c.launches = 0
        with count_plain_calls() as plain_calls, timed_saves(train) as saves, \
                saves_where(lambda step, force: force), model_only_saves(), HostPeak() as host, \
                first_step_checked(train, SFT_CHECK_SEQLEN, plain_calls, check):
            t0 = time.perf_counter()
            # the profiler traces the last step (the recipe's freq 100 would
            # trace none of 4)
            run = train.main(sft_argv(listfile, exp, config, tok_dir, datalist_dev_path=devlist,
                                      training_profiling_freq=SFT_STEPS), device=dev)
            run_s = time.perf_counter() - t0
    finally:
        train.Trainer.train_step, train.Trainer.dev, train.Trainer.train = real
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {k: c.launches for k, c in counters.items()}
    hist = run.metrics_processor.history
    dev_hist = run.metrics_processor.dev_history
    pinned = run.offload.pinned_bytes if run.offload is not None else 0
    final = bits_checksums(run.model.state_dict())
    del run
    free_caches()  # page-cache room for stage 3's read-back of the export

    seeded = bool(init_bits) and init_bits[0] == seed_bits
    print(f"  stage 2 starts from step_0: the params at init ({len(seed_bits)} tensors) equal the "
          f"HF tensors upcast to f32 bit for bit: {seeded} {'ok' if seeded else 'FAIL'}")
    if not seeded:
        failures.append("qwen2 sft: not started from the seed")
    report_step_check(check, "qwen2 sft", failures, card)
    tower_p = whisper_encoder.get_num_params(ac)
    text_p = n_params - tower_p
    losses = [h["loss/per_sample"] for h in hist]
    for h, s in zip(hist, steps):
        rows, T = s["rows"], s["L"]
        frames = rows * (3000 // 2)
        tower_tf = frames * (6 * tower_p + 12 * ac.encoder_layers * ac.d_model * 1500) / 1e12
        text_tf = rows * T * (6 * text_p + 12 * tc.num_hidden_layers * tc.num_attention_heads
                              * tc.head_dim * T) / 1e12
        la = s["launches"]
        print(f"  step {h['step']}: loss {h['loss/per_sample']:.4f}, {h['time/step_s'] * 1e3:.1f} "
              f"ms, {h['throughput/tps']:,.0f} label tokens/s, MFU "
              f"{h.get('throughput/mfu_pct', float('nan')):.3f}% (the reference's count: text "
              f"model, label tokens); the tower {tower_tf:.1f} TFLOP and the text model over "
              f"all {rows * T} positions {text_tf:.1f} TFLOP a step "
              f"({(tower_tf + text_tf) / h['time/step_s']:.1f} TFLOP/s); data wait "
              f"{h['time/data_loading_pct']:.1f}%; {rows} rows x {T}; launches K1 {la['K1']} "
              f"K2 {la['K2']} K3 {la['K3 fwd']}+{la['K3 bwd']}  [{card}]")
    want_step = {"K1": 2 * (ac.encoder_layers + L), "K2": ac.encoder_layers + L,
                 "K3 fwd": 0, "K3 bwd": 0}
    ok = (len(steps) == SFT_STEPS and all(s["launches"] == want_step for s in steps)
          and all(d["K1"] > 0 and d["K1"] % (ac.encoder_layers + L) == 0 and d["K2"] == 0
                  and d["K3 fwd"] == d["K3 bwd"] == 0 for d in devs)
          and len(devs) == 1 and not plain_calls
          and len(losses) == SFT_STEPS and all(math.isfinite(x) for x in losses))
    print(f"  launches a step (remat full recomputes the attention): want K1 "
          f"{want_step['K1']} = 2 x ({ac.encoder_layers} tower + {L} text), K2 "
          f"{want_step['K2']}, K3 0; dev pass {devs}; over the run {counts}; plain "
          f"versions called: {plain_calls or 'none'}; losses finite {'ok' if ok else 'FAIL'}")
    print("  K3 stays at 0 launches: the qwen2_audio TrainSpec has no head weight, so the "
          "trainer takes the full-logits pack loss under --training_enable_liger_kernel true, "
          "as the JAX trainer does (touchnet_tpu/bin/train.py:485-498)")
    if not ok:
        failures.append("qwen2 sft: launches / losses")
    # steps 2 and 3: no save, dev pass, set-up or profiler in them
    step_ms = statistics.median(h["time/step_s"] for h in hist[1:SFT_STEPS - 1]) * 1e3
    sft_step_split(exp / "profile_traces" / f"iteration_{SFT_STEPS}" / "trace.json",
                   hist[SFT_STEPS - 1]["time/step_s"] * 1e3, card, failures)
    ckpt = tree_bytes(exp / "checkpoint" / f"step_{SFT_STEPS}")
    ok = sorted(saves) == [SFT_STEPS]
    print(f"  step {step_ms:.1f} ms (the median of steps 2 and 3: no save, dev pass, set-up or "
          f"profiler in them); peak {peak:.2f} GiB allocated; AdamW moments "
          f"{pinned / 1e9:.2f} GB in pinned host memory; the host's resident memory "
          f"{host.before / 1e9:.2f} -> peak {host.peak / 1e9:.2f} GB; dev line "
          f"{[(d['step'], round(d['loss_per_sample'], 4)) for d in dev_hist]}; the last save "
          "(sync, the model alone: stage 3 reads nothing else; phase 15 holds the SFT resume), "
          "the loop blocked " + ", ".join(f"{ms:.1f} ms ({ckpt} bytes in {w:.2f} s)"
                                         for _, (ms, w) in sorted(saves.items())) +
          f"; the run {run_s:.1f} s {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("qwen2 sft: saves")

    # stage 3: the run's last save -> HF (with the tokenizer, as
    # run.sh:144-152 passes --tokenizer_model)
    secs = run_main("touchnet_tpu_torch.bin.convert_ckpt_to_hf",
                   ["--ckpt_dir", exp, "--step", -1, "--config", config, "--model_type",
                    "qwen2_audio", "--tokenizer_model", tok_dir], failures, "qwen2 sft stage 3")
    export = exp / "checkpoint_hf" / f"step-{SFT_STEPS}"
    tensors = read_safetensors(str(export / "model.safetensors"))
    bits = bits_checksums(tensors)
    del tensors
    differ = sorted(k for k in final if bits.get(k) != final[k]) + sorted(set(bits) - set(final))
    exported = Qwen2AudioConfig.from_json_file(str(export / "config.json")).to_dict()
    want_cfg = cfg.to_dict()
    want_cfg["text_config"]["attn_implementation"] = "flash"
    ok = not differ and exported == want_cfg and (export / "tokenizer.json").exists()
    print(f"  stage 3: convert_ckpt_to_hf --step -1 --config --model_type qwen2_audio "
          f"--tokenizer_model (in-process main) -> {export.name}, {tree_bytes(export)} bytes in "
          f"{secs:.2f} s; its {len(bits)} tensors equal the final params bit for bit: "
          f"{not differ} (differ in {differ[:5] or 'none'}); config.json round-trips, the "
          f"tokenizer beside it {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("qwen2 sft: export")
    shutil.rmtree(exp / "checkpoint", ignore_errors=True)

    t0 = time.perf_counter()
    first_step = steps[0]
    k1_rows, k2_rows = sft_kernel_rows(attn, dev, failures, card, first_step["rows"],
                                       first_step["L"], first_step["seg"].to(dev))
    rows_s = time.perf_counter() - t0
    print(f"  phase 14: stage 0 {stage0_s:.1f} s, the run {run_s:.1f} s, kernel rows "
          f"{rows_s:.1f} s, all {time.perf_counter() - t_phase:.1f} s; step {step_ms:.1f} ms, "
          f"peak {peak:.2f} GiB, launches {counts}  [{card}]")
    out.update(counts=counts, k1=k1_rows, k2=k2_rows, export=export,
               lists=(listfile, devlist))
    return out


# -- phase 15: kimi_audio's SFT stages 0-3 (examples/audio/sft/asr/wenetspeech/run.sh with
# model_type kimi_audio: make_data, the HF seed, the SFT run, the HF export) --

# one run of 3 steps whose last saves the model alone (its resumed run, a
# 36.7 GB save at step 1 and its read, went for the script's clock when
# phase 9 went through the launcher); step 2 has no save, dev pass, set-up
# or trace in its time
KIMI_SFT_STEPS, KIMI_SFT_MIMO = 3, 1
# phase 15's most text layers: the disk's clock (a checkpoint is 12 bytes a
# trainable parameter, written at ~0.7 GB/s and read back at ~0.5; 1 layer
# of 28 saves 3 GB a checkpoint against 2)
KIMI_SFT_MAX_LAYERS = 1
# the card's share of the step past the params, gradients, logits and the
# tower's saved layer inputs: one tower layer's recompute at ~70 rows (its
# fc1 and GELU outputs, the f32 LayerNorm copies, ~7.5 GB), the speech
# tokenizer's working set (SCORE_CHUNK_BYTES of scores) and the text layers'
KIMI_SFT_WORKSPACE = 8 * 2**30
# the token budgets the phase tries, the recipe's 2 x 8192 first: the budget
# sets both the logits and the rows, so it is the first cut the card forces
KIMI_SFT_BUDGETS = (2 * 8192, 1 * 8192)
# bytes a logit the port's full-logits pack loss holds at its peak, in the
# backward: the bf16 logits, their f32 copy (saved by logsumexp), exp(x -
# lse), its product with the incoming gradient, the gather's scatter and
# their sum. On an H100 80GB HBM3, 2 x 8192 positions at vocab 168448 ran
# out of memory in that backward with 75.0 GB allocated, asking for 11.0 GB
# more (params 14.1, the tower's saved inputs ~9: >= 22.8 bytes a logit);
# 14 a logit (bf16 logits, an f32 copy, two f32 gradients) reckons it fits
KIMI_SFT_LOGIT_BYTES = 24


def kimi_row_tokens(tok, instruct: str, samples: int, txt: str) -> int:
    """Ids of the text stream dynamic_batch makes of an utterance of
    `samples` 16 kHz samples (at most 30 s): user start, the instruct, a
    blank per audio token (its whisper frames [::2][::4]) and five more,
    the response."""
    frames = max(samples // 160, 1)
    audio = -(-(-(-frames // 2)) // 4)
    ids = tok.tokenize(instruct, add_special_tokens=False)
    return 1 + len(ids) + 1 + audio + 4 + len(tok.tokenize(txt, add_special_tokens=False))


def sft_rows(lengths: list, budget: int, seed: int, trials: int = 64) -> int:
    """The most rows of any batch dynamic_batch's budget rule (the longest
    row times the rows within `budget`) makes of `lengths`, over `trials`
    seeded shuffles of them."""
    rng = np.random.default_rng(seed)
    most = 0
    for _ in range(trials):
        longest, rows = 0, 0
        for n in rng.permutation(lengths):
            longest = max(longest, int(n))
            if longest * (rows + 1) > budget and rows:
                most, longest, rows = max(most, rows), int(n), 0
            rows += 1
        most = max(most, rows)
    return most


def kimi_sft_config(raw: dict, layers: int, mimo: int) -> dict:
    """Kimi-Audio's config dict with `layers` text layers and `mimo` mimo
    layers forked after the last text layer (the fork index layers - 1),
    so the mimo stack stays in the model."""
    out = json.loads(json.dumps(raw))
    out.update(num_hidden_layers=layers, kimia_mimo_layers=mimo,
               kimia_mimo_transformer_from_layer_index=layers - 1)
    return out


def kimi_sft_depth(raw: dict, free: int, card_bytes: int, rows_of) -> dict:
    """Phase 15's cut of Kimi-Audio-7B: the most text layers, at most
    KIMI_SFT_MAX_LAYERS, with KIMI_SFT_MIMO mimo layers, and at those layers the
    first budget of KIMI_SFT_BUDGETS, for which both fit (the widths and the
    vocab stay full; the disk sets the depth, the card the budget first):
      - the disk, up to SFT_DISK_CAP, holds one checkpoint with AdamW
        moments for every trainable tensor (f32 params 4 bytes a parameter,
        mu and nu 8 more; the frozen speech tokenizer has no moments), or
        the last save's model with the f32 export beside it (8 bytes a
        parameter: the last save holds the model alone),
        whichever is larger, and 2 GiB;
      - the card holds the f32 params, gradients where one exists (not the
        tokenizer, not the mimo stack, mimo_norm and mimo_output, which the
        text logits do not reach), the full-logits loss of the budget
        (KIMI_SFT_LOGIT_BYTES a logit),
        the tower's saved layer inputs at the budget's rows (rows_of(budget);
        remat full: bf16, 1500 frames x d_model a layer) and
        KIMI_SFT_WORKSPACE.
    Returns the plan (layers 0 when none fits) with every term in bytes."""
    from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig
    from touchnet_tpu_torch.models.kimi_audio.modeling_kimi_audio import empty_model

    enc = raw["speech_encoder_config"]
    row_bytes = enc["encoder_layers"] * 1500 * enc["d_model"] * 2
    plan = {"layers": 0}
    for layers in range(min(KIMI_SFT_MAX_LAYERS, raw["num_hidden_layers"]), 0, -1):
        cfg = KimiAudioConfig.from_dict(kimi_sft_config(raw, layers, KIMI_SFT_MIMO))
        sizes = {"frozen": 0, "no_grad": 0, "all": 0}
        for name, p in empty_model(cfg, device="meta").named_parameters():
            sizes["all"] += p.numel()
            if name.startswith("speech_tokenizer."):
                sizes["frozen"] += p.numel()
            elif name.startswith(("model.mimo_layers.", "model.mimo_norm.", "mimo_output.")):
                sizes["no_grad"] += p.numel()
        n = sizes["all"]
        ckpt = 4 * n + 8 * (n - sizes["frozen"])
        disk = max(ckpt, 8 * n) + 2**31
        grads = 4 * (n - sizes["frozen"] - sizes["no_grad"])
        for budget in KIMI_SFT_BUDGETS:
            rows = rows_of(budget)
            logits = KIMI_SFT_LOGIT_BYTES * budget * cfg.text_config.vocab_size
            card = 4 * n + grads + logits + rows * row_bytes + KIMI_SFT_WORKSPACE
            plan = dict(layers=layers, budget=budget, rows=rows, params=n, ckpt=ckpt,
                        disk=disk, card=card, grads=grads, logits=logits,
                        tower=rows * row_bytes, **sizes)
            if disk <= min(free, SFT_DISK_CAP) and card <= card_bytes:
                return plan
    plan["layers"] = 0
    return plan


def kimi_sft_argv(listfile, exp, config, tok_dir, budget, dtype="bfloat16", **extra) -> list:
    """The recipe's stage-2 flags with model_type kimi_audio (run.sh:76-141)
    as sft_argv cuts them for phase 14, with phase 15's own: KIMI_SFT_STEPS
    steps, and the token budget `budget` (2 x 8192, or 1 x 8192 when the
    card forces it: dataset_batchsize)."""
    return sft_argv(listfile, exp, config, tok_dir, dtype, **{
        "datapipe_type": "kimi_audio", "training_model_name": "kimi_audio",
        "training_description": "wenetspeech asr sft (kimi_audio)",
        "lr_scheduler_steps": KIMI_SFT_STEPS, "dataset_batchsize": budget // 8192, **extra})


def kimi_sft_rows(attn, dev, failures, card, B) -> tuple:
    """K1 and K2 (n) at the Kimi tower's training shape, B rows x T1500
    H20/20 D64 bf16 non-causal with no segment ids (the last 128-row block
    of 1500 ragged), each against its plain version (one head at a time),
    timed beside FlashAttention-2 varlen over the same rows. Returns (K1
    rows, K2 rows)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 52)
    bf = torch.bfloat16
    k1_rows, k2_rows = {}, {}
    name = f"(n) kimi_audio tower training: B{B} T1500 H20/20 D64 bf16 non-causal"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf)

    k1_case(attn, dev, failures, card, k1_rows, name, randn(B, 1500, 20, 64),
            randn(B, 1500, 20, 64), randn(B, 1500, 20, 64), None, None, False, 0, timed=True,
            grouped=True, runs=lambda q, k, v: ([1500] * B, [1500] * B, k, v))
    k2_case(attn, dev, gen, failures, card, k2_rows, name, B, 1500, 20, 20, 64, bf, False, None,
            timed=True, grouped=True)
    return k1_rows, k2_rows


def kimi_step_split(trainer, batch, card) -> dict:
    """The SFT step's parts, each timed alone (one warm-up, then CUDA events
    over one run) on the trainer's weights and the first step's batch:
    the frozen speech tokenizer's forward; the whisper tower's forward,
    recompute and backward (remat full); the text layers' (with the
    embeddings and the final norm); the lm-head, the full-logits pack loss
    and their backward; the streamed AdamW over every trainable tensor
    (with zero gradients). The parts alone do not add up to the step
    (launch gaps, the merge and the adaptor, the allocator). Returns {part:
    ms}."""
    from touchnet_tpu_torch.models import whisper_encoder
    from touchnet_tpu_torch.models.common import linear
    from touchnet_tpu_torch.models.kimi_audio import modeling_kimi_audio as km
    from touchnet_tpu_torch.ops.fused_adamw import streamed_adamw_step

    model, cfg, ob = trainer.model, trainer.model_config, trainer.opt
    bf = torch.bfloat16
    feats, fmask = batch["whisper_input_features"], batch["whisper_attention_mask"]
    ids = dict(text_input_ids=batch["text_input_ids"], audio_input_ids=batch["audio_input_ids"],
               segment_ids=batch["attention_mask"])
    hidden = km.forward(model, **ids, config=cfg, compute_dtype=bf,
                        return_hidden=True).detach()

    def tokenizer():
        km.speech_tokenizer_forward(model.speech_tokenizer, feats, fmask,
                                    cfg.speech_tokenizer_config, bf)

    def tower():
        whisper_encoder.forward(model.speech_encoder, feats, cfg.speech_encoder_config,
                                compute_dtype=bf, causal=False, apply_final_layer_norm=True,
                                remat_mode="full").float().sum().backward()

    def text_layers():
        km.forward(model, **ids, config=cfg, compute_dtype=bf, remat_mode="full",
                   return_hidden=True).float().sum().backward()

    def loss():
        h = hidden.clone().requires_grad_()
        logits = linear(h, model.lm_head.weight.to(bf))
        trainer.train_spec.loss_fn(logits, batch["labels"], batch["sentence_lens"],
                                   float(batch["labels"].shape[0]))[0].backward()

    def adamw():
        with torch.no_grad():
            streamed_adamw_step([None] * len(trainer.params), trainer.params, trainer.offload,
                                trainer.count, lr=ob.schedule(trainer.count), b1=ob.b1,
                                b2=ob.b2, eps=ob.eps, weight_decay=ob.weight_decay)
        trainer.offload.synchronize()

    out = {}
    for name, fn in (("speech tokenizer (forward)", tokenizer),
                     ("whisper tower (forward, recompute, backward)", tower),
                     ("text layers (forward, recompute, backward)", text_layers),
                     ("lm-head and full-logits loss (forward, backward)", loss),
                     ("AdamW, moments streamed from host memory", adamw)):
        for timed in (False, True):
            for p in model.parameters():
                p.grad = None
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
        out[name] = start.elapsed_time(end)
    for p in model.parameters():
        p.grad = None
    print("  the step's parts, each timed alone on the first step's batch: " +
          ", ".join(f"{n} {ms:.1f} ms" for n, ms in out.items()) + f"  [{card}]")
    return out


def run_kimi_sft(dev, card, failures, tmp: Path, lists) -> dict:
    """Phase 15: stages 0-3 of the SFT recipe with model_type kimi_audio on
    one card, Kimi-Audio-7B at full width (the tower cut to SFT_TOWER_LAYERS
    of its 32 layers, the 16-layer speech tokenizer, the adaptor, hidden
    3584, vocab 168448) cut as
    kimi_sft_depth says: stage 0 is phase 14's (`lists`: the same shards,
    dev list and data.list.raw); a seeded random bf16 HF directory through
    convert_hf_to_ckpt --model_type kimi_audio to step_0; bin.train.main with
    the recipe's stage-2 flags (sft_argv, datapipe and model kimi_audio),
    KIMI_SFT_STEPS steps with one save, at the last, holding the model
    alone (no resumed run since the data- and tensor-parallel slice: the
    script's clock; phases 8 and 10 hold the resume on the card and
    test_torch_kimi_audio_sft.py holds this one on the CPU); after the last step the speech tokenizer bit-equal to
    the seed, the mimo stack equal to the seed times prod(1 - lr_t wd), every
    other tensor moved; convert_ckpt_to_hf on that save, held to the final
    params bit for bit; step 1's first rows on the kernel path against
    plain_kernels() before its update (first_step_checked); K1 and K2 (n).
    Returns the launches of the two runs (the
    main path), the kernel rows and the export."""
    import wave

    from touchnet_tpu_torch.bin import train
    from touchnet_tpu_torch.models import whisper_encoder
    from touchnet_tpu_torch.models.kimi_audio import convert
    from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig
    from touchnet_tpu_torch.models.kimi_audio.modeling_kimi_audio import (
        get_num_params,
        init_params,
    )
    from touchnet_tpu_torch.ops import attention as attn
    from touchnet_tpu_torch.tokenizer import TokenizerConfig
    from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
    from touchnet_tpu_torch.utils.safetensors_io import read_safetensors, write_safetensors

    t_phase = time.perf_counter()
    out = {"counts": {}, "k1": {}, "k2": {}, "export": None}
    raw_full = json.loads(KIMI_CONFIG.read_text())
    full, mimo_full = raw_full["num_hidden_layers"], raw_full["kimia_mimo_layers"]
    tok_dir = write_char_tokenizer(tmp / "kimi_sft_tokenizer", raw_full["vocab_size"],
                                   KIMI_SPECIALS, KIMI_EOS, STAGE4_INSTRUCT)
    t0 = time.perf_counter()
    shared = lists is not None
    listfile, devlist = lists if shared else sft_stage0(tmp, failures)
    stage0_s = time.perf_counter() - t0
    tok = build_tokenizer(TokenizerConfig(tokenizer_type="HuggingFaceTokenizer",
                                          tokenizer_model=str(tok_dir)))
    lengths = []
    for line in open(Path(listfile).parent / "data.list.raw"):
        u = json.loads(line)
        with wave.open(u["wav"]) as w:
            lengths.append(kimi_row_tokens(tok, STAGE4_INSTRUCT, w.getnframes(), u["txt"]))

    def rows_of(budget):
        return sft_rows(lengths, budget, SEED + 53)

    free = shutil.disk_usage(tmp).free
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    plan = kimi_sft_depth(raw_full, free, card_bytes, rows_of)
    L = plan["layers"]
    print(f"[15] kimi_audio SFT, stages 0-3 (examples/audio/sft/asr/wenetspeech/run.sh with "
          f"model_type kimi_audio) on one card: {KIMI_CONFIG.relative_to(HERE)} at full width "
          f"(tower {raw_full['speech_encoder_config']['encoder_layers']} layers, cut to "
          f"{min(SFT_TOWER_LAYERS, raw_full['speech_encoder_config']['encoder_layers'])} for the "
          f"script's clock (SFT_TOWER_LAYERS), d"
          f"{raw_full['speech_encoder_config']['d_model']}; speech tokenizer "
          f"{raw_full['speech_tokenizer_config']['quantize_position']} layers, frozen; text "
          f"E={raw_full['hidden_size']} H={raw_full['num_attention_heads']}/"
          f"{raw_full['num_key_value_heads']} V={raw_full['vocab_size']}); rows of "
          f"{min(lengths)}-{max(lengths)} tokens; the plan (kimi_sft_depth): text layers "
          f"{L}, mimo {KIMI_SFT_MIMO}, budget {plan.get('budget')} tokens, at most "
          f"{plan.get('rows')} rows (the budget rule over 64 shuffles of the train set); "
          f"{plan.get('params', 0):,} params ({plan.get('frozen', 0):,} frozen, "
          f"{plan.get('no_grad', 0):,} with no gradient); disk: a checkpoint "
          f"{plan.get('ckpt', 0) / 1e9:.2f} GB, {plan.get('disk', 0) / 1e9:.2f} GB needed of "
          f"{free / 1e9:.2f} GB free (cap {SFT_DISK_CAP / 1e9:.2f}); card: params "
          f"{4 * plan.get('params', 0) / 1e9:.2f} + gradients {plan.get('grads', 0) / 1e9:.2f} "
          f"+ logits {plan.get('logits', 0) / 1e9:.2f} + the tower's saved inputs "
          f"{plan.get('tower', 0) / 1e9:.2f} + workspace {KIMI_SFT_WORKSPACE / 1e9:.2f} = "
          f"{plan.get('card', 0) / 1e9:.2f} GB of {card_bytes / 1e9:.2f}")
    if L == 0:
        print("  nothing fits the disk and the card FAIL")
        failures.append("kimi sft: no room")
        return out
    raw = kimi_sft_config(raw_full, L, KIMI_SFT_MIMO)
    tower_full = raw_full["speech_encoder_config"]["encoder_layers"]
    raw["speech_encoder_config"] = {**raw_full["speech_encoder_config"],
                                    "encoder_layers": min(SFT_TOWER_LAYERS, tower_full)}
    config = tmp / "kimi_sft_config.json"
    config.write_text(json.dumps(raw))
    cfg = KimiAudioConfig.from_json_file(str(config))
    tc, ec, vq = cfg.text_config, cfg.speech_encoder_config, cfg.speech_tokenizer_config
    budget = plan["budget"]
    print(f"  cuts: dp 8 -> 1 (one card); text layers {full} -> {L} and mimo layers "
          f"{mimo_full} -> {KIMI_SFT_MIMO}, forked after layer {L - 1} (was "
          f"{raw_full['kimia_mimo_transformer_from_layer_index']}), so the mimo stack stays "
          f"and decays without gradient (the disk: 12 bytes a trainable parameter; the "
          f"three vocab-wide matrices alone hold {3 * tc.vocab_size * tc.hidden_size:,}); "
          f"token budget 2 x 8192 -> {budget // 8192} x 8192 "
          f"{'(none: it fits)' if budget == 2 * 8192 else '(the card)'}; {KIMI_SFT_STEPS} "
          f"steps of 30000, warmup 2 of 1000; remat none -> full and the AdamW moments in "
          f"host memory (the card's memory); loader 12 workers, prefetch 12 -> "
          f"{SFT_WORKERS}, {SFT_WORKERS}; checkpoints sync, one save, at the last step, "
          f"holding the model alone (this script skips the trainer's step-1 save; stage 3 "
          f"reads nothing else), and no resumed run (the script's clock); "
          f"log every step (100); run 1's profiler traces its last step; stage 0 "
          f"{'the shards, dev list and data.list.raw of phase 14 (shared)' if shared else 'its own'}")

    # stage 1: an HF directory of seeded random bf16 weights -> step_0
    t0 = time.perf_counter()
    exp, hf = tmp / "kimi_sft_exp", tmp / "kimi_sft_hf"
    hf.mkdir()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 50), torch.bfloat16,
                        dev)
    state = model.state_dict()
    n_bytes = write_safetensors(convert.params_to_hf_state_dict(cfg, state),
                                str(hf / "model.safetensors"))
    (hf / "config.json").write_text(json.dumps(convert.hf_config_dict(cfg, "bfloat16")))
    seed_bits = bits_checksums({k: v.float() for k, v in state.items()})
    mimo_names = [k for k in state
                  if k.startswith(("model.mimo_layers.", "model.mimo_norm.", "mimo_output."))]
    mimo_seed = {k: state[k].cpu() for k in mimo_names}  # bf16, exact in f32
    del model, state
    torch.cuda.empty_cache()
    secs = run_main("touchnet_tpu_torch.bin.convert_hf_to_ckpt",
                   ["--ckpt_dir", exp, "--huggingface_model", hf, "--training_model_config_path",
                    config, "--model_type", "kimi_audio"], failures, "kimi sft stage 1")
    step0 = exp / "checkpoint" / "step_0"
    stage1_s = time.perf_counter() - t0
    print(f"  stage 1: HF seed (random bf16 weights, seed {SEED + 50}) {n_bytes} bytes; "
          f"convert_hf_to_ckpt --model_type kimi_audio (in-process main) -> step_0, "
          f"{tree_bytes(step0) if step0.exists() else 0} bytes (f32), in {secs:.2f} s; stage 1 "
          f"{stage1_s:.1f} s")
    shutil.rmtree(hf)  # its tensors are in step_0 now

    # stage 2: one run, saving its last step (the trainer's cadence) with the
    # model alone, which stage 3 exports
    counters = kernel_counters()
    steps, devs, init_bits, sizes, check = [], [], [], {}, {}
    real = (train.Trainer.train_step, train.Trainer.dev, train.Trainer.train)

    def counted_step(self, batch, num_sentence):
        before = {k: c.launches for k, c in counters.items()}
        torch.cuda.reset_peak_memory_stats()
        res = real[0](self, batch, num_sentence)
        ids = batch["text_input_ids"]
        steps.append({"launches": {k: c.launches - before[k] for k, c in counters.items()},
                      "rows": ids.shape[0], "L": ids.shape[1],
                      "peak": torch.cuda.max_memory_allocated() / 2**30,
                      "batch": batch if not steps else None})
        return res

    def counted_dev(self):
        before = {k: c.launches for k, c in counters.items()}
        real[1](self)
        devs.append({k: c.launches - before[k] for k, c in counters.items()})

    def checked_train(self):
        if not init_bits:
            init_bits.append(bits_checksums(self.model.state_dict()))
        # the init has read the step it started from: off the disk with it
        sizes[self.step] = tree_bytes(exp / "checkpoint" / f"step_{self.step}")
        shutil.rmtree(exp / "checkpoint" / f"step_{self.step}")
        return real[2](self)

    flags = dict(datalist_dev_path=devlist)
    train.Trainer.train_step, train.Trainer.dev, train.Trainer.train = (
        counted_step, counted_dev, checked_train)
    torch.cuda.empty_cache()
    try:
        # the main path: every launch count is zeroed here and read after it
        for c in counters.values():
            c.launches = 0
        with count_plain_calls() as plain_calls, timed_saves(train) as saves:
            t0 = time.perf_counter()
            with HostPeak() as host1, model_only_saves(), \
                    saves_where(lambda step, force: step == KIMI_SFT_STEPS), \
                    first_step_checked(train, SFT_CHECK_SEQLEN, plain_calls, check):
                first = train.main(kimi_sft_argv(listfile, exp, config, tok_dir, budget, **flags,
                                                 training_profiling_freq=KIMI_SFT_STEPS),
                                   device=dev)
            run1_s = time.perf_counter() - t0
            saves1 = dict(saves)
    finally:
        train.Trainer.train_step, train.Trainer.dev, train.Trainer.train = real
    counts = {k: c.launches for k, c in counters.items()}
    hist1 = first.metrics_processor.history
    dev1 = first.metrics_processor.dev_history
    pinned = first.offload.pinned_bytes if first.offload is not None else 0
    lrs = [float(first.opt.schedule(t)) for t in range(KIMI_SFT_STEPS)]
    wd = first.opt.weight_decay
    final_state = first.model.state_dict()
    final = bits_checksums(final_state)
    # after the last step: the tokenizer as seeded, the mimo stack decayed
    # by prod(1 - lr_t wd) (no gradient reaches it), every other tensor moved
    decay = math.prod(1.0 - lr * wd for lr in lrs)
    tok_names = [k for k in final if k.startswith("speech_tokenizer.")]
    tok_same = all(final[k] == seed_bits[k] for k in tok_names)
    mimo_err = max(((final_state[k] - mimo_seed[k].to(dev).float() * decay).abs().max()
                    / mimo_seed[k].float().abs().max().clamp_min(1e-30)).item()
                   for k in mimo_names)
    still = [k for k in final if k not in tok_names and k not in mimo_names
             and final[k] == seed_bits[k]]
    del final_state, mimo_seed
    # the parts of a step, on the trainer (its state is checked above)
    split = kimi_step_split(first, steps[0].pop("batch"), card)
    del first
    free_caches()  # page-cache room for stage 3's read-back of the export

    seeded = bool(init_bits) and init_bits[0] == seed_bits
    print(f"  stage 2 starts from step_0: the params at init ({len(seed_bits)} tensors) equal the "
          f"HF tensors upcast to f32 bit for bit: {seeded} {'ok' if seeded else 'FAIL'}")
    if not seeded:
        failures.append("kimi sft: not started from the seed")
    report_step_check(check, "kimi sft", failures, card)
    ok = tok_same and mimo_err <= 1e-6 and not still
    print(f"  after step {KIMI_SFT_STEPS}: the {len(tok_names)} speech_tokenizer.* tensors "
          f"bit-equal to the seed: {tok_same}; the {len(mimo_names)} mimo tensors (no gradient) "
          f"equal the seed x prod(1 - lr_t wd) = {decay:.9f} (lr_t {lrs}, wd {wd}) within "
          f"{mimo_err:.2e} of their largest value (<= 1e-6, f32 rounding); tensors left at the "
          f"seed among the other {len(final) - len(tok_names) - len(mimo_names)}: "
          f"{still[:5] or 'none'} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("kimi sft: frozen / decayed / moved")
    tower_p = whisper_encoder.get_num_params(ec)
    tok_p = plan["frozen"]
    text_p = get_num_params(cfg) - tower_p - tok_p - plan["no_grad"]
    losses1 = [h["loss/per_sample"] for h in hist1]
    for h, s in zip(hist1, steps):
        rows, T = s["rows"], s["L"]
        tower_tf = rows * 1500 * (6 * tower_p + 12 * ec.encoder_layers * ec.d_model * 1500) / 1e12
        tok_tf = rows * 1500 * (2 * tok_p + 4 * vq.quantize_position * vq.d_model * 1500) / 1e12
        text_tf = rows * T * (6 * text_p + 12 * tc.num_hidden_layers * tc.num_attention_heads
                              * tc.head_dim * T) / 1e12
        la = s["launches"]
        print(f"  step {h['step']}: loss {h['loss/per_sample']:.4f}, {h['time/step_s'] * 1e3:.1f} "
              f"ms, {h['throughput/tps']:,.0f} label tokens/s, MFU "
              f"{h.get('throughput/mfu_pct', float('nan')):.3f}% (the reference's count: text "
              f"and mimo layers, label tokens); the tower {tower_tf:.1f} TFLOP (forward and "
              f"backward), the frozen tokenizer {tok_tf:.1f} (forward) and the text model over "
              f"all {rows * T} positions {text_tf:.1f} TFLOP a step "
              f"({(tower_tf + tok_tf + text_tf) / h['time/step_s']:.1f} TFLOP/s); peak "
              f"{s['peak']:.2f} GiB; data wait {h['time/data_loading_pct']:.1f}%; {rows} rows x "
              f"{T}; launches K1 {la['K1']} K2 {la['K2']} K3 {la['K3 fwd']}+{la['K3 bwd']}  "
              f"[{card}]")
    want_step = {"K1": 2 * (ec.encoder_layers + L), "K2": ec.encoder_layers + L,
                 "K3 fwd": 0, "K3 bwd": 0}
    ok = (len(steps) == KIMI_SFT_STEPS and all(s["launches"] == want_step for s in steps)
          and all(d["K1"] > 0 and d["K1"] % (ec.encoder_layers + L) == 0 and d["K2"] == 0
                  and d["K3 fwd"] == d["K3 bwd"] == 0 for d in devs)
          and len(devs) == 1 and not plain_calls
          and len(losses1) == KIMI_SFT_STEPS and all(math.isfinite(x) for x in losses1))
    print(f"  launches a step (remat full recomputes the attention): want K1 "
          f"{want_step['K1']} = 2 x ({ec.encoder_layers} tower + {L} text), K2 "
          f"{want_step['K2']}, K3 0 (no head weight in the kimi_audio TrainSpec, so the "
          f"full-logits pack loss under --training_enable_liger_kernel true, as the JAX trainer, "
          f"touchnet_tpu/bin/train.py:555-581); the speech tokenizer's block-causal attention is "
          f"plain PyTorch in JAX's dense form, not a kernel; dev passes {devs}; over both runs "
          f"{counts}; plain versions called: {plain_calls or 'none'}; losses finite "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("kimi sft: launches / losses")
    step_ms = hist1[1]["time/step_s"] * 1e3  # step 2: no save, dev pass, set-up or trace
    sft_step_split(exp / "profile_traces" / f"iteration_{KIMI_SFT_STEPS}" / "trace.json",
                   hist1[KIMI_SFT_STEPS - 1]["time/step_s"] * 1e3, card, failures)
    peak = max(s["peak"] for s in steps)
    print(f"  step {step_ms:.1f} ms (step 2: no save, dev pass, set-up or profiler in it); "
          f"peak {peak:.2f} GiB allocated; AdamW moments {pinned / 1e9:.2f} GB in pinned "
          f"host memory (none for the frozen tokenizer); the host's resident memory "
          f"{host1.before / 1e9:.2f} -> peak {host1.peak / 1e9:.2f} GB; dev lines "
          f"{[(d['step'], round(d['loss_per_sample'], 4)) for d in dev1]}  [{card}]")
    sizes[KIMI_SFT_STEPS] = tree_bytes(exp / "checkpoint" / f"step_{KIMI_SFT_STEPS}")
    ok = sorted(saves1) == [KIMI_SFT_STEPS]
    print("  saves (sync), the loop blocked: " + ", ".join(
        f"step {s} {ms:.1f} ms ({sizes[s]} bytes in {w:.2f} s, "
        f"{sizes[s] / max(w, 1e-9) / 1e9:.2f} GB/s)" for s, (ms, w) in sorted(saves1.items())) +
        f" (the model alone); run {run1_s:.1f} s {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("kimi sft: saves")

    # stage 3: the run's last save -> HF, with the tokenizer
    secs = run_main("touchnet_tpu_torch.bin.convert_ckpt_to_hf",
                   ["--ckpt_dir", exp, "--step", -1, "--config", config, "--model_type",
                    "kimi_audio", "--tokenizer_model", tok_dir], failures, "kimi sft stage 3")
    export = exp / "checkpoint_hf" / f"step-{KIMI_SFT_STEPS}"
    tensors = read_safetensors(str(export / "model.safetensors"))
    bits = bits_checksums(tensors)
    del tensors
    differ = sorted(k for k in final if bits.get(k) != final[k]) + sorted(set(bits) - set(final))
    exported = KimiAudioConfig.from_json_file(str(export / "config.json")).to_dict()
    ok = not differ and exported == cfg.to_dict() and (export / "tokenizer.json").exists()
    print(f"  stage 3: convert_ckpt_to_hf --step -1 --config --model_type kimi_audio "
          f"--tokenizer_model (in-process main) -> {export.name}, {tree_bytes(export)} bytes in "
          f"{secs:.2f} s; its {len(bits)} tensors equal the final params bit for bit: "
          f"{not differ} (differ in {differ[:5] or 'none'}); config.json round-trips, the "
          f"tokenizer beside it {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("kimi sft: export")
    shutil.rmtree(exp / "checkpoint", ignore_errors=True)

    t0 = time.perf_counter()
    k1_rows, k2_rows = kimi_sft_rows(attn, dev, failures, card, steps[0]["rows"])
    rows_s = time.perf_counter() - t0
    print(f"  phase 15: stage 0 {stage0_s:.1f} s{' (shared)' if shared else ''}, stage 1 "
          f"{stage1_s:.1f} s, the run {run1_s:.1f} s, stage 3 "
          f"{secs:.1f} s, kernel rows {rows_s:.1f} s, all "
          f"{time.perf_counter() - t_phase:.1f} s; step {step_ms:.1f} ms, peak {peak:.2f} GiB, "
          f"launches {counts}  [{card}]")
    out.update(counts=counts, k1=k1_rows, k2=k2_rows, export=export, split=split)
    return out


# -- phase 18: touch_audio's SFT stages 1-3 (examples/audio/sft/asr/wenetspeech/run.sh with
# model_type touch_audio: the HF seed, the SFT run, the HF export) --

# Touch-Audio-7B's text depth in phase 18, and so in phase 11, which runs its
# export: 2 of 32 layers. A full-depth step holds 8.0 B parameters x 16
# bytes (f32 params, gradients and two moments) = 128 GB against the card's
# 80 (the recipe runs it at dp 8, run.sh:37); at 2 layers the step keeps its
# width, its vocab-wide embedding and head (1.05 B of the 1.49 B parameters)
# and its batches, and a checkpoint of the model is 5.95 GB
TOUCH_SFT_LAYERS, TOUCH_SFT_STEPS = 2, 4
# step 1's kernel-vs-plain check takes the first rows of its batch that hold
# this many positions: the plain K3 keeps [N, V] f32 logits and their
# gradient (2 x 2.1 GB at 4096 rows; at the batch's 16384 rows it ran out of
# an 80 GB H100's memory beside the run's 23.8 GB of state)
TOUCH_CHECK_TOKENS = 4096
# Llama-3's special tokens at their ids (Touch-Audio-7B's backbone is
# Llama-3-8B-shaped; its tokenizer is not in the repo)
TOUCH_BOS, TOUCH_EOS = "<|begin_of_text|>", "<|end_of_text|>"
TOUCH_PAD = "<|finetune_right_pad_id|>"
TOUCH_SPECIALS = {TOUCH_BOS: 128000, TOUCH_EOS: 128001, TOUCH_PAD: 128004}
# the card's features: the SFT recipe's log-mel 128 with the default stack 7
# is 896 wide, Touch-Audio-7B's projector takes 400; fbank 80 x stack 5
# stride 4 is the audio pretraining recipe's (its run.sh:73-78) and 400 wide
TOUCH_FEATS = {"audio_feat_type": "fbank", "audiofeat_num_mel_bins": 80,
               "audiofeat_stack_length": 5, "audiofeat_stride_length": 4}


def touch_sft_argv(listfile, exp, config, tok_dir, **extra) -> list:
    """The recipe's stage-2 flags with model_type touch_audio (sft_argv's,
    which cut dp 8 -> 1, the steps, sync checkpoints, the log cadence and
    the loader), and phase 18's: TOUCH_FEATS, TOUCH_SFT_STEPS steps, and the
    recipe's remat none with the moments on the card (phase 14's full remat
    and host moments are its cuts for the card's memory); `extra` adds or
    replaces flags."""
    return sft_argv(listfile, exp, config, tok_dir, datapipe_type="touch_audio",
                    training_model_name="touch_audio",
                    training_description="wenetspeech asr sft (touch_audio)",
                    training_activation_checkpoint_mode="none",
                    training_enable_cpu_offload="false", lr_scheduler_steps=TOUCH_SFT_STEPS,
                    **TOUCH_FEATS, **extra)


def step_check(trainer, batch, num_sentence: float, tokens: int) -> dict:
    """One step's loss, grad norm and gradients on the first rows of
    `batch` (as many as hold `tokens` positions, at least one; a row a
    sentence, as the dynamic batchers make them) and the trainer's weights,
    no update: in f32 on the plain path (plain_kernels), the reference, then
    on the trainer's own path and the plain path in its compute dtype and on
    its own path in f32. Returns {name: (loss, grad norm)} for "f32 plain",
    "kernel", "plain" and "f32 kernel", and {"e_" + name}: the gradients'
    relative L2 distance to the f32 plain path's (each pass's gradients are
    dropped once compared). .grad is cleared; the kernel launches of the
    comparison are taken back off their counts."""
    from touchnet_tpu_torch.utils.optimizer import global_grad_norm

    rows = max(1, tokens // batch["labels"].shape[1])
    sub = {k: (v[:rows] if torch.is_tensor(v) else v) for k, v in batch.items()}
    counters = kernel_counters()
    launched = {k: c.launches for k, c in counters.items()}
    out, ref = {"rows": rows, "T": batch["labels"].shape[1]}, None
    saved = trainer.compute_dtype
    for name, dtype, route in (("f32 plain", torch.float32, plain_kernels),
                               ("kernel", saved, contextlib.nullcontext),
                               ("plain", saved, plain_kernels),
                               ("f32 kernel", torch.float32, contextlib.nullcontext)):
        trainer.compute_dtype = dtype
        try:
            with route():
                grads, loss, _, _ = trainer._grads_and_metrics(sub, min(num_sentence, rows))
        finally:
            trainer.compute_dtype = saved
        for p in trainer.params:
            p.grad = None
        out[name] = (loss.item(), global_grad_norm(grads).item())
        if ref is None:
            ref = grads
        else:
            out["e_" + name] = grads_rel_l2(grads, ref)
        del grads
    for k, c in counters.items():
        c.launches = launched[k]
    return out


@contextlib.contextmanager
def first_step_checked(train, tokens: int, plain_calls: dict, check: dict):
    """While open, a Trainer's first train_step runs step_check on its batch
    first (`check` gets the result and the peak memory it took); the plain
    versions' calls it makes are taken back off `plain_calls`, which
    count_plain_calls keeps for the run."""
    real = train.Trainer.train_step

    def train_step(self, batch, num_sentence):
        if not check:
            seen = dict(plain_calls)
            torch.cuda.reset_peak_memory_stats()
            check.update(step_check(self, batch, num_sentence, tokens))
            check["peak"] = torch.cuda.max_memory_allocated() / 2**30
            plain_calls.clear()
            plain_calls.update(seen)
        return real(self, batch, num_sentence)

    train.Trainer.train_step = train_step
    try:
        yield
    finally:
        train.Trainer.train_step = real


def report_step_check(check: dict, what: str, failures, card) -> None:
    """step_check's result under phase 8's limits: f32 kernel against f32
    plain (STEP_F32_*), and the run's dtype held to the f32 plain path (its
    loss within STEP_BF16_LOSS, its gradients' error at most
    STEP_BF16_RATIO times the plain path's in that dtype) with its grad norm
    within STEP_F16_GNORM of that plain path's."""
    if not check:
        print(f"  {what}: no kernel-vs-plain check ran FAIL")
        failures.append(f"{what}: kernel vs plain step")
        return
    (fl, fn), (kl, kn), (pl, pn), (f32l, f32n) = (
        check[k] for k in ("f32 plain", "kernel", "plain", "f32 kernel"))
    ok32 = (abs(f32l - fl) / abs(fl) <= STEP_F32_LOSS and abs(f32n - fn) / fn <= STEP_F32_GNORM
            and check["e_f32 kernel"] <= STEP_F32_GRADS)
    e_n = abs(kn - pn) / pn
    ok = (ok32 and abs(kl - fl) <= STEP_BF16_LOSS and math.isfinite(kn) and e_n <= STEP_F16_GNORM
          and check["e_kernel"] <= STEP_BF16_RATIO * check["e_plain"])
    print(f"  {what}: step 1's first {check['rows']} rows x {check['T']} and its weights before "
          f"the update, kernel path vs plain path (phase 8's limits): f32 loss {f32l:.6f} vs "
          f"{fl:.6f} (rel {abs(f32l - fl) / abs(fl):.2e} <= {STEP_F32_LOSS:.0e}), grad norm "
          f"{f32n:.6f} vs {fn:.6f} (rel {abs(f32n - fn) / fn:.2e} <= {STEP_F32_GNORM:.0e}), "
          f"gradients rel L2 {check['e_f32 kernel']:.2e} (<= {STEP_F32_GRADS:.0e}); bf16 loss "
          f"kernel {kl:.6f}, plain {pl:.6f} (|kernel - f32 plain| {abs(kl - fl):.2e} <= "
          f"{STEP_BF16_LOSS:.0e}), grad norm {kn:.6f} vs {pn:.6f} (rel {e_n:.2e} <= "
          f"{STEP_F16_GNORM:.0e}), gradients rel L2 vs f32 plain: kernel "
          f"{check['e_kernel']:.3e}, plain {check['e_plain']:.3e} (kernel <= "
          f"{STEP_BF16_RATIO}x plain); peak {check['peak']:.2f} GiB {'ok' if ok else 'FAIL'}  "
          f"[{card}]")
    if not ok:
        failures.append(f"{what}: kernel vs plain step")


def grads_rel_l2(got: list, want: list) -> float:
    """Relative L2 distance of two gradient lists as one vector."""
    num = sum(((g.float() - w.float()) ** 2).sum() for g, w in zip(got, want) if w is not None)
    den = sum((w.float() ** 2).sum() for w in want if w is not None)
    return math.sqrt(float(num) / float(den))


def run_touch_sft(dev, card, failures, tmp: Path, lists) -> dict:
    """Phase 18: stages 1-3 of the SFT recipe with model_type touch_audio on
    one card, Touch-Audio-7B at full width (E 4096, H 32/8, D 128, MLP 14336,
    V 128256, the projector from 400) and TOUCH_SFT_LAYERS of its 32 text
    layers: stage 0 is phase 14's (`lists`: the same audio+metainfo shards
    and dev list); stage 1, an HF text backbone of seeded random bf16
    weights with its own lm_head through convert_hf_to_ckpt --model_type
    touch_audio to step_0 (the language model at init equal to the HF
    tensors upcast, bit for bit; the projector the converter's draw);
    stage 2, bin.train.main with the recipe's flags (touch_sft_argv: the
    touch_audio datapipe's dynamic batches of right-padded rows under 2 x
    8192 tokens, K3 under --training_enable_liger_kernel true), each step
    launching K1 L, K2 L and K3 once each way; step 1's loss, grad norm and
    gradients against the plain path in bf16 and in f32 on the first rows
    of its batch and its weights before the update (step_check), under
    phase 8's bf16 limits; one save, at
    the last step, holding the model alone; stage 3, convert_ckpt_to_hf
    --tokenizer_model: the export equals the final params bit for bit.
    Returns the run's launches and the export."""
    from touchnet_tpu_torch.bin import train
    from touchnet_tpu_torch.models.llama import convert as llama_convert
    from touchnet_tpu_torch.models.llama import modeling_llama
    from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import (
        TouchAudioConfig,
    )
    from touchnet_tpu_torch.models.touch_audio.modeling_touch_audio import (
        get_num_params,
        kaiming_uniform_init,
    )
    from touchnet_tpu_torch.utils.safetensors_io import read_safetensors, write_safetensors

    t_phase = time.perf_counter()
    raw = json.loads(ASR_CONFIG.read_text())
    full = raw["text_config"]["num_hidden_layers"]
    L = raw["text_config"]["num_hidden_layers"] = min(TOUCH_SFT_LAYERS, full)
    config = tmp / "touch_sft_config.json"
    config.write_text(json.dumps(raw))
    cfg = TouchAudioConfig.from_json_file(str(config))
    tc = cfg.text_config
    n_params = get_num_params(cfg)
    listfile, devlist = lists
    free = shutil.disk_usage(tmp).free
    print(f"[18] touch_audio SFT, stages 1-3 (examples/audio/sft/asr/wenetspeech/run.sh with "
          f"model_type touch_audio) on one card: {ASR_CONFIG.relative_to(HERE)} at full width "
          f"(E={tc.hidden_size} H={tc.num_attention_heads}/{tc.num_key_value_heads} "
          f"D={tc.head_dim} MLP={tc.intermediate_size} V={tc.vocab_size}, untied head; projector "
          f"from {cfg.audio_config.input_size}), text depth CUT {full} -> {L}; {n_params:,} "
          f"params; step_0 and the model's save {4 * n_params / 1e9:.2f} GB each, the HF seed "
          f"{2 * (n_params - tc.hidden_size * cfg.audio_config.input_size) / 1e9:.2f} GB; temp "
          f"dir {free / 1e9:.2f} GB free")
    print(f"  cuts: dp 8 -> 1 (one card); text layers {full} -> {L} (a full-depth step holds "
          f"{get_num_params(TouchAudioConfig.from_json_file(str(ASR_CONFIG))) * 16 / 1e9:.1f} GB "
          f"of f32 params, gradients and moments against the card's 80); features log-mel 128 "
          f"x stack 7 (896 wide, the projector takes 400) -> fbank 80 x stack 5 stride 4 (the "
          f"audio pretraining recipe's, 400 wide); {TOUCH_SFT_STEPS} steps of 30000, warmup 2 "
          f"of 1000; loader 12 workers, prefetch 12 -> {SFT_WORKERS}, {SFT_WORKERS}; "
          f"checkpoints sync, one save, at the last step, holding the model alone (stage 3 "
          f"reads nothing else); log every step (100); stage 0 the shards and dev list of "
          f"phase 14 (shared)")

    # stage 1: an HF text backbone of seeded random bf16 weights -> step_0
    t0 = time.perf_counter()
    exp, hf = tmp / "touch_sft_exp", tmp / "touch_sft_hf"
    hf.mkdir()
    lm = modeling_llama.init_params(tc, torch.Generator(device=dev).manual_seed(SEED + 60),
                                    torch.bfloat16, dev)
    state = llama_convert.params_to_hf_state_dict(tc, lm.state_dict())
    n_bytes = write_safetensors(state, str(hf / "model.safetensors"))
    (hf / "config.json").write_text(json.dumps(llama_convert.hf_config_dict(tc, "bfloat16")))
    seed_bits = bits_checksums({f"language_model.{k}": v.float() for k, v in state.items()})
    # the converter draws the projector from torch.Generator().manual_seed(0)
    seed_bits.update(bits_checksums({"projector.weight": kaiming_uniform_init(
        torch.Generator().manual_seed(0), (tc.hidden_size, cfg.audio_config.input_size))}))
    del lm, state
    torch.cuda.empty_cache()
    secs = run_main("touchnet_tpu_torch.bin.convert_hf_to_ckpt",
                   ["--ckpt_dir", exp, "--huggingface_model", hf, "--training_model_config_path",
                    config, "--model_type", "touch_audio"], failures, "touch sft stage 1")
    step0 = exp / "checkpoint" / "step_0"
    stage1_s = time.perf_counter() - t0
    print(f"  stage 1: HF text backbone (random bf16 weights, seed {SEED + 60}, lm_head apart "
          f"from the embedding) {n_bytes} bytes; convert_hf_to_ckpt --model_type touch_audio "
          f"(in-process main) -> step_0, {tree_bytes(step0) if step0.exists() else 0} bytes (f32), "
          f"in {secs:.2f} s; stage 1 {stage1_s:.1f} s")
    shutil.rmtree(hf)  # its tensors are in step_0 now
    tok_dir = write_char_tokenizer(tmp / "touch_sft_tokenizer", tc.vocab_size, TOUCH_SPECIALS,
                                   TOUCH_EOS, bos=TOUCH_BOS, pad=TOUCH_PAD)

    # stage 2: one run, whose last save holds the model alone
    counters = kernel_counters()
    steps, devs, init_bits, check = [], [], [], {}
    real = (train.Trainer.train_step, train.Trainer.dev, train.Trainer.train)

    def counted_step(self, batch, num_sentence):
        before = {k: c.launches for k, c in counters.items()}
        torch.cuda.reset_peak_memory_stats()
        res = real[0](self, batch, num_sentence)
        steps.append({"launches": {k: c.launches - before[k] for k, c in counters.items()},
                      "rows": batch["input_features"].shape[0],
                      "T": batch["input_features"].shape[1],
                      "padded": int((batch["attention_mask"] == 0).sum()),
                      "peak": torch.cuda.max_memory_allocated() / 2**30})
        return res

    def counted_dev(self):
        before = {k: c.launches for k, c in counters.items()}
        real[1](self)
        devs.append({k: c.launches - before[k] for k, c in counters.items()})

    def checked_train(self):
        init_bits.append(bits_checksums(self.model.state_dict()))
        # the init has read step_0: off the disk with it
        shutil.rmtree(exp / "checkpoint" / f"step_{self.step}")
        return real[2](self)

    train.Trainer.train_step, train.Trainer.dev, train.Trainer.train = (
        counted_step, counted_dev, checked_train)
    torch.cuda.empty_cache()
    try:
        # the main path: every launch count is zeroed here and read after it
        for c in counters.values():
            c.launches = 0
        with count_plain_calls() as plain_calls, timed_saves(train) as saves, \
                saves_where(lambda step, force: force), model_only_saves(), \
                first_step_checked(train, TOUCH_CHECK_TOKENS, plain_calls, check):
            t0 = time.perf_counter()
            run = train.main(touch_sft_argv(listfile, exp, config, tok_dir,
                                            datalist_dev_path=devlist), device=dev)
            run_s = time.perf_counter() - t0
    finally:
        train.Trainer.train_step, train.Trainer.dev, train.Trainer.train = real
    counts = {k: c.launches for k, c in counters.items()}
    hist = run.metrics_processor.history
    dev_hist = run.metrics_processor.dev_history
    final = bits_checksums(run.model.state_dict())
    del run
    free_caches()  # page-cache room for stage 3's read-back of the export

    seeded = bool(init_bits) and init_bits[0] == seed_bits
    print(f"  stage 2 starts from step_0: the params at init ({len(seed_bits)} tensors) equal the "
          f"HF tensors upcast to f32 and the converter's projector, bit for bit: {seeded} "
          f"{'ok' if seeded else 'FAIL'}")
    if not seeded:
        failures.append("touch sft: not started from the seed")
    report_step_check(check, "touch sft", failures, card)
    losses = [h["loss/per_sample"] for h in hist]
    # the model's work over every position a step computes (the metrics
    # line's tokens/s and MFU count label tokens only, as the reference's)
    per_pos = 6 * get_num_params(cfg, exclude_embedding=True)
    for h, s in zip(hist, steps):
        la = s["launches"]
        pos = s["rows"] * s["T"]
        tflop = pos * (per_pos + 12 * L * tc.num_attention_heads * tc.head_dim * s["T"]) / 1e12
        print(f"  step {h['step']}: loss {h['loss/per_sample']:.4f}, {h['time/step_s'] * 1e3:.1f} "
              f"ms, {h['throughput/tps']:,.0f} label tokens/s, MFU "
              f"{h.get('throughput/mfu_pct', float('nan')):.3f}% (the metrics line's); over all "
              f"{pos} positions {tflop:.1f} TFLOP ({tflop / h['time/step_s']:.1f} TFLOP/s, "
              f"{100 * tflop / h['time/step_s'] / (PEAK_BF16_FLOPS / 1e12):.1f}% of the bf16 "
              f"peak); peak {s['peak']:.2f} GiB; data wait {h['time/data_loading_pct']:.1f}%; "
              f"{s['rows']} rows x {s['T']} ({s['padded']} padded positions); launches K1 "
              f"{la['K1']} K2 {la['K2']} K3 {la['K3 fwd']}+{la['K3 bwd']}  [{card}]")
    want_step = {"K1": L, "K2": L, "K3 fwd": 1, "K3 bwd": 1}
    ok = (len(steps) == TOUCH_SFT_STEPS and all(s["launches"] == want_step for s in steps)
          and len(devs) == 1 and devs[0]["K1"] > 0 and devs[0]["K1"] % L == 0
          and devs[0]["K3 fwd"] == devs[0]["K1"] // L and devs[0]["K2"] == devs[0]["K3 bwd"] == 0
          and not plain_calls and len(losses) == TOUCH_SFT_STEPS
          and all(math.isfinite(x) for x in losses))
    print(f"  launches a step (remat none): want K1 {L}, K2 {L}, K3 1 + 1 (the touch_audio "
          f"TrainSpec has a head weight: liger on runs K3, as the JAX trainer's fused loss); "
          f"dev pass {devs}; over the run {counts}; plain versions called in the run: "
          f"{plain_calls or 'none'}; losses finite {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("touch sft: launches / losses")
    # steps 2 to the last but one: no check, save, dev pass or set-up in them
    timed = hist[1:TOUCH_SFT_STEPS - 1]
    step_ms = statistics.median(h["time/step_s"] for h in timed) * 1e3
    tps = statistics.median(h["throughput/tps"] for h in timed)
    mfu = statistics.median(h.get("throughput/mfu_pct", float("nan")) for h in timed)
    wait = statistics.median(h["time/data_loading_pct"] for h in timed)
    ckpt = tree_bytes(exp / "checkpoint" / f"step_{TOUCH_SFT_STEPS}")
    ok = sorted(saves) == [TOUCH_SFT_STEPS]
    print(f"  step {step_ms:.1f} ms, {tps:,.0f} label tokens/s, MFU {mfu:.3f}%, data wait "
          f"{wait:.1f}% (medians of steps 2-{TOUCH_SFT_STEPS - 1}); peak "
          f"{max(s['peak'] for s in steps[1:]):.2f} "
          f"GiB allocated (step 1 {steps[0]['peak']:.2f}); rows a batch "
          f"{[s['rows'] for s in steps]}; dev line "
          f"{[(d['step'], round(d['loss_per_sample'], 4)) for d in dev_hist]}; the last save "
          "(sync, the model alone), the loop blocked " +
          ", ".join(f"{ms:.1f} ms ({ckpt} bytes in {w:.2f} s)"
                    for _, (ms, w) in sorted(saves.items()))
          + f"; the run {run_s:.1f} s {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("touch sft: saves")

    # stage 3: the run's last save -> HF, with the tokenizer (run.sh:144-152)
    t0 = time.perf_counter()
    secs = run_main("touchnet_tpu_torch.bin.convert_ckpt_to_hf",
                   ["--ckpt_dir", exp, "--step", -1, "--config", config, "--model_type",
                    "touch_audio", "--tokenizer_model", tok_dir], failures, "touch sft stage 3")
    shutil.rmtree(exp / "checkpoint", ignore_errors=True)
    export = exp / "checkpoint_hf" / f"step-{TOUCH_SFT_STEPS}"
    tensors = read_safetensors(str(export / "model.safetensors"))
    bits = bits_checksums(tensors)
    del tensors
    differ = sorted(k for k in final if bits.get(k) != final[k]) + sorted(set(bits) - set(final))
    exported = TouchAudioConfig.from_json_file(str(export / "config.json")).to_dict()
    ok = not differ and exported == cfg.to_dict() and (export / "tokenizer.json").exists()
    stage3_s = time.perf_counter() - t0
    print(f"  stage 3: convert_ckpt_to_hf --step -1 --config --model_type touch_audio "
          f"--tokenizer_model (in-process main) -> {export.name}, {tree_bytes(export)} bytes in "
          f"{secs:.2f} s; its {len(bits)} tensors reload equal to the final params bit for bit: "
          f"{not differ} (differ in {differ[:5] or 'none'}); config.json round-trips, the "
          f"tokenizer beside it {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("touch sft: export")
    print(f"  phase 18: stage 1 {stage1_s:.1f} s, stage 2 {run_s:.1f} s, stage 3 {stage3_s:.1f} "
          f"s, all {time.perf_counter() - t_phase:.1f} s; step {step_ms:.1f} ms, launches "
          f"{counts}  [{card}]")
    return {"counts": counts, "export": export}


# -- phase 18b: the ASR closed loop (tests/touchnet_tpu/bin/test_task_metric_loop.py: the SFT
# recipe's stages 0-4 on a tone language, each character a pure tone) --

TONE_CHARS = "一二三四五六"
TONE_HZ = (400, 650, 900, 1150, 1400, 1650)
LOOP_STEPS, LOOP_TRAIN, LOOP_TEST = 200, 96, 8
# JAX's margins (test_task_metric_loop.py:228-232): the seed's weights
# transcribe held-out tones at a CER of at least 60, the trained ones at 50
# or less and below half the seed's
LOOP_CER0_MIN, LOOP_CER_MAX = 60.0, 50.0


def synth_tone(text: str, rng, seconds: float = 0.3) -> np.ndarray:
    """`seconds` of each character's tone, light noise, int16 PCM
    (test_task_metric_loop._synth)."""
    segs = [0.3 * np.sin(2 * np.pi * TONE_HZ[TONE_CHARS.index(ch)]
                         * np.arange(int(SR * seconds)) / SR) for ch in text]
    wav = np.concatenate(segs) if segs else np.zeros(0)
    wav = wav + rng.standard_normal(wav.shape) * 0.005
    return (wav * 32767 * 0.5).astype(np.int16)


def tone_jsonl(root: Path, n: int, rng, prefix: str, extra=(), chars=(3, 6),
               seconds=(0.3, 0.3)) -> str:
    """n utterances of chars[0] to chars[1] - 1 distinct characters with
    their tones of seconds[0]-seconds[1] a character (the defaults and the
    draws' order are test_task_metric_loop._make_jsonl's: the same rng gives
    JAX's utterances), then `extra` (key, seconds, text) ones sounding the
    first character (silence without text), under root with a jsonl of
    {key, wav, txt} lines; returns the jsonl's path."""
    from scipy.io import wavfile

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    utts = []
    for i in range(n):
        k = rng.integers(*chars)
        text = "".join(TONE_CHARS[j] for j in rng.permutation(len(TONE_CHARS))[:k])
        secs = seconds[0] if seconds[0] == seconds[1] else rng.uniform(*seconds)
        utts.append((f"{prefix}{i}", synth_tone(text, rng, secs), text))
    for key, secs, text in extra:
        wav = synth_tone(TONE_CHARS[0], rng, secs) if text else np.zeros(int(SR * secs), np.int16)
        utts.append((f"{prefix}{key}", wav, text))
    with open(root / "data.jsonl", "w", encoding="utf8") as f:
        for key, wav, text in utts:
            wavfile.write(root / f"{key}.wav", SR, wav)
            f.write(json.dumps({"key": key, "wav": str(root / f"{key}.wav"), "txt": text},
                               ensure_ascii=False) + "\n")
    return str(root / "data.jsonl")


def tone_tokenizer_dir(root: Path) -> str:
    """The closed loop's hermetic char-level HF tokenizer
    (test_task_metric_loop._char_tokenizer_dir): [PAD] 0, [BOS] 1, [EOS] 2,
    [UNK] 3, then the tone characters."""
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"[PAD]": 0, "[BOS]": 1, "[EOS]": 2, "[UNK]": 3}
    for ch in TONE_CHARS:
        vocab[ch] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Split(Regex("."), behavior="isolated")
    tok.decoder = decoders.Fuse()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]", bos_token="[BOS]",
                            eos_token="[EOS]", unk_token="[UNK]").save_pretrained(root)
    return str(root)


def decode_and_score(model_dir, config, test_jsonl, tok_dir, work: Path, tag: str,
                     device) -> tuple:
    """Stage 4 on the port (test_task_metric_loop._decode_and_score): the
    touch_audio CLI at JAX's flags (batch 8, 8 new tokens), the part file's
    ref and hyp through textnorm_zh with the recipe's flags, then
    error_rate_zh's char CER. Returns (CER, stats)."""
    from touchnet_tpu_torch.bin.error_rate_zh import score_pairs
    from touchnet_tpu_torch.bin.textnorm_zh import main as textnorm_main
    from touchnet_tpu_torch.models.touch_audio.inference_touch_audio import main as infer_main

    part = infer_main(["--model_path", str(model_dir), "--training_model_config_path",
                       str(config), "--data_list", str(test_jsonl), "--output_dir",
                       str(work / f"out_{tag}"), "--batch_size", "8", "--max_length", "8",
                       "--tokenizer_type", "HuggingFaceTokenizer", "--tokenizer_model", tok_dir],
                      device=device)
    raw = {"ref": work / f"ref_{tag}", "hyp": work / f"hyp_{tag}"}
    with open(part, encoding="utf8") as f, open(raw["ref"], "w", encoding="utf8") as rf, \
            open(raw["hyp"], "w", encoding="utf8") as hf:
        for line in f:
            r = json.loads(line)
            rf.write(f"{r['key']}\t{r['txt']}\n")
            hf.write(f"{r['key']}\t{r['hyp']}\n")
    texts = {}
    for side, path in raw.items():
        textnorm_main(["--to_upper", "--to_banjiao", "--remove_fillers", "--remove_erhua",
                       "--format", "ark", str(path), f"{path}.norm"])
        texts[side] = {}
        for line in open(f"{path}.norm", encoding="utf8"):
            key, _, text = line.rstrip("\n").partition("\t")
            texts[side][key] = text
    return score_pairs([(k, r, texts["hyp"].get(k, "")) for k, r in texts["ref"].items()],
                       tokenizer="char")


def closed_loop(tmp: Path, config, device, steps: int = LOOP_STEPS) -> dict:
    """JAX's closed loop through the port's entry points at world 1 (JAX's
    test runs dp_shard 4 x tp 2): bin.make_data over LOOP_TRAIN tone
    utterances; packed touch_audio SFT for `steps` steps with JAX's flags
    (1 x 256, f32, lr 5e-3, warmup 10, no augmentation, the full-logits
    loss: the flags leave liger off); convert_ckpt_to_hf; then
    decode_and_score of LOOP_TEST held-out utterances on the seed's weights
    (the trainer's own init from training_seed 0) and on the trained
    export. Returns {"cer0", "stats0", "cer", "stats", "train_s", "losses"}."""
    from touchnet_tpu_torch.bin import convert_ckpt_to_hf
    from touchnet_tpu_torch.bin import train
    from touchnet_tpu_torch.bin.make_data import main as make_data
    from touchnet_tpu_torch.models.touch_audio import convert
    from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import (
        TouchAudioConfig,
    )
    from touchnet_tpu_torch.models.touch_audio.modeling_touch_audio import init_params
    from touchnet_tpu_torch.utils.safetensors_io import write_safetensors

    rng = np.random.default_rng(0)
    tok_dir = tone_tokenizer_dir(tmp / "tok")
    train_jsonl = tone_jsonl(tmp / "train", LOOP_TRAIN, rng, "tr")
    test_jsonl = tone_jsonl(tmp / "test", LOOP_TEST, rng, "te")
    make_data(["--save_dir", str(tmp / "shards"), "--jsonl_path", train_jsonl,
               "--num_utt_per_shard", "4", "--num_workers", "1", "--datatypes",
               "audio+metainfo"])
    exp = tmp / "exp"
    args = {
        "tokenizer_type": "HuggingFaceTokenizer", "tokenizer_model": tok_dir,
        "datapipe_type": "touch_audio", "dataset_enable_pack": "true",
        "datalist_path": tmp / "shards" / "data.list", "datalist_epoch": 10000,
        "dataset_batchsize": 1, "dataset_audio_seqlen": 256, "dataset_text_seqlen": 256,
        "audio_min_length_in_ms_for_filter": 10, "audio_speed_perturb": "false",
        "audiofeat_spec_aug": "false", "audiofeat_spec_sub": "false",
        "dataloader_num_workers": 1, "training_model_name": "touch_audio",
        "training_model_config_path": config, "training_trace_dump_folder": exp,
        "training_log_freq": 50, "training_seed": 0,
        "training_mixed_precision_param": "float32",
        "training_activation_checkpoint_mode": "none", "training_enable_ckpt": "true",
        "training_ckpt_interval": steps, "lr_scheduler_steps": steps,
        "lr_scheduler_warmup_steps": 10, "optimizer_lr": 5e-3,
    }
    t0 = time.perf_counter()
    trainer = train.main([x for k, v in args.items() for x in (f"--{k}", str(v))],
                         device=device)
    train_s = time.perf_counter() - t0
    if trainer.step != steps:
        raise RuntimeError(f"closed loop: the run ended at step {trainer.step} of {steps}")
    losses = [h["loss/per_sample"] for h in trainer.metrics_processor.history]
    del trainer
    trained = convert_ckpt_to_hf.main(["--ckpt_dir", str(exp), "--step", str(steps),
                                       "--config", str(config), "--model_type", "touch_audio"])
    mcfg = TouchAudioConfig.from_json_file(str(config))
    seed = init_params(mcfg, torch.Generator(device=device).manual_seed(0), torch.float32, device)
    step0 = tmp / "hf_step0"
    step0.mkdir()
    write_safetensors({k: v.cpu() for k, v in
                       convert.params_to_hf_state_dict(mcfg, seed.state_dict()).items()},
                      str(step0 / "model.safetensors"))
    cer0, stats0 = decode_and_score(step0, config, test_jsonl, tok_dir, tmp, "step0", device)
    cer, stats = decode_and_score(trained, config, test_jsonl, tok_dir, tmp, "trained", device)
    return {"cer0": cer0, "stats0": stats0, "cer": cer, "stats": stats, "train_s": train_s,
            "losses": losses}


def loop_config(root: Path) -> Path:
    """Phase 18b's model: tests/assets/config/tiny_touch_audio.json with its
    width (E 64) in one head of 64 (H 1/1, D 64: K1 and K4 take D 64 and
    128, the tiny config's 16 they refuse); input 161, V 64, 2 layers and
    MLP 128 as there. Written under root."""
    raw = json.loads((HERE / "tests/assets/config/tiny_touch_audio.json").read_text())
    raw["text_config"].update(num_attention_heads=1, num_key_value_heads=1)
    path = root / "loop_config.json"
    path.write_text(json.dumps(raw))
    return path


def run_closed_loop(dev, card, failures, tmp: Path) -> dict:
    """Phase 18b: closed_loop on the card at loop_config's model (f32, as
    JAX's), printing the config, the seconds, both CERs and the launches;
    fails unless JAX's margins hold. K1, K2 and K4 run their f32 bodies
    (JAX's flags leave liger off: K3 does not run). Returns the launches."""
    from touchnet_tpu_torch.ops import attention as attn
    from touchnet_tpu_torch.ops import decode_attention as dec
    from touchnet_tpu_torch.ops import fused_ce

    t0 = time.perf_counter()
    config = loop_config(tmp)
    print(f"[18b] the ASR closed loop (tests/touchnet_tpu/bin/test_task_metric_loop.py) through "
          f"the port's entry points: {LOOP_TRAIN} training and {LOOP_TEST} test utterances of "
          f"the tone language, make_data, packed touch_audio SFT for {LOOP_STEPS} steps with "
          f"JAX's flags (f32, 1 x 256, lr 5e-3), convert_ckpt_to_hf, the CLI, textnorm_zh and "
          f"error_rate_zh on the seed's weights and the trained ones; world 1 (JAX's: dp_shard "
          f"4 x tp 2); the model {config.read_text()} (the tiny config's width in one head of "
          f"64: K1 and K4 take D 64 and 128)")
    counters = {"K1": attn.flash_attention, "K2": attn.flash_attention_bwd,
                "K3 fwd": fused_ce.fused_ce_fwd, "K3 bwd": fused_ce.fused_ce_bwd,
                "K4": dec.decode_attention}
    # the main path: every launch count is zeroed here and read after it
    for c in counters.values():
        c.launches = 0
    out = closed_loop(tmp, config, dev)
    counts = {k: c.launches for k, c in counters.items()}
    cer0, cer = out["cer0"], out["cer"]
    ok = (out["stats0"]["utts"] == out["stats"]["utts"] == LOOP_TEST and cer0 >= LOOP_CER0_MIN
          and cer <= LOOP_CER_MAX and cer < cer0 / 2 and counts["K1"] > 0 and counts["K2"] > 0
          and counts["K4"] > 0)
    print(f"  CER on the seed's weights {cer0:.2f} (>= {LOOP_CER0_MIN:.0f}), trained "
          f"{cer:.2f} (<= {LOOP_CER_MAX:.0f} and < half the seed's); losses every 50 steps "
          f"{[round(x, 4) for x in out['losses']]}; training {out['train_s']:.1f} s; launches "
          f"{counts}; phase {time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("closed loop: margins / launches")
    return counts


def profile_group(kernel: str) -> str:
    return next((g for g, keys in PROFILE_GROUPS if any(k in kernel for k in keys)),
                "elementwise and other")


PROFILE_MODES = ("op_small", "full")  # the recipe's remat, then the one it replaced


def profile_training(dev, card, tmp: Path, steps=2, warmup=2):
    """`python3 chip_smoke.py --profile`: torch.profiler over `steps`
    training steps of phase 8's configuration (1x16384 bf16) under each
    remat mode of PROFILE_MODES, each after `warmup` steps, through the
    Trainer's own train_step on the same batches. Prints, per mode, the
    device time of each group of kernels per step, the device's busy share
    of the window and the peak memory of forward + backward alone and of
    the whole step, side by side, then the twenty largest kernels of the
    first mode."""
    from torch.profiler import ProfilerActivity, profile

    from touchnet_tpu_torch.bin import TrainConfig, train
    from touchnet_tpu_torch.data import DataConfig
    from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
    from touchnet_tpu_torch.tokenizer import TokenizerConfig
    from touchnet_tpu_torch.utils.cli import parse_args_into_dataclasses

    cfg = LlamaConfig.from_json_file(str(CONFIG))
    listfile = write_shards(tmp / "shards", cfg.vocab_size, SEED)
    argv = train_argv(listfile, tmp / "exp", TRAIN_T, steps + warmup, "bfloat16",
                      cfg.vocab_size)
    tok, data, job = parse_args_into_dataclasses([TokenizerConfig, DataConfig, TrainConfig],
                                                 argv)
    trainer = train.Trainer(tok, data, job, dev)
    it = iter(trainer.dataloader)
    batches = [trainer._put_batch(next(it)) for _ in range(steps + warmup)]
    trainer.close()
    results = {}
    for mode in PROFILE_MODES:
        # the step reads the mode from the job config at every forward
        trainer.job_config.training_activation_checkpoint_mode = mode
        for batch, n in batches[:warmup]:
            trainer.train_step(batch, n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch, n in batches[warmup:]:
                trainer.train_step(batch, n)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
        busy, end = 0, -math.inf
        for a, b in spans:  # the union of the kernels' intervals
            busy += max(0, b - max(a, end))
            end = max(end, b)
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
        groups = {}
        for name, us in by_name.items():
            g = profile_group(name)
            groups[g] = groups.get(g, 0) + us
        # where the step's peak memory is set: forward + backward alone,
        # then the whole step (the same, plus clipping and AdamW)
        batch, n = batches[-1]
        torch.cuda.reset_peak_memory_stats()
        trainer._loss_and_acc(batch, n)[0].backward()
        torch.cuda.synchronize()
        fb_peak = torch.cuda.max_memory_allocated() / 2**30
        for p in trainer.params:
            p.grad = None
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step(batch, n)
        torch.cuda.synchronize()
        results[mode] = dict(wall_us=wall_us, busy=busy, n=len(kernels), by_name=by_name,
                             groups=groups, total=sum(by_name.values()), fb_peak=fb_peak,
                             step_peak=torch.cuda.max_memory_allocated() / 2**30)
    print(f"[profile] {steps} steps at 1x{TRAIN_T} bf16 after {warmup} warmups, remat "
          f"{' | '.join(PROFILE_MODES)}  [{card}]")
    print("  ms/step under the profiler: " + " | ".join(
        f"{r['wall_us'] / steps / 1e3:.1f}" for r in results.values()) +
        "; kernels/step: " + " | ".join(f"{r['n'] // steps}" for r in results.values()) +
        "; device busy: " + " | ".join(
            f"{100 * r['busy'] / r['wall_us']:.1f}%" for r in results.values()))
    print("  peak GiB allocated, forward + backward alone: " + " | ".join(
        f"{r['fb_peak']:.2f}" for r in results.values()) + "; the whole step: " + " | ".join(
        f"{r['step_peak']:.2f}" for r in results.values()))
    first = results[PROFILE_MODES[0]]
    names = sorted({g for r in results.values() for g in r["groups"]},
                   key=lambda g: -first["groups"].get(g, 0))
    for g in names:
        print(f"  {g}: " + " | ".join(
            f"{r['groups'].get(g, 0) / steps / 1e3:.1f} ms/step "
            f"({100 * r['groups'].get(g, 0) / r['total']:.1f}%)" for r in results.values()))
    for name, us in sorted(first["by_name"].items(), key=lambda x: -x[1])[:20]:
        print(f"  {us / steps / 1e3:9.2f} ms/step  {name[:110]}")


@contextlib.contextmanager
def variant_library(_build, edits):
    """While open, the kernel wrappers run a library built from a copy of
    ops/csrc with `edits` applied, (file, text, replacement) each, in a
    temporary directory: the checkout is never touched."""
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(csrc, Path(tmp) / "csrc")
        for fname, right, wrong in edits:
            src = Path(tmp) / "csrc" / fname
            text = src.read_text()
            if right not in text:
                raise RuntimeError(f"{right!r} not in {fname}")
            src.write_text(text.replace(right, wrong))
        _build.CSRC, _build.BUILD_DIR, _build._lib = Path(tmp) / "csrc", Path(tmp), None
        try:
            _build.load_library()  # a copy that does not build raises here, never "caught"
            yield
        finally:
            _build.CSRC, _build.BUILD_DIR, _build._lib = csrc, build_dir, None


# faulty copies of the kernels, (name, file, right text, faulty text, which
# check must catch it): each must fail its kernel's check
FAULTS = (
    ("K4 ring reads a tile before its copies land (one stage's wait skipped)",
     "decode_attention.cu", "cp_async_wait<R::kStages - 2>();", "cp_async_wait<R::kStages - 1>();",
     "K4"),
    ("K3 bwd without the dtl term", "fused_ce.cu",
     "if (col == lab) g0 += dtl;\n        if (col + 1 == lab) g1 += dtl;", "", "K3"),
    ("K3 fwd and bwd with a wrong swizzle (TMA tiles unswizzled, wgmma reads them swizzled)",
     "hopper.cuh", "CU_TENSOR_MAP_SWIZZLE_128B,", "CU_TENSOR_MAP_SWIZZLE_NONE,", "K3"),
    ("K3 bwd with the MN-major descriptor's LBO and SBO swapped", "fused_ce.cu",
     "wgmma_desc(tile + ks * 2048, 8192, 1024)", "wgmma_desc(tile + ks * 2048, 1024, 8192)", "K3"),
    ("K3 fwd whose lane merge takes the larger index on a tie", "fused_ce.cu",
     "(mo == m && ao < ai)", "(mo == m && ao > ai)", "K3"),
    ("K3 fwd without the rescale of the running sum to a new max", "fused_ce.cu",
     "l[i] = l[i] * exp2f((m[i] - mn) * kLog2e) + sum;", "l[i] = l[i] + sum;", "K3"),
)


def check_faults(_build, dev, card) -> int:
    """`python3 chip_smoke.py --faults`: every fault of FAULTS, built into
    its own library (variant_library), must fail phase 4 (K4) or phase 7
    (K3), timings skipped. Exits 1 if a fault passes."""
    from touchnet_tpu_torch.ops import decode_attention as dec
    from touchnet_tpu_torch.ops import fused_ce

    checks = {"K4": lambda f: check_k4(dec, dev, torch.Generator(device=dev).manual_seed(SEED),
                                       f, card, timing=False),
              "K3": lambda f: check_k3(fused_ce, dev, torch.Generator(device=dev).manual_seed(SEED),
                                       f, card, timing=False)}
    missed = []
    for name, fname, right, wrong, which in FAULTS:
        print(f"[faults] {name}: {fname} with {wrong!r}")
        failures = []
        with variant_library(_build, [(fname, right, wrong)]):
            try:
                checks[which](failures)
            except Exception as e:  # a faulty kernel may also raise: caught
                failures.append(f"raised {type(e).__name__}: {e}")
            torch.cuda.synchronize()
        print(f"[faults] {name}: {'caught' if failures else 'NOT CAUGHT'} "
              f"({len(failures)} failed checks: {failures[:4]})")
        if not failures:
            missed.append(name)
    if missed:
        print(f"chip_smoke --faults FAILED: not caught {missed}", file=sys.stderr)
        return 1
    print(f"[faults] every fault caught  [{card}]")
    return 0


# the design choices --tune measures: K4's ring depth (with its split
# budget); K3's mainloop ring depth (both directions), the dlogits
# epilogue's exponential and grid order (source edits); and K3 forward's
# vocab splits and raster group at N16384 (plan fields, no rebuild)
K4_TUNE_STAGES = (3, 4, 6, 6, 4, 3)  # twice, in mirrored order: the spread shows
K4_TUNE_BLOCKS_PER_SM = (8, 16, 32)
K3_TUNE = {
    "committed": [],
    "3 stages": [("fused_ce.cu", "kGemmStages = 4;", "kGemmStages = 3;")],
    "ex2.approx in the dlogits epilogue": [
        ("fused_ce.cu", "float g0 = dlse * exp2f(", "float g0 = dlse * fast_exp2("),
        ("fused_ce.cu", "float g1 = dlse * exp2f(", "float g1 = dlse * fast_exp2(")],
    "dlogits grid with vocab tiles fastest": [
        ("fused_ce.cu", "return {(int)blockIdx.x, (int)blockIdx.y, 1}; }",
         "return {(int)blockIdx.y, (int)blockIdx.x, 1}; }"),
        ("fused_ce.cu", "dim3(rt, vt_n)", "dim3(vt_n, rt)")],
}
K3_FWD_PLANS = {  # fields of fused_ce.FwdPlan replaced in the committed plan
    "committed plan": {},
    "32 splits of 16 tiles": {"splits": 32},
    "9 splits of 56 tiles": {"splits": 9},
    "72 splits of 7 tiles": {"splits": 72},
    "raster group 128 (row tiles fastest over the whole grid)": {"group": 128},
    "raster group 8": {"group": 8},
}


def ptxas_report(_build, sources=("decode_attention.cu", "fused_ce.cu")) -> None:
    """Registers, spills and static shared memory of every kernel of
    `sources`, as `nvcc -Xptxas -v` reports them with the build's flags."""
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            res = subprocess.run(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 str(Path(tmp) / "k.o"), str(_build.CSRC / src)],
                capture_output=True, text=True, check=True, timeout=600)
            kernel = None
            for line in (res.stdout + res.stderr).splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1]
                elif kernel and ("registers" in line or "spill" in line):
                    print(f"[ptxas] {src} {kernel}: {line.split(':', 1)[-1].strip()}")


def tune(_build, dev, card) -> int:
    """`python3 chip_smoke.py --tune`: the kernels' registers (ptxas_report),
    then times the variants above at the main paths' shapes (K4 case (a),
    K3 forward and backward at N16384), each source variant built with
    variant_library, in one process on one card; prints each variant's
    median ms and whether it gives the committed variant's bits."""
    from touchnet_tpu_torch.ops import decode_attention as dec
    from touchnet_tpu_torch.ops import fused_ce

    ptxas_report(_build)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, L, Hkv, G, D, S, base, last, layer = 32, 16, 8, 4, 64, 8192, 7936, 8000, 7
    q = torch.randn((B, Hkv * G, D), generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn((L, B, Hkv, S, 2 * D), generator=gen, device=dev, dtype=torch.bfloat16)
    plen = torch.randint(2048, 8192, (B,), generator=torch.Generator().manual_seed(SEED))
    plen = plen.to(device=dev, dtype=torch.int32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    saved = dec._SPLIT_BLOCKS_PER_SM
    ref = None
    for stages in K4_TUNE_STAGES:
        edit = ("decode_attention.cu", "static constexpr int kStages = 3;",
                f"static constexpr int kStages = {stages};")
        with variant_library(_build, [edit]):
            for per_sm in K4_TUNE_BLOCKS_PER_SM:
                dec._SPLIT_BLOCKS_PER_SM = per_sm
                out = dec.decode_attention(q, kv, plen, base, last, layer_idx=layer)
                ref = out if ref is None else ref
                # ~0.2 ms a launch: a second of launches first, so the card
                # is at its clocks after the variant's build, then 101 timed
                time_ms(lambda: dec.decode_attention(q, kv, plen, base, last, layer_idx=layer),
                        1, 5000)
                ms = time_ms(lambda: dec.decode_attention(q, kv, plen, base, last,
                                                          layer_idx=layer), 101, 20)
                diff = (out.float() - ref.float()).abs().max().item()
                print(f"[tune] K4 (a): {stages}-stage ring, splits for {per_sm} blocks/SM "
                      f"(cols, nsplit) {dec.split_plan(B, Hkv, S, sms)}: {ms:.4f} ms; "
                      f"max diff to the first variant {diff:.2e}  [{card}]")
        dec._SPLIT_BLOCKS_PER_SM = saved
    del kv
    N, E, V = TRAIN_T, 2048, 128256
    h = torch.randn((N, E), generator=gen, device=dev).to(torch.bfloat16)
    w = (0.02 * torch.randn((V, E), generator=gen, device=dev)).to(torch.bfloat16)
    labels = torch.randint(0, V, (N,), generator=gen, device=dev, dtype=torch.int32)
    lse = fused_ce.fused_ce_fwd(h, w, labels)[0]
    dlse = torch.full((N,), 1.0 / N, device=dev)
    ref = None
    for name, edits in K3_TUNE.items():
        with variant_library(_build, edits):
            out = fused_ce.fused_ce_bwd(h, w, labels, lse, dlse, -dlse)
            fwd = fused_ce.fused_ce_fwd(h, w, labels)
            ref = (out, fwd) if ref is None else ref
            same = all(torch.equal(a, b) for a, b in zip(out, ref[0]))
            same_f = all(torch.equal(a, b) for a, b in zip(fwd, ref[1]))
            ms = time_ms(lambda: fused_ce.fused_ce_bwd(h, w, labels, lse, dlse, -dlse), 5)
            fms = time_ms(lambda: fused_ce.fused_ce_fwd(h, w, labels))
            print(f"[tune] K3 N{N} E{E} V{V}, {name}: bwd {ms:.3f} ms, fwd {fms:.3f} ms; same "
                  f"bits as the committed variant: bwd {same}, fwd {same_f}  [{card}]")
    real = fused_ce.fwd_plan
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = list(K3_FWD_PLANS.items())
    for name, fields in plans + plans[::-1]:  # twice, in mirrored order
        plan = real(N, E, V, torch.bfloat16, sms)._replace(**fields)
        fused_ce.fwd_plan = lambda *a: plan
        try:
            out = fused_ce.fused_ce_fwd(h, w, labels)
            ms = time_ms(lambda: fused_ce.fused_ce_fwd(h, w, labels))
        finally:
            fused_ce.fwd_plan = real
        diff = max((a - b).abs().max().item() for a, b in zip(out[:3], ref[1][:3]))
        print(f"[tune] K3 fwd N{N} E{E} V{V}, {name} ({plan.splits} splits of "
              f"{fused_ce.split_run(plan, V, 0)[1]} tiles, raster group {plan.group}): "
              f"{ms:.3f} ms; statistics within {diff:.2e} of the committed plan's, argmax "
              f"equal: {torch.equal(out[3], ref[1][3])}  [{card}]")
    return 0


def run_audio_phases(dev, card, failures) -> tuple:
    """Phases 10, 14, 12, 15, 13, 18, 11 and 18b, in this order: 10 in a
    temporary directory of its own, the SFT recipe's chains in one: 14
    (qwen2_audio's stages 0-3), 12 (its stage 4 on 14's export, once the
    checkpoints are gone), 15 (kimi_audio's stages 1-3 on 14's stage-0
    shards, once 14's export is gone), 13 (its stage 4 on 15's export), 18
    (touch_audio's stages 1-3 on the same shards, once 15's export is gone)
    and 11 (its stage 4 on 18's export); then 18b, the closed loop, in a
    directory of its own. Returns their launch counts and the kernel rows
    of phases 12-15."""
    with phase_clock("phase 10"), tempfile.TemporaryDirectory() as tmp:
        audio_counts = run_audio_recipe(dev, card, failures, Path(tmp))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        with phase_clock("phase 14"):
            sft = run_qwen2_sft(dev, card, failures, Path(tmp))
        torch.cuda.empty_cache()
        with phase_clock("phase 12"):
            qwen2_counts, k1_rows, k4_rows = run_qwen2_cli(dev, card, failures, Path(tmp),
                                                           sft["export"])
            shutil.rmtree(Path(tmp) / "sft_exp", ignore_errors=True)  # the disk, for 15
        torch.cuda.empty_cache()
        with phase_clock("phase 15"):
            kimi_sft = run_kimi_sft(dev, card, failures, Path(tmp), sft["lists"])
        torch.cuda.empty_cache()
        with phase_clock("phase 13"):
            kimi_counts, k1_kimi, k4_kimi = run_kimi_cli(dev, card, failures, Path(tmp),
                                                         kimi_sft["export"])
            shutil.rmtree(Path(tmp) / "kimi_sft_exp", ignore_errors=True)  # the disk, for 18
        torch.cuda.empty_cache()
        with phase_clock("phase 18"):
            touch = (run_touch_sft(dev, card, failures, Path(tmp), sft["lists"])
                     if sft["lists"] is not None else {"counts": {}, "export": None})
        torch.cuda.empty_cache()
        with phase_clock("phase 11"):
            asr_counts = run_asr_cli(dev, card, failures, Path(tmp), touch["export"])
    torch.cuda.empty_cache()
    with phase_clock("phase 18b"), tempfile.TemporaryDirectory() as tmp:
        loop_counts = run_closed_loop(dev, card, failures, Path(tmp))
    torch.cuda.empty_cache()
    for rows in (k1_kimi, sft["k1"], kimi_sft["k1"]):
        k1_rows.update(rows)
    k4_rows.update(k4_kimi)
    return {"audio recipe": audio_counts, "ASR CLI": asr_counts, "qwen2_audio ASR": qwen2_counts,
            "kimi_audio ASR": kimi_counts, "qwen2_audio SFT": sft["counts"],
            "kimi_audio SFT": kimi_sft["counts"], "touch_audio SFT": touch["counts"],
            "closed loop": loop_counts}, k1_rows, {**sft["k2"], **kimi_sft["k2"]}, k4_rows


def kernels_line(counts, k1, k2, k3, k4) -> dict:
    """The JSON line of the kernels: a row each for K1, K2, K3 (forward,
    backward) and K4 with its launches over the main paths (`counts`) and
    the numbers of its case at the main path's shape, every timed case
    under "cases"."""
    def row(name, source, replaces, launches, cases, main_case):
        (main,) = [v for n, v in cases.items() if n.startswith(main_case)]
        return {"name": name, "route": "cuda", "source": f"touchnet_tpu_torch/ops/csrc/{source}",
                "replaces": replaces, "launches": launches,
                **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "tflops", "gemm_ms", "parts")
                   if k in main},
                "cases": cases}

    return {"kernels": [
        row("flash_attention_fwd (K1)", "flash_attention.cu",
            "touchnet_tpu/ops/attention.py:269", counts["K1"], k1, "(d)"),
        row("flash_attention_bwd (K2: delta, dkv, dq)", "flash_attention_bwd.cu",
            "touchnet_tpu/ops/attention.py:778", counts["K2"], k2, "(d)"),
        row("fused_ce_fwd (K3 forward: TMA + wgmma mainloop, ce_gemm<RowStatsOp>, and the "
            "combine)", "fused_ce.cu", "touchnet_tpu/ops/fused_ce.py:86",
            counts["K3 fwd"], {n: v["fwd"] for n, v in k3.items()}, "(d)"),
        row("fused_ce_bwd (K3 backward: TMA + wgmma mainloop, ce_gemm)", "fused_ce.cu",
            "touchnet_tpu/ops/fused_ce.py:175", counts["K3 bwd"],
            {n: v["bwd"] for n, v in k3.items()}, "(d)"),
        row("flash_decode (K4: cp.async ring into mma.sync, decode_mma_kernel, and the "
            "combine)", "decode_attention.cu", "touchnet_tpu/ops/decode_attention.py:85",
            counts["K4"], k4, "(a)"),
    ]}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import touchnet_tpu_torch
    from touchnet_tpu_torch.ops import _build
    from touchnet_tpu_torch.ops import attention as attn
    from touchnet_tpu_torch.ops import decode_attention as dec
    from touchnet_tpu_torch.ops import fused_ce

    if Path(touchnet_tpu_torch.__file__).resolve().parent.parent != HERE:
        raise RuntimeError(f"touchnet_tpu_torch imported from {touchnet_tpu_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[1] device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    for op in ("_flash_attention_forward", "_flash_attention_backward"):
        print(f"  yardstick schema: {getattr(torch.ops.aten, op).default._schema}")

    t0 = time.perf_counter()
    _build.build(_build.library_path())
    _build.load_library()
    print(f"[2] build: nvcc {' '.join(_build.NVCC_FLAGS)} -> "
          f"{_build.library_path().relative_to(HERE)} in {time.perf_counter() - t0:.1f} s")

    if sys.argv[1:] == ["--profile"]:
        with tempfile.TemporaryDirectory() as tmp:
            profile_training(dev, card, Path(tmp))
        return 0
    if sys.argv[1:] == ["--faults"]:
        return check_faults(_build, dev, card)
    if sys.argv[1:] == ["--tune"]:
        return tune(_build, dev, card)
    if sys.argv[1:] == ["--two-ranks"]:
        failures = []
        with phase_clock("phase 16"), tempfile.TemporaryDirectory() as tmp:
            run_two_ranks(card, failures, Path(tmp))
        if failures:
            raise SystemExit(f"chip_smoke --two-ranks FAILED: {failures}")
        return 0

    failures = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    print(f"  temp dir {tempfile.gettempdir()}: "
          f"{shutil.disk_usage(tempfile.gettempdir()).free / 1e9:.2f} GB free")
    with phase_clock("phase 3"):
        k1 = check_k1(attn, dev, gen, failures, card)
    with phase_clock("phase 4"):
        k4 = check_k4(dec, dev, gen, failures, card)
    with phase_clock("phase 5"):
        counts = run_slice(dev, card, failures)
    torch.cuda.empty_cache()
    with phase_clock("phase 6"):
        k2 = check_k2(attn, dev, gen, failures, card)
        k1_cp, k2_cp = check_cp_cases(attn, dev, gen, failures, card)
    k1.update(k1_cp)
    k2.update(k2_cp)
    with phase_clock("phase 7"):
        k3 = check_k3(fused_ce, dev, gen, failures, card)
    with phase_clock("phase 17"):
        check_frontend(dev, card, failures)
    with phase_clock("phase 8"), tempfile.TemporaryDirectory() as tmp:
        train_counts = run_training(dev, card, failures, Path(tmp))
    torch.cuda.empty_cache()
    with phase_clock("phase 9"), tempfile.TemporaryDirectory() as tmp:
        recipe_counts = run_recipe(dev, card, failures, Path(tmp))
    torch.cuda.empty_cache()
    paths, k1_audio, k2_sft, k4_audio = run_audio_phases(dev, card, failures)
    with phase_clock("phase 16"), tempfile.TemporaryDirectory() as tmp:
        paths["two ranks"] = run_two_ranks(card, failures, Path(tmp))
    k1.update(k1_audio)
    k2.update(k2_sft)
    k4.update(k4_audio)
    audio_counts = paths["audio recipe"]
    for name in ("K1", "K2", "K3 fwd", "K3 bwd"):
        for path, got in (("training", train_counts), ("recipe run", recipe_counts),
                          ("audio recipe", audio_counts), ("two ranks", paths["two ranks"]),
                          ("touch_audio SFT", paths["touch_audio SFT"])):
            if not got.get(name):
                failures.append(f"{name} never launched on the {path} path")
        counts[name] = counts.get(name, 0) + train_counts.get(name, 0) + \
            recipe_counts.get(name, 0) + audio_counts.get(name, 0) + \
            paths["two ranks"].get(name, 0) + paths["touch_audio SFT"].get(name, 0)
    # K3 stays off on the qwen2_audio and kimi_audio SFT paths (no head weight;
    # phases 14 and 15 check it) and in the closed loop (JAX's flags leave
    # liger off)
    for name in ("K1", "K2"):
        for path in ("qwen2_audio SFT", "kimi_audio SFT", "closed loop"):
            if not paths[path].get(name):
                failures.append(f"{name} never launched on the {path} path")
            counts[name] += paths[path].get(name, 0)
    for name in ("K1", "K4"):
        for path in ("ASR CLI", "qwen2_audio ASR", "kimi_audio ASR", "closed loop"):
            if not paths[path].get(name):
                failures.append(f"{name} never launched on the {path} path")
    if not recipe_counts.get("K4"):
        failures.append("K4 never launched on the recipe run's export path")
    counts["K4"] = counts.get("K4", 0) + recipe_counts.get("K4", 0) + \
        paths["closed loop"].get("K4", 0)
    for name in ("K1", "K4"):
        counts[name] += sum(paths[p].get(name, 0)
                            for p in ("ASR CLI", "qwen2_audio ASR", "kimi_audio ASR"))
    for name, n in counts.items():
        if n == 0:
            failures.append(f"{name} never launched on the main path")

    print(f"  [all phases] wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line(counts, k1, k2, k3, k4)))
    if failures:
        raise SystemExit(f"chip_smoke FAILED: {failures}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        sys.exit(gloo_rank_worker(sys.argv[2:]))
    sys.exit(main())
