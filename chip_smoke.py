#!/usr/bin/env python3
# Copyright (c) 2026 touchnet_tpu authors.
"""End-to-end smoke run of touchnet_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA
     versions; a CUDA card is required, there is no CPU fallback;
  2. build: nvcc builds the kernels of ops/csrc from this checkout;
  3. K1 (packed flash-attention forward) against its plain version;
  4. K4 (ragged flash-decode) against its plain version;
  5. the serving slice: Llama-3.2-1B at full width (random bf16 weights
     from a seed) generates for 8 prompts, with single-shot and chunked
     prefill; launch counts, logits against the plain-attention path,
     timings and peak memory. The plain-attention path is the same code
     with the kernels' wrappers swapped for their plain versions inside
     this script (plain_attention); the package itself has no such switch.
Then one JSON line of per-kernel results, the card line, and the last
line {"ok": true, "device": {...}}.

Tolerances on the card, each against the plain version on the same inputs:
  - bf16 kernels vs the plain version run in f32 on the same bf16-rounded
    inputs: max abs 2e-2 and mean abs 2e-3 on out at unit-scale inputs
    (the kernel rounds its f32 result to bf16 once: half an ulp is up to
    2^-9 relative, ~1.6e-2 at |out| near 4), lse 1e-3 (f32 throughout;
    only summation order differs);
  - f32 kernels: 1e-4, with TF32 off for the plain version's matmuls;
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
    fault beyond rounding moves them by far more, see PERF.md).
Timings are the median of 7 runs after 2 warmup runs, with CUDA events.
"""

import contextlib
import copy
import json
import math
import statistics
import subprocess
import sys
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
    ok = finite and (mx <= BF16_MAX and mean <= BF16_MEAN if dtype == torch.bfloat16
                     else mx <= F32_TOL)
    print(f"  {name}: max_abs_err={mx:.3e} mean_abs_err={mean:.3e} finite={finite} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    return mx


def packed_segments(B, T, dev):
    """Three documents then a padding tail (segment 0) in every row."""
    rng = np.random.default_rng(SEED + T)
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        c = np.sort(rng.choice(np.arange(1, T - 64), 3, replace=False))
        seg[b, :c[0]], seg[b, c[0]:c[1]], seg[b, c[1]:c[2]] = 1, 2, 3
    return torch.from_numpy(seg).to(dev)


def check_k1(attn, dev, gen, failures, card):
    print("[3] K1 flash_attention vs packed_attention_reference")
    rows = {}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def case(name, q, k, v, seg, kv_seg, causal, q_off, timed=False):
        out, lse = attn.flash_attention(q, k, v, seg, causal, None, kv_seg, q_off, 0)
        torch.cuda.synchronize()
        want, want_lse = attn.packed_attention_reference(
            q.float(), k.float(), v.float(), seg, causal, None, kv_seg, q_off, 0)
        B, T, H, _ = q.shape
        S = k.shape[1]
        m = torch.ones((B, T, S), dtype=torch.bool, device=dev)
        if causal:
            m &= (q_off + torch.arange(T, device=dev))[:, None] >= torch.arange(S, device=dev)
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
            ms = time_ms(lambda: attn.flash_attention(q, k, v, seg, causal, None, kv_seg, q_off, 0))
            plain = time_ms(lambda: attn.packed_attention_reference(
                q, k, v, seg, causal, None, kv_seg, q_off, 0))
            print(f"  {name} time: kernel {ms:.3f} ms, plain {plain:.3f} ms  [{card}]")
            rows[name] = (mx, ms, plain)
        return mx

    bf = torch.bfloat16
    B, T, H, Hkv, D = 8, 2048, 32, 8, 64
    seg = packed_segments(B, T, dev)
    case("(a) B8 T2048 H32/8 D64 bf16 causal packed",
         randn(B, T, H, D, dtype=bf), randn(B, T, Hkv, D, dtype=bf),
         randn(B, T, Hkv, D, dtype=bf), seg, seg, True, 0, timed=True)
    case("(b) B4 T=S=1500 H16/4 D128 bf16 non-causal",
         randn(4, 1500, 16, 128, dtype=bf), randn(4, 1500, 4, 128, dtype=bf),
         randn(4, 1500, 4, 128, dtype=bf), None, None, False, 0, timed=True)
    # (c) a 1024-row chunk at offset 2048 over the strided K/V halves of a
    # packed cache layer: the chunked-prefill call of the slice
    Sc, C, off = 4096, 1024, 2048
    cache = randn(B, Hkv, Sc, 2 * D, dtype=bf)
    k_c, v_c = attn.cache_halves(cache, D)
    assert k_c.data_ptr() == cache.data_ptr() and not k_c.is_contiguous()
    q_seg = torch.ones((B, C), dtype=torch.int32, device=dev)
    kv_seg = (torch.arange(Sc, device=dev) < off + C).int().expand(B, Sc).contiguous()
    qc = randn(B, C, H, D, dtype=bf)
    case("(c) chunk 1024 @2048 over cache halves [8,8,4096,128] bf16",
         qc, k_c, v_c, q_seg, kv_seg, True, off, timed=True)
    out_p = attn.flash_prefill(qc, cache, q_seg, kv_seg, q_offset=off)
    out_d, _ = attn.flash_attention(qc, k_c, v_c, q_seg, True, None, kv_seg, off, 0)
    if not torch.equal(out_p, out_d):
        failures.append("(c) flash_prefill entry")
    del cache, k_c, v_c, qc, out_p, out_d
    f32 = torch.float32
    seg = packed_segments(2, 300, dev)
    case("(d) B2 T300 H8/2 D64 f32 causal packed",
         randn(2, 300, 8, 64, dtype=f32), randn(2, 300, 2, 64, dtype=f32),
         randn(2, 300, 2, 64, dtype=f32), seg, seg, True, 0)
    case("(d) B2 T200 H6/3 D128 f32 non-causal",
         randn(2, 200, 6, 128, dtype=f32), randn(2, 200, 3, 128, dtype=f32),
         randn(2, 200, 3, 128, dtype=f32), None, None, False, 0)
    return rows


def check_k4(dec, dev, gen, failures, card):
    print("[4] K4 decode_attention vs decode_attention_reference")
    rows = {}

    def case(name, B, L, Hkv, G, D, S, plen, base, last, layer, dtype, timed=False):
        q = torch.randn((B, Hkv * G, D), generator=gen, device=dev).to(dtype)
        kv = torch.randn((L, B, Hkv, S, 2 * D), generator=gen, device=dev, dtype=dtype)
        plen = torch.tensor(plen, dtype=torch.int32, device=dev)
        got = dec.decode_attention(q, kv, plen, base, last, layer_idx=layer)
        torch.cuda.synchronize()
        want = dec.decode_attention_reference(q.float(), kv[layer].float(), plen, base, last)
        mx = compare(name, got, want, dtype, failures)
        if timed:
            ms = time_ms(lambda: dec.decode_attention(q, kv, plen, base, last, layer_idx=layer))
            plain = time_ms(lambda: dec.decode_attention_reference(
                q, kv, plen, base, last, layer_idx=layer))
            print(f"  {name} time: kernel {ms:.3f} ms, plain {plain:.3f} ms  [{card}]")
            rows[name] = (mx, ms, plain)
        return mx

    plen = torch.randint(2048, 8192, (32,), generator=torch.Generator().manual_seed(SEED))
    case("(a) B32 L16 H32/8 D64 S8192 bf16 layer 7",
         32, 16, 8, 4, 64, 8192, plen.tolist(), 7936, 8000, 7, torch.bfloat16, timed=True)
    for Hkv in (5, 7):
        case(f"(b) B3 Hkv{Hkv} G2 D128 S2048 bf16",
             3, 2, Hkv, 2, 128, 2048, [1500, 700, 1], 1536, 1600, 1, torch.bfloat16)
    case("(c) prompt_len 1 row, B2 Hkv8 G4 D64 S1024 f32",
         2, 1, 8, 4, 64, 1024, [1, 600], 640, 700, 0, torch.float32)
    return rows


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@contextlib.contextmanager
def plain_attention():
    """The reference route of the slice: while it is open, the kernel
    wrappers that forward_step calls (flash_attention, which flash_prefill
    also goes through, and decode_attention) are their plain versions,
    which take the same arguments and run on the card."""
    from touchnet_tpu_torch.ops import attention as attn
    from touchnet_tpu_torch.ops import decode_attention as dec

    saved = attn.flash_attention, dec.decode_attention
    attn.flash_attention = attn.packed_attention_reference
    dec.decode_attention = dec.decode_attention_reference
    try:
        yield
    finally:
        attn.flash_attention, dec.decode_attention = saved


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

    # warm cuBLAS and the allocator on a short prompt (not measured)
    inf.generate(model, cfg, emb[:2, :128], torch.full((2,), 128, device=dev), 2, **gen_kw)
    torch.cuda.synchronize()

    modes = [("single-shot", None), ("chunked 1024", 1024)]
    outs, counts, gen_s, peaks = {}, {}, {}, {}
    # the main path: every launch count is zeroed here and read just after
    flash_attention.launches = 0
    decode_attention.launches = 0
    for mode, chunk in modes:
        before = (flash_attention.launches, decode_attention.launches)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = inf.generate(model, cfg, emb, plen, NEW, prefill_chunk=chunk, **gen_kw)
        torch.cuda.synchronize()
        gen_s[mode] = time.perf_counter() - t0
        peaks[mode] = torch.cuda.max_memory_allocated()
        outs[mode] = out
        counts[mode] = (flash_attention.launches - before[0],
                        decode_attention.launches - before[1])
    main_counts = {"K1": flash_attention.launches, "K4": decode_attention.launches}
    model32 = copy.deepcopy(model).float()  # the same weights, for the f32 checks

    for mode, chunk in modes:
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
            with plain_attention():
                res = forced(m, dtype)[0]
            if (flash_attention.launches, decode_attention.launches) != before:
                failures.append(f"{mode} plain path launched a kernel")
            return res

        def worst(a, b):
            return max(rel_l2(a[i], b[i]) for i in range(a.shape[0]))

        got, prefill_ms, step_ms = forced(model, torch.bfloat16)
        plain = forced_plain(model, torch.bfloat16)
        ref = forced_plain(model32, torch.float32)
        got32, _, _ = forced(model32, torch.float32)
        finite = bool(torch.isfinite(got).all() and torch.isfinite(got32).all())
        e32, e_kp = worst(got32, ref), worst(got, plain)
        e_k, e_p = worst(got, ref), worst(plain, ref)
        e_pre = rel_l2(got[0], plain[0])
        agree = (got.argmax(-1) == plain.argmax(-1)).float().mean().item()
        ok = (finite and e32 <= F32_LOGITS_RTOL and e_k <= BF16_NOISE_RATIO * e_p
              and e_pre <= BF16_PREFILL_RTOL)
        print(f"  {mode}: logits rel_l2 (worst of prefill + {steps} steps): "
              f"f32 kernel vs f32 plain {e32:.3e} (<= {F32_LOGITS_RTOL:.0e}); "
              f"vs f32 plain: bf16 kernel {e_k:.3e}, bf16 plain {e_p:.3e} "
              f"(kernel <= {BF16_NOISE_RATIO}x plain); bf16 kernel vs bf16 plain {e_kp:.3e}, "
              f"last prefill only {e_pre:.3e} (<= {BF16_PREFILL_RTOL:.0e}); "
              f"finite={finite} {'ok' if ok else 'FAIL'}")
        print(f"  {mode}: greedy argmax agreement, bf16 kernel vs bf16 plain "
              f"(teacher-forced) {agree:.4f}")
        if not ok:
            failures.append(f"{mode} logits")
        print(f"  {mode}: prefill {prefill_ms:.1f} ms, decode {step_ms:.3f} ms/step, "
              f"generate {gen_s[mode]:.3f} s for {B}x{steps} tokens = "
              f"{B * steps / gen_s[mode]:.1f} generated tok/s, "
              f"peak {peaks[mode] / 2**30:.2f} GiB allocated  [{card}]")
    return main_counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import touchnet_tpu_torch
    from touchnet_tpu_torch.ops import _build
    from touchnet_tpu_torch.ops import attention as attn
    from touchnet_tpu_torch.ops import decode_attention as dec

    if Path(touchnet_tpu_torch.__file__).resolve().parent.parent != HERE:
        raise RuntimeError(f"touchnet_tpu_torch imported from {touchnet_tpu_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[1] device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build(_build.library_path())
    _build.load_library()
    print(f"[2] build: nvcc {' '.join(_build.NVCC_FLAGS)} -> "
          f"{_build.library_path().relative_to(HERE)} in {time.perf_counter() - t0:.1f} s")

    failures = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = check_k1(attn, dev, gen, failures, card)
    k4 = check_k4(dec, dev, gen, failures, card)
    counts = run_slice(dev, card, failures)
    for name in ("K1", "K4"):
        if counts[name] == 0:
            failures.append(f"{name} never launched on the main path")

    (k1_err, k1_ms, k1_plain), = [v for n, v in k1.items() if n.startswith("(a)")]
    (k4_err, k4_ms, k4_plain), = [v for n, v in k4.items() if n.startswith("(a)")]
    print(json.dumps({"kernels": [
        {"name": "flash_attention_fwd (K1)", "route": "cuda",
         "source": "touchnet_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "touchnet_tpu/ops/attention.py:269", "launches": counts["K1"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "flash_decode (K4)", "route": "cuda",
         "source": "touchnet_tpu_torch/ops/csrc/decode_attention.cu",
         "replaces": "touchnet_tpu/ops/decode_attention.py:85", "launches": counts["K4"],
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain},
    ]}))
    if failures:
        raise SystemExit(f"chip_smoke FAILED: {failures}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
