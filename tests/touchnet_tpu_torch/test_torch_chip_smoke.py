# The bound arithmetic of chip_smoke.py: live_pairs counts the live
# (row, column) pairs of one head from the segment runs, and must equal the
# sum of the dense causal + segment mask that K1 applies; K2's per-kernel
# bounds. The bit checksums and the depth choice of the recipe phase. And
# the source edits of its --faults and --tune modes must still find their
# text. Phase 12's helpers: the depth rule, the tokenizer it builds, the
# long utterance, the ark files and the scoring; and the kernels line.
# Phase 13's: the bound at a given peak (the f32 rows at the FP32 peak),
# the stage-4 argv (run.sh's flag set exactly), the kimi cases (i)-(k) in
# the kernels line. Phase 14's: the depth rule, the stage-2 argv (run.sh's
# flags but the named cuts), the SFT cases (l) and (m) in the kernels line.
# Phase 15's: the depth rule (text and mimo layers, then the budget, by disk
# and card), the rows rule, a row's length against dynamic_batch's, the
# stage-2 argv with model_type kimi_audio, the case (n) in the kernels line.
# Phase 6's (p): the varlen runs that express the allgather call, and the
# rows and columns with a live pair that its bytes count (live_extent,
# live_bytes: a chunk that causality masks whole reads nothing). Phases 18
# and 18b's: the stage-2 argv with model_type touch_audio, the tone data
# and tokenizer against JAX's closed loop's, Llama-3's specials in the char
# tokenizer, loop_config, step_check and report_step_check on a CPU
# trainer, and (q) in the kernels line.

import copy
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_PATH = os.path.join(ROOT, "chip_smoke.py")
_spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _packed(B, T, docs, seed, tail=True):
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        ends = np.sort(rng.choice(np.arange(1, T - 4 if tail else T), docs, replace=False))
        if not tail:
            ends[-1] = T
        for i, (a, e) in enumerate(zip([0, *ends[:-1]], ends)):
            seg[b, a:e] = i + 1
    return seg


def _mask(q_seg, kv_seg, causal, q_off, kv_off, T, S):
    m = np.ones((1 if q_seg is None else q_seg.shape[0], T, S), bool)
    if causal:
        m &= (q_off + np.arange(T))[:, None] >= (kv_off + np.arange(S))[None, :]
    if q_seg is not None:
        m &= q_seg[:, :, None] == kv_seg[:, None, :]
    return m


def _dense(q_seg, kv_seg, causal, q_off, kv_off, T, S):
    return int(_mask(q_seg, kv_seg, causal, q_off, kv_off, T, S).sum())


def _case(name):
    if name == "packed rows, padding tail":
        seg = _packed(3, 97, 4, 0)
        return seg, seg, True, 0, 0
    if name == "packed rows, no tail":
        seg = _packed(2, 64, 3, 1, tail=False)
        return seg, seg, True, 0, 0
    if name == "chunked prefill offset":
        q = np.ones((2, 16), np.int32)
        kv = (np.arange(80) < 48 + 16).astype(np.int32)[None].repeat(2, 0)
        return q, kv, True, 48, 0
    if name == "both offsets":
        seg = _packed(2, 120, 3, 2)
        return seg[:, 50:90], seg[:, 10:], True, 50, 10
    if name == "non-causal, packed":
        seg = _packed(2, 50, 2, 3)
        return seg, seg, False, 0, 0
    if name == "non-causal, one segment":
        return None, None, False, 0, 0
    if name == "causal, one segment":
        return None, None, True, 0, 0
    if name == "all padding":
        seg = np.zeros((2, 33), np.int32)
        return seg, seg, True, 0, 0
    if name == "rows that see no key":
        q = np.full((1, 20), 2, np.int32)
        kv = np.ones((1, 30), np.int32)
        return q, kv, True, 5, 0
    if name == "ring past chunk":
        seg = _packed(2, 128, 3, 4)
        return seg[:, 64:], seg[:, :64], True, 64, 0
    if name == "ring future chunk":
        seg = _packed(2, 128, 3, 4)
        return seg[:, :64], seg[:, 64:], True, 0, 64
    raise KeyError(name)


CASES = ["packed rows, padding tail", "packed rows, no tail", "chunked prefill offset",
         "both offsets", "non-causal, packed", "non-causal, one segment",
         "causal, one segment", "all padding", "rows that see no key", "ring past chunk",
         "ring future chunk"]


@pytest.mark.parametrize("name", CASES)
def test_live_pairs_equals_the_dense_mask(name):
    q_seg, kv_seg, causal, q_off, kv_off = _case(name)
    T = 37 if q_seg is None else q_seg.shape[1]
    S = 41 if kv_seg is None else kv_seg.shape[1]
    B = 3 if q_seg is None else q_seg.shape[0]  # None: one segment in each of B rows
    got = chip_smoke.live_pairs(q_seg, kv_seg, causal, q_off, kv_off, T, S, B)
    want = _dense(q_seg, kv_seg, causal, q_off, kv_off, T, S)
    assert got == (B * want if q_seg is None else want)


@pytest.mark.parametrize("name", CASES)
def test_live_extent_equals_the_dense_mask(name):
    """The query rows and key columns with at least one live pair, summed
    over the batch, equal the dense mask's."""
    q_seg, kv_seg, causal, q_off, kv_off = _case(name)
    T = 37 if q_seg is None else q_seg.shape[1]
    S = 41 if kv_seg is None else kv_seg.shape[1]
    B = 3 if q_seg is None else q_seg.shape[0]
    m = _mask(q_seg, kv_seg, causal, q_off, kv_off, T, S)
    want = (int(m.any(-1).sum()), int(m.any(-2).sum()))
    if q_seg is None:
        want = (B * want[0], B * want[1])
    assert chip_smoke.live_extent(q_seg, kv_seg, causal, q_off, kv_off, T, S, B) == want


def test_live_bytes_of_the_ring_chunks():
    """K1's bytes at (p)'s chunks: the own chunk reads all of q, k, v and
    the segment ids; the future chunk, which causality masks whole, only
    writes out and lse; the past chunk reads the live rows of q and the
    live columns of k and v."""
    T, H, Hkv, D = 64, 4, 2, 8
    seg = torch.from_numpy(_packed(1, 2 * T, 3, 4))
    q = torch.zeros(1, T, H, D, dtype=torch.bfloat16)
    k = torch.zeros(1, T, Hkv, D, dtype=torch.bfloat16)
    lse = torch.zeros(1, H, T)
    nb = chip_smoke.nbytes
    own = chip_smoke.live_bytes((q,), (k, k), (q, lse), seg[:, T:], seg[:, T:], True, T, T)
    assert own == nb(q, k, k, q, lse, seg[:, T:], seg[:, T:])
    fut = chip_smoke.live_bytes((q,), (k, k), (q, lse), seg[:, :T], seg[:, T:], True, 0, T)
    assert fut == nb(q, lse)
    rows, cols = chip_smoke.live_extent(seg[:, T:], seg[:, :T], True, T, 0)
    assert 0 < rows < T and 0 < cols <= T
    past = chip_smoke.live_bytes((q,), (k, k), (q, lse), seg[:, T:], seg[:, :T], True, T, 0)
    assert past == pytest.approx(nb(q) * rows / T + 2 * nb(k) * cols / T + nb(q, lse)
                                 + nb(seg[:, T:], seg[:, :T]))


def test_bound_names_its_limit():
    ops = chip_smoke.bound(989e12, 1.0)  # 1 s of bf16 operations, one byte
    assert ops["bound_by"] == "operations" and abs(ops["bound_ms"] - 1e3) < 1e-9
    mem = chip_smoke.bound(1.0, 3.35e9)  # 1 ms of bytes
    assert mem["bound_by"] == "bytes" and abs(mem["bound_ms"] - 1.0) < 1e-9


@pytest.mark.parametrize("peak,ms", [(None, 11.5e9 / 989e12 * 1e3), (66.9e12, 11.5e9 / 66.9e12 * 1e3)])
def test_bound_at_a_given_peak(peak, ms):
    """The f32 rows (i)-(k) are bounded at the FP32 peak, 66.9 TFLOP/s; the
    rest at the bf16 989 TFLOP/s. (i)'s 11.5 GFLOP: 0.17 ms at FP32."""
    args = () if peak is None else (peak,)
    got = chip_smoke.bound(11.5e9, 1.0, *args)
    assert got["bound_by"] == "operations" and abs(got["bound_ms"] - ms) < 1e-12
    assert chip_smoke.PEAK_F32_FLOPS == 66.9e12
    assert abs(chip_smoke.bound(11.5e9, 1.0, chip_smoke.PEAK_F32_FLOPS)["bound_ms"] - 0.1719) < 1e-4


@pytest.mark.parametrize("model_type", ["touch_audio", "qwen2_audio", "kimi_audio"])
def test_stage4_argv_is_the_recipes(model_type):
    """stage4_argv is run.sh:172-181's flag set: f32 at batch 1 for Kimi,
    bf16 at 16 otherwise (run.sh:156-160), touch_audio's instruct empty,
    and neither --training_model_config_path nor --tokenizer_model."""
    argv = chip_smoke.stage4_argv(model_type, "m", "d", "o")
    flags = dict(zip(argv[::2], argv[1::2]))
    assert len(flags) * 2 == len(argv)
    kimi = model_type == "kimi_audio"
    assert flags == {
        "--model_path": "m", "--model_dtype": "float32" if kimi else "bfloat16",
        "--instruct": "" if model_type == "touch_audio" else "Generate the transcription:",
        "--data_list": "d", "--output_dir": "o", "--batch_size": "1" if kimi else "16",
        "--inference_enable_liger_kernel": "true", "--num_workers": "16", "--prefetch": "8"}
    run_sh = open(os.path.join(ROOT, "examples/audio/sft/asr/wenetspeech/run.sh")).read()
    stage4 = run_sh[run_sh.index('python -m "touchnet_tpu.models.${model_type}'):]
    stage4 = stage4[:stage4.index("\n\n")]
    assert [ln.split()[0] for ln in stage4.splitlines()[1:]] == list(flags)


def test_fault_and_tune_edits_match_the_kernel_sources():
    """Every faulty copy (FAULTS) and tuning variant (K3_TUNE, the K4 ring
    depth) edits text that the kernel sources still hold: a stale edit
    would make --faults or --tune raise on the card."""
    csrc = os.path.join(os.path.dirname(_PATH), "touchnet_tpu_torch", "ops", "csrc")

    def text(name):
        with open(os.path.join(csrc, name)) as f:
            return f.read()

    edits = [(f, right) for _, f, right, _, _ in chip_smoke.FAULTS]
    edits += [(f, right) for v in chip_smoke.K3_TUNE.values() for f, right, _ in v]
    edits.append(("decode_attention.cu", "static constexpr int kStages = 3;"))
    for fname, right in edits:
        assert right in text(fname), (fname, right)


def test_k2_part_bounds_count_the_split_design():
    """dkv does S, dP, dV, dK (8·D·H per live pair), dq S, dP, dQ (6):
    14 in all against the fused pass's 10; delta is bound by its bytes."""
    B, T, H, Hkv, D = 1, 64, 4, 2, 16
    q, g, out = (torch.zeros(B, T, H, D, dtype=torch.bfloat16) for _ in range(3))
    k, v = (torch.zeros(B, T, Hkv, D, dtype=torch.bfloat16) for _ in range(2))
    lse = torch.zeros(B, H, T)
    seg = torch.ones(B, T, dtype=torch.int32)
    pairs = chip_smoke.live_pairs(seg, seg, True)
    got = chip_smoke.k2_part_bounds(D, H, pairs, q, k, v, out, g, lse, seg, q, k, v)
    assert got["dkv"]["flops"] == 8 * D * H * pairs == 8 * D * H * T * (T + 1) // 2
    assert got["dq"]["flops"] == 6 * D * H * pairs
    assert got["delta"]["bound_by"] == "bytes"


def test_bits_checksums_see_a_flipped_bit_and_a_swap():
    t = torch.arange(12, dtype=torch.float32)
    base = chip_smoke.bits_checksums({"t": t})["t"]
    flipped = t.clone()
    flipped.view(torch.int32)[3] ^= 1
    swapped = t[[0, 1, 5, 3, 4, 2, 6, 7, 8, 9, 10, 11]]
    assert chip_smoke.bits_checksums({"t": flipped})["t"][0] != base[0]
    s = chip_smoke.bits_checksums({"t": swapped})["t"]
    assert s[0] == base[0] and s[1] != base[1]
    assert chip_smoke.bits_checksums({"c": torch.tensor(7, dtype=torch.int32)})["c"] == (7, 7)


def test_recipe_depth_cuts_layers_only_without_room():
    """Phase 9 takes RECIPE_MAX_LAYERS (2) of Llama-3.2-1B's 16 layers
    (phase 8 trains all 16) when the temp directory holds three checkpoints
    (~4.6 GB each at 2 layers: f32 params, mu, nu), the stage-1 seed
    (bf16), its step_0 and the stage-3 export (f32), and otherwise cuts
    layers further, never width."""
    from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig

    cfg = LlamaConfig.from_json_file(str(chip_smoke.CONFIG))
    L, ckpt, need = chip_smoke.recipe_depth(cfg, 10**12)
    assert L == chip_smoke.RECIPE_MAX_LAYERS == 2 and 4.5e9 < ckpt < 4.7e9
    assert cfg.num_hidden_layers == 16
    n = ckpt // 12  # parameters
    assert need == 3 * ckpt + (2 + 4 + 4) * n + 2**31
    cut, _, cut_need = chip_smoke.recipe_depth(cfg, need - 1)
    assert 0 < cut < 2 and cut_need < need
    assert chip_smoke.recipe_depth(cfg, 0)[0] == 0
    assert cfg.num_hidden_layers == 16  # the config itself is untouched


_NS = "tn::(anonymous namespace)::"


@pytest.mark.parametrize("kernel,group", [
    (f"void {_NS}ce_gemm<{_NS}RowStatsOp>(CUtensorMap_st, CUtensorMap_st, {_NS}FwdParams)",
     "K3 fwd"),
    (f"void {_NS}ce_fwd_combine({_NS}FwdParams)", "K3 fwd"),
    (f"void {_NS}ce_fwd_partial<__nv_bfloat16>({_NS}FwdParams)", "K3 fwd"),
    (f"void {_NS}ce_gemm<{_NS}DlogitsOp>(CUtensorMap_st, CUtensorMap_st, {_NS}BwdParams)",
     "K3 bwd, TMA + wgmma mainloop (ce_gemm)"),
    (f"void {_NS}ce_gemm<{_NS}DhOp>(CUtensorMap_st, CUtensorMap_st, {_NS}BwdParams)",
     "K3 bwd, TMA + wgmma mainloop (ce_gemm)"),
    (f"void {_NS}ce_gemm<{_NS}DwOp>(CUtensorMap_st, CUtensorMap_st, {_NS}BwdParams)",
     "K3 bwd, TMA + wgmma mainloop (ce_gemm)"),
    (f"void {_NS}ce_bwd_dlogits<float>({_NS}BwdParams)", "K3 bwd, 64x64 tiles"),
    (f"void {_NS}ce_gemm_dw<__nv_bfloat16>({_NS}BwdParams)", "K3 bwd, 64x64 tiles"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", "cuBLAS"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise and other"),
])
def test_profile_groups_of_the_k3_kernels(kernel, group):
    """--profile's groups by demangled kernel name: both directions of K3
    run ce_gemm<Op>, so the epilogue class decides, ahead of cuBLAS's
    "gemm"."""
    assert chip_smoke.profile_group(kernel) == group


def test_char_tokenizer_has_qwen2_audios_special_ids(tmp_path):
    from touchnet_tpu_torch.tokenizer import TokenizerConfig
    from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer

    V = 156032
    root = chip_smoke.write_char_tokenizer(tmp_path / "tok", V, chip_smoke.QWEN2_SPECIALS,
                                           chip_smoke.QWEN2_EOS, chip_smoke.QWEN2_INSTRUCT)
    tok = build_tokenizer(TokenizerConfig(tokenizer_type="HuggingFaceTokenizer",
                                          tokenizer_model=str(root)))
    assert (tok.eos, tok.pad, tok.bos) == (151643, 151643, None)
    for name, i in chip_smoke.QWEN2_SPECIALS.items():
        assert tok.tokenize(name, add_special_tokens=False) == [i]
    text = "<|audio_bos|><|AUDIO|><|AUDIO|><|audio_eos|>" + chip_smoke.QWEN2_INSTRUCT
    ids = tok.tokenize(text, add_special_tokens=False)
    assert ids[:4] == [151647, 151646, 151646, 151648]
    first = list(dict.fromkeys(chip_smoke.QWEN2_INSTRUCT))  # its characters take ids 0, 1, ...
    assert ids[4:] == [first.index(c) for c in chip_smoke.QWEN2_INSTRUCT]
    assert tok.detokenize(ids[4:]) == chip_smoke.QWEN2_INSTRUCT
    assert len(tok.detokenize([0, 151642, 151649, V - 1])) == 4  # one character an id
    assert tok.vocab_size == V


def test_long_utterance_and_ark_files(tmp_path):
    jsonl, total = chip_smoke.synth_utterances(tmp_path / "wav", 3, 7, lo=1.0, hi=2.0,
                                               long=(1, 31.0))
    from scipy.io import wavfile

    recs = [json.loads(ln) for ln in open(jsonl)]
    sr, x = wavfile.read(recs[1]["wav"])
    assert sr == 16000 and len(x) == 31 * 16000 and 33.0 < total < 35.0
    part = tmp_path / "part_0"
    part.write_text("".join(json.dumps({"key": r["key"], "txt": r["txt"], "hyp": h},
                                       ensure_ascii=False) + "\n"
                            for r, h in zip(recs, ["UTTERANCE 0", "", "乱"])), encoding="utf8")
    out = tmp_path / "out"
    out.mkdir()
    keys = chip_smoke.write_ark(str(part), out)
    assert keys == ["utt0", "utt1", "utt2"]
    assert (out / "raw_rec.txt").read_text(encoding="utf8") == \
        "utt0\tUTTERANCE 0\nutt1\t\nutt2\t乱\n"
    assert (out / "trans.txt").read_text().splitlines()[2] == "utt2\tutterance 2"
    failures = []
    line = chip_smoke.score_cer(out, keys, failures)
    assert not failures and line.startswith("Overall -> ")
    assert "num_eval_utts: 3" in (out / "RESULTS.txt").read_text()  # the empty hyp too
    failures = []
    chip_smoke.score_cer(out, keys + ["utt3"], failures)  # a key the scorer never read
    assert failures == ["qwen2 asr: scoring"]


def test_kernels_line_names_k1_to_k4():
    def case(ms):
        return {"max_abs_err": 1e-3, "ms": ms, "plain_ms": 2 * ms, "library_ms": None,
                "bound_ms": ms / 10, "bound_by": "operations", "tflops": 1.0}

    k1 = {"(d) main": case(2.0), "(f) tower": case(0.8), "(g) prefill": case(0.7)}
    k4 = {"(a) decode": case(0.2), "(h) qwen2 decode": case(0.07)}
    k3 = {"(d) main": {"fwd": case(13.0), "bwd": case(44.0)}}
    counts = {"K1": 120, "K2": 16, "K3 fwd": 1, "K3 bwd": 1, "K4": 3584}
    line = chip_smoke.kernels_line(counts, k1, {"(d) main": case(6.8)}, k3, k4)
    rows = line["kernels"]
    assert [r["name"].split("(")[1][:2] for r in rows] == ["K1", "K2", "K3", "K3", "K4"]
    for r in rows:
        for key in ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms"):
            assert key in r, (r["name"], key)
    assert rows[0]["ms"] == 2.0 and set(rows[0]["cases"]) == set(k1)
    assert rows[4]["launches"] == 3584 and "(h) qwen2 decode" in rows[4]["cases"]


def test_kernels_line_carries_the_kimi_cases():
    """Phase 13's f32 rows (i)-(k) land under K1's and K4's cases; the main
    rows stay (d) and (a)."""
    def case(ms, bound):
        return {"max_abs_err": 1e-6, "ms": ms, "plain_ms": 2 * ms, "library_ms": ms / 2,
                "bound_ms": bound, "bound_by": "operations", "tflops": 1.0}

    k1 = {"(d) main": case(2.0, 0.2), "(i) kimi_audio tower": case(1.0, 0.172),
          "(j) kimi_audio prefill": case(0.5, 0.02)}
    k4 = {"(a) decode": case(0.2, 0.1), "(k) kimi_audio decode main": case(0.03, 0.001),
          "(k) kimi_audio decode mimo": case(0.03, 0.001)}
    k3 = {"(d) main": {"fwd": case(13.0, 8.7), "bwd": case(44.0, 26.1)}}
    counts = {"K1": 600, "K2": 16, "K3 fwd": 1, "K3 bwd": 1, "K4": 20000}
    rows = chip_smoke.kernels_line(counts, k1, {"(d) main": case(6.8, 0.5)}, k3, k4)["kernels"]
    assert [n for n in rows[0]["cases"] if n.startswith(("(i)", "(j)"))] == \
        ["(i) kimi_audio tower", "(j) kimi_audio prefill"]
    assert sum(n.startswith("(k)") for n in rows[4]["cases"]) == 2
    assert rows[0]["ms"] == 2.0 and rows[4]["ms"] == 0.2
    assert all(c["library_ms"] is not None for n, c in rows[4]["cases"].items()
               if n.startswith("(k)"))


def _qwen2():
    from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import (
        Qwen2AudioConfig,
    )
    from touchnet_tpu_torch.models.qwen2_audio.modeling_qwen2_audio import get_num_params

    return Qwen2AudioConfig.from_json_file(str(chip_smoke.QWEN2_CONFIG)), get_num_params


@pytest.mark.parametrize("free_gb,card_gb,want", [(80.21, 85.0, 2), (28.0, 85.0, 1),
                                                  (80.21, 60.0, 0), (20.0, 85.0, 0)])
def test_sft_depth_cuts_the_text_model_by_disk_and_card(free_gb, card_gb, want):
    """Phase 14 takes at most SFT_MAX_LAYERS text layers, fewer when the
    temp dir (at most SFT_DISK_CAP) cannot hold one checkpoint (12 bytes a
    parameter) and 2 GiB or the card the params, gradients, full logits and
    activations; the tower and the vocab stay full. At 2 layers:
    2,224,196,608 params, a 26.7 GB checkpoint, 70.8 GB of card."""
    cfg, get_num_params = _qwen2()
    layers, ckpt, disk, card = chip_smoke.sft_depth(cfg, int(free_gb * 1e9),
                                                    int(card_gb * 1e9), get_num_params)
    assert layers == want and cfg.text_config.num_hidden_layers == 28
    if want:
        c = copy.deepcopy(cfg)
        c.text_config.num_hidden_layers = want
        n = get_num_params(c)
        assert ckpt == 12 * n and disk == ckpt + 2**31
        assert disk <= min(free_gb * 1e9, chip_smoke.SFT_DISK_CAP)
        assert card == 8 * n + 16384 * 156032 * 14 + chip_smoke.SFT_ACTIVATIONS
    if want == 2:
        assert n == 2_224_196_608 and 26.6e9 < ckpt < 26.8e9 and 70.7e9 < card < 70.9e9


def _run_sh_stage2():
    run_sh = open(os.path.join(ROOT, "examples/audio/sft/asr/wenetspeech/run.sh")).read()
    body = run_sh[run_sh.index("python -m touchnet_tpu.bin.train"):]
    body = body[:body.index("\nfi")]
    flags = {}
    for ln in body.splitlines()[1:]:
        parts = ln.strip().rstrip("\\").split(None, 1)
        flags[parts[0][2:]] = parts[1].strip().strip('"')
    return flags


def test_sft_argv_is_the_recipes_stage2_but_the_named_cuts():
    """Every flag of run.sh's stage 2 is in sft_argv with the recipe's
    value (its shell variables resolved for qwen2_audio and exp_id's
    2x8192 dp8), except the cuts phase 14 names; sft_argv adds only the
    CPU offload of the moments and the SFT cut's checkpoint writes."""
    recipe = _run_sh_stage2()
    argv = chip_smoke.sft_argv("L", "E", "C", "T")
    got = dict(zip((a[2:] for a in argv[::2]), argv[1::2]))
    resolved = {"${pretrained_tokenizer_dir}": "T", "${model_type}": "qwen2_audio",
                "data/${train_set}/data.list": "L", "${bs}": "2", "${max_seq_len}": "8192",
                "${num_workers}": "12", "${prefetch}": "12", "${seed}": "2025",
                "config/${model_config}.json": "C", "exp/${exp_id}": "E", "${cp}": "1",
                "${tp}": "1", "${dp}": "8", "${pp}": "1", "${liger}": "true",
                "${param_dtype}": "bfloat16",
                "wenetspeech asr sft (${model_type})": "wenetspeech asr sft (qwen2_audio)"}
    cuts = {"training_data_parallel_shard_degree": "1", "dataloader_num_workers": "2",
            "dataloader_prefetch_factor": "2", "training_ckpt_async_mode": "disabled",
            "training_log_freq": "1", "training_activation_checkpoint_mode": "full",
            "lr_scheduler_steps": "4", "lr_scheduler_warmup_steps": "2"}
    differ = {}
    for k, v in recipe.items():
        if k == "datalist_dev_path":  # phase 14 passes its dev list through extra
            assert k not in got
            continue
        want = resolved.get(v, v)
        try:  # numbers by value (2e-5 is written 2e-05)
            same = float(got[k]) == float(want)
        except ValueError:
            same = got[k].lower() == want.lower()
        if not same:
            differ[k] = got[k]
    assert differ == cuts
    assert set(got) - set(recipe) == {"training_enable_cpu_offload"}
    assert got["training_enable_cpu_offload"] == "true"


def test_kernels_line_carries_the_sft_cases():
    """Phase 14's (l) lands under K2's cases, (m) under K1's and K2's; the
    main rows stay (d)."""
    def case(ms):
        return {"max_abs_err": 1e-3, "ms": ms, "plain_ms": 2 * ms, "library_ms": ms / 2,
                "bound_ms": ms / 10, "bound_by": "operations", "tflops": 1.0, "parts": {}}

    k1 = {"(d) main": case(2.0), "(m) qwen2_audio text training": case(0.5)}
    k2 = {"(d) main": case(6.8), "(l) qwen2_audio tower training": case(9.0),
          "(m) qwen2_audio text training": case(1.5)}
    k3 = {"(d) main": {"fwd": case(13.0), "bwd": case(44.0)}}
    counts = {"K1": 600, "K2": 400, "K3 fwd": 1, "K3 bwd": 1, "K4": 20000}
    rows = chip_smoke.kernels_line(counts, k1, k2, k3, {"(a) decode": case(0.2)})["kernels"]
    assert "(m) qwen2_audio text training" in rows[0]["cases"]
    assert {"(l) qwen2_audio tower training", "(m) qwen2_audio text training"} <= \
        set(rows[1]["cases"])
    assert rows[0]["ms"] == 2.0 and rows[1]["ms"] == 6.8 and rows[1]["launches"] == 400


def _kimi_raw():
    return json.loads(chip_smoke.KIMI_CONFIG.read_text())


@pytest.mark.parametrize("max_layers,free_gb,card_gb,rows,want", [
    (1, 80.21, 85.02, {16384: 73, 8192: 38}, (1, 8192)),
    (2, 80.21, 85.02, {16384: 73, 8192: 38}, (2, 8192)),
    (2, 40.0, 85.02, {16384: 73, 8192: 38}, (1, 8192)),
    (2, 80.21, 120.0, {16384: 73, 8192: 38}, (2, 16384)),
    (1, 80.21, 60.0, {16384: 73, 8192: 38}, (0, None)),
    (1, 30.0, 85.02, {16384: 73, 8192: 38}, (0, None)),
])
def test_kimi_sft_depth_cuts_depth_then_budget(monkeypatch, max_layers, free_gb, card_gb, rows,
                                               want):
    """Phase 15 keeps the widths and the vocab; it takes at most
    KIMI_SFT_MAX_LAYERS text layers and KIMI_SFT_MIMO mimo layers forked
    after the last, fewer text layers when the disk cannot hold run 1's
    checkpoint (f32 params and moments for every tensor but the frozen
    tokenizer's) and 2 GiB, and the recipe's 2 x 8192 budget cut to 1 x
    8192 when the card cannot hold the params, the gradients that exist,
    the logits, the tower's saved inputs at the budget's rows and the
    workspace (KIMI_SFT_LOGIT_BYTES a logit: at 14, 2 x 8192 ran out of the
    card's memory). At 2 text layers and 1 mimo layer: 3,522,111,232 params,
    a 39.52 GB checkpoint (the 42.3 GB of 12 bytes a parameter, less the
    tokenizer's moments); at 1 and 1: 3,289,053,440, 36.72 GB."""
    monkeypatch.setattr(chip_smoke, "KIMI_SFT_MAX_LAYERS", max_layers)
    raw = _kimi_raw()
    plan = chip_smoke.kimi_sft_depth(raw, int(free_gb * 1e9), int(card_gb * 1e9),
                                     rows.__getitem__)
    assert (plan["layers"], plan["budget"] if plan["layers"] else None) == want
    assert raw["num_hidden_layers"] == 28
    if plan["layers"]:
        n, frozen = plan["params"], plan["frozen"]
        assert plan["ckpt"] == 4 * n + 8 * (n - frozen)
        assert plan["disk"] == max(plan["ckpt"], 8 * n) + 2**31
        assert plan["disk"] <= min(free_gb * 1e9, chip_smoke.SFT_DISK_CAP)
        assert plan["logits"] == chip_smoke.KIMI_SFT_LOGIT_BYTES * plan["budget"] * 168448
        assert plan["tower"] == rows[plan["budget"]] * 32 * 1500 * 1280 * 2
        assert plan["card"] == (4 * n + plan["grads"] + plan["logits"] + plan["tower"]
                                + chip_smoke.KIMI_SFT_WORKSPACE) <= card_gb * 1e9
        assert plan["frozen"] == 343_599_360
    if want[0] == 2:
        assert plan["params"] == 3_522_111_232 and plan["no_grad"] == 836_779_008
        assert 39.5e9 < plan["ckpt"] < 39.6e9
    if want[0] == 1:
        assert plan["params"] == 3_289_053_440 and 36.7e9 < plan["ckpt"] < 36.8e9
    cut = chip_smoke.kimi_sft_config(raw, 2, 1)
    assert (cut["num_hidden_layers"], cut["kimia_mimo_layers"],
            cut["kimia_mimo_transformer_from_layer_index"]) == (2, 1, 1)
    assert cut["hidden_size"] == 3584 and cut["speech_encoder_config"] == \
        raw["speech_encoder_config"]


@pytest.mark.parametrize("lengths,budget,want", [
    ([100] * 30, 1000, 10), ([100] * 5, 1000, 5), ([300, 10, 10, 10], 600, 3),
    ([2000], 1000, 1)])
def test_sft_rows_is_the_budget_rule(lengths, budget, want):
    assert chip_smoke.sft_rows(lengths, budget, seed=0, trials=8) == want


def test_kimi_row_tokens_is_dynamic_batchs_row(tmp_path):
    """kimi_row_tokens gives the length of the row the port's dynamic_batch
    makes of the same utterance (the text stream with the response)."""
    from touchnet_tpu_torch.data import DataConfig
    from touchnet_tpu_torch.models.kimi_audio import processing_kimi_audio as proc
    from touchnet_tpu_torch.models.qwen2_audio.processing_qwen2_audio import whisper_features
    from touchnet_tpu_torch.tokenizer import TokenizerConfig
    from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer

    specials = {k: v - 151661 + 200 for k, v in chip_smoke.KIMI_SPECIALS.items()}
    tok = build_tokenizer(TokenizerConfig(
        tokenizer_type="HuggingFaceTokenizer", tokenizer_model=str(chip_smoke.write_char_tokenizer(
            tmp_path, 256, specials, chip_smoke.KIMI_EOS, chip_smoke.STAGE4_INSTRUCT))))
    for samples, txt in ((16000, "utterance 3"), (23_999, "utterance 142"), (480_000, "x")):
        wav = np.zeros(samples, np.float32)
        (b,) = proc.dynamic_batch(
            iter([{"key": "k", "waveform": wav, "sample_rate": 16000, "txt": txt}]),
            DataConfig(dataset_text_seqlen=8192, text_max_length_in_tokens_for_filter=9000,
                       dataloader_drop_last_batch=False),
            lambda w, sr: whisper_features(w, sr, 16), tok, specials["<|im_media_begin|>"],
            specials["<|im_media_end|>"], 3000)
        assert chip_smoke.kimi_row_tokens(tok, chip_smoke.STAGE4_INSTRUCT, samples, txt) == \
            b["text_input_ids"].shape[1]


def test_kimi_sft_argv_is_the_recipes_stage2_but_the_named_cuts():
    """Phase 15's stage-2 flags: run.sh's with model_type kimi_audio, but
    phase 14's cuts, its own step count, and the budget the plan keeps."""
    recipe = _run_sh_stage2()
    for budget, bs in ((16384, "2"), (8192, "1")):
        argv = chip_smoke.kimi_sft_argv("L", "E", "C", "T", budget)
        got = dict(zip((a[2:] for a in argv[::2]), argv[1::2]))
        resolved = {"${pretrained_tokenizer_dir}": "T", "${model_type}": "kimi_audio",
                    "data/${train_set}/data.list": "L", "${bs}": "2", "${max_seq_len}": "8192",
                    "${num_workers}": "12", "${prefetch}": "12", "${seed}": "2025",
                    "config/${model_config}.json": "C", "exp/${exp_id}": "E", "${cp}": "1",
                    "${tp}": "1", "${dp}": "8", "${pp}": "1", "${liger}": "true",
                    "${param_dtype}": "bfloat16",
                    "wenetspeech asr sft (${model_type})": "wenetspeech asr sft (kimi_audio)"}
        cuts = {"training_data_parallel_shard_degree": "1", "dataloader_num_workers": "2",
                "dataloader_prefetch_factor": "2", "training_ckpt_async_mode": "disabled",
                "training_log_freq": "1", "training_activation_checkpoint_mode": "full",
                "lr_scheduler_steps": str(chip_smoke.KIMI_SFT_STEPS),
                "lr_scheduler_warmup_steps": "2"}
        if bs == "1":
            cuts["dataset_batchsize"] = "1"
        differ = {}
        for k, v in recipe.items():
            if k == "datalist_dev_path":
                assert k not in got
                continue
            want = resolved.get(v, v)
            try:
                same = float(got[k]) == float(want)
            except ValueError:
                same = got[k].lower() == want.lower()
            if not same:
                differ[k] = got[k]
        assert differ == cuts
        assert set(got) - set(recipe) == {"training_enable_cpu_offload"}


def test_kernels_line_carries_the_kimi_sft_case():
    """Phase 15's (n) lands under K1's and K2's cases; the main rows stay
    (d)."""
    def case(ms):
        return {"max_abs_err": 1e-3, "ms": ms, "plain_ms": 2 * ms, "library_ms": ms / 2,
                "bound_ms": ms / 10, "bound_by": "operations", "tflops": 1.0, "parts": {}}

    name = "(n) kimi_audio tower training: B71 T1500 H20/20 D64 bf16 non-causal"
    k1 = {"(d) main": case(2.0), name: case(6.0)}
    k2 = {"(d) main": case(6.8), name: case(20.0)}
    k3 = {"(d) main": {"fwd": case(13.0), "bwd": case(44.0)}}
    counts = {"K1": 800, "K2": 500, "K3 fwd": 1, "K3 bwd": 1, "K4": 20000}
    rows = chip_smoke.kernels_line(counts, k1, k2, k3, {"(a) decode": case(0.2)})["kernels"]
    assert name in rows[0]["cases"] and name in rows[1]["cases"]
    assert rows[0]["ms"] == 2.0 and rows[1]["ms"] == 6.8 and rows[1]["cases"][name]["ms"] == 20.0


def test_cp_runs_cover_the_allgather_mask():
    """(p)'s library runs for the allgather call: rank 1's queries (global
    positions T..2T) per document against each document's keys from its
    global start, bottom-right causal, cover exactly the live pairs of the
    dense causal + segment mask at q_offset T over all 2T keys; the keys'
    first row is where the runs' keys begin."""
    T = 64
    seg = torch.from_numpy(_packed(1, 2 * T, 4, 7))
    q_runs, k_runs, first = chip_smoke.cp_runs(seg, T)
    assert sum(q_runs) == T and sum(k_runs) == 2 * T - first
    covered = sum(q * (k - q) + q * (q + 1) // 2 for q, k in zip(q_runs, k_runs))
    want = _dense(seg[:, T:].numpy(), seg.numpy(), True, T, 0, T, 2 * T)
    assert covered == want == chip_smoke.live_pairs(seg[:, T:], seg, True, T, 0, T, 2 * T)


# -- phases 18 and 18b ---------------------------------------------------------------

def test_touch_sft_argv_is_the_recipes_stage2_but_the_named_cuts():
    """Every flag of run.sh's stage 2 with model_type touch_audio is in
    touch_sft_argv with the recipe's value, except sft_argv's cuts (dp,
    loader, sync saves, log cadence, steps) and the features: fbank 80 x
    stack 5 stride 4 (the recipe's log-mel 128 x stack 7 is 896 wide against
    Touch-Audio-7B's 400); the remat stays the recipe's none and the moments
    stay on the card."""
    recipe = _run_sh_stage2()
    argv = chip_smoke.touch_sft_argv("L", "E", "C", "T")
    got = dict(zip((a[2:] for a in argv[::2]), argv[1::2]))
    resolved = {"${pretrained_tokenizer_dir}": "T", "${model_type}": "touch_audio",
                "data/${train_set}/data.list": "L", "${bs}": "2", "${max_seq_len}": "8192",
                "${num_workers}": "12", "${prefetch}": "12", "${seed}": "2025",
                "config/${model_config}.json": "C", "exp/${exp_id}": "E", "${cp}": "1",
                "${tp}": "1", "${dp}": "8", "${pp}": "1", "${liger}": "true",
                "${param_dtype}": "bfloat16",
                "wenetspeech asr sft (${model_type})": "wenetspeech asr sft (touch_audio)"}
    cuts = {"training_data_parallel_shard_degree": "1", "dataloader_num_workers": "2",
            "dataloader_prefetch_factor": "2", "training_ckpt_async_mode": "disabled",
            "training_log_freq": "1", "lr_scheduler_steps": "4",
            "lr_scheduler_warmup_steps": "2", "audio_feat_type": "fbank",
            "audiofeat_num_mel_bins": "80"}
    differ = {}
    for k, v in recipe.items():
        if k == "datalist_dev_path":  # phase 18 passes its dev list through extra
            assert k not in got
            continue
        want = resolved.get(v, v)
        try:
            same = float(got[k]) == float(want)
        except ValueError:
            same = got[k].lower() == want.lower()
        if not same:
            differ[k] = got[k]
    assert differ == cuts
    assert {k: got[k] for k in set(got) - set(recipe)} == {
        "training_enable_cpu_offload": "false", "audiofeat_stack_length": "5",
        "audiofeat_stride_length": "4"}


def test_tone_data_and_tokenizer_are_the_jax_closed_loops(tmp_path):
    """tone_jsonl with its defaults draws JAX's closed-loop utterances from
    the same rng (test_task_metric_loop._make_jsonl: texts and wavs equal),
    and tone_tokenizer_dir tokenizes as _char_tokenizer_dir does."""
    from scipy.io import wavfile

    from touchnet_tpu_torch.tokenizer import TokenizerConfig
    from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer

    spec = importlib.util.spec_from_file_location(
        "test_task_metric_loop",
        os.path.join(ROOT, "tests", "touchnet_tpu", "bin", "test_task_metric_loop.py"))
    jloop = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jloop)
    ours = chip_smoke.tone_jsonl(tmp_path / "ours", 6, np.random.default_rng(0), "tr")
    theirs = jloop._make_jsonl(tmp_path / "theirs", 6, np.random.default_rng(0), "tr")
    for a, b in zip(open(ours, encoding="utf8"), open(theirs, encoding="utf8"), strict=True):
        a, b = json.loads(a), json.loads(b)
        assert a["key"] == b["key"] and a["txt"] == b["txt"] and 3 <= len(a["txt"]) <= 5
        assert np.array_equal(wavfile.read(a["wav"])[1], wavfile.read(b["wav"])[1])
    toks = [build_tokenizer(TokenizerConfig(tokenizer_type="HuggingFaceTokenizer",
                                            tokenizer_model=d))
            for d in (chip_smoke.tone_tokenizer_dir(tmp_path / "t1"),
                      jloop._char_tokenizer_dir(tmp_path / "t2"))]
    text = chip_smoke.TONE_CHARS[::-1]
    assert toks[0].tokenize(text, add_special_tokens=False) == \
        toks[1].tokenize(text, add_special_tokens=False) == [9, 8, 7, 6, 5, 4]
    assert [(t.bos, t.eos, t.pad) for t in toks] == [(1, 2, 0)] * 2


def test_char_tokenizer_takes_llama3s_bos_and_pad(tmp_path):
    """Phase 18's tokenizer: Llama-3's bos, eos and pad at their ids, one
    character every other id below 128256."""
    from touchnet_tpu_torch.tokenizer import TokenizerConfig
    from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer

    root = chip_smoke.write_char_tokenizer(
        tmp_path / "tok", 128256, chip_smoke.TOUCH_SPECIALS, chip_smoke.TOUCH_EOS,
        bos=chip_smoke.TOUCH_BOS, pad=chip_smoke.TOUCH_PAD)
    tok = build_tokenizer(TokenizerConfig(tokenizer_type="HuggingFaceTokenizer",
                                          tokenizer_model=str(root)))
    assert (tok.bos, tok.eos, tok.pad) == (128000, 128001, 128004)
    assert tok.vocab_size == 128256
    ids = tok.tokenize("utterance 7", add_special_tokens=False)
    assert len(ids) == 11 and max(ids) < 95 and tok.detokenize(ids) == "utterance 7"


def test_loop_config_is_the_tiny_width_in_one_head(tmp_path):
    from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import (
        TouchAudioConfig,
    )

    tiny = TouchAudioConfig.from_json_file(
        os.path.join(ROOT, "tests/assets/config/tiny_touch_audio.json"))
    cfg = TouchAudioConfig.from_json_file(str(chip_smoke.loop_config(tmp_path)))
    tc = cfg.text_config
    assert (tc.hidden_size, tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim) == \
        (64, 1, 1, 64)
    assert tiny.text_config.head_dim == 16
    assert (tc.vocab_size, tc.num_hidden_layers, tc.intermediate_size) == (64, 2, 128)
    assert cfg.audio_config.input_size == 161 and not tc.tie_word_embeddings
    for c in (cfg, tiny):
        c.text_config.num_attention_heads = c.text_config.num_key_value_heads = 0
        c.text_config.head_dim = 0
    assert cfg.to_dict() == tiny.to_dict()


def test_step_check_leaves_the_trainer_as_it_was(tmp_path):
    """Phase 18's step-1 check on a CPU trainer (bf16, the tiny touch_audio
    config under liger, a batch of one sentence a row): the first rows that
    hold `tokens` positions; the kernel path (on the CPU the wrappers' plain
    route) and the plain path within 1e-5 in bf16 and in f32, bf16 within
    its rounding of f32, report_step_check passing them; no
    launch counted, .grad cleared, the compute dtype the run's again; a
    train step on the whole batch after it equals one without it."""
    from test_torch_touch_audio import _flags, _shards, _trainer

    argv = _flags(tmp_path, _shards(tmp_path, 12), 4, training_mixed_precision_param="bfloat16",
                  dataset_enable_pack="false", dataset_batchsize=1, dataset_audio_seqlen=300,
                  dataset_text_seqlen=300)
    met = []
    for checked in (True, False):
        trainer = _trainer(argv)
        try:
            batch, ns = trainer._put_batch(next(iter(trainer.dataloader)))
            rows, T = batch["labels"].shape
            assert ns == rows > 2
            if checked:
                counts = {k: c.launches for k, c in chip_smoke.kernel_counters().items()}
                got = chip_smoke.step_check(trainer, batch, ns, 2 * T + 1)
                assert (got["rows"], got["T"]) == (2, T)
                assert {k: c.launches for k, c in chip_smoke.kernel_counters().items()} == counts
                assert trainer.compute_dtype == torch.bfloat16
                assert all(p.grad is None for p in trainer.params)
                # the wrappers' CPU route: K2's formula against autograd
                # through the plain forward, the same to f32 rounding
                np.testing.assert_allclose(got["kernel"], got["plain"], rtol=1e-5)
                np.testing.assert_allclose(got["f32 kernel"], got["f32 plain"], rtol=1e-5)
                np.testing.assert_allclose(got["e_kernel"], got["e_plain"], rtol=1e-2)
                assert got["e_f32 kernel"] < 1e-5
                (bl, bn), (fl, fn) = got["plain"], got["f32 plain"]
                assert abs(bl - fl) < 2e-2 and abs(bn - fn) / fn < 2e-2
                assert 0 < got["e_plain"] < 2e-2
                failures = []
                chip_smoke.report_step_check({**got, "peak": 0.0}, "cpu", failures, "CPU")
                assert failures == []
            met.append({k: float(v) for k, v in trainer.train_step(batch, ns).items()})
        finally:
            trainer.close()
    assert met[0] == met[1]


def test_kernels_line_carries_the_touch_audio_head_case():
    """K3's (q), touch_audio's SFT head, lands under both K3 rows' cases;
    their main case stays (d)."""
    def case(ms):
        return {"max_abs_err": 1e-3, "ms": ms, "plain_ms": 2 * ms, "library_ms": None,
                "bound_ms": ms / 2, "bound_by": "operations", "tflops": 1.0}

    k3 = {"(d) main": {"fwd": case(13.0), "bwd": case(44.0)},
          "(q) touch_audio SFT head": {"fwd": case(28.0), "bwd": case(86.0)}}
    counts = {"K1": 600, "K2": 400, "K3 fwd": 9, "K3 bwd": 8, "K4": 20000}
    rows = chip_smoke.kernels_line(counts, {"(d) main": case(2.0)}, {"(d) main": case(6.8)}, k3,
                                   {"(a) decode": case(0.2)})["kernels"]
    assert rows[2]["cases"]["(q) touch_audio SFT head"]["ms"] == 28.0
    assert rows[3]["cases"]["(q) touch_audio SFT head"]["ms"] == 86.0
    assert rows[2]["ms"] == 13.0 and rows[3]["launches"] == 8
