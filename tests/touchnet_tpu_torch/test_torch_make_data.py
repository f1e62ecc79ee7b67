# Stage 0 (make_data) and the HF tokenizer of the port against the JAX
# package on the CPU, hermetic (the jsonl and a char-level HF tokenizer are
# built in the test):
#   - the port's and the JAX CLI on the same jsonl write byte-identical
#     .bin and .idx files per shard and the same data.list (up to the save
#     directory): texttoken with the char-level HuggingFaceTokenizer,
#     texttoken with RawTokenizer on id lists, metainfo, and both at once;
#     the shards read back through the port's TouchDataset give the ids;
#     (the audio datatypes: test_torch_audio_frontend.py);
#   - HuggingFaceTokenizer equals JAX's on ids, detokenize, vocab_size,
#     bos, eos and pad; BestRQTokenizer raises for an init method it does
#     not know (the codes: test_torch_bestrq.py).

import json

import numpy as np
import pytest

from touchnet_tpu.bin.make_data import main as jmake_data
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.tokenizer.tokenizer import build_tokenizer as jbuild_tokenizer
from touchnet_tpu_torch.bin.make_data import main as make_data
from touchnet_tpu_torch.data.dataset import TouchDataset
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer

CHARS = "abcdefghijklmnopqrstuvwxyz .,'"


def char_tokenizer_dir(outdir):
    """A char-level HF tokenizer (tests/touchnet_tpu/bin/test_task_metric_loop.py)."""
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"[PAD]": 0, "[BOS]": 1, "[EOS]": 2, "[UNK]": 3}
    for ch in CHARS:
        vocab[ch] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Split(Regex("."), behavior="isolated")
    tok.decoder = decoders.Fuse()
    PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="[PAD]", bos_token="[BOS]",
        eos_token="[EOS]", unk_token="[UNK]",
    ).save_pretrained(outdir)
    return str(outdir)


def _jsonl(path, n, ids):
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for i in range(n):
            k = int(rng.integers(0, 40))  # some empty texts: skipped by texttoken
            if ids:
                text = [int(x) for x in rng.integers(0, 100000, k)]
            else:
                text = "".join(CHARS[j] for j in rng.integers(0, len(CHARS), k))
            f.write(json.dumps({"key": f"utt{i}", "text": text}, ensure_ascii=False) + "\n")
    return str(path)


def _tok_flags(kind, tmp_path):
    if kind == "hf":
        return ["--tokenizer_type", "HuggingFaceTokenizer",
                "--tokenizer_model", char_tokenizer_dir(tmp_path / "tok")]
    return ["--tokenizer_type", "RawTokenizer", "--tokenizer_raw_vocab_size", "128256"]


@pytest.mark.parametrize("datatypes,tok", [("texttoken", "hf"), ("texttoken", "raw"),
                                           ("metainfo", "raw"), ("texttoken+metainfo", "hf")])
def test_make_data_matches_jax(tmp_path, datatypes, tok):
    jsonl = _jsonl(tmp_path / "data.jsonl", 23, ids=tok == "raw")
    flags = _tok_flags(tok, tmp_path)
    outs = {}
    for name, fn in (("port", make_data), ("jax", jmake_data)):
        save = tmp_path / name
        fn(["--save_dir", str(save), "--jsonl_path", jsonl, "--num_utt_per_shard", "10",
            "--num_workers", "2", "--datatypes", datatypes] + flags)
        outs[name] = save
    port, jax_ = outs["port"], outs["jax"]
    lines = (port / "data.list").read_text().splitlines()
    assert lines == (jax_ / "data.list").read_text().replace(str(jax_), str(port)).splitlines()
    assert len(lines) == 3
    for line in lines:
        shard = line.split()[0]
        files = sorted(p.name for p in (port / shard).iterdir())
        assert files == sorted(f"{d}.{e}" for d in datatypes.split("+") for e in ("bin", "idx"))
        for f in files:
            assert (port / shard / f).read_bytes() == (jax_ / shard / f).read_bytes(), f
    if "texttoken" in datatypes:
        tokenizer = build_tokenizer(TokenizerConfig(
            **{k.lstrip("-"): v for k, v in zip(flags[::2], flags[1::2])}))
        records = [json.loads(ln) for ln in open(jsonl)]
        want = [tokenizer.tokenize(r["text"], add_special_tokens=False)
                for r in records if r["text"]]
        got = []
        for line in lines:
            ds = TouchDataset(line.split()[0], datatypes="texttoken")
            got += [ds.get(i, "texttoken").tolist() for i in range(len(ds))]
        assert got == want


@pytest.mark.parametrize("datatypes", ["audio", "audiotoken", "audio+metainfo"])
def test_make_data_audio_raises(tmp_path, datatypes):
    """The audio datatypes build (byte for byte JAX's:
    test_torch_audio_frontend.py); what raises is a datatypes string that
    names one of them twice, as in the JAX CLI."""
    from test_torch_audio_frontend import write_audio_jsonl

    jsonl = write_audio_jsonl(tmp_path / "wav", 3, seed=0)
    save = tmp_path / "out"
    make_data(["--save_dir", str(save), "--jsonl_path", jsonl, "--datatypes", datatypes,
               "--num_workers", "1", "--tokenizer_type", "BestRQTokenizer",
               "--tokenizer_bestrq_vocab_size", "64", "--tokenizer_bestrq_input_size", "161"])
    (shard,) = [ln.split()[0] for ln in (save / "data.list").read_text().splitlines()]
    assert len(TouchDataset(shard, datatypes=datatypes)) == 3
    with pytest.raises(NotImplementedError, match="unsupported datatypes"):
        make_data(["--save_dir", str(tmp_path / "again"), "--jsonl_path", jsonl,
                   "--datatypes", f"{datatypes}+{datatypes.split('+')[0]}"])


def test_make_data_refuses_audio_resample(tmp_path):
    """--audio_resample is a flag of the audio datatypes again (the rate
    they decode at: a 16 kHz wav read at 8 kHz holds half the samples); a
    flag that no datatype reads is refused as a parse error."""
    from test_torch_audio_frontend import write_audio_jsonl

    jsonl = write_audio_jsonl(tmp_path / "wav", 2, seed=1)
    lens = {}
    for rate in (16000, 8000):
        save = tmp_path / f"out{rate}"
        make_data(["--save_dir", str(save), "--jsonl_path", jsonl, "--datatypes", "audio",
                   "--num_workers", "1", "--audio_resample", str(rate)])
        shard = (save / "data.list").read_text().split()[0]
        ds = TouchDataset(shard, datatypes="audio")
        lens[rate] = [len(ds.get(i, "audio")) for i in range(len(ds))]
    assert all(abs(a - 2 * b) <= 2 for a, b in zip(lens[16000], lens[8000]))
    with pytest.raises(SystemExit):
        make_data(["--save_dir", str(tmp_path / "x"), "--jsonl_path", jsonl,
                   "--datatypes", "audio", "--tmp_dir", str(tmp_path)])


def test_hf_tokenizer_matches_jax(tmp_path):
    path = char_tokenizer_dir(tmp_path / "tok")
    ours = build_tokenizer(TokenizerConfig(tokenizer_type="HuggingFaceTokenizer",
                                           tokenizer_model=path))
    theirs = jbuild_tokenizer(JTokenizerConfig(tokenizer_type="HuggingFaceTokenizer",
                                               tokenizer_model=path))
    assert type(ours).__name__ == type(theirs).__name__ == "HuggingFaceTokenizer"
    for text in ("hello world.", "a,b c'd", ""):
        for special in (True, False):
            ids = ours.tokenize(text, add_special_tokens=special)
            assert ids == theirs.tokenize(text, add_special_tokens=special)
            assert ours.detokenize(ids) == theirs.detokenize(ids)
    assert ours.detokenize(ours.tokenize("hello world.")) == "hello world."
    for attr in ("vocab_size", "bos", "eos", "pad", "vocab"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert (ours.vocab_size, ours.bos, ours.eos, ours.pad) == (len(CHARS) + 4, 1, 2, 0)


def test_bestrq_tokenizer_raises():
    """An init method other than "default" raises at first use, as JAX's."""
    tok = build_tokenizer(TokenizerConfig(tokenizer_type="BestRQTokenizer",
                                          tokenizer_bestrq_init_method="kmeans"))
    with pytest.raises(NotImplementedError, match="kmeans"):
        tok.tokenize(np.zeros((2, 560), np.float32))
