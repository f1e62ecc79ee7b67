# BestRQTokenizer and the touch_audio batchers of the port against the JAX
# package on the CPU, on inputs made by numpy from a seed:
#   - BEST-RQ codes against JAX's BestRQTokenizer: agreement 1.0 (as
#     tests/touchnet_tpu/data/test_torch_rng.py demands of JAX's against
#     torch), at the recipe's shape (input 400, emb 16, vocab 1024, seed
#     2025) and two others; the projection equals JAX's bit for bit and the
#     codebook within a few ulps (JAX replays torch's generator);
#   - each batcher's arrays against JAX's on the same samples: equal
#     (batch_audio_packed, batch_pairaudio_pairtext_packed, batch_audio,
#     batch_pairaudio_pairtext; online codes and offline ones), but for
#     batch_pairaudio_pairtext's sentence_lens, the port's a row's label
#     count and JAX's one less (a reference fault, ROADMAP.md §3);
#   - touch_audio_datapipe's batches against JAX's on the same shards (speed
#     perturb off: the JAX draws come from the module-level random): equal;
#   - a resume test on each packed batcher, through the threaded loader
#     with speed perturb on: N batches straight, then k, state_dict, a new
#     loader from that state and N - k more; every array equal;
#   - a BestRQ input size that is not the stacked features' width raises
#     at setup;
#   - the loader's shutdown wakes a consumer blocked on a slow worker.

import copy

import numpy as np
import pytest
import torch

from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.data import native as jnative
from touchnet_tpu.models.touch_audio import processing_touch_audio as jproc
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.tokenizer.tokenizer import BestRQTokenizer as JBestRQ
from touchnet_tpu.tokenizer.tokenizer import build_tokenizer as jbuild_tokenizer
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.data.dataloader import build_dataloader
from touchnet_tpu_torch.models.touch_audio import processing_touch_audio as proc
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import BestRQTokenizer, build_tokenizer
from test_torch_audio_frontend import build_audio_shards, write_audio_jsonl

BESTRQ_KW = dict(tokenizer_bestrq_input_size=161, tokenizer_bestrq_emb_size=8,
                 tokenizer_bestrq_vocab_size=64)


@pytest.mark.parametrize("inp,emb,vocab,seed", [(400, 16, 1024, 2025), (80, 16, 1024, 2025),
                                                (161, 8, 64, 7)])
def test_bestrq_codes_match_jax(inp, emb, vocab, seed):
    kw = dict(tokenizer_bestrq_input_size=inp, tokenizer_bestrq_emb_size=emb,
              tokenizer_bestrq_vocab_size=vocab, tokenizer_bestrq_init_seed=seed)
    ours = build_tokenizer(TokenizerConfig(tokenizer_type="BestRQTokenizer", **kw))
    theirs = JBestRQ(JTokenizerConfig(**kw))
    feats = np.random.default_rng(seed).standard_normal((3000, inp)).astype(np.float32)
    got, want = np.asarray(ours.tokenize(feats)), np.asarray(theirs.tokenize(feats))
    assert (got == want).mean() == 1.0
    assert len(set(got.tolist())) > vocab // 4  # the codes are spread
    assert ours.vocab_size == theirs.vocab_size == vocab
    ours._build_quantizer_and_codebook()
    theirs._build_quantizer_and_codebook()
    np.testing.assert_array_equal(ours._quantizer, theirs._quantizer)
    np.testing.assert_allclose(ours.detokenize(got[:5]), theirs.detokenize(got[:5]),
                               atol=1e-6)
    assert (ours.bos, ours.eos, ours.pad) == (None, None, None)


def test_bestrq_is_the_torch_construction():
    """The port draws from torch.Generator().manual_seed(seed) with
    xavier_uniform_ then normal_, the original TouchNet's construction."""
    tok = BestRQTokenizer(TokenizerConfig(**BESTRQ_KW, tokenizer_bestrq_init_seed=11))
    g = torch.Generator().manual_seed(11)
    q, c = torch.empty(161, 8), torch.empty(64, 8)
    torch.nn.init.xavier_uniform_(q, generator=g)
    torch.nn.init.normal_(c, generator=g)
    tok._build_quantizer_and_codebook()
    np.testing.assert_array_equal(tok._quantizer, q.numpy())
    np.testing.assert_allclose(tok._codebook, (c / c.norm(dim=1, keepdim=True)).numpy(),
                               atol=1e-7)


# -- batchers ------------------------------------------------------------------

def _stream(n, seed, width=161, text=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = {"audiofeat": rng.standard_normal((int(rng.integers(3, 14)), width))
             .astype(np.float32)}
        if text:
            s["input_ids"] = [int(x) for x in rng.integers(3, 60, int(rng.integers(1, 5)))]
        out.append(s)
    return out


def _with_offline_codes(samples, tok):
    out = copy.deepcopy(samples)
    for s in out:
        s["audiotoken"] = np.asarray(tok.tokenize(s["audiofeat"]) + [5, 6], np.int32)
    return out


def _equal_batches(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


class _TextTok:
    bos, eos, pad = 1, 2, 0


@pytest.mark.parametrize("name,packed,text,offline", [
    ("batch_audio_packed", True, False, False),
    ("batch_audio_packed", True, False, True),
    ("batch_audio", False, False, False),
    ("batch_pairaudio_pairtext_packed", True, True, False),
    ("batch_pairaudio_pairtext", False, True, False),
])
def test_batchers_match_jax(name, packed, text, offline):
    for drop_last in (True, False):
        kw = dict(dataset_batchsize=3, dataset_audio_seqlen=32, dataset_text_seqlen=32,
                  dataloader_drop_last_batch=drop_last)
        tok = BestRQTokenizer(TokenizerConfig(**BESTRQ_KW))
        jtok = _TextTok() if text else JBestRQ(JTokenizerConfig(**BESTRQ_KW))
        samples = _stream(40, 1, text=text)
        if offline:
            samples = _with_offline_codes(samples, tok)
        got = list(getattr(proc, name)(iter(copy.deepcopy(samples)), DataConfig(**kw),
                                       _TextTok() if text else tok))
        want = list(getattr(jproc, name)(iter(copy.deepcopy(samples)), JDataConfig(**kw),
                                         jtok))
        if name == "batch_pairaudio_pairtext":
            # the port's sentence_lens is a row's label count, len(ids) + 1;
            # JAX's is len(ids) (a reference fault the port does not copy)
            for w in want:
                w["sentence_lens"] = w["sentence_lens"] + w["attention_mask"]
        _equal_batches(got, want)


# -- the datapipe --------------------------------------------------------------

def _audio_flags(listfile, **over):
    kw = dict(datapipe_type="touch_audio", datalist_path=listfile, datalist_epoch=3,
              dataset_enable_pack=True, dataset_batchsize=2, dataset_audio_seqlen=48,
              dataset_text_seqlen=48, audio_speed_perturb=False, audiofeat_spec_aug=False,
              audiofeat_spec_sub=False, dataloader_num_workers=0)
    kw.update(over)
    return kw


def test_datapipe_matches_jax(tmp_path, monkeypatch):
    """The whole chain on make_data shards, packed BEST-RQ batches, numpy
    frontend in both (TOUCHNET_NATIVE=0; the native ones agree bit for bit,
    test_torch_audio_frontend.py): the same batches."""
    monkeypatch.setenv("TOUCHNET_NATIVE", "0")
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_failed", False)
    listfile = build_audio_shards(tmp_path / "shards",
                                  write_audio_jsonl(tmp_path / "wav", 10, seed=2), per_shard=4)
    kw = _audio_flags(listfile, datalist_epoch=1, dataloader_drop_last_batch=False)
    tok_kw = dict(tokenizer_type="BestRQTokenizer", **BESTRQ_KW)
    got = list(build_dataloader(DataConfig(**kw), build_tokenizer(TokenizerConfig(**tok_kw)),
                                0, 1))
    want = list(proc_jax_loader(JDataConfig(**kw), jbuild_tokenizer(JTokenizerConfig(**tok_kw))))
    _equal_batches(got, want)


def proc_jax_loader(cfg, tok):
    from touchnet_tpu.data.dataloader import build_dataloader as jbuild_dataloader

    return jbuild_dataloader(cfg, tok, 0, 1)


def _take(loader, n):
    out = []
    for b in loader:
        out.append(copy.deepcopy(b))
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("pair", [False, True], ids=["batch_audio_packed",
                                                     "batch_pairaudio_pairtext_packed"])
def test_packed_batcher_resume_is_exact(tmp_path, pair):
    """N batches straight against k, a checkpoint of the loader's state, and
    N - k from a new loader built on it: every array equal. Two threaded
    workers, speed perturb on (its draws come from each sample's draw_seed,
    which the resumed root gives again)."""
    jsonl = write_audio_jsonl(tmp_path / "wav", 14, seed=3, txt_vocab=60 if pair else None)
    listfile = build_audio_shards(tmp_path / "shards", jsonl, per_shard=3)
    kw = _audio_flags(listfile, audio_speed_perturb=True, dataloader_num_workers=2)
    tok_kw = (dict(tokenizer_type="RawTokenizer", tokenizer_raw_vocab_size=64) if pair
              else dict(tokenizer_type="BestRQTokenizer", **BESTRQ_KW))
    cfg, tok = DataConfig(**kw), build_tokenizer(TokenizerConfig(**tok_kw))
    N, k = 8, 3
    straight = build_dataloader(cfg, tok, 0, 1)
    want = _take(straight, N)
    straight.shutdown()
    first = build_dataloader(cfg, tok, 0, 1)
    got = _take(first, k)
    state = copy.deepcopy(first.state_dict())
    first.shutdown()
    second = build_dataloader(cfg, tok, 0, 1)
    second.load_state_dict(state)
    got += _take(second, N - k)
    second.shutdown()
    _equal_batches(got, want)
    if pair:
        assert all((b["input_ids"] != 0).any() for b in got)


def test_bestrq_input_size_must_match_the_features(tmp_path):
    cfg = DataConfig(**_audio_flags(str(tmp_path / "data.list")))  # 23 mel bins x 7 = 161
    tok = build_tokenizer(TokenizerConfig(tokenizer_type="BestRQTokenizer",
                                          tokenizer_bestrq_input_size=400))
    with pytest.raises(ValueError, match="161 wide"):
        proc.touch_audio_datapipe(cfg, tok, 0, 1)


def test_shutdown_wakes_a_consumer_blocked_on_a_slow_worker():
    """A consumer waiting on a worker that is still making its next batch
    (the trainer's prefetch thread when a run ends under slow audio
    workers) ends once the loader shuts down, instead of waiting forever
    and keeping alive what it references (a whole Trainer, on the card)."""
    import threading
    import time

    from touchnet_tpu_torch.data.dataloader import ParallelAwareDataloader

    release = threading.Event()

    class Slow:
        def __iter__(self):
            yield {"x": 0}
            release.wait(30)  # still making the next batch at shutdown
            yield {"x": 1}

        def state_dict(self):
            return {}

        def load_state_dict(self, state):
            pass

    loader = ParallelAwareDataloader(lambda w, n: Slow(), 0, 1, num_workers=1,
                                     prefetch_factor=1)
    got = []
    consumer = threading.Thread(target=lambda: got.extend(loader), daemon=True)
    consumer.start()
    deadline = time.monotonic() + 10
    while loader.workers[0]._queue is None or (
            loader.workers[0]._queue.empty() and not got) and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)  # the consumer now waits on the worker's second batch
    threading.Timer(0.3, release.set).start()
    loader.shutdown()
    consumer.join(timeout=5)
    assert not consumer.is_alive()
    assert not loader.workers[0]._thread.is_alive()
