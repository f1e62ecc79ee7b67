# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/data/datapipe.py (framework-free: numpy and the standard
# library), with its imports pointed at the port: every decoder
# (metainfo, texttoken, audiotoken, audio, audio+metainfo,
# audio+metainfo+audiotoken), pick_segment and random_cut_bounds. Three
# changes:
#   - the root counts an item when the next one is asked for
#     (LowLevelTouchDatapipe.__iter__), so a resume re-reads the look-ahead
#     item a batcher holds instead of dropping it, and a resumed run sees
#     the batches of an uninterrupted one. This holds for batchers that
#     yield a batch only when the item just pulled does not fit, or at the
#     end (batch_text, the touch_audio batchers); a batcher that yields
#     right after taking an item in would see that item again after a
#     resume;
#   - the root gives every item a draw_seed: its dp rank, worker, epoch,
#     shard and sample counters at decode time, which a resume restores.
#     The augmentations of data/functions.py seed their draws from it. (The
#     decode seed, epoch + consumed_lists + consumed_samples, is the same
#     for sample k of one shard and sample k - 1 of the next, and for
#     every worker; the segment pick and the random cut keep it, as in JAX);
#   - the audio decoders copy what they read out of the dataset's mmap, so
#     an item outlives its TouchDataset (MMapBinReader.read returns a view
#     of a mapping that the reader closes when it is collected).
#
# Stateful, exactly-resumable streaming datapipes.
#
# Capability parity: reference touchnet/data/datapipe.py:16-213
# (LowLevelTouchDatapipe with 2-level shuffle + 2-level sharding and
# {epoch, consumed_lists, consumed_samples} checkpoint state;
# MidLevelTouchDatapipe generator-composition whose state delegates to the
# root). The SEMANTICS are pinned by the resume-exactness tests
# (tests/touchnet_tpu/data/test_dataloader.py); the structure here is our
# own: per-datatype decoders live in a registry keyed by the data.list
# datatypes column, the shard/sample visit plan and the audio segment /
# random-cut draws are standalone helpers, and the iterator is a thin loop
# over (shard plan x sample order x decoder). Torch-free: RNG is numpy
# PCG64 (deterministic by seed); worker sharding is explicit
# (worker_id/num_workers come from the dataloader, not torch worker_info).

import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy

from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.data.dataset import TouchDataset


def _randperm(n: int, seed: int) -> numpy.ndarray:
    return numpy.random.Generator(numpy.random.PCG64(seed)).permutation(n)


def _randint(low: int, high: int, seed: int) -> int:
    """Uniform integer in [low, high) with a fresh seeded generator."""
    return int(numpy.random.Generator(numpy.random.PCG64(seed)).integers(low, high))


# -- per-datatype decoders ---------------------------------------------------
# A decoder turns (dataset, sample_idx, config, seed) into the item dict the
# downstream map functions consume. `seed` is the resume-stable draw seed
# epoch + consumed_lists + consumed_samples (reference datapipe.py:142-169):
# any in-sample randomness (segment pick, random cut) must derive from it so
# a resumed run re-draws identically.

_DECODERS: Dict[str, Callable] = {}


def register_decoder(datatypes: str):
    def wrap(fn):
        _DECODERS[datatypes] = fn
        return fn

    return wrap


def _read_metainfo(dataset: TouchDataset, sample_idx: int) -> Dict[str, Any]:
    raw = dataset.get(sample_idx, "metainfo")
    return json.loads(raw.tobytes().decode("utf-8").strip())


@register_decoder("metainfo")
def _decode_metainfo(dataset, sample_idx, config, seed):
    # text pre-training from raw text metainfo
    item = _read_metainfo(dataset, sample_idx)
    item["datatypes"] = "metainfo"
    return item


@register_decoder("texttoken")
def _decode_texttoken(dataset, sample_idx, config, seed):
    # text pre-training from pre-tokenized ids
    ids = dataset.get(sample_idx, "texttoken").tolist()
    return dict(input_ids=ids, datatypes="texttoken")


def pick_segment(
    metainfo: Dict[str, Any], seed: int
) -> Optional[Tuple[int, Optional[int], str]]:
    """Segment-based loading: one uniformly drawn utterance segment from the
    metainfo's info.segments, as (sample offset, length, transcript)."""
    segments = (metainfo.get("info") or {}).get("segments")
    if not segments:
        return None
    sr = metainfo["sample_rate"]
    seg = segments[_randint(0, len(segments), seed)]
    start = int(float(seg["start"]) * sr)
    end = int(float(seg["end"]) * sr)
    return start, end - start, seg["txt"]


def random_cut_bounds(
    total_length: int, sample_rate: int, config: DataConfig, seed: int
) -> Optional[Tuple[int, int]]:
    """Random audio crop: (offset, length) in samples, or None when the
    utterance is shorter than the configured minimum. Draws length then
    offset, each from a fresh generator on the SAME seed (reference
    datapipe.py:152-169 — resume-exactness depends on this)."""
    min_len = config.dataset_random_cut_audio_min_length_in_ms / 1000.0 * sample_rate
    max_len = config.dataset_random_cut_audio_max_length_in_ms / 1000.0 * sample_rate
    assert max_len > min_len
    if total_length <= min_len:
        return None
    length = _randint(int(min_len), min(total_length, int(max_len)), seed)
    offset = _randint(0, max(1, total_length - length), seed)
    return offset, length


def _waveform(pcm: numpy.ndarray) -> numpy.ndarray:
    """int16 PCM (a view of the mmap) -> a float32 copy in [-1, 1], [1, T]."""
    return (numpy.array(pcm, dtype=numpy.float32) / 32768.0)[None, :]


@register_decoder("audiotoken")
def _decode_audiotoken(dataset, sample_idx, config, seed):
    # pure audio-LM pretraining over offline BestRQ codes: the codes ARE the
    # token stream, consumable by the causal_lm datapipe exactly like
    # texttoken shards
    ids = dataset.get(sample_idx, "audiotoken").tolist()
    return dict(input_ids=ids, datatypes="audiotoken")


@register_decoder("audio")
def _decode_audio(dataset, sample_idx, config, seed):
    # raw-audio-only shards (no transcript): the sample rate is not stored,
    # so the config's resample target is taken as the decode-time rate
    # (make_data decodes at --audio_resample)
    return {
        "waveform": _waveform(dataset.get(sample_idx, "audio")),
        "sample_rate": config.audio_resample_rate,
        "datatypes": "audio",
    }


@register_decoder("audio+metainfo")
def _decode_audio_metainfo(dataset, sample_idx, config, seed):
    # audio pre-training / audio-text alignment, with optional partial reads
    item = _read_metainfo(dataset, sample_idx)
    offset, length = 0, None
    if config.dataset_load_audio_via_segments:
        picked = pick_segment(item, seed)
        if picked is not None:
            offset, length, item["txt"] = picked
    if config.dataset_random_cut_audio:
        _, total = dataset.get_idx(sample_idx, "audio")
        cut = random_cut_bounds(int(total), item["sample_rate"], config, seed)
        if cut is not None:
            length, offset = cut[1], cut[0]
    item["waveform"] = _waveform(dataset.get(sample_idx, "audio", offset=offset,
                                             length=length))
    item["datatypes"] = "audio+metainfo"
    return item


@register_decoder("audio+metainfo+audiotoken")
def _decode_audio_metainfo_audiotoken(dataset, sample_idx, config, seed):
    # offline-BestRQ audio pretraining: waveform + metainfo as above, plus the
    # precomputed codes. Codes are frame-aligned to the FULL, unperturbed
    # utterance, so the partial-read paths and speed perturb are refused.
    if (
        config.dataset_load_audio_via_segments
        or config.dataset_random_cut_audio
        or config.audio_speed_perturb
    ):
        raise ValueError(
            "audiotoken shards carry codes aligned to the full, unperturbed "
            "utterance: disable dataset_load_audio_via_segments, "
            "dataset_random_cut_audio and audio_speed_perturb, or train from "
            "audio+metainfo shards with online tokenization"
        )
    item = _read_metainfo(dataset, sample_idx)
    if item["sample_rate"] != config.audio_resample_rate:
        raise ValueError(
            f"audiotoken codes were computed at {item['sample_rate']} Hz but "
            f"the config resamples to {config.audio_resample_rate} Hz — the "
            "frame count would no longer match; rebuild the shards at the "
            "training rate"
        )
    item["waveform"] = _waveform(dataset.get(sample_idx, "audio"))
    item["audiotoken"] = numpy.array(dataset.get(sample_idx, "audiotoken"),
                                     dtype=numpy.int32)
    item["datatypes"] = "audio+metainfo+audiotoken"
    return item


# -- the root datapipe -------------------------------------------------------


@dataclass
class _Shard:
    dir: str
    datatypes: str


class LowLevelTouchDatapipe:
    """Root of every pipeline: iterates TouchDataset shards listed in a
    data.list file ("<dir> <datatypes>" lines).

    Two-level shuffle: shard-list permutation seeded by epoch; in-shard sample
    permutation seeded by (epoch + consumed_lists). Two-level sharding:
    dp-rank stride over the shard list, then dataloader-worker stride.
    Resumable via {epoch, consumed_lists, consumed_samples}.
    """

    def __init__(
        self,
        config: DataConfig,
        dp_rank: int,
        dp_world_size: int,
        worker_id: int = 0,
        num_workers: int = 1,
        split: str = "train",
    ):
        datalist_path = {
            "train": config.datalist_path,
            "dev": config.datalist_dev_path,
            "test": config.datalist_test_path,
        }[split]
        self.shards = self._read_datalist(datalist_path)
        self.config = config
        self.dp_rank = dp_rank
        self.dp_world_size = dp_world_size
        self.worker_id = worker_id
        self.num_workers = num_workers

        # Checkpoint state
        self.epoch = 0
        self.consumed_lists = 0
        self.consumed_samples = 0

    @staticmethod
    def _read_datalist(path: str) -> List[_Shard]:
        shards = []
        with open(path, "r") as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                assert len(parts) == 2, f"bad data.list line: {line!r}"
                shards.append(_Shard(dir=parts[0], datatypes=parts[1]))
        return shards

    # -- checkpoint state --------------------------------------------------
    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.epoch = state_dict["epoch"]
        self.consumed_lists = state_dict["consumed_lists"]
        self.consumed_samples = state_dict["consumed_samples"]

    def state_dict(self) -> Dict[str, Any]:
        return {
            "epoch": self.epoch,
            "consumed_lists": self.consumed_lists,
            "consumed_samples": self.consumed_samples,
        }

    # -- visit plan ---------------------------------------------------------
    def _epoch_shard_plan(self, epoch: int) -> List[int]:
        """This worker's shard indices for one epoch: optional shuffle
        (seeded by epoch), dp-rank stride, then dataloader-worker stride."""
        cfg = self.config
        idxs = (
            _randperm(len(self.shards), epoch).tolist()
            if cfg.datalist_shuffling
            else list(range(len(self.shards)))
        )
        if cfg.datalist_sharding:
            assert len(idxs) >= self.dp_world_size, (
                f"{len(idxs)} shards < dp_world_size {self.dp_world_size}"
            )
            idxs = idxs[self.dp_rank :: self.dp_world_size]
        if cfg.datalist_epoch > 1:
            assert len(idxs) >= self.num_workers, (
                f"{len(idxs)} shards < num_workers {self.num_workers}"
            )
        return idxs[self.worker_id :: self.num_workers]

    def _sample_order(self, num_samples: int) -> List[int]:
        if not self.config.dataset_shuffling:
            return list(range(num_samples))
        return _randperm(num_samples, self.epoch + self.consumed_lists).tolist()

    # -- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, Any]]:
        cfg = self.config
        while self.epoch < cfg.datalist_epoch:
            plan = self._epoch_shard_plan(self.epoch)
            for shard_idx in plan[self.consumed_lists:]:
                shard = self.shards[shard_idx]
                decode = _DECODERS.get(shard.datatypes)
                if decode is None:
                    raise NotImplementedError(
                        f"unsupported datatypes: {shard.datatypes}"
                    )
                dataset = TouchDataset(shard.dir, cfg.dataset_mmap, shard.datatypes)
                order = self._sample_order(len(dataset))
                for sample_idx in order[self.consumed_samples:]:
                    seed = self.epoch + self.consumed_lists + self.consumed_samples
                    item = decode(dataset, sample_idx, cfg, seed)
                    item["draw_seed"] = (f"{self.dp_rank}.{self.worker_id}.{self.epoch}."
                                         f"{self.consumed_lists}.{self.consumed_samples}")
                    yield item
                    # counted when the consumer asks for the next item, not
                    # before the yield: a state_dict() taken while the
                    # batcher holds this item as its look-ahead (it yields a
                    # batch when the item it pulled does not fit) resumes AT
                    # this item, which goes into the next batch, as it does
                    # in an uninterrupted run
                    self.consumed_samples += 1
                self.consumed_samples = 0
                self.consumed_lists += 1
            self.consumed_lists = 0
            self.epoch += 1


class MidLevelTouchDatapipe:
    """Generator-function composition node: wraps ``f(iter(source), *args)``.
    Checkpoint state delegates to the source, so a whole chain checkpoints
    through its root LowLevelTouchDatapipe."""

    def __init__(self, source, f: Callable, *args, **kw):
        assert callable(f)
        self.source = source
        self.f = f
        self.args = args
        self.kw = kw

    def __iter__(self):
        assert self.source is not None
        return self.f(iter(self.source), *self.args, **self.kw)

    def apply(self, f: Callable) -> "MidLevelTouchDatapipe":
        assert callable(f)
        return MidLevelTouchDatapipe(self, f, *self.args, **self.kw)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.source.load_state_dict(state_dict)

    def state_dict(self) -> Dict[str, Any]:
        return self.source.state_dict()
