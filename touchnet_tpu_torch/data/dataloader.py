# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/data/dataloader.py (framework-free: numpy and the standard
# library), with its imports pointed at the port. build_dataloader
# takes causal_lm, touch_audio and qwen2_audio (whose datapipe checks the
# tokenizer against the model config's audio_token_index, so the caller
# passes model_config); kimi_audio raises as a later slice.
#
# Parallelism-aware, exactly-resumable dataloader.
#
# Capability parity: reference touchnet/data/dataloader.py:30-163
# (ParallelAwareDataloader on torchdata StatefulDataLoader: per-dp-rank state
# key, world-size guard, worker round-robin, get_epoch). Re-designed without
# torchdata: each "worker" is a full datapipe chain over its shard stripe
# (worker_id/num_workers striding inside LowLevelTouchDatapipe); batches are
# multiplexed round-robin. Exact resume is guaranteed by snapshotting the root
# datapipe state *after* each produced batch and keying the loader state by
# the consumed batch, so prefetched-but-unconsumed batches are replayed.
#
# Generator batchers (batch_text) hold one look-ahead sample (the overflow
# item that triggered a yield). The reference and the JAX package drop it on
# resume; the port's root datapipe counts an item only once the next is
# pulled (datapipe.py), so the resumed state re-reads it and a resumed run
# gets the batches of an uninterrupted one.
#
# One change: shutdown() leaves an end-of-stream mark in each worker's
# queue, so a consumer blocked on a worker that stopped producing wakes
# and ends (the JAX loader leaves it waiting).

import copy
import functools
import queue
import threading
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Iterator, List, Optional

from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.utils.logging import logger

_SENTINEL = object()


class BaseDataLoader(ABC):
    """Base class for all dataloaders: stateful + iterable."""

    @abstractmethod
    def __iter__(self):
        ...

    @abstractmethod
    def state_dict(self) -> Dict[str, Any]:
        ...

    @abstractmethod
    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        ...

    @abstractmethod
    def get_epoch(self) -> int:
        ...


class _Worker:
    """One datapipe chain + optional background prefetch thread."""

    def __init__(self, pipe, prefetch_factor: int, threaded: bool):
        self.pipe = pipe  # Mid/LowLevel datapipe chain (stateful via root)
        self.prefetch_factor = max(1, prefetch_factor)
        self.threaded = threaded
        self.consumed_state = pipe.state_dict()
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._iter = None
        self._exhausted = False
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()

    def start(self):
        if self.threaded:
            self._queue = queue.Queue(maxsize=self.prefetch_factor)
            self._thread = threading.Thread(target=self._fill, daemon=True)
            self._thread.start()
        else:
            self._iter = iter(self.pipe)

    def _fill(self):
        try:
            for batch in self.pipe:
                state = copy.deepcopy(self.pipe.state_dict())
                while not self._stop.is_set():
                    try:
                        self._queue.put((batch, state), timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # surface worker crashes to the consumer
            self._error = e
            if not self._stop.is_set():
                self._queue.put((_SENTINEL, None))
            return
        if not self._stop.is_set():
            # final state (epoch counters advance when the generator ends)
            self._queue.put((_SENTINEL, copy.deepcopy(self.pipe.state_dict())))

    def next(self):
        """Returns a batch or _SENTINEL when exhausted. Updates consumed_state."""
        if self._exhausted:
            return _SENTINEL
        if self.threaded:
            batch, state = self._queue.get()
            if batch is _SENTINEL:
                self._exhausted = True
                if self._error is not None:
                    raise self._error
                if state is not None:
                    self.consumed_state = state
                return _SENTINEL
            self.consumed_state = state
            return batch
        else:
            try:
                batch = next(self._iter)
            except StopIteration:
                self._exhausted = True
                self.consumed_state = copy.deepcopy(self.pipe.state_dict())
                return _SENTINEL
            self.consumed_state = copy.deepcopy(self.pipe.state_dict())
            return batch

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            # drain so the producer can observe the stop event
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            # wake a consumer blocked in next() on this worker: a stopped
            # producer puts nothing more, and the consumer (the trainer's
            # prefetch thread, which holds the trainer) would wait forever
            try:
                self._queue.put_nowait((_SENTINEL, None))
            except queue.Full:
                pass
            self._thread.join(timeout=5.0)


class ParallelAwareDataloader(BaseDataLoader):
    """Round-robins batches from ``num_workers`` stateful datapipe chains.

    Args:
        datapipe_factory: fn(worker_id, num_workers) -> datapipe chain.
        dp_rank / dp_world_size: data-parallel coordinates; state is keyed by
            rank and guarded against world-size changes (no resharding).
        num_workers: worker stripe count (0 => single in-thread chain).
        prefetch_factor: per-worker queue depth when threaded.
    """

    def __init__(
        self,
        datapipe_factory: Callable,
        dp_rank: int,
        dp_world_size: int,
        num_workers: int = 0,
        prefetch_factor: int = 2,
        threaded: Optional[bool] = None,
    ):
        self.dp_rank = dp_rank
        self.dp_world_size = dp_world_size
        self._rank_id = f"dp_rank_{dp_rank}"
        self.num_workers = max(1, num_workers)
        self.threaded = threaded if threaded is not None else num_workers > 0
        self.prefetch_factor = prefetch_factor
        self.workers: List[_Worker] = [
            _Worker(datapipe_factory(w, self.num_workers), prefetch_factor, self.threaded)
            for w in range(self.num_workers)
        ]
        self.next_worker = 0
        self._started = False

    def __iter__(self) -> Iterator:
        if not self._started:
            for w in self.workers:
                w.start()
            self._started = True
        while True:
            active = [w for w in self.workers if not w._exhausted]
            if not active:
                return
            w = self.workers[self.next_worker % self.num_workers]
            self.next_worker = (self.next_worker + 1) % self.num_workers
            if w._exhausted:
                continue
            batch = w.next()
            if batch is _SENTINEL:
                continue
            yield batch

    def state_dict(self) -> Dict[str, Any]:
        return {
            self._rank_id: {
                "worker_states": [w.consumed_state for w in self.workers],
                "next_worker": self.next_worker,
                "num_workers": self.num_workers,
            },
            "world_size": self.dp_world_size,
        }

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        if not state_dict:
            return
        if self._rank_id not in state_dict:
            logger.warning(f"DataLoader state is empty for dp rank {self.dp_rank}, "
                           "expected key {self._rank_id}")
            return
        assert self.dp_world_size == state_dict["world_size"], (
            "dp_degree is inconsistent before and after checkpoint, "
            "dataloader resharding is not supported yet."
        )
        sub = state_dict[self._rank_id]
        assert sub["num_workers"] == self.num_workers, (
            "dataloader_num_workers changed across resume; not supported."
        )
        for w, s in zip(self.workers, sub["worker_states"]):
            w.pipe.load_state_dict(copy.deepcopy(s))
            w.consumed_state = copy.deepcopy(s)
        self.next_worker = sub["next_worker"]

    def get_epoch(self) -> int:
        return min(w.consumed_state.get("epoch", 0) for w in self.workers)

    def shutdown(self):
        for w in self.workers:
            w.shutdown()


def build_dataloader(
    data_config: DataConfig,
    tokenizer,
    dp_rank: int,
    dp_world_size: int,
    split: str = "train",
    model_config=None,
) -> ParallelAwareDataloader:
    """Dispatch on datapipe_type to the per-model datapipe builder; dev/test
    splits force no-shuffle / no-augment / 1 epoch (reference
    touchnet/data/dataloader.py:114-163). qwen2_audio needs ``model_config``
    (a Qwen2AudioConfig: its audio_token_index)."""
    config = copy.deepcopy(data_config)
    if split != "train":
        config.datalist_shuffling = False
        config.dataset_shuffling = False
        config.datalist_epoch = 1
        config.audio_speed_perturb = False
        config.audiofeat_spec_aug = False
        config.audiofeat_spec_sub = False
        config.audiofeat_spec_trim = False
        config.dataloader_drop_last_batch = False

    if config.datapipe_type == "causal_lm":
        from touchnet_tpu_torch.models.llama.processing_llama import causal_lm_datapipe as builder
    elif config.datapipe_type == "touch_audio":
        from touchnet_tpu_torch.models.touch_audio.processing_touch_audio import (
            touch_audio_datapipe as builder,
        )
    elif config.datapipe_type == "qwen2_audio":
        from touchnet_tpu_torch.models.qwen2_audio.processing_qwen2_audio import (
            qwen2_audio_datapipe,
        )

        if model_config is None or not hasattr(model_config, "audio_token_index"):
            raise ValueError("datapipe_type qwen2_audio needs the model's config (its "
                             "audio_token_index): train with --training_model_name qwen2_audio")
        builder = functools.partial(qwen2_audio_datapipe,
                                    audio_token_index=model_config.audio_token_index)
    else:
        raise NotImplementedError(
            f"datapipe_type {config.datapipe_type!r}: causal_lm, touch_audio and qwen2_audio "
            "are ported; kimi_audio is a later slice"
        )

    def factory(worker_id: int, num_workers: int):
        return builder(
            config, tokenizer, dp_rank, dp_world_size,
            worker_id=worker_id, num_workers=num_workers, split=split,
        )

    return ParallelAwareDataloader(
        factory,
        dp_rank=dp_rank,
        dp_world_size=dp_world_size,
        num_workers=config.dataloader_num_workers,
        prefetch_factor=config.dataloader_prefetch_factor,
    )
