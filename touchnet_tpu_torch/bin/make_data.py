# Copyright (c) 2026 touchnet_tpu authors.
# Stage 0 of the recipes: jsonl -> sharded TouchDataset (.bin/.idx) + data.list.
#
#     python -m touchnet_tpu_torch.bin.make_data --save_dir <d> --jsonl_path <f> \
#         --datatypes texttoken --num_utt_per_shard N --num_workers W <tokenizer flags>
#
# Port of touchnet_tpu/bin/make_data.py: DataBuilder (:35-62), build_shard
# (:152-224) for the texttoken and metainfo datatypes, _chunked and main
# with its multiprocessing pool and the data.list it writes (:236-284). The
# files are byte for byte the JAX CLI's. Host-only: numpy and the tokenizer.
# The audio and audiotoken datatypes need the audio decode, the frontends
# and BestRQ, and raise a ValueError naming the audio slice.
#
# One departure: a shard whose worker raised fails the run here (the JAX
# CLI logs the error and still lists the broken shard in data.list).

import json
import multiprocessing
import os
from typing import Iterable, List, Type

import numpy

from touchnet_tpu_torch.bin import MakeDataConfig
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.data.dataset import DType, IndexWriter
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
from touchnet_tpu_torch.utils.cli import parse_args_into_dataclasses
from touchnet_tpu_torch.utils.logging import init_logger, logger

DATATYPE_NAMES = ("audio", "metainfo", "audiotoken", "texttoken")
AUDIO_DATATYPES = ("audio", "audiotoken")


class DataBuilder:
    """Writer side of TouchDataset: append items to .bin, record lengths,
    then finalize() writes the .idx sidecar."""

    def __init__(self, bin_path: str, dtype: Type[numpy.number] = numpy.int32):
        self.dtype = dtype
        self.data_file = open(bin_path, "wb")
        self.sequence_lengths: List[int] = []
        self.document_indices: List[int] = [0]

    def add_item(self, array) -> None:
        arr = numpy.asarray(array, dtype=self.dtype)
        self.data_file.write(arr.tobytes(order="C"))
        self.sequence_lengths.append(arr.size)

    def add_document(self, array, lengths: List[int]) -> None:
        arr = numpy.asarray(array, dtype=self.dtype)
        self.data_file.write(arr.tobytes(order="C"))
        self.sequence_lengths.extend(lengths)
        self.document_indices.append(len(self.sequence_lengths))

    def end_document(self) -> None:
        self.document_indices.append(len(self.sequence_lengths))

    def finalize(self, idx_path: str) -> None:
        self.data_file.close()
        with IndexWriter(idx_path, self.dtype) as writer:
            writer.write(self.sequence_lengths, self.document_indices)


def check_datatypes(datatypes: str) -> List[str]:
    """The '+'-joined datatypes, each once; raises for an unknown one
    (NotImplementedError, as the JAX CLI) and for an audio one (ValueError)."""
    parts = datatypes.split("+")
    bad = [p for p in parts if p not in DATATYPE_NAMES]
    if bad or len(set(parts)) != len(parts):
        raise NotImplementedError(
            f"unsupported datatypes {datatypes!r}: expected a '+'-combination of "
            f"{DATATYPE_NAMES}")
    audio = [p for p in parts if p in AUDIO_DATATYPES]
    if audio:
        raise ValueError(
            f"datatypes {audio}: audio decode, the frontends and BestRQ are the audio "
            "slice of touchnet_tpu_torch; this slice builds texttoken and metainfo")
    return parts


def build_shard(chunk, path_prefix, cur_chunk, num_chunks, conf, tok_conf):
    """Build one shard dir holding a .bin/.idx pair per requested datatype."""
    datatypes = check_datatypes(conf.datatypes)
    tokenizer = None
    if "texttoken" in datatypes:
        if tok_conf.tokenizer_type == "HuggingFaceTokenizer":
            assert tok_conf.tokenizer_model is not None, "tokenizer_model required"
        tokenizer = build_tokenizer(tok_conf)

    builders = {}
    if "metainfo" in datatypes:
        builders["metainfo"] = DataBuilder(os.path.join(path_prefix, "metainfo.bin"),
                                           numpy.uint8)
    if "texttoken" in datatypes:
        builders["texttoken"] = DataBuilder(os.path.join(path_prefix, "texttoken.bin"),
                                            DType.optimal_dtype(tokenizer.vocab_size))

    logger.info(f"Processing {path_prefix} {cur_chunk}/{num_chunks}")
    for line in chunk:
        try:
            record = json.loads(line.strip())
            items = {}
            if "texttoken" in builders:
                if not record["text"]:
                    continue
                # bos/eos are added by the batchers, not here
                items["texttoken"] = numpy.asarray(
                    tokenizer.tokenize(record["text"], add_special_tokens=False), numpy.int64)
            if "metainfo" in builders:
                blob = json.dumps(record, ensure_ascii=False).strip().encode("utf-8")
                items["metainfo"] = numpy.frombuffer(blob, dtype=numpy.uint8).copy()
        except Exception as ex:
            logger.warning(f"skipping bad record ({ex}): {line[:200]}")
            continue
        for name, arr in items.items():
            builders[name].add_item(arr)
            builders[name].end_document()  # one sentence per document
    for name, b in builders.items():
        b.finalize(os.path.join(path_prefix, f"{name}.idx"))


def _chunked(lines: List[str], size: int) -> Iterable[List[str]]:
    for i in range(0, len(lines), size):
        yield lines[i : i + size]


def main(argv=None):
    os.environ["PYTHONUNBUFFERED"] = "1"
    # DataConfig's flags parse as in the JAX CLI; only its audio datatypes read them
    conf, tok_conf, _ = parse_args_into_dataclasses(
        [MakeDataConfig, TokenizerConfig, DataConfig], argv)
    assert conf.jsonl_path is not None, "conf.jsonl_path cannot be None"
    check_datatypes(conf.datatypes)

    with open(conf.jsonl_path, "r") as f:
        lines = [ln.strip() for ln in f]
    os.makedirs(conf.save_dir, exist_ok=True)
    init_logger(os.path.join(conf.save_dir, "touchnet_make_data.log"))

    shards: List[str] = []
    chunks = list(_chunked(lines, conf.num_utt_per_shard))
    with multiprocessing.Pool(processes=conf.num_workers) as pool:
        pending = []
        for i, chunk in enumerate(chunks):
            prefix = os.path.join(conf.save_dir, f"{i:09d}")
            os.makedirs(prefix, exist_ok=True)
            shards.append(prefix)
            pending.append(pool.apply_async(build_shard,
                                            (chunk, prefix, i, len(chunks), conf, tok_conf)))
        for res in pending:
            res.get()  # a worker's exception is raised here

    with open(os.path.join(conf.save_dir, "data.list"), "w", encoding="utf8") as out:
        out.writelines(f"{name} {conf.datatypes}\n" for name in shards)
    logger.info(f"{len(shards)} shards of {conf.datatypes} under {conf.save_dir}")


if __name__ == "__main__":
    main()
