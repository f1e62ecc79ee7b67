# Copyright (c) 2026 touchnet_tpu authors.
# Stage 0 of the recipes: jsonl -> sharded TouchDataset (.bin/.idx) + data.list.
#
#     python -m touchnet_tpu_torch.bin.make_data --save_dir <d> --jsonl_path <f> \
#         --datatypes texttoken --num_utt_per_shard N --num_workers W <tokenizer flags>
#
# Port of touchnet_tpu/bin/make_data.py: DataBuilder (:35-62), the audio
# decode (load_audio: ffmpeg when it is on the PATH, else the scipy wav
# reader, :66-117), _offline_audio_codes (:128-149), build_shard for every
# '+'-combination of audio, metainfo, audiotoken and texttoken (:152-224),
# _chunked and main with its multiprocessing pool and the data.list it
# writes (:236-284). The files are byte for byte the JAX CLI's. Host-only:
# numpy, scipy, the frontends of data/ and the tokenizer.
#
# One departure: a shard whose worker raised fails the run here (the JAX
# CLI logs the error and still lists the broken shard in data.list). A bad
# record is skipped with a warning, as there.

import json
import multiprocessing
import os
import shutil
import subprocess
from typing import Iterable, List, Optional, Type

import numpy

from touchnet_tpu_torch.bin import MakeDataConfig
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.data.dataset import DType, IndexWriter
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
from touchnet_tpu_torch.utils.cli import parse_args_into_dataclasses
from touchnet_tpu_torch.utils.logging import init_logger, logger

DATATYPE_NAMES = ("audio", "metainfo", "audiotoken", "texttoken")


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
    """The '+'-joined datatypes, each once; raises NotImplementedError (as
    the JAX CLI) for an unknown or repeated one."""
    parts = datatypes.split("+")
    bad = [p for p in parts if p not in DATATYPE_NAMES]
    if bad or len(set(parts)) != len(parts):
        raise NotImplementedError(
            f"unsupported datatypes {datatypes!r}: expected a '+'-combination of "
            f"{DATATYPE_NAMES}")
    return parts


# ---------------------------------------------------------------------------
# Audio decoding
# ---------------------------------------------------------------------------


def _ffmpeg_decode(path, sr, start, end):
    cmd = ["ffmpeg", "-nostdin", "-threads", "0", "-ss", str(start),
           "-i", path, "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le",
           "-ar", str(sr)]
    if end is not None:
        cmd += ["-t", str(end - start)]
    cmd.append("-")
    proc = subprocess.run(cmd, capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg failed: {proc.stderr.decode()[:500]}")
    return numpy.frombuffer(proc.stdout, numpy.int16).flatten()


def _scipy_wav_decode(path, sr, start, end):
    from scipy.io import wavfile

    from touchnet_tpu_torch.data.dsp import resample

    file_sr, data = wavfile.read(path)
    if data.ndim > 1:
        data = data.mean(axis=1)
    scale = {
        numpy.dtype(numpy.int16): 32768.0,
        numpy.dtype(numpy.int32): 2147483648.0,
    }.get(data.dtype)
    if scale is not None:
        f = data.astype(numpy.float32) / scale
    elif data.dtype == numpy.uint8:
        f = (data.astype(numpy.float32) - 128.0) / 128.0
    else:
        f = data.astype(numpy.float32)
    lo = int(start * file_sr)
    hi = int(end * file_sr) if end is not None else f.shape[0]
    f = f[lo:hi]
    if file_sr != sr:
        f = resample(f, file_sr, sr)
    return numpy.clip(f * 32768.0, -32768, 32767).astype(numpy.int16)


def load_audio(file: str, sr: int = 16000, start_time: float = 0.0,
               end_time: Optional[float] = None) -> numpy.ndarray:
    """Decode an audio file to mono int16 PCM at the given rate (optionally a
    time segment). ffmpeg when available, scipy wav reader otherwise."""
    if shutil.which("ffmpeg") is not None:
        return _ffmpeg_decode(file, sr, start_time, end_time)
    if file.lower().endswith(".wav"):
        return _scipy_wav_decode(file, sr, start_time, end_time)
    raise RuntimeError(f"ffmpeg not found and {file!r} is not a wav file")


def _offline_audio_codes(pcm: numpy.ndarray, sample_rate: int,
                         data_conf: DataConfig, tokenizer) -> numpy.ndarray:
    """BestRQ codes for one utterance through the SAME generator chain the
    online datapipe uses (frontend -> stack -> tokenize), so offline and
    online tokenization are value-identical when the training config matches
    the make_data config (no speed perturb / augment — BEST-RQ labels come
    from clean speech; the online input-feature augments still apply)."""
    from touchnet_tpu_torch.data import functions

    sample = {
        "waveform": (pcm.astype(numpy.float32) / 32768.0)[None, :],
        "sample_rate": sample_rate,
    }
    sample = next(functions.feature_function(data_conf)(iter([sample]), data_conf))
    sample = next(functions.audiofeat_stack(iter([sample]), data_conf))
    return numpy.asarray(tokenizer.tokenize(sample["audiofeat"]), numpy.int32)


def build_shard(chunk, path_prefix, cur_chunk, num_chunks, conf, tok_conf, data_conf):
    """Build one shard dir holding a .bin/.idx pair per requested datatype."""
    datatypes = check_datatypes(conf.datatypes)
    tokenizer = None
    if "texttoken" in datatypes or "audiotoken" in datatypes:
        if tok_conf.tokenizer_type == "HuggingFaceTokenizer":
            assert tok_conf.tokenizer_model is not None, "tokenizer_model required"
        tokenizer = build_tokenizer(tok_conf)

    builders = {}
    if "audio" in datatypes:
        builders["audio"] = DataBuilder(os.path.join(path_prefix, "audio.bin"), numpy.int16)
    if "metainfo" in datatypes:
        builders["metainfo"] = DataBuilder(os.path.join(path_prefix, "metainfo.bin"),
                                           numpy.uint8)
    if "audiotoken" in datatypes:
        builders["audiotoken"] = DataBuilder(os.path.join(path_prefix, "audiotoken.bin"),
                                             DType.optimal_dtype(tokenizer.vocab_size))
    if "texttoken" in datatypes:
        builders["texttoken"] = DataBuilder(os.path.join(path_prefix, "texttoken.bin"),
                                            DType.optimal_dtype(tokenizer.vocab_size))

    needs_audio = "audio" in datatypes or "audiotoken" in datatypes
    logger.info(f"Processing {path_prefix} {cur_chunk}/{num_chunks}")
    for line in chunk:
        try:
            record = json.loads(line.strip())
            items = {}
            if needs_audio:
                pcm = load_audio(record["wav"], conf.audio_resample)
                record["sample_rate"] = conf.audio_resample
                if "audio" in builders:
                    items["audio"] = pcm
                if "audiotoken" in builders:
                    items["audiotoken"] = _offline_audio_codes(
                        pcm, conf.audio_resample, data_conf, tokenizer)
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
    conf, tok_conf, data_conf = parse_args_into_dataclasses(
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
                                            (chunk, prefix, i, len(chunks), conf, tok_conf,
                                             data_conf)))
        for res in pending:
            res.get()  # a worker's exception is raised here

    with open(os.path.join(conf.save_dir, "data.list"), "w", encoding="utf8") as out:
        out.writelines(f"{name} {conf.datatypes}\n" for name in shards)
    logger.info(f"{len(shards)} shards of {conf.datatypes} under {conf.save_dir}")


if __name__ == "__main__":
    main()
