# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/data/dataset.py (framework-free: numpy and the standard
# library), with its imports pointed at the port.
#
# TouchDataset random-access binary storage (.bin payload + .idx index).
#
# Capability parity: reference touchnet/data/dataset.py:19-519 (Megatron
# indexed-dataset lineage). The on-disk format is kept bit-compatible so
# datasets produced by either framework are interchangeable:
#   .idx = b"MMIDIDX\x00\x00" | u64 version=1 | u8 dtype-code |
#          u64 seq_cnt | u64 doc_cnt | i32 lengths[seq_cnt] |
#          i64 byte-pointers[seq_cnt] | i64 doc-indices[doc_cnt]
#   .bin = raw concatenated payload bytes.
# Implementation is torch-free (numpy only) so it runs in CPU dataloader
# workers without pulling in any accelerator framework.

import os
import struct
from abc import ABC, abstractmethod
from enum import Enum
from typing import Dict, List, Optional, Tuple, Type, Union

import numpy

_INDEX_HEADER = b"MMIDIDX\x00\x00"


class DType(Enum):
    """Numpy dtype <-> on-disk code for TouchDataset indices."""

    uint8 = 1
    int8 = 2
    int16 = 3
    int32 = 4
    int64 = 5
    float64 = 6
    float32 = 7
    uint16 = 8

    @classmethod
    def code_from_dtype(cls, value: Type[numpy.number]) -> int:
        return cls[value.__name__].value

    @classmethod
    def dtype_from_code(cls, value: int) -> Type[numpy.number]:
        return getattr(numpy, cls(value).name)

    @staticmethod
    def size(key: Union[int, Type[numpy.number]]) -> int:
        if isinstance(key, int):
            return DType.dtype_from_code(key)().itemsize
        elif numpy.number in key.__mro__:
            return key().itemsize
        else:
            raise ValueError(f"not a dtype or code: {key!r}")

    @staticmethod
    def optimal_dtype(cardinality: Optional[int]) -> Type[numpy.number]:
        """Smallest index dtype able to hold token ids of the given vocab."""
        if cardinality is not None and cardinality < 65500:
            return numpy.uint16
        else:
            return numpy.int32


class IndexWriter:
    """Writes the .idx sidecar for a .bin payload file."""

    def __init__(self, idx_path: str, dtype: Type[numpy.number]) -> None:
        self.idx_path = idx_path
        self.dtype = dtype

    def __enter__(self) -> "IndexWriter":
        self.idx_writer = open(self.idx_path, "wb")
        self.idx_writer.write(_INDEX_HEADER)
        self.idx_writer.write(struct.pack("<Q", 1))
        self.idx_writer.write(struct.pack("<B", DType.code_from_dtype(self.dtype)))
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.idx_writer.close()

    def write(self, sequence_lengths: List[int], document_indices: List[int]) -> None:
        sequence_pointers = self._sequence_pointers(sequence_lengths)
        self.idx_writer.write(struct.pack("<Q", len(sequence_lengths)))
        self.idx_writer.write(struct.pack("<Q", len(document_indices)))
        self.idx_writer.write(
            numpy.asarray(sequence_lengths, dtype=numpy.int32).tobytes(order="C")
        )
        self.idx_writer.write(
            numpy.asarray(sequence_pointers, dtype=numpy.int64).tobytes(order="C")
        )
        self.idx_writer.write(
            numpy.asarray(document_indices, dtype=numpy.int64).tobytes(order="C")
        )

    def _sequence_pointers(self, sequence_lengths: List[int]) -> List[int]:
        itemsize = DType.size(self.dtype)
        curr_ptr = 0
        list_ptr = []
        for length in sequence_lengths:
            list_ptr.append(curr_ptr)
            curr_ptr += length * itemsize
        return list_ptr


class IndexReader:
    """mmap-backed reader of the .idx sidecar."""

    def __init__(self, idx_path: str) -> None:
        with open(idx_path, "rb") as stream:
            header = stream.read(9)
            assert header == _INDEX_HEADER, f"bad header, cannot read: {idx_path}"
            version = struct.unpack("<Q", stream.read(8))[0]
            assert version == 1, f"bad version, cannot read: {idx_path}"
            code = struct.unpack("<B", stream.read(1))[0]
            self.dtype = DType.dtype_from_code(code)
            self.dtype_size = DType.size(self.dtype)
            self.sequence_count = struct.unpack("<Q", stream.read(8))[0]
            self.document_count = struct.unpack("<Q", stream.read(8))[0]
            offset = stream.tell()

        self._mmap = numpy.memmap(idx_path, mode="r", order="C")
        buf = memoryview(self._mmap)
        self.sequence_lengths = numpy.frombuffer(
            buf, dtype=numpy.int32, count=self.sequence_count, offset=offset
        )
        self.sequence_pointers = numpy.frombuffer(
            buf,
            dtype=numpy.int64,
            count=self.sequence_count,
            offset=offset + self.sequence_lengths.nbytes,
        )
        self.document_indices = numpy.frombuffer(
            buf,
            dtype=numpy.int64,
            count=self.document_count,
            offset=offset + self.sequence_lengths.nbytes + self.sequence_pointers.nbytes,
        )
        assert self.sequence_lengths.shape[0] == self.sequence_count
        assert self.sequence_lengths.shape[0] == self.document_indices[-1]

    def __del__(self) -> None:
        if hasattr(self, "_mmap"):
            self._mmap._mmap.close()
            del self._mmap

    def __len__(self) -> int:
        return self.sequence_count

    def __getitem__(self, idx: int) -> Tuple[numpy.int64, numpy.int32]:
        return self.sequence_pointers[idx], self.sequence_lengths[idx]


class BinReader(ABC):
    """Reads item payloads out of a .bin file."""

    @abstractmethod
    def read(self, dtype: Type[numpy.number], count: int, offset: int) -> numpy.ndarray:
        ...


class MMapBinReader(BinReader):
    def __init__(self, bin_path: str) -> None:
        self._mmap = numpy.memmap(bin_path, mode="r", order="C")
        self._buffer = memoryview(self._mmap)

    def read(self, dtype: Type[numpy.number], count: int, offset: int) -> numpy.ndarray:
        return numpy.frombuffer(self._buffer, dtype=dtype, count=count, offset=offset)

    def __del__(self) -> None:
        if hasattr(self, "_mmap") and self._mmap is not None:
            self._mmap._mmap.close()
        if hasattr(self, "_mmap"):
            del self._mmap


class FileBinReader(BinReader):
    def __init__(self, bin_path: str) -> None:
        self._bin_path = bin_path

    def read(self, dtype: Type[numpy.number], count: int, offset: int) -> numpy.ndarray:
        sequence = numpy.empty(count, dtype=dtype)
        with open(self._bin_path, mode="rb", buffering=0) as f:
            f.seek(offset)
            f.readinto(sequence)
        return sequence


class TouchDataset:
    """Random-access dataset over a shard dir holding one {datatype}.idx/.bin
    pair per datatype (e.g. "audio+metainfo").

    ``get(idx, datatype, offset, length)`` supports partial reads at
    token/sample granularity — used for on-the-fly audio segment slicing.
    Picklable: state is just (path_prefix, mmap, datatypes), mmaps are
    re-opened on unpickle (worker processes).
    """

    def __init__(
        self,
        path_prefix: str,
        mmap: bool = True,
        datatypes: str = "audio+metainfo",
    ) -> None:
        self.path_prefix: str = None
        self.mmap: bool = None
        self.datatypes: str = None
        self.index: Dict[str, IndexReader] = {}
        self.bin_reader: Dict[str, BinReader] = {}
        self.initialize(path_prefix, mmap, datatypes)

    def initialize(self, path_prefix: str, mmap: bool, datatypes: str) -> None:
        self.path_prefix = path_prefix
        self.mmap = mmap
        self.datatypes = datatypes
        for d in datatypes.split("+"):
            idx_path = f"{path_prefix}/{d}.idx"
            bin_path = f"{path_prefix}/{d}.bin"
            assert os.path.exists(idx_path) and os.path.exists(bin_path), (
                f"missing .idx/.bin for datatype {d!r} at {path_prefix}"
            )
            self.bin_reader[d] = MMapBinReader(bin_path) if mmap else FileBinReader(bin_path)
            self.index[d] = IndexReader(idx_path)
        lengths = {d: len(ix) for d, ix in self.index.items()}
        assert len(set(lengths.values())) == 1, f"datatype length mismatch: {lengths}"

    def __getstate__(self) -> Tuple[str, bool, str]:
        return self.path_prefix, self.mmap, self.datatypes

    def __setstate__(self, state: Tuple[str, bool, str]) -> None:
        self.index = {}
        self.bin_reader = {}
        self.initialize(*state)

    def __len__(self) -> int:
        return len(next(iter(self.index.values())))

    def get_idx(self, idx: int, datatype: str) -> Tuple[numpy.int64, numpy.int32]:
        return self.index[datatype][idx]

    def get(
        self, idx: int, datatype: str, offset: int = 0, length: Optional[int] = None
    ) -> numpy.ndarray:
        sequence_pointer, sequence_length = self.get_idx(idx, datatype)
        if length is None:
            length = sequence_length - offset
        sequence_pointer += offset * DType.size(self.index[datatype].dtype)
        return self.bin_reader[datatype].read(
            dtype=self.index[datatype].dtype, count=length, offset=sequence_pointer
        )
