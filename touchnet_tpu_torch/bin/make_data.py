# Copyright (c) 2026 touchnet_tpu authors.
# The writer side of TouchDataset: DataBuilder, copied from
# touchnet_tpu/bin/make_data.py:35-62 with its imports pointed at the port.
# The jsonl -> shards CLI (audio decode, multiprocessing) is a later slice.

from typing import List, Type

import numpy

from touchnet_tpu_torch.data.dataset import IndexWriter


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
