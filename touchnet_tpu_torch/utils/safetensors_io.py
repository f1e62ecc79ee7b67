# Copyright (c) 2026 touchnet_tpu authors.
# Reader and writer of the safetensors format on torch alone (the HF weight
# files of the converters, bin/convert_hf_to_ckpt.py and
# bin/convert_ckpt_to_hf.py; the machines the port trains on need not have
# the safetensors package).
#
# The format: an 8-byte little-endian header length N, N bytes of a JSON
# header {name: {"dtype", "shape", "data_offsets": [begin, end]}, and an
# optional "__metadata__": {str: str}}, then the raw little-endian tensor
# bytes, each at its offsets from the end of the header. The writer pads the
# header with spaces to a multiple of 8 bytes, as the package does, and
# stores the tensors in name order.

import json
import struct
from typing import Dict

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, on the CPU. The file is read
    once into one buffer and each tensor is a view of it."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        f.seek(0, 2)
        data = bytearray(f.tell() - 8 - n)
        f.seek(8 + n)
        f.readinto(data)
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name}: dtype {info['dtype']} is not read")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        numel = 1
        for d in shape:
            numel *= d
        size = torch.empty((), dtype=dtype).element_size()
        if end - begin != numel * size or end > len(data):
            raise ValueError(f"{path}: tensor {name}: offsets {begin}-{end} do not hold "
                             f"{shape} {info['dtype']}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, count=numel,
                                     offset=begin).reshape(shape)
    return out


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> int:
    """Write ``tensors`` (any device; copied to the host one at a time) to a
    .safetensors file, with the metadata transformers checks ({"format":
    "pt"}). Returns the bytes written."""
    header, offset, order = {}, 0, sorted(tensors)
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name}: dtype {t.dtype} is not written")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    header["__metadata__"] = {"format": "pt"}
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())
    return 8 + len(blob) + offset
