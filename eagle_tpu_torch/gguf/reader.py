"""GGUF container reader (port of eagle_tpu/gguf/reader.py: `GGUFReader`
with `tensor_bytes` and `tensor_f32`).

The file is memory-mapped copy-on-write (`mmap.ACCESS_COPY`): a tensor's
bytes are a numpy view of the map, writable as far as numpy and
`torch.from_numpy` are concerned, so the loader hands them to PyTorch
without a copy or a warning; nothing is ever written back to the file.
Quantized tensors stay packed: the repack runs downstream, on the device
that holds the bytes (quant/qtensor.py)."""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

from .constants import GGUF_DEFAULT_ALIGNMENT, GGUF_MAGIC, GGMLType, GGUFValueType, ggml_row_bytes

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_SCALAR_NP = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


@dataclass
class GGUFTensorInfo:
    name: str
    ggml_type: GGMLType
    #: numpy-convention shape: the last axis is the contiguous row (ggml
    #: ne[0]), the reverse of the on-disk dims order
    shape: tuple[int, ...]
    offset: int  # relative to the start of the data section
    nbytes: int = field(default=0)

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


class _Cursor:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def read_fmt(self, fmt: str):
        vals = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return vals[0] if len(vals) == 1 else vals

    def read_string(self) -> str:
        n = self.read_fmt("<Q")
        raw = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return raw.decode("utf-8", errors="replace")

    def read_value(self, vtype: GGUFValueType) -> Any:
        if vtype == GGUFValueType.STRING:
            return self.read_string()
        if vtype == GGUFValueType.BOOL:
            return bool(self.read_fmt("<B"))
        if vtype == GGUFValueType.ARRAY:
            elem_type = GGUFValueType(self.read_fmt("<I"))
            count = self.read_fmt("<Q")
            if elem_type in _SCALAR_NP and count > 0:
                dt = np.dtype(_SCALAR_NP[elem_type]).newbyteorder("<")
                arr = np.frombuffer(self.buf, dtype=dt, count=count, offset=self.pos).copy()
                self.pos += dt.itemsize * count
                return arr
            return [self.read_value(elem_type) for _ in range(count)]
        return self.read_fmt(_SCALAR_FMT[vtype])


class GGUFReader:
    """Read-only view of a GGUF file: `metadata` (key -> value, numpy arrays
    for numeric arrays) and `tensors` (name -> GGUFTensorInfo)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_COPY)
        buf = memoryview(self._mm)
        cur = _Cursor(buf)

        magic = cur.read_fmt("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
        self.version = cur.read_fmt("<I")
        if self.version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {self.version}")
        n_tensors = cur.read_fmt("<q")
        n_kv = cur.read_fmt("<q")

        self.metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = cur.read_string()
            vtype = GGUFValueType(cur.read_fmt("<I"))
            self.metadata[key] = cur.read_value(vtype)
        self.alignment = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))

        self.tensors: dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = cur.read_string()
            n_dims = cur.read_fmt("<I")
            dims = [cur.read_fmt("<Q") for _ in range(n_dims)]
            raw_type = cur.read_fmt("<I")
            try:
                ggml_type = GGMLType(raw_type)
            except ValueError:
                raise ValueError(f"{path}: tensor {name} has ggml type {raw_type}, "
                                 "which is not ported yet") from None
            offset = cur.read_fmt("<Q")
            info = GGUFTensorInfo(name=name, ggml_type=ggml_type,
                                  shape=tuple(reversed(dims)), offset=offset)
            info.nbytes = ggml_row_bytes(ggml_type, info.n_elements)
            self.tensors[name] = info
        self.data_offset = cur.pos + (-cur.pos % self.alignment)
        self._buf = buf

    def tensor_bytes(self, name: str) -> np.ndarray:
        """Packed bytes of a tensor: a zero-copy uint8 view of the map."""
        info = self.tensors[name]
        return np.frombuffer(self._buf, dtype=np.uint8, count=info.nbytes,
                             offset=self.data_offset + info.offset)

    def tensor_f32(self, name: str) -> np.ndarray:
        """A tensor as float32, numpy-convention shape: F32 and F16 as they
        are, every block format decoded as the reference's `dequantize`
        decodes it (`quant/qtensor.py:dequantize`, torch ops on the CPU)."""
        import torch

        from ..quant.qtensor import dequantize

        info = self.tensors[name]
        return dequantize(torch.from_numpy(self.tensor_bytes(name)), info.ggml_type,
                          info.shape).numpy()

    def close(self):
        self._buf = None
        try:
            self._mm.close()
        except BufferError:
            # tensor views are still alive; the map goes when they do
            pass
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
