"""GGUF container writer (port of eagle_tpu/gguf/writer.py: `GGUFWriter`).

Writes GGUF v3: typed metadata, then F32/F16 arrays and pre-packed block
payloads (uint8 bytes with their ggml type and logical shape). The
reference's quantizers (quant/blocks.py) are not ported: a payload in a block
format arrives already packed."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from .constants import GGUF_DEFAULT_ALIGNMENT, GGUF_MAGIC, GGUF_VERSION, GGMLType, GGUFValueType, ggml_row_bytes

_SCALAR_PACK = {
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

_NP_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}


def _infer_vtype(value: Any) -> GGUFValueType:
    if isinstance(value, (bool, np.bool_)):
        return GGUFValueType.BOOL
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, (int, np.integer)):
        return GGUFValueType.UINT32 if 0 <= int(value) < 2**32 else GGUFValueType.INT64
    if isinstance(value, (float, np.floating)):
        return GGUFValueType.FLOAT32
    if isinstance(value, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(value)}")


class GGUFWriter:
    def __init__(self, path: str | Path, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any]] = []
        self._tensors: list[tuple[str, GGMLType, tuple[int, ...], np.ndarray]] = []

    def add(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        self._kv.append((key, vtype if vtype is not None else _infer_vtype(value), value))

    def add_tensor(self, name: str, data: np.ndarray, ggml_type: GGMLType | None = None,
                   raw_shape: Sequence[int] | None = None):
        """Add a tensor: a float32/float16 array (stored as F32/F16), or
        pre-packed uint8 bytes of `ggml_type` whose numpy-convention logical
        shape is `raw_shape`."""
        if data.dtype == np.uint8 and ggml_type is not None:
            if raw_shape is None:
                raise ValueError(f"tensor {name}: packed bytes need raw_shape")
            shape = tuple(int(s) for s in raw_shape)
            ggml_type = GGMLType(ggml_type)
            packed = data.reshape(-1)
        else:
            dense = {np.dtype(np.float32): GGMLType.F32, np.dtype(np.float16): GGMLType.F16}
            if data.dtype not in dense or ggml_type not in (None, dense[data.dtype]):
                raise NotImplementedError(
                    f"tensor {name}: {data.dtype} as {ggml_type}: only F32/F16 arrays and "
                    "pre-packed block payloads are written (no quantizer is ported)")
            ggml_type = dense[data.dtype]
            shape = tuple(data.shape)
            packed = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        expected = ggml_row_bytes(ggml_type, int(np.prod(shape)) if shape else 1)
        if packed.nbytes != expected:
            raise ValueError(f"tensor {name}: payload {packed.nbytes} != expected {expected}")
        self._tensors.append((name, ggml_type, shape, packed))

    def _write_string(self, f, s: str):
        raw = s.encode("utf-8")
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)

    def _write_value(self, f, vtype: GGUFValueType, value: Any):
        if vtype == GGUFValueType.STRING:
            self._write_string(f, value)
        elif vtype == GGUFValueType.BOOL:
            f.write(struct.pack("<B", 1 if value else 0))
        elif vtype == GGUFValueType.ARRAY:
            if isinstance(value, np.ndarray) and value.dtype in _NP_TO_VTYPE:
                f.write(struct.pack("<IQ", int(_NP_TO_VTYPE[value.dtype]), value.size))
                f.write(np.ascontiguousarray(value).astype(value.dtype.newbyteorder("<")).tobytes())
            else:
                seq = list(value)
                elem_t = _infer_vtype(seq[0]) if seq else GGUFValueType.UINT32
                if elem_t == GGUFValueType.UINT32 and any(
                        isinstance(v, (int, np.integer)) and int(v) < 0 for v in seq):
                    elem_t = GGUFValueType.INT32
                f.write(struct.pack("<IQ", int(elem_t), len(seq)))
                for v in seq:
                    self._write_value(f, elem_t, v)
        else:
            f.write(struct.pack(_SCALAR_PACK[vtype], value))

    def write(self):
        with open(self.path, "wb") as f:
            f.write(struct.pack("<IIqq", GGUF_MAGIC, GGUF_VERSION, len(self._tensors),
                                len(self._kv)))
            for key, vtype, value in self._kv:
                self._write_string(f, key)
                f.write(struct.pack("<I", int(vtype)))
                self._write_value(f, vtype, value)
            offset = 0
            for name, ggml_type, shape, packed in self._tensors:
                self._write_string(f, name)
                dims = tuple(reversed(shape))  # ggml order: innermost first
                f.write(struct.pack("<I", len(dims)))
                for d in dims:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<I", int(ggml_type)))
                f.write(struct.pack("<Q", offset))
                offset += packed.nbytes + (-packed.nbytes % self.alignment)
            f.write(b"\x00" * (-f.tell() % self.alignment))
            for _, _, _, packed in self._tensors:
                f.write(memoryview(packed))
                f.write(b"\x00" * (-packed.nbytes % self.alignment))
