"""GGUF/GGML constants for the formats and keys the port reads (port of
eagle_tpu/gguf/constants.py: `GGMLType`, `TypeTraits`, `GGUFValueType`,
`Keys`, `ggml_row_bytes`).

Only the tensor types of the llama/EAGLE path are listed: F32, F16 and the
block formats Q4_0, Q8_0, Q4_K and Q6_K. The values are ggml's
(ggml/include/ggml.h), so a file with any other type fails to parse with a
ValueError naming the type id."""

from __future__ import annotations

import enum
from dataclasses import dataclass

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

QK_K = 256  # super-block size for K-quants
K_SCALE_SIZE = 12


class GGMLType(enum.IntEnum):
    """ggml tensor data types read by this slice (ggml.h values)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q8_0 = 8
    Q4_K = 12
    Q6_K = 14


@dataclass(frozen=True)
class TypeTraits:
    block_size: int  # number of weights per block
    type_size: int  # bytes per block


GGML_TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits(1, 4),
    GGMLType.F16: TypeTraits(1, 2),
    GGMLType.Q4_0: TypeTraits(32, 2 + 16),
    GGMLType.Q8_0: TypeTraits(32, 2 + 32),
    GGMLType.Q4_K: TypeTraits(QK_K, 4 + K_SCALE_SIZE + QK_K // 2),
    GGMLType.Q6_K: TypeTraits(QK_K, 2 + QK_K // 16 + 3 * QK_K // 4),
}


class GGUFValueType(enum.IntEnum):
    """Metadata value types in the GGUF container."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class Keys:
    """The metadata keys of the llama and EAGLE families (on-disk strings;
    the `{arch}` ones are formatted with the architecture name)."""

    class General:
        ARCHITECTURE = "general.architecture"
        NAME = "general.name"
        ALIGNMENT = "general.alignment"
        FILE_TYPE = "general.file_type"

    class LLM:
        CONTEXT_LENGTH = "{arch}.context_length"
        EMBEDDING_LENGTH = "{arch}.embedding_length"
        BLOCK_COUNT = "{arch}.block_count"
        FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
        VOCAB_SIZE = "{arch}.vocab_size"

    class Attention:
        HEAD_COUNT = "{arch}.attention.head_count"
        HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
        LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
        KEY_LENGTH = "{arch}.attention.key_length"

    class Rope:
        DIMENSION_COUNT = "{arch}.rope.dimension_count"
        FREQ_BASE = "{arch}.rope.freq_base"
        SCALING_TYPE = "{arch}.rope.scaling.type"
        SCALING_FACTOR = "{arch}.rope.scaling.factor"
        SCALING_ORIG_CTX = "{arch}.rope.scaling.original_context_length"
        SCALING_ATTN_FACTOR = "{arch}.rope.scaling.attn_factor"

    class Tokenizer:
        LIST = "tokenizer.ggml.tokens"


def ggml_row_bytes(ggml_type: GGMLType, n_elements: int) -> int:
    """Bytes needed to store `n_elements` contiguous values of `ggml_type`."""
    tr = GGML_TYPE_TRAITS[ggml_type]
    if n_elements % tr.block_size != 0:
        raise ValueError(
            f"{ggml_type.name}: {n_elements} not a multiple of block size {tr.block_size}"
        )
    return n_elements // tr.block_size * tr.type_size
