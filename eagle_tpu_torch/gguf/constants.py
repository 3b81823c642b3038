"""GGUF/GGML constants for the formats and keys the port reads (port of
eagle_tpu/gguf/constants.py: `GGMLType`, `TypeTraits`, `GGUFValueType`,
`Keys` with the SPM and BPE tokenizers' keys, `TokenType`, `ggml_row_bytes`).

The tensor types listed are F32, F16 and the block formats the repack takes:
the affine formats Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q8_1, Q2_K, Q3_K, Q4_K,
Q5_K, Q6_K, IQ4_NL and IQ4_XS, and the codebook formats IQ2_XXS, IQ2_XS,
IQ2_S, IQ3_XXS, IQ3_S, IQ1_S and IQ1_M. The values are ggml's
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
    """ggml tensor data types read by the port (ggml.h values)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    IQ1_M = 29


@dataclass(frozen=True)
class TypeTraits:
    block_size: int  # number of weights per block
    type_size: int  # bytes per block


GGML_TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits(1, 4),
    GGMLType.F16: TypeTraits(1, 2),
    GGMLType.Q4_0: TypeTraits(32, 2 + 16),
    GGMLType.Q4_1: TypeTraits(32, 4 + 16),
    GGMLType.Q5_0: TypeTraits(32, 2 + 4 + 16),
    GGMLType.Q5_1: TypeTraits(32, 4 + 4 + 16),
    GGMLType.Q8_0: TypeTraits(32, 2 + 32),
    GGMLType.Q8_1: TypeTraits(32, 4 + 32),
    GGMLType.Q2_K: TypeTraits(QK_K, 4 + QK_K // 16 + QK_K // 4),
    GGMLType.Q3_K: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 8 + 12),
    GGMLType.Q4_K: TypeTraits(QK_K, 4 + K_SCALE_SIZE + QK_K // 2),
    GGMLType.Q5_K: TypeTraits(QK_K, 4 + K_SCALE_SIZE + QK_K // 2 + QK_K // 8),
    GGMLType.Q6_K: TypeTraits(QK_K, 2 + QK_K // 16 + 3 * QK_K // 4),
    GGMLType.IQ4_NL: TypeTraits(32, 2 + 16),
    GGMLType.IQ4_XS: TypeTraits(QK_K, 2 + 2 + QK_K // 64 + QK_K // 2),
    # codebook formats (ggml-common.h's block structs)
    GGMLType.IQ2_XXS: TypeTraits(QK_K, 2 + QK_K // 4),
    GGMLType.IQ2_XS: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 32),
    GGMLType.IQ2_S: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 16),
    GGMLType.IQ3_XXS: TypeTraits(QK_K, 2 + 3 * QK_K // 8),
    GGMLType.IQ3_S: TypeTraits(QK_K, 2 + 13 * QK_K // 32 + QK_K // 64),
    GGMLType.IQ1_S: TypeTraits(QK_K, 2 + QK_K // 8 + QK_K // 16),
    GGMLType.IQ1_M: TypeTraits(QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32),
}


#: byte offsets of the f16 fields in one block (d; dmin or m; Q8_1's s).
#: IQ1_M has none: its f16 scale is the top nibbles of the four u16 scale
#: words at bytes 48-55, word w holding bits 4w .. 4w+3.
F16_FIELDS: dict[GGMLType, tuple[int, ...]] = {
    GGMLType.Q4_0: (0,), GGMLType.Q4_1: (0, 2), GGMLType.Q5_0: (0,), GGMLType.Q5_1: (0, 2),
    GGMLType.Q8_0: (0,), GGMLType.Q8_1: (0, 2), GGMLType.Q2_K: (80, 82), GGMLType.Q3_K: (108,),
    GGMLType.Q4_K: (0, 2), GGMLType.Q5_K: (0, 2), GGMLType.Q6_K: (208,),
    GGMLType.IQ4_NL: (0,), GGMLType.IQ4_XS: (0,), GGMLType.IQ2_XXS: (0,),
    GGMLType.IQ2_XS: (0,), GGMLType.IQ2_S: (0,), GGMLType.IQ3_XXS: (0,), GGMLType.IQ3_S: (0,),
    GGMLType.IQ1_S: (0,), GGMLType.IQ1_M: (),
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
        EXPERT_COUNT = "{arch}.expert_count"
        EXPERT_USED_COUNT = "{arch}.expert_used_count"

    class Attention:
        HEAD_COUNT = "{arch}.attention.head_count"
        HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
        LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
        LAYERNORM_EPS = "{arch}.attention.layer_norm_epsilon"
        KEY_LENGTH = "{arch}.attention.key_length"

    class Rope:
        DIMENSION_COUNT = "{arch}.rope.dimension_count"
        FREQ_BASE = "{arch}.rope.freq_base"
        SCALING_TYPE = "{arch}.rope.scaling.type"
        SCALING_FACTOR = "{arch}.rope.scaling.factor"
        SCALING_ORIG_CTX = "{arch}.rope.scaling.original_context_length"
        SCALING_ATTN_FACTOR = "{arch}.rope.scaling.attn_factor"

    class Tokenizer:
        MODEL = "tokenizer.ggml.model"
        LIST = "tokenizer.ggml.tokens"
        TOKEN_TYPE = "tokenizer.ggml.token_type"
        SCORES = "tokenizer.ggml.scores"
        BOS_ID = "tokenizer.ggml.bos_token_id"
        EOS_ID = "tokenizer.ggml.eos_token_id"
        UNK_ID = "tokenizer.ggml.unknown_token_id"
        PAD_ID = "tokenizer.ggml.padding_token_id"
        ADD_BOS = "tokenizer.ggml.add_bos_token"
        ADD_EOS = "tokenizer.ggml.add_eos_token"
        ADD_SPACE_PREFIX = "tokenizer.ggml.add_space_prefix"
        PRE = "tokenizer.ggml.pre"
        MERGES = "tokenizer.ggml.merges"


class TokenType(enum.IntEnum):
    """Token classes stored in tokenizer.ggml.token_type."""

    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


def ggml_row_bytes(ggml_type: GGMLType, n_elements: int) -> int:
    """Bytes needed to store `n_elements` contiguous values of `ggml_type`."""
    tr = GGML_TYPE_TRAITS[ggml_type]
    if n_elements % tr.block_size != 0:
        raise ValueError(
            f"{ggml_type.name}: {n_elements} not a multiple of block size {tr.block_size}"
        )
    return n_elements // tr.block_size * tr.type_size
