"""Tokenizers built from GGUF metadata (port of eagle_tpu/tokenizer/: the SPM
tokenizer, Vicuna's; the byte-level BPE tokenizer, Llama-3's; and the
factory `tokenizer_from_gguf_metadata` of eagle_tpu/tokenizer/bpe.py)."""

from __future__ import annotations

from ..gguf.constants import Keys
from .bpe import BPETokenizer
from .spm import SPMTokenizer

__all__ = ["BPETokenizer", "SPMTokenizer", "tokenizer_from_gguf_metadata"]


def tokenizer_from_gguf_metadata(md: dict):
    """The tokenizer a GGUF's `tokenizer.ggml.model` names: SPM ("llama" /
    "spm", the default) or byte-level BPE ("gpt2" / "bpe"). WPM, UGM and
    RWKV come with the architectures that use them (ROADMAP queue 1, item
    8)."""
    model = md.get(Keys.Tokenizer.MODEL, "llama")
    if model in ("llama", "spm"):
        return SPMTokenizer.from_gguf_metadata(md)
    if model in ("gpt2", "bpe"):
        return BPETokenizer.from_gguf_metadata(md)
    raise NotImplementedError(
        f"tokenizer model {model!r} is not ported yet (ROADMAP queue 1, item 8: the other "
        "architectures, each with its tokenizer)")
