"""Fill-in-the-middle (infill) support (port of eagle_tpu/runtime/infill.py:
`FimTokens`, `fim_tokens_from_metadata`, `format_infill`, `infill_filter`;
host numpy, as the reference's).

Three pieces of the reference's infill surface:
  1. FIM special-token resolution: GGUF metadata ids (and the legacy
     prefix / suffix / middle keys) with a fallback on well-known piece
     spellings (llama-vocab.cpp's Qwen / CodeLlama / DeepSeek names);
  2. infill prompt assembly, PSM and SPM orders (examples/infill);
  3. the infill sampler: the EOG-ratio gate, common-prefix candidate merging
     and the two probability-threshold passes (llama_sampler_init_infill),
     applied on the host to the top-k candidate set.
"""

from __future__ import annotations

import dataclasses

import numpy as np


_FIM_PRE_NAMES = ("<|fim_prefix|>", "<fim-prefix>", "<｜fim▁begin｜>", "<PRE>", "<fim_prefix>")
_FIM_SUF_NAMES = ("<|fim_suffix|>", "<fim-suffix>", "<｜fim▁hole｜>", "<SUF>", "<fim_suffix>")
_FIM_MID_NAMES = ("<|fim_middle|>", "<fim-middle>", "<｜fim▁end｜>", "<MID>", "<fim_middle>")


@dataclasses.dataclass(frozen=True)
class FimTokens:
    pre: int
    suf: int
    mid: int
    pad: int = -1
    rep: int = -1
    sep: int = -1


def fim_tokens_from_metadata(md: dict, pieces: list[str] | None = None) -> FimTokens | None:
    """Resolve FIM ids from GGUF keys, falling back to well-known token
    spellings (llama-vocab.cpp:1797-1846). Returns None when the vocab has no
    FIM tokens (the model can't infill)."""
    def key(name):
        v = md.get(f"tokenizer.ggml.{name}_token_id")
        return int(v) if v is not None else -1

    pre, suf, mid = key("fim_pre"), key("fim_suf"), key("fim_mid")
    # legacy keys (llama-vocab.cpp:1725)
    if pre < 0:
        pre = key("prefix")
    if suf < 0:
        suf = key("suffix")
    if mid < 0:
        mid = key("middle")
    if pieces and (pre < 0 or suf < 0 or mid < 0):
        index = {p: i for i, p in enumerate(pieces)}
        if pre < 0:
            pre = next((index[n] for n in _FIM_PRE_NAMES if n in index), -1)
        if suf < 0:
            suf = next((index[n] for n in _FIM_SUF_NAMES if n in index), -1)
        if mid < 0:
            mid = next((index[n] for n in _FIM_MID_NAMES if n in index), -1)
    if pre < 0 or suf < 0 or mid < 0:
        return None
    return FimTokens(pre=pre, suf=suf, mid=mid, pad=key("fim_pad"),
                     rep=key("fim_rep"), sep=key("fim_sep"))


def format_infill(
    prefix_ids: list[int],
    suffix_ids: list[int],
    fim: FimTokens,
    spm_infill: bool = False,
    bos_id: int = -1,
    add_bos: bool = False,
) -> list[int]:
    """[FIM_PRE] prefix [FIM_SUF] suffix [FIM_MID] (PSM), or the suffix-first
    SPM order — infill.cpp:168-178."""
    pfx = [fim.pre] + list(prefix_ids)
    sfx = [fim.suf] + list(suffix_ids)
    first, second = (sfx, pfx) if spm_infill else (pfx, sfx)
    out = first + second
    if add_bos and bos_id >= 0:
        out = [bos_id] + out
    return out + [fim.mid]


def infill_filter(
    ids: np.ndarray,  # [K] candidate token ids (e.g. top-k by prob)
    probs: np.ndarray,  # [K] their probabilities (softmax over full vocab)
    pieces: list[str],  # id -> text piece
    is_eog: np.ndarray,  # [V] bool per vocab id
    eot_id: int,
) -> tuple[np.ndarray, np.ndarray]:
    """The infill sampler transform (src/llama-sampling.cpp:2257-2436).
    Returns filtered (ids, renormalized probs)."""
    probs = probs.astype(np.float64)
    eog = is_eog[ids]
    p_eog = float(probs[eog].sum())
    p_txt = float(probs[~eog].sum())

    # EOG gate: 3 * p_eog * n > p_txt -> keep only EOG tokens (:2288)
    if 3.0 * p_eog * len(ids) > p_txt:
        keep = eog
        if not keep.any():
            return np.asarray([eot_id]), np.asarray([1.0])
        p = probs[keep]
        return ids[keep], p / p.sum()

    # combine tokens where one piece is a prefix of another (:2316-2357):
    # merge into the higher-probability token
    probs = probs.copy()
    alive = np.ones(len(ids), bool)
    texts = [pieces[i] if 0 <= i < len(pieces) else "" for i in ids]
    for i0 in range(len(ids)):
        for i1 in range(len(ids)):
            if i0 == i1 or not alive[i0] or not alive[i1]:
                continue
            t0 = texts[i0]
            if t0 and texts[i1].startswith(t0) and len(t0) <= len(texts[i1]):
                dst, src = (i1, i0) if probs[i1] > probs[i0] else (i0, i1)
                probs[dst] += probs[src]
                alive[src] = False
                probs[src] = 0.0

    # threshold pass 1: drop non-EOG below 0.2 (:2365-2386)
    keep = alive & ((probs >= 0.2) | eog)
    n_non_eog = int((keep & ~eog).sum())
    if n_non_eog == 0:
        return np.asarray([eot_id]), np.asarray([1.0])
    p_sum = probs[keep].sum()
    probs = np.where(keep, probs / p_sum, 0.0)

    # threshold pass 2: thold = 1/(n_non_eog + 1) (:2407-2430)
    thold = 1.0 / (n_non_eog + 1)
    keep2 = keep & ((probs >= thold) | eog)
    p = probs[keep2]
    return ids[keep2], p / p.sum()
