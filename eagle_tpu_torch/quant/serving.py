"""Serving-layout preparation of loaded weights (port of
eagle_tpu/quant/serving.py: `_pack_q`, `prepare_qtensor`,
`prepare_params_for_serving`).

- nibble packing of 4-bit "kn" codes (Q4_0, Q4_1, Q4_K): two codes per byte, with
  packed row j of a group holding (j, j + G/2) as (lo, hi);
- `scale_mode` "f32" keeps the exact f32 scale products; "bf16" rounds
  materialized scales and biases to bf16 (coded scales stay as they are).

Runs on whatever device holds the weights; "nk" tensors (the embedding
table) are never packed."""

from __future__ import annotations

import dataclasses

import torch

from ..gguf.constants import GGMLType
from .qtensor import QTensor

#: formats whose codes fit [0, 16) after repack
PACKABLE_TYPES = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q4_K)


def _pack_q(q: torch.Tensor, group: int) -> torch.Tensor:
    """[..., K, N] int8 codes in [0, 16) -> [..., K/2, N] packed bytes."""
    half = group // 2
    *lead, k, n = q.shape
    qg = q.view(torch.uint8).reshape(*lead, k // group, group, n)
    p = qg[..., :half, :] | (qg[..., half:, :] << 4)
    return p.reshape(*lead, k // 2, n).view(torch.int8)


def prepare_qtensor(t: QTensor, scale_mode: str = "f32") -> QTensor:
    if scale_mode not in ("f32", "bf16"):
        raise ValueError(f"scale_mode {scale_mode!r}")
    out = t
    if t.layout == "kn" and not t.packed and GGMLType(t.ggml_type) in PACKABLE_TYPES:
        out = dataclasses.replace(out, q=_pack_q(out.q, out.group), packed=True)
    if t.coded:  # coded scales are final
        return out
    if scale_mode == "bf16" and out.scale.dtype != torch.bfloat16:
        out = dataclasses.replace(
            out, scale=out.scale.to(torch.bfloat16),
            bias=None if out.bias is None else out.bias.to(torch.bfloat16))
    return out


def prepare_params_for_serving(params, scale_mode: str = "f32"):
    """Convert every QTensor of a params tree (dicts, lists, tuples); other
    leaves pass through. "f32" is value-preserving; "bf16" is an explicit,
    lossy opt-in, as in the reference."""
    if isinstance(params, QTensor):
        return prepare_qtensor(params, scale_mode)
    if isinstance(params, dict):
        return {k: prepare_params_for_serving(v, scale_mode) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(prepare_params_for_serving(v, scale_mode) for v in params)
    return params
