"""EAGLE feature-level draft head (port of eagle_tpu/models/eagle.py:
`eagle_forward`).

x = ReLU(FC([embed(token); feature])) -> one llama decoder layer with no
input norm -> unweighted RMSNorm (no output_norm weight) -> the TARGET
model's lm_head. `feature` at step i is the hidden state of token i-1. The
single-layer draft cache (dense, int8 or paged) is updated in place."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ops.matmul import qmatmul
from ..ops.norms import rms_norm
from ..ops.rope import rope_freqs_cfg
from ..runtime.kvcache import KVCache
from .config import ModelConfig, check_ported
from .llama import _layer_step, cache_kw, check_layer_keys, embed_lookup, fused_ffn_mode, read_bound

_DRAFT_KEYS = {"tok_embd", "fc_w", "fc_b", "layers"}


class EagleOutput(NamedTuple):
    logits: torch.Tensor | None  # [B, T, V] via the target's lm_head
    feature: torch.Tensor  # [B, T, D] the draft's next-step feature (post-norm)
    feature_pre: torch.Tensor  # [B, T, D] pre-norm variant
    kv: KVCache


def eagle_forward(
    draft_params: dict[str, Any],
    target_params: dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T]
    features: torch.Tensor,  # [B, T, D] feature of each token's predecessor
    positions: torch.Tensor,  # [B, T] draft positions (shifted: pair i sits at i-1)
    kv: KVCache,  # single-layer draft cache, updated in place
    slots: torch.Tensor,
    mask: torch.Tensor,
    *,
    compute_dtype=torch.bfloat16,
    return_logits: bool = True,
    kv_limit: int | None = None,
    slots_contiguous: bool = False,
) -> EagleOutput:
    """Draft forward; `slots_contiguous` as in `llama_forward`."""
    check_ported(cfg)
    extra = set(draft_params) - _DRAFT_KEYS
    if extra:
        raise NotImplementedError(f"draft weights not ported yet: {sorted(extra)}")
    check_layer_keys(draft_params["layers"])
    emb = embed_lookup(draft_params["tok_embd"], tokens)
    fused = torch.cat([emb, features.to(emb.dtype)], dim=-1)
    x = qmatmul(fused, draft_params["fc_w"], compute_dtype)
    if draft_params.get("fc_b") is not None:
        x = x + draft_params["fc_b"].to(x.dtype)
    x = torch.relu(x)

    inv_freq, _ = rope_freqs_cfg(cfg, device=x.device)
    kv_limit, mask = read_bound(kv, kv_limit, mask)
    x = _layer_step(
        cfg, inv_freq, positions, slots, mask, compute_dtype, x,
        draft_params["layers"], 0, kv.k, kv.v, kv_limit=kv_limit, fused_ffn=fused_ffn_mode(),
        **cache_kw(kv),
    )
    feat_post = rms_norm(x, None, cfg.rms_eps)  # unweighted: no output_norm tensor
    logits = None
    if return_logits:
        logits = qmatmul(feat_post, target_params["output"], compute_dtype)
    return EagleOutput(logits=logits, feature=feat_post, feature_pre=x, kv=kv)
