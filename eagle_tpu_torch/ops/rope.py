"""Rotary position embedding, half-split ("NEOX"/HF) layout (port of
eagle_tpu/ops/rope.py for the unscaled and linear-scaled cases; YaRN raises).

The two halves of each head rotate together — not interleaved pairs."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, base: float, scale_factor: float = 1.0, *,
               device) -> torch.Tensor:
    """Inverse frequencies [head_dim/2] (f32) on `device` (the caller's
    activations' device; there is no default)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (base**exponent)
    return inv_freq / scale_factor


def _yarn_active(cfg) -> tuple[float, int]:
    """(resolved ext_factor, resolved n_ctx_orig), as the reference resolves
    them (ext_factor < 0 means 1.0 under rope_scaling == 'yarn', else 0)."""
    ext = float(getattr(cfg, "rope_ext_factor", -1.0))
    if ext < 0.0:
        ext = 1.0 if getattr(cfg, "rope_scaling", None) == "yarn" else 0.0
    orig = int(getattr(cfg, "rope_orig_ctx", 0) or 0) or int(
        getattr(cfg, "n_ctx_train", 0) or 0
    )
    return ext, orig


def _check_not_yarn(cfg) -> None:
    ext, orig = _yarn_active(cfg)
    if ext != 0.0 and orig > 0:
        raise NotImplementedError("YaRN rope scaling is not ported yet")


def rope_mscale_cfg(cfg) -> float:
    """cos/sin magnitude multiplier: rope_attn_factor (YaRN's correction
    raises, see `_check_not_yarn`)."""
    _check_not_yarn(cfg)
    return float(getattr(cfg, "rope_attn_factor", 1.0))


def rope_freqs_cfg(cfg, *, device) -> tuple[torch.Tensor, float]:
    """(inv_freq [rope_dim/2], mscale) from a ModelConfig: unscaled or
    linear (`rope_scale_factor`) frequencies."""
    _check_not_yarn(cfg)
    factor = getattr(cfg, "rope_scale_factor", 1.0) or 1.0
    inv_freq = rope_freqs(cfg.rope_dim, cfg.rope_base, 1.0, device=device)
    if factor != 1.0:
        inv_freq = inv_freq / factor
    return inv_freq, rope_mscale_cfg(cfg)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
               mscale: float = 1.0) -> torch.Tensor:
    """Rotate features. x: [..., T, H, D]; positions broadcastable to
    [..., T] (int); inv_freq [D/2]; mscale scales cos and sin."""
    angles = positions[..., None].float() * inv_freq  # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    if mscale != 1.0:
        cos = cos * mscale
        sin = sin * mscale
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

