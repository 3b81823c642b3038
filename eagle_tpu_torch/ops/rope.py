"""Rotary position embedding, half-split ("NEOX"/HF) layout (port of
eagle_tpu/ops/rope.py: `rope_freqs`, `_yarn_corr_dims`, `yarn_blend`,
`_yarn_active`, `rope_mscale_cfg`, `rope_freqs_cfg` with linear and YaRN
scaling, `apply_rope`; and `rope_inv_freq`, the frequencies divided by a
Llama-3.1 file's per-frequency factors, as eagle_tpu/models/llama.py:683-688).

The two halves of each head rotate together — not interleaved pairs.

YaRN's per-frequency blend is a static vector: the reference's numpy
formula, computed once per (config, device) on the host and kept on the
device, so a forward captured into a CUDA graph copies nothing from the
host (a copy from pageable memory cannot be captured). The factored
frequencies are likewise computed once per factors tensor, config and
device."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary


def rope_freqs(head_dim: int, base: float, scale_factor: float = 1.0, *,
               device) -> torch.Tensor:
    """Inverse frequencies [head_dim/2] (f32) on `device` (the caller's
    activations' device; there is no default)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (base**exponent)
    return inv_freq / scale_factor


def _yarn_corr_dims(n_dims: int, n_ctx_orig: int, base: float, beta_fast: float,
                    beta_slow: float) -> tuple[float, float]:
    """Correction-range endpoints in frequency-index units
    (ggml_rope_yarn_corr_dims): the dim where a frequency completes `beta`
    rotations over the original context."""

    def corr(n_rot: float) -> float:
        return n_dims * math.log(n_ctx_orig / (n_rot * 2.0 * math.pi)) / (2.0 * math.log(base))

    start = math.floor(corr(beta_fast))
    end = math.ceil(corr(beta_slow))
    return max(0.0, float(start)), min(float(n_dims - 1), float(end))


def yarn_blend(head_dim: int, n_ctx_orig: int, base: float, scale_factor: float,
               ext_factor: float, beta_fast: float = 32.0, beta_slow: float = 1.0
               ) -> np.ndarray:
    """Per-frequency YaRN interpolation multiplier [head_dim/2] (numpy f32):
    ggml's rope_yarn mixes theta_interp = freq_scale * theta_extrap with
    theta_extrap by mix = ramp * ext_factor per dim, which is inv_freq *
    (freq_scale + mix * (1 - freq_scale))."""
    freq_scale = 1.0 / scale_factor
    low, high = _yarn_corr_dims(head_dim, n_ctx_orig, base, beta_fast, beta_slow)
    i = np.arange(head_dim // 2, dtype=np.float32)
    ramp = 1.0 - np.clip((i - low) / max(0.001, high - low), 0.0, 1.0)
    mix = ramp * ext_factor
    return (freq_scale * (1.0 - mix) + mix).astype(np.float32)


def _yarn_active(cfg) -> tuple[float, int]:
    """(resolved ext_factor, resolved n_ctx_orig), as the reference resolves
    them (ext_factor < 0 means 1.0 under rope_scaling == 'yarn', else 0;
    n_ctx_orig falls back to the training context)."""
    ext = float(getattr(cfg, "rope_ext_factor", -1.0))
    if ext < 0.0:
        ext = 1.0 if getattr(cfg, "rope_scaling", None) == "yarn" else 0.0
    orig = int(getattr(cfg, "rope_orig_ctx", 0) or 0) or int(
        getattr(cfg, "n_ctx_train", 0) or 0
    )
    return ext, orig


def rope_mscale_cfg(cfg) -> float:
    """cos/sin magnitude multiplier (a Python float): rope_attn_factor, times
    YaRN's 1 + 0.1 ln(factor) where YaRN is on (q.k scales by its square).
    A config with rope_yarn_log_mul (deepseek2) folds it into the score
    scale instead, as the reference."""
    mscale = float(getattr(cfg, "rope_attn_factor", 1.0))
    ext, orig = _yarn_active(cfg)
    factor = getattr(cfg, "rope_scale_factor", 1.0) or 1.0
    if ext != 0.0 and orig > 0 and not getattr(cfg, "rope_yarn_log_mul", 0.0):
        mscale *= 1.0 + 0.1 * math.log(factor)
    return mscale


#: (rope_dim, n_ctx_orig, base, factor, ext, beta_fast, beta_slow, device) -> blend
_BLENDS: dict[tuple, torch.Tensor] = {}


def _blend_on(device, *key) -> torch.Tensor:
    dev = torch.device(device)
    full = (*key, str(dev))
    if full not in _BLENDS:
        _BLENDS[full] = torch.from_numpy(yarn_blend(*key)).to(dev)
    return _BLENDS[full]


def rope_freqs_cfg(cfg, *, device) -> tuple[torch.Tensor, float]:
    """(inv_freq [rope_dim/2], mscale) from a ModelConfig: unscaled, linear
    (`rope_scale_factor`) or YaRN-blended frequencies, as ggml_rope_ext."""
    factor = getattr(cfg, "rope_scale_factor", 1.0) or 1.0
    ext, orig = _yarn_active(cfg)
    inv_freq = rope_freqs(cfg.rope_dim, cfg.rope_base, 1.0, device=device)
    if ext != 0.0 and orig > 0 and cfg.rope_dim > 0:
        inv_freq = inv_freq * _blend_on(
            device, cfg.rope_dim, orig, cfg.rope_base, factor, ext,
            float(getattr(cfg, "rope_beta_fast", 32.0)),
            float(getattr(cfg, "rope_beta_slow", 1.0)))
    elif factor != 1.0:
        inv_freq = inv_freq / factor
    return inv_freq, rope_mscale_cfg(cfg)


#: rope_factors tensor -> {(rope fields, device): factored inv_freq}
_FACTORED = WeakIdKeyDictionary()


def rope_inv_freq(cfg, factors: torch.Tensor | None, *, device) -> torch.Tensor:
    """`rope_freqs_cfg`'s inverse frequencies divided by `factors` (a
    model's `rope_freqs.weight`, Llama-3.1's smooth interpolation: ggml_rope_ext
    divides theta by freq_factors[i]), or undivided without factors. The
    division commutes with the YaRN blend. The result is kept per factors
    tensor, rope config and device, so a captured forward reuses it."""
    inv_freq, _ = rope_freqs_cfg(cfg, device=device)
    if factors is None:
        return inv_freq
    key = (cfg.rope_dim, cfg.rope_base, getattr(cfg, "rope_scale_factor", 1.0),
           *_yarn_active(cfg), getattr(cfg, "rope_beta_fast", 32.0),
           getattr(cfg, "rope_beta_slow", 1.0), str(torch.device(device)))
    per = _FACTORED.setdefault(factors, {})
    if key not in per:
        per[key] = inv_freq / factors.to(inv_freq.device)
    return per[key]


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

