"""RMSNorm and LayerNorm (port of eagle_tpu/ops/norms.py: `rms_norm`,
`layer_norm`): f32 math regardless of the activation dtype."""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None,
               eps: float) -> torch.Tensor:
    """Mean-subtracted LayerNorm with f32 statistics; the weight and the
    bias are each optional (the LayerNorm families: phi2, starcoder2,
    stablelm, gptneox, command-r)."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None, eps: float) -> torch.Tensor:
    """RMSNorm; `weight=None` gives the unweighted norm of the EAGLE head's
    final norm (the draft head has no output_norm tensor)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)
