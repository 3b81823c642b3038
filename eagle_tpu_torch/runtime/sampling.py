"""Token selection (port of the greedy path of eagle_tpu/runtime/sampling.py)
and the exact top-k the tree engines expand with.

Only greedy selection is ported; the stochastic sampler chain and
speculative acceptance (`speculative_accept`) come in a later slice."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.8
    greedy: bool = False

    @property
    def is_greedy(self) -> bool:
        return self.greedy or self.temperature <= 0


def check_greedy(cfg: SamplerConfig) -> None:
    if not cfg.is_greedy:
        raise NotImplementedError("only greedy sampling is ported yet")


def sample(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """Token ids [...] (int32) from logits [..., V]: the argmax (first
    maximum on ties, as jnp.argmax)."""
    check_greedy(cfg)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices) of the k largest entries along the last
    axis, values descending and the LOWER index first among equal values:
    the order of `jax.lax.top_k` (and of `approx_max_k`, exact on the CPU).
    `torch.topk` promises no order on ties, so it runs on a unique int64 key:
    the f32 value's bits mapped to an order-preserving int32 (-0.0 ranks
    below +0.0) in the high word, the reversed index in the low word. No host
    read, so it is safe to capture in a CUDA graph."""
    xf = x.float()
    n = xf.shape[-1]
    bits = xf.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    rev = (n - 1) - torch.arange(n, dtype=torch.int64, device=x.device)
    idx = torch.topk((ordered << 32) | rev, k, dim=-1).indices
    return xf.gather(-1, idx), idx
