"""The sampler chain and stochastic speculative acceptance (port of
eagle_tpu/runtime/sampling.py: `SamplerState`, `SamplerConfig`, the masks,
`apply_penalties`, `transform_logits`, `sample`, `BatchedSamplerParams`,
`_batched_transform`, `sample_batched`, `transformed_probs_batched`,
`speculative_accept`, `dry_penalty`, `_mirostat_v1`, `_mirostat_v2`,
`sample_stateful`), the exact `top_k` the tree engines expand with, and
`CounterRNG`, the engines' random source.

Every function that draws takes its noise as an argument ("noise in, token
out"): `jax.random.categorical(key, l)` is `argmax(l + gumbel)`, so a draw
here is `argmax(l + gumbel)` with the Gumbel noise given, and
`speculative_accept` takes its uniforms and its Gumbel noise. The tests feed
them the reference's own draws; the engines feed them `CounterRNG`'s.

The stateful samplers (penalties, DRY, mirostat: `SamplerConfig.stateful`)
keep their per-sequence state in a `SamplerState` of static tensors that
`sample_stateful` updates in place, so a decode step that holds it can be
replayed as a CUDA graph. Where the reference drops that state (its
speculative cycles and batched rows sample without counts, its constrained
generators transform without them), the port refuses the config instead:
`refuse_dropped_state` raises `DroppedSamplerState`. Where the reference
ignores the sampler altogether and decodes greedily (lookahead), a sampled
config is refused too (`refuse_sampled`, `SamplerIgnored`).
`_NEG_INF` is finite (-1e30), as in the reference, so a masked logit plus
noise stays finite."""

from __future__ import annotations

import dataclasses
import math

import torch

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.8
    # DRY repetition penalty (0 multiplier = disabled)
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_sequence_breakers: tuple = ()
    top_k: int = 40  # <= 0: disabled
    top_p: float = 0.95  # >= 1: disabled
    min_p: float = 0.05  # <= 0: disabled
    typical_p: float = 1.0  # >= 1: disabled
    top_n_sigma: float = 0.0  # <= 0: disabled
    xtc_probability: float = 0.0  # 0: disabled
    xtc_threshold: float = 0.1
    penalty_repeat: float = 1.0  # 1.0: disabled
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    #: tuple of (token_id, bias) pairs, applied first
    logit_bias: tuple = ()
    # mirostat: 0 = off, 1 or 2 = v1 / v2
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    greedy: bool = False

    @property
    def stateful(self) -> bool:
        return self.needs_penalties or self.mirostat in (1, 2) or self.dry_multiplier > 0

    @property
    def needs_penalties(self) -> bool:
        return (
            self.penalty_repeat != 1.0
            or self.penalty_freq != 0.0
            or self.penalty_present != 0.0
        )

    @property
    def is_greedy(self) -> bool:
        """The draw is an argmax (no noise): `greedy`, or temperature <= 0."""
        return self.greedy or self.temperature <= 0


class DroppedSamplerState(NotImplementedError):
    """A stateful sampler on a path where the reference samples without its
    state (the server answers it with 400)."""


def refuse_dropped_state(cfg: SamplerConfig | None, path: str) -> None:
    """Raise for a stateful `cfg` on `path`, one where the reference drops
    the sampler's state and would silently sample without the penalties,
    DRY or mirostat asked for."""
    if cfg is not None and cfg.stateful:
        raise DroppedSamplerState(
            f"penalties, DRY and mirostat on {path}: the reference drops the sampler's "
            "state on this path (ROADMAP queue 3)")


class SamplerIgnored(DroppedSamplerState):
    """A sampled config on a path where the reference decodes greedily
    whatever the sampler (lookahead decoding)."""


def refuse_sampled(cfg: SamplerConfig | None, path: str) -> None:
    """Raise unless `cfg` draws the raw argmax (greedy, no logit bias, no
    state): on `path` the reference ignores the sampler and decodes
    greedily, so it would silently not sample."""
    if cfg is not None and not (cfg.is_greedy and not cfg.logit_bias and not cfg.stateful):
        raise SamplerIgnored(
            f"a sampled or transformed sampler on {path}: the reference decodes greedily "
            "there, whatever the sampler (ROADMAP queue 3); pass --temp 0 (a greedy "
            "SamplerConfig)")


class SamplerState:
    """Per-sequence sampler state of static tensors, updated in place: the
    occurrence counts [B, V] f32 (the penalties' window is the whole
    context), mirostat's surprise target `mu` [B] f32 (2 tau at the start)
    and the last `window` tokens [B, W] int32 for DRY (-1 before any). A
    CUDA graph that holds the tensors reads and writes them at each replay;
    `reset` starts a new sequence without moving them."""

    def __init__(self, batch: int, vocab: int, tau: float = 5.0, window: int = 64,
                 device="cpu"):
        self.counts = torch.zeros((batch, vocab), dtype=torch.float32, device=device)
        self.mu = torch.zeros((batch,), dtype=torch.float32, device=device)
        self.recent = torch.zeros((batch, window), dtype=torch.int32, device=device)
        self.reset(tau)

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return self.counts, self.mu, self.recent

    def reset(self, tau: float = 5.0) -> "SamplerState":
        self.counts.zero_()
        self.mu.fill_(2.0 * tau)
        self.recent.fill_(-1)
        return self

    def count(self, row: int, tokens) -> None:
        """Add `tokens` (a sequence, repeats counted once per occurrence, as
        the reference's `.at[...].add`) to row `row`'s counts."""
        idx = torch.as_tensor(tokens, dtype=torch.int64).to(self.counts.device)
        self.counts[row].scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))

    def observe(self, tokens: torch.Tensor) -> None:
        """Row b drew tokens[b]: count it and shift it into `recent`."""
        t = tokens.long()[:, None]
        self.counts.scatter_add_(1, t, torch.ones_like(t, dtype=torch.float32))
        tail = self.recent[:, 1:].clone()  # the slices overlap: through a copy
        self.recent[:, :-1].copy_(tail)
        self.recent[:, -1:].copy_(t)


# ---------------------------------------------------------------------------
# the masks (each on the last axis of [..., V] f32 logits)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep every logit >= the k-th largest: with ties, more than k survive."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _NEG_INF, logits)


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep tokens until the cumulative probability exceeds p; the top token
    always stays."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < p
    threshold = torch.where(keep_sorted, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, _NEG_INF, logits)


def min_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    cutoff = probs.amax(dim=-1, keepdim=True) * p
    return torch.where(probs < cutoff, _NEG_INF, logits)


def typical_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Locally-typical sampling (llama_sampler_typical)."""
    if p >= 1.0:
        return logits
    log_probs = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(log_probs)
    entropy = -torch.sum(probs * log_probs, dim=-1, keepdim=True)
    shifted = torch.abs(-log_probs - entropy)
    order = torch.argsort(shifted, dim=-1, stable=True)
    probs_sorted = probs.gather(-1, order)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = (cum - probs_sorted) < p
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, logits, _NEG_INF)


def top_n_sigma_mask(logits: torch.Tensor, n: float) -> torch.Tensor:
    """Keep logits within n standard deviations of the max."""
    if n <= 0:
        return logits
    valid = logits > _NEG_INF / 2
    mean = torch.where(valid, logits, 0.0).mean(dim=-1, keepdim=True)
    var = torch.where(valid, (logits - mean) ** 2, 0.0).mean(dim=-1, keepdim=True)
    cutoff = logits.amax(dim=-1, keepdim=True) - n * torch.sqrt(var)
    return torch.where(logits < cutoff, _NEG_INF, logits)


def xtc_mask(logits: torch.Tensor, uniform: torch.Tensor, prob: float,
             threshold: float) -> torch.Tensor:
    """Exclude-top-choices: where `uniform` [..., 1] < prob, mask every token
    above `threshold` probability except the least likely of them."""
    if prob <= 0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    above = probs >= threshold
    n_above = above.sum(dim=-1, keepdim=True)
    min_above = torch.where(above, probs, torch.inf).amin(dim=-1, keepdim=True)
    drop = above & (probs > min_above) & (n_above >= 2)
    fire = uniform < prob
    return torch.where(fire & drop, _NEG_INF, logits)


def apply_logit_bias(logits: torch.Tensor, bias: tuple) -> torch.Tensor:
    """Add each (token, bias) in order; a token named twice gets both. Each
    is a scalar add: no tensor is built from host values, which a CUDA
    graph's capture would refuse."""
    if not bias:
        return logits
    out = logits.clone()
    for tid, val in bias:
        out[..., tid] += val
    return out


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    cfg: SamplerConfig) -> torch.Tensor:
    """llama_sampler_penalties: the repeat penalty divides a seen token's
    positive logit and multiplies its negative one; the frequency and
    presence penalties subtract linearly in its count. `counts` [..., V]
    broadcasts against `logits`."""
    seen = counts > 0
    l = logits
    if cfg.penalty_repeat != 1.0:
        rep = cfg.penalty_repeat
        l = torch.where(seen, torch.where(l > 0, l / rep, l * rep), l)
    if cfg.penalty_freq != 0.0 or cfg.penalty_present != 0.0:
        l = l - counts * cfg.penalty_freq - seen.to(l.dtype) * cfg.penalty_present
    return l


def transform_logits(logits: torch.Tensor, cfg: SamplerConfig,
                     xtc_uniform: torch.Tensor | None = None,
                     penalty_counts: torch.Tensor | None = None) -> torch.Tensor:
    """The chain's logit transforms on [..., V] (everything but the draw):
    logit bias, the penalties (when `penalty_counts` is given and the config
    has them), then (unless `greedy`) top-n-sigma, top-k, typical, top-p,
    min-p, XTC (when `xtc_uniform` [..., 1] is given) and the temperature."""
    l = apply_logit_bias(logits.float(), cfg.logit_bias)
    if cfg.needs_penalties and penalty_counts is not None:
        l = apply_penalties(l, penalty_counts, cfg)
    if cfg.greedy:
        return l
    l = top_n_sigma_mask(l, cfg.top_n_sigma)
    l = top_k_mask(l, cfg.top_k)
    l = typical_mask(l, cfg.typical_p)
    l = top_p_mask(l, cfg.top_p)
    l = min_p_mask(l, cfg.min_p)
    if cfg.xtc_probability > 0 and xtc_uniform is not None:
        l = xtc_mask(l, xtc_uniform, cfg.xtc_probability, cfg.xtc_threshold)
    if cfg.temperature > 0:
        l = l / cfg.temperature
    return l


def sample(logits: torch.Tensor, cfg: SamplerConfig, gumbel: torch.Tensor | None = None,
           xtc_uniform: torch.Tensor | None = None) -> torch.Tensor:
    """Token ids [...] (int32) from logits [..., V]: the argmax of the
    transformed logits if `cfg.is_greedy` (first maximum on ties, as
    jnp.argmax), else the argmax of transformed logits + `gumbel` [..., V].
    A plain greedy config takes the argmax of the raw logits, as before."""
    if cfg.greedy and not cfg.logit_bias:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    l = transform_logits(logits, cfg, xtc_uniform)
    if cfg.is_greedy:
        return torch.argmax(l, dim=-1).to(torch.int32)
    if gumbel is None:
        raise ValueError("a sampled draw needs its Gumbel noise")
    return torch.argmax(gumbel + l, dim=-1).to(torch.int32)


def draw(logits: torch.Tensor, cfg: SamplerConfig, rng: "CounterRNG",
         state: "SamplerState | None" = None) -> torch.Tensor:
    """`sample` (with `state`: `sample_stateful`, which updates it) with its
    noise from `rng`: XTC's uniform [..., 1] when XTC is on, then Gumbel
    noise unless the draw is an argmax (mirostat always draws). The number
    of draws depends on the config alone, so a graphed step advances the
    counter as the eager one does."""
    mirostat = state is not None and cfg.mirostat in (1, 2)
    xtc_on = cfg.xtc_probability > 0 and not cfg.greedy and not mirostat
    xtc = rng.uniform((*logits.shape[:-1], 1)) if xtc_on else None
    gumbel = rng.gumbel(logits.shape) if mirostat or not cfg.is_greedy else None
    if state is not None:
        return sample_stateful(logits, cfg, state, gumbel, xtc)
    return sample(logits, cfg, gumbel, xtc)


# ---------------------------------------------------------------------------
# per-row parameters (the batched chain: the speculative cycle's p and q)


@dataclasses.dataclass(frozen=True)
class BatchedSamplerParams:
    """Per-row sampler parameters as [B] tensors; every transform is
    branch-free, and neutral values (top_k <= 0, top_p >= 1, min_p <= 0,
    penalty_repeat == 1, ...) are exact no-ops per row."""

    temperature: torch.Tensor  # [B] f32; <= 0 with greedy -> argmax
    top_k: torch.Tensor  # [B] i32; <= 0 disabled
    top_p: torch.Tensor  # [B] f32; >= 1 disabled
    min_p: torch.Tensor  # [B] f32; <= 0 disabled
    penalty_repeat: torch.Tensor  # [B] f32; == 1 disabled
    penalty_freq: torch.Tensor  # [B] f32
    penalty_present: torch.Tensor  # [B] f32
    greedy: torch.Tensor  # [B] bool
    spec_k: torch.Tensor  # [B] i32: per-row max accepted drafts per cycle

    @staticmethod
    def create(batch: int, default: SamplerConfig | None = None, n_draft: int = 5,
               device="cpu") -> "BatchedSamplerParams":
        c = default or SamplerConfig(greedy=True)

        def full(v, dtype):
            return torch.full((batch,), v, dtype=dtype, device=device)

        f32 = torch.float32
        return BatchedSamplerParams(
            temperature=full(c.temperature, f32), top_k=full(c.top_k, torch.int32),
            top_p=full(c.top_p, f32), min_p=full(c.min_p, f32),
            penalty_repeat=full(c.penalty_repeat, f32), penalty_freq=full(c.penalty_freq, f32),
            penalty_present=full(c.penalty_present, f32), greedy=full(bool(c.greedy), torch.bool),
            spec_k=full(n_draft, torch.int32),
        )

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def set_row(self, i: int, cfg: SamplerConfig,
                spec_k: int | None = None) -> "BatchedSamplerParams":
        """Configure row i from `cfg` IN PLACE and return self: the tensors
        keep their addresses, so a CUDA graph that holds them reads the new
        row at its next replay (the reference returns a new object)."""
        for name in ("temperature", "top_k", "top_p", "min_p", "penalty_repeat", "penalty_freq",
                     "penalty_present", "greedy"):
            getattr(self, name)[i] = getattr(cfg, name)
        if spec_k is not None:
            self.spec_k[i] = spec_k
        return self

    def row(self, i: int) -> "BatchedSamplerParams":
        """Row i as a one-row view of the same tensors."""
        return BatchedSamplerParams(*(t[i:i + 1] for t in self.tensors()))


def _rows(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A [B] parameter shaped to broadcast over [B, ..., V] (`ndim` dims)."""
    return x.view(-1, *([1] * (ndim - 1)))


def _batched_transform(logits: torch.Tensor, bp: BatchedSamplerParams,
                       counts: torch.Tensor | None = None) -> torch.Tensor:
    """[B, ..., V] logits -> transformed logits, row b under row b's params
    (the reference's [B, V] transform, vmapped over any middle axes):
    penalties (when `counts` is given), top-k by the k-th largest value,
    top-p, min-p, temperature; two sorts over V per row."""
    l = logits.float()
    nd, v = l.dim(), l.shape[-1]
    if counts is not None:
        seen = counts > 0
        rep = _rows(bp.penalty_repeat, nd)
        l = torch.where(seen, torch.where(l > 0, l / rep, l * rep), l)
        l = l - counts * _rows(bp.penalty_freq, nd) - seen * _rows(bp.penalty_present, nd)
    # top-k with per-row k: threshold = k-th largest (disabled rows: off)
    sorted_desc = torch.sort(l, dim=-1, descending=True).values
    k_idx = (bp.top_k.long() - 1).clamp(0, v - 1)
    kth = sorted_desc.gather(-1, _rows(k_idx, nd).expand(*l.shape[:-1], 1))
    k_on = _rows((bp.top_k > 0) & (bp.top_k < v), nd)
    l = torch.where(k_on & (l < kth), _NEG_INF, l)
    # top-p per row
    sorted_desc = torch.sort(l, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < _rows(bp.top_p, nd)
    thr = torch.where(keep_sorted, sorted_desc, torch.inf).amin(dim=-1, keepdim=True)
    p_on = _rows(bp.top_p < 1.0, nd)
    l = torch.where(p_on & (l < thr), _NEG_INF, l)
    # min-p per row
    pr = torch.softmax(l, dim=-1)
    cutoff = pr.amax(dim=-1, keepdim=True) * _rows(bp.min_p, nd)
    m_on = _rows(bp.min_p > 0, nd)
    l = torch.where(m_on & (pr < cutoff), _NEG_INF, l)
    temp = _rows(bp.temperature.clamp(min=1e-6), nd)
    return l / temp


def _greedy_rows(bp: BatchedSamplerParams) -> torch.Tensor:
    return bp.greedy | (bp.temperature <= 0)


def _masked_argmax(l: torch.Tensor) -> torch.Tensor:
    return torch.argmax(torch.where(l > _NEG_INF / 2, l, _NEG_INF), dim=-1)


def sample_batched(logits: torch.Tensor, bp: BatchedSamplerParams, gumbel: torch.Tensor,
                   counts: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row draw from [B, V]: greedy rows take the argmax of the
    transformed logits, sampling rows the argmax of them + `gumbel`."""
    l = _batched_transform(logits, bp, counts)
    samp_tok = torch.argmax(gumbel + l, dim=-1)
    return torch.where(_greedy_rows(bp), _masked_argmax(l), samp_tok).to(torch.int32)


def transformed_probs_batched(logits: torch.Tensor, bp: BatchedSamplerParams,
                              counts: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row sampling distribution [B, ..., V]: the softmax of the
    transformed logits for sampling rows, one_hot(argmax) for greedy rows.
    The p (target) and q (draft) of `speculative_accept`."""
    l = _batched_transform(logits, bp, counts)
    p = torch.softmax(l, dim=-1)
    onehot = torch.zeros_like(p).scatter_(-1, _masked_argmax(l)[..., None], 1.0)
    return torch.where(_rows(_greedy_rows(bp), p.dim()), onehot, p)


def speculative_accept(
    drafts: torch.Tensor,  # [B, K] draft tokens, sampled from q
    q_probs: torch.Tensor,  # [B, K, V] draft distributions
    p_probs: torch.Tensor,  # [B, K+1, V] target distributions (K = bonus position)
    spec_k: torch.Tensor,  # [B] per-row accepted-draft cap
    greedy: torch.Tensor,  # [B] rows that reduce to exact match + argmax correction
    uniform: torch.Tensor,  # [B, K] in (0, 1): the acceptance draws
    gumbel: torch.Tensor,  # [B, V]: the correction draw's noise
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic speculative acceptance: draft k is accepted while
    u_k < p(d_k) / q(d_k); the first rejection resamples from
    norm(max(p - q, 0)); full acceptance draws the bonus token from p at
    position K; a spec_k cap truncates with a plain draw from p at the cut.
    Greedy rows carry one-hot p and q, so the test is exact match and the
    correction is the target's argmax. Returns (tokens [B, K+1] int32,
    n_acc [B]): tokens[:, :n_acc] are the accepted drafts, tokens[:, n_acc]
    the correction or bonus."""
    b, k, v = q_probs.shape
    d = drafts.long()[..., None]
    p_tok = p_probs[:, :k].gather(-1, d)[..., 0]
    q_tok = q_probs.gather(-1, d)[..., 0]
    acc = uniform * q_tok.clamp(min=1e-20) < p_tok  # u < p/q without the divide
    n_raw = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    n_acc = torch.minimum(n_raw, spec_k.to(n_raw.dtype))
    capped = n_acc < n_raw
    q_pad = torch.cat([q_probs, torch.zeros_like(q_probs[:, :1])], dim=1)
    at = n_acc.long()[:, None, None].expand(b, 1, v)
    p_j = p_probs.gather(1, at)[:, 0]
    q_j = q_pad.gather(1, at)[:, 0]
    resid = (p_j - q_j).clamp(min=0.0)
    rs = resid.sum(-1, keepdim=True)
    corr = torch.where(capped[:, None], p_j,
                       torch.where(rs > 0, resid / rs.clamp(min=1e-20), p_j))
    tok_s = torch.argmax(gumbel + torch.log(corr + 1e-30), dim=-1)
    tok_g = torch.argmax(corr, dim=-1)
    tok_corr = torch.where(greedy, tok_g, tok_s).to(torch.int32)
    drafts_pad = torch.cat([drafts, drafts[:, -1:]], dim=1).to(torch.int32)
    pos = torch.arange(k + 1, device=drafts.device)[None, :]
    tokens = torch.where(pos == n_acc[:, None], tok_corr[:, None], drafts_pad)
    return tokens, n_acc.to(torch.int32)


# ---------------------------------------------------------------------------
# the stateful samplers: DRY, mirostat v1 / v2 and the stateful chain step


def dry_penalty(logits: torch.Tensor, recent: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """DRY ("don't repeat yourself", llama_sampler_dry) on logits [..., V]
    with the recent tokens [..., W] (-1 before any): a candidate z that
    would extend the longest suffix of the window also found earlier in it,
    immediately followed by z, loses multiplier * base^(len - allowed) when
    that length reaches `dry_allowed_length`. The match lengths of every
    window position come from one [W, W] comparison; breaker tokens compare
    unequal on both sides (-2 against -3), so no match runs through one."""
    w, v = recent.shape[-1], logits.shape[-1]
    dev = recent.device
    brk = torch.zeros_like(recent, dtype=torch.bool)
    for b in cfg.dry_sequence_breakers:
        brk = brk | (recent == b)
    left = torch.where(brk, -2, recent)
    right = torch.where(brk, -3, recent)
    valid = recent >= 0
    # run[i]: how far left[i-1-j] == right[w-1-j] holds over j = 0, 1, ...
    i_idx = torch.arange(w, device=dev)[:, None]
    j_idx = torch.arange(w, device=dev)[None, :]
    li, ri = i_idx - 1 - j_idx, (w - 1 - j_idx).expand(w, w)
    ok = (li >= 0) & (li < ri)
    lc = li.clamp(min=0)
    eq = ok & (left[..., lc] == right[..., ri]) & valid[..., lc] & valid[..., ri]
    run = torch.cumprod(eq.long(), dim=-1).sum(dim=-1)  # [..., W]
    # candidate recent[i] extends the match of length run[i]; index v absorbs the rest
    cand = torch.where((run > 0) & valid & ~brk, recent.long(), v)
    pen_len = torch.zeros((*recent.shape[:-1], v + 1), dtype=torch.long, device=dev)
    pen_len = pen_len.scatter_reduce(-1, cand, run, "amax")[..., :v]
    fire = pen_len >= cfg.dry_allowed_length
    pen = cfg.dry_multiplier * torch.pow(cfg.dry_base,
                                         (pen_len - cfg.dry_allowed_length).float())
    return torch.where(fire, logits - pen, logits)


def _log2_surprise(logp: torch.Tensor) -> torch.Tensor:
    return -logp / math.log(2.0)


def _mirostat_v1_k(logits: torch.Tensor, mu: torch.Tensor, m: int = 100) -> torch.Tensor:
    """Mirostat v1's truncation k [B] (int64): the Zipf exponent s_hat
    regressed on the top-m probabilities, then k from the surprise target
    mu, an f32 power cast down by truncation as the reference's."""
    v = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    top = torch.topk(probs, m, dim=-1).values  # [B, m], descending
    idx = torch.arange(m - 1, dtype=torch.float32, device=logits.device)
    t_i = torch.log((idx + 2.0) / (idx + 1.0))
    ratio = top[:, :-1] / top[:, 1:].clamp(min=1e-10)
    b_i = torch.log(ratio.clamp(min=1e-10))
    s_hat = (t_i * b_i).sum(dim=-1) / (b_i * b_i).sum(dim=-1).clamp(min=1e-10)
    eps = s_hat - 1.0
    k = torch.pow((eps * torch.pow(2.0, mu)) / (1.0 - torch.pow(float(v), -eps)),
                  1.0 / s_hat.clamp(min=1e-6))
    return k.clamp(1, v).to(torch.int32).long()


def _mirostat_v1(logits: torch.Tensor, gumbel: torch.Tensor, cfg: SamplerConfig,
                 mu: torch.Tensor, m: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """llama_sampler_mirostat (v1) on [B, V]: keep the logits >= the k-th
    largest (`_mirostat_v1_k`), draw at the temperature, then move mu by
    eta times the draw's surprise (bits) less tau. Returns (tokens, mu)."""
    v = logits.shape[-1]
    k = _mirostat_v1_k(logits, mu, m)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, (k - 1).clamp(0, v - 1)[:, None])
    l = torch.where(logits < kth, _NEG_INF, logits) / max(cfg.temperature, 1e-6)
    tok = torch.argmax(gumbel + l, dim=-1)
    obs = _log2_surprise(torch.log_softmax(logits, dim=-1).gather(-1, tok[:, None])[:, 0])
    return tok.to(torch.int32), mu - cfg.mirostat_eta * (obs - cfg.mirostat_tau)


def _mirostat_v2(logits: torch.Tensor, gumbel: torch.Tensor, cfg: SamplerConfig,
                 mu: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """llama_sampler_mirostat_v2 on [B, V]: drop the tokens whose surprise
    (-log2 p) exceeds mu (the argmax always stays), draw at the
    temperature, then move mu toward tau. Returns (tokens, mu)."""
    surprise = _log2_surprise(torch.log_softmax(logits, dim=-1))  # [B, V]
    keep = (surprise <= mu[:, None]).scatter(-1, torch.argmax(logits, dim=-1)[:, None], True)
    l = torch.where(keep, logits / max(cfg.temperature, 1e-6), _NEG_INF)
    tok = torch.argmax(gumbel + l, dim=-1)
    obs = surprise.gather(-1, tok[:, None])[:, 0]
    return tok.to(torch.int32), mu - cfg.mirostat_eta * (obs - cfg.mirostat_tau)


def sample_stateful(logits: torch.Tensor, cfg: SamplerConfig, state: SamplerState,
                    gumbel: torch.Tensor | None = None,
                    xtc_uniform: torch.Tensor | None = None) -> torch.Tensor:
    """One stateful chain step on [B, V]: DRY on `state.recent`, then either
    mirostat (v1 / v2: logit bias, the penalties on `state.counts`, the
    truncation, a draw with `gumbel`, mu updated in place) or the chain of
    `transform_logits` with the penalties and an argmax (greedy) or a draw
    with `gumbel`. The drawn tokens [B] (int32) are observed into `state`.
    The reference draws from two keys of one split (`key` for the chain,
    `mkey` for mirostat); here `gumbel` is whichever the branch takes."""
    logits = logits.float()
    if cfg.dry_multiplier > 0:
        logits = dry_penalty(logits, state.recent, cfg)
    counts = state.counts if cfg.needs_penalties else None
    if cfg.mirostat in (1, 2):
        l = apply_logit_bias(logits, cfg.logit_bias)
        if counts is not None:
            l = apply_penalties(l, counts, cfg)
        fn = _mirostat_v1 if cfg.mirostat == 1 else _mirostat_v2
        tok, mu = fn(l, gumbel, cfg, state.mu)
        state.mu.copy_(mu)
    else:
        l = transform_logits(logits, cfg, xtc_uniform, penalty_counts=counts)
        if cfg.is_greedy:
            tok = torch.argmax(l, dim=-1).to(torch.int32)
        else:
            tok = torch.argmax(gumbel + l, dim=-1).to(torch.int32)
    state.observe(tok)
    return tok


# ---------------------------------------------------------------------------
# the exact top-k of the tree engines


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


# ---------------------------------------------------------------------------
# the random source


_M32 = 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xor-shift-multiply, two rounds) on int64
    values in [0, 2**32). The multipliers are odd and below 2**31, so no
    product reaches 2**63: no int64 wraps, and every value stays
    non-negative (no sign from an arithmetic shift)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


class CounterRNG:
    """Draws as a function of (seed, counter, element index): the port's
    counterpart of the reference's `jax.random` key. `seed` and `counter`
    are int64 device scalars; every draw reads both and advances `counter`
    in place by one, with no host read. So a CUDA graph that captured draws
    draws new values at each replay, and a graphed run gives the eager run's
    values bit for bit; the same (seed, counter) gives the same values on
    the CPU and the card. A draw's key is a hash of (seed, counter), and a
    second hash of it gives an odd multiplier a and an offset b; an
    element's 32-bit value is the hash of a * index + b (mod 2**32). The
    key enters through a product, not an xor: with `index ^ key`, two keys
    that differ only below bit log2(n) would give index permutations of one
    another's n values. The value's top 24 bits give a uniform in (0, 1),
    (h + 0.5) / 2**24, and Gumbel noise -log(-log(u)), computed in f64 and
    returned in f32."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.seed = torch.zeros((), dtype=torch.int64, device=device)
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        self.reset(seed)

    def reset(self, seed: int) -> None:
        """Start the stream of `seed` (in place: graphs stay valid)."""
        self.seed.fill_(int(seed) & _M32)
        self.counter.zero_()

    def _bits(self, shape) -> torch.Tensor:
        n = 1
        for s in shape:
            n *= int(s)
        key = _hash32(self.seed ^ _hash32(self.counter & _M32))
        self.counter.add_(1)
        a, b = key | 1, _hash32(key ^ 0x9E3779B9)
        idx = torch.arange(n, dtype=torch.int64, device=self.seed.device)
        return _hash32((idx * a + b) & _M32).view(*shape)  # exact while n < 2**31

    def _uniform64(self, shape) -> torch.Tensor:
        return ((self._bits(shape) >> 8).double() + 0.5) * 2.0**-24

    def uniform(self, shape) -> torch.Tensor:
        """f32 uniforms in (0, 1) of `shape`."""
        return self._uniform64(shape).float()

    def gumbel(self, shape) -> torch.Tensor:
        """f32 standard Gumbel noise of `shape`."""
        return (-torch.log(-torch.log(self._uniform64(shape)))).float()
