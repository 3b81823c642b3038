"""The port's sampler chain (eagle_tpu_torch/runtime/sampling.py) against the
reference (eagle_tpu/runtime/sampling.py) on the CPU:

- each mask, `transform_logits`, `_batched_transform` and
  `transformed_probs_batched` equal within rtol 1e-6 (f32), on logits with
  ties at the k-th value and at the maximum;
- `sample`, `sample_batched` and `speculative_accept` token for token when
  fed the reference's own draws: `jax.random.categorical(key, l)` is
  `argmax(l + jax.random.gumbel(key, l.shape))`, so the port gets that
  Gumbel noise, and `speculative_accept` the uniforms and noise of its
  `ukey` / `ckey` split;
- tests/test_stochastic_accept.py's checks on the port: the first emitted
  token's marginal equals p within total variation 0.02 (V = 16, 40,000
  rows), greedy rows reduce to exact match, the spec_k cap truncates;
- `CounterRNG`: uniforms in (0, 1) with a flat histogram, the same seed
  gives the same stream, another seed or the next counter another one,
  and two counters whose keys differ only in their low bits unrelated ones;
- stateful configs (penalties, DRY, mirostat) raise where the reference
  drops the sampler's state (a speculative engine's cycles, its batched
  rows); `transform_logits` applies the penalties from the counts given
  (tests/test_torch_sampling_stateful.py holds the rest)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eagle_tpu.runtime.sampling as ref
import eagle_tpu_torch.runtime.sampling as port
import torch_port_util  # noqa: F401  (one torch thread)

V = 64


def tied_logits(seed: int, rows: int = 6, v: int = V) -> np.ndarray:
    """Logits with a tie at the maximum, ties at and around the k-th value
    for k in {3, 5, 8}, and some masked (-1e30) entries."""
    rng = np.random.default_rng(seed)
    l = rng.standard_normal((rows, v)).astype(np.float32) * 2
    for r in range(rows):
        order = np.argsort(-l[r])
        l[r, order[1]] = l[r, order[0]]  # tie at the max
        for k in (3, 5, 8):
            l[r, order[k]] = l[r, order[k - 1]]  # tie at the k-th
        if r % 2:
            l[r, order[-4:]] = -1e30
    return l


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


MASKS = [
    ("top_k_mask", (1,)), ("top_k_mask", (3,)), ("top_k_mask", (5,)), ("top_k_mask", (V,)),
    ("top_p_mask", (0.5,)), ("top_p_mask", (0.95,)), ("top_p_mask", (1e-9,)),
    ("min_p_mask", (0.05,)), ("min_p_mask", (0.3,)), ("typical_mask", (0.7,)),
    ("typical_mask", (0.2,)), ("top_n_sigma_mask", (1.0,)), ("top_n_sigma_mask", (0.3,)),
]


@pytest.mark.parametrize("name,args", MASKS, ids=[f"{n}{a}" for n, a in MASKS])
def test_masks_match_reference(name, args):
    l = tied_logits(0)
    close(getattr(port, name)(torch.from_numpy(l), *args),
          getattr(ref, name)(jnp.asarray(l), *args))


def test_logit_bias_and_xtc_match_reference():
    l = tied_logits(1)
    bias = ((3, 1.5), (7, -2.0), (3, 0.25))  # a token named twice gets both
    close(port.apply_logit_bias(torch.from_numpy(l), bias),
          ref.apply_logit_bias(jnp.asarray(l), bias))
    key = jax.random.PRNGKey(4)
    u = jax.random.uniform(key, l.shape[:-1] + (1,))
    for thr in (0.05, 0.1, 0.5):
        close(port.xtc_mask(torch.from_numpy(l), torch.from_numpy(np.array(u)), 0.6, thr),
              ref.xtc_mask(jnp.asarray(l), key, 0.6, thr))


CONFIGS = [
    port.SamplerConfig(),  # the CLI's defaults: temp 0.8, top-k 40, top-p 0.95, min-p 0.05
    port.SamplerConfig(temperature=1.3, top_k=5, top_p=0.8, min_p=0.0),
    port.SamplerConfig(temperature=0.5, top_k=0, top_p=1.0, min_p=0.2, typical_p=0.9,
                       top_n_sigma=1.5),
    port.SamplerConfig(temperature=0.7, logit_bias=((2, 3.0),), xtc_probability=0.5,
                       xtc_threshold=0.05),
    port.SamplerConfig(temperature=0.0),
    port.SamplerConfig(greedy=True, logit_bias=((5, 10.0),)),
]


def jcfg(cfg: port.SamplerConfig) -> ref.SamplerConfig:
    return ref.SamplerConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_transform_and_sample_match_reference(ci):
    """transform_logits within rtol 1e-6; `sample` token for token with the
    reference's draws (its key split: categorical on the first half, XTC on
    a split of the second)."""
    cfg = CONFIGS[ci]
    l = tied_logits(2 + ci, rows=32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        key_c, tkey = jax.random.split(key)
        _, xkey = jax.random.split(tkey)
        u = np.array(jax.random.uniform(xkey, l.shape[:-1] + (1,)))
        got_l = port.transform_logits(torch.from_numpy(l), cfg, torch.from_numpy(u))
        close(got_l, ref.transform_logits(jnp.asarray(l), jcfg(cfg), key=tkey))
        g = np.array(jax.random.gumbel(key_c, l.shape, jnp.float32))
        got = port.sample(torch.from_numpy(l), cfg, torch.from_numpy(g), torch.from_numpy(u))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.sample(jnp.asarray(l), key,
                                                                          jcfg(cfg))))


def batched_params(b: int):
    """The same per-row parameters for both packages: every row another mix
    (greedy rows, disabled and active top-k / top-p / min-p)."""
    rng = np.random.default_rng(9)
    rows = dict(temperature=rng.choice([0.0, 0.5, 0.8, 1.5], b).astype(np.float32),
                top_k=rng.choice([0, 1, 3, 5, 40, V], b).astype(np.int32),
                top_p=rng.choice([0.5, 0.95, 1.0], b).astype(np.float32),
                min_p=rng.choice([0.0, 0.05, 0.3], b).astype(np.float32),
                penalty_repeat=rng.choice([1.0, 1.3], b).astype(np.float32),
                penalty_freq=rng.choice([0.0, 0.2], b).astype(np.float32),
                penalty_present=rng.choice([0.0, 0.5], b).astype(np.float32),
                greedy=rng.random(b) < 0.25, spec_k=rng.integers(1, 5, b).astype(np.int32))
    return (port.BatchedSamplerParams(**{k: torch.from_numpy(v) for k, v in rows.items()}),
            ref.BatchedSamplerParams(**{k: jnp.asarray(v) for k, v in rows.items()}))


@pytest.mark.parametrize("with_counts", [False, True], ids=["plain", "counts"])
def test_batched_transform_and_probs_match_reference(with_counts):
    b = 24
    tbp, jbp = batched_params(b)
    l = tied_logits(7, rows=b)
    counts = (np.random.default_rng(3).integers(0, 3, (b, V)).astype(np.float32)
              if with_counts else None)
    tc = None if counts is None else torch.from_numpy(counts)
    jc = None if counts is None else jnp.asarray(counts)
    close(port._batched_transform(torch.from_numpy(l), tbp, tc),
          ref._batched_transform(jnp.asarray(l), jbp, jc))
    close(port.transformed_probs_batched(torch.from_numpy(l), tbp, tc),
          ref.transformed_probs_batched(jnp.asarray(l), jbp, jc))
    # the verify's [B, K+1, V]: the reference vmaps over the middle axis
    l3 = np.stack([tied_logits(11 + j, rows=b) for j in range(4)], axis=1)
    want = jax.vmap(lambda x: ref.transformed_probs_batched(x, jbp), in_axes=1, out_axes=1)(
        jnp.asarray(l3))
    close(port.transformed_probs_batched(torch.from_numpy(l3), tbp), want)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        g = np.array(jax.random.gumbel(key, l.shape, jnp.float32))
        np.testing.assert_array_equal(
            port.sample_batched(torch.from_numpy(l), tbp, torch.from_numpy(g), tc).numpy(),
            np.asarray(ref.sample_batched(jnp.asarray(l), key, jbp, jc)))


def test_create_and_set_row_match_reference():
    cfg = port.SamplerConfig(temperature=0.6, top_k=7)
    tb = port.BatchedSamplerParams.create(3, cfg, n_draft=4).set_row(
        1, port.SamplerConfig(greedy=True), spec_k=2)
    jb = ref.BatchedSamplerParams.create(3, jcfg(cfg), n_draft=4).set_row(
        1, ref.SamplerConfig(greedy=True), spec_k=2)
    for f in dataclasses.fields(tb):
        np.testing.assert_array_equal(getattr(tb, f.name).numpy(), np.asarray(getattr(jb, f.name)))


def _accept_inputs(seed: int, b: int, k: int, v: int):
    rng = np.random.default_rng(seed)

    def dists(*shape):
        l = rng.standard_normal((*shape, v)) * 1.5
        l[rng.random((*shape, v)) < 0.3] = -40  # zero-probability tokens on either side
        p = np.exp(l - l.max(-1, keepdims=True))
        return (p / p.sum(-1, keepdims=True)).astype(np.float32)

    q, p = dists(b, k), dists(b, k + 1)
    drafts = np.stack([[rng.choice(v, p=q[i, j] / q[i, j].sum()) for j in range(k)]
                       for i in range(b)]).astype(np.int32)
    greedy = rng.random(b) < 0.3
    onehot = np.eye(v, dtype=np.float32)
    q[greedy] = onehot[drafts[greedy]]
    p[greedy] = onehot[np.where(rng.random((greedy.sum(), k + 1)) < 0.5,
                                np.pad(drafts[greedy], ((0, 0), (0, 1))),
                                rng.integers(0, v, (greedy.sum(), k + 1)))]
    spec_k = rng.integers(0, k + 1, b).astype(np.int32)
    return drafts, q, p, spec_k, greedy


@pytest.mark.parametrize("seed", range(4))
def test_speculative_accept_matches_reference(seed):
    b, k, v = 64, 5, 24
    drafts, q, p, spec_k, greedy = _accept_inputs(seed, b, k, v)
    key = jax.random.PRNGKey(100 + seed)
    ukey, ckey = jax.random.split(key)
    u = np.array(jax.random.uniform(ukey, (b, k)))
    g = np.array(jax.random.gumbel(ckey, (b, v), jnp.float32))
    want_t, want_n = ref.speculative_accept(jnp.asarray(drafts), jnp.asarray(q), jnp.asarray(p),
                                            jnp.asarray(spec_k), jnp.asarray(greedy), key)
    got_t, got_n = port.speculative_accept(
        torch.from_numpy(drafts), torch.from_numpy(q), torch.from_numpy(p),
        torch.from_numpy(spec_k), torch.from_numpy(greedy), torch.from_numpy(u),
        torch.from_numpy(g))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert 0 < int(want_n.sum()) < b * k  # both accepts and rejections


def _rand_dist(rng, v, temp=1.0):
    l = rng.standard_normal(v) * temp
    p = np.exp(l - l.max())
    return (p / p.sum()).astype(np.float32)


def test_marginal_preserves_target():
    """The FIRST emitted token's marginal equals p0 (total variation < 0.02
    at 40,000 rows: the noise alone is ~0.006), however bad the draft."""
    rng = np.random.default_rng(0)
    v, k, n = 16, 2, 40000
    p0, p1, p2 = _rand_dist(rng, v, 2.0), _rand_dist(rng, v), _rand_dist(rng, v)
    q0, q1 = _rand_dist(rng, v, 2.0), _rand_dist(rng, v)
    gen = port.CounterRNG(seed=1)
    q = torch.from_numpy(np.stack([q0, q1]))
    drafts = torch.argmax(gen.gumbel((n, k, v)) + torch.log(q), dim=-1).to(torch.int32)
    tokens, n_acc = port.speculative_accept(
        drafts, q.expand(n, k, v), torch.from_numpy(np.stack([p0, p1, p2])).expand(n, k + 1, v),
        torch.full((n,), k, dtype=torch.int32), torch.zeros(n, dtype=torch.bool),
        gen.uniform((n, k)), gen.gumbel((n, v)))
    emp = np.bincount(tokens[:, 0].numpy(), minlength=v) / n
    tv = 0.5 * np.abs(emp - p0).sum()
    assert tv < 0.02, tv
    assert (n_acc == 0).any() and (n_acc >= 1).any()


def test_greedy_rows_reduce_to_exact_match():
    rng = np.random.default_rng(5)
    v, k, b = 8, 3, 64
    t_arg = rng.integers(0, v, (b, k + 1))
    d_arg = np.where(rng.random((b, k)) < 0.6, t_arg[:, :k], rng.integers(0, v, (b, k)))
    eye = np.eye(v, dtype=np.float32)
    gen = port.CounterRNG(seed=3)
    tokens, n_acc = port.speculative_accept(
        torch.from_numpy(d_arg.astype(np.int32)), torch.from_numpy(eye[d_arg]),
        torch.from_numpy(eye[t_arg]), torch.full((b,), k, dtype=torch.int32),
        torch.ones(b, dtype=torch.bool), gen.uniform((b, k)), gen.gumbel((b, v)))
    for i in range(b):
        want = 0
        while want < k and d_arg[i, want] == t_arg[i, want]:
            want += 1
        assert int(n_acc[i]) == want
        assert (tokens[i, :want].numpy() == d_arg[i, :want]).all()
        assert int(tokens[i, want]) == t_arg[i, want]


def test_spec_k_cap_truncates():
    v, k, b = 8, 4, 32
    one = torch.eye(v)[1]
    gen = port.CounterRNG()
    tokens, n_acc = port.speculative_accept(
        torch.ones((b, k), dtype=torch.int32), one.expand(b, k, v), one.expand(b, k + 1, v),
        torch.full((b,), 2, dtype=torch.int32), torch.ones(b, dtype=torch.bool),
        gen.uniform((b, k)), gen.gumbel((b, v)))
    assert (n_acc == 2).all()
    assert (tokens[:, 2] == 1).all()  # the plain draw from p at the cut


def test_counter_rng_uniforms_and_streams():
    """Uniforms in (0, 1); over 64 bins of 2**20 draws each bin within 5 %
    of its expected count (the noise is ~0.8 %); neighbouring elements
    uncorrelated; Gumbel mean near the Euler-Mascheroni constant; the same
    seed repeats its stream, another seed and the next counter give
    others."""
    n = 1 << 20
    gen = port.CounterRNG(seed=7)
    u = gen.uniform((n,))
    assert u.dtype == torch.float32 and float(u.min()) > 0 and float(u.max()) < 1
    hist = torch.histc(u, bins=64, min=0, max=1)
    assert float((hist / (n / 64) - 1).abs().max()) < 0.05
    g = gen.gumbel((n,))
    assert abs(float(g.double().mean()) - 0.5772156649) < 0.01
    gen.reset(7)
    np.testing.assert_array_equal(gen.uniform((n,)).numpy(), u.numpy())  # same seed, same draws
    assert int(gen.counter) == 1
    assert abs(float(np.corrcoef(u[:-1].numpy(), u[1:].numpy())[0, 1])) < 0.01  # neighbours
    nxt = gen.uniform((n,))
    other = port.CounterRNG(seed=8).uniform((n,))
    for x in (nxt, other):
        assert float((x == u).float().mean()) < 1e-3
        assert abs(float(np.corrcoef(x.numpy(), u.numpy())[0, 1])) < 0.01


def test_counter_rng_close_keys_give_unrelated_streams():
    """Two counters whose draw keys differ only in the low log2(n) bits:
    with the key xor-ed into the index, each n-element draw would be an
    index permutation of the other (the precondition below). Their values
    must instead share no more than chance does (n**2 / 2**32 = 1/4096)."""
    n, seed = 1 << 10, 5
    counters = torch.arange(1 << 15, dtype=torch.int64)
    keys = port._hash32(seed ^ port._hash32(counters))
    order = torch.argsort(keys >> 10)
    hi = (keys >> 10)[order]
    at = int(torch.nonzero(hi[1:] == hi[:-1])[0, 0])
    c1, c2 = int(counters[order[at]]), int(counters[order[at + 1]])
    k1, k2 = int(keys[c1]), int(keys[c2])
    assert k1 != k2 and (k1 ^ k2) < n
    idx = np.arange(n)
    assert set((idx ^ k1).tolist()) == set((idx ^ k2).tolist())  # the hazard's precondition
    gen = port.CounterRNG(seed=seed)
    draws = []
    for c in (c1, c2):
        gen.counter.fill_(c)
        draws.append(set(gen._bits((n,)).tolist()))
    assert len(draws[0]) == n and len(draws[1]) == n
    assert len(draws[0] & draws[1]) <= 2


@pytest.mark.parametrize("kw", [dict(penalty_repeat=1.1), dict(penalty_freq=0.1),
                                dict(penalty_present=0.2), dict(dry_multiplier=0.8),
                                dict(mirostat=2)])
def test_stateful_configs_raise(kw):
    from eagle_tpu_torch.models.config import ModelConfig
    from eagle_tpu_torch.runtime.speculative import EagleChainEngine

    cfg = port.SamplerConfig(**kw)
    with pytest.raises(port.DroppedSamplerState, match="drops the sampler's state"):
        port.refuse_dropped_state(cfg, "a speculative engine")
    tiny = ModelConfig(vocab_size=V, n_embd=256, n_layers=1, n_heads=4, n_kv_heads=2,
                       head_dim=64, n_ff=512)
    with pytest.raises(NotImplementedError, match="drops the sampler's state"):
        EagleChainEngine({}, {}, tiny, max_seq=16, sampler=cfg, device="cpu")
    eng = EagleChainEngine({}, {}, tiny, max_seq=16, batch=2, device="cpu")
    with pytest.raises(NotImplementedError, match="drops the sampler's state"):
        eng.set_row_sampler(1, cfg)
    port.refuse_dropped_state(port.SamplerConfig(), "anywhere")  # a stateless config passes
    l = tied_logits(12, rows=2)
    counts = torch.zeros(2, V)
    counts[0, :5] = 2.0
    got = port.transform_logits(torch.from_numpy(l), cfg, penalty_counts=counts)
    want = port.transform_logits(torch.from_numpy(l), cfg)
    if cfg.needs_penalties:  # only the seen tokens of row 0 move
        assert not torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want)
