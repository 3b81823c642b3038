"""The port's sampled engines on the CPU, through `eagle_tpu_torch.api.Engine`
on the tiny GGUF pair of tests/test_torch_engine.py:

- the sampled engines reproduce their tokens from a seed, and another seed
  gives others; the graph keys of a sampled engine hold across runs and
  seeds (capture stubbed on the CPU);
- the speculative-sampling theorem on the engines: over 1,000 rows (one
  batch, a draw stream per row) the joint law of the first two tokens of
  the chain, the static tree and EAGLE-2 (the prompt's draw and the first
  cycle's first token) matches plain sampling's exact law, computed from
  the target's logits, within total variation 0.1 (noise alone <= 0.038);
  the chain's draft is steered to the target's likeliest token, so that
  both its acceptance and its residual resample run.

No reference engine runs here: the laws are computed from the port's own
target logits, which tests/test_torch_engine.py holds to the reference."""

import numpy as np
import pytest
import torch

from eagle_tpu_torch import _build
from eagle_tpu_torch.runtime import graphs, speculative
from eagle_tpu_torch.runtime.generate import pad_bucket
from eagle_tpu_torch.runtime.sampling import SamplerConfig, transform_logits
from eagle_tpu_torch.runtime.speculative import EagleChainEngine
from eagle_tpu_torch.runtime.tree import EagleTreeEngine, TreeSpec
from eagle_tpu_torch.runtime.tree2 import EagleTree2Engine
from torch_port_util import ENGINE_KINDS as KINDS
from torch_port_util import ENGINE_PROMPT as PROMPT
from torch_port_util import tiny_engine_pair, tiny_port_engine


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    pair = tiny_engine_pair(tmp_path_factory.mktemp("engine"), PROMPT)
    return {k: tiny_port_engine(pair, k) for k in KINDS}


@pytest.mark.parametrize("kind", list(KINDS))
def test_sampled_engines_reproduce_from_a_seed(engines, kind):
    eng = engines[kind].make_engine(kind, sampler=SamplerConfig())  # the CLI's defaults
    ids = engines[kind].tokenizer.encode(PROMPT)
    sampler = SamplerConfig()

    def run(seed):
        if kind == "plain":
            return eng.generate(ids, 24, sampler=sampler, seed=seed, stop_at_eos=False)
        return eng.generate(ids, 24, seed=seed, stop_at_eos=False)[0]

    a, b, c = run(5), run(5), run(6)
    assert a == b and a != c


class _FakeGraph:
    replays = 0

    def replay(self):
        self.replays += 1


def test_sampled_graph_keys_hold_across_runs(engines, monkeypatch):
    """With capture stubbed, a sampled chain engine captures each key once:
    the sampler's tensors, the q buffer and the draw counter keep their
    addresses, so later runs and other seeds replay."""
    monkeypatch.setattr(graphs.StepGraphs, "_warm_up", lambda self, body: body())
    monkeypatch.setattr(graphs.StepGraphs, "_capture", lambda self, body: (body(), _FakeGraph())[1])
    eng = engines["chain"].make_engine("chain", sampler=SamplerConfig())
    eng.graphs = graphs.StepGraphs(enabled=True)
    ids = engines["chain"].tokenizer.encode(PROMPT)
    eng.generate(ids, 12, seed=1, stop_at_eos=False)
    captures = eng.graphs.captures
    for seed in (1, 2):
        eng.generate(ids, 12, seed=seed, stop_at_eos=False)
    assert eng.graphs.captures == captures and eng.graphs.replays > 0
    _build.reset_counts()


def _exact_joint(gen, prompt, sampler):
    """Plain sampling's law of the first two tokens: {(t0, t1): p}."""

    def probs(seq):
        t = pad_bucket(len(seq))
        padded = torch.zeros((1, t), dtype=torch.int32)
        padded[0, : len(seq)] = torch.tensor(seq)
        logits, _, _ = gen._prefill(padded, torch.tensor([len(seq)], dtype=torch.int32), t)
        return torch.softmax(transform_logits(logits[0], sampler), -1).double().numpy()

    p0 = probs(prompt)
    return {(a, b): p0[a] * p1 for a in np.flatnonzero(p0 > 1e-12)
            for b, p1 in enumerate(probs(prompt + [int(a)])) if p1 > 1e-12}


def test_first_tokens_follow_plain_sampling(engines, monkeypatch):
    """The speculative-sampling theorem: the chain (stochastic acceptance),
    the static tree and EAGLE-2 (sample-then-match) emit the first two
    tokens with plain sampling's joint law. Expected total variation from
    sampling noise at N rows over at most 9 cells: <= 0.5 * sqrt(9 * 2 /
    (pi * N)) ~ 0.038 at N = 1,000; the bound is 0.1. The random draft
    proposes nothing the target's top 3 hold, so the chain's draft logits
    get +1e4 at the target's likeliest successor of the draft pair's token:
    q is then nearly one-hot there, accepted with probability p(d)."""
    n = 1000
    sampler = SamplerConfig(temperature=1.0, top_k=3)
    base = engines["chain"]
    prompt = base.tokenizer.encode("the lazy dog")
    t = pad_bucket(len(prompt))
    want = _exact_joint(base._plain_generator(), prompt, sampler)
    likeliest = torch.full((base.model_cfg.vocab_size,), -1, dtype=torch.int64)
    for (a, b), p in sorted(want.items(), key=lambda kv: kv[1]):
        likeliest[a] = b  # ascending, so the likeliest b of each a is written last
    real = speculative.eagle_forward

    def steered(*args, **kw):
        out = real(*args, **kw)
        if out.logits is None:  # the prompt's draft pass
            return out
        to = likeliest[args[3].long()]  # [B, T]; -1: no steer
        boost = torch.where(to >= 0, 1e4, 0.0)[..., None].to(out.logits.dtype)
        return out._replace(logits=out.logits.scatter_add(-1, to.clamp(min=0)[..., None], boost))

    spec = (base.params, base.draft_params, base.model_cfg, base.draft_cfg)
    kw = dict(max_seq=32, batch=n, kv_dtype=torch.float32, compute_dtype=torch.float32,
              feature_source="pre_norm", sampler=sampler, eos_id=-1, device="cpu")
    for eng in (EagleChainEngine(*spec, n_draft=3, **kw),
                EagleTreeEngine(*spec, tree=TreeSpec((2, 2)), **kw),
                EagleTree2Engine(*spec, beam=2, depth=2, n_verify=4, **kw)):
        chain = type(eng) is EagleChainEngine
        monkeypatch.setattr(speculative, "eagle_forward", steered if chain else real)
        st = eng.fresh_state()
        st.rng.reset(11)
        tokens = torch.zeros((n, t), dtype=torch.int32)
        tokens[:, : len(prompt)] = torch.tensor(prompt)
        eng._prefill(st, tokens, torch.full((n,), len(prompt), dtype=torch.int32), t)
        t0 = st.last_token.clone()
        out = eng._multi_cycle(1, kv_limit=32)
        emp: dict = {}
        for key in zip(t0.tolist(), out.tokens[0, :, 0].tolist()):
            emp[key] = emp.get(key, 0) + 1 / n
        tv = 0.5 * sum(abs(emp.get(k, 0.0) - want.get(k, 0.0)) for k in set(emp) | set(want))
        assert tv < 0.1, (type(eng).__name__, tv)
        if chain:  # both the acceptance and the residual resample ran
            n_acc = out.n_accepted[0]
            assert 0.1 < float((n_acc > 0).double().mean()) < 0.9
