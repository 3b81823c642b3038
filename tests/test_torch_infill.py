"""Fill-in-the-middle in the port (eagle_tpu_torch/runtime/infill.py,
`api.Engine.infill`) against the reference on the CPU:

- every case of tests/test_infill.py on the port's functions (FIM ids from
  the GGUF keys, the legacy keys and the piece names, PSM / SPM prompt
  orders, the infill sampler's EOG gate, prefix merge and thresholds), and
  `fim_tokens_from_metadata`, `format_infill` and `infill_filter` equal to
  the reference's on seeded random inputs;
- `Engine.infill` text equal to the reference's `Engine.infill` on a tiny
  GGUF whose SPM vocabulary carries CodeLlama's four FIM control pieces
  and their `tokenizer.ggml.prefix` / `suffix` / `middle` / `eot` keys:
  greedy in PSM and SPM order, and sampled from a seed; the generator's
  per-token forward is its graphed logits step (replayed, capture stubbed);
- a vocabulary without FIM tokens raises ValueError.

The reference runs once per module (its Engine is a module fixture)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.api import Engine as JaxEngine
from eagle_tpu.api import EngineConfig as JaxEngineConfig
from eagle_tpu.gguf.constants import GGMLType
from eagle_tpu.runtime import infill as jinfill
from eagle_tpu.runtime.sampling import SamplerConfig as JaxSamplerConfig
from eagle_tpu_torch.api import Engine, EngineConfig
from eagle_tpu_torch.runtime.infill import (
    FimTokens,
    fim_tokens_from_metadata,
    format_infill,
    infill_filter,
)
from eagle_tpu_torch.runtime.sampling import SamplerConfig
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_PROMPT,
    background_cpu,
    spm_metadata,
    write_tiny_gguf_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

# ---- the reference's cases (tests/test_infill.py), on the port ---------------


def test_fim_from_metadata_keys():
    md = {"tokenizer.ggml.fim_pre_token_id": 11, "tokenizer.ggml.fim_suf_token_id": 12,
          "tokenizer.ggml.fim_mid_token_id": 13}
    fim = fim_tokens_from_metadata(md)
    assert (fim.pre, fim.suf, fim.mid) == (11, 12, 13)


def test_fim_from_legacy_keys():
    md = {"tokenizer.ggml.prefix_token_id": 1, "tokenizer.ggml.suffix_token_id": 2,
          "tokenizer.ggml.middle_token_id": 3}
    fim = fim_tokens_from_metadata(md)
    assert (fim.pre, fim.suf, fim.mid) == (1, 2, 3)


def test_fim_name_fallback_qwen_and_codellama():
    fim = fim_tokens_from_metadata({}, ["a", "<|fim_prefix|>", "<|fim_suffix|>",
                                        "<|fim_middle|>"])
    assert (fim.pre, fim.suf, fim.mid) == (1, 2, 3)
    fim = fim_tokens_from_metadata({}, ["x", "<PRE>", "<SUF>", "<MID>"])
    assert (fim.pre, fim.suf, fim.mid) == (1, 2, 3)
    assert fim_tokens_from_metadata({}, ["just", "words"]) is None


def test_format_infill_orders():
    fim = FimTokens(pre=100, suf=101, mid=102)
    assert format_infill([1, 2], [3], fim) == [100, 1, 2, 101, 3, 102]
    assert format_infill([1, 2], [3], fim, spm_infill=True) == [101, 3, 100, 1, 2, 102]
    with_bos = format_infill([1], [2], fim, bos_id=9, add_bos=True)
    assert with_bos[0] == 9 and with_bos[-1] == 102


def test_infill_filter_eog_gate():
    is_eog = np.asarray([False, False, True])
    f_ids, f_p = infill_filter(np.asarray([0, 1, 2]), np.asarray([0.4, 0.3, 0.3]),
                               ["a", "b", "<eos>"], is_eog, eot_id=2)
    assert list(f_ids) == [2]
    assert np.isclose(f_p.sum(), 1.0)


def test_infill_filter_prefix_merge():
    is_eog = np.asarray([False, False, False, True])
    f_ids, f_p = infill_filter(np.asarray([0, 1, 2, 3]), np.asarray([0.30, 0.40, 0.28, 0.02]),
                               ["fo", "foo", "bar", "<eos>"], is_eog, eot_id=3)
    assert 1 in f_ids and 0 not in f_ids
    assert dict(zip(f_ids.tolist(), f_p.tolist()))[1] > 0.6


def test_infill_filter_all_below_threshold_forces_eot():
    f_ids, f_p = infill_filter(np.arange(10), np.full(10, 0.1), [f"t{i}" for i in range(10)],
                               np.zeros(10, bool), eot_id=7)
    assert list(f_ids) == [7] and f_p[0] == 1.0


def test_server_infill_no_fim_tokens_is_400():
    assert fim_tokens_from_metadata({}, ["hello"]) is None


# ---- the functions against the reference's on seeded inputs ------------------

FIM_MD = [{}, {"tokenizer.ggml.fim_pre_token_id": 4, "tokenizer.ggml.fim_suf_token_id": 5,
               "tokenizer.ggml.fim_mid_token_id": 6, "tokenizer.ggml.fim_pad_token_id": 7,
               "tokenizer.ggml.fim_rep_token_id": 8, "tokenizer.ggml.fim_sep_token_id": 9},
          {"tokenizer.ggml.prefix_token_id": 1, "tokenizer.ggml.middle_token_id": 3},
          {"tokenizer.ggml.fim_suf_token_id": 2}]
PIECES = [None, ["a", "<fim-prefix>", "<fim-suffix>", "<fim-middle>"],
          ["<｜fim▁begin｜>", "<｜fim▁hole｜>", "<｜fim▁end｜>", "<PRE>"],
          ["<fim_prefix>", "x", "<fim_middle>", "<SUF>"], ["no", "fim"]]


@pytest.mark.parametrize("md", range(len(FIM_MD)))
def test_fim_tokens_match_reference(md):
    for pieces in PIECES:
        assert fim_tokens_from_metadata(FIM_MD[md], pieces) == (
            None if (want := jinfill.fim_tokens_from_metadata(FIM_MD[md], pieces)) is None
            else FimTokens(**vars(want)))


@pytest.mark.parametrize("seed", range(6))
def test_infill_filter_matches_reference(seed):
    """Random candidate sets over pieces that prefix each other, EOG tokens
    among them, and each format order with and without BOS."""
    rng = np.random.default_rng(seed)
    pieces = ["▁a", "▁ab", "▁abc", "b", "bc", "▁b", "c", "</s>", "d", "▁", "▁abd", "e"]
    is_eog = np.zeros(len(pieces), bool)
    is_eog[7] = True
    k = int(rng.integers(2, len(pieces) + 1))
    ids = rng.permutation(len(pieces))[:k]
    p = rng.dirichlet(np.full(k, 0.3 if seed % 2 else 2.0)) * rng.uniform(0.5, 1.0)
    got = infill_filter(ids, p.astype(np.float32), pieces, is_eog, eot_id=7)
    want = jinfill.infill_filter(ids, p.astype(np.float32), pieces, is_eog, eot_id=7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    fim = FimTokens(pre=20, suf=21, mid=22)
    jfim = jinfill.FimTokens(pre=20, suf=21, mid=22)
    pre, suf = rng.integers(0, 9, size=seed).tolist(), rng.integers(0, 9, size=3).tolist()
    for spm in (False, True):
        for bos in (True, False):
            assert format_infill(pre, suf, fim, spm, 1, bos) == jinfill.format_infill(
                pre, suf, jfim, spm, 1, bos)


# ---- Engine.infill against the reference's -----------------------------------

#: the output weights' scale: peaked logits, so that the infill sampler's
#: thresholds (a candidate needs p >= 0.2) keep text tokens and the fill
#: runs for several tokens before it ends
OUT_SCALE = 1.0
FIM_IDS = {"prefix": 500, "suffix": 501, "middle": 502, "eot": 503}


def fim_metadata() -> dict:
    """`spm_metadata` with CodeLlama's FIM control pieces at the vocabulary's
    last ids and their GGUF keys (CodeLlama-7b: ids 32007-32010)."""
    md = spm_metadata(ENGINE_PROMPT)
    toks = list(md["tokenizer.ggml.tokens"])
    ttype = np.asarray(md["tokenizer.ggml.token_type"]).copy()
    for (name, i), piece in zip(FIM_IDS.items(), ("▁<PRE>", "▁<SUF>", "▁<MID>", "▁<EOT>")):
        toks[i] = piece
        ttype[i] = 3  # control
        md[f"tokenizer.ggml.{name}_token_id"] = i
    md["tokenizer.ggml.tokens"] = toks
    md["tokenizer.ggml.token_type"] = ttype
    return md


@pytest.fixture(scope="module")
def fim_pair(tmp_path_factory):
    q8 = GGMLType.Q8_0
    return write_tiny_gguf_pair(tmp_path_factory.mktemp("infill"), q8, q8, q8, q8, seed=3,
                                target_metadata=fim_metadata(), out_scale=OUT_SCALE)


@pytest.fixture(scope="module")
def ref(fim_pair):
    """The reference's Engines (greedy and sampled) and a cache of their
    infills."""
    def make(greedy):
        return JaxEngine(JaxEngineConfig(
            model_path=str(fim_pair[0]), max_seq=128, backend="xla",
            compute_dtype=jnp.float32, kv_dtype=jnp.float32,
            sampler=JaxSamplerConfig(greedy=greedy)))

    return {"greedy": make(True), "sampled": make(False)}, {}


def port_engine(pair, greedy: bool) -> Engine:
    return Engine(EngineConfig(model_path=pair[0], max_seq=128, compute_dtype=torch.float32,
                               kv_dtype=torch.float32, device="cpu",
                               sampler=SamplerConfig(greedy=greedy)))


CASES = {"psm": dict(spm_infill=False), "spm": dict(spm_infill=True),
         "sampled": dict(seed=6, spm_infill=True)}
N_NEW = 12
TEXT = ("def fox(a, b):\n    return ", "\n\nprint(fox(1, 2))")


@pytest.mark.parametrize("case", list(CASES))
def test_engine_infill_matches_reference(ref, fim_pair, case, monkeypatch):
    kw = CASES[case]
    greedy = not case.startswith("sampled")
    engines, runs = ref
    if case not in runs:
        jeng = engines["greedy" if greedy else "sampled"]
        runs[case] = jeng.infill(*TEXT, max_new_tokens=N_NEW, **kw)
    assert runs[case]  # the fill runs for some tokens before it ends
    eng = port_engine(fim_pair, greedy)
    gen = eng.engine
    steps = []
    real = gen._logits_step
    monkeypatch.setattr(gen, "_logits_step", lambda lim: (steps.append(lim), real(lim)))
    assert eng.infill(*TEXT, max_new_tokens=N_NEW, **kw) == runs[case]
    assert steps and gen.graphs.eager == len(steps)  # one logits step a token (eager: the CPU)


def test_engine_infill_without_fim_tokens_raises(tmp_path):
    from torch_port_util import tiny_engine_pair

    pair = tiny_engine_pair(tmp_path, ENGINE_PROMPT)
    with pytest.raises(ValueError, match="no FIM tokens"):
        port_engine(pair, True).infill("a", "b")
