"""The port's normal entry point on the CPU against the reference: greedy
`generate_text` of `eagle_tpu_torch.api.Engine` (f32, `device="cpu"`) on a
tiny GGUF pair minted with the reference's GGUFWriter (the tiny_cfgs
shapes, Q8_0 weights) and an SPM vocabulary of 512 pieces gives the
reference Engine's text and speculative stats (`backend="xla"`, f32) for
`Generator`, the chain, the static tree and EAGLE-2.

tests/test_torch_engine_sampled.py runs the sampled engines on such a pair,
tests/test_torch_cli.py the CLI and the refusals."""

import jax.numpy as jnp
import pytest

from eagle_tpu.api import Engine as JaxEngine
from eagle_tpu.api import EngineConfig as JaxEngineConfig
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_KINDS as KINDS,
    ENGINE_PROMPT as PROMPT,
    background_cpu,
    tiny_engine_pair,
    tiny_port_engine,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tiny_engine_pair(tmp_path_factory.mktemp("engine"), PROMPT)


@pytest.fixture(scope="module")
def engines(pair):
    return {k: tiny_port_engine(pair, k) for k in KINDS}


@pytest.mark.parametrize("kind", list(KINDS))
def test_greedy_text_matches_reference(pair, engines, kind):
    want_text, want_stats = JaxEngine(JaxEngineConfig(
        model_path=str(pair[0]), draft_path=None if kind == "plain" else str(pair[1]),
        max_seq=128, backend="xla", compute_dtype=jnp.float32, kv_dtype=jnp.float32,
        **KINDS[kind])).generate_text(PROMPT, max_new_tokens=16)
    eng = engines[kind]
    assert eng.tokenizer.encode(PROMPT)[:3] == [1] + eng.tokenizer.encode("the quick",
                                                                           add_bos=False)
    text, stats = eng.generate_text(PROMPT, max_new_tokens=16)
    assert text == want_text
    assert stats == want_stats
    assert (stats.get("n_cycles", 0) > 0) == (kind != "plain")
