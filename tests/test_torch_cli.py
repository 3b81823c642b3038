"""The port's command-line tools and refusals on the CPU: `tools.cli.main`
(`--device cpu`) on a tiny GGUF pair with an SPM vocabulary prints the text
and the `[speculative]` line, `tools.tokenize` the ids; every flag of the
CLI and the server, config and entry point the port does not have yet
raises NotImplementedError naming its ROADMAP item, and a stateful sampler
(`--repeat-penalty`) where the reference drops its state (with a draft,
with a grammar) raises `DroppedSamplerState`, and a sampled config under
lookahead decoding (which the reference decodes greedily) raises
`SamplerIgnored`, while `--lookahead W,N,G --temp 0` runs and prints the
`[lookahead]` line; `Engine.infill` on a vocabulary without FIM tokens
raises ValueError, as the reference's; the server's `--grammar`
becomes its default grammar; `batch` > 1 with a chain draft builds the
continuous batcher (`paged`: the paged one); the paged and prompt-cache
flags parse; the entry points default to the card."""

import pytest
import torch

from eagle_tpu_torch.api import Engine, EngineConfig
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.lookahead import LookaheadEngine
from eagle_tpu_torch.runtime.paged_batcher import PagedBatcher
from eagle_tpu_torch.runtime.sampling import SamplerConfig
from eagle_tpu_torch.runtime.scheduler import ContinuousBatcher
from eagle_tpu_torch.server import server
from eagle_tpu_torch.tools import cli, tokenize
from torch_port_util import tiny_engine_pair

PROMPT = "the quick brown fox jumps over a lazy dog and then"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tiny_engine_pair(tmp_path_factory.mktemp("cli"), PROMPT)


@pytest.fixture(scope="module")
def engine(pair):
    return Engine(EngineConfig(model_path=pair[0], draft_path=pair[1], max_seq=128,
                               compute_dtype=torch.float32, kv_dtype=torch.float32, device="cpu"))


def test_cli_prints_text_and_speculative_line(pair, capsys):
    assert cli.main(["-m", str(pair[0]), "--draft", str(pair[1]), "-p", PROMPT, "-n", "8",
                     "--device", "cpu", "--ctx", "128", "--seed", "3"]) == 0
    out, err = capsys.readouterr()
    assert out.strip() and "[load]" in err and "[perf]" in err
    assert "[speculative] accept_rate=" in err and "mean_accept_len=" in err
    assert tokenize.main(["-m", str(pair[0]), "-p", "the fox", "--ids"]) == 0
    ids = [int(x) for x in capsys.readouterr().out.split()]
    assert ids[0] == 1 and len(ids) == 3


DROPS = "drops the sampler's state"
GREEDY = "decodes greedily"
REFUSED_FLAGS = [(["--lora", "a.gguf"], "item 9"), (["--lora-scale", "0.5"], "item 9"),
                 # lookahead runs greedy only: the CLI's default sampler is refused
                 (["--lookahead", "4,3,2"], GREEDY),
                 # the stateful samplers and grammars run; together, or a penalty under a
                 # draft, the reference drops the sampler's state
                 (["--grammar", "root ::= \"a\"", "--repeat-penalty", "1.1"], DROPS),
                 (["--json-schema", "{}", "--temp", "0", "--repeat-penalty", "1.2"], DROPS),
                 (["--jinja"], "jinja2"), (["--backend", "xla"], "--device"),
                 (["--repeat-penalty", "1.1", "--draft", "DRAFT"], DROPS)]


@pytest.mark.parametrize("flags,item", REFUSED_FLAGS, ids=[f[0][0] for f in REFUSED_FLAGS])
def test_cli_refuses_what_is_not_ported(pair, flags, item, capsys):
    flags = [str(pair[1]) if f == "DRAFT" else f for f in flags]
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["-m", str(pair[0]), "-p", "a", "--device", "cpu", *flags])
    if item == GREEDY:  # greedy, it runs and prints the reference's [lookahead] line
        assert cli.main(["-m", str(pair[0]), "-p", PROMPT, "-n", "8", "--device", "cpu",
                         "--ctx", "128", "--temp", "0", *flags]) == 0
        out, err = capsys.readouterr()
        assert out.strip() and "[lookahead] tokens_per_step=" in err and "steps=" in err


ENGINE_REFUSALS = [(dict(lora_path="a.gguf"), "item 9"), (dict(lora_scale=0.5), "item 9"),
                   (dict(lookahead=(4, 3, 2), sampler=SamplerConfig()), GREEDY),
                   (dict(draft_path="DRAFT", sampler=SamplerConfig(mirostat=2)), DROPS)]


@pytest.mark.parametrize("kw,item", ENGINE_REFUSALS,  # the ids of the cases before mirostat ran
                         ids=["kw0-item 9", "kw1-item 9", "kw2-item 7", "kw3-item 7"])
def test_engine_config_refusals(pair, kw, item):
    kw = {k: pair[1] if v == "DRAFT" else v for k, v in kw.items()}
    with pytest.raises(NotImplementedError, match=item):
        Engine(EngineConfig(model_path=pair[0], device="cpu", **kw))
    if "lookahead" in kw:  # greedy, the lookahead engine runs; a sampled request is refused
        eng = Engine(EngineConfig(model_path=pair[0], device="cpu", max_seq=128,
                                  compute_dtype=torch.float32, kv_dtype=torch.float32,
                                  lookahead=kw["lookahead"]))
        assert isinstance(eng.engine, LookaheadEngine)
        assert (eng.engine.lay.W, eng.engine.lay.N, eng.engine.lay.G) == kw["lookahead"]
        text, stats = eng.generate_text("the fox", max_new_tokens=6)
        assert text and stats["n_predict"] == 6 and stats["n_steps"] >= 1
        with pytest.raises(NotImplementedError, match=item):
            eng.generate_text("the fox", sampler=kw["sampler"])
    elif "sampler" in kw:  # without the draft the port runs mirostat
        Engine(EngineConfig(model_path=pair[0], device="cpu", sampler=kw["sampler"]))


SERVER_REFUSED = [(["--jinja"], "jinja2"),
                  (["--grammar", "root ::= \"a\""], None), (["--lora", "a.gguf"], "item 9"),
                  (["--lora-scale", "0.5"], "item 9"), (["--backend", "xla"], "--device")]


@pytest.mark.parametrize("flags,item", SERVER_REFUSED, ids=[f[0][0] for f in SERVER_REFUSED])
def test_server_refuses_what_is_not_ported(pair, flags, item, monkeypatch):
    """What the server lacks raises; `--grammar` (item None) is the
    server's default grammar: `main` builds the server with it."""
    argv = ["-m", str(pair[0]), "--device", "cpu", "-np", "2", *flags]
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            server.main(argv)
        return
    served = []
    monkeypatch.setattr(server.InferenceServer, "run", lambda self, **kw: served.append(self))
    assert server.main(argv) == 0
    assert served[0].grammar == flags[1]
    served[0].stop()


@pytest.mark.parametrize("kind", ["chain", "tree", "plain", "paged", "paged_int8"])
def test_batch_engine_builds_the_batcher(pair, kind):
    """As the reference: a chain draft with batch > 1 gets a batcher over a
    batch-row chain engine (with `paged`, a PagedBatcher over a pool of
    `kv_pages` pages, by default batch x pages per slot); the tree engines
    and Generator get none."""
    extra = {"chain": {}, "tree": dict(tree_branching=(2,)), "plain": {},
             "paged": dict(paged=True, page_size=16),
             "paged_int8": dict(paged=True, kv_pages=5, kv_dtype=torch.int8)}[kind]
    cfg = dict(model_path=pair[0], draft_path=None if kind == "plain" else pair[1], batch=3,
               max_seq=128, compute_dtype=torch.float32, kv_dtype=torch.float32, device="cpu")
    eng = Engine(EngineConfig(**{**cfg, **extra}))
    if kind in ("chain", "paged", "paged_int8"):
        assert isinstance(eng.batcher, ContinuousBatcher) and eng.batcher.batch == 3
        assert eng.engine.batch == 3 and eng.batcher.engine is eng.engine
        assert isinstance(eng.batcher, PagedBatcher) == kind.startswith("paged")
    else:
        assert eng.batcher is None
    if kind == "paged":  # 3 slots x 128 / 16 pages
        assert eng.batcher.pools["tgt"].n_pages == 24 and eng.batcher.ps == 16
        text, _ = eng.generate_text("the lazy dog", max_new_tokens=6)
        assert text == Engine(EngineConfig(**cfg)).generate_text("the lazy dog",
                                                                 max_new_tokens=6)[0]
        with pytest.raises(ValueError, match="page pool"):  # the pool is the batcher's
            eng.engine.generate([1, 5, 6], max_new_tokens=2)
    if kind == "paged_int8":
        assert eng.batcher.pools["tgt"].n_pages == 5 and eng.batcher.ps == 64
        assert eng.engine.state.tgt_kv.k.dtype == torch.int8
        assert eng.engine.state.tgt_kv.k_scale.shape == (2, 6, 2, 64)


def test_paged_and_session_flags_parse():
    """The flags that refused before parse with the reference's defaults and
    pass `check_refused`."""
    from eagle_tpu_torch.utils.args import build_parser, check_refused

    args = build_parser("server").parse_args(["-m", "x", "--paged", "--kv-pages", "16",
                                              "--page-size", "32"])
    check_refused(args, "server")
    assert (args.paged, args.kv_pages, args.page_size) == (True, 16, 32)
    d = build_parser("server").parse_args(["-m", "x"])
    assert (d.paged, d.kv_pages, d.page_size) == (False, None, 64)
    args = build_parser("cli").parse_args(["-m", "x", "--prompt-cache", "s.bin",
                                           "--prompt-cache-all"])
    check_refused(args, "cli")
    assert (args.prompt_cache, args.prompt_cache_all) == ("s.bin", True)


def test_entry_point_refusals(engine):
    """`infill` on a vocabulary without FIM tokens raises ValueError, as
    the reference's; a grammar and a JSON schema run (the chain
    engine speculates under them), and with a stateful sampler raise where
    the reference would drop its state."""
    eng = engine
    text, stats = eng.generate_text("a", max_new_tokens=4, grammar="root ::= \"a\"")
    assert text == "a" and stats["constrained"]
    text, stats = eng.generate_text("a", max_new_tokens=6, json_schema={"type": "boolean"})
    assert text in ("true", "false", "t", "tr", "tru", "f", "fa", "fal", "fals")
    with pytest.raises(ValueError, match="no FIM tokens"):
        eng.infill("a", "b")
    with pytest.raises(NotImplementedError, match=DROPS):
        eng.generate_text("a", grammar="root ::= \"a\"", sampler=SamplerConfig(penalty_repeat=1.1))
    gen = eng._plain_generator()
    assert isinstance(gen, Generator)
    # Self-Extend and prompt sessions, refused before, run (tests/test_torch_int8_kv.py and
    # tests/test_torch_state_io.py hold them against the reference)
    assert len(gen.generate([1, 5, 6], 4, grp_attn_n=2, grp_attn_w=4, stop_at_eos=False)) == 4


def test_engine_defaults_to_the_card(pair):
    assert EngineConfig().device == "cuda" and EngineConfig().feature_source == "pre_norm"
    assert cli.build_argparser().parse_args(["-m", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(EngineConfig(model_path=pair[0]))
