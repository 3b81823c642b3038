"""Rules of the PyTorch port that no numeric test shows:

- nothing in `eagle_tpu_torch/` or `chip_smoke.py` imports jax, ml_dtypes,
  `regex` or the JAX package (an AST scan of every import; the paged pool,
  the paged batcher, the state files and the BPE tokenizer among them), the
  BPE tokenizer takes its Unicode classes from its own data, not from
  `unicodedata`, and imports with `regex` blocked;
- an entry point built with its default device (the card) raises on a host
  without CUDA instead of falling back to the CPU (the engines, the loaders,
  `api.Engine` and the CLI among them);
- `generate` and `generate_constrained` refuse an empty prompt, the one
  input that would build a negative cache slot;
- a kernel wrapper given a non-CPU tensor and no buildable kernel raises and
  never runs the plain version;
- the codebook grids are read from the port's own copy of `iq_grids.npz`."""

import ast
import pathlib

import pytest
import torch

from eagle_tpu_torch import _build
from eagle_tpu_torch.models.config import ModelConfig
from eagle_tpu_torch.ops.flash_attention import flash_attention_cached, flash_attention_prefill
from eagle_tpu_torch.ops.qmm import qmm, qmm_i4, qmm_i4_stacked, qmm_stacked
from eagle_tpu_torch.quant.qtensor import QTensor

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "eagle_tpu", "ml_dtypes", "regex")


def _port_files():
    files = sorted(f for f in (ROOT / "eagle_tpu_torch").rglob("*.py")
                   if ".build" not in f.parts)  # build outputs, not sources
    files.append(ROOT / "chip_smoke.py")
    names = {str(f.relative_to(ROOT)) for f in files}
    for must in ("eagle_tpu_torch/gguf/reader.py", "eagle_tpu_torch/gguf/writer.py",
                 "eagle_tpu_torch/gguf/constants.py", "eagle_tpu_torch/models/loader.py",
                 "eagle_tpu_torch/quant/serving.py", "eagle_tpu_torch/ops/ffn.py",
                 "eagle_tpu_torch/quant/iq_blocks.py", "eagle_tpu_torch/tools/kernel_bench.py",
                 "eagle_tpu_torch/timing.py", "eagle_tpu_torch/runtime/tree.py",
                 "eagle_tpu_torch/runtime/tree2.py", "eagle_tpu_torch/runtime/sampling.py",
                 "eagle_tpu_torch/tokenizer/__init__.py", "eagle_tpu_torch/tokenizer/spm.py",
                 "eagle_tpu_torch/api.py", "eagle_tpu_torch/utils/args.py",
                 "eagle_tpu_torch/utils/logging.py", "eagle_tpu_torch/tools/cli.py",
                 "eagle_tpu_torch/tools/tokenize.py", "eagle_tpu_torch/runtime/scheduler.py",
                 "eagle_tpu_torch/server/server.py", "eagle_tpu_torch/server/batch_worker.py",
                 "eagle_tpu_torch/server/chat_templates.py", "eagle_tpu_torch/server/webui.py",
                 "eagle_tpu_torch/runtime/chat.py", "eagle_tpu_torch/runtime/paged_kv.py",
                 "eagle_tpu_torch/runtime/paged_batcher.py",
                 "eagle_tpu_torch/runtime/state_io.py", "eagle_tpu_torch/runtime/grammar.py",
                 "eagle_tpu_torch/runtime/json_schema.py",
                 "eagle_tpu_torch/server/tool_calls.py", "eagle_tpu_torch/runtime/lookahead.py",
                 "eagle_tpu_torch/runtime/lookup.py", "eagle_tpu_torch/runtime/infill.py",
                 "eagle_tpu_torch/tokenizer/bpe.py",
                 "eagle_tpu_torch/tokenizer/unicode_classes.py"):
        assert must in names
    return files


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_no_jax_or_reference_imports():
    bad = []
    for f in _port_files():
        for mod in _imported(ast.parse(f.read_text(), str(f))):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_bpe_tokenizer_needs_no_unicode_tables():
    """The BPE tokenizer's classes are the port's data: it imports neither
    `regex` nor `unicodedata`, and it tokenizes with `regex` blocked."""
    import subprocess
    import sys

    for name in ("bpe.py", "unicode_classes.py"):
        mods = set(_imported(ast.parse((ROOT / "eagle_tpu_torch/tokenizer" / name).read_text())))
        assert not mods & {"regex", "unicodedata"}, (name, mods)
    code = ("import sys; sys.modules['regex'] = None; sys.modules['unicodedata'] = None; "
            "from eagle_tpu_torch.tokenizer import BPETokenizer; "
            "from eagle_tpu_torch.tokenizer.bpe import _BYTE_ENC; "
            "t = BPETokenizer([_BYTE_ENC[b] for b in range(256)], [], [1] * 256, pre='llama3'); "
            "print(t.decode(t.encode('naïve 日本 123')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True)
    assert out.stdout.strip() == "naïve 日本 123"


TINY = ModelConfig(vocab_size=64, n_embd=256, n_layers=1, n_heads=4, n_kv_heads=2,
                   head_dim=64, n_ff=512)


@pytest.mark.parametrize("entry", ["KVCache.create", "synth_llama_params",
                                   "synth_eagle_params", "Generator", "EagleChainEngine",
                                   "EagleTreeEngine", "EagleTree2Engine",
                                   "params_from_numpy", "load_llama_params",
                                   "load_eagle_params", "Engine", "cli", "server",
                                   "ChatSession", "cli --chat", "PagedKVCache.create",
                                   "server --paged", "Engine paged int8",
                                   "Generator.generate_constrained",
                                   "EagleChainEngine.generate_constrained",
                                   "cli --grammar", "LookaheadEngine", "LookupEngine",
                                   "cli --lookahead"])
def test_default_device_raises_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from eagle_tpu_torch.api import Engine, EngineConfig
    from eagle_tpu_torch.convert import params_from_numpy
    from eagle_tpu_torch.server import server
    from eagle_tpu_torch.tools import cli
    from eagle_tpu_torch.models.loader import load_eagle_params, load_llama_params
    from eagle_tpu_torch.models.synth import synth_eagle_params, synth_llama_params
    from eagle_tpu_torch.runtime.chat import ChatSession
    from eagle_tpu_torch.runtime.generate import Generator
    from eagle_tpu_torch.runtime.kvcache import KVCache
    from eagle_tpu_torch.runtime.lookahead import LookaheadEngine
    from eagle_tpu_torch.runtime.lookup import LookupEngine
    from eagle_tpu_torch.runtime.paged_kv import PagedKVCache
    from eagle_tpu_torch.runtime.speculative import EagleChainEngine
    from eagle_tpu_torch.runtime.tree import EagleTreeEngine
    from eagle_tpu_torch.runtime.tree2 import EagleTree2Engine

    calls = {
        "KVCache.create": lambda: KVCache.create(1, 1, 16, 2, 64),
        "synth_llama_params": lambda: synth_llama_params(TINY),
        "synth_eagle_params": lambda: synth_eagle_params(TINY),
        "Generator": lambda: Generator({}, TINY, max_seq=16),
        "EagleChainEngine": lambda: EagleChainEngine({}, {}, TINY, max_seq=16),
        "EagleTreeEngine": lambda: EagleTreeEngine({}, {}, TINY, max_seq=16),
        "EagleTree2Engine": lambda: EagleTree2Engine({}, {}, TINY, max_seq=16),
        "params_from_numpy": lambda: params_from_numpy({}),
        "load_llama_params": lambda: load_llama_params("no-such-file.gguf"),
        "load_eagle_params": lambda: load_eagle_params("no-such-file.gguf"),
        "Engine": lambda: Engine(EngineConfig(model_path="no-such-file.gguf")),
        "cli": lambda: cli.main(["-m", "no-such-file.gguf", "-p", "a"]),
        "server": lambda: server.main(["-m", "no-such-file.gguf", "-np", "2"]),
        "ChatSession": lambda: ChatSession(Generator({}, TINY, max_seq=16), tokenizer=None),
        "cli --chat": lambda: cli.main(["-m", "no-such-file.gguf", "--chat"]),
        "PagedKVCache.create": lambda: PagedKVCache.create(1, 2, 4, 2, 16, 2, 64),
        "server --paged": lambda: server.main(["-m", "no-such-file.gguf", "-np", "2",
                                               "--paged"]),
        "Engine paged int8": lambda: Engine(EngineConfig(
            model_path="no-such-file.gguf", batch=2, paged=True, kv_dtype=torch.int8)),
        "Generator.generate_constrained": lambda: Generator({}, TINY, max_seq=16)
        .generate_constrained([1, 2], None, None),
        "EagleChainEngine.generate_constrained": lambda: EagleChainEngine(
            {}, {}, TINY, max_seq=16).generate_constrained([1, 2], None, None),
        "cli --grammar": lambda: cli.main(["-m", "no-such-file.gguf", "-p", "a", "--grammar",
                                           'root ::= "a"']),
        "LookaheadEngine": lambda: LookaheadEngine({}, TINY, max_seq=64),
        "LookupEngine": lambda: LookupEngine({}, TINY, max_seq=16),
        "cli --lookahead": lambda: cli.main(["-m", "no-such-file.gguf", "-p", "a", "--temp", "0",
                                             "--lookahead", "4,3,2"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["Generator", "EagleChainEngine", "EagleTreeEngine",
                                   "EagleTree2Engine", "LookaheadEngine", "LookupEngine"])
def test_empty_prompt_raises(entry):
    """An empty prompt would put the first decode or draft slot at -1, which
    the reference's scatter drops and PyTorch's `scatter_` refuses (the
    model-free engines' prefill would read its last row at -1)."""
    from eagle_tpu_torch.runtime.generate import Generator
    from eagle_tpu_torch.runtime.lookahead import LookaheadEngine
    from eagle_tpu_torch.runtime.lookup import LookupEngine
    from eagle_tpu_torch.runtime.speculative import EagleChainEngine
    from eagle_tpu_torch.runtime.tree import EagleTreeEngine
    from eagle_tpu_torch.runtime.tree2 import EagleTree2Engine

    cls = {"Generator": Generator, "EagleChainEngine": EagleChainEngine,
           "EagleTreeEngine": EagleTreeEngine, "EagleTree2Engine": EagleTree2Engine,
           "LookaheadEngine": LookaheadEngine, "LookupEngine": LookupEngine}[entry]
    args = ({},) if entry in ("Generator", "LookaheadEngine", "LookupEngine") else ({}, {})
    runner = cls(*args, TINY, max_seq=64, device="cpu")
    with pytest.raises(ValueError, match="at least one token"):
        runner.generate([], max_new_tokens=4)


@pytest.mark.parametrize("entry", ["Generator", "EagleChainEngine"])
def test_empty_prompt_raises_constrained(entry):
    """`generate_constrained` refuses an empty prompt as `generate` does."""
    from eagle_tpu_torch.runtime.generate import Generator
    from eagle_tpu_torch.runtime.speculative import EagleChainEngine

    runner = (Generator({}, TINY, max_seq=16, device="cpu") if entry == "Generator"
              else EagleChainEngine({}, {}, TINY, max_seq=16, device="cpu"))
    with pytest.raises(ValueError, match="at least one token"):
        runner.generate_constrained([], None, None, max_new_tokens=4)


@pytest.fixture
def no_kernels(monkeypatch, tmp_path):
    """No built library and no nvcc: the kernels cannot be built."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _build.reset_counts()
    yield
    assert sum(_build.plain_calls.values()) == 0  # never the plain version
    assert sum(_build.launches.values()) == 0


def _meta_weight(stack=None):
    lead = () if stack is None else (stack,)
    kw = dict(device="meta")
    return QTensor(
        q=torch.empty(lead + (128, 64), dtype=torch.int8, **kw),
        scale=torch.empty(lead + (8, 64), dtype=torch.int8, **kw),
        bias=torch.empty(lead + (8, 64), dtype=torch.int8, **kw),
        sup=torch.empty(lead + (1, 64), dtype=torch.float32, **kw),
        sup_min=torch.empty(lead + (1, 64), dtype=torch.float32, **kw),
        group=32, layout="kn", packed=True,
    )


def _meta_ffn_weight(n, k):
    """A stacked Q4_0-form weight (packed, f32 scale and bias) on `meta`."""
    kw = dict(device="meta")
    return QTensor(q=torch.empty((2, k // 2, n), dtype=torch.int8, **kw),
                   scale=torch.empty((2, k // 32, n), **kw),
                   bias=torch.empty((2, k // 32, n), **kw), group=32, layout="kn", packed=True)


def _meta_int4_weight(stack=None):
    lead = () if stack is None else (stack,)
    kw = dict(device="meta")
    return QTensor(q=torch.empty(lead + (128, 64), dtype=torch.int8, **kw),
                   scale=torch.empty(lead + (8, 64), dtype=torch.bfloat16, **kw),
                   bias=torch.empty(lead + (8, 64), dtype=torch.bfloat16, **kw),
                   group=32, layout="kn", int4=True)


@pytest.mark.parametrize("call", ["qmm", "qmm_stacked", "flash_decode", "flash_prefill",
                                  "ffn_out_norm", "gate_up_act", "qmm_i4", "qmm_i4_stacked"])
def test_device_tensor_without_kernel_raises(no_kernels, call):
    from eagle_tpu_torch.ops.ffn import ffn_out_norm, gate_up_act

    meta = dict(device="meta")
    x = torch.empty((1, 256), **meta)
    q = torch.empty((1, 1, 4, 64), **meta)
    cache = torch.empty((1, 1, 2, 128, 64), dtype=torch.bfloat16, **meta)
    fns = {
        "qmm": lambda: qmm(x, _meta_weight()),
        "qmm_stacked": lambda: qmm_stacked(x, _meta_weight(stack=2), 1),
        "flash_decode": lambda: flash_attention_cached(
            q, cache, cache, torch.empty((1, 1, 128), dtype=torch.bool, **meta), 0),
        "flash_prefill": lambda: flash_attention_prefill(
            q, cache, cache, torch.empty((1, 1), dtype=torch.int32, **meta),
            torch.empty((1, 128), dtype=torch.int32, **meta), 0),
        "ffn_out_norm": lambda: ffn_out_norm(
            torch.empty((1, 256), **meta), torch.empty((1, 128), **meta),
            torch.empty((128,), **meta), _meta_ffn_weight(128, 256), 1, 1e-6),
        "gate_up_act": lambda: gate_up_act(torch.empty((1, 256), **meta),
                                           _meta_ffn_weight(256, 256), 1),
        "qmm_i4": lambda: qmm_i4(x, _meta_int4_weight()),
        "qmm_i4_stacked": lambda: qmm_i4_stacked(x, _meta_int4_weight(stack=2), 1),
    }
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fns[call]()


def test_iq_grids_come_from_the_port(monkeypatch):
    """The codebook formats read the port's copy of iq_grids.npz (the same
    bytes as the reference's), never a file of the JAX package."""
    import numpy as np

    from eagle_tpu_torch.quant import iq_blocks

    own = ROOT / "eagle_tpu_torch" / "quant" / "iq_grids.npz"
    assert iq_blocks.NPZ == own and own.is_file()
    assert own.read_bytes() == (ROOT / "eagle_tpu" / "quant" / "iq_grids.npz").read_bytes()
    opened = []
    real_load = np.load
    monkeypatch.setattr(np, "load", lambda path, *a, **k: (opened.append(path),
                                                           real_load(path, *a, **k))[1])
    iq_blocks._host_grids.cache_clear()
    try:
        grids = iq_blocks._host_grids()
    finally:
        iq_blocks._host_grids.cache_clear()
    assert opened == [own]
    assert grids["ksigns"].shape == (128,) and grids["iq1s"].shape == (2048, 8)
