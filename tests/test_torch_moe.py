"""The port's mixture-of-experts path and its dense reads on the CPU,
against the reference:

- the dense read of every block format the port reads (the 20 of
  `REPACKABLE_TYPES`), 2-D and 3-D ([E, N, K] expert stacks), through
  `GGUFReader.tensor_f32`: bit for bit the reference's `dequantize`;
- `_moe_ffn` against the reference's at rtol 1e-5 in f32: Mixtral's rule
  (softmax over the top k), softmax over every expert (qwen2moe) with and
  without `expert_weights_norm` / `expert_weights_scale`, the shared expert
  with and without its sigmoid gate, and a router tie at the k-th value,
  which keeps every tied expert;
- tiny MoE GGUFs (2 layers, width 256, 4 experts, top 2) minted with the
  reference's `GGUFWriter`: Mixtral written as llama.cpp writes it (`llama`
  with `llama.expert_count`, Q4_K experts) and as the reference's converter
  writes it (`mixtral`, Q8_0 experts), and Qwen2-MoE (q/k/v biases, Q4_K
  experts, a shared expert of 512 with its gate). Both packages load them
  alike (every leaf bit-equal), the forward's logits agree at rtol 1e-4,
  `Generator` and the EAGLE chain give the reference's tokens, the static
  tree and EAGLE-2 give the port's greedy tokens (with a random and with an
  oracle draft), and `Engine(batch=2)` gives each slot the single-sequence
  tokens;
- a gpt2 file with a Q8_0 `position_embd`: the reference's logits;
- the refusals, each naming ROADMAP queue 1, item 8."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eagle_tpu.gguf.constants import GGMLType as JGGMLType
from eagle_tpu.gguf.reader import GGUFReader as JReader
from eagle_tpu.gguf.writer import GGUFWriter as JWriter
from eagle_tpu.models.config import ModelConfig as JaxCfg
from eagle_tpu.models.llama import _moe_ffn as jax_moe_ffn
from eagle_tpu.models.loader import load_llama_params as jax_load
from eagle_tpu_torch.api import Engine, EngineConfig
from eagle_tpu_torch.gguf.reader import GGUFReader
from eagle_tpu_torch.models.config import (
    MOE_ARCHS,
    TARGET_ARCHS,
    ModelConfig,
    check_ported,
)
from eagle_tpu_torch.models.llama import _moe_ffn, check_layer_keys
from eagle_tpu_torch.models.loader import load_llama_params
from eagle_tpu_torch.ops.ffn import supports_ffn_block
from eagle_tpu_torch.quant import qtensor
from eagle_tpu_torch.quant.qtensor import REPACKABLE_TYPES, dequantize
from eagle_tpu_torch.runtime import tree, tree2
from eagle_tpu_torch.runtime.generate import Generator
from test_torch_families import MAX_SEQ, _close, _jax_engine, _port_engine
from test_torch_lnfamilies import _cache, _forward, _jax_forward, _jcache, _tokens
from test_torch_loader import _same_tree
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_PROMPT,
    background_cpu,
    jax_cfg_to_torch,
    ln_vocab,
    oracle,
    random_blocks,
    spm_metadata,
    tree_to_numpy,
    write_tiny_gguf_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

# ---- the dense read ---------------------------------------------------------

FORMATS = [t.name for t in REPACKABLE_TYPES]
SHAPES = {"2d": (8, 512), "3d": (3, 4, 512)}


@pytest.fixture(scope="module")
def format_file(tmp_path_factory):
    """A GGUF holding each format as an [8, 512] tensor and a [3, 4, 512]
    stack of random blocks (finite f16 scales of both signs)."""
    path = tmp_path_factory.mktemp("formats") / "formats.gguf"
    rng = np.random.default_rng(41)
    w = JWriter(path)
    w.add("general.architecture", "llama")
    for name in FORMATS:
        for dim, shape in SHAPES.items():
            n = int(np.prod(shape[:-1]))
            w.add_tensor(f"{name}.{dim}", random_blocks(rng, JGGMLType[name], n, shape[-1]),
                         ggml_type=JGGMLType[name], raw_shape=shape)
    w.write()
    return path


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dim", list(SHAPES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_dense_read_bit_equal(format_file, fmt, dim):
    """`GGUFReader.tensor_f32` of a block format: the reference's
    `dequantize` bit for bit (signed zeros included), at its logical shape."""
    name = f"{fmt}.{dim}"
    with JReader(format_file) as ref:
        want = ref.tensor_f32(name)
    port = GGUFReader(format_file)
    got = port.tensor_f32(name)
    port.close()
    assert got.dtype == np.float32 and got.shape == want.shape == SHAPES[dim]
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_K", "Q5_0", "IQ1_M"])
def test_dense_read_chunks_and_dtype(format_file, fmt, monkeypatch):
    """Decoded a few rows at a time (`DENSE_CHUNK`), into a bf16 stack
    slot, the values are the whole decode's, rounded once to bf16; bytes of
    the wrong length raise."""
    port = GGUFReader(format_file)
    name = f"{fmt}.3d"
    raw = torch.from_numpy(port.tensor_bytes(name))
    whole = dequantize(raw, JGGMLType[fmt], SHAPES["3d"])
    np.testing.assert_array_equal(_bits(whole.numpy()), _bits(port.tensor_f32(name)))
    monkeypatch.setattr(qtensor, "DENSE_CHUNK", 1000)
    assert torch.equal(dequantize(raw, JGGMLType[fmt], SHAPES["3d"]), whole)
    out = torch.zeros((2, *SHAPES["3d"]), dtype=torch.bfloat16)
    monkeypatch.setattr(qtensor, "DENSE_CHUNK", 512)
    dequantize(raw, JGGMLType[fmt], SHAPES["3d"], out=out[1])
    assert torch.equal(out[1], whole.to(torch.bfloat16)) and not out[0].any()
    with pytest.raises(ValueError, match="bytes"):
        dequantize(raw[:-1], JGGMLType[fmt], SHAPES["3d"])
    port.close()


# ---- the MoE FFN against the reference's ------------------------------------

D, N_EXP, F_EXP, F_SH, L = 256, 4, 128, 192, 2
#: (config changes, layers with a shared expert, with its gate, router tie)
FFN_CASES = {
    "mixtral": (dict(), False, False, False),
    "mixtral tie": (dict(), False, False, True),
    "softmax all": (dict(arch="qwen2moe", moe_softmax_all=True), False, False, False),
    "softmax all tie": (dict(arch="qwen2moe", moe_softmax_all=True), False, False, True),
    "softmax all norm scale": (dict(arch="qwen2moe", moe_softmax_all=True,
                                    expert_weights_norm=True, expert_weights_scale=2.5),
                               False, False, False),
    "shared expert": (dict(arch="qwen2moe", moe_softmax_all=True), True, False, False),
    "shared expert gated": (dict(arch="qwen2moe", moe_softmax_all=True), True, True, False),
}


def _ffn_layers(seed: int, shexp: bool, gate: bool, tie: bool) -> dict:
    """Random layer-stacked MoE weights (numpy f32). With `tie`, router rows
    1 and 2 are equal and rows 0 and 3 are +3 and -1 times them: every row's
    order is 0 > 1 = 2 > 3 or 3 > 1 = 2 > 0, so at k = 2 the k-th logit is
    a tie of two experts."""
    rng = np.random.default_rng(seed)

    def mat(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    layers = {"ffn_gate_inp": mat(L, N_EXP, D, s=0.1), "w_gate_exps": mat(L, N_EXP, F_EXP, D),
              "w_up_exps": mat(L, N_EXP, F_EXP, D), "w_down_exps": mat(L, N_EXP, D, F_EXP)}
    if tie:
        v = layers["ffn_gate_inp"][:, 1]
        layers["ffn_gate_inp"][:, 0], layers["ffn_gate_inp"][:, 2] = 3 * v, v
        layers["ffn_gate_inp"][:, 3] = -v
    if shexp:
        layers.update(w_gate_shexp=mat(L, F_SH, D), w_up_shexp=mat(L, F_SH, D),
                      w_down_shexp=mat(L, D, F_SH))
        if gate:
            layers["ffn_gate_inp_shexp"] = mat(L, 1, D, s=0.2)
    return layers


def _ffn_cfgs(change: dict):
    fields = dict(arch="mixtral", n_embd=D, n_expert=N_EXP, n_expert_used=2) | change
    return JaxCfg(**fields), ModelConfig(**fields)


def _x(seed: int = 43) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((2, 5, D)).astype(np.float32)


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_reference(case):
    """`_moe_ffn` on layer 1 of random weights: the reference's output at
    rtol 1e-5 (f32)."""
    change, shexp, gate, tie = FFN_CASES[case]
    jcfg, cfg = _ffn_cfgs(change)
    layers = _ffn_layers(47, shexp, gate, tie)
    x = _x()
    want = jax_moe_ffn(jcfg, {k: jnp.asarray(v) for k, v in layers.items()}, 1, jnp.asarray(x),
                       jax.nn.silu, "xla", jnp.float32)
    got = _moe_ffn(cfg, {k: torch.from_numpy(v) for k, v in layers.items()}, 1,
                   torch.from_numpy(x), F.silu, torch.float32)
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-5)


@pytest.mark.parametrize("case", ["mixtral tie", "softmax all tie"])
def test_router_tie_keeps_every_tied_expert(case):
    """At a tie at the k-th router value every tied expert is kept (3 of 4
    at k = 2), as the reference's `>= top_k(...)[0][..., -1:]` keeps them: the
    output is the sum over all three, not the two `torch.topk` indices."""
    change, *_ = FFN_CASES[case]
    _, cfg = _ffn_cfgs(change)
    layers = {k: torch.from_numpy(v) for k, v in _ffn_layers(47, False, False, True).items()}
    x = torch.from_numpy(_x())
    got = _moe_ffn(cfg, layers, 1, x, F.silu, torch.float32)
    xr = x.reshape(-1, D)
    router = xr @ layers["ffn_gate_inp"][1].T
    assert bool((router[:, 1] == router[:, 2]).all())
    kept = router >= torch.topk(router, 2, dim=-1).values[:, -1:]
    assert bool((kept.sum(-1) == 3).all())

    def experts(mask):
        """The FFN with the router's weights over `mask`'s experts."""
        if cfg.moe_softmax_all:
            probs = torch.where(mask, torch.softmax(router, -1), 0.0)
        else:
            probs = torch.softmax(torch.where(mask, router, float("-inf")), -1)
        out = 0
        for e in range(N_EXP):
            g = xr @ layers["w_gate_exps"][1, e].T
            u = xr @ layers["w_up_exps"][1, e].T
            out = out + (F.silu(g) * u) @ layers["w_down_exps"][1, e].T * probs[:, e:e + 1]
        return out.reshape(got.shape)

    idx = torch.topk(router, 2, dim=-1).indices
    two = torch.zeros_like(kept).scatter(1, idx, True)
    _close(got, experts(kept).numpy(), rtol=1e-5)
    assert float((got - experts(two)).abs().max()) > 1e-3 * float(got.abs().max())


# ---- tiny MoE files through both packages -----------------------------------

#: arch -> (write_tiny_gguf_pair's `moe`, the vocabulary's words)
MOE_FILES = {
    "llama": dict(n_expert=4, n_used=2, n_ff_exp=256, type=JGGMLType.Q4_K, shexp=0),
    "mixtral": dict(n_expert=4, n_used=2, n_ff_exp=256, type=JGGMLType.Q8_0, shexp=0),
    "qwen2moe": dict(n_expert=4, n_used=2, n_ff_exp=256, type=JGGMLType.Q4_K, shexp=512),
}
ARCHS = list(MOE_FILES)
PROMPT = ENGINE_PROMPT + " and a dog"
N_NEW = 20


def tiny_moe_pair(tmp_path, arch: str):
    q8 = JGGMLType.Q8_0
    return write_tiny_gguf_pair(tmp_path, q8, q8, q8, q8, seed=31, arch=arch,
                                target_metadata=spm_metadata(ENGINE_PROMPT), moe=MOE_FILES[arch])


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return {a: tiny_moe_pair(tmp_path_factory.mktemp(a), a) for a in ARCHS}


@pytest.fixture(scope="module")
def models(pairs):
    out = {}
    for a, (target, _) in pairs.items():
        tt, tcfg, _ = load_llama_params(target, device="cpu", dense_dtype=torch.float32)
        jt, jcfg, _ = jax_load(target)
        out[a] = dict(tt=tt, tcfg=tcfg, jt=jt, jcfg=jcfg)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_config_reads_the_experts(models, arch):
    """The experts' fields as the reference reads them, field for field:
    4 experts, 2 used, softmax over all experts and q/k/v biases on
    qwen2moe; the layers carry the router and the experts in place of the
    dense FFN, qwen2moe's shared expert and its gate too; the fused FFN
    block keeps off them."""
    m = models[arch]
    tcfg = m["tcfg"]
    assert tcfg == jax_cfg_to_torch(m["jcfg"])
    check_ported(tcfg)
    assert tcfg.arch in TARGET_ARCHS and tcfg.arch in MOE_ARCHS
    qwen = arch == "qwen2moe"
    assert (tcfg.n_expert, tcfg.n_expert_used, tcfg.moe_softmax_all, tcfg.attn_bias) == (
        4, 2, qwen, qwen)
    assert tcfg.n_ff_exp == (256 if qwen else 0)
    layers = m["tt"]["layers"]
    want = {"attn_norm", "ffn_norm", "wqkv", "wo", "ffn_gate_inp", "w_gate_exps", "w_up_exps",
            "w_down_exps"}
    if qwen:
        want |= {"bqkv", "w_gate_shexp", "w_up_shexp", "w_down_shexp", "ffn_gate_inp_shexp"}
    assert set(layers) == want
    assert tuple(layers["w_gate_exps"].shape) == (2, 4, 256, 256)
    assert tuple(layers["w_down_exps"].shape) == (2, 4, 256, 256)
    assert tuple(layers["ffn_gate_inp"].shape) == (2, 4, 256)
    if qwen:
        assert tuple(layers["w_gate_shexp"].shape) == (2, 512, 256)
        assert tuple(layers["w_down_shexp"].shape) == (2, 256, 512)
        assert tuple(layers["ffn_gate_inp_shexp"].shape) == (2, 1, 256)
    check_layer_keys(layers, tcfg)
    assert not supports_ffn_block(layers, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_loaded_params_bit_equal(models, arch):
    """Every leaf bit-equal to the reference's `load_llama_params`: the
    dense experts, the router and the shared expert decoded to the
    reference's f32, the quantized attention as repacked."""
    m = models[arch]
    _same_tree(m["tt"], m["jt"])


@pytest.mark.parametrize("arch", ["llama", "qwen2moe"])
def test_dense_dtype_is_the_compute_dtype(pairs, models, arch):
    """`dense_dtype` bf16 (Engine's default compute dtype) stores each dense
    MoE weight as the f32 one rounded to bf16; the quantized weights are
    unchanged."""
    tt, _, _ = load_llama_params(pairs[arch][0], device="cpu", dense_dtype=torch.bfloat16)
    f32 = models[arch]["tt"]["layers"]
    for k, v in tt["layers"].items():
        if isinstance(v, torch.Tensor) and v.dim() >= 3:
            assert v.dtype == torch.bfloat16 and torch.equal(v, f32[k].to(torch.bfloat16)), k
    assert torch.equal(tt["layers"]["wqkv"].q, f32["wqkv"].q)


@pytest.mark.parametrize("arch", ["mixtral", "qwen2moe"])
def test_params_carried_across(models, arch):
    """The reference's loaded params, every leaf turned to numpy (the 3-D
    expert stacks, the router, the shared expert), come through
    `convert.params_from_numpy` bit-equal and give the same logits."""
    from eagle_tpu_torch.convert import params_from_numpy

    m = models[arch]
    carried = params_from_numpy(tree_to_numpy(m["jt"]), device="cpu")
    _same_tree(carried, m["jt"])
    toks, pos = _tokens(12), np.arange(12)[None]
    want = _forward(m["tt"], m["tcfg"], _cache(m["tcfg"]), toks, pos).logits
    assert torch.equal(_forward(carried, m["tcfg"], _cache(m["tcfg"]), toks, pos).logits, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    """A 24-token prefill through the tag-mask path, then 3 decoded tokens
    one at a time: logits and the hidden state at rtol 1e-4 in f32; the
    experts move the logits (the same file with its experts' down products
    zeroed does not give them)."""
    m = models[arch]
    cfg = m["tcfg"]
    n = 24
    toks = _tokens(n + 3)
    cache = _cache(cfg)
    pos = np.arange(n)[None]
    want = _jax_forward(m["jt"], m["jcfg"], _jcache(cfg), toks[:, :n], pos)
    got = _forward(m["tt"], cfg, cache, toks[:, :n], pos, prefill=True)
    _close(got.logits, want.logits)
    _close(got.hidden, want.hidden)
    jcache = want.kv
    for i in range(n, n + 3):
        p = np.asarray([[i]], np.int32)
        want_i = _jax_forward(m["jt"], m["jcfg"], jcache, toks[:, i:i + 1], p)
        jcache = want_i.kv
        _close(_forward(m["tt"], cfg, cache, toks[:, i:i + 1], p).logits, want_i.logits)
    zeroed = {**m["tt"], "layers": {**m["tt"]["layers"],
                                    "w_down_exps": torch.zeros_like(m["tt"]["layers"][
                                        "w_down_exps"])}}
    other = _forward(zeroed, cfg, _cache(cfg), toks[:, :n], pos, prefill=True).logits
    assert float((other - got.logits).abs().max()) > 1e-3 * float(got.logits.abs().max())


@pytest.fixture(scope="module")
def ref_engines(pairs):
    """The reference's engines, built once per module and (arch, kind)."""
    cache = {}

    def get(arch, kind):
        if (arch, kind) not in cache:
            cache[arch, kind] = _jax_engine(pairs[arch], kind)
        return cache[arch, kind]

    return get


@pytest.mark.parametrize("kind", ["plain", "chain"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_reference(pairs, ref_engines, arch, kind):
    """`Generator` and the EAGLE chain (a dense one-layer draft) through
    `Engine`: the reference's tokens (and the chain's stats) on the prompt's
    ids; the chain's tokens are the greedy ones."""
    jeng, eng = ref_engines(arch, kind), _port_engine(pairs[arch], kind)
    ids = eng.tokenizer.encode(PROMPT)
    assert ids == jeng.tokenizer.encode(PROMPT) and len(ids) >= 10
    if kind == "plain":
        want = jeng.engine.generate(ids, max_new_tokens=N_NEW, stop_at_eos=False)
        got = eng.engine.generate(ids, max_new_tokens=N_NEW, stop_at_eos=False)
    else:
        want, want_stats = jeng.engine.generate(ids, max_new_tokens=N_NEW, stop_at_eos=False)
        got, stats = eng.engine.generate(ids, max_new_tokens=N_NEW, stop_at_eos=False)
        assert stats == want_stats and stats["n_cycles"] > 0
        assert got == _greedy_ids(eng, ids, N_NEW)
    assert [int(t) for t in got] == [int(t) for t in want]


def _greedy_ids(eng, ids, n):
    gen = Generator(eng.params, eng.model_cfg, max_seq=MAX_SEQ, kv_dtype=torch.float32,
                    compute_dtype=torch.float32, eos_id=-1, device="cpu")
    return gen.generate(ids, max_new_tokens=n, stop_at_eos=False)


@pytest.mark.parametrize("kind", ["tree", "tree2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_engines_equal_greedy(pairs, monkeypatch, arch, kind):
    """A static tree (2, 2) and EAGLE-2 (2, 2, 4) through `Engine`: the
    port's greedy tokens with the random draft, and with an oracle draft
    (its logits boosted at the greedy continuation), which accepts every
    cycle's full depth, so each verify row at an accepted node (its own
    routing) decides a token."""
    eng_kw = {"tree": dict(tree_branching=(2, 2)), "tree2": dict(tree2=(2, 2, 4))}[kind]
    pair = pairs[arch]

    def engine():
        return Engine(EngineConfig(model_path=pair[0], draft_path=pair[1], max_seq=MAX_SEQ,
                                   compute_dtype=torch.float32, kv_dtype=torch.float32,
                                   device="cpu", **eng_kw))

    eng = engine()
    ids = eng.tokenizer.encode(PROMPT)
    n = 24  # the prompt's token and 23 = 1 + 11 cycles of 2 accepted
    greedy = _greedy_ids(eng, ids, n)
    toks, _ = eng.engine.generate(ids, max_new_tokens=n, stop_at_eos=False)
    assert toks == greedy
    mod = tree if kind == "tree" else tree2
    seq = torch.tensor(list(ids) + greedy, dtype=torch.int64)
    monkeypatch.setattr(mod, "eagle_forward", oracle(mod.eagle_forward, seq))
    toks, stats = engine().engine.generate(ids, max_new_tokens=n, stop_at_eos=False)
    assert toks == greedy and stats["mean_accept_len"] == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_batch2_engine_equals_single_sequences(pairs, arch):
    """`Engine(batch=2)`'s `ContinuousBatcher` (the chain, each row routed
    on its own): two prompts together, then a third in a freed slot, each
    slot's tokens those of the chain run on its prompt alone."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (5, 23, 12)]
    b = _port_engine(pairs[arch], "chain", batch=2).batcher
    got = []
    for group in (prompts[:2], prompts[2:]):  # a slot is reused: read it when done
        slots = [b.submit(p, max_new_tokens=10, stop_at_eos=False) for p in group]
        b.run_until_done(max_steps=200)
        got += [list(map(int, s.generated[:10])) for s in slots]
    single = _port_engine(pairs[arch], "chain").engine
    for p, toks in zip(prompts, got):
        want, _ = single.generate(p, max_new_tokens=10, stop_at_eos=False)
        assert toks == [int(t) for t in want]


# ---- a quantized position_embd ----------------------------------------------


def test_quantized_position_embd_matches_reference(tmp_path):
    """A gpt2 file whose learned positions are Q8_0 (the port refused it
    before it read block formats densely): `pos_embd` the reference's f32
    values, and the reference's logits at rtol 1e-4."""
    q8 = JGGMLType.Q8_0
    target, _ = write_tiny_gguf_pair(tmp_path, q8, q8, q8, q8, seed=23, arch="gpt2",
                                     target_metadata=ln_vocab("gpt2"), n_kv_heads=4, tied=True,
                                     out_scale=0.1, pos_type=q8)
    assert JReader(target).tensors["position_embd.weight"].ggml_type == q8
    tt, tcfg, _ = load_llama_params(target, device="cpu")
    jt, jcfg, _ = jax_load(target)
    assert tt["pos_embd"].dtype == torch.float32
    np.testing.assert_array_equal(_bits(tt["pos_embd"].numpy()), _bits(np.asarray(jt["pos_embd"])))
    toks, pos = _tokens(20), np.arange(20)[None]
    want = _jax_forward(jt, jcfg, _jcache(tcfg), toks, pos)
    _close(_forward(tt, tcfg, _cache(tcfg), toks, pos, prefill=True).logits, want.logits)


# ---- what stays refused -----------------------------------------------------

#: (arch of the tiny file whose config is changed, change)
REFUSED = {
    "sparsemixer (phimoe)": ("mixtral", dict(moe_sparsemixer=True)),
    "leading dense layers (deepseek v1)": ("mixtral", dict(n_dense_layers=1)),
    "experts on qwen2": ("qwen2moe", dict(arch="qwen2", moe_softmax_all=False)),
    "softmax over all on mixtral": ("mixtral", dict(moe_softmax_all=True)),
    "the top-k rule on qwen2moe": ("qwen2moe", dict(moe_softmax_all=False)),
    "more experts used than there are": ("llama", dict(n_expert_used=5)),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_configs_name_item_8(models, name):
    base, change = REFUSED[name]
    cfg = dataclasses.replace(models[base]["tcfg"], **change)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        check_ported(cfg)


@pytest.mark.parametrize("arch", ["qwen3moe", "olmoe", "granitemoe", "dbrx", "deepseek2",
                                  "grok", "phimoe", "deepseek", "arctic"])
def test_refused_moe_files_name_item_8(arch):
    """The other MoE architectures stay refused by architecture; their
    configs carried across from the reference are refused too."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        ModelConfig.from_gguf_metadata({"general.architecture": arch})
    cfg = ModelConfig(arch=arch, n_expert=8, n_expert_used=2)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        check_ported(cfg)


def test_arctic_residual_moe_refused(tmp_path):
    """A file with `ffn_norm_exps` (arctic's residual MoE beside its dense
    FFN) is refused at load, naming item 8, by the loader and `Engine`."""
    extra = {f"blk.{i}.ffn_norm_exps.weight": np.ones(256, np.float32) for i in range(2)}
    q8 = JGGMLType.Q8_0
    target, _ = write_tiny_gguf_pair(tmp_path, q8, q8, q8, q8, seed=31, arch="mixtral",
                                     target_metadata=spm_metadata(ENGINE_PROMPT),
                                     moe=MOE_FILES["mixtral"], extra=extra)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        load_llama_params(target, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        Engine(EngineConfig(model_path=target, device="cpu"))


@pytest.mark.parametrize("drop", ["w_up_exps", "w_up_shexp", "dense w_down"])
def test_partial_moe_layers_refused(models, drop):
    """A MoE layer without one of its experts' stacks, with part of a
    shared expert, or with a dense FFN beside the experts is refused."""
    layers = dict(models["qwen2moe"]["tt"]["layers"])
    if drop == "dense w_down":
        layers["w_down"] = layers["wo"]
    else:
        layers.pop(drop)
    with pytest.raises(NotImplementedError):
        check_layer_keys(layers, models["qwen2moe"]["tcfg"])
