"""The port's fused FFN block (eagle_tpu_torch/ops/ffn.py: the plain
versions of the `ffn_out_norm` and `gate_up_act` kernels, and `ffn_block`)
against the reference's Pallas block (`ffn_block_pallas`) run in interpret
mode, and the fused branch of the port's `_layer_step`.

Weights are the reference's synthetic QTensors carried across as numpy:
Q4_0 packed and unpacked (f32 scale and bias) and Q8_0 (unpacked codes in
[-127, 127], no bias), layer-stacked (L = 3) and single-layer (L = 1, the
EAGLE draft). Compute is f32. Tolerance: 1e-5 of max|want|, because the two
sum the same f32 products in another order (the Pallas kernel per K tile,
the port per group), and the norm's mean and rsqrt round differently.

The port runs any row count; the reference pads rows to a multiple of 8.
1 and 6 rows through the port are held against the reference's 8 padded
rows, sliced."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.gguf.constants import GGMLType
from eagle_tpu.models.synth import synth_qtensor
from eagle_tpu.ops.pallas_ffn import ffn_block_pallas
from eagle_tpu.ops.pallas_ffn import supports_ffn_block as jsupports
from eagle_tpu_torch import _build
from eagle_tpu_torch.convert import params_from_numpy
from eagle_tpu_torch.models.config import ModelConfig
from eagle_tpu_torch.models.eagle import eagle_forward
from eagle_tpu_torch.models.llama import _layer_step, llama_forward
from eagle_tpu_torch.models.synth import synth_llama_params
from eagle_tpu_torch.ops.ffn import ffn_block, ffn_out_norm, gate_up_act, supports_ffn_block
from eagle_tpu_torch.runtime.kvcache import KVCache, causal_mask_from_tags
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    background_cpu, qtensor_to_numpy,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

D, F, HD = 256, 512, 256  # model width, FFN width, attention width (4 heads of 64)
EPS = 1e-6
FORMS = {  # (qtype, packed)
    "q4_0_packed": (GGMLType.Q4_0, True),
    "q4_0_unpacked": (GGMLType.Q4_0, False),
    "q8_0": (GGMLType.Q8_0, False),
}


def _weights(rng, form, stack):
    qtype, packed = FORMS[form]
    ref = [synth_qtensor(rng, n, k, qtype, stack=stack, packed=packed)
           for n, k in ((D, HD), (2 * F, D), (D, F))]
    return ref, [params_from_numpy(qtensor_to_numpy(w), "cpu") for w in ref]


def _inputs(rng, rows):
    attn = rng.normal(0, 1.0, (rows, HD)).astype(np.float32)
    resid = rng.normal(0, 1.0, (rows, D)).astype(np.float32)
    nw = rng.uniform(0.5, 1.5, (D,)).astype(np.float32)
    return attn, resid, nw


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def _reference(ref_w, attn, resid, nw, layer, act, stages):
    return np.asarray(ffn_block_pallas(
        jnp.asarray(attn), jnp.asarray(resid), jnp.asarray(nw), *ref_w,
        jnp.asarray(layer, jnp.int32), rms_eps=EPS, act_fn=act, compute_dtype=jnp.float32,
        interpret=True, stages=stages))


@pytest.mark.parametrize("stack", [3, 1])
@pytest.mark.parametrize("stages", ["all", "wo"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_ffn_block_matches_pallas(form, act, stages, stack):
    rng = np.random.default_rng(0)
    ref_w, w = _weights(rng, form, stack)
    attn, resid, nw = _inputs(rng, 8)
    layer = stack - 1
    want = _reference(ref_w, attn, resid, nw, layer, act, stages)
    _build.reset_counts()
    got = ffn_block(torch.from_numpy(attn), torch.from_numpy(resid), torch.from_numpy(nw), *w,
                    layer, rms_eps=EPS, act_fn=act, compute_dtype=torch.float32, stages=stages)
    assert _build.plain_calls["ffn_out_norm"] == 1
    assert _build.plain_calls["gate_up_act"] == (1 if stages == "all" else 0)
    _close(got, want)


@pytest.mark.parametrize("rows", [1, 6])
@pytest.mark.parametrize("form", ["q4_0_packed", "q8_0"])
def test_unpadded_rows_match_padded_reference(form, rows):
    rng = np.random.default_rng(1)
    ref_w, w = _weights(rng, form, 3)
    attn, resid, nw = _inputs(rng, 8)
    attn[rows:] = 0.0
    resid[rows:] = 0.0
    want = _reference(ref_w, attn, resid, nw, 1, "silu", "all")[:rows]
    got = ffn_block(torch.from_numpy(attn[:rows]), torch.from_numpy(resid[:rows]),
                    torch.from_numpy(nw), *w, 1, rms_eps=EPS, compute_dtype=torch.float32)
    _close(got, want)


def test_stage_outputs_at_their_rounding_points():
    """bf16 compute: h and the activation product come out in bf16, x in
    f32, and x is exactly resid + the qmm product."""
    rng = np.random.default_rng(2)
    _, (wo, wgu, _) = _weights(rng, "q4_0_packed", 2)
    attn, resid, nw = (torch.from_numpy(a) for a in _inputs(rng, 3))
    x, h = ffn_out_norm(attn, resid, nw, wo, 1, EPS, torch.bfloat16)
    assert x.dtype == torch.float32 and h.dtype == torch.bfloat16
    from eagle_tpu_torch.ops.qmm import qmm_math

    assert torch.equal(x, qmm_math(attn, wo.layer(1), torch.bfloat16) + resid)
    a = gate_up_act(h, wgu, 1, "gelu", torch.bfloat16)
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == (3, F)


class _Cfg:
    act = "silu"


def test_supports_ffn_block_matches_reference():
    """The cases of tests/test_pallas_ffn.py::test_supports_gating, and coded
    scales, through both gates."""
    rng = np.random.default_rng(3)
    ref_w, w = _weights(rng, "q4_0_packed", 3)
    coded = synth_qtensor(rng, D, HD, GGMLType.Q4_K, stack=3, packed=True, coded=True)
    jbase = {"ffn_norm": jnp.ones((3, D)), "wo": ref_w[0], "w_gate_up": ref_w[1],
             "w_down": ref_w[2]}
    tbase = {"ffn_norm": torch.ones((3, D)), "wo": w[0], "w_gate_up": w[1], "w_down": w[2]}

    def variants(base, ones, dense_wo, coded_wo):
        nonorm = {k: v for k, v in base.items() if k != "ffn_norm"}
        split = {k: v for k, v in base.items() if k != "w_gate_up"}
        split["w_gate"] = base["w_gate_up"]
        return {
            "base": (base, "silu"), "gelu": (base, "gelu"), "relu": (base, "relu"),
            "post_attn_norm": ({**base, "post_attn_norm": ones((3, D))}, "silu"),
            "router": ({**base, "ffn_gate_inp": ones((3, D, 4))}, "silu"),
            "no_ffn_norm": (nonorm, "silu"), "split_gate": (split, "silu"),
            "dense_wo": ({**base, "wo": dense_wo}, "silu"),
            "coded_wo": ({**base, "wo": coded_wo}, "silu"),
        }

    jv = variants(jbase, jnp.ones, jnp.ones((3, D, D), jnp.bfloat16), coded)
    tv = variants(tbase, torch.ones, torch.ones((3, D, D), dtype=torch.bfloat16),
                  params_from_numpy(qtensor_to_numpy(coded), "cpu"))
    for name, (layers, act) in jv.items():
        cfg = _Cfg()
        cfg.act = act
        assert supports_ffn_block(tv[name][0], cfg) == jsupports(layers, cfg), name
    assert supports_ffn_block(tbase, _Cfg())


# ---- the fused branch of the layer step ----------------------------------

CFG = ModelConfig(vocab_size=512, n_embd=D, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
                  n_ff=F, rms_eps=EPS, rope_dim=64)


def _layers(rng, stack=2, attn_norm=True):
    qtype, packed = FORMS["q4_0_packed"]
    w = {name: params_from_numpy(qtensor_to_numpy(
        synth_qtensor(rng, n, k, qtype, stack=stack, packed=packed)), "cpu")
        for name, (n, k) in (("wqkv", (HD + 2 * 128, D)), ("wo", (D, HD)),
                             ("w_gate_up", (2 * F, D)), ("w_down", (D, F)))}
    w["ffn_norm"] = torch.from_numpy(rng.uniform(0.5, 1.5, (stack, D)).astype(np.float32))
    if attn_norm:
        w["attn_norm"] = torch.from_numpy(rng.uniform(0.5, 1.5, (stack, D)).astype(np.float32))
    return w


def _step(layers, t, fused, li=1):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (1, t, D)).astype(np.float32))
    kv = KVCache.create(2, 1, 128, 2, 64, torch.float32, device="cpu")
    pos = torch.arange(t, dtype=torch.int32)[None]
    kv.with_tags(pos, pos)
    mask = causal_mask_from_tags(kv.slot_pos, pos)
    inv_freq = torch.ones(32)
    return _layer_step(CFG, inv_freq, pos, pos, mask, torch.float32, x, layers, li, kv.k, kv.v,
                       fused_ffn=fused)


# (qmm plain calls, ffn_out_norm, gate_up_act) per layer step
_BRANCH = {"0": (4, 0, 0), "1": (2, 1, 1), "all": (2, 1, 1), "wo": (3, 1, 0)}


@pytest.mark.parametrize("mode", sorted(_BRANCH))
def test_layer_step_takes_the_branch(mode):
    layers = _layers(np.random.default_rng(5))
    want = _step(layers, 6, "0")
    _build.reset_counts()
    got = _step(layers, 6, mode)
    calls = _build.plain_calls
    assert (calls["qmm"], calls["ffn_out_norm"], calls["gate_up_act"]) == _BRANCH[mode]
    # f32 on the CPU: the fused block's plain versions do the unfused ops
    assert torch.equal(got, want)


def test_layer_step_unfused_beyond_64_rows_and_for_coded_weights():
    layers = _layers(np.random.default_rng(6))
    _build.reset_counts()
    _step(layers, 65, "1")
    assert _build.plain_calls["ffn_out_norm"] == 0 and _build.plain_calls["qmm"] == 4
    coded = synth_llama_params(CFG, seed=0, packed=True, coded=True, device="cpu")["layers"]
    _build.reset_counts()
    _step(coded, 6, "1")
    assert _build.plain_calls["ffn_out_norm"] == 0 and _build.plain_calls["qmm"] == 4


def test_forward_reads_the_switch(monkeypatch):
    """llama_forward and eagle_forward read EAGLE_TPU_FUSED_FFN; the draft's
    single-layer stack takes the fused branch too."""
    rng = np.random.default_rng(7)
    params = {"tok_embd": torch.from_numpy(rng.normal(0, 1, (512, D)).astype(np.float32)),
              "layers": _layers(rng), "output_norm": torch.ones(D),
              "output": params_from_numpy(qtensor_to_numpy(
                  synth_qtensor(rng, 512, D, GGMLType.Q4_0, packed=True)), "cpu")}
    draft = {"tok_embd": params["tok_embd"], "layers": _layers(rng, stack=1, attn_norm=False),
             "fc_w": params_from_numpy(qtensor_to_numpy(
                 synth_qtensor(rng, D, 2 * D, GGMLType.Q8_0)), "cpu"), "fc_b": torch.zeros(D)}
    toks = torch.tensor([[3, 5, 7]])
    pos = torch.arange(3, dtype=torch.int32)[None]
    outs = {}
    for mode in ("unset", "0", "1"):
        if mode == "unset":
            monkeypatch.delenv("EAGLE_TPU_FUSED_FFN", raising=False)
        else:
            monkeypatch.setenv("EAGLE_TPU_FUSED_FFN", mode)
        kv = KVCache.create(2, 1, 64, 2, 64, torch.float32, device="cpu")
        kv.with_tags(pos, pos)
        mask = causal_mask_from_tags(kv.slot_pos, pos)
        _build.reset_counts()
        fo = llama_forward(params, CFG, toks, pos, kv, pos, mask, compute_dtype=torch.float32)
        dkv = KVCache.create(1, 1, 64, 2, 64, torch.float32, device="cpu")
        dkv.with_tags(pos, pos)
        eo = eagle_forward(draft, params, CFG, toks, fo.hidden, pos, dkv, pos, mask,
                           compute_dtype=torch.float32)
        n = 3 if mode == "1" else 0  # two target layers + the draft layer
        assert _build.plain_calls["ffn_out_norm"] == n and _build.plain_calls["gate_up_act"] == n
        outs[mode] = (fo.logits, eo.logits)
    for mode in ("0", "1"):
        for a, b in zip(outs["unset"], outs[mode]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("rows", [1, 2, 6, 8, 9, 33, 64])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_matmul_pass_takes_qmm_plan(rng, form, rows):
    """The fused kernels' matmul pass picks its body from qmm's own route
    and, on the tensor-core bodies, qmm's plan for the same product (the
    gate/up pass paired): so at up to 8 rows in bf16, where qmm takes that
    body too, its sums are qmm's. At 1 bf16 row both passes take the 1-row
    body with qmm's `_gemv_plan` for the same product (the gate/up pass
    paired, [1, K] @ [K, 2F]); f32 keeps the SIMT body, and shapes the
    bodies cannot address (K % 64 != 0) fall to SIMT as well."""
    from eagle_tpu_torch.ops.ffn import _body
    from eagle_tpu_torch.ops.qmm import _gemv_plan, _mma_plan, _route, tc_form

    _, (wo, wgu, _) = _weights(rng, form, 2)
    for w, n, k, paired in ((wo, D, HD, False), (wgu, 2 * F, D, True),
                            (wo, 4096, 4096, False), (wgu, 22016, 4096, True)):
        f = tc_form(w)
        assert _body(rows, k, n, w, torch.float32, paired) == "simt"
        want = "gemv" if rows == 1 else "mma"
        assert _body(rows, k, n, w, torch.bfloat16, paired) == want
        assert _body(rows, k + 32, n, w, torch.bfloat16, paired) == "simt"
        if rows <= 8:  # qmm takes the same body for the same product
            assert _route(rows, k, n, torch.bfloat16, f) == want
        if rows == 1:  # n = 2F for the paired pass: a block's two halves are one tile
            p = _gemv_plan(k, n, w.group, f)
            assert p.splits * p.steps_per_split >= k // 64 and n % p.cols == 0
        if want == "mma":
            assert (_mma_plan(rows, k, n, w.group, f, paired=paired)
                    == _mma_plan(rows, k, n, w.group, f))
