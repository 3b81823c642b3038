"""The port's CUDA kernels against their plain PyTorch versions on the card,
over every branch at small shapes: qmm (packed / unpacked, coded / f32 /
bf16 scales, bias or none, G = 32, 16 and 8, the Q4_0, Q8_0 and IQ1_M
forms, each row-tile size of the SIMT body, the 1-row tensor-core body,
the small-row tensor-core body (2-8 rows) and the wgmma body, f32 and bf16
compute, 2-D and stacked, and the shapes only the SIMT body takes: N % 4
!= 0, N % 16 != 0, K % 64 != 0), qmm_i4 (2-D and stacked, f32 / bf16
scale and bias, bias or none, G = 32 and 16, f32 and bf16 compute, the
SIMT, small-row and wgmma bodies, ragged row tiles and K splits),
flash_decode and flash_prefill (f32 and bf16
caches, head_dim 64 and 128, GQA, key splits, s_limit, rows that see
nothing), ffn_out_norm and gate_up_act (packed / unpacked, f32 / bf16
scales, bias or none, G = 32, 16 and 8, SiLU / tanh-GELU, 1 to 64 rows,
L = 1 and stacked, f32 and bf16 compute; at 1 bf16 row gate_up_act bit for
bit against act(g) * u from qmm's sums), greedy tokens of a tiny model
on the card against the CPU, unfused and fused, and the engines' CUDA
graphs (graphed tokens equal to the eager path's bit for bit, greedy and
EAGLE at 1 and 3 cycles per dispatch, the tree engines at 1-3 with and
without an oracle draft; replays counted as launches; a new cache or
fused-FFN mode captures another graph), and flash_decode under the tree
engines' ancestor masks; sampled decoding (`-k sample`): `speculative_accept`'s
marginal, draws that advance across graph replays, and every sampled engine
graphed == eager from the same seed; the chat's kernels (`-k "offset or
feed or shift or embed"`): flash_prefill as a feed at an offset runs it, a
feed (`Generator._extend`) then graphed decode equal to eager, a context
shift under live step graphs (no capture after it), `Engine.embed` and
`rerank` on the card against the CPU; the stateful samplers and
constrained decoding (`-k "stateful or constrained or proposal"`): the
penalties, DRY and mirostat on the card against the CPU at V = 32,000,
each stateful sampler's graphed `Generator` == eager (a new state
recaptures), the graphed proposal == eager, the chain's constrained
tokens == the plain generator's; model-free speculation, infill and YaRN
(`-k "lookahead or lookup or infill or yarn"`): flash_decode under a
lookahead step's mask, the graphed lookahead and lookup engines == eager,
`_compact_kv` in a replay, infill's graphed logits steps against the CPU,
a YaRN config's frequencies and graphed decode; the Llama-3 path (`-k
llama3`): qmm on every route at the 8B path's new shapes, both flash
kernels at g = 4, a tied "nk" head with rope factors graphed == eager.

Marked `gpu`: they skip without a CUDA card. On the card, where JAX is not
installed, run them without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

Tolerances, relative to the largest |value| of the plain result: f32 1e-4
(the kernels sum in another order, and the tensor cores are not used in
f32); bf16 1e-2 (group sums of x, summed in another order, may round to
bf16 one ulp apart, and attention probabilities are rounded to bf16)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from eagle_tpu_torch import _build
from eagle_tpu_torch.models.config import ModelConfig
from eagle_tpu_torch.models.synth import synth_eagle_params, synth_llama_params, synth_qtensor
from eagle_tpu_torch.ops import flash_attention as fa
from eagle_tpu_torch.gguf.constants import GGMLType
from eagle_tpu_torch.ops.ffn import (ffn_out_norm, ffn_out_norm_plain, gate_up_act,
                                     gate_up_act_plain)
from eagle_tpu_torch.ops.qmm import (_route, qmm, qmm_i4, qmm_i4_plain, qmm_i4_stacked,
                                     qmm_plain, qmm_stacked, tc_form)
from eagle_tpu_torch.quant.qtensor import Q4_K, Q6_K, QTensor, pack_int4
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.kvcache import KVCache, causal_mask_from_tags
from eagle_tpu_torch.runtime.sampling import SamplerConfig
from eagle_tpu_torch.runtime import tree, tree2
from eagle_tpu_torch.runtime.speculative import EagleChainEngine

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
Q4_0, Q8_0 = int(GGMLType.Q4_0), int(GGMLType.Q8_0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert bool(torch.isfinite(got).all())
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} x {scale:.3e}"


def _packed_g16(gen, n, k, stack=None):
    """A packed weight with groups of 16 (no ggml type has it; the kernel
    takes it all the same)."""
    lead = () if stack is None else (stack,)
    q = torch.randint(-128, 128, lead + (k // 2, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    scale = torch.rand(lead + (k // 16, n), generator=gen, device="cuda") * 1e-3
    bias = torch.randn(lead + (k // 16, n), generator=gen, device="cuda") * 1e-3
    return QTensor(q=q, scale=scale, bias=bias, group=16, layout="kn", packed=True)


def _g8(gen, n, k, stack=None, packed=False):
    """A weight with groups of 8 and an f32 bias, as IQ1_M repacks (codes in
    {-1, 0, 1}), or packed random nibbles."""
    lead = () if stack is None else (stack,)
    if packed:
        q = torch.randint(-128, 128, lead + (k // 2, n), generator=gen, device="cuda",
                          dtype=torch.int8)
    else:
        q = torch.randint(-1, 2, lead + (k, n), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand(lead + (k // 8, n), generator=gen, device="cuda") * 1e-2
    bias = scale * 0.125 * (torch.randint(0, 2, scale.shape, generator=gen, device="cuda") * 2 - 1)
    return QTensor(q=q, scale=scale, bias=bias, group=8, ggml_type=int(GGMLType.IQ1_M),
                   layout="kn", packed=packed)


# name -> weight maker (gen, n, k, stack)
WEIGHTS = {
    "q4k_packed_coded": lambda g, n, k, s: synth_qtensor(g, n, k, Q4_K, s, packed=True, coded=True),
    "q4k_packed_f32": lambda g, n, k, s: synth_qtensor(g, n, k, Q4_K, s, packed=True),
    "q4k_packed_bf16": lambda g, n, k, s: synth_qtensor(g, n, k, Q4_K, s, packed=True,
                                                        scale_dtype=torch.bfloat16),
    "q4k_int8_coded": lambda g, n, k, s: synth_qtensor(g, n, k, Q4_K, s, coded=True),
    "q4k_int8_f32_nobias": lambda g, n, k, s: dataclasses.replace(
        synth_qtensor(g, n, k, Q4_K, s), bias=None),
    "q6k_int8_coded": lambda g, n, k, s: synth_qtensor(g, n, k, Q6_K, s, coded=True),
    "q6k_int8_bf16": lambda g, n, k, s: synth_qtensor(g, n, k, Q6_K, s,
                                                      scale_dtype=torch.bfloat16),
    "packed_g16_f32": lambda g, n, k, s: _packed_g16(g, n, k, s),
    # the GGUF path's forms: Q4_0 (packed nibbles, f32 scale, f32 bias -8d)
    # and Q8_0 (int8 codes over the whole [-128, 127], f32 scale, no bias)
    "q4_0_packed_f32": lambda g, n, k, s: synth_qtensor(g, n, k, Q4_0, s, packed=True),
    "q8_0_int8_f32": lambda g, n, k, s: synth_qtensor(g, n, k, Q8_0, s),
    # groups of 8: the IQ1_M form, and packed nibbles
    "iq1m_int8_g8": lambda g, n, k, s: _g8(g, n, k, s),
    "packed_g8_f32": lambda g, n, k, s: _g8(g, n, k, s, packed=True),
}


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 2, 3, 7, 9, 70])
@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_qmm_kernel_matches_plain(cuda, name, rows, compute):
    w = WEIGHTS[name](cuda, 256, 512, None)
    x = torch.randn((rows, 512), generator=cuda, device="cuda")
    _build.reset_counts()
    got = qmm(x, w, compute)
    route = _counter("qmm", _route(rows, 512, 256, compute, tc_form(w)))
    assert _build.launches[route] == 1 and sum(_build.launches.values()) == 1
    assert _build.plain_calls["qmm"] == 0
    _close(got, qmm_plain(x, w, compute), TOL[compute])


def _counter(kernel: str, route: str) -> str:
    """The launch counter of a route of qmm or qmm_i4."""
    return {"simt": kernel, "gemv": kernel + "_gemv", "mma": kernel + "_mma",
            "tc": kernel + "_tc"}[route]


@pytest.mark.parametrize("stack", [None, 3], ids=["2d", "stacked"])
@pytest.mark.parametrize("rows", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_qmm_small_row_route_matches_plain(cuda, name, rows, stack):
    """The small-row tensor-core body (bf16, 2-8 rows) on every form: N = 400
    leaves a ragged 256-column tile, K = 1280 runs 20 steps of 64 through
    the 3-stage ring, cut into K splits; layers 1 and 2 of a stack."""
    w = WEIGHTS[name](cuda, 400, 1280, stack)
    x = torch.randn((rows, 1280), generator=cuda, device="cuda")
    for layer in ((None,) if stack is None else (1, 2)):
        _build.reset_counts()
        if stack is None:
            got, want = qmm(x, w), qmm_plain(x, w)
        else:
            got, want = qmm_stacked(x, w, layer), qmm_plain(x, w.layer(layer))
        assert _build.launches["qmm_mma"] == 1 and sum(_build.launches.values()) == 1
        _close(got, want, TOL[torch.bfloat16])


@pytest.mark.parametrize("split", [True, False], ids=["ksplit", "nosplit"])
@pytest.mark.parametrize("stack", [None, 3], ids=["2d", "stacked"])
@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_qmm_gemv_route_matches_plain(cuda, name, stack, split):
    """The 1-row tensor-core body (bf16, one row) on every form: N = 400
    leaves a ragged 256-column tile; K = 1280 runs in K splits, K = 64 (256
    for coded weights) in one; layers 1 and 2 of a stack. One launch of
    qmm_gemv per call, no plain version."""
    from eagle_tpu_torch.ops.qmm import _gemv_plan

    probe = WEIGHTS[name](cuda, 16, 256, None)
    n, k = (400, 1280) if split else (272, 256 if probe.coded else 64)
    w = WEIGHTS[name](cuda, n, k, stack)
    assert (_gemv_plan(k, n, w.group, tc_form(w)).splits > 1) == split
    x = torch.randn((1, k), generator=cuda, device="cuda")
    for layer in ((None,) if stack is None else (1, 2)):
        _build.reset_counts()
        if stack is None:
            got, want = qmm(x, w), qmm_plain(x, w)
        else:
            got, want = qmm_stacked(x, w, layer), qmm_plain(x, w.layer(layer))
        assert _build.launches["qmm_gemv"] == 1 and sum(_build.launches.values()) == 1
        assert _build.plain_calls["qmm"] == 1  # the reference call above only
        _close(got, want, TOL[torch.bfloat16])


# (K, N) the tensor-core bodies cannot address: N % 4 != 0, N % 16 != 0 with
# N % 4 == 0, K % 64 != 0 (not for coded weights, whose K is a multiple of 256)
RAGGED = [(1024, 250), (1024, 260), (1056, 256)]


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 6, 37])
@pytest.mark.parametrize("name,k,n", [(name, k, n) for name in sorted(WEIGHTS) for k, n in RAGGED
                                      if "coded" not in name or k % 256 == 0])
def test_qmm_ragged_shapes(cuda, name, k, n, rows, compute):
    """qmm answers at the shapes the reference serves with a whole-N tile, on
    the route `_route` picks from the shape (the SIMT body, masked at the
    last column where N % 4 != 0), 2-D and at layer 2 of a stack."""
    for stack in (None, 3):
        w = WEIGHTS[name](cuda, n, k, stack)
        x = torch.randn((rows, k), generator=cuda, device="cuda")
        _build.reset_counts()
        got = qmm(x, w, compute) if stack is None else qmm_stacked(x, w, 2, compute)
        route = _counter("qmm", _route(rows, k, n, compute, tc_form(w)))
        assert route == "qmm" and _build.launches["qmm"] == 1
        assert sum(_build.launches.values()) == 1
        _close(got, qmm_plain(x, w if stack is None else w.layer(2), compute), TOL[compute])


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 6, 37])
@pytest.mark.parametrize("k,n", RAGGED)
@pytest.mark.parametrize("group", [16, 32])
def test_qmm_i4_ragged_shapes(cuda, group, k, n, rows, compute):
    for stack in (None, 3):
        w = _int4_weight(cuda, n, k, group, stack, torch.bfloat16, True)
        x = torch.randn((rows, k), generator=cuda, device="cuda")
        _build.reset_counts()
        got = qmm_i4(x, w, compute) if stack is None else qmm_i4_stacked(x, w, 2, compute)
        assert _route(rows, k, n, compute, tc_form(w)) == "simt"
        assert _build.launches["qmm_i4"] == 1 and sum(_build.launches.values()) == 1
        want = qmm_i4_plain(x, w if stack is None else w.layer(2), compute)
        _close(got, want, TOL[compute])


TC_ROWS = [9, 37, 64, 65, 128, 300]  # both row tiles (64, 128) and their ragged edges


@pytest.mark.parametrize("rows", TC_ROWS)
@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_qmm_tensor_core_route_matches_plain(cuda, name, rows):
    """The tensor-core body on every form: N = 400 leaves a ragged 256-column
    tile, K = 1280 runs 20 steps of 64 through the 3-4 stage ring, cut into
    K splits of 256 at these small tile counts; bias or none takes the
    trailing side-product steps or not."""
    w = WEIGHTS[name](cuda, 400, 1280, None)
    x = torch.randn((rows, 1280), generator=cuda, device="cuda")
    _build.reset_counts()
    got = qmm(x, w)
    assert _build.launches["qmm_tc"] == 1 and _build.launches["qmm"] == 0
    assert _build.plain_calls["qmm"] == 0
    _close(got, qmm_plain(x, w), TOL[torch.bfloat16])


@pytest.mark.parametrize("rows", [37, 300])
@pytest.mark.parametrize("name", ["q4k_packed_coded", "q6k_int8_coded", "iq1m_int8_g8",
                                  "q4_0_packed_f32", "q8_0_int8_f32", "packed_g16_f32"])
def test_qmm_tensor_core_route_stacked(cuda, name, rows):
    """The layer offset of a stack (layers 1 and 2 of 3) on the tensor-core
    body, one K split and several (K = 2048: 8 splits at 37 rows, 1 at 300
    with N = 4096)."""
    for n, k in ((512, 2048), (4096, 2048)):
        w = WEIGHTS[name](cuda, n, k, 3)
        x = torch.randn((rows, k), generator=cuda, device="cuda")
        for layer in (1, 2):
            _build.reset_counts()
            got = qmm_stacked(x, w, layer)
            assert _build.launches["qmm_tc"] == 1
            _close(got, qmm_plain(x, w.layer(layer)), TOL[torch.bfloat16])


def test_qmm_tensor_core_route_refuses_what_it_cannot_take(cuda):
    """The tensor-core bodies raise, and never fall back to the SIMT body,
    on an operand off 16 bytes (a layer whose base is misaligned); a shape
    they do not take (K % 64, N % 16) is routed to the SIMT body from the
    shape, before any launch. The SIMT body (f32 compute) takes the
    misaligned layer."""
    x = torch.randn((37, 512), generator=cuda, device="cuda")
    w = WEIGHTS["q4k_packed_coded"](cuda, 256, 512, 2)
    store = torch.zeros(w.q.numel() + 8, dtype=torch.int8, device="cuda")
    q_off = store[8:].view(w.q.shape)  # contiguous, 8 bytes off a 16-byte boundary
    q_off.copy_(w.q)
    bad = dataclasses.replace(w, q=q_off)
    _build.reset_counts()
    for rows in (37, 6, 1):  # the wgmma body, the small-row body, the 1-row body
        with pytest.raises(ValueError, match="aligned"):
            qmm_stacked(x[:rows], bad, 1)
    assert sum(_build.launches.values()) == 0
    _close(qmm_stacked(x[:1], bad, 1, torch.float32),
           qmm_plain(x[:1], w.layer(1), torch.float32), TOL[torch.float32])
    assert _build.launches["qmm"] == 1 and sum(_build.launches.values()) == 1
    for n, k in ((256, 288), (264, 512)):  # K % 64, N % 16
        wk = WEIGHTS["q4_0_packed_f32"](cuda, n, k, None)
        xk = torch.randn((37, k), generator=cuda, device="cuda")
        _build.reset_counts()
        _close(qmm(xk, wk), qmm_plain(xk, wk), TOL[torch.bfloat16])
        assert _build.launches["qmm"] == 1 and sum(_build.launches.values()) == 1
    wi = _int4_weight(cuda, 264, 512, 32, None, torch.bfloat16, True)
    _build.reset_counts()
    _close(qmm_i4(x, wi), qmm_i4_plain(x, wi), TOL[torch.bfloat16])
    assert _build.launches["qmm_i4"] == 1 and sum(_build.launches.values()) == 1


@pytest.mark.parametrize("rows", [1, 6, 70])
@pytest.mark.parametrize("name", ["q4k_packed_coded", "q6k_int8_coded", "iq1m_int8_g8"])
def test_qmm_stacked_kernel_matches_plain(cuda, name, rows):
    w = WEIGHTS[name](cuda, 512, 1024, 3)
    x = torch.randn((rows, 1024), generator=cuda, device="cuda")
    for layer in (0, 2):
        _close(qmm_stacked(x, w, layer), qmm_plain(x, w.layer(layer)), TOL[torch.bfloat16])


def _int4_weight(gen, n, k, group, stack, scale_dtype, bias):
    lead = () if stack is None else (stack,)
    q = torch.randint(-8, 8, lead + (k, n), generator=gen, device="cuda", dtype=torch.int8)
    scale = (torch.rand(lead + (k // group, n), generator=gen, device="cuda") * 1e-2)
    b = torch.randn(lead + (k // group, n), generator=gen, device="cuda") * 1e-3
    return QTensor(q=pack_int4(q, group), scale=scale.to(scale_dtype),
                   bias=b.to(scale_dtype) if bias else None, group=group, layout="kn",
                   int4=True)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16], ids=["s_f32", "s_bf16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("rows", [1, 2, 5, 8, 37, 70])
@pytest.mark.parametrize("stack", [None, 3], ids=["2d", "stacked"])
def test_qmm_i4_kernel_matches_plain(cuda, stack, rows, group, bias, scale_dtype, compute):
    """Every branch of qmm_i4: each row tile of the SIMT body in f32 (1, 2,
    4, 8 rows and ragged ones), the small-row body at 2-8 bf16 rows and the
    wgmma body above, K splits (small N at K = 1024), both entries."""
    w = _int4_weight(cuda, 256, 1024, group, stack, scale_dtype, bias)
    x = torch.randn((rows, 1024), generator=cuda, device="cuda")
    for layer in ((None,) if stack is None else (0, 2)):
        _build.reset_counts()
        if stack is None:
            got, want = qmm_i4(x, w, compute), qmm_i4_plain(x, w, compute)
        else:
            got = qmm_i4_stacked(x, w, layer, compute)
            want = qmm_i4_plain(x, w.layer(layer), compute)
        route = _counter("qmm_i4", _route(rows, 1024, 256, compute, tc_form(w)))
        assert _build.launches[route] == 1 and sum(_build.launches.values()) == 1
        assert _build.plain_calls["qmm_i4"] == 1
        _close(got, want, TOL[compute])


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16], ids=["s_f32", "s_bf16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("rows", TC_ROWS)
@pytest.mark.parametrize("stack", [None, 3], ids=["2d", "stacked"])
def test_qmm_i4_tensor_core_route_matches_plain(cuda, stack, rows, group, bias, scale_dtype):
    """qmm_i4's tensor-core body at its rounding points: N = 400 (a ragged
    256-column tile), K = 1280 (20 ring steps, K splits), both row tiles,
    both entries (layers 0 and 2 of a stack)."""
    w = _int4_weight(cuda, 400, 1280, group, stack, scale_dtype, bias)
    x = torch.randn((rows, 1280), generator=cuda, device="cuda")
    for layer in ((None,) if stack is None else (0, 2)):
        _build.reset_counts()
        if stack is None:
            got, want = qmm_i4(x, w), qmm_i4_plain(x, w)
        else:
            got, want = qmm_i4_stacked(x, w, layer), qmm_i4_plain(x, w.layer(layer))
        assert _build.launches["qmm_i4_tc"] == 1 and _build.launches["qmm_i4"] == 0
        _close(got, want, TOL[torch.bfloat16])


@pytest.mark.parametrize("split", [True, False], ids=["ksplit", "nosplit"])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16], ids=["s_f32", "s_bf16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("rows", [2, 3, 6, 8])
@pytest.mark.parametrize("stack", [None, 3], ids=["2d", "stacked"])
def test_qmm_i4_small_row_route_matches_plain(cuda, stack, rows, group, bias, scale_dtype,
                                              split):
    """qmm_i4's small-row body (bf16, 2-8 rows) at qmm_i4's rounding points:
    N = 400 leaves a ragged 256-column tile and K = 1280 runs 20 steps in K
    splits; N = 272, K = 64 one step in one split; both entries (layers 1
    and 2 of a stack). One launch of qmm_i4_mma per call, no plain
    version."""
    from eagle_tpu_torch.ops.qmm import _mma_plan

    n, k = (400, 1280) if split else (272, 64)
    w = _int4_weight(cuda, n, k, group, stack, scale_dtype, bias)
    assert (_mma_plan(rows, k, n, group, tc_form(w)).splits > 1) == split
    x = torch.randn((rows, k), generator=cuda, device="cuda")
    for layer in ((None,) if stack is None else (1, 2)):
        _build.reset_counts()
        got = qmm_i4(x, w) if stack is None else qmm_i4_stacked(x, w, layer)
        assert _build.launches["qmm_i4_mma"] == 1 and sum(_build.launches.values()) == 1
        assert _build.plain_calls["qmm_i4"] == 0
        want = qmm_i4_plain(x, w if stack is None else w.layer(layer))
        _close(got, want, TOL[torch.bfloat16])


def test_qmm_i4_refuses_what_it_cannot_take(cuda):
    x = torch.randn((2, 256), generator=cuda, device="cuda")
    w = _int4_weight(cuda, 64, 256, 32, None, torch.bfloat16, True)
    bad = {
        "group 8": dataclasses.replace(w, group=8, scale=torch.zeros((32, 64), device="cuda"),
                                       bias=None),
        "not int4": dataclasses.replace(w, int4=False, packed=True),
        "int8 scale": dataclasses.replace(w, scale=w.scale.to(torch.int8)),
        "stacked into the 2-D entry": dataclasses.replace(w, q=w.q[None], scale=w.scale[None],
                                                          bias=w.bias[None]),
    }
    for what, bw in bad.items():
        with pytest.raises(ValueError):
            qmm_i4(x, bw)
    with pytest.raises(ValueError):
        qmm(x, w)  # qmm does not read int4 weights


def _cache(gen, dtype, d, h_kv, s=256, n_layers=2):
    shape = (n_layers, 2, h_kv, s, d)
    return (torch.randn(shape, generator=gen, device="cuda").to(dtype),
            torch.randn(shape, generator=gen, device="cuda").to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,h,h_kv,s_limit", [(1, 4, 4, None), (6, 8, 2, None), (6, 8, 2, 96),
                                              (40, 4, 2, 128)])
def test_flash_decode_matches_plain(cuda, dtype, d, t, h, h_kv, s_limit):
    k_cache, v_cache = _cache(cuda, dtype, d, h_kv)
    lim = s_limit or k_cache.shape[3]
    tags = torch.full((2, k_cache.shape[3]), -1, dtype=torch.int32, device="cuda")
    tags[:, : 60 + t] = torch.arange(60 + t, dtype=torch.int32, device="cuda")
    tags[:, 10:14] = -1  # rolled-back holes
    pos = (60 + torch.arange(t, dtype=torch.int32, device="cuda"))[None].repeat(2, 1)
    mask = causal_mask_from_tags(tags[:, :lim], pos)
    mask[1, 0] = False  # a row that sees nothing: the uniform average
    q = torch.randn((2, t, h, d), generator=cuda, device="cuda")
    _build.reset_counts()
    got = fa.flash_attention_cached(q, k_cache, v_cache, mask, 1, s_limit=s_limit)
    assert _build.launches["flash_decode"] == 1 and _build.plain_calls["flash_decode"] == 0
    want = fa.flash_attention_cached_plain(q, k_cache, v_cache, mask, 1, s_limit=s_limit)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,h_kv", [(4, 4), (8, 2)])
def test_flash_prefill_matches_plain(cuda, dtype, d, h, h_kv):
    k_cache, v_cache = _cache(cuda, dtype, d, h_kv)
    t, n = 64, 45  # a padded prompt bucket
    tags = torch.full((2, k_cache.shape[3]), -1, dtype=torch.int32, device="cuda")
    tags[:, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    q_pos = torch.arange(t, dtype=torch.int32, device="cuda")[None].repeat(2, 1)
    q_pos[:, n + 3:] = -1  # padded rows that see nothing
    q = torch.randn((2, t, h, d), generator=cuda, device="cuda")
    _build.reset_counts()
    got = fa.flash_attention_prefill(q, k_cache, v_cache, q_pos, tags, 0, s_limit=128)
    assert _build.launches["flash_prefill"] == 1 and _build.plain_calls["flash_prefill"] == 0
    want = fa.flash_attention_prefill_plain(q, k_cache, v_cache, q_pos, tags, 0, s_limit=128)
    _close(got, want, TOL[dtype])


# (T*g, g) of the tensor-core body's cases: one 16-row tile (1, 6), a 16-row
# edge (24), 64-row blocks (64), a 64-row edge (80), a ragged 128-row block
# (120) and the prompt bucket (512)
TC_ROWS = [(tg, g) for tg in (1, 6, 24, 64, 80, 120, 512) for g in (1, 2, 4) if tg % g == 0]


def _tc_case(gen, tg, g, d, s_limit):
    """A bf16 cache of 2 kv heads and 384 slots, 250 of them tagged with
    rolled-back holes, and T = tg / g query positions spread over them."""
    k_cache, v_cache = _cache(gen, torch.bfloat16, d, 2, s=384)
    lim = s_limit or k_cache.shape[3]
    t, n = tg // g, min(250, lim)
    tags = torch.full((2, k_cache.shape[3]), -1, dtype=torch.int32, device="cuda")
    tags[:, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    tags[:, 10:14] = -1
    pos = (torch.arange(t, device="cuda") * n // t + (n - 1 if t == 1 else 0)).to(torch.int32)
    q = torch.randn((2, t, 2 * g, d), generator=gen, device="cuda")
    return k_cache, v_cache, lim, tags, pos[None].repeat(2, 1).contiguous(), q


def _uniform_rows(got, v_cache, layer, lim, g, b, t):
    """Row (b, t) of `got` is the uniform average of V over [0, lim)."""
    uniform = v_cache[layer, b, :, :lim].float().mean(dim=1).repeat_interleave(g, dim=0)
    _close(got[b, t], uniform, 1e-2)


@pytest.mark.parametrize("s_limit", [96, 300, None], ids=["s96", "s300", "full"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tg,g", TC_ROWS)
def test_flash_decode_tensor_core_body(cuda, tg, g, d, s_limit):
    """The bf16 body at every row-block size, ragged key ends, GQA, key
    splits, holed tags and a fully masked row inside a row tile."""
    k_cache, v_cache, lim, tags, pos, q = _tc_case(cuda, tg, g, d, s_limit)
    t = q.shape[1]
    mask = causal_mask_from_tags(tags[:, :lim], pos)
    mask[1, t // 2] = False  # a row that sees nothing: the uniform average
    plan = fa._plan(tg, lim, d, torch.bfloat16, 2 * 2, False)
    assert plan.body == "mma" and plan.splits > 1  # 4 kv-head units: always split
    _build.reset_counts()
    got = fa.flash_attention_cached(q, k_cache, v_cache, mask, 1, s_limit=s_limit)
    assert _build.launches["flash_decode"] == 1 and _build.plain_calls["flash_decode"] == 0
    _close(got, fa.flash_attention_cached_plain(q, k_cache, v_cache, mask, 1, s_limit=s_limit),
           TOL[torch.bfloat16])
    _uniform_rows(got, v_cache, 1, lim, g, 1, t // 2)


@pytest.mark.parametrize("s_limit", [96, 300, None], ids=["s96", "s300", "full"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tg,g", TC_ROWS)
def test_flash_prefill_tensor_core_body(cuda, tg, g, d, s_limit):
    """flash_prefill's bf16 body over the same cases: the tag mask built in
    registers, q_pos = -1 rows inside a tile and at the end."""
    k_cache, v_cache, lim, tags, q_pos, q = _tc_case(cuda, tg, g, d, s_limit)
    t = q.shape[1]
    q_pos[1, t // 2] = -1
    q_pos[0, -1] = -1
    _build.reset_counts()
    got = fa.flash_attention_prefill(q, k_cache, v_cache, q_pos, tags, 0, s_limit=s_limit)
    assert _build.launches["flash_prefill"] == 1 and _build.plain_calls["flash_prefill"] == 0
    want = fa.flash_attention_prefill_plain(q, k_cache, v_cache, q_pos, tags, 0, s_limit=s_limit)
    _close(got, want, TOL[torch.bfloat16])
    _uniform_rows(got, v_cache, 0, lim, g, 1, t // 2)
    _uniform_rows(got, v_cache, 0, lim, g, 0, t - 1)


def test_tiny_greedy_tokens_card_equal_cpu(cuda):
    """Greedy tokens of a 2-layer model through the kernels on the card equal
    the plain path's on the CPU (same weights, f32 compute and cache)."""
    cfg = ModelConfig(vocab_size=512, n_embd=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      head_dim=64, n_ff=512, rms_eps=1e-6, rope_dim=64)
    params = synth_llama_params(cfg, seed=3, packed=True, coded=True, device="cuda")

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, QTensor):
            return dataclasses.replace(tree, **{k: None if v is None else v.cpu()
                                                for k, v in tree.tensors().items()})
        return tree.cpu()

    prompt = np.random.default_rng(0).integers(0, 512, size=21).tolist()
    toks = []
    for dev, p in (("cuda", params), ("cpu", to_cpu(params))):
        gen = Generator(p, cfg, max_seq=256, kv_dtype=torch.float32,
                        compute_dtype=torch.float32, eos_id=-1, device=dev)
        toks.append(gen.generate(prompt, max_new_tokens=24, stop_at_eos=False, chunk=8))
    assert toks[0] == toks[1]


# weight forms the fused FFN kernels take (materialized scales only)
FFN_FORMS = {
    "q4_0_packed_f32": lambda g, n, k, s: synth_qtensor(g, n, k, Q4_0, s, packed=True),
    "q4_0_packed_bf16": lambda g, n, k, s: synth_qtensor(g, n, k, Q4_0, s, packed=True,
                                                         scale_dtype=torch.bfloat16),
    "q4_0_int8_f32": lambda g, n, k, s: synth_qtensor(g, n, k, Q4_0, s),
    "q8_0_int8_f32": lambda g, n, k, s: synth_qtensor(g, n, k, Q8_0, s),
    "q6k_int8_bf16_g16": lambda g, n, k, s: synth_qtensor(g, n, k, Q6_K, s,
                                                          scale_dtype=torch.bfloat16),
    "iq1m_int8_f32_g8": lambda g, n, k, s: _g8(g, n, k, s),
}
FFN_ROWS = [1, 2, 6, 9, 33, 64]


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("stack", [1, 3])
@pytest.mark.parametrize("rows", FFN_ROWS)
@pytest.mark.parametrize("form", sorted(FFN_FORMS))
def test_ffn_out_norm_matches_plain(cuda, form, rows, stack, compute):
    wo = FFN_FORMS[form](cuda, 256, 384, stack)
    attn = torch.randn((rows, 384), generator=cuda, device="cuda")
    resid = torch.randn((rows, 256), generator=cuda, device="cuda")
    nw = torch.rand((256,), generator=cuda, device="cuda") + 0.5
    layer = stack - 1
    _build.reset_counts()
    x, h = ffn_out_norm(attn, resid, nw, wo, layer, 1e-6, compute)
    assert _build.launches["ffn_out_norm"] == 1 and _build.plain_calls["ffn_out_norm"] == 0
    xw, hw = ffn_out_norm_plain(attn, resid, nw, wo.layer(layer), 1e-6, compute)
    assert x.dtype == torch.float32 and h.dtype == compute
    _close(x, xw, TOL[compute])
    _close(h, hw, TOL[compute])
    if rows <= 8 or compute == torch.float32:
        # at these rows the matmul pass takes qmm's own body and plan (SIMT in
        # f32, the gemv body at 1 bf16 row, mma.sync at 2-8): the same sums,
        # bit for bit
        assert torch.equal(x, qmm_stacked(attn, wo, layer, compute) + resid)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("stack", [1, 3])
@pytest.mark.parametrize("rows", FFN_ROWS)
@pytest.mark.parametrize("form", sorted(FFN_FORMS))
def test_gate_up_act_matches_plain(cuda, form, rows, stack, act, compute):
    w = FFN_FORMS[form](cuda, 2 * 384, 256, stack)
    h = torch.randn((rows, 256), generator=cuda, device="cuda").to(compute)
    layer = stack - 1
    _build.reset_counts()
    got = gate_up_act(h, w, layer, act, compute)
    assert _build.launches["gate_up_act"] == 1 and _build.plain_calls["gate_up_act"] == 0
    assert got.dtype == compute and tuple(got.shape) == (rows, 384)
    _close(got, gate_up_act_plain(h, w.layer(layer), act, compute), TOL[compute])


@pytest.mark.parametrize("split", [True, False], ids=["ksplit", "nosplit"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("form", sorted(FFN_FORMS))
def test_gate_up_act_one_row_equals_unfused_sums(cuda, form, act, split):
    """At 1 bf16 row gate_up_act's matmul pass is the paired 1-row body with
    qmm's plan for the same [1, K] @ [K, 2F] product, so g and u are the
    unfused path's sums, qmm_stacked's on the fused weight split at F, to the
    bit: the output equals round_bf16(act(g) * u) built from them, bit for
    bit (the epilogue's expf / tanhf and PyTorch's SiLU and tanh-GELU are
    the same f32 operations in the same order). K = 1280 runs in K splits,
    K = 64 in one; layer 2 of a stack of 3."""
    from eagle_tpu_torch.ops.ffn import _act, _body
    from eagle_tpu_torch.ops.qmm import _gemv_plan

    k, f = (1280, 384) if split else (64, 384)
    w = FFN_FORMS[form](cuda, 2 * f, k, 3)
    assert _body(1, k, 2 * f, w, torch.bfloat16, paired=True) == "gemv"
    assert (_gemv_plan(k, 2 * f, w.group, tc_form(w)).splits > 1) == split
    h = torch.randn((1, k), generator=cuda, device="cuda").to(torch.bfloat16)
    _build.reset_counts()
    got = gate_up_act(h, w, 2, act, torch.bfloat16)
    assert _build.launches["gate_up_act"] == 1 and sum(_build.launches.values()) == 1
    g, u = qmm_stacked(h, w, 2).chunk(2, dim=-1)
    assert _build.launches["qmm_gemv"] == 1 and _build.plain_calls["gate_up_act"] == 0
    want = (_act(act, g) * u).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, f)
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())
    _close(got, gate_up_act_plain(h, w.layer(2), act, torch.bfloat16), TOL[torch.bfloat16])


def test_tiny_greedy_fused_equals_unfused(cuda, monkeypatch):
    """A 2-layer Q4_0-form model on the card: fused-FFN greedy tokens equal
    the unfused ones (f32 compute), and the fused kernels ran."""
    cfg = ModelConfig(vocab_size=512, n_embd=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      head_dim=64, n_ff=512, rms_eps=1e-6, rope_dim=64)
    params = synth_llama_params(cfg, qtype=Q4_0, seed=3, packed=True, device="cuda")
    prompt = np.random.default_rng(0).integers(0, 512, size=21).tolist()
    toks = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("EAGLE_TPU_FUSED_FFN", mode)
        _build.reset_counts()
        gen = Generator(params, cfg, max_seq=256, kv_dtype=torch.float32,
                        compute_dtype=torch.float32, eos_id=-1, device="cuda")
        toks[mode] = gen.generate(prompt, max_new_tokens=24, stop_at_eos=False, chunk=8)
        assert (_build.launches["gate_up_act"] > 0) == (mode == "1")
    assert toks["0"] == toks["1"]


# ---- one dispatch per decode step / group of EAGLE cycles (runtime/graphs.py)

TINY_CFG = ModelConfig(vocab_size=512, n_embd=256, n_layers=2, n_heads=4, n_kv_heads=2,
                       head_dim=64, n_ff=512, rms_eps=1e-6, rope_dim=64)


def _tiny_bf16(qtype=Q4_K, coded=True):
    """A 2-layer target and its draft on the card, bf16 compute and cache:
    the decode and draft products take the 1-row body, verify the small-row
    one."""
    tp = synth_llama_params(TINY_CFG, qtype=qtype, seed=3, packed=True, coded=coded,
                            device="cuda")
    dp = synth_eagle_params(TINY_CFG, qtype=qtype, seed=4, packed=True, device="cuda")
    return tp, dp


def _bf16_gen(params, graphed):
    return Generator(params, TINY_CFG, max_seq=256, kv_dtype=torch.bfloat16,
                     compute_dtype=torch.bfloat16, eos_id=-1, device="cuda",
                     cuda_graphs=graphed)


PROMPT = np.random.default_rng(0).integers(0, 512, size=21).tolist()


def test_graphed_generator_equals_eager(cuda):
    """Graphed greedy tokens equal the eager path's bit for bit, and
    `_build.launches` after N replays is N times one eager step's."""
    tp, _ = _tiny_bf16()
    eager, graphed = _bf16_gen(tp, False), _bf16_gen(tp, True)
    want = eager.generate(PROMPT, max_new_tokens=40, stop_at_eos=False, chunk=8)
    got = graphed.generate(PROMPT, max_new_tokens=40, stop_at_eos=False, chunk=8)
    assert got == want
    assert graphed.graphs.captures == graphed.graphs.eager == 1  # one bucket (128)
    assert graphed.graphs.replays == 38 and eager.graphs.eager == 39
    scfg = SamplerConfig(greedy=True)
    tok = torch.tensor([want[-1]], dtype=torch.int32, device="cuda")
    pos = len(PROMPT) + 39
    _build.reset_counts()
    eager._decode_chunk(tok, pos, scfg, 1, kv_limit=128)
    one = {k: v for k, v in _build.launches.items() if v}
    assert one["qmm_gemv"] == 2 * 4 + 1 and one["flash_decode"] == 2
    _build.reset_counts()
    toks = graphed._decode_chunk(tok, pos, scfg, 7, kv_limit=128)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {k: 7 * v for k, v in one.items()}
    assert graphed.graphs.eager == 1 and graphed.graphs.replays == 38 + 7
    assert sum(_build.plain_calls.values()) == 0
    assert toks[0, 0].item() == eager._decode_chunk(tok, pos, scfg, 1, kv_limit=128)[0, 0].item()


@pytest.mark.parametrize("cycles", [1, 3])
def test_graphed_chain_engine_equals_eager(cuda, cycles):
    """Graphed EAGLE tokens and stats at C cycles per dispatch equal the
    eager C = 1 run's; after the warm-up no cycle runs eagerly, and at C = 1
    a graphed run counts the eager run's launches."""
    tp, dp = _tiny_bf16()

    def engine(graphed):
        return EagleChainEngine(tp, dp, TINY_CFG, n_draft=3, max_seq=256,
                                kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                                eos_id=-1, device="cuda", cuda_graphs=graphed)

    eager, graphed = engine(False), engine(True)
    _build.reset_counts()
    want = eager.generate(PROMPT, max_new_tokens=30, stop_at_eos=False)
    eager_launches = dict(_build.launches)
    graphed.generate(PROMPT, max_new_tokens=30, stop_at_eos=False, cycles_per_dispatch=cycles)
    warm = graphed.graphs.eager
    _build.reset_counts()
    got = graphed.generate(PROMPT, max_new_tokens=30, stop_at_eos=False,
                           cycles_per_dispatch=cycles)
    assert got == want
    assert graphed.graphs.eager == warm and graphed.graphs.replays > 0
    assert _build.launches["qmm_mma"] > 0 and sum(_build.plain_calls.values()) == 0
    if cycles == 1:
        assert dict(_build.launches) == eager_launches


def test_graph_recaptures_on_a_new_cache(cuda):
    tp, _ = _tiny_bf16()
    gen = _bf16_gen(tp, True)
    want = gen.generate(PROMPT, max_new_tokens=20, stop_at_eos=False, chunk=8)
    assert gen.graphs.captures == 1
    gen.kv = KVCache.create(TINY_CFG.n_layers, 1, 256, TINY_CFG.n_kv_heads, TINY_CFG.head_dim,
                            torch.bfloat16, device="cuda")
    assert gen.generate(PROMPT, max_new_tokens=20, stop_at_eos=False, chunk=8) == want
    assert gen.graphs.captures == 2 and gen.graphs.eager == 2


def test_graph_per_fused_ffn_mode(cuda, monkeypatch):
    """EAGLE_TPU_FUSED_FFN is read while a step is captured: switching it
    takes another graph, and switching back replays the first."""
    tp, _ = _tiny_bf16(Q4_0, coded=False)
    gen = _bf16_gen(tp, True)
    toks = []
    for mode in ("0", "1", "0"):
        monkeypatch.setenv("EAGLE_TPU_FUSED_FFN", mode)
        _build.reset_counts()
        toks.append(gen.generate(PROMPT, max_new_tokens=20, stop_at_eos=False, chunk=8))
        assert (_build.launches["gate_up_act"] > 0) == (mode == "1")
    assert gen.graphs.captures == 2 and gen.graphs.replays == 3 * 19 - 2
    assert toks[0] == toks[2]


# ---- the tree engines (runtime/tree.py, runtime/tree2.py)


@pytest.mark.parametrize("s_limit", [96, 300, None], ids=["s96", "s300", "full"])
@pytest.mark.parametrize("kind,t,g", [("tree", 4, 1), ("tree", 29, 2), ("tree2", 8, 2),
                                      ("tree2", 16, 4), ("tree2", 32, 2)])
def test_flash_decode_tree_masks(cuda, kind, t, g, s_limit):
    """flash_decode under the tree engines' masks, where a row sees the
    committed prefix (holed tags) and its own ancestors in the node window:
    `_tree_mask` for a drafted level of TreeSpec((4, 2, 2)) (4 rows) and
    its whole verify (29 rows), `_window_tree_mask` for EAGLE-2 windows of
    a random tree (8-32 rows); T*g 4-64 rows per kv head."""
    k_cache, v_cache = _cache(cuda, torch.bfloat16, 64, 2, s=384)
    lim = s_limit or k_cache.shape[3]
    spec = tree.TreeSpec((4, 2, 2))
    n = spec.n_nodes if kind == "tree" else t
    base = lim - n - 3  # the window ends below the read bound
    tags = torch.full((2, k_cache.shape[3]), -1, dtype=torch.int32, device="cuda")
    tags[:, :base] = torch.arange(base, dtype=torch.int32, device="cuda")
    tags[:, 10:14] = -1
    bases = torch.full((2,), base, dtype=torch.int32, device="cuda")
    if kind == "tree":
        depth = torch.from_numpy(spec.depth).cuda()
        lo = 0 if t == n else 1  # the verify's rows, or level 1's
        ids = torch.arange(lo, lo + t, dtype=torch.int32, device="cuda")
        tags[:, base:base + n] = base + depth
        mask = tree._tree_mask(tags[:, :lim], (base + depth[ids.long()])[None].repeat(2, 1),
                               bases, ids, torch.from_numpy(spec.ancestor).cuda(), n)
    else:
        rng = np.random.default_rng(t)
        parent = [-1] + [int(rng.integers(0, j)) for j in range(1, t)]
        anc, dep = torch.eye(t, dtype=torch.bool), [0] * t
        for j in range(1, t):
            anc[j] |= anc[parent[j]]
            dep[j] = dep[parent[j]] + 1
        depth = torch.tensor(dep, dtype=torch.int32, device="cuda")
        tags[:, base:base + t] = base + depth
        mask = tree2._window_tree_mask(tags[:, :lim], (base + depth)[None].repeat(2, 1), bases,
                                       anc.cuda()[None].repeat(2, 1, 1))
    q = torch.randn((2, t, 2 * g, 64), generator=cuda, device="cuda")
    _build.reset_counts()
    got = fa.flash_attention_cached(q, k_cache, v_cache, mask, 1, s_limit=s_limit)
    assert _build.launches["flash_decode"] == 1 and _build.plain_calls["flash_decode"] == 0
    _close(got, fa.flash_attention_cached_plain(q, k_cache, v_cache, mask, 1, s_limit=s_limit),
           TOL[torch.bfloat16])


def _oracle(real, seq):
    """`eagle_forward` with its logits boosted at the target's greedy
    continuation (`seq`: prompt + greedy tokens; the pair at draft position
    p proposes x_{p+2}), device ops only, so graphs capture it."""

    def forward(*args, **kw):
        out = real(*args, **kw)
        if out.logits is None:
            return out
        want = seq[(args[5].long() + 2).clamp(max=seq.numel() - 1)]
        return out._replace(logits=out.logits.scatter_add(
            -1, want[..., None], torch.full_like(out.logits[..., :1], 1e4)))

    return forward


@pytest.mark.parametrize("kind,cycles,with_oracle", [
    ("tree", 1, False), ("tree", 2, True), ("tree2", 1, False), ("tree2", 3, False),
    ("tree2", 1, True), ("tree2", 3, True)])
def test_graphed_tree_engine_equals_eager(cuda, kind, cycles, with_oracle, monkeypatch):
    """Graphed tree tokens and stats at C cycles per dispatch equal the
    eager C = 1 run's (the static tree's verify takes 29 rows, EAGLE-2's 13:
    the wgmma body); after the warm-up no cycle runs eagerly, and at C = 1
    a graphed run counts the eager run's launches. With the oracle draft
    the runs accept drafts, so compaction and the feature handoff past the
    root are replayed too."""
    tp, dp = _tiny_bf16()
    mod = tree if kind == "tree" else tree2
    if with_oracle:
        greedy = _bf16_gen(tp, False).generate(PROMPT, max_new_tokens=40, stop_at_eos=False)
        seq = torch.tensor(PROMPT + greedy, dtype=torch.int64, device="cuda")
        monkeypatch.setattr(mod, "eagle_forward", _oracle(mod.eagle_forward, seq))

    def engine(graphed):
        kw = dict(max_seq=256, kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                  eos_id=-1, device="cuda", cuda_graphs=graphed)
        if kind == "tree":
            return tree.EagleTreeEngine(tp, dp, TINY_CFG, tree=tree.TreeSpec((4, 2, 2)), **kw)
        return tree2.EagleTree2Engine(tp, dp, TINY_CFG, beam=4, depth=3, n_verify=13, **kw)

    eager, graphed = engine(False), engine(True)
    _build.reset_counts()
    want = eager.generate(PROMPT, max_new_tokens=30, stop_at_eos=False)
    eager_launches = dict(_build.launches)
    graphed.generate(PROMPT, max_new_tokens=30, stop_at_eos=False, cycles_per_dispatch=cycles)
    warm = graphed.graphs.eager
    _build.reset_counts()
    got = graphed.generate(PROMPT, max_new_tokens=30, stop_at_eos=False,
                           cycles_per_dispatch=cycles)
    assert got == want
    assert graphed.graphs.eager == warm and graphed.graphs.replays > 0
    assert _build.launches["qmm_tc"] > 0 and sum(_build.plain_calls.values()) == 0
    if cycles == 1:
        assert dict(_build.launches) == eager_launches
    if with_oracle:
        assert want[1]["n_accepted"] > 0


# ---- sampled decoding on the card (runtime/sampling.py; `-k sample`)

SAMPLED = SamplerConfig()  # the CLI's defaults: temp 0.8, top-k 40, top-p 0.95, min-p 0.05


def test_sample_speculative_accept_marginal_on_the_card(cuda):
    """The first emitted token's marginal equals p within total variation
    0.02 (V = 16, 40,000 rows; noise alone ~0.006), with the draws of a
    `CounterRNG` on the card."""
    from eagle_tpu_torch.runtime.sampling import CounterRNG, speculative_accept

    rng = np.random.default_rng(0)
    v, k, n = 16, 2, 40000

    def dist(temp=1.0):
        p = np.exp(rng.standard_normal(v) * temp)
        return torch.tensor(p / p.sum(), dtype=torch.float32, device="cuda")

    p0, p1, p2, q0, q1 = dist(2.0), dist(), dist(), dist(2.0), dist()
    gen = CounterRNG(seed=1, device="cuda")
    q = torch.stack([q0, q1])
    drafts = torch.argmax(gen.gumbel((n, k, v)) + torch.log(q), dim=-1).to(torch.int32)
    tokens, n_acc = speculative_accept(
        drafts, q.expand(n, k, v), torch.stack([p0, p1, p2]).expand(n, k + 1, v),
        torch.full((n,), k, dtype=torch.int32, device="cuda"),
        torch.zeros(n, dtype=torch.bool, device="cuda"), gen.uniform((n, k)), gen.gumbel((n, v)))
    emp = torch.bincount(tokens[:, 0].long(), minlength=v).double() / n
    assert float(0.5 * (emp - p0.double()).abs().sum()) < 0.02
    assert bool((n_acc == 0).any()) and bool((n_acc > 0).any())


def test_sample_draws_advance_across_replays(cuda):
    """A graph that captured a draw draws anew at each replay, with the
    values an eager run of the same (seed, counter) gives."""
    from eagle_tpu_torch.runtime.sampling import CounterRNG

    gen = CounterRNG(seed=9, device="cuda")
    out = torch.zeros((4, 1000), device="cuda")
    row = torch.zeros((), dtype=torch.int64, device="cuda")

    def body():
        out.index_copy_(0, row.view(1), gen.uniform((1, 1000)))
        row.add_(1)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()  # the warm-up draws row 0
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for _ in range(3):
        graph.replay()
    eager = CounterRNG(seed=9, device="cuda")
    want = torch.cat([eager.uniform((1, 1000)) for _ in range(4)])
    assert int(gen.counter) == 4 and torch.equal(out, want)
    assert len({tuple(r[:8].tolist()) for r in out}) == 4


@pytest.mark.parametrize("kind,cycles", [("plain", 1), ("chain", 1), ("chain", 2), ("chain", 3),
                                         ("tree", 1), ("tree", 2), ("tree2", 1), ("tree2", 2),
                                         ("tree2", 3)])
def test_sampled_engine_graphed_equals_eager(cuda, kind, cycles):
    """Sampled at the CLI's defaults, graphed tokens (and stats) at C
    cycles per dispatch equal the eager C = 1 run's from the same seed bit
    for bit; after the warm-up no body runs eagerly; another seed gives
    another stream; no plain version runs."""
    tp, dp = _tiny_bf16()
    kw = dict(max_seq=256, kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, eos_id=-1,
              device="cuda")

    def engine(graphed):
        if kind == "plain":
            return Generator(tp, TINY_CFG, cuda_graphs=graphed, **kw)
        spec = dict(sampler=SAMPLED, cuda_graphs=graphed, **kw)
        if kind == "chain":
            return EagleChainEngine(tp, dp, TINY_CFG, n_draft=3, **spec)
        if kind == "tree":
            return tree.EagleTreeEngine(tp, dp, TINY_CFG, tree=tree.TreeSpec((4, 2, 2)), **spec)
        return tree2.EagleTree2Engine(tp, dp, TINY_CFG, beam=4, depth=3, n_verify=13, **spec)

    def run(eng, seed, c):
        if kind == "plain":
            return eng.generate(PROMPT, max_new_tokens=30, sampler=SAMPLED, seed=seed,
                                stop_at_eos=False, chunk=8)
        return eng.generate(PROMPT, max_new_tokens=30, seed=seed, stop_at_eos=False,
                            cycles_per_dispatch=c)

    eager, graphed = engine(False), engine(True)
    want = run(eager, 4, 1)
    assert run(graphed, 4, cycles) == want  # the warm-up captures
    warm = graphed.graphs.eager
    _build.reset_counts()
    assert run(graphed, 4, cycles) == want
    assert run(graphed, 5, cycles) != want
    assert graphed.graphs.eager == warm and graphed.graphs.replays > 0
    assert sum(_build.plain_calls.values()) == 0


# ---- continuous batching (runtime/scheduler.py): row views and masked cycles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("view", ["row2", "every_other"])
@pytest.mark.parametrize("kernel", ["flash_decode", "flash_prefill"])
def test_flash_kernels_on_a_row_view(cuda, kernel, view, dtype, d):
    """Both kernels on a view of a B = 4 cache whose batch rows are apart
    (the batcher's `KVCache.row`, and every other row): the batch stride
    is passed, nothing is copied, and the result is the plain version's."""
    shape = (2, 4, 2, 256, d)
    k_full = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    v_full = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    rows = slice(2, 3) if view == "row2" else slice(0, 4, 2)
    k_cache, v_cache = k_full[:, rows], v_full[:, rows]
    assert not k_cache.is_contiguous()
    b, t = k_cache.shape[1], 20
    tags = torch.full((b, 256), -1, dtype=torch.int32, device="cuda")
    tags[:, :150] = torch.arange(150, dtype=torch.int32, device="cuda")
    pos = (torch.arange(t, device="cuda", dtype=torch.int32) + 130)[None].repeat(b, 1)
    q = torch.randn((b, t, 4, d), generator=cuda, device="cuda")
    _build.reset_counts()
    mask = causal_mask_from_tags(tags[:, :160], pos)
    if kernel == "flash_decode":
        got = fa.flash_attention_cached(q, k_cache, v_cache, mask, 1, s_limit=160)
    else:
        got = fa.flash_attention_prefill(q, k_cache, v_cache, pos, tags, 1, s_limit=160)
    assert _build.launches[kernel] == 1 and _build.plain_calls[kernel] == 0
    want = fa.flash_attention_cached_plain(q, k_cache.contiguous(), v_cache.contiguous(), mask,
                                           1, s_limit=160)
    _close(got, want, TOL[dtype])


def _batch_engine(tp, dp, graphed, batch=3):
    return EagleChainEngine(tp, dp, TINY_CFG, n_draft=3, max_seq=256, batch=batch,
                            kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, eos_id=-1,
                            device="cuda", cuda_graphs=graphed)


def _state_rows(eng, rows):
    st = eng.state
    return [t[rows].clone() for t in (st.tgt_kv.slot_pos, st.dft_kv.slot_pos, st.last_token,
                                      st.feature, st.n_past)]


def test_batched_cycle_graphed_equals_eager_with_an_inactive_row(cuda):
    """A B = 3 batcher, row 2 parked and row 1 admitted in chunks while row
    0 generates: graphed tokens and tags equal the eager run's bit for bit,
    no body runs eagerly after the capture, and a replayed masked cycle
    leaves the inactive rows' tags and scalars as they were."""
    from eagle_tpu_torch.runtime.scheduler import ContinuousBatcher

    tp, dp = _tiny_bf16()
    prompts = [PROMPT, np.random.default_rng(1).integers(0, 512, size=90).tolist()]
    runs = {}
    for graphed in (False, True):
        eng = _batch_engine(tp, dp, graphed)
        b = ContinuousBatcher(eng, prefill_chunk=32)
        s0 = b.submit(prompts[0], max_new_tokens=40, stop_at_eos=False)
        for _ in range(3):
            b.step()
        s1 = b.submit(prompts[1], max_new_tokens=12, stop_at_eos=False)
        b.step()  # row 1's first chunk: row 1 inactive in this cycle
        frozen = _state_rows(eng, [1, 2])
        eng._multi_cycle(1, kv_limit=eng.kv_read_bucket(int(b.n_past.max()) + 8),
                         active=b._active_mask)
        b.n_past[0] = int(eng.state.n_past[0])  # the extra cycle, for the host's mirror
        for old, new in zip(frozen, _state_rows(eng, [1, 2])):
            assert torch.equal(old.view(torch.int32) if old.is_floating_point() else old,
                               new.view(torch.int32) if new.is_floating_point() else new)
        b.run_until_done(max_steps=200)
        runs[graphed] = (s0.generated, s1.generated, eng.state.tgt_kv.slot_pos.clone(),
                         eng.state.dft_kv.slot_pos.clone())
        if graphed:  # every eager body was a capture's warm-up
            assert eng.graphs.replays > 0 and eng.graphs.eager == eng.graphs.captures
    for got, want in zip(runs[True], runs[False]):
        assert (torch.equal(got, want) if isinstance(got, torch.Tensor) else got == want)


def test_set_row_sampler_after_capture_takes_effect(cuda):
    """A row's sampler set after the stochastic cycle's capture reaches the
    next replay (the rows are written in place): top-k 1 at temperature 1
    draws the argmax, so that row gives the greedy batched tokens, with no
    new capture."""
    from eagle_tpu_torch.runtime.scheduler import ContinuousBatcher

    tp, dp = _tiny_bf16()
    hot = SamplerConfig(temperature=1.5, top_k=0, top_p=1.0, min_p=0.0)
    first = SamplerConfig(temperature=1.0, top_k=1, top_p=1.0, min_p=0.0)
    greedy_eng = _batch_engine(tp, dp, False, batch=2)
    gb = ContinuousBatcher(greedy_eng)
    gb.submit(PROMPT, max_new_tokens=30, stop_at_eos=False)
    want = gb.submit(PROMPT[:15], max_new_tokens=30, stop_at_eos=False)
    gb.run_until_done(max_steps=200)

    eng = _batch_engine(tp, dp, True, batch=2)
    b = ContinuousBatcher(eng)
    for p in (PROMPT, PROMPT[:15]):
        b.submit(p, max_new_tokens=30, stop_at_eos=False, sampler=hot)
    b.run_until_done(max_steps=200)  # captures the stochastic cycle
    captures = eng.graphs.captures
    b.submit(PROMPT, max_new_tokens=30, stop_at_eos=False, sampler=hot)
    got = b.submit(PROMPT[:15], max_new_tokens=30, stop_at_eos=False, sampler=first)
    assert not eng.fast_greedy
    b.run_until_done(max_steps=200)
    assert got.generated == want.generated
    assert eng.graphs.captures == captures and eng.graphs.replays > 0


# ---- chat over a live cache: a feed at an offset, the context shift, embed

#: (T, real rows n, q0, s_limit): three padding rows, then chip_smoke.py's
#: phase chat feeds (256-row blocks from 0, 128 rows from 185, 256 from 311)
OFFSET_FEEDS = [(16, 13, 300, 512), (32, 29, 700, 1024), (64, 61, 960, 1024),
                (256, 138, 0, 256), (128, 79, 185, 512), (256, 219, 311, 1024)]


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("t,n,q0,s_limit", OFFSET_FEEDS)
def test_flash_prefill_at_an_offset(cuda, t, n, q0, s_limit, g):
    """A chat turn's feed (`Generator._extend`): T query rows from position
    q0 over the history's tags, rows n..T-1 padding (positions past the
    feed, tags unwritten), bf16, head_dim 128, GQA."""
    k_cache, v_cache = _cache(cuda, torch.bfloat16, 128, 4, s=1024)
    slots = torch.arange(1024, dtype=torch.int32, device="cuda")[None].repeat(2, 1)
    tags = torch.where(slots < q0 + n, slots, -1)
    q_pos = (q0 + torch.arange(t, dtype=torch.int32, device="cuda"))[None].repeat(2, 1)
    q = torch.randn((2, t, 4 * g, 128), generator=cuda, device="cuda")
    _build.reset_counts()
    got = fa.flash_attention_prefill(q, k_cache, v_cache, q_pos, tags, 1, s_limit=s_limit)
    assert _build.launches["flash_prefill"] == 1 and _build.plain_calls["flash_prefill"] == 0
    want = fa.flash_attention_prefill_plain(q, k_cache, v_cache, q_pos, tags, 1,
                                            s_limit=s_limit)
    _close(got, want, TOL[torch.bfloat16])


def _feed(gen, ids, start):
    from eagle_tpu_torch.runtime.generate import pad_bucket

    t = pad_bucket(len(ids))
    p = torch.zeros((1, t), dtype=torch.int32, device="cuda")
    p[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    return gen._extend(p, start, len(ids), t, kv_limit=gen.kv_read_bucket(start + t))[0]


def test_graphed_decode_after_a_feed_equals_eager(cuda):
    """A prompt, a feed of 20 tokens at its end (`_extend`: 9 qmm_tc and 2
    flash_prefill on the tiny model, the cache's pointers kept), then a
    graphed decode chunk: the eager run's tokens bit for bit."""
    tp, _ = _tiny_bf16()
    feed = np.random.default_rng(2).integers(0, 512, size=20).tolist()
    out = {}
    for graphed in (False, True):
        gen = _bf16_gen(tp, graphed)
        gen.generate(PROMPT, max_new_tokens=1)
        ptrs = [x.data_ptr() for x in (gen.kv.k, gen.kv.v, gen.kv.slot_pos)]
        _build.reset_counts()
        logits = _feed(gen, feed, len(PROMPT))
        assert _build.launches["qmm_tc"] == 2 * 4 + 1 and _build.launches["flash_prefill"] == 2
        assert [x.data_ptr() for x in (gen.kv.k, gen.kv.v, gen.kv.slot_pos)] == ptrs
        first = logits.argmax(-1).to(torch.int32)
        toks = gen._decode_chunk(first, len(PROMPT) + len(feed), SamplerConfig(greedy=True),
                                 16, kv_limit=128)
        out[graphed] = (logits.clone(), toks.tolist())
    assert torch.equal(out[True][0], out[False][0]) and out[True][1] == out[False][1]


def test_context_shift_under_live_graphs_replays(cuda):
    """`generate(context_shift_keep=)` past a 256-slot cache: the shift moves
    the rows in place, so the steps after it replay the graphs captured
    before it (none captured after), and the tokens equal the eager run's."""
    tp, _ = _tiny_bf16()
    runs = {}
    for graphed in (False, True):
        gen = _bf16_gen(tp, graphed)
        at_shift = []
        real = gen.shift_context
        gen.shift_context = lambda *a, g=gen, r=real: (at_shift.append(g.graphs.captures), r(*a))
        runs[graphed] = gen.generate(PROMPT, max_new_tokens=400, stop_at_eos=False,
                                     context_shift_keep=8)
        assert len(at_shift) >= 1
        if graphed:
            assert gen.graphs.captures == at_shift[0] and gen.graphs.replays > 0
    assert runs[True] == runs[False] and len(runs[True]) == 400


def test_embed_on_the_card_matches_the_cpu(cuda):
    """`Engine.embed` (mean and last) and `rerank` over the tiny model's
    params, f32, on the card against the CPU (relative error <= 1e-3)."""
    from eagle_tpu_torch.api import Engine, EngineConfig

    class Words:  # a stand-in tokenizer: one id per byte
        eos_id, bos_id = 2, 1

        def encode(self, text, add_bos=True):
            return [1] * add_bos + [3 + b for b in text.encode()]

    cpu_params = synth_llama_params(TINY_CFG, seed=3, packed=True, coded=True, device="cpu")
    texts = ["the first text", "a second one", "and a third, longer text to embed"]
    got = {}
    for dev in ("cuda", "cpu"):
        eng = Engine.__new__(Engine)
        eng.cfg = EngineConfig(compute_dtype=torch.float32, kv_dtype=torch.float32, device=dev)
        eng.device, eng.model_cfg, eng.tokenizer = torch.device(dev), TINY_CFG, Words()
        eng.params = params_to(cpu_params, dev)
        got[dev] = [np.stack(eng.embed(texts, pooling=p)) for p in ("mean", "last")] + [
            np.asarray(eng.rerank(texts[0], texts[1:]))]
    for a, b in zip(got["cuda"], got["cpu"]):
        _close(torch.from_numpy(a), torch.from_numpy(b), 1e-3)


def params_to(tree, dev):
    if isinstance(tree, dict):
        return {k: params_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, **{k: None if v is None else v.to(dev)
                                            for k, v in tree.tensors().items()})
    return tree.to(dev)


# ---- paged and int8 caches


def test_int8_quantize_on_the_card_equals_the_cpu(cuda):
    """`quantize_kv_vec` / `dequantize_kv` on the card give the CPU's codes,
    scales and values bit for bit (f32 and bf16 inputs, zero rows, ties)."""
    from eagle_tpu_torch.runtime.kvcache import dequantize_kv, quantize_kv_vec

    gen = torch.Generator().manual_seed(5)
    x = torch.randn((3, 4, 33, 128), generator=gen) * 3
    x[0, 1, 2] = 0
    x[1, 0, 0] = (torch.randint(-126, 126, (128,), generator=gen) + 0.5) / 4
    x[1, 0, 0, 0] = 127 / 4
    for dtype in (torch.float32, torch.bfloat16):
        xc = x.to(dtype)
        c_cpu, s_cpu = quantize_kv_vec(xc)
        c_gpu, s_gpu = quantize_kv_vec(xc.cuda())
        assert torch.equal(c_gpu.cpu(), c_cpu)
        assert torch.equal(s_gpu.cpu().view(torch.int32), s_cpu.view(torch.int32))
        for out in (torch.bfloat16, torch.float32):
            a = dequantize_kv(c_gpu, s_gpu, out).cpu()
            b = dequantize_kv(c_cpu, s_cpu, out)
            assert torch.equal(a.view(torch.int16 if out == torch.bfloat16 else torch.int32),
                               b.view(torch.int16 if out == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_paged_read_equals_the_dense_read(cuda, kv_dtype):
    """The same prompt written into a paged pool (its pages in a shuffled
    order) and into a dense cache gives the same logits (rel err <= 2e-2):
    the rows read through the page table (the plain read) as the dense
    cache's read (flash_decode for bf16, the plain read for int8)."""
    from eagle_tpu_torch.models.llama import llama_forward
    from eagle_tpu_torch.runtime.kvcache import KVCache, causal_mask_from_tags
    from eagle_tpu_torch.runtime.paged_kv import PagedKVCache

    tp, _ = _tiny_bf16()
    cfg, ps, s, b = TINY_CFG, 16, 128, 2
    dense = KVCache.create(cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim, kv_dtype,
                           device="cuda")
    paged = PagedKVCache.create(cfg.n_layers, b, 2 * s // ps, s // ps, ps, cfg.n_kv_heads,
                                cfg.head_dim, kv_dtype, device="cuda")
    perm = torch.randperm(2 * s // ps, generator=torch.Generator().manual_seed(2))
    paged.page_table.copy_(perm.view(b, s // ps).to(torch.int32))
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, 512, (b, 40), generator=gen, device="cuda", dtype=torch.int32)
    pos = torch.arange(40, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
    outs = []
    for kv in (dense, paged):
        kv.with_tags(pos, pos)
        fo = llama_forward(tp, cfg, tokens, pos, kv, pos, causal_mask_from_tags(kv.slot_pos, pos),
                           compute_dtype=torch.bfloat16, kv_limit=64)
        outs.append(fo.logits.float())
    _close(outs[1], outs[0], 2e-2)


def test_paged_cycle_graphed_equals_eager(cuda):
    """A paged B = 3 batcher (16-row pages, a pool of 24 pages, bf16), with a
    prefix hit and page-table changes between replays: graphed tokens, tags
    and stats equal the eager run's bit for bit, and no graph key is
    captured twice (the tables are rewritten in place)."""
    from eagle_tpu_torch.runtime.paged_batcher import PagedBatcher

    tp, dp = _tiny_bf16()
    shared = np.random.default_rng(3).integers(0, 512, size=48).tolist()
    prompts = [shared + [5, 6, 7], shared + [9, 10], PROMPT]
    runs = {}
    for graphed in (False, True):
        eng = _batch_engine(tp, dp, graphed)
        b = PagedBatcher(eng, n_pages=24, page_size=16)
        s0 = b.submit(prompts[0], max_new_tokens=60, stop_at_eos=False)
        while len(s0.generated) < 3:
            b.step()
        s1 = b.submit(prompts[1], max_new_tokens=40, stop_at_eos=False)
        s2 = b.submit(prompts[2], max_new_tokens=40, stop_at_eos=False)
        b.run_until_done(max_steps=300)
        runs[graphed] = ([s.generated for s in (s0, s1, s2)], dict(b.stats),
                         eng.state.tgt_kv.slot_pos.clone(), eng.state.dft_kv.slot_pos.clone())
        if graphed:  # each key captured once: a page-table change recaptures nothing
            assert eng.graphs.replays > 0
            assert eng.graphs.captures == len(eng.graphs._graphs) == eng.graphs.eager
    assert runs[True][1]["prefix_hits"] == 1
    for got, want in zip(runs[True], runs[False]):
        assert (torch.equal(got, want) if isinstance(got, torch.Tensor) else got == want)


# ---- stateful samplers and constrained decoding (`-k "stateful or constrained"`)

STATEFUL_KINDS = {
    "penalties": SamplerConfig(greedy=True, penalty_repeat=1.3, penalty_freq=0.2,
                               penalty_present=0.2),
    "dry": SamplerConfig(greedy=True, dry_multiplier=0.8, dry_allowed_length=1,
                         dry_sequence_breakers=(7,)),
    "mirostat_v1": SamplerConfig(mirostat=1, mirostat_tau=8.0, temperature=1.0,
                                 penalty_repeat=1.1),
    "mirostat_v2": SamplerConfig(mirostat=2, mirostat_tau=8.0, temperature=1.0,
                                 logit_bias=((5, 2.0), (9, -1.0))),
    "sampled_penalties": SamplerConfig(temperature=0.9, top_k=0, top_p=1.0, min_p=0.0,
                                       penalty_freq=0.3, xtc_probability=0.5,
                                       xtc_threshold=0.01),
}


def test_stateful_functions_on_the_card_match_the_cpu(cuda):
    """At V = 32,000 with the same logits, state and noise: the penalties,
    DRY and both mirostats on the card against the CPU (relative error <=
    1e-5: CUDA divides by a Python scalar through its reciprocal), mirostat
    v1's k equal, and four `sample_stateful` steps of each kind the same
    tokens with the same state after them."""
    from eagle_tpu_torch.runtime import sampling as S

    v, b = 32000, 3
    rng = np.random.default_rng(0)
    logits = torch.from_numpy((rng.standard_normal((b, v)) * 3).astype(np.float32))
    counts = torch.from_numpy(rng.integers(0, 3, (b, v)).astype(np.float32))
    recent = torch.from_numpy(rng.integers(0, 12, (b, 64)).astype(np.int32))
    g = torch.from_numpy(rng.gumbel(size=(b, v)).astype(np.float32))
    mu = torch.tensor([4.0, 10.0, 16.0])
    both = {"cpu": (logits, counts, recent, g, mu),
            "cuda": tuple(t.cuda() for t in (logits, counts, recent, g, mu))}
    cfg = STATEFUL_KINDS["penalties"]
    dry = STATEFUL_KINDS["dry"]
    res = {dev: dict(pen=S.apply_penalties(l, c, cfg), dry=S.dry_penalty(l, r, dry),
                     k=S._mirostat_v1_k(l, m), v1=S._mirostat_v1(l, n, cfg, m),
                     v2=S._mirostat_v2(l, n, cfg, m))
           for dev, (l, c, r, n, m) in both.items()}
    _close(res["cuda"]["pen"].cpu(), res["cpu"]["pen"], 1e-5)
    _close(res["cuda"]["dry"].cpu(), res["cpu"]["dry"], 1e-5)
    assert torch.equal(res["cuda"]["k"].cpu(), res["cpu"]["k"])
    for name in ("v1", "v2"):
        assert torch.equal(res["cuda"][name][0].cpu(), res["cpu"][name][0])
        _close(res["cuda"][name][1].cpu(), res["cpu"][name][1], 1e-5)
    for kind, scfg in STATEFUL_KINDS.items():
        states = {dev: S.SamplerState(b, v, tau=scfg.mirostat_tau, device=dev)
                  for dev in ("cpu", "cuda")}
        for step in range(4):
            lg = torch.from_numpy((rng.standard_normal((b, v)) * 3).astype(np.float32))
            gn = torch.from_numpy(rng.gumbel(size=(b, v)).astype(np.float32))
            u = torch.from_numpy(rng.random((b, 1)).astype(np.float32))
            toks = {dev: S.sample_stateful(lg.to(dev), scfg, states[dev], gn.to(dev), u.to(dev))
                    for dev in ("cpu", "cuda")}
            assert torch.equal(toks["cuda"].cpu(), toks["cpu"]), (kind, step)
        assert torch.equal(states["cuda"].counts.cpu(), states["cpu"].counts)
        assert torch.equal(states["cuda"].recent.cpu(), states["cpu"].recent)
        _close(states["cuda"].mu.cpu(), states["cpu"].mu, 1e-5)


@pytest.mark.parametrize("kind", list(STATEFUL_KINDS))
def test_graphed_stateful_generator_equals_eager(cuda, kind):
    """Each stateful sampler rides the graphed decode step: graphed tokens
    equal the eager path's bit for bit, a second graphed run captures
    nothing and runs no body eagerly, and a state made anew recaptures."""
    tp, _ = _tiny_bf16()
    scfg = STATEFUL_KINDS[kind]
    eager, graphed = _bf16_gen(tp, False), _bf16_gen(tp, True)
    want = eager.generate(PROMPT, max_new_tokens=40, sampler=scfg, seed=3, stop_at_eos=False,
                          chunk=8)
    assert graphed.generate(PROMPT, max_new_tokens=40, sampler=scfg, seed=3,
                            stop_at_eos=False, chunk=8) == want
    captures, warm = graphed.graphs.captures, graphed.graphs.eager
    _build.reset_counts()
    assert graphed.generate(PROMPT, max_new_tokens=40, sampler=scfg, seed=3,
                            stop_at_eos=False, chunk=8) == want
    assert (graphed.graphs.captures, graphed.graphs.eager) == (captures, warm)
    assert _build.launches["qmm_gemv"] > 0 and sum(_build.plain_calls.values()) == 0
    old, graphed.sstate = graphed.sstate, None  # kept: the new state lies elsewhere
    assert graphed.generate(PROMPT, max_new_tokens=40, sampler=scfg, seed=3,
                            stop_at_eos=False, chunk=8) == want
    assert graphed.graphs.captures == captures + 1
    assert old.counts.data_ptr() != graphed.sstate.counts.data_ptr()


class _Pieces:
    """A tokenizer of 512 pieces for the grammar: digits, letters and the
    space, repeated 1-3 times; 0-2 control (EOS 2)."""

    eos_id = 2
    chars = "0123456789abcdefghijklmnopqrstuvwxyz "

    def piece(self, i: int) -> str:
        return "" if i < 3 else self.chars[i % 37] * (1 + (i // 37) % 3)


WORDS_GBNF = "root ::= [a-z ]+"


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_constrained_chain_equals_plain_on_the_card(cuda, graphed):
    """f32 on the card: the chain's constrained tokens (proposals eager or
    replayed as graphs) equal the plain constrained generator's, the
    digits vetoed; graphed proposals equal eager ones, with their stats."""
    from eagle_tpu_torch.runtime.grammar import Grammar

    cfg = TINY_CFG
    tp = synth_llama_params(cfg, qtype=Q4_K, seed=3, packed=True, coded=True, device="cuda")
    dp = synth_eagle_params(cfg, qtype=Q4_K, seed=4, packed=True, device="cuda")
    kw = dict(max_seq=256, kv_dtype=torch.float32, compute_dtype=torch.float32, eos_id=2,
              device="cuda")
    tok = _Pieces()
    plain = Generator(tp, cfg, cuda_graphs=graphed, **kw)
    want = plain.generate_constrained(PROMPT, Grammar(WORDS_GBNF), tok, max_new_tokens=40)
    text = "".join(tok.piece(t) for t in want if t != 2)
    assert Grammar(WORDS_GBNF).accepts_text(text) and len(want) > 1

    def chain(g):
        return EagleChainEngine(tp, dp, cfg, n_draft=3, cuda_graphs=g, **kw)

    got, stats = chain(graphed).generate_constrained(PROMPT, Grammar(WORDS_GBNF), tok,
                                                     max_new_tokens=40)
    assert got == want and stats["constrained"] and stats["n_cycles"] >= 1
    if graphed:
        eng = chain(True)
        eng.generate_constrained(PROMPT, Grammar(WORDS_GBNF), tok, max_new_tokens=40)
        warm = eng.graphs.eager
        _build.reset_counts()
        again = eng.generate_constrained(PROMPT, Grammar(WORDS_GBNF), tok, max_new_tokens=40)
        assert again == (got, stats) and eng.graphs.eager == warm and eng.graphs.replays > 0
        assert sum(_build.plain_calls.values()) == 0
        eager = chain(False).generate_constrained(PROMPT, Grammar(WORDS_GBNF), tok,
                                                  max_new_tokens=40)
        assert eager == (got, stats)


def test_graphed_proposal_equals_eager(cuda):
    """bf16: one proposal replayed as a graph writes the eager proposal's
    drafts, argmaxes, candidates, features and logits bit for bit, and the
    caches' tags; the verify's products are `qmm_mma` launches."""
    from eagle_tpu_torch.runtime.grammar import Grammar

    tp, dp = _tiny_bf16()
    outs = []
    for graphed in (False, True):
        eng = EagleChainEngine(tp, dp, TINY_CFG, n_draft=3, max_seq=256,
                               kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, eos_id=2,
                               device="cuda", cuda_graphs=graphed)
        toks, _ = eng.generate_constrained(PROMPT, Grammar(WORDS_GBNF), _Pieces(),
                                           max_new_tokens=12)
        st, prop = eng.state, eng._prop
        _build.reset_counts()
        eng._propose(eng.kv_read_bucket(int(st.n_past[0]) + eng.K + 2), 256)
        torch.cuda.synchronize()
        assert _build.launches["qmm_mma"] == 2 * 4 + 1
        outs.append((toks, prop.ids.clone(), prop.feats.clone(), prop.logits.clone(),
                     st.tgt_kv.slot_pos.clone(), st.dft_kv.slot_pos.clone()))
        if graphed:
            assert eng.graphs.replays > 0
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert torch.equal(a, b)


# ---- model-free speculation, infill and YaRN (runtime/lookahead.py, lookup.py,
# infill via Generator._constrained_step, ops/rope.py; `-k "lookahead or lookup or
# infill or yarn"`)


@pytest.mark.parametrize("wng", [(4, 4, 3), (8, 4, 8)], ids=["w4n4g3", "w8n4g8"])
@pytest.mark.parametrize("live", [3, 0], ids=["grams_live", "no_gram_live"])
def test_flash_decode_lookahead_mask(cuda, wng, live):
    """flash_decode under a lookahead step's mask: the committed prefix
    (tags with holes) and the static window pattern in the cache's last T
    slots, the columns of dead grams off, over the whole cache; T*g 22-96
    rows per kv head, rows that see a handful of keys among hundreds."""
    from eagle_tpu_torch.runtime.lookahead import _Layout

    lay = _Layout(*wng)
    t, g = lay.T, 2
    k_cache, v_cache = _cache(cuda, torch.bfloat16, 128, 2, s=384)
    s = k_cache.shape[3]
    base, n_past = s - t, 200
    tags = torch.full((2, s), -1, dtype=torch.int32, device="cuda")
    tags[:, :n_past] = torch.arange(n_past, dtype=torch.int32, device="cuda")
    tags[:, 17:25] = -1
    pos = n_past + torch.from_numpy(lay.pos_off).cuda()
    ok = torch.ones(t, dtype=torch.bool, device="cuda")
    dead = lay.gram_rows[live:].reshape(-1)
    ok[torch.from_numpy(dead).long().cuda()] = False
    tags[:, base:] = torch.where(ok, pos, -1)
    committed = (tags >= 0) & (torch.arange(s, device="cuda") < base)
    mask = committed[:, None, :] & (tags[:, None, :] <= pos[None, :, None])
    mask[:, :, base:] = torch.from_numpy(lay.visible).cuda() & ok[None, :]
    q = torch.randn((2, t, 2 * g, 128), generator=cuda, device="cuda")
    _build.reset_counts()
    got = fa.flash_attention_cached(q, k_cache, v_cache, mask, 1)
    assert _build.launches["flash_decode"] == 1 and _build.plain_calls["flash_decode"] == 0
    _close(got, fa.flash_attention_cached_plain(q, k_cache, v_cache, mask, 1),
           TOL[torch.bfloat16])


def _model_free(kind, tp, graphed):
    from eagle_tpu_torch.runtime.lookahead import LookaheadEngine
    from eagle_tpu_torch.runtime.lookup import LookupEngine

    kw = dict(max_seq=256, kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, eos_id=-1,
              device="cuda", cuda_graphs=graphed)
    if kind == "lookahead":
        return LookaheadEngine(tp, TINY_CFG, W=4, N=4, G=3, **kw)
    return LookupEngine(tp, TINY_CFG, n_draft=8, **kw)


@pytest.mark.parametrize("kind", ["lookahead", "lookup"])
def test_graphed_model_free_engine_equals_eager(cuda, kind):
    """A tiny lookahead engine (T = 22 rows, flash_decode over the whole
    cache) and a lookup engine (9 verify rows, qmm_tc): graphed tokens and
    stats equal the eager run's bit for bit, every step after the first
    replays, and a replay counts the eager step's launches. The tokens
    follow greedy decoding (up to a bf16 near-tie of the tiny model)."""
    from eagle_tpu_torch.runtime.lookup import NgramCache

    tp, _ = _tiny_bf16()
    prompt = (PROMPT[:6] * 4)[:21]
    want = _model_free(kind, tp, False).generate(prompt, max_new_tokens=40, stop_at_eos=False)
    eng = _model_free(kind, tp, True)
    eng.generate(prompt, max_new_tokens=40, stop_at_eos=False)
    warm = eng.graphs.eager
    if kind == "lookup":  # the n-gram cache learns across calls: start it afresh
        eng.ngram = NgramCache()
    _build.reset_counts()
    got = eng.generate(prompt, max_new_tokens=40, stop_at_eos=False)
    assert got == want and eng.graphs.eager == warm and eng.graphs.replays > 0
    assert sum(_build.plain_calls.values()) == 0 and _build.launches["qmm_tc"] > 0
    if kind == "lookahead":
        assert _build.launches["flash_decode"] > 0


def test_lookahead_compact_kv_in_a_replay(cuda):
    """`tree._compact_kv` captured in a CUDA graph: with the accepted count
    and the rows written on the device before each replay, the replay moves
    the kept rows and tags as the eager call does, and leaves the dropped
    ones."""
    from eagle_tpu_torch.runtime.graphs import StepGraphs
    from eagle_tpu_torch.runtime.tree import _compact_kv

    def cache():
        kv = KVCache.create(2, 1, 64, 2, 64, torch.bfloat16, device="cuda")
        kv.k.copy_(torch.randn(kv.k.shape, generator=cuda, device="cuda"))
        kv.v.copy_(torch.randn(kv.v.shape, generator=cuda, device="cuda"))
        kv.slot_pos[:, 40:] = torch.arange(24, dtype=torch.int32, device="cuda") + 100
        return kv

    n_acc = torch.zeros((), dtype=torch.int32, device="cuda")
    src_rows = torch.zeros((1, 4), dtype=torch.int64, device="cuda")
    cols = torch.arange(4, dtype=torch.int32, device="cuda")[None, :]
    graphed, g = cache(), StepGraphs(True)
    for acc, rows in ((2, [0, 3, 7, 0]), (0, [0, 0, 0, 0]), (3, [0, 5, 6, 9])):
        n_acc.fill_(acc)
        src_rows.copy_(torch.tensor([rows]))
        eager = cache()
        eager.k.copy_(graphed.k)
        eager.v.copy_(graphed.v)
        eager.slot_pos.copy_(graphed.slot_pos)
        for kv, run in ((eager, lambda f: f()), (graphed, None)):
            def body(kv=kv):
                _compact_kv(kv, 40 + src_rows, 10 + cols, cols <= n_acc)
            if run is None:
                g.run(("compact",), body, (*kv.tensors(), n_acc, src_rows, cols))
            else:
                run(body)
        assert torch.equal(graphed.k, eager.k) and torch.equal(graphed.slot_pos, eager.slot_pos)
    assert g.captures == 1 and g.replays == 2


def test_infill_logits_steps_on_the_card_match_the_cpu(cuda):
    """Infill's per-token forward (`Generator._constrained_step`, a graph
    replay per read bucket) on the card against the CPU's plain path, f32:
    the logits of a 30-token fill within 1e-3 of their scale."""
    cpu_params = synth_llama_params(TINY_CFG, seed=3, packed=True, coded=True, device="cpu")
    gens = {dev: Generator(params_to(cpu_params, dev), TINY_CFG, max_seq=256,
                           kv_dtype=torch.float32, compute_dtype=torch.float32, eos_id=-1,
                           device=dev)
            for dev in ("cuda", "cpu")}
    toks = PROMPT + [7] * 30
    out = {}
    for dev, gen in gens.items():
        gen._prompt(np.asarray(PROMPT, np.int32), None)
        out[dev] = torch.stack([gen._constrained_step(t, len(PROMPT) + i)[0].cpu().clone()
                                for i, t in enumerate(toks[len(PROMPT):])])
    assert gens["cuda"].graphs.replays > 0
    _close(out["cuda"], out["cpu"], 1e-3)


def test_yarn_graphed_decode_on_the_card(cuda):
    """A YaRN config (factor 4, original context 32) past its original
    context on the card: the blended frequencies equal the CPU's, and the
    graphed greedy tokens equal the eager run's."""
    from eagle_tpu_torch.ops.rope import rope_freqs_cfg

    cfg = dataclasses.replace(TINY_CFG, rope_scaling="yarn", rope_scale_factor=4.0,
                              rope_orig_ctx=32)
    inv, ms = rope_freqs_cfg(cfg, device="cuda")
    inv_cpu, ms_cpu = rope_freqs_cfg(cfg, device="cpu")
    assert ms == ms_cpu > 1.0
    torch.testing.assert_close(inv.cpu(), inv_cpu, rtol=1e-6, atol=0)
    tp, _ = _tiny_bf16()
    runs = [Generator(tp, cfg, max_seq=256, kv_dtype=torch.bfloat16,
                      compute_dtype=torch.bfloat16, eos_id=-1, device="cuda",
                      cuda_graphs=graphed).generate(PROMPT * 3, max_new_tokens=40,
                                                    stop_at_eos=False)
            for graphed in (False, True)]
    assert runs[0] == runs[1]


# ---- the Llama-3 path (`-k llama3`) ------------------------------------------

#: (name, weight form, N, K, stacked) of the Llama-3.1-8B path's new qmm shapes
LLAMA3_SHAPES = [("wqkv", "q4k_packed_coded", 6144, 4096, True),
                 ("w_gate_up", "q4k_packed_coded", 28672, 4096, True),
                 ("w_down", "q4k_packed_coded", 4096, 14336, True),
                 ("lm_head", "q6k_int8_coded", 128256, 4096, False),
                 ("draft_fc", "q8_0_int8_f32", 4096, 8192, False)]


@pytest.mark.parametrize("rows", [1, 6, 300])
@pytest.mark.parametrize("name,form,n,k,stacked", LLAMA3_SHAPES,
                         ids=[s[0] for s in LLAMA3_SHAPES])
def test_llama3_qmm_shapes_every_route(cuda, name, form, n, k, stacked, rows):
    """qmm at the 8B path's new shapes, bf16: 1 row on the 1-row body, 6 on
    the small-row body, 300 on the wgmma body, each against the plain
    version (a 2-layer stack read at layer 1)."""
    w = WEIGHTS[form](cuda, n, k, 2 if stacked else None)
    x = torch.randn((rows, k), generator=cuda, device="cuda")
    _build.reset_counts()
    got = qmm_stacked(x, w, 1) if stacked else qmm(x, w)
    route = _counter("qmm", _route(rows, k, n, torch.bfloat16, tc_form(w)))
    assert route == {1: "qmm_gemv", 6: "qmm_mma", 300: "qmm_tc"}[rows]
    assert _build.launches[route] == 1 and _build.plain_calls["qmm"] == 0
    _close(got, qmm_plain(x, w.layer(1) if stacked else w), TOL[torch.bfloat16])


@pytest.mark.parametrize("name,t", [("flash_decode", 1), ("flash_decode", 6),
                                    ("flash_prefill", 64)])
def test_llama3_flash_gqa(cuda, name, t):
    """Both kernels at Llama-3-8B's g = 4 (32 query heads over 8 KV heads
    of 128, bf16 cache, 1,024 slots with a hole), against their plain
    versions."""
    b, h, h_kv, d, s = 1, 32, 8, 128, 1024
    kc = torch.randn((2, b, h_kv, s, d), generator=cuda, device="cuda").to(torch.bfloat16)
    vc = torch.randn((2, b, h_kv, s, d), generator=cuda, device="cuda").to(torch.bfloat16)
    tags = torch.arange(s, dtype=torch.int32, device="cuda")[None].clone()
    tags[:, 900 + t:] = -1
    tags[:, 100:140] = -1
    pos = (900 + torch.arange(t, dtype=torch.int32, device="cuda"))[None]
    q = torch.randn((b, t, h, d), generator=cuda, device="cuda")
    if name == "flash_decode":
        mask = causal_mask_from_tags(tags, pos)
        got = fa.flash_attention_cached(q, kc, vc, mask, 1)
        want = fa.flash_attention_cached_plain(q, kc, vc, mask, 1)
    else:
        got = fa.flash_attention_prefill(q, kc, vc, pos, tags, 1)
        want = fa.flash_attention_prefill_plain(q, kc, vc, pos, tags, 1)
    _close(got, want, TOL[torch.bfloat16])


def _nk_table(gen, v, d, g=16):
    """A tied head: int8 codes [V, D] and f32 scales [V, D / g], "nk" (the
    Q6_K embedding table as the loader gives it)."""
    q = torch.randint(-32, 32, (v, d), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand((v, d // g), generator=gen, device="cuda") * 2e-3 + 1e-3
    return QTensor(q=q, scale=scale, bias=None, group=g, ggml_type=int(Q6_K), layout="nk")


def test_llama3_nk_head_graphed_equals_eager(cuda):
    """A tiny target with a tied "nk" head and Llama-3.1 rope factors on the
    card: the head's product against its f32 plain version, and graphed
    greedy tokens equal to the eager run's past the factors' original
    context."""
    from eagle_tpu_torch.ops.matmul import qmatmul

    tp, _ = _tiny_bf16()
    head = _nk_table(cuda, TINY_CFG.vocab_size, TINY_CFG.n_embd)
    tp = dict(tp, tok_embd=head, output=head,
              rope_factors=torch.linspace(1.0, 8.0, TINY_CFG.head_dim // 2, device="cuda"))
    x = torch.randn((3, TINY_CFG.n_embd), generator=cuda, device="cuda")
    got = qmatmul(x, head, torch.bfloat16)
    assert got.dtype == torch.float32
    _close(got, x @ head.dequantize(torch.float32).T, TOL[torch.bfloat16])
    runs = [Generator(tp, TINY_CFG, max_seq=256, kv_dtype=torch.bfloat16,
                      compute_dtype=torch.bfloat16, eos_id=-1, device="cuda",
                      cuda_graphs=graphed).generate(PROMPT * 3, max_new_tokens=40,
                                                    stop_at_eos=False)
            for graphed in (False, True)]
    assert runs[0] == runs[1]
