"""The port's plain qmm (the CPU path and the plain version of the qmm CUDA
kernel) against the JAX Pallas qmm kernels run in interpret mode, for every
branch of the kernel: packed / unpacked q, coded / materialized (f32, bf16)
scales, bias present / absent, G = 32 and 16, 2-D and layer-stacked.

Tolerance: f32 compute, rtol 1e-5 (atol 1e-5 of the output's scale): the two
sum the same f32 products in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.gguf.constants import GGMLType
from eagle_tpu.models.synth import synth_qtensor
from eagle_tpu.ops.pallas_qmm import qmatmul_pallas, qmatmul_pallas_2d, qmatmul_pallas_stacked
from eagle_tpu_torch import _build
from eagle_tpu_torch.convert import params_from_numpy
from eagle_tpu_torch.ops.matmul import qmatmul, qmatmul_layer
from eagle_tpu_torch.ops.qmm import qmm, qmm_stacked
from torch_port_util import qtensor_to_numpy

# (qtype, packed, coded, scale dtype, keep bias)
BRANCHES = {
    "q4k_packed_coded_bias": (GGMLType.Q4_K, True, True, jnp.float32, True),
    "q4k_packed_f32_bias": (GGMLType.Q4_K, True, False, jnp.float32, True),
    "q4k_packed_bf16_bias": (GGMLType.Q4_K, True, False, jnp.bfloat16, True),
    "q4k_int8_coded_bias": (GGMLType.Q4_K, False, True, jnp.float32, True),
    "q4k_int8_f32_nobias": (GGMLType.Q4_K, False, False, jnp.float32, False),
    "q4k_packed_coded_nobias": (GGMLType.Q4_K, True, True, jnp.float32, False),
    "q6k_int8_coded_g16": (GGMLType.Q6_K, False, True, jnp.float32, True),
    "q6k_int8_bf16_g16": (GGMLType.Q6_K, False, False, jnp.bfloat16, True),
}


def _weight(rng, branch, stack=None, n=256, k=512):
    qtype, packed, coded, sdt, keep_bias = BRANCHES[branch]
    ref = synth_qtensor(rng, n, k, qtype, packed=packed, coded=coded, scale_dtype=sdt,
                        stack=stack)
    if not keep_bias:
        ref = dataclasses.replace(ref, bias=None, sup_min=None)
    return ref, params_from_numpy(qtensor_to_numpy(ref), "cpu")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("rows", [1, 3, 9])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_qmm_2d_matches_pallas(rng, branch, rows):
    ref, w = _weight(rng, branch)
    x = rng.standard_normal((rows, 512)).astype(np.float32)
    want = qmatmul_pallas(jnp.asarray(x), ref, compute_dtype=jnp.float32, interpret=True)
    before = _build.plain_calls["qmm"]
    got = qmm(torch.from_numpy(x), w, compute_dtype=torch.float32)
    assert _build.plain_calls["qmm"] == before + 1  # CPU tensors take the plain version
    _close(got, want)


@pytest.mark.parametrize("branch", ["q4k_packed_coded_bias", "q4k_packed_f32_bias",
                                    "q6k_int8_coded_g16"])
def test_qmm_stacked_matches_pallas(rng, branch):
    ref, w = _weight(rng, branch, stack=3)
    x = rng.standard_normal((4, 512)).astype(np.float32)
    for li in (1, 2):
        want = qmatmul_pallas_stacked(jnp.asarray(x), ref, jnp.int32(li),
                                      compute_dtype=jnp.float32, interpret=True)
        _close(qmm_stacked(torch.from_numpy(x), w, li, compute_dtype=torch.float32), want)


def test_qmatmul_layer_single_stack_and_nd(rng):
    """A single-layer stack (the EAGLE draft) goes through the 2-D entry;
    leading dims flatten and come back."""
    ref, w = _weight(rng, "q4k_packed_f32_bias", stack=1)
    x = rng.standard_normal((2, 3, 512)).astype(np.float32)
    ref0 = jax.tree_util.tree_map(lambda a: a[0], ref)
    want = qmatmul_pallas(jnp.asarray(x), ref0, compute_dtype=jnp.float32, interpret=True)
    got = qmatmul_layer(torch.from_numpy(x), w, 0, compute_dtype=torch.float32)
    assert got.shape == (2, 3, 256)
    _close(got, want)


def test_qmm_bf16_compute_rounding_points(rng):
    """bf16 compute rounds w = q*scale, x and the bias side product at the
    Pallas kernel's points (the XLA path instead adds the bias into the bf16
    weight): within bf16 summation-order noise of the interpret kernel."""
    ref, w = _weight(rng, "q4k_packed_coded_bias")
    x = rng.standard_normal((3, 512)).astype(np.float32)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), ref, compute_dtype=jnp.bfloat16,
                                     interpret=True))
    got = qmm(torch.from_numpy(x), w, compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_dense_weight_matmul(rng):
    wd = rng.standard_normal((64, 128)).astype(np.float32)
    x = rng.standard_normal((2, 128)).astype(np.float32)
    got = qmatmul(torch.from_numpy(x), torch.from_numpy(wd), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), x @ wd.T, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the tensor-core body's planner, routing and x prologue (no card needed)
# ---------------------------------------------------------------------------

from eagle_tpu_torch.ops.qmm import (TcForm, _gemv_layout, _gemv_plan,  # noqa: E402
                                     _mma_layout, _mma_plan, _route, _tc_layout, _tc_plan,
                                     x_prologue_plain)

# (q form, scale bytes, coded, bias bytes): every form the body takes
TC_FORMS = {
    "packed_coded": TcForm("packed", 1, True, 1),
    "packed_f32": TcForm("packed", 4, False, 4),
    "packed_bf16_nobias": TcForm("packed", 2, False, 0),
    "int8_coded": TcForm("int8", 1, True, 1),
    "int8_f32": TcForm("int8", 4, False, 0),
    "int8_bf16": TcForm("int8", 2, False, 2),
    "int4_f32_bias": TcForm("int4", 4, False, 4),
    "int4_bf16_nobias": TcForm("int4", 2, False, 0),
}
# (N, K) of every product the prefill runs at Vicuna-7B width, and the EAGLE fc
MAIN_SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096), "w_gate_up": (22016, 4096),
               "w_down": (4096, 11008), "lm_head": (32000, 4096), "fc_w": (4096, 8192)}


def _groups(form):
    return (16, 32) if form.coded or form.q == "int4" else (8, 16, 32)


@pytest.mark.parametrize("rows", [9, 37, 64, 65, 300, 512])
@pytest.mark.parametrize("form", sorted(TC_FORMS))
def test_tc_plan_fits_and_covers(form, rows):
    """Shared memory within 227 KB; the row and column tiles cover [B, N];
    the K splits cover K exactly once, on 256-row boundaries (whole groups,
    whole sup rows), with the groups per split that G gives."""
    f = TC_FORMS[form]
    for n, k in list(MAIN_SHAPES.values()) + [(400, 1280), (256, 512)]:
        for g in _groups(f):
            p = _tc_plan(rows, k, n, g, f)
            assert p.smem_bytes == _tc_layout(p.rows, g, f, p.stages) <= 232448
            assert p.stages in (3, 4) and p.rows == (64 if rows <= 64 else 128)
            assert -(-rows // p.rows) * p.rows >= rows and p.cols == 256
            steps = k // 64
            assert p.splits * p.steps_per_split >= steps > (p.splits - 1) * p.steps_per_split
            assert p.splits == 1 or p.steps_per_split % 4 == 0
            assert p.groups_per_split * g == p.steps_per_split * 64


@pytest.mark.parametrize("name", sorted(MAIN_SHAPES))
def test_tc_plan_fills_the_card(name):
    """Every main-path product at 512 rows (and qmm_i4's 37-row case) puts a
    block on at least 90 % of the 132 SMs, and 4 stages fit its forms."""
    n, k = MAIN_SHAPES[name]
    cases = [(512, TC_FORMS["packed_coded"], 32), (512, TC_FORMS["packed_f32"], 32),
             (512, TC_FORMS["int8_f32"], 32), (37, TC_FORMS["int4_bf16_nobias"], 32),
             (512, TC_FORMS["int4_f32_bias"], 32)]
    for rows, f, g in cases:
        p = _tc_plan(rows, k, n, g, f)
        blocks = -(-n // p.cols) * -(-rows // p.rows) * p.splits
        assert blocks >= 0.9 * 132, (name, rows, p)
        assert p.stages == 4


def test_tc_plan_refuses_shapes_the_body_cannot_take():
    f = TC_FORMS["packed_f32"]
    for k, n, g in ((288, 256, 32), (512, 264, 32), (512, 256, 64)):
        with pytest.raises(ValueError, match="tensor-core"):
            _tc_plan(37, k, n, g, f)


@pytest.mark.parametrize("rows", [1, 2, 7, 8, 9, 37, 512])
def test_route(rows):
    """At shapes every body takes: bf16 at 1 row takes the 1-row tensor-core
    body (qmm only; qmm_i4 keeps the SIMT body there), at 2-8 rows the
    small-row one and above 8 rows the wgmma body, in qmm and qmm_i4 alike;
    f32 compute the SIMT body."""
    for n, k in MAIN_SHAPES.values():
        for form in TC_FORMS.values():
            want = ("tc" if rows > 8 else "mma" if rows > 1
                    else "simt" if form.q == "int4" else "gemv")
            assert _route(rows, k, n, torch.bfloat16, form) == want
            assert _route(rows, k, n, torch.float32, form) == "simt"


@pytest.mark.parametrize("rows", [1, 2, 6, 8, 9, 37, 64])
@pytest.mark.parametrize("k,n", [(4096, 4001), (4096, 4100), (4128, 4096), (4096, 100),
                                 (512, 250)])
def test_route_ragged_shapes(k, n, rows):
    """Shapes the tensor-core bodies cannot address (N % 16 != 0, K % 64 !=
    0; N % 4 != 0 among them) take the SIMT body at every row count, decided
    from the shape before any launch."""
    for form in TC_FORMS.values():
        for dt in (torch.bfloat16, torch.float32):
            assert _route(rows, k, n, dt, form) == "simt"


# the fused FFN and draft shapes (N, K) beside the target's
MMA_SHAPES = {**MAIN_SHAPES, "ffn_wo": (4096, 4096), "draft_gate_up": (22016, 4096),
              "small": (400, 1280), "tiny": (256, 512)}
# the small-row body takes every form (qmm's and qmm_i4's), the 1-row body
# every form but int4
MMA_FORMS = TC_FORMS
GEMV_FORMS = {name: f for name, f in TC_FORMS.items() if f.q != "int4"}


def _cxx_mma_layout(rows, group, f, steps_per_split):
    """csrc/qmm_mma.cuh:mma_layout's total, line by line (kMmaK 64, 256
    columns, 3 stages): the ring stage's q, scale, sup, bias and sup_min
    rows rounded to 128 bytes, the bf16 B tile, qmm's side tile (a bias,
    not int4), the x rows and qmm's group sums."""
    up = lambda v, m: -(-v // m) * m
    scale = (64 if f.q == "int8" else 32) * 256
    sup = scale + (64 // group) * 256 * f.scale_bytes
    bias = sup + (256 * 4 if f.coded else 0)
    sup_min = bias + (64 // group) * 256 * f.bias_bytes
    stage = up(sup_min + (256 * 4 if f.coded and f.bias_bytes else 0), 128)
    side = bool(f.bias_bytes) and f.q != "int4"
    bside = 3 * stage + 64 * 256 * 2
    x = bside + (16 * 256 * 2 if side else 0)
    xside = x + rows * steps_per_split * 64 * 2
    return xside + (rows * up(steps_per_split * 2, 8) * 16 if side else 0)


@pytest.mark.parametrize("rows", [2, 3, 6, 8, 9, 33, 64])
@pytest.mark.parametrize("form", sorted(MMA_FORMS))
def test_mma_plan_fits_and_covers(form, rows):
    """The small-row body's plan: shared memory within 227 KB and equal to
    the layout; one block column holds every row and the column tiles cover
    N; the K splits cover K exactly once, on 64-row steps (whole groups),
    on 256-row boundaries for coded weights (whole sup rows), with the
    groups per split that G gives; the paired pass takes the same plan. The
    layout is the C++ one (`_cxx_mma_layout`): int4 holds its bias rows in
    the stage and no side tile or group sums."""
    f = MMA_FORMS[form]
    for n, k in MMA_SHAPES.values():
        for g in _groups(f):
            p = _mma_plan(rows, k, n, g, f)
            assert p.smem_bytes == _mma_layout(rows, g, f, p.steps_per_split) <= 232448
            assert p.smem_bytes == _cxx_mma_layout(rows, g, f, p.steps_per_split)
            assert p.cols == 256 and -(-n // p.cols) * p.cols >= n and p.stages == 3
            steps = k // 64
            assert p.splits * p.steps_per_split >= steps > (p.splits - 1) * p.steps_per_split
            assert not f.coded or p.steps_per_split % 4 == 0
            assert p.groups_per_split * g == p.steps_per_split * 64
            if n % 256 == 0:
                assert _mma_plan(rows, k, n, g, f, paired=True) == p


@pytest.mark.parametrize("rows", [2, 6, 8, 33, 64])
@pytest.mark.parametrize("name", sorted(MMA_SHAPES))
def test_mma_plan_fills_the_card(name, rows):
    """Every main-path product (the target's, the fused FFN's and the
    draft's) puts at least one block on each of the 132 SMs, in every form,
    and two blocks fit an SM at verify rows."""
    n, k = MMA_SHAPES[name]
    if n * k < 4096 * 4096:
        return  # the small test shapes have fewer tiles x steps than SMs
    for f in MMA_FORMS.values():
        p = _mma_plan(rows, k, n, 32, f)
        assert -(-n // p.cols) * p.splits >= 132, (name, rows, p)
        assert rows > 8 or p.smem_bytes <= 232448 // 2, (name, rows, p)


def test_mma_plan_refuses_shapes_the_body_cannot_take():
    """Rows outside 1-64, K % 64, N % 16 (N % 256 paired), G outside (8,
    16, 32), and int4 at G = 8 (qmm_i4's groups are 16 and 32); int4 at G
    16 and 32 is taken."""
    f = MMA_FORMS["packed_f32"]
    i4 = TC_FORMS["int4_f32_bias"]
    for b, k, n, g in ((0, 512, 256, 32), (65, 512, 256, 32), (6, 288, 256, 32),
                       (6, 512, 264, 32), (6, 512, 256, 64)):
        for form in (f, i4):
            with pytest.raises(ValueError, match="small-row"):
                _mma_plan(b, k, n, g, form)
    with pytest.raises(ValueError, match="small-row"):
        _mma_plan(6, 512, 384, 32, f, paired=True)  # gate/up halves of 128 columns
    with pytest.raises(ValueError, match="small-row"):
        _mma_plan(6, 512, 256, 8, i4)
    for g in (16, 32):
        assert _mma_plan(6, 512, 256, g, i4).splits >= 1


# (N, K) of every 1-row product on the decode paths: the target's, the fused
# FFN's wo and the draft's, beside two small test shapes
GEMV_SHAPES = {**MMA_SHAPES, "draft_wqkv": (12288, 4096)}


@pytest.mark.parametrize("form", sorted(GEMV_FORMS))
def test_gemv_plan_fits_and_covers(form):
    """The 1-row body's plan: shared memory within 227 KB and equal to the
    layout, 3 ring stages (2 where 3 do not fit); the column tiles cover N;
    the K splits
    cover K exactly once, on 64-row steps (whole groups), on 256-row
    boundaries for coded weights (whole sup rows), with the groups per split
    that G gives."""
    f = GEMV_FORMS[form]
    for n, k in GEMV_SHAPES.values():
        for g in _groups(f):
            p = _gemv_plan(k, n, g, f)
            assert p.smem_bytes == _gemv_layout(g, f, p.stages, p.steps_per_split) <= 232448
            assert p.stages in (2, 3) and p.cols == 256 and -(-n // p.cols) * p.cols >= n
            steps = k // 64
            assert p.splits * p.steps_per_split >= steps > (p.splits - 1) * p.steps_per_split
            assert not f.coded or p.steps_per_split % 4 == 0
            assert p.groups_per_split * g == p.steps_per_split * 64


@pytest.mark.parametrize("name", sorted(GEMV_SHAPES))
def test_gemv_plan_fills_the_card(name):
    """Every main-path 1-row product, in every form, puts about two blocks
    on each of the 132 SMs (at least 1.9 x 132 where the shape has that many
    tiles and steps, and a block on every SM in any case), with 3 ring
    stages, in shared memory that lets three blocks (the kernel's register
    cap) share an SM."""
    n, k = GEMV_SHAPES[name]
    if n * k < 4096 * 4096:
        return  # the small test shapes have fewer tiles x steps than SMs
    for f in GEMV_FORMS.values():
        p = _gemv_plan(k, n, 32, f)
        tiles = -(-n // p.cols)
        units = k // 64 // (4 if f.coded else 1)
        blocks = tiles * p.splits
        assert blocks >= min(1.9 * 132, tiles * units) and blocks >= 132, (name, f, p)
        assert p.stages == 3 and 3 * (p.smem_bytes + 1024) <= 233472, (name, f, p)


def test_gemv_plan_refuses_shapes_the_body_cannot_take():
    """The 1-row body refuses K % 64 != 0, N % 16 != 0, G outside (8, 16, 32)
    and int4 weights, and `_route` sends none of them there, nor more than
    one row."""
    f = GEMV_FORMS["packed_f32"]
    for k, n, g in ((288, 256, 32), (512, 264, 32), (512, 256, 64)):
        with pytest.raises(ValueError, match="gemv"):
            _gemv_plan(k, n, g, f)
    with pytest.raises(ValueError, match="gemv"):
        _gemv_plan(512, 256, 32, TC_FORMS["int4_f32_bias"])
    assert _route(1, 512, 256, torch.bfloat16, TC_FORMS["int4_f32_bias"]) == "simt"
    for b in (2, 6, 8):
        assert _route(b, 512, 256, torch.bfloat16, f) != "gemv"
    for k, n in ((288, 256), (512, 264)):
        assert _route(1, k, n, torch.bfloat16, f) == "simt"


@pytest.mark.parametrize("rows", [1, 3, 9])
@pytest.mark.parametrize("n", [250, 100])
@pytest.mark.parametrize("branch", ["q4k_packed_coded_bias", "q4k_int8_f32_nobias",
                                    "q6k_int8_bf16_g16"])
def test_qmm_plain_ragged_n_matches_pallas(rng, branch, n, rows):
    """The widths the kernels now take (N % 4 != 0, N % 16 != 0; the SIMT
    body on the card): the plain version against the reference's 2-D kernel,
    which takes a whole-N tile there (pallas_qmm.py:426-427)."""
    ref, w = _weight(rng, branch, n=n)
    x = rng.standard_normal((rows, 512)).astype(np.float32)
    want = qmatmul_pallas_2d(jnp.asarray(x), ref, compute_dtype=jnp.float32, interpret=True)
    got = qmm(torch.from_numpy(x), w, compute_dtype=torch.float32)
    assert tuple(got.shape) == (rows, n)
    _close(got, want)


@pytest.mark.parametrize("group", [8, 16, 32])
def test_x_prologue_plain_matches_reference_group_sums(rng, group):
    """The prologue's plain version: x rounded to bf16 as JAX rounds it, and
    the group sums of the unrounded x (the reference's side-product operand,
    pallas_qmm.py: x.reshape(b, k // g, g).sum(-1), cast to the compute
    dtype) within one bf16 rounding (the two sum in another order)."""
    x = (rng.standard_normal((37, 512)) * 3).astype(np.float32)
    xb, xs = x_prologue_plain(torch.from_numpy(x), group, True)
    want_x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(xb.float().numpy(), want_x)
    want = np.asarray(jnp.asarray(x).reshape(37, 512 // group, group).sum(axis=-1)
                      .astype(jnp.bfloat16).astype(jnp.float32))
    got = xs.float().numpy()
    assert got.shape == (37, 512 // group) and xs.dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)
    assert x_prologue_plain(torch.from_numpy(x), group, False)[1] is None
