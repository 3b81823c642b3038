"""The port's int4 form and qmm_i4 (the CPU path and the plain version of
the qmm_i4 CUDA kernel) against the JAX package's int4-dtype Pallas kernels
run in interpret mode (`qmatmul_pallas_2d_i4`, `qmatmul_pallas_stacked_i4`),
and the port's plain qmm at G = 8 (the IQ1_M form) against `qmatmul_pallas`.

The weights cross over through `convert.params_from_numpy` from the JAX
QTensor, whose int4 `q` arrives as ml_dtypes int4, so the conversion into
the port's two-per-byte int4 form is tested too. K = 4096 spans two of the
reference's 2048-deep K tiles.

Tolerance: max abs error <= 1e-5 x max |reference|. The two round at the
same points (q, scale, bias, the product, the sum and x in the compute
dtype), so only the f32 summation order differs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.gguf.constants import GGMLType as J
from eagle_tpu.ops.pallas_qmm import (qmatmul_pallas, qmatmul_pallas_2d_i4,
                                      qmatmul_pallas_stacked, qmatmul_pallas_stacked_i4)
from eagle_tpu.quant.qtensor import QTensor as JQTensor
from eagle_tpu.quant.qtensor import repack_numpy
from eagle_tpu_torch import _build
from eagle_tpu_torch.convert import params_from_numpy
from eagle_tpu_torch.ops.qmm import qmm, qmm_i4, qmm_i4_stacked, qmm_stacked
from eagle_tpu_torch.quant.qtensor import QTensor, pack_int4
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    background_cpu, qtensor_to_numpy, random_blocks,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

K, N = 4096, 256
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _int4_ref(rng, group, bias, stack=None, n=N):
    """A reference int4 QTensor (bf16 scale and bias, as kernel_bench makes
    them) and its port counterpart through params_from_numpy."""
    lead = () if stack is None else (stack,)
    q = rng.integers(-8, 8, size=lead + (K, n)).astype(np.int8)
    s = (rng.standard_normal(lead + (K // group, n)) * 0.01).astype(np.float32)
    b = (rng.standard_normal(lead + (K // group, n)) * 0.001).astype(np.float32)
    ref = JQTensor(q=jnp.asarray(q).astype(jnp.int4), scale=jnp.asarray(s, jnp.bfloat16),
                   bias=jnp.asarray(b, jnp.bfloat16) if bias else None, group=group,
                   layout="kn")
    return ref, params_from_numpy(qtensor_to_numpy(ref), "cpu"), q


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_qmm_i4_matches_pallas(rng, rows, group, bias, dtype):
    jdt, tdt = DTYPES[dtype]
    ref, w, _ = _int4_ref(rng, group, bias)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    want = qmatmul_pallas_2d_i4(jnp.asarray(x), ref, compute_dtype=jdt, interpret=True)
    before = _build.plain_calls["qmm_i4"]
    got = qmm_i4(torch.from_numpy(x), w, compute_dtype=tdt)
    assert _build.plain_calls["qmm_i4"] == before + 1  # CPU tensors take the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, N)
    _close(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("group", [16, 32])
def test_qmm_i4_stacked_matches_pallas(rng, group, dtype):
    jdt, tdt = DTYPES[dtype]
    ref, w, _ = _int4_ref(rng, group, True, stack=3)
    x = rng.standard_normal((4, K)).astype(np.float32)
    for li in (0, 2):
        want = qmatmul_pallas_stacked_i4(jnp.asarray(x), ref, jnp.int32(li), compute_dtype=jdt,
                                         interpret=True)
        _close(qmm_i4_stacked(torch.from_numpy(x), w, li, compute_dtype=tdt), want)


def test_int4_form(rng):
    """4 bits per weight in the (j, j + G/2) pairing; unpack gives int8 in
    [-8, 7]; layer(i) and tensors() work as on the other forms."""
    ref, w, q = _int4_ref(rng, 32, True, stack=2)
    assert w.int4 and not w.packed
    assert w.q.dtype == torch.int8 and tuple(w.q.shape) == (2, K // 2, N)
    assert w.shape == (N, K) and w.layer(1).shape == (N, K)
    assert set(w.tensors()) == {"q", "scale", "bias", "sup", "sup_min"}
    for i in range(2):
        lw = w.layer(i)
        assert lw.int4 and lw.q.data_ptr() == w.q[i].data_ptr()  # a view
        np.testing.assert_array_equal(lw.unpack().q.numpy(), q[i])
    # the pairing: packed row j of group g holds K rows g*G + j (lo), + G/2 (hi)
    p = w.q[0].view(torch.uint8).numpy()
    np.testing.assert_array_equal(p[3] & 0xF, q[0, 3] & 0xF)
    np.testing.assert_array_equal(p[3] >> 4, q[0, 3 + 16] & 0xF)
    np.testing.assert_array_equal(p[16 + 3] >> 4, q[0, 32 + 3 + 16] & 0xF)
    assert torch.equal(pack_int4(torch.from_numpy(q), 32), w.q)
    # dense [N, K] = q * scale + bias in f32, as the reference's dequantize
    ref0 = JQTensor(q=ref.q[1], scale=ref.scale[1], bias=ref.bias[1], group=32, layout="kn")
    np.testing.assert_array_equal(w.layer(1).dequantize().numpy(), np.asarray(ref0.dequantize()))


def test_qmm_refuses_int4_weights(rng):
    _, w, _ = _int4_ref(rng, 32, True)
    with pytest.raises(ValueError, match="qmm_i4"):
        qmm(torch.zeros((1, K)), w)


def _iq1_m_ref(rng, n, k, stack=None):
    """An IQ1_M weight (groups of 8, f32 scale and bias) from the reference's
    repack of random blocks, "kn", optionally stacked."""
    def one():
        q, s, b, g = repack_numpy(random_blocks(rng, J.IQ1_M, n, k), J.IQ1_M, (n, k),
                                  use_native=False)
        assert g == 8
        return q.T, s.T, b.T

    parts = [one() for _ in range(stack or 1)]
    arrs = [np.ascontiguousarray(np.stack(a) if stack else a[0]) for a in zip(*parts)]
    return JQTensor(q=jnp.asarray(arrs[0]), scale=jnp.asarray(arrs[1]), bias=jnp.asarray(arrs[2]),
                    group=8, ggml_type=int(J.IQ1_M), layout="kn")


@pytest.mark.parametrize("rows", [1, 3, 9])
def test_qmm_plain_g8_matches_pallas(rng, rows):
    ref = _iq1_m_ref(rng, 256, 512)
    w = params_from_numpy(qtensor_to_numpy(ref), "cpu")
    assert w.group == 8
    x = rng.standard_normal((rows, 512)).astype(np.float32)
    want = qmatmul_pallas(jnp.asarray(x), ref, compute_dtype=jnp.float32, interpret=True)
    _close(qmm(torch.from_numpy(x), w, compute_dtype=torch.float32), want)


def test_qmm_plain_g8_stacked_matches_pallas(rng):
    ref = _iq1_m_ref(rng, 256, 512, stack=2)
    w = params_from_numpy(qtensor_to_numpy(ref), "cpu")
    x = rng.standard_normal((4, 512)).astype(np.float32)
    for li in (0, 1):
        want = qmatmul_pallas_stacked(jnp.asarray(x), ref, jnp.int32(li),
                                      compute_dtype=jnp.float32, interpret=True)
        _close(qmm_stacked(torch.from_numpy(x), w, li, compute_dtype=torch.float32), want)


def test_int4_concat_needs_one_form(rng):
    from eagle_tpu_torch.quant.qtensor import concat_qtensors

    _, w, _ = _int4_ref(rng, 32, True)
    fused = concat_qtensors([w, w])
    assert fused.int4 and fused.shape == (2 * N, K)
    with pytest.raises(ValueError):
        concat_qtensors([w, dataclasses.replace(w, int4=False)])
    assert isinstance(fused, QTensor)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("rows", [9, 37, 70])
def test_qmm_i4_prefill_rows_match_pallas(rng, rows, group, bias):
    """The row counts that take the tensor-core body on the card (more than
    8, bf16): the plain version against the reference's interpret-mode
    kernel at bf16, ragged 64- and 128-row tiles included."""
    ref, w, _ = _int4_ref(rng, group, bias)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    want = qmatmul_pallas_2d_i4(jnp.asarray(x), ref, compute_dtype=jnp.bfloat16, interpret=True)
    got = qmm_i4(torch.from_numpy(x), w, compute_dtype=torch.bfloat16)
    assert tuple(got.shape) == (rows, N)
    _close(got, want)


@pytest.mark.parametrize("rows", [1, 3, 9])
@pytest.mark.parametrize("n", [250, 100])
def test_qmm_i4_plain_ragged_n_matches_pallas(rng, n, rows):
    """The widths qmm_i4 now takes (N % 4 != 0, N % 16 != 0; the SIMT body
    on the card): the plain version against the reference's 2-D kernel,
    which takes a whole-N tile there (pallas_qmm.py:574), at bf16."""
    ref, w, _ = _int4_ref(rng, 32, True, n=n)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    want = qmatmul_pallas_2d_i4(jnp.asarray(x), ref, compute_dtype=jnp.bfloat16, interpret=True)
    got = qmm_i4(torch.from_numpy(x), w, compute_dtype=torch.bfloat16)
    assert tuple(got.shape) == (rows, n)
    _close(got, want)
