"""The port's kernel benchmark (eagle_tpu_torch/tools/kernel_bench.py), the
entry point of the int4 slice, on the CPU: every ported variant runs and
checks against its plain version, the TPU-only variants raise, and the
whole slice agrees with the reference. The weights are the reference
kernel_bench's draws from `np.random.default_rng(0)`, and each variant's
output equals the reference's kernel for that variant run in interpret
mode on the same weights:

    packed, int8, coded  qmatmul_pallas
    stacked              qmatmul_pallas_stacked_nd
    split4               four qmatmul_pallas calls, concatenated
    int4                 qmatmul_pallas_2d_i4
    i4stacked            qmatmul_pallas_stacked_i4
    dense                dot_general of bf16 operands, f32 result

Tolerances (bf16 compute, as the benchmark runs), relative to the largest
|value|: 1e-5 for the int4 kernels (the same rounding points, another f32
summation order); 1e-4 for qmm, whose bias side product sums x per group
in f32 in another order before rounding it to bf16; 1e-2 for dense, whose
torch.matmul rounds its output to bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.ops.pallas_qmm import (qmatmul_pallas, qmatmul_pallas_2d_i4,
                                      qmatmul_pallas_stacked_i4, qmatmul_pallas_stacked_nd)
from eagle_tpu.quant.qtensor import QTensor as JQTensor
from eagle_tpu_torch.tools import kernel_bench as kb

K, N, B, G = 256, 256, 2, 32
SMALL = ["--device", "cpu", "--k", str(K), "--n", str(N), "--b", str(B)]


def test_every_ported_variant_runs_on_the_cpu(capsys):
    assert kb.main(SMALL + ["--variants", ",".join(kb.VARIANTS)]) == 0
    out = capsys.readouterr().out
    for name in kb.VARIANTS:
        assert f"{name}: within " in out
    assert "nothing timed" in out


@pytest.mark.parametrize("name", list(kb.TPU_ONLY) + ["no_such_variant"])
def test_tpu_only_and_unknown_variants_raise(name):
    with pytest.raises(ValueError, match="TPU" if name in kb.TPU_ONLY else "unknown"):
        kb.main(SMALL + ["--variants", f"packed,{name}"])


def _reference_arrays():
    """The reference kernel_bench's host arrays, in its order (its lines
    48-51, 72-74 and 131-134)."""
    rng = np.random.default_rng(0)
    q_codes = rng.integers(0, 16, size=(K, N), dtype=np.int8)
    scale = (rng.standard_normal((K // G, N)) * 0.01).astype(np.float32)
    bias = (rng.standard_normal((K // G, N)) * 0.001).astype(np.float32)
    w_dense = (rng.standard_normal((K, N)) * 0.01).astype(np.float32)
    x0 = (rng.standard_normal((B, K)) * 0.1).astype(np.float32)
    codes = rng.integers(1, 64, size=(K // G, N)).astype(np.int8)
    mcodes = rng.integers(0, 64, size=(K // G, N)).astype(np.int8)
    sup = (np.abs(rng.standard_normal((K // 256, N))) * 0.01 + 1e-3).astype(np.float32)
    supm = (np.abs(rng.standard_normal((K // 256, N))) * 1e-3).astype(np.float32)
    return dict(q_codes=q_codes, scale=scale, bias=bias, w_dense=w_dense, x=x0, codes=codes,
                mcodes=mcodes, sup=sup, sup_min=supm)


def _reference_outputs(a):
    """Each variant's output from the reference's kernels, built as the
    reference kernel_bench builds its weights."""
    bf = jnp.bfloat16
    sbf, bbf = jnp.asarray(a["scale"], bf), jnp.asarray(a["bias"], bf)
    q_np = a["q_codes"].astype(np.uint8).reshape(K // G, G, N)
    packed = (q_np[:, :G // 2] | (q_np[:, G // 2:] << 4)).reshape(K // 2, N).view(np.int8)
    qt_packed = JQTensor(q=jnp.asarray(packed), scale=sbf, bias=bbf, group=G, layout="kn",
                         packed=True)
    qt_int8 = JQTensor(q=jnp.asarray(a["q_codes"]), scale=sbf, bias=bbf, group=G, layout="kn")
    qt_coded = JQTensor(q=jnp.asarray(packed), scale=jnp.asarray(a["codes"]),
                        bias=jnp.asarray(a["mcodes"]), group=G, layout="kn", packed=True,
                        sup=jnp.asarray(a["sup"]), sup_min=jnp.asarray(a["sup_min"]))
    qt_i4 = JQTensor(q=(qt_int8.q - 8).astype(jnp.int4), scale=sbf, bias=bbf, group=G,
                     layout="kn")
    qt_st = JQTensor(q=jnp.asarray(np.stack([packed] * 2)), scale=jnp.stack([sbf] * 2),
                     bias=jnp.stack([bbf] * 2), group=G, layout="kn", packed=True)
    b2 = np.stack([a["bias"] + 8.0 * a["scale"]] * 2).astype(np.float32)
    qt_i4st = JQTensor(q=jnp.asarray(np.stack([a["q_codes"]] * 2) - 8).astype(jnp.int4),
                       scale=jnp.stack([sbf] * 2), bias=jnp.asarray(b2, bf), group=G,
                       layout="kn")
    x = jnp.asarray(a["x"])

    def quarter(i):
        return jax.tree_util.tree_map(lambda t: t[:, i * N // 4:(i + 1) * N // 4], qt_packed)

    return {
        "dense": jax.lax.dot_general(x.astype(bf), jnp.asarray(a["w_dense"], bf),
                                     (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32),
        "packed": qmatmul_pallas(x, qt_packed, interpret=True),
        "int8": qmatmul_pallas(x, qt_int8, interpret=True),
        "coded": qmatmul_pallas(x, qt_coded, interpret=True),
        "stacked": qmatmul_pallas_stacked_nd(x, qt_st, jnp.int32(1), interpret=True),
        "split4": jnp.concatenate([qmatmul_pallas(x, quarter(i), interpret=True)
                                   for i in range(4)], axis=-1),
        "int4": qmatmul_pallas_2d_i4(x, qt_i4, interpret=True),
        "i4stacked": qmatmul_pallas_stacked_i4(x, qt_i4st, jnp.int32(1), interpret=True),
    }


TOL = {"dense": 1e-2, "int4": 1e-5, "i4stacked": 1e-5}


def test_slice_matches_the_reference():
    a = _reference_arrays()
    ported = kb.make_inputs(K, N, B, G, coded=True)
    for key, want in a.items():
        np.testing.assert_array_equal(ported[key], want, err_msg=key)
    args = kb.parse_args(SMALL + ["--variants", ",".join(kb.VARIANTS)])
    bench = kb.Bench(args, list(kb.VARIANTS), torch.device("cpu"))
    ref = _reference_outputs(a)
    for name in kb.VARIANTS:
        got = bench.runner(name, 1)(bench.x, 1).float().numpy()
        want = np.asarray(ref[name])
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        assert got.shape == (B, N) and err <= TOL.get(name, 1e-4), (name, err)
