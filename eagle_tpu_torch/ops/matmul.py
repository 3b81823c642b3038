"""Quantized matmul dispatch (port of eagle_tpu/ops/matmul.py: `qmatmul`,
`qmatmul_layer`, and `_qmatmul_xla` for "nk" QTensors).

Weights are logically [N, K]; activations [..., K]; result [..., N] with f32
accumulation. QTensors in the "kn" layout go through the `qmm` kernel
(ops/qmm.py), whose wrapper takes its plain version only for CPU tensors;
dense weights are a plain matmul. An "nk" QTensor (a tied head: the
embedding table of a file without `output.weight`) is dequantized and
multiplied as the reference does it, outside any Pallas kernel: the table
in the compute dtype, then one product with f32 accumulation."""

from __future__ import annotations

import torch

from ..quant.qtensor import QTensor
from .qmm import qmm, qmm_stacked

__all__ = ["qmatmul", "qmatmul_layer"]


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [N, K]^T -> [M, N] f32 from operands in one compute
    dtype, accumulated in f32: one cuBLAS product with an f32 output on the
    card; the CPU has none for bf16, so there the same values multiply in
    f32 (each product is exact there too)."""
    if w.dtype == torch.float32:
        return x @ w.T
    if x.is_cuda:
        return torch.mm(x, w.T, out_dtype=torch.float32)
    return x.float() @ w.float().T


def _qmatmul_nk(x: torch.Tensor, w: QTensor, compute_dtype) -> torch.Tensor:
    """x [..., K] @ w[N, K]^T for an "nk" QTensor (the reference's
    `_qmatmul_xla`): the codes times the scale (plus the bias) rounded to
    the compute dtype, then one product. The dequantized table is made per
    call, from the device's tensors only, so a CUDA graph captures it."""
    n, k = w.q.shape
    g = w.group
    scale, bias = w.effective_scale_bias()
    # int8 codes are exact in bf16: one rounding, of the product
    wd = w.q.reshape(n, k // g, g) * scale.to(compute_dtype)[:, :, None]
    if bias is not None:
        wd = wd + bias.to(compute_dtype)[:, :, None]
    out = _f32_product(x.reshape(-1, k).to(compute_dtype), wd.reshape(n, k))
    return out.reshape(*x.shape[:-1], n)


def qmatmul(x: torch.Tensor, w: QTensor | torch.Tensor,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x [..., K] @ w[N, K]^T -> [..., N] f32."""
    if not isinstance(w, QTensor):
        return (x.to(compute_dtype) @ w.to(compute_dtype).T).float()
    if w.layout == "nk":  # never packed: the serving prep packs only "kn"
        return _qmatmul_nk(x, w, compute_dtype)
    return qmm(x, w, compute_dtype)


def qmatmul_layer(x: torch.Tensor, w, layer_idx: int,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Matmul against layer `layer_idx` of LAYER-STACKED weights, read in
    place. A single-layer stack (the EAGLE draft) takes the 2-D entry on its
    only layer, as the reference does (matmul.py:98-103)."""
    if isinstance(w, QTensor) and w.q.dim() == 3 and w.q.shape[0] == 1:
        return qmatmul(x, w.layer(0), compute_dtype)
    if isinstance(w, QTensor):
        if w.layout == "nk":
            return qmatmul(x, w.layer(layer_idx), compute_dtype)
        return qmm_stacked(x, w, layer_idx, compute_dtype)
    return qmatmul(x, w[layer_idx], compute_dtype)
