"""Fused dequant + matmul: the `qmm` CUDA kernel (csrc/qmm.cu), its wrapper
and its plain PyTorch version.

Replaces eagle_tpu/ops/pallas_qmm.py:_qmm_kernel, reached there through
`qmatmul_pallas` / `qmatmul_pallas_2d` (2-D weights: lm_head, EAGLE fc_w) and
`qmatmul_pallas_stacked_nd` / `qmatmul_pallas_stacked` (layer-stacked
weights, layer chosen by scalar prefetch). Here both are one kernel: a layer
is chosen by offsetting the weight pointers by `layer x stride`, no copy.

Bound on the H100: at decode the bytes of the quantized weights (Q4_K packed
with codes: 4.75 bits per weight, ~3.9 GB per 7B token), so the SIMT body
reads each weight byte once per row tile with coalesced 4-column vectors,
keeps a whole quant group's loads in flight per warp, splits K over warps
and blocks to fill the 132 SMs at small N, and never writes a dequantized
weight to device memory. Prefill (more than 8 rows, bf16) is bound by
operations and takes the tensor-core body: 64 x 128 tiles, each weight tile
dequantized into shared memory only. The TPU's batch pad to 8 rows and its
tile pickers do not carry over: any row count from 1 to 512 runs in one
launch. G = 8 (IQ1_M) runs in both bodies as G = 16 and 32 do.

The `qmm_i4` kernel (csrc/qmm_i4.cu) is the counterpart of
`qmatmul_pallas_2d_i4` / `qmatmul_pallas_stacked_i4` (pallas_qmm.py's
`_qmm_kernel_i4`): weights of the `int4` form, signed nibbles with the scale
AND the bias applied to every weight in the compute dtype. Only the kernel
benchmark (tools/kernel_bench.py) makes such weights; the model path never
routes them, as in the reference."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..quant.qtensor import QTensor

_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_SMS = 132  # H100 SXM streaming multiprocessors
_COLS = 128  # output columns per block (csrc/qmm.cu)
_WARPS = 8  # K-walking warps per block


def _dims(w: QTensor) -> tuple[int, int]:
    n, k = w.shape
    return k, n


def qmm_math(x: torch.Tensor, w: QTensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch for one 2-D "kn" weight, at
    its rounding points: w = round_ct(q * scale_f32), y = round_ct(x) @ w
    with f32 accumulation, plus round_ct(xsum_g) @ round_ct(bias). x [B, K]
    -> f32 [B, N]. Shared by the plain versions of qmm and of the fused FFN
    kernels (ops/ffn.py), which count their own calls."""
    if w.int4:
        raise ValueError("int4 weights take qmm_i4, not qmm")
    k, n = _dims(w)
    g = w.group
    b = x.shape[0]
    xf = x.float()
    scale, bias = w.effective_scale_bias()
    q = w.unpack().q
    wd = (q.float().reshape(k // g, g, n) * scale[:, None, :]).reshape(k, n)
    y = xf.to(compute_dtype).float() @ wd.to(compute_dtype).float()
    if bias is not None:
        xs = xf.reshape(b, k // g, g).sum(-1)
        y = y + xs.to(compute_dtype).float() @ bias.to(compute_dtype).float()
    return y


def qmm_plain(x: torch.Tensor, w: QTensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the kernel (`qmm_math`), counted."""
    _build.plain_calls["qmm"] += 1
    return qmm_math(x, w, compute_dtype)


def _check(x: torch.Tensor, w: QTensor, compute_dtype) -> None:
    if w.layout != "kn" or w.int4:
        raise ValueError("qmm takes 'kn' layout weights that are not int4")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qmm compute dtype must be f32 or bf16, got {compute_dtype}")
    k, n = _dims(w)
    g = w.group
    if g not in (8, 16, 32) or k % g or n % 4:
        raise ValueError(f"qmm needs G in (8, 16, 32), K % G == 0, N % 4 == 0 "
                         f"(K={k}, N={n}, G={g})")
    if w.packed and g % 2:
        raise ValueError("packed weights need an even group")
    if w.q.dtype != torch.int8:
        raise ValueError(f"q must be int8, got {w.q.dtype}")
    if w.coded:
        if k % 256 or w.sup.dtype != torch.float32 or w.scale.dtype != torch.int8:
            raise ValueError("coded scales need K % 256 == 0, int8 codes and f32 sup")
        if w.bias is not None and (w.sup_min is None or w.sup_min.dtype != torch.float32
                                   or w.bias.dtype != torch.int8):
            raise ValueError("coded bias needs int8 min codes and f32 sup_min")
    else:
        for t in (w.scale, w.bias):
            if t is not None and t.dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"materialized scale/bias must be f32 or bf16, got {t.dtype}")
    for name, t in w.tensors().items():
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


#: alignment the SIMT body's vector loads need (4 adjacent columns per lane);
#: the tensor-core body loads 16 bytes at a time from every operand
_ALIGN = {torch.float32: 16, torch.bfloat16: 8, torch.int8: 4}
_TC_ALIGN = 16
_TC_ROWS = 64  # rows per block of the tensor-core body (csrc/qmm.cu)


def simt_config(b: int, k: int, n: int, group: int) -> tuple[int, int, int]:
    """(rows per block, K splits, groups per split) of the SIMT body for
    [b, k] @ [k, n]. The fused FFN kernels take the same configuration for
    the same product, so their sums are the qmm kernel's to the bit."""
    rb = 1 if b == 1 else 2 if b == 2 else 4 if b <= 4 else 8
    tiles = -(-n // _COLS) * -(-b // rb)
    n_groups = k // group
    # split K until there are ~4 blocks per SM, each warp walking whole groups
    splits = min(max(1, -(-4 * _SMS // tiles)), max(1, n_groups // _WARPS))
    gps = -(-n_groups // splits)
    gps = -(-gps // _WARPS) * _WARPS if splits > 1 else gps
    return rb, -(-n_groups // gps), gps


def _ptr(t: torch.Tensor | None, layer: int | None, align: int | None = None) -> int | None:
    if t is None:
        return None
    p = t.data_ptr()
    if layer is not None:
        p += layer * t.stride(0) * t.element_size()
    align = align or _ALIGN[t.dtype]
    if p % align:
        raise ValueError(f"{t.dtype} operand at {p:#x} is not {align}-byte aligned")
    return p


def _launch(x2: torch.Tensor, w: QTensor, layer: int | None, compute_dtype) -> torch.Tensor:
    fn = _build.kernel("qmm_launch", _ARGTYPES)
    k, n = _dims(w)
    b = x2.shape[0]
    if x2.shape[1] != k:
        raise ValueError(f"x has K={x2.shape[1]}, weight K={k}")
    if b == 0:
        return x2.new_empty((0, n))
    xf = x2.float().contiguous()
    # more than 8 rows in bf16 go to the tensor cores (the SIMT body re-reads
    # every weight byte per 8 rows there and is bound by its FMA rate)
    tc = compute_dtype == torch.bfloat16 and b > 8 and k % 64 == 0 and n % 16 == 0
    if tc:
        if xf.data_ptr() % _TC_ALIGN:
            xf = xf.clone()
        rb, splits, gps = _TC_ROWS, 1, k // w.group
    else:
        rb, splits, gps = simt_config(b, k, n, w.group)
    out = torch.empty((b, n), dtype=torch.float32, device=xf.device)
    partial = torch.empty((splits, b, n), dtype=torch.float32, device=xf.device) if splits > 1 else None
    align = _TC_ALIGN if tc else None
    rc = fn(
        xf.data_ptr(), _ptr(w.q, layer, align), _ptr(w.scale, layer, align),
        _ptr(w.bias, layer, align), _ptr(w.sup, layer, align), _ptr(w.sup_min, layer, align),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        b, k, n, w.group, int(w.packed), _KINDS[w.scale.dtype],
        -1 if w.bias is None else _KINDS[w.bias.dtype],
        int(compute_dtype == torch.bfloat16), rb, splits, gps,
        torch.cuda.current_stream(xf.device).cuda_stream,
    )
    _build.check(rc, "qmm_launch")
    _build.launches["qmm"] += 1
    return out


def _apply(x: torch.Tensor, w: QTensor, layer: int | None, compute_dtype, name: str, plain,
           check, launch) -> torch.Tensor:
    """x [..., K] against a 2-D weight (`layer` None) or layer `layer` of a
    stack, read in place: CPU tensors take the plain version, CUDA tensors
    launch the kernel."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        out = plain(x2, w if layer is None else w.layer(layer), compute_dtype)
    else:
        if layer is None and w.q.dim() != 2:
            raise ValueError(f"{name} takes a 2-D weight; use {name}_stacked for a layer stack")
        if layer is not None:
            if w.q.dim() != 3:
                raise ValueError(f"{name}_stacked takes a layer-stacked [L, ...] weight")
            if not 0 <= layer < w.q.shape[0]:
                raise IndexError(f"layer {layer} outside the stack of {w.q.shape[0]}")
        check(x2, w, compute_dtype)
        out = launch(x2, w, layer, compute_dtype)
    return out.reshape(*lead, -1)


def qmm(x: torch.Tensor, w: QTensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x [..., K] @ dequant(w)^T -> [..., N] f32 for a 2-D "kn" weight
    (counterpart of `qmatmul_pallas`). CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    return _apply(x, w, None, compute_dtype, "qmm", qmm_plain, _check, _launch)


def qmm_stacked(x: torch.Tensor, w: QTensor, layer: int,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Matmul against layer `layer` of a layer-stacked "kn" weight, read in
    place (counterpart of `qmatmul_pallas_stacked_nd`)."""
    return _apply(x, w, layer, compute_dtype, "qmm", qmm_plain, _check, _launch)


# ---------------------------------------------------------------------------
# qmm_i4: int4 weights (csrc/qmm_i4.cu)
# ---------------------------------------------------------------------------

_I4_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def qmm_i4_plain(x: torch.Tensor, w: QTensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the qmm_i4 kernel for one 2-D int4 "kn" weight, at
    the reference's rounding points (`_qmm_kernel_i4`): w = round_ct(q *
    round_ct(scale)), w = round_ct(w + round_ct(bias)), y = round_ct(x) @ w
    with f32 accumulation. x [B, K] -> f32 [B, N]."""
    _build.plain_calls["qmm_i4"] += 1
    if not w.int4:
        raise ValueError("qmm_i4 takes int4 weights")
    k, n = _dims(w)
    g = w.group
    ct = compute_dtype
    wd = w.unpack().q.to(ct).reshape(k // g, g, n) * w.scale.to(ct)[:, None, :]
    if w.bias is not None:
        wd = wd + w.bias.to(ct)[:, None, :]
    return x.float().to(ct).float() @ wd.reshape(k, n).float()


def _check_i4(x: torch.Tensor, w: QTensor, compute_dtype) -> None:
    if w.layout != "kn" or not w.int4 or w.coded:
        raise ValueError("qmm_i4 takes int4 'kn' weights with materialized scales")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qmm_i4 compute dtype must be f32 or bf16, got {compute_dtype}")
    k, n = _dims(w)
    g = w.group
    if g not in (16, 32) or k % g or n % 4:
        raise ValueError(f"qmm_i4 needs G in (16, 32), K % G == 0, N % 4 == 0 "
                         f"(K={k}, N={n}, G={g})")
    if w.q.dtype != torch.int8:
        raise ValueError(f"q must hold int8 nibble pairs, got {w.q.dtype}")
    for name, t in (("scale", w.scale), ("bias", w.bias)):
        if t is not None and t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} must be f32 or bf16, got {t.dtype}")
    for name, t in (("q", w.q), ("scale", w.scale), ("bias", w.bias)):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {x.device}")


def _launch_i4(x2: torch.Tensor, w: QTensor, layer: int | None, compute_dtype) -> torch.Tensor:
    fn = _build.kernel("qmm_i4_launch", _I4_ARGTYPES)
    k, n = _dims(w)
    b = x2.shape[0]
    if x2.shape[1] != k:
        raise ValueError(f"x has K={x2.shape[1]}, weight K={k}")
    if b == 0:
        return x2.new_empty((0, n))
    xf = x2.float().contiguous()
    rb, splits, gps = simt_config(b, k, n, w.group)
    out = torch.empty((b, n), dtype=torch.float32, device=xf.device)
    partial = torch.empty((splits, b, n), dtype=torch.float32, device=xf.device) if splits > 1 else None
    rc = fn(
        xf.data_ptr(), _ptr(w.q, layer), _ptr(w.scale, layer), _ptr(w.bias, layer),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        b, k, n, w.group, _KINDS[w.scale.dtype], -1 if w.bias is None else _KINDS[w.bias.dtype],
        int(compute_dtype == torch.bfloat16), rb, splits, gps,
        torch.cuda.current_stream(xf.device).cuda_stream,
    )
    _build.check(rc, "qmm_i4_launch")
    _build.launches["qmm_i4"] += 1
    return out


def qmm_i4(x: torch.Tensor, w: QTensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x [..., K] @ w -> [..., N] f32 for a 2-D int4 "kn" weight
    (counterpart of `qmatmul_pallas_2d_i4`). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    return _apply(x, w, None, compute_dtype, "qmm_i4", qmm_i4_plain, _check_i4, _launch_i4)


def qmm_i4_stacked(x: torch.Tensor, w: QTensor, layer: int,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Matmul against layer `layer` of a layer-stacked int4 "kn" weight, read
    in place (counterpart of `qmatmul_pallas_stacked_i4`)."""
    return _apply(x, w, layer, compute_dtype, "qmm_i4", qmm_i4_plain, _check_i4, _launch_i4)
