"""Fused FFN block for decode and verify rows: the `ffn_out_norm` and
`gate_up_act` CUDA kernels (csrc/ffn.cu), their wrappers and plain PyTorch
versions, and `ffn_block` (port of eagle_tpu/ops/pallas_ffn.py:
`supports_ffn_block`, `_fused_qmm_call` with `epi_out_norm`,
`_gate_up_act_2d`, `ffn_block_pallas`).

    x = resid + attn @ Wo ;  h = round_ct(rms_norm(x) * w)     ffn_out_norm
    a = round_ct(act(h @ Wg) * (h @ Wu))                       gate_up_act
    out = a @ Wdown + x                                        qmm + add

`ffn_out_norm` replaces pallas_ffn.py:257/:265 (`_fused_qmm_call` with the
`epi_out_norm` epilogue), `gate_up_act` replaces :413/:419
(`_gate_up_act_2d`). Bound on the H100: the weight bytes, as for qmm
(Q4_0 packed, f32 scale and bias: wo 12.58 MB and w_gate_up 67.63 MB per
Vicuna-7B layer). The design (csrc/ffn.cu): a matmul pass, then an
epilogue pass where the full row of sums first exists. The matmul pass is
one of qmm's bodies with qmm's plan for the same product (`_body`):
- 1 bf16 row: the 1-row tensor-core body (csrc/qmm_gemv.cuh, `_gemv_plan`),
  as qmm's decode products; gate_up_act's pass paired, a block's gate and
  up halves of 128 columns each (the SIMT pass before it reached 43 % of
  the byte bound on Q4_0 w_gate_up);
- f32 compute, and K % 64 != 0: the SIMT body (csrc/qmm_body.cuh,
  `simt_config`);
- bf16 at 2-64 rows: the small-row tensor-core body (csrc/qmm_mma.cuh,
  `_mma_plan`), gate and up tiles in one block for `gate_up_act`; each
  weight is dequantized once and `mma.sync` covers 16 rows, so 6 rows cost
  1.0-1.2x one row (the SIMT body paid 2.0-3.2x; `chip_smoke.py`, H100
  80GB HBM3 at 700 W).
Where qmm takes the same body (x, gate and up at 1-8 rows in bf16, any f32
product) they are bit-equal to the unfused path's sums, and the fused block
only saves launches (residual add, norm, split, activation, multiply).

On a CPU tensor each wrapper takes its plain version; on a CUDA tensor it
launches the kernel or raises."""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from ..quant.qtensor import QTensor
from .matmul import qmatmul_layer
from .qmm import (_ALIGN, _KINDS, _TC_ALIGN, _gemv_plan, _mma_plan, _route, qmm_math, simt_config,
                  tc_form)

MAX_ROWS = 64  # decode and verify rows; prefill stays unfused
ACTS = {"silu": 0, "gelu": 1}
_OUT_NORM_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p])
_GATE_UP_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
#: the argument types of ffn_out_norm_mma_launch and of ffn_out_norm_gemv_launch
_OUT_NORM_MMA_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                      + [ctypes.c_float, ctypes.c_void_p])
#: the argument types of gate_up_act_mma_launch and of gate_up_act_gemv_launch
_GATE_UP_MMA_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def supports_ffn_block(layers: dict, cfg) -> bool:
    """The plain pre-norm FFN with a fused gate_up: RMSNorm, the sequential
    residual, no biases after the attention (`bo`, `b_up`, `b_down`, jais's
    `b_gate_up`, the FFN norm's `ffn_norm_b`), no sandwich norms, no MoE
    router, quantized "kn" layer-stacked weights with materialized scales
    and 128-aligned extents
    (the reference's gate, `pallas_ffn.py:47`, which reads neither the norm
    type, the residual form nor the biases: under it a stablelm's FFN norm
    would become an RMSNorm without its bias)."""
    if getattr(cfg, "norm_type", "rms") != "rms" or getattr(cfg, "parallel_blocks", False):
        return False
    if any(k in layers for k in ("post_attn_norm", "post_ffn_norm", "ffn_gate_inp", "bo",
                                 "b_up", "b_down", "b_gate_up", "ffn_norm_b")):
        return False
    if "ffn_norm" not in layers or "w_gate_up" not in layers:
        return False
    if getattr(cfg, "act", "silu") not in ACTS:
        return False
    ws = [layers.get("wo"), layers.get("w_gate_up"), layers.get("w_down")]
    for w in ws:
        if not isinstance(w, QTensor) or w.layout != "kn" or w.q.dim() != 3:
            return False
        if w.coded:
            return False
        k = w.q.shape[1] * (2 if w.packed else 1)
        n = w.q.shape[2]
        if n % 128 != 0 or k % (2 * w.group if w.packed else w.group) != 0:
            return False
        if w.group % 8 != 0:
            return False
    return ws[1].q.shape[2] % 256 == 0  # gate/up split: an even, 128-aligned width


def _act(name: str, g: torch.Tensor) -> torch.Tensor:
    return F.silu(g) if name == "silu" else F.gelu(g, approximate="tanh")


def ffn_out_norm_plain(attn, resid, norm_w, wo: QTensor, eps: float, compute_dtype):
    """Plain version of `ffn_out_norm` for one layer's "kn" weight: x = o +
    resid in f32, the mean of x^2 over the true width, h cast once."""
    _build.plain_calls["ffn_out_norm"] += 1
    x = qmm_math(attn, wo, compute_dtype) + resid.float()
    ms = (x * x).mean(dim=-1, keepdim=True)
    return x, (x * torch.rsqrt(ms + eps) * norm_w.float()).to(compute_dtype)


def gate_up_act_plain(h, w: QTensor, act: str, compute_dtype):
    """Plain version of `gate_up_act` for one layer's fused "kn" weight."""
    _build.plain_calls["gate_up_act"] += 1
    gate, up = qmm_math(h, w, compute_dtype).chunk(2, dim=-1)
    return (_act(act, gate) * up).to(compute_dtype)


def _check(x: torch.Tensor, w: QTensor, layer: int, compute_dtype) -> tuple[int, int]:
    """(K, N) of a layer-stacked weight the kernels take, else raise."""
    if w.layout != "kn" or w.q.dim() != 3 or w.coded:
        raise ValueError("the fused FFN kernels take layer-stacked 'kn' weights with "
                         "materialized scales")
    if not 0 <= layer < w.q.shape[0]:
        raise IndexError(f"layer {layer} outside the stack of {w.q.shape[0]}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be f32 or bf16, got {compute_dtype}")
    k = w.q.shape[1] * (2 if w.packed else 1)
    n = w.q.shape[2]
    if w.group not in (8, 16, 32) or k % w.group or n % 128 or w.q.dtype != torch.int8:
        raise ValueError(f"need int8 q, G in (8, 16, 32), K % G == 0, N % 128 == 0 "
                         f"(K={k}, N={n}, G={w.group})")
    rows = x.shape[0]
    if not 1 <= rows <= MAX_ROWS or x.shape[1] != k:
        raise ValueError(f"x is {tuple(x.shape)}; need 1..{MAX_ROWS} rows of K={k}")
    for name, t in (("scale", w.scale), ("bias", w.bias)):
        if t is not None and t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} must be f32 or bf16, got {t.dtype}")
    for name, t in (("q", w.q), ("scale", w.scale), ("bias", w.bias)):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {x.device}")
    return k, n


def _lp(t: torch.Tensor | None, layer: int, align: int | None = None) -> int | None:
    """Pointer to layer `layer` of a stacked operand, checked for the SIMT
    body's 4-column vector loads (or `align`: the tensor-core body's 16-byte
    copies)."""
    if t is None:
        return None
    p = t.data_ptr() + layer * t.stride(0) * t.element_size()
    align = align or _ALIGN[t.dtype]
    if p % align:
        raise ValueError(f"{t.dtype} operand at {p:#x} is not {align}-byte aligned")
    return p


def _body(rows: int, k: int, n: int, w: QTensor, compute_dtype, paired: bool = False) -> str:
    """The matmul pass's body: "simt" (csrc/qmm_body.cuh, with
    `simt_config`) where qmm's own `_route` takes it (f32 compute, K % 64 !=
    0); "gemv" (csrc/qmm_gemv.cuh, with `_gemv_plan`) at 1 bf16 row, as
    qmm, the gate/up pass `paired`; else "mma" (csrc/qmm_mma.cuh, with
    `_mma_plan`: bf16 at 2-64 rows; qmm takes the same body at 2-8 rows, and
    its prefill body beyond). Either way the plan is the one qmm would take
    for the same product with that body."""
    route = _route(rows, k, n, compute_dtype, tc_form(w))
    return route if route in ("simt", "gemv") else "mma"


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bias_kind(w: QTensor) -> int:
    return -1 if w.bias is None else _KINDS[w.bias.dtype]


def ffn_out_norm(attn: torch.Tensor, resid: torch.Tensor, norm_w: torch.Tensor, wo: QTensor,
                 layer: int, eps: float, compute_dtype=torch.bfloat16):
    """attn [R, H*Dh], resid [R, D] -> (x = resid + attn @ Wo[layer] f32
    [R, D], h = round_ct(rms_norm(x) * norm_w) [R, D]), R <= 64."""
    if attn.device.type == "cpu":
        return ffn_out_norm_plain(attn, resid, norm_w, wo.layer(layer), eps, compute_dtype)
    k, n = _check(attn, wo, layer, compute_dtype)
    r = attn.shape[0]
    xf = attn.float().contiguous()
    # the epilogue reads resid and norm_w four columns at a time
    rf, nw = (_aligned16(t.float().contiguous()) for t in (resid, norm_w))
    if tuple(rf.shape) != (r, n) or tuple(nw.shape) != (n,):
        raise ValueError(f"resid {tuple(rf.shape)} / norm {tuple(nw.shape)} do not match [{r}, {n}]")
    x_out = torch.empty((r, n), dtype=torch.float32, device=attn.device)
    h_out = torch.empty((r, n), dtype=compute_dtype, device=attn.device)
    body = _body(r, k, n, wo, compute_dtype)
    fn = _build.kernel(*{"mma": ("ffn_out_norm_mma_launch", _OUT_NORM_MMA_ARGS),
                         "gemv": ("ffn_out_norm_gemv_launch", _OUT_NORM_MMA_ARGS),
                         "simt": ("ffn_out_norm_launch", _OUT_NORM_ARGS)}[body])
    stream = torch.cuda.current_stream(attn.device).cuda_stream
    if body == "gemv":
        plan = _gemv_plan(k, n, wo.group, tc_form(wo))  # qmm's plan for the same product
        partial = torch.empty((plan.splits, 1, n), dtype=torch.float32, device=attn.device)
        a = _TC_ALIGN
        rc = fn(
            _aligned16(xf).data_ptr(), _lp(wo.q, layer, a), _lp(wo.scale, layer, a),
            _lp(wo.bias, layer, a), rf.data_ptr(), nw.data_ptr(), x_out.data_ptr(),
            h_out.data_ptr(), partial.data_ptr(), k, n, wo.group, int(wo.packed),
            _KINDS[wo.scale.dtype], _bias_kind(wo), plan.stages, plan.splits,
            plan.steps_per_split, plan.smem_bytes, float(eps), stream)
        _build.check(rc, "ffn_out_norm_gemv_launch")
        _build.launches["ffn_out_norm"] += 1
        return x_out, h_out
    if body == "mma":
        plan = _mma_plan(r, k, n, wo.group, tc_form(wo))
        partial = torch.empty((plan.splits, r, n), dtype=torch.float32, device=attn.device)
        a = _TC_ALIGN
        rc = fn(
            _aligned16(xf).data_ptr(), _lp(wo.q, layer, a), _lp(wo.scale, layer, a),
            _lp(wo.bias, layer, a), rf.data_ptr(), nw.data_ptr(), x_out.data_ptr(),
            h_out.data_ptr(), partial.data_ptr(), r, k, n, wo.group, int(wo.packed),
            _KINDS[wo.scale.dtype], _bias_kind(wo), plan.splits, plan.steps_per_split,
            plan.smem_bytes, float(eps), stream)
        _build.check(rc, "ffn_out_norm_mma_launch")
        _build.launches["ffn_out_norm"] += 1
        return x_out, h_out
    rb, splits, gps = simt_config(r, k, n, wo.group)
    partial = torch.empty((splits, r, n), dtype=torch.float32, device=attn.device)
    rc = fn(
        xf.data_ptr(), _lp(wo.q, layer), _lp(wo.scale, layer), _lp(wo.bias, layer),
        rf.data_ptr(), nw.data_ptr(), x_out.data_ptr(), h_out.data_ptr(), partial.data_ptr(),
        r, k, n, wo.group, int(wo.packed), _KINDS[wo.scale.dtype], _bias_kind(wo),
        int(compute_dtype == torch.bfloat16), rb, splits, gps, float(eps), stream)
    _build.check(rc, "ffn_out_norm_launch")
    _build.launches["ffn_out_norm"] += 1
    return x_out, h_out


def gate_up_act(h: torch.Tensor, w_gate_up: QTensor, layer: int, act: str = "silu",
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """h [R, D] -> round_ct(act(h @ Wg) * (h @ Wu)) [R, F] in the compute
    dtype, gate columns [0, F) and up columns [F, 2F) of the fused weight."""
    if act not in ACTS:
        raise ValueError(f"act {act!r}")
    if h.device.type == "cpu":
        return gate_up_act_plain(h, w_gate_up.layer(layer), act, compute_dtype)
    k, two_f = _check(h, w_gate_up, layer, compute_dtype)
    if two_f % 256:
        raise ValueError(f"the fused gate/up width {two_f} must be a multiple of 256")
    f, r = two_f // 2, h.shape[0]
    hc = h.to(compute_dtype).contiguous()
    out = torch.empty((r, f), dtype=compute_dtype, device=h.device)
    w = w_gate_up
    body = _body(r, k, two_f, w, compute_dtype, paired=True)
    fn = _build.kernel(*{"mma": ("gate_up_act_mma_launch", _GATE_UP_MMA_ARGS),
                         "gemv": ("gate_up_act_gemv_launch", _GATE_UP_MMA_ARGS),
                         "simt": ("gate_up_act_launch", _GATE_UP_ARGS)}[body])
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if body == "gemv":
        plan = _gemv_plan(k, two_f, w.group, tc_form(w))  # qmm's plan for [1, K] @ [K, 2F]
        partial = torch.empty((plan.splits, 2, 1, f), dtype=torch.float32, device=h.device)
        a = _TC_ALIGN
        rc = fn(
            _aligned16(hc).data_ptr(), _lp(w.q, layer, a), _lp(w.scale, layer, a),
            _lp(w.bias, layer, a), out.data_ptr(), partial.data_ptr(), k, f, w.group,
            int(w.packed), _KINDS[w.scale.dtype], _bias_kind(w), ACTS[act], plan.stages,
            plan.splits, plan.steps_per_split, plan.smem_bytes, stream)
        _build.check(rc, "gate_up_act_gemv_launch")
        _build.launches["gate_up_act"] += 1
        return out
    if body == "mma":
        # qmm's plan for the same [R, K] @ [K, 2F] product
        plan = _mma_plan(r, k, two_f, w.group, tc_form(w), paired=True)
        partial = torch.empty((plan.splits, 2, r, f), dtype=torch.float32, device=h.device)
        a = _TC_ALIGN
        rc = fn(
            _aligned16(hc).data_ptr(), _lp(w.q, layer, a), _lp(w.scale, layer, a),
            _lp(w.bias, layer, a), out.data_ptr(), partial.data_ptr(), r, k, f, w.group,
            int(w.packed), _KINDS[w.scale.dtype], _bias_kind(w), ACTS[act], plan.splits,
            plan.steps_per_split, plan.smem_bytes, stream)
        _build.check(rc, "gate_up_act_mma_launch")
        _build.launches["gate_up_act"] += 1
        return out
    # the unfused path's split for the same [R, K] @ [K, 2F] product
    rb, splits, gps = simt_config(r, k, two_f, w.group)
    partial = torch.empty((splits, 2, r, f), dtype=torch.float32, device=h.device)
    rc = fn(
        hc.data_ptr(), _lp(w.q, layer), _lp(w.scale, layer), _lp(w.bias, layer), out.data_ptr(),
        partial.data_ptr(), r, k, f, w.group, int(w.packed), _KINDS[w.scale.dtype],
        _bias_kind(w), int(compute_dtype == torch.bfloat16), ACTS[act], rb, splits, gps, stream)
    _build.check(rc, "gate_up_act_launch")
    _build.launches["gate_up_act"] += 1
    return out


def ffn_block(attn, resid, norm_w, wo: QTensor, w_gate_up: QTensor, w_down: QTensor, layer: int,
              *, rms_eps: float, act_fn: str = "silu", compute_dtype=torch.bfloat16,
              stages: str = "all") -> torch.Tensor:
    """resid + FFN(rms_norm(resid + attn @ Wo)) for one layer of R <= 64
    rows; returns the next residual stream [R, D] f32. `stages` "all" fuses
    both stages, "wo" only the first (gate/up then go through qmm, split,
    activation and multiply). Stage 3 stays `a @ Wdown + x`, as in the
    reference."""
    if stages not in ("all", "wo"):
        raise ValueError(f"stages {stages!r}")
    x, h = ffn_out_norm(attn, resid, norm_w, wo, layer, rms_eps, compute_dtype)
    if stages == "wo":
        gate, up = qmatmul_layer(h, w_gate_up, layer, compute_dtype).chunk(2, dim=-1)
        a = (_act(act_fn, gate) * up).to(compute_dtype)
    else:
        a = gate_up_act(h, w_gate_up, layer, act_fn, compute_dtype)
    return qmatmul_layer(a, w_down, layer, compute_dtype) + x
