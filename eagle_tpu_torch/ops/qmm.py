"""Fused dequant + matmul: the `qmm` CUDA kernels (csrc/qmm.cu), their
wrapper and their plain PyTorch version.

Replaces eagle_tpu/ops/pallas_qmm.py:_qmm_kernel, reached there through
`qmatmul_pallas` / `qmatmul_pallas_2d` (pallas_call at :513; 2-D weights:
lm_head, EAGLE fc_w) and `qmatmul_pallas_stacked_nd` /
`qmatmul_pallas_stacked` (:758; layer-stacked weights, layer chosen by
scalar prefetch). Here both are one entry: a layer is chosen by offsetting
the weight pointers by `layer x stride`, no copy.

Four bodies, picked by `_route` from the shape alone (qmm_i4 takes all
but the 1-row one):
- "simt", csrc/qmm_body.cuh: f32 compute at any row count, every shape the
  tensor-core bodies cannot address (K % 64 != 0 or N % 16 != 0; any N >=
  1, masked at the last column when N % 4 != 0), and qmm_i4 at 1 row.
  It reads each weight byte once per row tile with coalesced 4-column
  vectors, keeps a whole quant group's loads in flight per warp, splits K
  over warps and blocks (`simt_config`) to fill the 132 SMs at small N,
  and never writes a dequantized weight to device memory; at one bf16 row
  it reached 23-36 % of the byte bound (`chip_smoke.py` on an H100 80GB
  HBM3 at 700 W, as the other times here).
- "gemv", csrc/qmm_gemv.cuh: bf16 at 1 row (decode), bound by the bytes of
  the quantized weights (Q4_K packed with codes: 4.75 bits per weight,
  ~3.9 GB per 7B token). A 3-stage `cp.async` ring of raw 64-deep weight
  tiles per 256-column block, x staged once per block as bf16 pairs, the
  weights dequantized in registers (one AND-OR into a magic-number float,
  one FFMA, half a bf16 pair conversion each) straight into the A operand
  of `mma.sync.m16n8k16`, K splits from `_gemv_plan`. Its pace is set by
  that arithmetic, not by the copies. The fused FFN kernels (ops/ffn.py)
  take the same body and plan for their matmul pass at 1 row, gate_up_act
  paired.
- "mma", csrc/qmm_mma.cuh: bf16 at 2-8 rows (the EAGLE verify forward,
  K + 1 = 6 rows; kernel_bench's 8). Each weight is dequantized once per
  call into a bf16 tile in shared memory (a 3-stage `cp.async` ring feeds
  it) and `mma.sync.m16n8k16` products cover 16 rows at once, the bias side
  product as a fifth k16 block of each step; K splits from `_mma_plan`. Its
  time is flat from 2 to 8 rows, 1.2-1.4x the SIMT body's 1-row time over
  the same bytes (18-25 % of the byte bound at 6 rows): what holds it is
  the latency of each 64-deep step's copy, dequant and product phases,
  which the block's barriers serialize. The fused FFN kernels (ops/ffn.py)
  take the same body for their matmul pass at 2-64 rows, and qmm_i4 at 2-8
  rows (its bias applied per weight in the dequant, no side product).
- "tc", csrc/qmm_tc.cuh: bf16 above 8 rows (prefill; 512 rows for a
  300-token prompt), bound by operations there. An x prologue rounds x to
  bf16 and takes the group sums once per call; the main loop runs
  `wgmma.mma_async` on 64- or 128-row x 256-column tiles, fed by a 3-4
  stage ring that one producer thread fills by TMA, with each 64-deep
  weight tile dequantized into shared memory while the previous step's
  wgmma runs, the bias side product as trailing wgmma steps over the
  groups, and K splits where the tiles are fewer than the SMs (`_tc_plan`).
  Its pace is set by the dequant, at 2-3x the time of one torch.matmul on
  a pre-dequantized bf16 weight.
Every form takes the tensor-core bodies: packed / int8, coded / f32 / bf16
scales, bias or none, G = 8, 16, 32, 2-D or stacked; they need 16-byte
aligned operands (layer offsets included) and raise on anything else: no
route is chosen by catching an error, and a CUDA tensor never falls back to
the plain version.
The TPU's batch pad to 8 rows and its tile pickers do not carry over: any
row count from 1 to 512 runs in one call.

The `qmm_i4` kernels (csrc/qmm_i4.cu) are the counterpart of
`qmatmul_pallas_2d_i4` / `qmatmul_pallas_stacked_i4` (pallas_qmm.py:600 and
:839, `_qmm_kernel_i4`): weights of the `int4` form, signed nibbles with
the scale AND the bias applied to every weight in the compute dtype, with
the SIMT, small-row and wgmma bodies (the last two at qmm_i4's rounding
points).
Only the kernel benchmark (tools/kernel_bench.py) makes such weights; the
model path never routes them, as in the reference."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..quant.qtensor import QTensor

_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_TC_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
#: the argument types of qmm_mma_launch and of qmm_gemv_launch
_MMA_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
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
    scale, bias = w.effective_scale_bias()
    q = w.unpack().q
    wd = (q.float().reshape(k // g, g, n) * scale[:, None, :]).reshape(k, n)
    xc, xs = x_prologue_plain(x, g, bias is not None, compute_dtype)
    y = xc.float() @ wd.to(compute_dtype).float()
    if bias is not None:
        y = y + xs.float() @ bias.to(compute_dtype).float()
    return y


def x_prologue_plain(x: torch.Tensor, group: int, sums: bool,
                     compute_dtype=torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor | None]:
    """What the tensor-core body's x prologue (csrc/qmm_tc.cuh:tc_x_prologue)
    computes, at the reference's rounding points: x [B, K] rounded to the
    compute dtype, and with `sums` the f32 sum of each group of `group`
    values of the unrounded x, rounded to the compute dtype [B, K/G] (the
    kernel pads its copy to `gp` columns with zeros)."""
    xf = x.float()
    xs = xf.reshape(x.shape[0], -1, group).sum(-1).to(compute_dtype) if sums else None
    return xf.to(compute_dtype), xs


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
    if g not in (8, 16, 32) or k % g or n < 1:
        raise ValueError(f"qmm needs G in (8, 16, 32), K % G == 0, N >= 1 "
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
#: the tensor-core body's TMA copies need 16-byte bases and row strides
_ALIGN = {torch.float32: 16, torch.bfloat16: 8, torch.int8: 4}
_TC_ALIGN = 16

# the tensor-core body (csrc/qmm_tc.cuh)
_TC_COLS = 256  # weight columns per block
_TC_K = 64  # K per step
_TC_SPLIT_K = 256  # K splits cut here: whole groups, whole sup rows of coded weights
_TC_MAX_SMEM = 232448  # 227 KB of dynamic shared memory per block
_TC_B_SLOT = _TC_K * _TC_COLS * 2
_TC_FILL = 0.9  # least share of the SMs a plan's blocks cover, where the shape allows
_TC_STEP_BYTES = 4.8e6  # bytes of partial sums that cost as much as one block-step


class TcForm(NamedTuple):
    """What the tensor-core body's ring holds per step for a weight: q as
    "packed" nibbles, "int8" or "int4" nibbles; the bytes of a scale (4 f32,
    2 bf16, 1 code); coded (a sup row per step); the bytes of a bias (0:
    none)."""
    q: str
    scale_bytes: int
    coded: bool
    bias_bytes: int


class TcPlan(NamedTuple):
    rows: int  # output rows per block (64 or 128)
    cols: int  # output columns per block
    stages: int  # ring stages
    splits: int  # K splits (grid z)
    steps_per_split: int  # K steps of 64 per split (the last split may have fewer)
    groups_per_split: int
    smem_bytes: int  # dynamic shared memory of the main loop


def tc_form(w: QTensor) -> TcForm:
    size = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
    q = "int4" if w.int4 else "packed" if w.packed else "int8"
    return TcForm(q, size[w.scale.dtype], w.coded,
                  0 if w.bias is None else size[w.bias.dtype])


def _tc_layout(rows: int, group: int, form: TcForm, stages: int) -> int:
    """Dynamic shared memory of the main loop (csrc/qmm_tc.cuh:tc_layout):
    `stages` ring stages, each the bf16 x tile and the raw weight tile,
    rounded to 1 KB; two bf16 B slots; four mbarriers; 1 KB to align the
    base."""
    stage = rows * 128
    stage += (_TC_K if form.q == "int8" else _TC_K // 2) * _TC_COLS
    stage += (_TC_K // group) * _TC_COLS * form.scale_bytes
    stage += _TC_COLS * 4 if form.coded else 0
    stage += (_TC_K // group) * _TC_COLS * form.bias_bytes if form.q == "int4" else 0
    stage = -(-stage // 1024) * 1024
    return stages * stage + 2 * _TC_B_SLOT + 64 + 1024


@functools.lru_cache(maxsize=None)  # pure: the wrappers ask per launch
def _tc_plan(b: int, k: int, n: int, group: int, form: TcForm) -> TcPlan:
    """Row tile, ring stages and K splits of the tensor-core body for
    [b, k] @ [k, n]: 128-row tiles above 64 rows, else 64; 4 stages where
    they fit in 227 KB, else 3; K cut on 256-row boundaries into the splits
    that give the least estimated time, among those that put a block on at
    least 90 % of the 132 SMs (where the shape has that many tiles and
    steps). The estimate counts the block-steps on the busiest SM (waves x
    steps per split) plus the partial sums' traffic, written and read back
    by the reduce kernel, at 4.8 MB per block-step (an H100 block-step at
    512 rows took about 1.6 us, in which ~3 TB/s moves ~4.8 MB). Raises on
    a shape the body does not take."""
    if k % _TC_K or n % 16 or group not in (8, 16, 32):
        raise ValueError(f"the tensor-core qmm body needs K % 64 == 0, N % 16 == 0 and G in "
                         f"(8, 16, 32) (K={k}, N={n}, G={group})")
    rows = 64 if b <= 64 else 128
    stages = 4 if _tc_layout(rows, group, form, 4) <= _TC_MAX_SMEM else 3
    smem = _tc_layout(rows, group, form, stages)
    if smem > _TC_MAX_SMEM:
        raise ValueError(f"the tensor-core qmm body needs {smem} bytes of shared memory")
    tiles = -(-n // _TC_COLS) * -(-b // rows)
    quantum = _TC_SPLIT_K // _TC_K
    units = -(-(k // _TC_K) // quantum)
    fill = min(_TC_FILL * _SMS, tiles * units)
    best = None
    for per in range(units, 0, -1):  # units of 256 K rows per split
        splits = -(-units // per)
        blocks = tiles * splits
        if blocks < fill:
            continue
        est = -(-blocks // _SMS) * per * quantum
        if splits > 1:
            est += (2 * splits + 1) * b * n * 4 / _TC_STEP_BYTES
        if best is None or est < best[0]:
            best = (est, per, splits)
    _, per, splits = best
    return TcPlan(rows, _TC_COLS, stages, splits, per * quantum, per * quantum * _TC_K // group,
                  smem)


def _route(b: int, k: int, n: int, compute_dtype, form: TcForm) -> str:
    """Which body a [b, k] @ [k, n] call takes, from its shape alone (qmm and
    qmm_i4 alike):
    - "simt": f32 compute at any row count, every shape the tensor-core
      bodies cannot address: K % 64 != 0 or N % 16 != 0 (their 64-deep steps
      and 16-byte row copies; the SIMT body takes any N >= 1), and int4
      weights at 1 row;
    - "gemv": bf16 at 1 row (decode), qmm only (`qmm_gemv_kernel`,
      csrc/qmm_gemv.cuh: a `cp.async` ring of raw weight tiles, `mma.sync`
      products with the weights as the A operand);
    - "mma": bf16 at 2-8 rows (verify; kernel_bench's 8 for int4), qmm and
      qmm_i4 (`qmm_mma_kernel`, csrc/qmm_mma.cuh: each weight dequantized
      once, 16 rows per product);
    - "tc": bf16 at more than 8 rows (prefill: the wgmma body,
      csrc/qmm_tc.cuh)."""
    if compute_dtype != torch.bfloat16 or k % _TC_K or n % 16:
        return "simt"
    if b == 1:
        return "simt" if form.q == "int4" else "gemv"
    if b <= 8:
        return "mma"
    return "tc"


# the small-row tensor-core body (csrc/qmm_mma.cuh)
_MMA_COLS = 256  # weight columns per block
_MMA_STAGES = 3
_MMA_MAX_ROWS = 64
#: time of one 64-deep step of a block, by blocks per SM (us), and the rate
#: at which partial sums are written and read back (bytes per us): from
#: H100 80GB HBM3 measurements of this body at 6 rows
_MMA_STEP_US = {1: 2.3, 2: 3.9}
_MMA_BYTES_PER_US = 3.0e6


class MmaPlan(NamedTuple):
    cols: int  # weight columns per block
    stages: int  # ring stages
    splits: int  # K splits (grid y)
    steps_per_split: int  # K steps of 64 per split (the last split may have fewer)
    groups_per_split: int
    smem_bytes: int  # dynamic shared memory


def _mma_stage(group: int, form: TcForm) -> int:
    """Bytes of one ring stage of the small-row body: the raw weight tile of
    one 64-deep step (q: 64 int8 rows, or 32 of packed or int4 nibbles;
    scale rows, sup when coded, bias rows, sup_min when coded with a bias),
    rounded to 128 bytes."""
    stage = (_TC_K if form.q == "int8" else _TC_K // 2) * _MMA_COLS
    stage += (_TC_K // group) * _MMA_COLS * form.scale_bytes
    stage += _MMA_COLS * 4 if form.coded else 0
    stage += (_TC_K // group) * _MMA_COLS * form.bias_bytes
    stage += _MMA_COLS * 4 if form.coded and form.bias_bytes else 0
    return -(-stage // 128) * 128


def _mma_layout(rows: int, group: int, form: TcForm, steps_per_split: int) -> int:
    """Dynamic shared memory of the small-row body (csrc/qmm_mma.cuh:
    mma_layout): 3 ring stages, the bf16 B tile, the split's x rows in bf16
    and, with qmm's bias side product (a bias, not int4), the side
    product's B tile (16 x 256 bf16) and the rows' group sums (16 bf16 per
    step, rows rounded to 128 bytes)."""
    side = 0
    if form.bias_bytes and form.q != "int4":
        side = 16 * _MMA_COLS * 2 + rows * -(-steps_per_split * 2 // 8) * 8 * 16
    return (_MMA_STAGES * _mma_stage(group, form) + _TC_B_SLOT
            + rows * steps_per_split * _TC_K * 2 + side)


@functools.lru_cache(maxsize=None)  # pure: the wrappers ask per launch
def _mma_plan(b: int, k: int, n: int, group: int, form: TcForm, paired: bool = False) -> MmaPlan:
    """K splits of the small-row body for [b, k] @ [k, n], all b <= 64 rows
    in each block (`paired`: n = 2F, gate and up tiles together; the same
    tiles and splits as unpaired). K is cut on 64-row steps (whole groups),
    on 256-row boundaries for coded weights (whole sup rows). Among the cuts
    whose shared memory fits 227 KB it prefers those that put a block on
    every SM (where the shape has that many tiles and steps), then those
    that let two blocks share an SM (one block of 8 warps hides too little
    latency), then the least estimated time: waves of blocks x steps per
    split x the time of a step at that occupancy, plus the partial sums
    written and read back. Raises on a shape the body does not take."""
    groups = (16, 32) if form.q == "int4" else (8, 16, 32)
    if (not 1 <= b <= _MMA_MAX_ROWS or k % _TC_K or n % (256 if paired else 16)
            or group not in groups):
        raise ValueError(f"the small-row tensor-core body needs 1-64 rows, K % 64 == 0, "
                         f"N % {256 if paired else 16} == 0 and G in {groups} "
                         f"(rows={b}, K={k}, N={n}, G={group}, q={form.q})")
    tiles = -(-n // _MMA_COLS)
    quantum = _TC_SPLIT_K // _TC_K if form.coded else 1
    units = -(-(k // _TC_K) // quantum)
    fill = min(_SMS, tiles * units)
    stage = _mma_stage(group, form)
    best = None
    for per in range(units, 0, -1):  # units of K steps per split
        smem = _mma_layout(b, group, form, per * quantum)
        if smem > _TC_MAX_SMEM:
            continue
        splits = -(-units // per)
        blocks = tiles * splits
        per_sm = 2 if smem <= _TC_MAX_SMEM // 2 else 1
        est = (-(-blocks // (per_sm * _SMS)) * per * quantum * _MMA_STEP_US[per_sm]
               + (2 * splits + 1) * b * n * 4 * (splits > 1) / _MMA_BYTES_PER_US)
        key = (blocks < fill, per_sm == 1, est)
        if best is None or key < best[0]:
            best = (key, per, splits, smem)
    if best is None:
        raise ValueError(f"the small-row tensor-core body cannot hold {b} rows in 227 KB")
    _, per, splits, smem = best
    steps = per * quantum
    return MmaPlan(_MMA_COLS, _MMA_STAGES, splits, steps, steps * _TC_K // group, smem)


# the 1-row tensor-core body (csrc/qmm_gemv.cuh)
_GEMV_COLS = 256  # weight columns per block: 8 warps x 32
_GEMV_STAGES = 3
_GEMV_FILL = 1.9  # blocks per SM a plan reaches for, where the shape allows
#: a block's fixed cost (x staged, the ring's first fill, the store) in steps
#: of 64 (H100 80GB HBM3, 700 W: splits of 4 steps cost about 6 steps' time)
_GEMV_BLOCK_STEPS = 2


class GemvPlan(NamedTuple):
    cols: int  # weight columns per block
    stages: int  # ring stages
    splits: int  # K splits (grid y)
    steps_per_split: int  # K steps of 64 per split (the last split may have fewer)
    groups_per_split: int
    smem_bytes: int  # dynamic shared memory


def _gemv_stage(group: int, form: TcForm) -> int:
    """Bytes of one ring stage of the 1-row body: the raw weight tile of one
    64-deep step (the q rows, the scale rows, sup when coded, the bias rows
    and sup_min when coded with a bias, each 256 columns wide), rounded to
    128 bytes."""
    stage = (_TC_K if form.q == "int8" else _TC_K // 2) * _GEMV_COLS
    stage += (_TC_K // group) * _GEMV_COLS * form.scale_bytes
    stage += _GEMV_COLS * 4 if form.coded else 0
    stage += (_TC_K // group) * _GEMV_COLS * form.bias_bytes
    stage += _GEMV_COLS * 4 if form.coded and form.bias_bytes else 0
    return -(-stage // 128) * 128


def _gemv_layout(group: int, form: TcForm, stages: int, steps_per_split: int) -> int:
    """Dynamic shared memory of the 1-row body (csrc/qmm_gemv.cuh:
    gemv_layout): `stages` ring stages, the split's x as bf16 pairs (128
    bytes per step) and, with a bias, its group sums (one f32 each)."""
    side = steps_per_split * (_TC_K // group) * 4 if form.bias_bytes else 0
    return stages * _gemv_stage(group, form) + steps_per_split * 128 + side


@functools.lru_cache(maxsize=None)  # pure: the wrappers ask per launch
def _gemv_plan(k: int, n: int, group: int, form: TcForm) -> GemvPlan:
    """Ring stages and K splits of the 1-row body for [1, k] @ [k, n]. The
    ring has 3 stages (2 where 3 do not fit 227 KB): on an H100 80GB HBM3
    more stages ran slower (wqkv 24.7 us at 6, 21.9 at 3), two steps in
    flight per block being enough behind the body's arithmetic (three
    blocks of 256 threads share an SM: the kernel's register cap). K is cut on 64-row steps (whole groups), on 256-row
    boundaries for coded weights (whole sup rows), into the splits that
    give the least estimated time among those that put about two blocks on
    every SM (1.9 x 132, where the shape has that many tiles and steps; one
    block per SM hid too little latency): the blocks on the busiest SM x
    (the steps per split + a block's fixed cost), plus the partial sums
    written and read back (in steps of one block-step per SM). Raises on a
    shape the body does not take."""
    if k % _TC_K or n % 16 or group not in (8, 16, 32) or form.q == "int4":
        raise ValueError(f"the 1-row gemv qmm body needs K % 64 == 0, N % 16 == 0, G in "
                         f"(8, 16, 32) and no int4 (K={k}, N={n}, G={group}, q={form.q})")
    tiles = -(-n // _GEMV_COLS)
    quantum = _TC_SPLIT_K // _TC_K if form.coded else 1
    units = -(-(k // _TC_K) // quantum)
    fill = min(_GEMV_FILL * _SMS, tiles * units)
    stage = _gemv_stage(group, form)
    best = None
    for per in range(units, 0, -1):  # units of K steps per split
        steps = per * quantum
        stages = _GEMV_STAGES
        if _gemv_layout(group, form, stages, steps) > _TC_MAX_SMEM:
            stages = 2
        smem = _gemv_layout(group, form, stages, steps)
        if smem > _TC_MAX_SMEM:
            continue
        splits = -(-units // per)
        blocks = tiles * splits
        est = (-(-blocks // _SMS) * (steps + _GEMV_BLOCK_STEPS)
               + (2 * splits + 1) * n * 4 * (splits > 1) / (_SMS * stage))
        key = (blocks < fill, est)
        if best is None or key < best[0]:
            best = (key, GemvPlan(_GEMV_COLS, stages, splits, steps, steps * _TC_K // group,
                                  smem))
    if best is None:
        raise ValueError(f"the 1-row gemv qmm body cannot hold K={k} in 227 KB")
    return best[1]


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


def _simt_align(n: int) -> int | None:
    """The alignment the SIMT body needs of its operands: its 4-column
    vector loads' (None: `_ALIGN`) where N % 4 == 0, else none beyond the
    element's own (it loads element by element at such N)."""
    return None if n % 4 == 0 else 1


def _scratch_x(x2: torch.Tensor) -> torch.Tensor:
    """x as contiguous f32 whose base the tensor-core bodies' 16-byte loads
    take."""
    xf = x2.float().contiguous()
    return xf.clone() if xf.data_ptr() % _TC_ALIGN else xf


def _launch(x2: torch.Tensor, w: QTensor, layer: int | None, compute_dtype) -> torch.Tensor:
    k, n = _dims(w)
    b = x2.shape[0]
    if x2.shape[1] != k:
        raise ValueError(f"x has K={x2.shape[1]}, weight K={k}")
    if b == 0:
        return x2.new_empty((0, n))
    route = _route(b, k, n, compute_dtype, tc_form(w))
    fn = _build.kernel(*{"tc": ("qmm_tc_launch", _TC_ARGTYPES),
                         "mma": ("qmm_mma_launch", _MMA_ARGTYPES),
                         "gemv": ("qmm_gemv_launch", _MMA_ARGTYPES),
                         "simt": ("qmm_launch", _ARGTYPES)}[route])
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    bias_kind = -1 if w.bias is None else _KINDS[w.bias.dtype]
    a = _TC_ALIGN
    if route == "tc":
        plan = _tc_plan(b, k, n, w.group, tc_form(w))
        xf = _scratch_x(x2)
        xb = torch.empty((b, k), dtype=torch.bfloat16, device=xf.device)
        gp = -(-(k // w.group) // 8) * 8 + _TC_K  # group sums, padded for the last step
        xsum = (torch.empty((b, gp), dtype=torch.bfloat16, device=xf.device)
                if w.bias is not None else None)
        out = torch.empty((b, n), dtype=torch.float32, device=xf.device)
        partial = (torch.empty((plan.splits, b, n), dtype=torch.float32, device=xf.device)
                   if plan.splits > 1 else None)
        rc = fn(
            xf.data_ptr(), xb.data_ptr(), None if xsum is None else xsum.data_ptr(),
            _ptr(w.q, layer, a), _ptr(w.scale, layer, a), _ptr(w.bias, layer, a),
            _ptr(w.sup, layer, a), _ptr(w.sup_min, layer, a), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            gp, b, k, n, w.group, int(w.packed), _KINDS[w.scale.dtype], bias_kind, plan.rows,
            plan.stages, plan.splits, plan.steps_per_split, plan.smem_bytes, stream,
        )
        _build.check(rc, "qmm_tc_launch")
        _build.launches["qmm_tc"] += 1
        return out
    if route == "gemv":
        plan = _gemv_plan(k, n, w.group, tc_form(w))
        xf = _scratch_x(x2)
        out = torch.empty((1, n), dtype=torch.float32, device=xf.device)
        partial = (torch.empty((plan.splits, 1, n), dtype=torch.float32, device=xf.device)
                   if plan.splits > 1 else None)
        rc = fn(
            xf.data_ptr(), _ptr(w.q, layer, a), _ptr(w.scale, layer, a), _ptr(w.bias, layer, a),
            _ptr(w.sup, layer, a), _ptr(w.sup_min, layer, a), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            k, n, w.group, int(w.packed), _KINDS[w.scale.dtype], bias_kind, plan.stages,
            plan.splits, plan.steps_per_split, plan.smem_bytes, stream,
        )
        _build.check(rc, "qmm_gemv_launch")
        _build.launches["qmm_gemv"] += 1
        return out
    if route == "mma":
        plan = _mma_plan(b, k, n, w.group, tc_form(w))
        xf = _scratch_x(x2)
        out = torch.empty((b, n), dtype=torch.float32, device=xf.device)
        partial = (torch.empty((plan.splits, b, n), dtype=torch.float32, device=xf.device)
                   if plan.splits > 1 else None)
        rc = fn(
            xf.data_ptr(), _ptr(w.q, layer, a), _ptr(w.scale, layer, a), _ptr(w.bias, layer, a),
            _ptr(w.sup, layer, a), _ptr(w.sup_min, layer, a), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            b, k, n, w.group, int(w.packed), _KINDS[w.scale.dtype], bias_kind, plan.splits,
            plan.steps_per_split, plan.smem_bytes, stream,
        )
        _build.check(rc, "qmm_mma_launch")
        _build.launches["qmm_mma"] += 1
        return out
    xf = x2.float().contiguous()
    rb, splits, gps = simt_config(b, k, n, w.group)
    out = torch.empty((b, n), dtype=torch.float32, device=xf.device)
    partial = torch.empty((splits, b, n), dtype=torch.float32, device=xf.device) if splits > 1 else None
    sa = _simt_align(n)
    rc = fn(
        xf.data_ptr(), _ptr(w.q, layer, sa), _ptr(w.scale, layer, sa), _ptr(w.bias, layer, sa),
        _ptr(w.sup, layer, sa), _ptr(w.sup_min, layer, sa),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        b, k, n, w.group, int(w.packed), _KINDS[w.scale.dtype], bias_kind,
        int(compute_dtype == torch.bfloat16), rb, splits, gps, stream,
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
_I4_TC_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_I4_MMA_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


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
    if g not in (16, 32) or k % g or n < 1:
        raise ValueError(f"qmm_i4 needs G in (16, 32), K % G == 0, N >= 1 "
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
    k, n = _dims(w)
    b = x2.shape[0]
    if x2.shape[1] != k:
        raise ValueError(f"x has K={x2.shape[1]}, weight K={k}")
    if b == 0:
        return x2.new_empty((0, n))
    route = _route(b, k, n, compute_dtype, tc_form(w))
    fn = _build.kernel(*{"tc": ("qmm_i4_tc_launch", _I4_TC_ARGTYPES),
                         "mma": ("qmm_i4_mma_launch", _I4_MMA_ARGTYPES),
                         "simt": ("qmm_i4_launch", _I4_ARGTYPES)}[route])
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    bias_kind = -1 if w.bias is None else _KINDS[w.bias.dtype]
    a = _TC_ALIGN
    if route == "tc":
        plan = _tc_plan(b, k, n, w.group, tc_form(w))
        xf = _scratch_x(x2)
        xb = torch.empty((b, k), dtype=torch.bfloat16, device=xf.device)
        out = torch.empty((b, n), dtype=torch.float32, device=xf.device)
        partial = (torch.empty((plan.splits, b, n), dtype=torch.float32, device=xf.device)
                   if plan.splits > 1 else None)
        rc = fn(
            xf.data_ptr(), xb.data_ptr(), _ptr(w.q, layer, a), _ptr(w.scale, layer, a),
            _ptr(w.bias, layer, a), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            b, k, n, w.group, _KINDS[w.scale.dtype], bias_kind, plan.rows, plan.stages,
            plan.splits, plan.steps_per_split, plan.smem_bytes, stream,
        )
        _build.check(rc, "qmm_i4_tc_launch")
        _build.launches["qmm_i4_tc"] += 1
        return out
    if route == "mma":
        plan = _mma_plan(b, k, n, w.group, tc_form(w))
        xf = _scratch_x(x2)
        out = torch.empty((b, n), dtype=torch.float32, device=xf.device)
        partial = (torch.empty((plan.splits, b, n), dtype=torch.float32, device=xf.device)
                   if plan.splits > 1 else None)
        rc = fn(
            xf.data_ptr(), _ptr(w.q, layer, a), _ptr(w.scale, layer, a), _ptr(w.bias, layer, a),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            b, k, n, w.group, _KINDS[w.scale.dtype], bias_kind, plan.splits,
            plan.steps_per_split, plan.smem_bytes, stream,
        )
        _build.check(rc, "qmm_i4_mma_launch")
        _build.launches["qmm_i4_mma"] += 1
        return out
    xf = x2.float().contiguous()
    rb, splits, gps = simt_config(b, k, n, w.group)
    out = torch.empty((b, n), dtype=torch.float32, device=xf.device)
    partial = torch.empty((splits, b, n), dtype=torch.float32, device=xf.device) if splits > 1 else None
    sa = _simt_align(n)
    rc = fn(
        xf.data_ptr(), _ptr(w.q, layer, sa), _ptr(w.scale, layer, sa), _ptr(w.bias, layer, sa),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        b, k, n, w.group, _KINDS[w.scale.dtype], bias_kind,
        int(compute_dtype == torch.bfloat16), rb, splits, gps, stream,
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
