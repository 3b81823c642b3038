"""The instruction budget of the 1-row qmm body, from its SASS (card only).

    python -m eagle_tpu_torch.tools.gemv_sass [--out FILE]

Builds the kernels (`_build.build`), disassembles the library with the CUDA
toolkit's `cuobjdump -sass`, and takes `qmm_gemv_kernel<G = 32, packed>` as
`qmm.cu` instantiates it (the Q4_K and Q4_0 forms). Its step loop is the
backward branch that spans the most code. The loop is counted by opcode,
statically: all of it (with the copy code of every form, of which a step
runs a part), and its math core (after the last copy instruction, up to the
last product: scales, dequant, x reads, products, the branches of every
scale kind included), per step of 64 weights a lane. Beside each count: the
issue time of wqkv's 50.3 M weights at that count, at 4 warp instructions
per clock on each of 132 SMs at the card's top SM clock (`nvidia-smi`).
`--out` keeps the function's SASS."""

from __future__ import annotations

import argparse
import collections
import pathlib
import re
import subprocess

KERNEL = "qmm_gemv_kernelILi32ELb1E"  # mangled qmm_gemv_kernel<32, true>
SOURCE = "qmm_cu"  # the instance in qmm.cu (ffn_tensor_core.cu has its own)
WEIGHTS_PER_STEP = 64  # weights a lane takes per step of the loop
WQKV_WEIGHTS = 12288 * 4096
SMS, ISSUE_PER_CLOCK = 132, 4


def kernel_sass(sass: str, kernel: str = KERNEL, source: str = SOURCE) -> str:
    """The one function of `cuobjdump -sass` output whose name holds both
    `kernel` and `source`."""
    found = [f for f in sass.split("Function : ")
             if kernel in f.split("\n", 1)[0] and source in f.split("\n", 1)[0]]
    if len(found) != 1:
        raise ValueError(f"{len(found)} functions named like {kernel} in {source}")
    return found[0]


def _opcode(text: str) -> str:
    return (text.split()[1] if text.startswith("@") else text.split()[0]).split(".")[0]


def step_loop(fn: str) -> tuple[collections.Counter, collections.Counter]:
    """(opcodes of the longest backward-branch loop, opcodes of its math
    core) of one function's SASS."""
    ins = [(int(a, 16), t.strip())
           for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
    loops = [(a - int(m.group(1), 16), int(m.group(1), 16), a) for a, t in ins
             for m in [re.search(r"BRA\s+0x([0-9a-f]+)", t)]
             if m and int(m.group(1), 16) < a]
    if not loops:
        raise ValueError("no backward branch: no loop in this function")
    _, lo, hi = max(loops)
    body = [(a, _opcode(t)) for a, t in ins if lo <= a <= hi]
    copies = [a for a, o in body if o in ("LDGSTS", "LDGDEPBAR")]
    products = [a for a, o in body if o == "HMMA"]
    if not copies or not products:
        raise ValueError("the loop holds no asynchronous copy or no product")
    last_copy, last_mma = max(copies), max(products)
    core = collections.Counter(o for a, o in body if last_copy < a <= last_mma)
    return collections.Counter(o for _, o in body), core


def issue_us(n_per_step: int, mhz: float) -> float:
    """wqkv's issue time at n_per_step warp instructions per step."""
    steps = WQKV_WEIGHTS / WEIGHTS_PER_STEP / 32  # warp steps: 32 lanes each
    return steps * n_per_step / (SMS * ISSUE_PER_CLOCK) / mhz


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the function's SASS here")
    args = ap.parse_args(argv)

    from .. import _build

    lib, _ = _build.build()
    cuobjdump = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    fn = kernel_sass(sass)
    if args.out:
        pathlib.Path(args.out).write_text(fn)
    loop, core = step_loop(fn)
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    n_loop, n_core = sum(loop.values()), sum(core.values())
    top = ", ".join(f"{k} {v}" for k, v in core.most_common(8))
    print(f"[sass] qmm_gemv_kernel<32, packed> step loop ({WEIGHTS_PER_STEP} weights a lane): "
          f"{n_loop} instructions (static, {n_loop / WEIGHTS_PER_STEP:.2f} per weight; wqkv "
          f"{issue_us(n_loop, mhz):.2f} us of issue at {mhz:.0f} MHz); its math core {n_core} "
          f"({n_core / WEIGHTS_PER_STEP:.2f} per weight: {top}; wqkv "
          f"{issue_us(n_core, mhz):.2f} us)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
