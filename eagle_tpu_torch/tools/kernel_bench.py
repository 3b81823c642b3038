"""Quantized-matmul kernel benchmark on the card (port of
eagle_tpu/tools/kernel_bench.py).

    python -m eagle_tpu_torch.tools.kernel_bench [--k 4096] [--n 11008] [--b 8]
        [--group 32] [--variants packed,int8,int4,dense,split4] [--device cuda]

Runs one logical matmul x[B, K] @ W[K, N] (by default Vicuna-7B's FFN width,
8 rows) in each weight form, with the reference's weights: the same draws
from `np.random.default_rng(0)` in the same order. Variants:

    dense      torch.matmul on bf16 weights (outside the kernels, as the
               reference's dense row is outside Pallas)
    packed     qmm, 4-bit codes two per byte, bf16 scale and bias
    int8       qmm, one code per byte
    coded      qmm, packed codes with int8 sub-scale codes and f32
               super-scales
    stacked    qmm_stacked over a layer stack of the packed weight
    split4     qmm over four quarter-width weights, concatenated
    int4       qmm_i4, signed nibbles q - 8 with the same scale and bias
    i4stacked  qmm_i4_stacked, q - 8 with +8*scale folded into the bias

The reference's `split`, `nosplit`, `codedres`, `codedsplit` and `tiles`
are TPU layout and tile-sweep experiments that do not port; asking for one
raises.

Before timing, each variant's output is held against its plain version
(relative error <= 1e-2). Each line gives the time per call on the card
(a CUDA-graph replay timed with CUDA events, `timing.device_ms`, so the
host's launch overhead does not count), the bytes
one call must move (weights, x and y) over that time, and that time's share
of the byte bound at 3.35 TB/s. The H100's 50 MB L2 would hold a weight
across back-to-back calls, so every variant is timed over enough copies of
its weight (layers of the stack for the stacked variants) that the copies
take at least twice the L2, cycled call by call; the line says how many.

`--device cpu` runs the plain versions once, checks them and times nothing:
it is for the tests."""

from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch

from .._device import resolve_device
from ..ops.qmm import qmm, qmm_i4, qmm_i4_plain, qmm_i4_stacked, qmm_plain, qmm_stacked
from ..quant.qtensor import QTensor, pack_int4
from ..quant.serving import _pack_q
from ..timing import device_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
L2_BYTES = 50 * 2**20  # the H100's L2: 50 MB
TOL = 1e-2
VARIANTS = ("dense", "packed", "int8", "coded", "stacked", "split4", "int4", "i4stacked")
TPU_ONLY = ("split", "nosplit", "codedres", "codedsplit", "tiles")
REPS = 50  # timed calls per variant


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--n", type=int, default=11008)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--group", type=int, default=32)
    ap.add_argument("--variants", default="packed,int8,int4,dense,split4")
    ap.add_argument("--device", default="cuda", help="'cpu' checks the plain versions untimed")
    return ap.parse_args(argv)


def variant_names(spec: str) -> list[str]:
    names = [v for v in spec.split(",") if v]
    for v in names:
        if v in TPU_ONLY:
            raise ValueError(f"variant {v!r} is a TPU layout or tile-sweep experiment of the "
                             "reference; it does not port to the card")
        if v not in VARIANTS:
            raise ValueError(f"unknown variant {v!r}; ported: {', '.join(VARIANTS)}")
    return names


def make_inputs(k: int, n: int, b: int, g: int, coded: bool) -> dict[str, np.ndarray]:
    """The reference's host arrays, drawn in its order."""
    rng = np.random.default_rng(0)
    out = {"q_codes": rng.integers(0, 16, size=(k, n), dtype=np.int8),
           "scale": (rng.standard_normal((k // g, n)) * 0.01).astype(np.float32),
           "bias": (rng.standard_normal((k // g, n)) * 0.001).astype(np.float32),
           "w_dense": (rng.standard_normal((k, n)) * 0.01).astype(np.float32),
           "x": (rng.standard_normal((b, k)) * 0.1).astype(np.float32)}
    if coded:
        out["codes"] = rng.integers(1, 64, size=(k // g, n)).astype(np.int8)
        out["mcodes"] = rng.integers(0, 64, size=(k // g, n)).astype(np.int8)
        out["sup"] = (np.abs(rng.standard_normal((k // 256, n))) * 0.01 + 1e-3).astype(np.float32)
        out["sup_min"] = (np.abs(rng.standard_normal((k // 256, n))) * 1e-3).astype(np.float32)
    return out


class Bench:
    """The weight forms of one run on one device, built from `make_inputs`."""

    def __init__(self, args: argparse.Namespace, names: list[str], dev: torch.device):
        k, n, g = args.k, args.n, args.group
        self.k, self.n, self.b, self.g, self.dev, self.names = k, n, args.b, g, dev, names
        h = make_inputs(k, n, args.b, g, "coded" in names)
        t = {key: torch.from_numpy(v).to(dev) for key, v in h.items()}
        bf16 = torch.bfloat16
        sc, bi = t["scale"].to(bf16), t["bias"].to(bf16)
        self.x = t["x"]
        self.forms = {
            "dense": t["w_dense"].to(bf16),
            "int8": QTensor(q=t["q_codes"], scale=sc, bias=bi, group=g, layout="kn"),
            "packed": QTensor(q=_pack_q(t["q_codes"], g), scale=sc, bias=bi, group=g,
                              layout="kn", packed=True),
            "int4": QTensor(q=pack_int4(t["q_codes"] - 8, g), scale=sc, bias=bi, group=g,
                            layout="kn", int4=True),
            # w = s * (c - 8) + (b + 8 s): the zero-point folded into the bias
            "i4stacked": QTensor(q=pack_int4(t["q_codes"] - 8, g), scale=sc,
                                 bias=(t["bias"] + 8.0 * t["scale"]).to(bf16), group=g,
                                 layout="kn", int4=True),
        }
        if "codes" in t:
            self.forms["coded"] = QTensor(q=self.forms["packed"].q, scale=t["codes"],
                                          bias=t["mcodes"], group=g, layout="kn", packed=True,
                                          sup=t["sup"], sup_min=t["sup_min"])
        self.forms["stacked"] = self.forms["split4"] = self.forms["packed"]
        q4 = k * n // 2 + (k // g) * n * 2 * 2
        self.weight_bytes = {
            "dense": k * n * 2, "packed": q4, "int8": k * n + (k // g) * n * 2 * 2,
            "coded": k * n // 2 + (k // g) * n * 2 + (k // 256) * n * 8, "stacked": q4,
            "split4": q4, "int4": q4, "i4stacked": q4}

    def copies(self, name: str) -> int:
        """Copies of the weight whose bytes take at least twice the L2."""
        return max(2, math.ceil(2 * L2_BYTES / self.weight_bytes[name]))

    def runner(self, name: str, c: int):
        """fn(x, i) for call i, cycling over c copies of the weight."""
        w = self.forms[name]
        if name == "dense":
            ws = [w] + [w.clone() for _ in range(c - 1)]
            return lambda x, i: torch.matmul(x.to(torch.bfloat16), ws[i % c])
        if name in ("stacked", "i4stacked"):
            st = _map(w, lambda v: torch.stack([v] * c))
            fn = qmm_stacked if name == "stacked" else qmm_i4_stacked
            return lambda x, i: fn(x, st, i % c)
        ws = [w] + [_map(w, torch.clone) for _ in range(c - 1)]
        if name == "split4":
            q = self.n // 4
            parts = [[_map(wc, lambda v, j=j: v[:, j * q:(j + 1) * q].contiguous())
                      for j in range(4)] for wc in ws]
            return lambda x, i: torch.cat([qmm(x, p) for p in parts[i % c]], dim=-1)
        fn = qmm_i4 if name == "int4" else qmm
        return lambda x, i: fn(x, ws[i % c])

    def plain(self, name: str) -> torch.Tensor:
        w = self.forms[name]
        if name == "dense":
            return self.x.to(torch.bfloat16).float() @ w.float()
        if name in ("int4", "i4stacked"):
            return qmm_i4_plain(self.x, w)
        return qmm_plain(self.x, w)

    def check(self) -> dict[str, float]:
        """Each variant's output against its plain version; raises past TOL.
        Returns the relative errors."""
        errs = {}
        for name in self.names:
            got, want = self.runner(name, 1)(self.x, 0).float(), self.plain(name)
            err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            if not bool(torch.isfinite(got).all()) or err > TOL:
                raise AssertionError(f"{name}: rel err {err:.3e} against the plain version "
                                     f"(limit {TOL})")
            errs[name] = err
            print(f"{name:>10}: within {err:.1e} of its plain version", flush=True)
        return errs

    def time(self) -> list[dict]:
        """Time per call of each variant on the card, cycling over copies of
        its weight that take twice the L2."""
        io_bytes = self.b * self.k * 4 + self.b * self.n * 4
        results = []
        for name in self.names:
            c = self.copies(name)
            fn = self.runner(name, c)
            ms = device_ms(lambda i: fn(self.x, i), REPS)
            n_bytes = self.weight_bytes[name] + io_bytes
            res = {"variant": name, "copies": c, "bytes": n_bytes,
                   "working_set_bytes": c * self.weight_bytes[name], "us": ms * 1e3,
                   "gb_per_s": n_bytes / ms / 1e6,
                   "bound_share": n_bytes / HBM_BYTES_PER_S / (ms / 1e3)}
            print(f"{name:>10}: {res['us']:8.1f} us/call  {res['gb_per_s']:7.1f} GB/s effective  "
                  f"{100 * res['bound_share']:5.1f}% of the byte bound  ({c} copies, "
                  f"{res['working_set_bytes'] / 2**20:.0f} MiB timed)", flush=True)
            results.append(res)
            del fn
            torch.cuda.empty_cache()
        return results


def _map(w: QTensor, fn) -> QTensor:
    """`w` with fn applied to each of its tensors."""
    return dataclasses.replace(w, **{f: None if v is None else fn(v)
                                     for f, v in w.tensors().items()})


def run(args: argparse.Namespace) -> list[dict]:
    """Check every variant, then time each on the card; one result dict per
    variant (none on the CPU)."""
    dev = resolve_device(args.device)
    bench = Bench(args, variant_names(args.variants), dev)
    print(f"[kernel_bench] x[{args.b}, {args.k}] @ W[{args.k}, {args.n}], G={args.group}, "
          f"on {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}", flush=True)
    bench.check()
    if dev.type == "cpu":
        print("[kernel_bench] plain versions checked on the cpu; nothing timed", flush=True)
        return []
    return bench.time()


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
