"""Build and bind the port's CUDA kernels (no JAX counterpart).

Every `csrc/*.cu` compiles with its own nvcc process, all started together,
into an object file; one more nvcc call links them into one shared library
with a plain C interface, loaded with ctypes (pointers and the stream as
`c_void_p`, ints as `c_int`). The library lands in `.build/` beside this
file (git-ignored), named by a hash of the sources, so an edited kernel
rebuilds and an unchanged one loads at once. Sources come from the
repository only.

Each C entry point returns `cudaGetLastError()` after its launches; `check`
raises on a nonzero value. The launch counters below are what `chip_smoke.py`
reads to show that the main path ran through the kernels."""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / ".build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

#: kernel name -> launches since the last reset (one per wrapper call that
#: launched the kernel); "qmm_tc" and "qmm_i4_tc" count the wgmma route of
#: qmm and qmm_i4, "qmm_mma" and "qmm_i4_mma" their small-row mma.sync
#: route, "qmm_gemv" qmm's 1-row route, "qmm" and "qmm_i4" their SIMT route;
#: "flash_decode_mma_cluster" and "flash_decode_wgmma" count flash_decode's
#: two routes at head width 256 (bf16), each launch also counted under
#: "flash_decode"
launches: dict[str, int] = {"qmm": 0, "flash_decode": 0, "flash_prefill": 0,
                             "ffn_out_norm": 0, "gate_up_act": 0, "qmm_i4": 0,
                             "qmm_tc": 0, "qmm_i4_tc": 0, "qmm_mma": 0, "qmm_gemv": 0,
                             "qmm_i4_mma": 0, "flash_decode_mma_cluster": 0,
                             "flash_decode_wgmma": 0}
#: kernel name -> calls of its plain PyTorch version since the last reset
plain_calls: dict[str, int] = {k: 0 for k in launches}

_lib: ctypes.CDLL | None = None
_fns: dict[str, ctypes._CFuncPtr] = {}


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this host")
    return path


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernels if the library for these sources is missing.
    Returns (library path, compiler output). The output holds ptxas'
    report (registers, shared memory and spills per kernel); it is saved
    beside the library and read back when the library is already built."""
    sources = _sources()
    lib_path = BUILD_DIR / f"libeagle_kernels_{_digest(sources)}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        return lib_path, log_path.read_text() if log_path.exists() else ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    procs = []
    for src in sources:  # one nvcc per source, all started together
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c", str(src), "-o",
               str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        for _, obj, _ in procs:
            obj.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{lib_path.name}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    report = "\n".join(log)
    log_path.write_text(report)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    return lib_path, report


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build()
        _lib = ctypes.CDLL(str(path))
    return _lib


def kernel(name: str, argtypes: list):
    """C entry point `name` of the kernel library, built at first use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError {rc}")
