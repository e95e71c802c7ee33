"""Build the port's hand-written kernels and load them with ctypes.

Every kernel source under ``csrc/`` has a plain C interface and is compiled
on its own into a shared library under ``build/kernels/`` at first use: a
``.cu`` file by ``nvcc`` for ``sm_90a`` (:func:`build`), the host popcount
kernels ``asmk_kernels.cpp`` by ``g++`` (:func:`build_host`). The library's
name carries a digest of the source and the flags, so a changed source or
flag set never loads a stale library. Nothing here runs when a module is
imported.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# portable code only: build/ may be copied to another host of the same kind
HOST_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's kernels are built from source at first use")


def cxx() -> str:
    for c in (os.environ.get("CXX"), "g++"):
        path = shutil.which(c) if c else None
        if path:
            return path
    raise RuntimeError("g++ not found: the host popcount kernels are built from source at first use")


def library_path(src: pathlib.Path, flags=None) -> pathlib.Path:
    flags = NVCC_FLAGS if flags is None else flags
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def _compile(src: pathlib.Path, compiler: str, flags):
    out = library_path(src, flags)
    if out.exists():
        return 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{pathlib.Path(compiler).name} failed on {src.name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def build(src: pathlib.Path):
    """Compile the CUDA source ``src`` unless that exact source was built
    already. Returns (seconds compiling, 0.0 when cached; the compiler's
    output, with ptxas' register and spill report). Raises with that output
    when nvcc fails."""
    return _compile(src, nvcc(), NVCC_FLAGS)


def build_host(src: pathlib.Path):
    """The same for a host C++ source, compiled by ``g++`` (``$CXX``)."""
    return _compile(src, cxx(), HOST_FLAGS)
