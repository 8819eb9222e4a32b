"""Build the port's CUDA kernels from `csrc/` at first use.

Each `csrc/*.cu` source is compiled by `nvcc` on its own into a shared
library with a plain C interface, which the kernel's wrapper loads with
`ctypes`. Libraries land in `iggcn_tpu_torch/_build/` (git-ignored), named
by a hash of the source, every header under `csrc/` (`*.cuh`) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. `build_all` starts one `nvcc` per source, all at
once, and waits for them together.

`load_host_library` does the same for a host C++ source (`csrc/*.cpp`,
the native diffusion library) with the host compiler, `$CXX` or `g++`,
with OpenMP where that compiler has its runtime.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
# -Xptxas -v makes ptxas report each kernel's registers, shared memory
# and spills; the log is kept in `BUILD_LOGS`
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_LOGS: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of `nvcc`: $CUDA_HOME/bin, then PATH, then the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                       "to build the port's kernels")


def _target(source: str, flags: Sequence[str]) -> Tuple[str, str]:
    src = os.path.join(CSRC_DIR, source)
    digest = hashlib.sha1(" ".join(flags).encode())
    for path in [src, *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + b"\0" + fh.read())
    stem = os.path.splitext(source)[0]
    return src, os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:12]}.so")


def build_all(sources: Sequence[str],
              extra_flags: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every source in `sources` (names under `csrc/`) that has no
    up-to-date library yet, one `nvcc` process each, all started together.
    `extra_flags` go to nvcc after `NVCC_FLAGS` (e.g. a -D for a
    diagnostic build; it gets a library of its own). Returns {source:
    library path}; raises with nvcc's output on failure."""
    flags = (*NVCC_FLAGS, *extra_flags)
    paths, procs = {}, {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    for source in sources:
        src, out = _target(source, flags)
        paths[source] = out
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[source] = (tmp, out, subprocess.Popen(
            [find_nvcc(), *flags, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for source, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[source] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{source} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent process never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared")
# OpenMP parallelises a host library over its batch where the compiler has
# it; a compiler without its runtime (no libgomp) builds it serial
HOST_OPENMP = "-fopenmp"


def _host_build(cxx: str, flags: Sequence[str], src: str, out: str
                ) -> subprocess.CompletedProcess:
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *flags, src, "-o", tmp],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the host compiler {cxx!r} for "
                           f"{os.path.relpath(src, PKG_DIR)}: {e}") from e
    if proc.returncode == 0:
        os.replace(tmp, out)
    return proc


def load_host_library(source: str) -> ctypes.CDLL:
    """The library of the host C++ source `csrc/<source>`, compiled by the
    host compiler (`$CXX`, else `g++`) at first use, with OpenMP where the
    compiler has it; raises with the compiler's output when it cannot be
    built (there is no fallback)."""
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        cxx = os.environ.get("CXX") or "g++"
        os.makedirs(BUILD_DIR, exist_ok=True)
        logs = []
        for flags in ((*HOST_FLAGS, HOST_OPENMP), HOST_FLAGS):
            src, out = _target(source, (cxx, *flags))
            if os.path.exists(out):
                break
            proc = _host_build(cxx, flags, src, out)
            logs.append(f"{' '.join([cxx, *flags])}: exit {proc.returncode}"
                        f"\n{proc.stdout}{proc.stderr}")
            if proc.returncode == 0:
                break
            if "omp" not in proc.stdout + proc.stderr:
                break          # not OpenMP's fault: do not try without it
        BUILD_LOGS[source] = "\n".join(logs)
        if not os.path.exists(out):
            raise RuntimeError(f"{cxx} failed on csrc/{source}:\n"
                               + BUILD_LOGS[source])
        lib = ctypes.CDLL(out)
        _libs[source] = lib
        return lib


def load_library(source: str) -> ctypes.CDLL:
    """The built library of `csrc/<source>`, compiled on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(build_all([source])[source])
            _libs[source] = lib
        return lib
