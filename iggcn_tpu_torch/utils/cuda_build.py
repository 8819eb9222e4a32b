"""Build the port's CUDA kernels from `csrc/` at first use.

Each `csrc/*.cu` source is compiled by `nvcc` on its own into a shared
library with a plain C interface, which the kernel's wrapper loads with
`ctypes`. Libraries land in `iggcn_tpu_torch/_build/` (git-ignored), named
by a hash of the source, every header under `csrc/` (`*.cuh`) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. `build_all` starts one `nvcc` per source, all at
once, and waits for them together.
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


def load_library(source: str) -> ctypes.CDLL:
    """The built library of `csrc/<source>`, compiled on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(build_all([source])[source])
            _libs[source] = lib
        return lib
