"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
The first use builds every kernel at once — one ``nvcc`` process per
source, all started together — into ``windflow_tpu_torch/build/``, keyed
by a hash of the source, so a later process reuses what is there.
Nothing here runs at import: the CPU tests import this module on
machines without ``nvcc``.  A missing ``nvcc`` where a kernel is needed
is an error, never a reason to fall back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

from windflow_tpu_torch.basic import WindFlowError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

#: kernel name -> source file under csrc/
SOURCES = {
    "grouping_rank_hist": "grouping_rank_hist.cu",
    "sliding_fold": "sliding_fold.cu",
    "dense_monoid_table": "dense_monoid_table.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: the C signature of each library's entry point: (name, argtypes)
SIGNATURES = {
    "grouping_rank_hist": ("wf_grouping_rank_hist",
                           [_P, _I, _I, _P, _P, _P, _P, _P]),
    "sliding_fold": ("wf_sliding_fold",
                     [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "dense_monoid_table": ("wf_dense_monoid_table",
                           [_P, _I, _I, _I, _P, _P, _I, _P]),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: seconds the last build_all() spent in nvcc (0.0 when all were cached)
last_build_seconds = 0.0
#: nvcc compilations run in this process
nvcc_runs = 0


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise WindFlowError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels cannot be built; Config(cuda_kernels='0') runs the plain "
        "torch composition instead")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:12]}.so")


def build_all() -> float:
    """Compile every kernel that is not built yet, all ``nvcc`` processes
    running together; load every library.  Returns the build seconds."""
    global last_build_seconds, nvcc_runs
    with _lock:
        todo = {n: _lib_path(n) for n in SOURCES
                if n not in _libs}
        missing = {n: p for n, p in todo.items() if not os.path.exists(p)}
        t0 = time.perf_counter()
        if missing:
            nvcc = nvcc_path()
            os.makedirs(BUILD_DIR, exist_ok=True)
            procs = {}
            for n, p in missing.items():
                tmp = f"{p}.{os.getpid()}.tmp"
                procs[n] = (subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp,
                     os.path.join(CSRC, SOURCES[n])],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                    tmp, p)
            errors = []
            for n, (proc, tmp, p) in procs.items():
                out, _ = proc.communicate()
                nvcc_runs += 1
                if proc.returncode != 0:
                    errors.append(f"{SOURCES[n]}:\n{out.decode()[-4000:]}")
                else:
                    os.replace(tmp, p)
            if errors:
                raise WindFlowError("nvcc failed:\n" + "\n".join(errors))
        last_build_seconds = time.perf_counter() - t0
        for n, p in todo.items():
            lib = ctypes.CDLL(p)
            fn_name, argtypes = SIGNATURES[n]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[n] = lib
        return last_build_seconds


def entry(name: str):
    """The C entry point of kernel ``name``, building on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return getattr(lib, SIGNATURES[name][0])
