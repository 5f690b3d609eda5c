"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under
``build/repro_torch/`` at the repository root, at first use (never at
import).  The file name carries a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is reused.  All missing
libraries are compiled at once, one ``nvcc`` process per source, and loaded
with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# exported launcher of each source: (name, pointer args, int args, float
# args), in that order; every launcher takes the CUDA stream last and
# returns cudaGetLastError()
LAUNCHERS = {
    "placement_power": ("placement_power_launch", 9, 7, 0),
    "fused_anneal": ("fused_anneal_launch", 19, 9, 0),
    "flash_attention": ("flash_attention_launch", 6, 10, 1),
    "flash_attention_wgmma": ("flash_attention_wgmma_launch", 6, 9, 1),
    "flash_attention_decode": ("flash_attention_decode_launch", 9, 11, 1),
}

# exported shared-memory queries of each source: (name, int args, int
# results); each writes its results through int pointers (the dynamic
# bytes its launcher requests and its kernel's static bytes; the device's
# opt-in limit) and returns a cudaError_t
QUERIES = {
    "placement_power": (("placement_power_smem", 2, 2),
                        ("device_smem_optin", 0, 1)),
    "fused_anneal": (("fused_anneal_smem", 7, 2),),
    "flash_attention": (("flash_attention_smem", 3, 2),),
    "flash_attention_wgmma": (("flash_attention_wgmma_smem", 4, 2),),
    "flash_attention_decode": (("flash_attention_decode_smem", 5, 2),),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# nvcc / ptxas output of the last build of each source
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are compiled "
                           "from csrc/ at first use and need the CUDA "
                           "toolkit")
    return path


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    fn_name, n_ptr, n_int, n_float = LAUNCHERS[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_F] * n_float + [_P]
    fn.restype = ctypes.c_int
    for q_name, n_int, n_out in QUERIES[name]:
        q = getattr(lib, q_name)
        q.argtypes = [_I] * n_int + [ctypes.POINTER(_I)] * n_out
        q.restype = ctypes.c_int
    return lib


def build_all() -> float:
    """Compile every kernel library that is missing, all at once, and load
    them all; returns the seconds spent."""
    t0 = time.perf_counter()
    with _LOCK:
        todo = [n for n in LAUNCHERS if n not in _LIBS]
        jobs = []
        try:
            for name in todo:
                path = _library_path(name)
                if path.exists():
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                jobs.append((name, tmp, path, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for name, tmp, path, proc in jobs:
                BUILD_LOG[name] = proc.communicate()[0]
                if proc.returncode != 0:
                    failed.append(name)
                else:
                    os.replace(tmp, path)
        finally:
            for _, _, _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {n}.cu ---\n{BUILD_LOG[n]}" for n in failed))
        for name in todo:
            _LIBS[name] = _load(name, _library_path(name))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def query(name: str, fn_name: str, *ints: int) -> Tuple[int, ...]:
    """The int results of the exported query ``fn_name`` of
    ``csrc/<name>.cu`` (``QUERIES``) at ``ints``; raises on its error."""
    n_out = next(q[2] for q in QUERIES[name] if q[0] == fn_name)
    outs = [_I(0) for _ in range(n_out)]
    err = getattr(library(name), fn_name)(
        *ints, *(ctypes.byref(o) for o in outs))
    if err != 0:
        raise RuntimeError(f"{fn_name}{ints} failed: CUDA error {err}")
    return tuple(o.value for o in outs)
