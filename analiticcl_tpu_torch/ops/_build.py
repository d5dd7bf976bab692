"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes; :func:`load_all` runs one ``nvcc`` per source at
once)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>_<hash>.so csrc/<name>.cu

The output goes to ``build/analiticcl_tpu_torch/`` beside the package, keyed
by a hash of the source and the flags, so an edited kernel rebuilds and an
unchanged one loads at once. A file lock keeps parallel processes from racing
on one build. The ptxas report (registers, shared memory, spills) is kept next
to the library as ``<lib>.log``.

Every C entry point returns ``cudaGetLastError()`` after its launch; callers
raise through :func:`check`. A missing ``nvcc`` or a failed build raises:
there is no fallback to the plain PyTorch versions for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "analiticcl_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p
SIGNATURES = {
    # each ends with the stream and the wide path's work list and counters
    "dl_lcs": {
        "analiticcl_dl_lcs": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                              _P],
        "analiticcl_dl_lcs_slots": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # slots and tables
            _I, _P, _P,  # table element bytes, outputs
            _I, _I, _I, _P, _P, _P,  # P, L, W, stream, work list
        ],
        "analiticcl_dl_lcs_slots_scored": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # slots and tables
            _I,  # table element bytes
            _P, _P, _I, _P, _P, _P, _P,  # pc_band, exact bits, nb8, flags,
            # freqs, weights, threshold
            _P, _P, _P, _P, _P,  # keep, metrics, max_freq, score, counts
            _I, _I, _I, _P, _P, _P,  # P, L, W, stream, work list
        ],
    },
    "compact": {
        "analiticcl_compact": [
            _P, _I, _I,  # counts, their number, slots per count
            _P, _P, _P, _P, _I, _P, _P,  # keep, q, pc, metrics, their
            # element bytes, max_freq, total_match
            _P, _I, _I, _I, _P,  # out, B, P, P2, stream
        ],
    },
    "planes": {
        "analiticcl_planes": [
            _P, _P, _P,  # q_counts, planes, totals
            _I, _I, _I, _I, _P,  # B, A, T, at_pad, stream
        ],
    },
    "resolve": {
        "analiticcl_resolve": [
            _P, _P, _P, _P,  # inputs
            _P, _P, _P, _P, _P,  # outputs
            _I, _I, _I, _I, _P,  # B, M_band, bt, P, stream
        ],
    },
    "stage_a": {
        "analiticcl_stage_a": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P,  # inputs, extents
            _P, _P, _P, _P, _P,  # outputs
            _I, _I, _I, _I, _I, _I,  # B, at_pad, width, nb_band, bt, qt
            _I, _P,  # instance, stream
        ],
        "analiticcl_stage_a_route": [_I, _I, _I, ctypes.c_longlong],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _build(name: str, so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # another process built it while we waited
            return
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu ({proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        build_seconds[name] = time.perf_counter() - t0
        Path(str(so) + ".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (building it first if needed)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    so = _library_path(name)
    if not so.exists():
        _build(name, so)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def load_all(names) -> None:
    """Load the kernel libraries ``names``, building those not yet built
    at once: one ``nvcc`` per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        list(pool.map(load, names))


def ptxas_report(name: str) -> str:
    """What ptxas said about ``name``'s kernels when they were built."""
    log = Path(str(_library_path(name)) + ".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
