"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
for ``sm_90a`` at first use, all sources at once in parallel, into
``build/repro_torch/<hash>/`` at the repository root, where ``<hash>``
covers the sources, the shared header and the flags — an edited source
builds anew, an unchanged one loads the library already there.  Nothing is
compiled or loaded at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["SOURCES", "DTYPE_CODES", "build_all", "build_sources", "load",
           "load_library", "dtype_code"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("spmv_dia", "krylov_fused", "coef_update", "stencil_assembly",
           "krylov_loop")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

# (storage, accum) pairs the kernels are instantiated for (csrc/common.cuh)
DTYPE_CODES = {
    (torch.float64, torch.float64): 0,
    (torch.float32, torch.float32): 1,
    (torch.bfloat16, torch.float32): 2,
}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    "spmv_dia": {
        "spmv_dia_launch": [ctypes.c_int, _P, _P, _P, _I64, _I64,
                            ctypes.POINTER(_I64), ctypes.c_int, _I64, _P],
        "spmv_dia_guarded_launch": [ctypes.c_int, _P, _P, _P, _I64, _I64,
                                    ctypes.POINTER(_I64), ctypes.c_int, _I64,
                                    _P, _P, _P],
    },
    "krylov_fused": {
        "spmv_dot_launch": [ctypes.c_int, _P, _P, _P, _P, _I64, _I64,
                            ctypes.POINTER(_I64), ctypes.c_int, _I64, _I64,
                            _P],
        "spmv_dot_guarded_launch": [ctypes.c_int, _P, _P, _P, _P, _I64, _I64,
                                    ctypes.POINTER(_I64), ctypes.c_int, _I64,
                                    _I64, _P, _P, _P],
        "axpy_precond_launch": [ctypes.c_int] + [_P] * 11 + [_I64, _P],
        "axpy_precond_inplace_launch": [ctypes.c_int] + [_P] * 11
        + [_I64, _I64, _I64, _P, _P, _P],
        "spmv_dot_direction_launch": [ctypes.c_int] + [_P] * 8
        + [_I64, _I64, ctypes.POINTER(_I64), ctypes.c_int, _I64, _I64, _P,
           _P, _P],
    },
    "krylov_loop": {
        "cg_direction_launch": [ctypes.c_int, _P, _P, _P, _P, _I64, _I64, _P,
                                _P, _P],
        "cg_alpha_launch": [ctypes.c_int, _P, _I64, _I64, _P, _P, _P, _I64,
                            _P, _P, _P],
        "cg_advance_launch": [ctypes.c_int] + [_P] * 7
        + [ctypes.c_int, _P, _P, _P, _I64, _I64, _I64, _P, _P],
    },
    "coef_update": {"coef_update_launch": [ctypes.c_int, _P, _P, _P, _I64,
                                           _I64, _I64, _P]},
    "stencil_assembly": {
        "momentum_bands_launch": [ctypes.c_int] + [_P] * 8
        + [_I64] * 4 + [ctypes.c_double, _P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def dtype_code(storage: torch.dtype, accum: torch.dtype) -> int:
    try:
        return DTYPE_CODES[(storage, accum)]
    except KeyError:
        raise TypeError(
            f"no kernel instantiation for storage {storage} with accum "
            f"{accum}; supported: {list(DTYPE_CODES)}") from None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode() + f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return _build_dir() / f"lib{name}.so"


def build_sources(csrc: Path, names, out_dir: Path) -> dict:
    """Compile ``csrc/<name>.cu`` for each of ``names`` into
    ``out_dir/lib<name>.so``, all at once in parallel, skipping a library
    already there.

    Returns ``{"seconds": wall, "built": [...], "ptxas": {name: log}}``
    (the ``-Xptxas -v`` log of every name, kept beside its library); raises
    with the compiler's output if any build fails.
    """
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"lib{n}.so").exists()]
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        (out_dir / f"{name}.log").write_text(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    logs = {n: (out_dir / f"{n}.log").read_text() for n in names
            if (out_dir / f"{n}.log").exists()}
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return {"seconds": time.perf_counter() - t0, "built": todo,
            "ptxas": logs}


def build_all() -> dict:
    """Compile every source of the package not yet built (see
    :func:`build_sources`)."""
    return build_sources(CSRC, SOURCES, _build_dir())


def load_library(path: Path, name: str,
                 signatures: dict | None = None) -> ctypes.CDLL:
    """Load the library of ``<name>.cu`` at ``path``, its entry points typed
    by ``signatures`` (``{entry point: argtypes}``; default this tree's) —
    an entry point the library lacks, as another checkout's older build
    may, is left out."""
    lib = ctypes.CDLL(str(path))
    sigs = _SIGNATURES[name] if signatures is None else signatures
    for fn, argtypes in sigs.items():
        if not hasattr(lib, fn):
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build_all()
        lib = _loaded[name] = load_library(_lib_path(name), name)
    return lib
