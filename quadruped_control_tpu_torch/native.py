"""ctypes loader for the native (C++) active-set QP solver (counterpart of
``quadruped_control_tpu/native.py``).

``native/libquadruped_native.so`` (source ``native/active_set_qp.cc``, plain
C ABI version 1) is the host-side, double-precision, OpenMP-batched oracle:
the qpOASES-equivalent used to validate the solvers at scale. It is a host
path, not a device one. The library in the repository is read in place;
this module never writes under ``native/``. Where that library is missing
and a build is asked for, ``g++`` compiles the source into the port's own
``_build/native/`` (git-ignored). Without a library the solve falls back to
the port's NumPy oracle (``solver/reference.py``), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_LIB_NAME = "libquadruped_native.so"
_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_BUILD_DIR = Path(__file__).resolve().parent / "_build" / "native"
_ABI_VERSION = 1
# native/Makefile's flags, less its warnings.
_CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-fopenmp",
              "-shared")


@functools.lru_cache(maxsize=None)
def _build(src: Path, out_dir: Path) -> Optional[Path]:
    """Compile ``src`` into ``out_dir/libquadruped_native.so``; None when
    there is no source or no ``g++``, or the compile fails (tried once per
    process)."""
    if not src.exists() or shutil.which("g++") is None:
        return None
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / _LIB_NAME
    tmp = out_dir / f"{_LIB_NAME}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), str(src)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _open(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.qp_active_set_solve_batch.restype = ctypes.c_int
    lib.qp_active_set_solve_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double)] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
    ]
    lib.qp_native_abi_version.restype = ctypes.c_int
    lib.qp_native_abi_version.argtypes = []
    version = lib.qp_native_abi_version()
    if version != _ABI_VERSION:
        raise RuntimeError(f"{path}: native ABI version {version}, expected "
                           f"{_ABI_VERSION}")
    return lib


def load_native(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    """The native library: ``native/`` in place, else the port's own build
    (made now if ``build_if_missing``); None if there is none."""
    path = _NATIVE_DIR / _LIB_NAME
    if not path.exists():
        path = _BUILD_DIR / _LIB_NAME
        if not path.exists() and build_if_missing:
            _build(_NATIVE_DIR / "active_set_qp.cc", _BUILD_DIR)
    if not path.exists():
        return None
    return _open(str(path))


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def solve_qp_batch_native(Q, c, G, h, x0, max_iter: int = 200):
    """Batched active-set solve through the native library.

    Args:
      Q: (B, n, n), c: (B, n), G: (B, m, n), h: (B, m), x0: (B, n) feasible
        starts — float64 NumPy arrays (or anything ``np.asarray`` takes),
        copied to C-contiguous float64 if they are not.
    Returns:
      (x, lam, kkt_err, status) with status 0 == optimal. Falls back to the
      NumPy oracle if the native library is unavailable.
    """
    lib = load_native()
    Q, c, G, h, x0 = (np.ascontiguousarray(a, dtype=np.float64)
                      for a in (Q, c, G, h, x0))
    B, n = c.shape
    m = h.shape[-1]
    want = {"Q": (B, n, n), "G": (B, m, n), "h": (B, m), "x0": (B, n)}
    got = {"Q": Q.shape, "G": G.shape, "h": h.shape, "x0": x0.shape}
    if got != want:
        raise ValueError(f"solve_qp_batch_native: shapes {got}, expected "
                         f"{want} from c {c.shape}")

    if lib is None:
        from quadruped_control_tpu_torch.solver.reference import (
            solve_qp_active_set,
        )

        x = np.zeros((B, n))
        lam = np.zeros((B, m))
        kkt = np.zeros(B)
        status = np.zeros(B, dtype=np.int32)
        for b in range(B):
            sol = solve_qp_active_set(Q[b], c[b], G[b], h[b], x0=x0[b],
                                      max_iter=max_iter)
            x[b], lam[b], kkt[b] = sol.x, sol.lam, sol.kkt_error
            status[b] = 0 if sol.status == "optimal" else 1
        return x, lam, kkt, status

    x = np.zeros((B, n), dtype=np.float64)
    lam = np.zeros((B, m), dtype=np.float64)
    kkt = np.zeros(B, dtype=np.float64)
    status = np.zeros(B, dtype=np.int32)
    lib.qp_active_set_solve_batch(
        _ptr(Q), _ptr(c), _ptr(G), _ptr(h), _ptr(x0),
        n, m, B, max_iter,
        _ptr(x), _ptr(lam), _ptr(kkt),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return x, lam, kkt, status
