"""ctypes loader for the native ELL-pattern code (native/pattern.cpp).

Port of ``femcy_tpu.native.loader``.  At first use the source is compiled
with ``g++`` into ``femcy_tpu_torch/_build/`` (git-ignored) under a name
that carries a hash of the source and the flags, so a stale library is
never loaded; nothing is built when the module is imported.  Unlike the JAX
loader there is no silent fallback: a missing ``g++`` or a failed compile
raises (with g++'s stderr).  ``FEMCY_TPU_NATIVE=0`` selects the numpy path
of ``topology.build_pattern`` explicitly, as in femcy_tpu.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "pattern.cpp"
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}


def native_enabled() -> bool:
    """False when FEMCY_TPU_NATIVE=0 asks for the numpy pattern route."""
    return os.environ.get("FEMCY_TPU_NATIVE", "1") != "0"


def library_path() -> pathlib.Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfemcy_pattern-{h.hexdigest()[:16]}.so"


def build_library() -> pathlib.Path:
    """Compile pattern.cpp into the hashed library path (no-op if present)."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "cannot build the native pattern library: g++ not found on $PATH "
            "(FEMCY_TPU_NATIVE=0 selects the numpy route)"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile in a temporary directory and rename into place: a concurrent
    # build never sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", lib]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                "g++ failed to build the native pattern library "
                f"(exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(lib, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it at first use; None when
    FEMCY_TPU_NATIVE=0."""
    if not native_enabled():
        return None
    lib = _loaded.get(BUILD_DIR)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(BUILD_DIR)
        if lib is None:
            lib = _bind(ctypes.CDLL(str(build_library())))
            _loaded[BUILD_DIR] = lib
        return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.pattern_build.restype = ctypes.c_void_p
    lib.pattern_build.argtypes = [
        p32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
    ]
    lib.pattern_nnz.restype = ctypes.c_int64
    lib.pattern_nnz.argtypes = [ctypes.c_void_p]
    lib.pattern_width.restype = ctypes.c_int32
    lib.pattern_width.argtypes = [ctypes.c_void_p]
    lib.pattern_nwidth.restype = ctypes.c_int32
    lib.pattern_nwidth.argtypes = [ctypes.c_void_p]
    lib.pattern_export_block_targets.restype = None
    lib.pattern_export_block_targets.argtypes = [ctypes.c_void_p, p32]
    lib.pattern_export.restype = ctypes.c_int32
    lib.pattern_export.argtypes = [ctypes.c_void_p, p32, p32, p32, p64, p32,
                                   p64, p64]
    lib.pattern_free.restype = None
    lib.pattern_free.argtypes = [ctypes.c_void_p]
    return lib


def build_pattern_native(elements: np.ndarray, dm: int, n_dof: int):
    """The pattern arrays from the native library, or None when
    FEMCY_TPU_NATIVE=0 or the mesh exceeds its int32 index space (2^31
    dof-level contributions or ELL slots; the numpy route then takes it
    with int64 indices).

    (block_targets, node_width, colidx, row_counts, diag_slot,
     csr_indices, csr_slots, csr_indptr, width)

    The dof-level scatter targets (E*edof^2 int32, 607 MB at 1M C3D4
    elements) and the (row, col)-sorted permutation are not exported:
    ``ELLPattern.ensure_scatter_targets`` expands the dm^2-smaller
    ``block_targets`` for the consumers that need them, and
    ``ELLPattern.ensure_sorted_scatter`` sorts in numpy.
    """
    lib = get_lib()
    if lib is None:
        return None
    E, npe = elements.shape
    edof = npe * dm
    n_contrib = E * edof * edof
    if n_contrib >= 2**31 or n_dof >= 2**31:
        return None

    elements = np.ascontiguousarray(elements, dtype=np.int32)

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    handle = lib.pattern_build(p32(elements), E, npe, dm, n_dof)
    if not handle:
        raise MemoryError("native pattern library could not allocate its state")
    try:
        nnz = lib.pattern_nnz(handle)
        width = lib.pattern_width(handle)
        node_width = lib.pattern_nwidth(handle)
        if n_dof * width >= 2**31:
            return None
        colidx = np.empty((n_dof, width), dtype=np.int32)
        row_counts = np.empty(n_dof, dtype=np.int32)
        diag_slot = np.empty(n_dof, dtype=np.int64)
        csr_indices = np.empty(nnz, dtype=np.int32)
        csr_slots = np.empty(nnz, dtype=np.int64)
        csr_indptr = np.empty(n_dof + 1, dtype=np.int64)
        # targets=NULL: the dof-level scatter map is not exported
        status = lib.pattern_export(
            handle, None, p32(colidx), p32(row_counts), p64(diag_slot),
            p32(csr_indices), p64(csr_slots), p64(csr_indptr),
        )
        if status != 0:
            raise RuntimeError("mesh has dofs without a diagonal entry")
        block_targets = np.empty(E * npe * npe, dtype=np.int32)
        lib.pattern_export_block_targets(handle, p32(block_targets))
        return (
            block_targets,
            int(node_width),
            colidx,
            row_counts,
            diag_slot,
            csr_indices,
            csr_slots,
            csr_indptr,
            int(width),
        )
    finally:
        lib.pattern_free(handle)
