"""Build and load the port's CUDA kernels (csrc/*.cu).

At first use the sources are compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and linked
into one shared library with a plain C interface, which is loaded with
``ctypes``.  The library goes to ``femcy_tpu_torch/_build/``
(git-ignored) under a name that carries a hash of the sources and flags,
so a stale library is never loaded.  Nothing is built or imported when a
module is imported: the CPU tests import every module.

If ``nvcc`` is missing or fails, ``load_library`` raises with the reason
(nvcc's own stderr for a failed compile).
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

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

#: where nvcc is looked for after $CUDA_HOME/bin and $PATH
NVCC_FALLBACKS = ("/usr/local/cuda/bin/nvcc",)

_lock = threading.Lock()
_loaded: dict = {}
_entries: dict = {}


def find_nvcc() -> str | None:
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then NVCC_FALLBACKS."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.extend(NVCC_FALLBACKS)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfemcy_kernels-{h.hexdigest()[:16]}.so"


def build_library() -> pathlib.Path:
    """Compile csrc/*.cu into the hashed library path (no-op if present)."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "cannot build the femcy_tpu_torch CUDA kernels: nvcc not found "
            "($CUDA_HOME/bin, $PATH, "
            + ", ".join(NVCC_FALLBACKS)
            + "); CUDA tensors need the CUDA toolkit"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory and rename the library into place: a
    # concurrent build never sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        # wait for every compile before raising, so none outlives the call
        results = []
        for cmd, p in procs:
            _, err = p.communicate()
            results.append((cmd, p.returncode, err))
        for cmd, code, err in results:
            _check(cmd, code, err)
        lib = os.path.join(tmp, out.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        _check(link, proc.returncode, proc.stderr)
        os.replace(lib, out)
    return out


def _check(cmd, code: int, stderr: str) -> None:
    if code != 0:
        raise RuntimeError(
            "nvcc failed to build the femcy_tpu_torch CUDA kernels "
            f"(exit {code}): {' '.join(cmd)}\n{stderr}"
        )


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once per process
    and build directory."""
    lib = _loaded.get(BUILD_DIR)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(BUILD_DIR)
        if lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.femcy_cuda_error_string.argtypes = [ctypes.c_int]
            lib.femcy_cuda_error_string.restype = ctypes.c_char_p
            _loaded[BUILD_DIR] = lib
        return lib


def entry(name: str, argtypes):
    """The library's entry point ``name``, which returns a CUDA error code,
    with ``argtypes`` set.  Bound once per build directory, then served from
    a cache, so a launch costs one ctypes call."""
    key = (BUILD_DIR, name)
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load_library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return fn


def launch(fn, device: torch.device, what: str, *args) -> None:
    """Call ``fn(*args, stream)`` on ``device``'s current stream, and raise
    if it returns a CUDA error code."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(fn, device, what, *args)
    code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        msg = load_library().femcy_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
