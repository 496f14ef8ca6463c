"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` goes through one ``nvcc`` call into one shared library
with a plain C interface: no PyTorch headers, so the build takes seconds, not
minutes.  The library lands in ``build/`` beside this module (listed in
``.gitignore``) under a name carrying a digest of the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.  Nothing is
built when a module is imported (the CPU tests import every module): the
first kernel launch builds.  Pointers are passed as ``c_void_p`` and 64-bit
sizes as ``c_int64``, so ctypes never truncates them to 32 bits.  Every C
entry point returns ``cudaGetLastError()`` after its launch, and
:func:`launch` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in build_info
)

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: C entry point -> argument types (each returns an int CUDA error code)
SIGNATURES = {
    "dsag_logreg_block_sub": (_P,) * 6 + (_I64, _I64, _I32, _I32, _P),
    "dsag_pca_block_sub": (_P,) * 5 + (_I64, _I64, _I32, _I32, _I32, _P),
    "dsag_grid_cache_update": (_P,) * 15 + (_I32,) * 5 + (_P,),
    "dsag_dsag_cache_update": (_P,) * 6 + (_I64, _I64, _I32, _I32, _I32, _P),
    "dsag_gram_matvec": (_P,) * 4 + (_I64, _I64, _I32, _I32, _I32, _P),
}
#: integer constants the wrappers check shapes against
CONSTANTS = (
    "dsag_logreg_threads",
    "dsag_pca_threads",
    "dsag_pca_chunk",
    "dsag_pca_max_out",
    "dsag_gram_chunk",
    "dsag_gram_tile",
)

#: what the last build did: library path, seconds, nvcc's -Xptxas -v report
build_info: dict = {}
_lib = None
_constants: dict[str, int] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built with "
            "the CUDA toolkit on the machine that holds the card"
        )
    return found


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its digest is new."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for flag in NVCC_FLAGS:
        digest.update(flag.encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libdsag_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        build_info["log"] = proc.stderr
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    for name in CONSTANTS:
        getattr(lib, name).restype = ctypes.c_int
        _constants[name] = int(getattr(lib, name)())
    lib.dsag_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dsag_cuda_error_string.restype = ctypes.c_char_p
    build_info["path"] = str(so)
    build_info["seconds"] = time.perf_counter() - t0
    _lib = lib
    return lib


def constant(name: str) -> int:
    """One of the kernels' integer limits (:data:`CONSTANTS`)."""
    library()
    return _constants[name]


def launch(name: str, *args) -> None:
    """Call one C entry point; raise if the launch reported a CUDA error."""
    lib = library()
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.dsag_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
