"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface: no PyTorch headers, so the build takes seconds, not minutes.
The library lands in ``build/`` beside this module (listed in
``.gitignore``) under a name carrying a digest of the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.  Nothing is
built when a module is imported (the CPU tests import every module): the
first kernel launch builds, under a module lock, so that the threads of a
sharded run that reach their first launch together build once.  Pointers are passed as ``c_void_p`` and 64-bit
sizes as ``c_int64``, so ctypes never truncates them to 32 bits.  Every C
entry point returns ``cudaGetLastError()`` after its launch, and
:func:`launch` raises when it is not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from torch.distributed.tensor import DTensor

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in build_info
)

_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
_F64 = ctypes.c_double
#: C entry point -> argument types (each returns an int CUDA error code)
SIGNATURES = {
    "dsag_logreg_block_sub": (_P,) * 7 + (_I64, _I64, _I32, _I32, _I32, _I32, _P),
    "dsag_pca_block_sub": (_P,) * 6 + (_I64, _I64, _I32, _I32, _I32, _I32, _P),
    "dsag_grid_cache_update": (_P,) * 15 + (_I32,) * 8 + (_P,),
    "dsag_dsag_cache_update": (_P,) * 6 + (_I64, _I64, _I32, _I32, _I32, _I32, _P),
    "dsag_dsag_cache_update_int8": (_P,) * 14 + (_I64, _I64, _I64, _I32, _P),
    "dsag_dsag_int8_row_max": (_P,) * 8 + (_I64, _I64, _I64, _I32, _P),
    "dsag_gram_matvec": (_P,) * 4 + (_I64, _I64) + (_I32,) * 6 + (_P,),
    "dsag_gram_tile_rows": (_I32, _I32),
    "dsag_wide_block_sub": (_P,) * 8 + (_I64, _I64, _I32, _I32, _I64, _I32, _I64, _I32, _I32, _P),
    "dsag_gram_matvec_wide": (_P,) * 5 + (_I64, _I64, _I32, _I32, _I32, _I64, _I32, _P),
    "dsag_flash_attention": (_P,) * 4 + (_I64,) * 4 + (_I32,) * 4 + (_F32,) + (_I64,) * 12
    + (_I32, _P),
    "dsag_what_if_replay": (_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _F64, _F64, _I32, _P),
}
#: the kernels' integer limits, mirrored from the sources so that the
#: wrappers' launch plans and the engines' capability checks are pure
#: functions of the shapes (no build, no card); ``chip_smoke.py`` phase 2
#: holds every entry against the compiled value (:func:`mirror_mismatches`)
LIMITS = {
    "dsag_logreg_max_warps": 8,
    "dsag_logreg_max_out": 3,
    "dsag_logreg_slab": 256,
    "dsag_pca_threads": 256,
    "dsag_pca_chunk": 64,
    "dsag_pca_max_out": 4,
    "dsag_pca_slab": 512,
    "dsag_wide_slab": 256,
    "dsag_gram_max_k": 8,
    "dsag_gram_max_d": 1024,
    "dsag_gram_max_cluster": 8,
    "dsag_cache_window": 2048,
    "dsag_flash_block_q": 64,
    "dsag_flash_block_k": 64,
    "dsag_what_if_max_workers": 1024,
    "dsag_int8_rows_per_block": 4,
}
#: integer constants the library exports
CONSTANTS = tuple(LIMITS)

#: what the last build did: library path, seconds, nvcc's -Xptxas -v report
build_info: dict = {}
_lib = None
_constants: dict[str, int] = {}
#: held while the library is built and loaded (first launches of several threads)
_lock = threading.Lock()
#: held while a wrapper adds to its launch counter (see :func:`count_launch`)
_count_lock = threading.Lock()
#: each thread's active cost counter (``repro_torch.analysis.cost``), if any:
#: the shards of a sharded run count apart
cost_counter = threading.local()
#: this thread's dry-run mode (:func:`dry_run`), if any
_dry = threading.local()
#: what meta tensors at a kernel wrapper take inside :func:`dry_run`
DRY_RUN_MODES = ("card", "plain")


@contextlib.contextmanager
def dry_run(mode: str):
    """Let meta tensors (shapes and dtypes, no data) reach the kernel wrappers
    on this thread: under ``"card"``, K4, K4-int8 and K6 check them as their
    launch would, report the launch to the active cost counter with the
    kernel's cost model and return meta outputs, launching nothing and
    adding nothing to their launch counts; under ``"plain"`` every wrapper
    takes its plain twin, as on CPU tensors.  Outside it a meta tensor at a
    wrapper raises (``launch/dryrun.py`` counts a step over meta tensors)."""
    if mode not in DRY_RUN_MODES:
        raise ValueError(f"dry-run mode {mode!r} not in {DRY_RUN_MODES}")
    prev = getattr(_dry, "mode", None)
    _dry.mode = mode
    try:
        yield
    finally:
        _dry.mode = prev


def dry_run_mode() -> str | None:
    """This thread's :func:`dry_run` mode, or None outside one."""
    return getattr(_dry, "mode", None)


def route(*tensors, counts: bool = False) -> str:
    """Where a kernel wrapper takes its operands: ``"launch"`` (every tensor
    on a card: the kernel), ``"plain"`` (every tensor on the CPU, or meta
    tensors under ``dry_run("plain")``: the plain twin) or ``"count"``
    (meta tensors under ``dry_run("card")``, at a wrapper with a count-only
    path, ``counts=True``: K4, K4-int8 and K6).  Raises on anything else: a
    ``DTensor`` (a kernel takes raw pointers, and a mesh run hands it the
    local shard), mixed devices, and meta tensors outside a dry run or at a
    wrapper with no count-only path."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError("a kernel takes plain tensors: pass a DTensor's local shard "
                        "(.to_local())")
    if all(t.is_cuda for t in tensors):
        return "launch"
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return "plain"
    if devices == {"meta"}:
        mode = dry_run_mode()
        if mode == "plain":
            return "plain"
        if mode == "card" and counts:
            return "count"
        raise ValueError(f"tensors on devices {devices}: meta tensors reach a kernel wrapper "
                         "only inside a dry run (kernels._build.dry_run)" + (
                             "" if mode is None else ", and this kernel has no count-only path"))
    raise ValueError(f"tensors on mixed or unsupported devices: {devices}")


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


def compile_library(sources: list[Path], out: Path) -> str:
    """Compile ``sources`` into the shared library ``out``: one ``nvcc -c``
    per source, all started together, then one link.  Returns ptxas's report."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as objdir:
        objs = [f"{objdir}/{src.stem}.o" for src in sources]
        jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in jobs]
        results = [(cmd, p, *p.communicate()) for cmd, p in zip(jobs, procs)]  # reap all
        failed = [r for r in results if r[1].returncode != 0]
        if not failed:
            link = [nvcc, "-shared", "-o", str(out), *objs]
            p = subprocess.run(link, capture_output=True, text=True)
            failed = [(link, p, p.stdout, p.stderr)] if p.returncode else []
        if failed:
            cmd, p, stdout, stderr = failed[0]
            raise RuntimeError(f"nvcc failed with code {p.returncode}:\n{' '.join(cmd)}\n"
                               f"{stdout}{stderr}")
    return "".join(stderr for *_, stderr in results)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its digest is new.  Safe to
    call from several threads: one builds and loads, the others wait."""
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _build_and_load()
    return _lib


def _tmp_path(so: Path) -> Path:
    """Where this thread compiles ``so`` before the atomic rename: unique per
    process and per thread."""
    return so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")


def _build_and_load() -> None:
    """Build the library if its digest is new and load it (under :data:`_lock`)."""
    global _lib
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
        tmp = _tmp_path(so)
        build_info["log"] = compile_library(sources, tmp)
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    lib = _load(so)
    build_info["path"] = str(so)
    build_info["seconds"] = time.perf_counter() - t0
    _lib = lib


def _load(so: Path) -> ctypes.CDLL:
    """Load the built library, declare every entry point's types and read
    its constants."""
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
    return lib


def constant(name: str) -> int:
    """One of the kernels' integer limits (:data:`CONSTANTS`), as compiled."""
    if _lib is None:
        library()
    return _constants[name]


def mirror_mismatches() -> dict[str, tuple[int, int]]:
    """``{name: (mirrored, compiled)}`` for every entry of :data:`LIMITS`
    that differs from the built library's value (builds it first)."""
    return {name: (v, constant(name)) for name, v in LIMITS.items() if constant(name) != v}


def count_launch(counts: dict[str, int], name: str, cost=None, launched: bool = True) -> None:
    """Add one to ``counts[name]``, a wrapper's launch counter: the shards of
    a sharded run launch from several threads, and ``+=`` on a dict entry is
    a read, an add and a write.  If this thread has an active cost counter,
    report the launch to it: ``cost()`` returns its ``(bytes, flops, peak)``
    (the kernel's model in :mod:`repro_torch.analysis.kernel_costs`; it may read
    the launch's data on the host, which the counter does not count).
    Without a counter ``cost`` is not called: no launch, no host read.
    ``launched=False`` is a dry run's count-only call (:func:`dry_run`):
    reported to the counter, not counted as a launch."""
    if launched:
        with _count_lock:
            counts[name] += 1
    counter = getattr(cost_counter, "active", None)
    if counter is not None and cost is not None:
        counter(name, cost)


def launch(name: str, *args) -> None:
    """Call one C entry point; raise if the launch reported a CUDA error."""
    lib = _lib if _lib is not None else library()
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.dsag_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
