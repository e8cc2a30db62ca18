"""Build and bind the port's CUDA kernels and its native planner.

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, in ``_build/`` next to this file
(listed in ``.gitignore``), and loads with ``ctypes``.  A library is built at
first use and named by a hash of its source and flags, so an edited source
rebuilds.  `build()` starts one ``nvcc`` per missing library, all at once.

The native planner (the repo's ``native/*.cpp``: tokenizer, parser, binder
and core optimizer) compiles with ``g++`` and the flags of
``native/Makefile`` into the same directory (`native_library`), under a
file lock so that concurrent processes build it once.

Both are kept where the compile cache says (`serving/compile_cache.py`:
``serving.compile_cache.path``, else ``_build/``); a library found intact
there is a hit, a compiler run a miss, and a torn file is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
#: the native planner's sources, shared with the JAX package (read only)
NATIVE_DIR = _HERE.parent / "native"
NATIVE_SOURCES = ("tokenizer.cpp", "parser.cpp", "binder.cpp")
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

#: library name -> (source file, {C function: argtypes}); every function
#: returns a cudaError_t as int (and dsql_segsum_plan -1 for a shape its
#: kernel does not take)
KERNELS: Dict[str, tuple] = {
    "segsum": ("segsum.cu", {
        # n, domain, k, data_buf[k], mask_buf[k], types[k], int plan[16]
        "dsql_segsum_plan": [_I64, _I, _I, _P, _P, _P, _P],
        # gid, n, domain, k, data[k], masks[k], types[k], plan, scratch,
        # out, stream
        "dsql_segsum_typed": [_P, _I64, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    }),
}

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit on the machine with the card")


def _dir() -> Path:
    from .serving import compile_cache

    return compile_cache.cache_dir(BUILD_DIR)


def library_path(name: str) -> Path:
    source = _CSRC / KERNELS[name][0]
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _dir() / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns {name: seconds} for those
    compiled; raises with the compiler's output when one fails."""
    import time

    from .serving import compile_cache

    _dir().mkdir(parents=True, exist_ok=True)
    todo = [n for n in (names or KERNELS)
            if not compile_cache.lookup(library_path(n))]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        target = library_path(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    times, errors = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
        compile_cache.stored(target)
        times[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            # the single flight of a library's build: concurrent first
            # callers wait for the one nvcc run instead of racing it
            # dsql: allow-blocking-under-lock — deliberate, once a library
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in KERNELS[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def native_library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in NATIVE_SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return _dir() / f"libdsql_native-{h.hexdigest()[:16]}.so"


def native_library() -> Path:
    """Path of the native planner library, compiled first when missing
    (about 20 s of ``g++``).  A file lock makes concurrent processes wait
    for one build; raises RuntimeError when the sources are absent or
    ``g++`` fails."""
    import fcntl

    missing = [n for n in NATIVE_SOURCES if not (NATIVE_DIR / n).exists()]
    if missing:
        raise RuntimeError(f"native planner sources missing: {missing}")
    from .serving import compile_cache

    target = native_library_path()
    if compile_cache.lookup(target):
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target.parent / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if compile_cache.lookup(target):
            return target
        gxx = shutil.which("g++") or shutil.which("c++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native planner is not built")
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [gxx, *GXX_FLAGS, "-o", str(tmp),
               *(str(NATIVE_DIR / n) for n in NATIVE_SOURCES)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed for the native planner (rc {proc.returncode}):\n"
                f"{proc.stdout}")
        os.replace(tmp, target)
        compile_cache.stored(target)
    return target
