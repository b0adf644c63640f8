"""Build and load the port's CUDA kernels.

Every ``tfmesos_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface and
loaded with ``ctypes`` — no PyTorch headers, so a build takes seconds,
not minutes.  All sources compile in parallel (one ``nvcc`` process
each, started together).  Output goes under ``build/tfmesos_tpu_torch/``
at the root of the checkout, in a directory named by a hash of every
file under ``csrc/`` (the shared ``*.cuh`` headers too) and the flags,
so an unchanged tree reuses its build and any change rebuilds.

Nothing here runs at import: the first kernel launch builds.  Each C
entry point returns ``cudaGetLastError()`` after its launch; callers
raise through :func:`check` when it is not 0.

:func:`build_host` compiles a host library of ``native/`` (the token
gather of ``train/data.py``, the log pump of ``logpump.py``) with the
host C++ compiler into the same build root, named by a hash of its
source and flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "tfmesos_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCE_DIR = PACKAGE_DIR / "native"
HOST_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
HOST_LIBS = ("-lpthread",)

# Loaded libraries by kernel name: a memo of the idempotent build, kept
# for the life of the process so each launch is one ctypes call.
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, ctypes._CFuncPtr] = {}


def sources() -> List[Path]:
    """Every kernel source of the package (one library each), sorted by
    name."""
    return sorted(SOURCE_DIR.glob("*.cu"))


def _hashed_files() -> List[Path]:
    """Every file under ``csrc/`` — the sources and the headers they
    include — sorted by path."""
    return sorted(p for p in SOURCE_DIR.rglob("*") if p.is_file())


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    """The build directory for the current ``csrc/`` files and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _hashed_files():
        h.update(p.relative_to(SOURCE_DIR).as_posix().encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(clean: bool = False) -> Dict[str, Path]:
    """Compile every source (skipping those already built for this
    hash) and return ``{kernel name: library path}``.  ``clean=True``
    first removes every earlier build.  Raises ``RuntimeError`` with
    nvcc's stderr if a compile fails.  The compiler's resource report
    (``-Xptxas -v``) lands in ``<name>.log`` beside each library."""
    if clean and BUILD_ROOT.exists():
        shutil.rmtree(BUILD_ROOT)
    srcs = sources()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {p.stem: out_dir / f"lib{p.stem}.so" for p in srcs}
    todo = [p for p in srcs if not libs[p.stem].is_file()]
    if todo:
        nvcc = _nvcc()
        procs = []
        for p in todo:
            tmp = out_dir / f"lib{p.stem}.so.{os.getpid()}.tmp"
            procs.append((p, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(p)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failures = []
        for p, tmp, proc in procs:
            out, err = proc.communicate()
            (out_dir / f"{p.stem}.log").write_text(out + err)
            if proc.returncode != 0:
                failures.append(f"nvcc failed on {p.name} "
                                f"(rc={proc.returncode}):\n{err}")
                tmp.unlink(missing_ok=True)
            else:
                tmp.replace(libs[p.stem])
        if failures:
            raise RuntimeError("\n".join(failures))
    return libs


def build_host(name: str) -> Path:
    """Compile ``native/<name>.cpp`` with ``g++`` into
    ``lib<name>.so`` and return its path; an unchanged source and flags
    reuse the earlier build.  Raises ``RuntimeError`` when there is no
    ``g++`` or the compile fails (with the compiler's stderr)."""
    src = HOST_SOURCE_DIR / f"{name}.cpp"
    h = hashlib.sha256(" ".join(HOST_FLAGS + HOST_LIBS).encode())
    h.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"host-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.is_file():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found; lib{name}.so cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *HOST_FLAGS, "-o", str(tmp), str(src),
                           *HOST_LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {src.name} "
                           f"(rc={proc.returncode}):\n{proc.stderr}")
    tmp.replace(lib)
    return lib


def kernel(name: str, symbol: str, argtypes: Sequence,
           restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of kernel library ``name`` with its
    argument and result types declared (building and loading on first
    use).  Pointers and the stream are ``c_void_p``, ints ``c_int``; a
    launch entry returns an ``int`` CUDA error code.  The declared entry
    is memoized: a wrapper asks for it on every launch."""
    key = (name, symbol, tuple(argtypes), restype)
    fn = _FNS.get(key)
    if fn is None:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build()[name]))
            _LIBS[name] = lib
        # A fresh function object per declaration, so two declarations
        # of one symbol never overwrite each other's types.
        fn = lib[symbol]
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FNS[key] = fn
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise if a launch of kernel library ``name`` reported a CUDA
    error (every library exports ``tfm_error_string``)."""
    if err != 0:
        describe = _LIBS[name].tfm_error_string
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} at launch "
                           f"({describe(err).decode()})")
