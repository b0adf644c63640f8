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

# Loaded libraries by kernel name: a memo of the idempotent build, kept
# for the life of the process so each launch is one ctypes call.
_LIBS: Dict[str, ctypes.CDLL] = {}


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


def kernel(name: str, symbol: str, argtypes: Sequence,
           restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of kernel library ``name`` with its
    argument and result types declared (building and loading on first
    use).  Pointers and the stream are ``c_void_p``, ints ``c_int``; a
    launch entry returns an ``int`` CUDA error code."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build()[name]))
        _LIBS[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
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
