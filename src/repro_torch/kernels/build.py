"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` compiles on its own into a shared library with
a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, of every header under
``csrc/`` (``*.cuh``, which any source may include) and of the flags, so an
edited source or header rebuilds and an unchanged one is loaded from
``_build/`` (listed in ``.gitignore``).  ``build()`` starts one ``nvcc`` per missing source, all
at once, and waits for them together.  A failed build raises
``KernelBuildError`` with the compiler's output; nothing falls back.
``compiles()`` says how many ``nvcc`` runs this process started (the
sanitizer's compile budgets read it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "KernelBuildError", "build", "load", "build_log",
           "compiles"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

# kernel library name -> its source, relative to this package
SOURCES = {"dense_fwd": "csrc/dense_fwd.cu", "dense_bwd": "csrc/dense_bwd.cu",
           "conv2d": "csrc/conv2d.cu", "pool2d": "csrc/pool2d.cu",
           "rmsnorm": "csrc/rmsnorm.cu",
           "flash_attention": "csrc/flash_attention.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, str] = {}
_COMPILES = [0]          # nvcc runs started by this process


class KernelBuildError(RuntimeError):
    """nvcc was missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
        "build only where the CUDA toolkit is installed")


def _target(name: str) -> Path:
    h = hashlib.sha256((_HERE / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every named kernel library that is not built yet, in
    parallel.  Returns name -> library path."""
    names = list(SOURCES) if names is None else list(names)
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.is_file()}
    if not todo:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_HERE / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
        _COMPILES[0] += 1
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        _LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)   # atomic: a concurrent reader sees all or nothing
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from this process's build of ``name``, or "" if it was
    loaded from an earlier build."""
    return _LOGS.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def compiles() -> int:
    """The ``nvcc`` runs this process started."""
    return _COMPILES[0]
