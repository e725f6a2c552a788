"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a library with a plain C interface, loaded with ``ctypes``. The
library goes to ``_build/`` inside the package, named by a hash of the
source, every header under ``csrc/`` and the flags (``digest``), so an
edited source or header is rebuilt and an unchanged one is reused. The
compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``<library>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit")


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def digest(name: str, csrc: Path = CSRC, defines=()) -> str:
    """Hash of ``csrc/<name>.cu``, of every ``csrc/*.cuh`` it may include
    and of the flags and macro definitions: what the built library depends
    on."""
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for f in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))]:
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def library_path(name: str, defines=()) -> Path:
    """Path of the built library for ``csrc/<name>.cu`` compiled with the
    macros ``defines`` (built if absent)."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}_{digest(name, defines=defines)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *_flags(defines), "-o", str(tmp), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: concurrent builders never see half a file
    return out


def load(name: str, defines=()) -> ctypes.CDLL:
    return ctypes.CDLL(str(library_path(name, defines)))
