"""Builds the port's CUDA sources with ``nvcc`` and loads them with ``ctypes``.

Each source under ``csrc/`` compiles into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``),
written at first use to ``build/kernels/`` at the repository root (listed
in ``.gitignore``). The file name carries a hash of the source, of the
``csrc/`` headers it includes (``#include "x.cuh"``, and theirs in turn) and
of the flags, so an edited source or header rebuilds and an unchanged one
loads as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA toolkit "
        "is installed"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, each once."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its content, its included
    headers' and the flags."""
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(name: str, extra_flags: tuple = (), force: bool = False) -> Path:
    """Compiles ``csrc/<name>.cu`` unless its library is already built.

    ``force`` rebuilds even so; ``extra_flags`` (e.g. ``-Xptxas -v``) go to
    ``nvcc`` and its output is printed.
    """
    out = library_path(name)
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}"
        )
    if extra_flags:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Builds (if needed) and loads ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(str(build(name)))
