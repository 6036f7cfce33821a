"""Build and load the port's hand-written CUDA kernels.

A ``.cu`` source of this package is compiled at its first use by ``nvcc``
into a shared library with a plain C interface, and loaded with ``ctypes``:

    nvcc -O3 -gencode arch=compute_90a,code=sm_90a -std=c++17 -fmad=false \\
         -shared -Xcompiler -fPIC -D<constants> -o _build/<name>-<key>.so <source>

Why not ``torch.utils.cpp_extension.load``: a source that includes
PyTorch's headers takes minutes to compile, and ``load`` needs ``ninja``; a
plain C library with cudart linked statically (nvcc's default) needs
nothing but ``nvcc`` and builds in seconds.

The library is cached in ``_build/`` beside this file (``.gitignore`` lists
it), keyed on a hash of the source, the flags (the constants' ``-D`` defines
among them) and ``nvcc --version``. A build writes a temporary file and
``os.replace``s it into place, so processes that build the same library at
once (the ranks of a world) each load a whole file. A failed or impossible
build raises ``KernelCompileError`` with nvcc's messages: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np

from gymrl_tpu_torch.utils.profiling import span

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-fmad=false",
         "-shared", "-Xcompiler", "-fPIC")

# Seconds each library took to compile in this process (absent: loaded from the cache).
BUILD_SECONDS: dict[str, float] = {}

_LOADED: dict[tuple, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a source."""


def float_literal(x: float) -> str:
    """``x`` rounded to float32, as an exact C++17 hexadecimal float literal."""
    v = float(np.float32(x))
    if not math.isfinite(v):
        raise ValueError(f"{x} is not a finite float32")
    return f"({v.hex()}f)"


def define_flags(defines: dict[str, str]) -> list[str]:
    return [f"-D{name}={value}" for name, value in sorted(defines.items())]


def cache_key(source_text: str, flags, nvcc_version: str) -> str:
    h = hashlib.sha256()
    for part in (source_text, "\0".join(flags), nvcc_version):
        h.update(part.encode())
        h.update(b"\x01")
    return h.hexdigest()[:20]


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.access(path, os.X_OK) else None


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def load(name: str, source: str, defines: dict[str, str]) -> ctypes.CDLL:
    """The library built from ``source`` with ``defines``, compiled on the
    first call (or taken from ``_build/``) and memoized for the process."""
    flags = (*FLAGS, *define_flags(defines))
    memo = (name, source, flags)
    with _LOCK:
        lib = _LOADED.get(memo)
        if lib is not None:
            return lib
        with span("kernels.load", name) as load_span:
            nvcc = find_nvcc()
            if nvcc is None:
                raise KernelCompileError(
                    f"cannot build {name}: nvcc is not on PATH nor under $CUDA_HOME/bin")
            version = _run([nvcc, "--version"])
            if version.returncode != 0:
                raise KernelCompileError(f"{nvcc} --version failed:\n{version.stderr}")
            with open(source) as f:
                text = f.read()
            path = os.path.join(BUILD_DIR, f"{name}-{cache_key(text, flags, version.stdout)}.so")
            compiled = not os.path.exists(path)
            if compiled:
                os.makedirs(BUILD_DIR, exist_ok=True)
                fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                t0 = time.perf_counter()
                try:
                    done = _run([nvcc, *flags, "-o", tmp, source])
                    if done.returncode != 0:
                        raise KernelCompileError(
                            f"nvcc failed on {source} (exit {done.returncode}):\n"
                            f"{done.stderr}{done.stdout}")
                    os.replace(tmp, path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                BUILD_SECONDS[name] = time.perf_counter() - t0
            load_span.note = f"{name} {'compiled' if compiled else 'cached'}"
            lib = ctypes.CDLL(path)
            _LOADED[memo] = lib
            return lib
