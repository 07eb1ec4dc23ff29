"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes plain C functions and becomes its own
shared library, ``_build/lib<name>-<hash>.so`` beside this file (the
directory is git-ignored). The hash covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
never loads a stale library. Libraries are built at
first use, never at import: the CPU tests import every module on hosts
without ``nvcc``. :func:`build_all` starts one ``nvcc`` per source, all
at once, and waits for them together.

The libraries are loaded with ``ctypes``; callers declare ``argtypes``
for every function (``c_void_p`` for each pointer and the stream), or
64-bit pointers would be cut to 32 bits.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: devices whose tensors take a wrapper's plain version: the CPU, and
#: ``meta`` (shapes only, for the dry run); a CUDA tensor launches the
#: kernel or raises
PLAIN_DEVICES = ("cpu", "meta")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def sources() -> List[str]:
    """Names of every CUDA source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Dict[str, object]]:
    """Build every missing library, one ``nvcc`` per source in parallel.

    Returns ``{name: {"seconds": ..., "log": ...}}`` for the sources it
    compiled (``log`` is nvcc's ``-Xptxas -v`` report: registers, shared
    memory, spills). Raises on the first failed compile, after every
    started ``nvcc`` has exited.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in sources():
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    report: Dict[str, Dict[str, object]] = {}
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)    # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path = _library_path(name)
    if not path.exists():
        build_all()
    return ctypes.CDLL(str(path))


def refuse_autograd(kernel: str, tensors) -> None:
    """Raise ``NotImplementedError`` when autograd would record a call of
    a forward-only kernel: its output, written through ``ctypes`` into a
    fresh tensor, has no ``grad_fn``, so every input upstream would lose
    its gradient without a word. The wrappers call this on their CUDA
    branch only; the plain versions on the CPU differentiate."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise NotImplementedError(
            f"the {kernel} kernel is forward-only: it has no backward, so "
            f"it cannot run on inputs that require grad")
