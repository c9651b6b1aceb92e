"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/kernels/`` at the repository root (git-ignored),
named by a hash of its source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header rebuilds and an unchanged one is
reused. Nothing builds at import: the first launch builds what it needs,
and ``build_all`` builds every source at once, one ``nvcc`` process
each, all started together. A failed build, load or launch raises
``KernelError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel of the port that did not build, load or launch."""


def is_device_failure(err: BaseException) -> bool:
    """Whether ``err`` is a kernel's build, load or launch failure
    (``KernelError``) or an error of the CUDA runtime. Code that
    resolves other errors quietly (the draft tier's downgrade) lets
    these propagate."""
    cuda_errors = tuple(c for c in (getattr(torch, "AcceleratorError", None),
                                    getattr(torch.cuda, "CudaError", None))
                        if c is not None)
    return isinstance(err, (KernelError, *cuda_errors)) or (
        isinstance(err, RuntimeError) and "CUDA error" in str(err))


def sources() -> list[str]:
    """Every kernel source's name (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelError(
            "no CUDA toolkit found (set CUDA_HOME); the port's kernels "
            "are compiled with nvcc at first use"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:12]}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every missing library among ``names`` (default: all
    sources) in parallel. Returns the compiler's report (``-Xptxas -v``:
    registers, shared memory, spills) per source built now."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(not library_path(n).exists() for n in names) else ""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, out,
        )
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        report, _ = proc.communicate()
        reports[name] = report
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{report}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelError("kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _libs:
            build_all([name])
            try:
                _libs[name] = ctypes.CDLL(str(library_path(name)))
            except OSError as e:
                raise KernelError(f"kernel library {name} did not load: "
                                  f"{e}") from e
        return _libs[name]
