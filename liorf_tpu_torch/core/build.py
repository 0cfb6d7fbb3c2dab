"""Where the port's native libraries are built, and how: the nvcc-built
kernels (``csrc/*.cu``, each loaded by its module under ``ops/``) and the
g++-built host runtime (``native/``)."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

# One flag set for every kernel source: Hopper's sm_90a, a shared library
# with a plain C interface (bound with ctypes, no PyTorch headers).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def build_dir() -> Path:
    """``$LIORF_TORCH_BUILD_DIR``, else ``build/liorf_tpu_torch/`` at the repo
    root (git-ignored), never the package directory."""
    env = os.environ.get("LIORF_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "liorf_tpu_torch"


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels cannot be built"
    )


def build_cuda_library(source: Path, extra_flags: tuple[str, ...] = ()) -> tuple[Path, float | None]:
    """Compile ``source`` into ``build_dir()/lib<stem>_<hash>.so`` once per
    content (the source and the headers beside it, ``*.cuh``) and flags.
    Returns the library's path and the wall time of the nvcc run (None when
    the library was already built). Raises on a failed build; prints the
    compiler's output when ``extra_flags`` asked for a report
    (``-Xptxas -v``)."""
    src = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS + extra_flags).encode()).hexdigest()[:12]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{source.stem}_{tag}.so"
    if so.exists():
        return so, None
    tmp = out_dir / f".{so.name}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    if extra_flags and (proc.stdout or proc.stderr):
        print(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so, seconds


def raw_stream(index: int) -> int:
    """The address of the current CUDA stream of device ``index``, as a
    kernel's plain C interface takes it (without building a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(index)
