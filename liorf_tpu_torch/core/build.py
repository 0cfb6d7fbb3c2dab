"""Where the port's native libraries are built: the nvcc-built kernels
(``ops/knn_cuda.py``) and the g++-built host runtime (``native/``)."""

from __future__ import annotations

import os
from pathlib import Path


def build_dir() -> Path:
    """``$LIORF_TORCH_BUILD_DIR``, else ``build/liorf_tpu_torch/`` at the repo
    root (git-ignored), never the package directory."""
    env = os.environ.get("LIORF_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "liorf_tpu_torch"
