"""liorf_tpu_torch: the PyTorch/CUDA port of the LiDAR-inertial SLAM engine.

Same sub-package layout and function names as ``liorf_tpu`` so a reader
finds the counterpart of every module. Imports ``torch`` and ``numpy`` only.

The engine is float32 with full-precision products throughout (the pose
solves are sensitive to 3-digit TF32 rounding), so importing the package
turns TF32 off for matmul and cuDNN.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import core, eval, graph, imu, loops, mapping, ops, pipeline, sensors  # noqa: E402

__all__ = [
    "core", "eval", "graph", "imu", "loops", "mapping", "ops", "pipeline",
    "sensors",
]
