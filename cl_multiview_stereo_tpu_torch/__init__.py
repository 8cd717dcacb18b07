"""PyTorch + CUDA port of the multi-view stereo pipeline.

The JAX package ``cl_multiview_stereo_tpu`` beside this one is the
reference: every module here mirrors the module of the same name there and
is held against it by ``tests/test_torch_*.py``.  Plain tensor code is
PyTorch; each Pallas kernel of the reference has a hand-written CUDA
counterpart with a plain PyTorch twin for CPU tensors: the strips
depth-init cost volume (``csrc/cost_volume.cu``), the strips consistency
engine (``csrc/consistency.cu``) and the dense plane sweep
(``csrc/sweep.cu``).

This package imports nothing of the JAX package, nor JAX: the numpy-only
modules it needs (``config``, ``io.images``, ``io.pointcloud``,
``testing.synthetic``) are its own copies, held equal to the JAX ones by
``tests/test_torch_config.py``, so it runs where JAX is not installed.
"""

import torch

from cl_multiview_stereo_tpu_torch.config import (
    DerivedGeometry,
    RefinementSchedule,
    SlicParams,
    SystemSettings,
    build_disp_levels,
    build_view_subsets,
)
from cl_multiview_stereo_tpu_torch.testing.synthetic import fronto_parallel_scene

# Every tolerance of the port is stated against float32 JAX.  TF32 keeps
# about three decimal digits, so neither matmuls nor cuDNN may use it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The configuration and the synthetic scene, re-exported for the port's
# callers (chip_smoke.py among them).
__all__ = [
    "SystemSettings",
    "DerivedGeometry",
    "RefinementSchedule",
    "SlicParams",
    "build_disp_levels",
    "build_view_subsets",
    "fronto_parallel_scene",
]
