"""PyTorch + CUDA port of the multi-view stereo pipeline.

The JAX package ``cl_multiview_stereo_tpu`` beside this one is the
reference: every module here mirrors the module of the same name there and
is held against it by ``tests/test_torch_*.py``.  Plain tensor code is
PyTorch; the strips depth-init cost volume is a hand-written CUDA kernel
(``csrc/cost_volume.cu``) with a plain PyTorch twin for CPU tensors.

Only the numpy-only modules of the JAX package are imported
(``config``, ``testing.synthetic``, ``io.images``), so this package runs
where JAX is not installed.
"""

import torch

from cl_multiview_stereo_tpu.config import (
    DerivedGeometry,
    RefinementSchedule,
    SlicParams,
    SystemSettings,
    build_disp_levels,
    build_view_subsets,
)
from cl_multiview_stereo_tpu.testing.synthetic import fronto_parallel_scene

# Every tolerance of the port is stated against float32 JAX.  TF32 keeps
# about three decimal digits, so neither matmuls nor cuDNN may use it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The reference package's numpy-only pieces, re-exported so that callers
# of the port (chip_smoke.py among them) import nothing of that package.
__all__ = [
    "SystemSettings",
    "DerivedGeometry",
    "RefinementSchedule",
    "SlicParams",
    "build_disp_levels",
    "build_view_subsets",
    "fronto_parallel_scene",
]
