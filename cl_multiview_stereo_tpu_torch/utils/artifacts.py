"""Stage artifact dumps and checkpoint/resume (port of
``cl_multiview_stereo_tpu/utils/artifacts.py``).

The directory names and checkpoint keys are the JAX package's, so a
checkpoint written by either package resumes in the other.  Tensors are
pulled to the host once, whole, before any numpy call.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# Stage directory names mirror the reference's results/ tree.
STAGE_DIRS = {
    "disp_init": "1- initialize disparity",
    "flatness": "2- flatness",
    "init_sm": "3- initialize smoothness",
    "init_cs": "4- initialize consistency",
    "sm": "5- smoothness",
    "cs": "6- consistency",
    "propagate": "7- propagate",
    "fusion": "8- Fusion",
}


def to_host(a) -> np.ndarray:
    """One device-to-host copy of a whole tensor (arrays pass through)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def dump_stage_pngs(out_dir: str, name: str, arr, lo: float, hi: float) -> None:
    """Write one grayscale PNG per view for a (V, ...) tensor or array."""
    from cl_multiview_stereo_tpu_torch.io.images import save_gray_png

    sub = os.path.join(out_dir, STAGE_DIRS.get(name, name))
    a = to_host(arr)
    for v in range(a.shape[0]):
        save_gray_png(os.path.join(sub, f"{name}_{v}.png"), a[v], lo, hi)


def save_checkpoint(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: to_host(v) for k, v in arrays.items()})


def load_checkpoint(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
