"""Shared set-up of the port's parity tests (``tests/test_torch_*.py``).

Each test feeds the same numpy inputs, made from a seed, to a JAX function
(on the CPU) and to its counterpart in ``cl_multiview_stereo_tpu_torch``,
and compares the results as numpy arrays.  Shapes are those of the JAX
package's own tests: 48x64 images, 2x2 views, ladder 4..11.  Each side gets
its own settings, geometry and scenes: the port's from
``cl_multiview_stereo_tpu_torch.config``/``.testing.synthetic``, JAX's from
its own modules (``tests/test_torch_config.py`` holds the two equal).
"""

from __future__ import annotations

import numpy as np
import torch

from cl_multiview_stereo_tpu import config as jax_config
from cl_multiview_stereo_tpu.testing import synthetic as jax_synthetic
from cl_multiview_stereo_tpu_torch.config import SystemSettings
from cl_multiview_stereo_tpu_torch.testing import synthetic

# torch's default CPU thread count oversubscribes the host when pytest-xdist
# runs several workers beside the JAX tests.
torch.set_num_threads(2)

CPU = torch.device("cpu")


def small_settings(**kw) -> SystemSettings:
    """The JAX tests' small configuration (tests/test_pipeline.py), as the
    port's settings."""
    base = dict(
        array_width=2, array_height=2, spixl_size=8, min_disp=4, max_disp=11,
        inc=1, bl_ratio=1.0, kernel_size=8, kernel_step=2, no_prop=2,
    )
    base.update(kw)
    return SystemSettings(**base)


def jax_settings(s: SystemSettings) -> jax_config.SystemSettings:
    """The same settings as the JAX package's own object."""
    return jax_config.SystemSettings.from_dict(s.to_dict())


def scenes(name: str, *args, **kw) -> tuple[np.ndarray, np.ndarray]:
    """The views of synthetic scene ``name`` from each package's own
    generator: (port views, JAX views)."""
    return getattr(synthetic, name)(*args, **kw)[0], getattr(jax_synthetic, name)(*args, **kw)[0]


def t(a, dtype=torch.float32) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor with an explicit dtype."""
    return torch.as_tensor(np.array(a)).to(dtype)


def n(x) -> np.ndarray:
    """Tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
