"""rgb_to_lab: the port against the JAX package on the same uint8 input."""

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab
from torch_parity import n, scenes, t


@pytest.mark.parametrize("source", ["uniform", "scene"])
def test_rgb_to_lab_matches_jax(source):
    if source == "uniform":
        rgb = jrgb = np.random.default_rng(0).integers(0, 256, size=(4, 6, 3), dtype=np.uint8)
    else:
        rgb, jrgb = scenes("two_plane_scene", 48, 64, array_width=2, array_height=2, seed=11)
    got = n(rgb_to_lab(t(rgb, torch.uint8)))
    want = np.asarray(jax_rgb_to_lab(jrgb))
    assert got.dtype == np.float32 and got.shape == rgb.shape
    # tests/test_color.py's tolerance for JAX against its scalar mirror
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
