"""Superpixel extent: the port's walk against both JAX forms, bitwise."""

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.config import DerivedGeometry, SlicParams
from cl_multiview_stereo_tpu.ops import slic as jslic
from cl_multiview_stereo_tpu.ops import superpixel as jsp
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu.testing import synthetic
from cl_multiview_stereo_tpu_torch.ops import superpixel
from torch_parity import n, small_settings, t


@pytest.fixture(scope="module", params=[(48, 64), (37, 53), (61, 45)], ids=str)
def segmented(request):
    h, w = request.param
    s = small_settings(min_disp=2, max_disp=6, no_prop=1)
    rgb, _ = synthetic.two_plane_scene(
        h, w, array_width=2, array_height=2, disp_bg=3.0, disp_fg=5.0, bl_ratio=1.0, seed=h
    )
    geom = DerivedGeometry.create(w, h, s)
    labels, spmap = jslic.segment(jax_rgb_to_lab(rgb), geom, SlicParams.create(s))
    return geom, np.asarray(labels), np.asarray(spmap.center)


@pytest.mark.parametrize("jax_form", ["superpixel_extent_walk", "superpixel_extent"])
def test_extent_bitwise_equals_jax(segmented, jax_form):
    geom, labels, center = segmented
    got = n(superpixel.superpixel_extent(t(labels, torch.int32), t(center), geom))
    want = np.asarray(getattr(jsp, jax_form)(labels, center, geom))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_step_and_samples_equal_jax(segmented):
    geom, labels, center = segmented
    ext = np.asarray(jsp.superpixel_extent(labels, center, geom))
    np.testing.assert_array_equal(
        n(superpixel.extent_step(t(ext, torch.int32))), np.asarray(jsp.extent_step(ext))
    )
    np.testing.assert_array_equal(
        n(superpixel.consistency_samples(t(ext, torch.int32))),
        np.asarray(jsp.consistency_samples(ext)),
    )
