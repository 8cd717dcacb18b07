"""Fusion: the port's label-gather rasterization against both JAX forms."""

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu import config as jcfg
from cl_multiview_stereo_tpu.ops import fusion as jfusion
from cl_multiview_stereo_tpu.ops import slic as jslic
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu.testing import synthetic
from cl_multiview_stereo_tpu_torch.ops import fusion
from torch_parity import jax_settings, n, small_settings, t


@pytest.fixture(scope="module")
def planes():
    s = jax_settings(small_settings())
    views, _ = synthetic.two_plane_scene(
        48, 64, array_width=2, array_height=2, disp_bg=5.0, disp_fg=9.0, bl_ratio=1.0, seed=7
    )
    geom = jcfg.DerivedGeometry.create(64, 48, s)
    labels, spmap = jslic.segment(jax_rgb_to_lab(views), geom, jcfg.SlicParams.create(s))
    rng = np.random.default_rng(3)
    v, mh, mw = 4, geom.map_h, geom.map_w
    d = rng.uniform(4, 11, (v, mh, mw)).astype(np.float32)
    nrm = rng.normal(size=(v, mh, mw, 3)).astype(np.float32)
    nrm[..., 2] = np.abs(nrm[..., 2]) + 0.5
    return np.asarray(labels), np.asarray(spmap.center), d, nrm


@pytest.mark.parametrize("jax_form", ["rasterize_planes", "rasterize_planes_gather"])
def test_rasterize_matches_jax(planes, jax_form):
    labels, center, d, nrm = planes
    got = n(fusion.rasterize_planes(t(labels, torch.int32), t(center), t(d), t(nrm)))
    want = np.asarray(getattr(jfusion, jax_form)(labels, center, d, nrm))
    # XLA on the CPU contracts the plane formula into two FMAs (measured:
    # fma(nz, d, fma(nx, cx - px, ny*(cy - py))) reproduces JAX bitwise);
    # the port rounds every product, as the reference kernel does.  Where
    # the terms cancel near d = 0 that is a few ulps of the largest term
    # (1.25e-6 at most on this scene), which rtol alone cannot hold.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=5e-6)

