"""Fusion cross-check (the warp + stability vote): the port against the JAX
functions and the scalar mirrors of ``testing/mirror.py``."""

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu import config as jcfg
from cl_multiview_stereo_tpu.ops import fusion as jfusion
from cl_multiview_stereo_tpu.ops import slic as jslic
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu.testing import mirror, synthetic
from cl_multiview_stereo_tpu_torch.ops import fusion
from torch_parity import jax_settings, n, small_settings, t

BL = 1.0359
FUSE = 1.0
# tests/test_fusion_vote.py's tolerance against the mirror
RTOL = 1e-6


def _disp_maps(v: int, seed: int) -> np.ndarray:
    """tests/test_fusion_vote.py's fixture: piecewise-constant disparities
    with noise and rejected zeros, (v, 12, 16)."""
    rng = np.random.default_rng(seed)
    h, w = 12, 16
    base = rng.choice([0.0, 4.0, 7.0], size=(v, 1, 1), p=[0.1, 0.5, 0.4])
    d = np.broadcast_to(base, (v, h, w)) + rng.integers(0, 3, (v, h, w))
    d = d.astype(np.float32)
    d[rng.random((v, h, w)) < 0.1] = 0.0
    return d


# (array_width, disparity maps): the JAX vote test's 2x2 maps, and a 3x3
# camera array at the shipping bl_ratio
FIXTURES = {"2x2": (2, _disp_maps(4, 3)), "3x3": (3, _disp_maps(9, 17))}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_project_to_reference_inv_matches_jax_and_mirror(name):
    aw, d = FIXTURES[name]
    got = n(fusion.project_to_reference_inv(t(d), aw, BL))
    np.testing.assert_allclose(got, np.asarray(jfusion.project_to_reference_inv(d, aw, BL)), rtol=RTOL)
    np.testing.assert_allclose(got, mirror.project_to_reference_inv(d, aw, BL), rtol=RTOL)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_remove_view_inconsistency_matches_jax_and_mirror(name):
    aw, d = FIXTURES[name]
    proj = mirror.project_to_reference_inv(d, aw, BL).astype(np.float32)
    got = n(fusion.remove_view_inconsistency(t(proj), t(d), aw, BL, FUSE))
    want = np.asarray(jfusion.remove_view_inconsistency(proj, d, aw, BL, FUSE))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, mirror.remove_view_inconsistency(proj, d, aw, BL, FUSE), rtol=RTOL)
    assert (got == 0).any() and (got != 0).any()


@pytest.fixture(scope="module")
def planes():
    """Random planes on the labels of the 2x2 two-plane scene; a few
    superpixels get nz = 0, so ``disp_full`` holds non-finite values."""
    s = jax_settings(small_settings())
    views, _ = synthetic.two_plane_scene(
        48, 64, array_width=2, array_height=2, disp_bg=5.0, disp_fg=9.0, bl_ratio=1.0, seed=7
    )
    geom = jcfg.DerivedGeometry.create(64, 48, s)
    labels, spmap = jslic.segment(jax_rgb_to_lab(views), geom, jcfg.SlicParams.create(s))
    rng = np.random.default_rng(3)
    v, mh, mw = 4, geom.map_h, geom.map_w
    d = rng.uniform(4, 11, (v, mh, mw)).astype(np.float32)
    nrm = rng.normal(0, 0.05, (v, mh, mw, 3)).astype(np.float32)
    nrm[..., 2] = 1.0
    return np.asarray(labels), np.asarray(spmap.center), d, nrm


@pytest.mark.parametrize("blow_up", [False, True], ids=["finite", "nz0"])
def test_fuse_views_cross_check_matches_jax(planes, blow_up):
    labels, center, d, nrm = planes
    nrm = nrm.copy()
    if blow_up:
        nrm[:, 1, 2:5] = (1.0, 0.0, 0.0)  # nz = 0: +-inf and NaN pixels
    kw = dict(array_width=2, bl_ratio=BL, fuse=FUSE, cross_check=True)
    got = n(fusion.fuse_views(t(labels, torch.int32), t(center), t(d), t(nrm), **kw))
    want = np.asarray(jfusion.fuse_views(labels, center, d, nrm, **kw))
    # the rasterized input differs from XLA's FMA-contracted form by a few
    # ulps (tests/test_torch_fusion.py), hence atol beside rtol
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=5e-6, equal_nan=True)
    assert (np.isnan(got) == np.isnan(want)).all()
    assert np.isfinite(got).all() != blow_up
    assert (got == 0).any() and (got != 0).any()


def test_cross_check_needs_the_camera_geometry(planes):
    labels, center, d, nrm = planes
    with pytest.raises(ValueError, match="array_width"):
        fusion.fuse_views(t(labels, torch.int32), t(center), t(d), t(nrm), cross_check=True)
