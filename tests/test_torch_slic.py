"""SLIC: the port against the JAX package, fed JAX's own Lab image."""

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.config import DerivedGeometry, SlicParams
from cl_multiview_stereo_tpu.ops import slic as jslic
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu.testing import synthetic
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.ops import slic
from torch_parity import CPU, n, small_settings, t


@pytest.fixture(scope="module")
def scene():
    s = small_settings()
    views, _ = synthetic.two_plane_scene(
        48, 64, array_width=2, array_height=2, disp_bg=5.0, disp_fg=9.0, bl_ratio=1.0, seed=11
    )
    geom = DerivedGeometry.create(64, 48, s)
    p = SlicParams.create(s)
    lab = np.asarray(jax_rgb_to_lab(views))
    labels, spmap = jslic.segment(lab, geom, p)
    return dict(s=s, geom=geom, p=p, lab=lab, labels=np.asarray(labels), spmap=spmap)


def test_segment_matches_jax(scene):
    labels, spmap = slic.segment(t(scene["lab"]), scene["geom"], scene["p"])
    agree = (n(labels) == scene["labels"]).mean()
    # tests/test_slic.py's bound for JAX against its scalar mirror
    assert agree > 0.995, f"label agreement {agree}"
    h, w = scene["lab"].shape[1:3]
    np.testing.assert_array_equal(n(spmap.count).sum(axis=(1, 2)), np.full(4, h * w))
    assert n(labels).dtype == np.int32


def test_init_and_assignment_match_jax(scene):
    geom, p = scene["geom"], scene["p"]
    lab = scene["lab"]
    got0 = slic.init_cluster_centers(t(lab), geom)
    want0 = jslic.init_cluster_centers(lab, geom)
    np.testing.assert_array_equal(n(got0.center), np.asarray(want0.center))
    np.testing.assert_array_equal(n(got0.color), np.asarray(want0.color))
    # assignment against a converged JAX map (the parity swap matters there)
    spmap = convert.superpixel_map(
        {k: np.asarray(getattr(scene["spmap"], k)) for k in ("center", "color", "count")}, CPU
    )
    got = n(slic.find_center_association(t(lab), spmap, geom, p))
    want = np.asarray(jslic.find_center_association(lab, scene["spmap"], geom, p))
    assert (got == want).mean() > 0.995


def test_update_matches_jax(scene):
    """One update step fed JAX's labels and map."""
    geom = scene["geom"]
    lab, labels = scene["lab"], scene["labels"]
    jspmap = scene["spmap"]
    spmap = convert.superpixel_map(
        {k: np.asarray(getattr(jspmap, k)) for k in ("center", "color", "count")}, CPU
    )
    got = slic.update_cluster_centers(t(lab), t(labels, torch.int32), spmap, geom)
    want = jslic.update_cluster_centers(lab, labels, jspmap, geom)
    for field in ("center", "color", "count"):
        np.testing.assert_allclose(
            n(getattr(got, field)), np.asarray(getattr(want, field)), rtol=1e-4, atol=1e-3
        )


@pytest.mark.parametrize("flag", ["edge_enable", "enforce_connectivity"])
def test_unported_slic_options_raise(scene, flag):
    p = SlicParams.create(scene["s"].replace(**{flag: True}))
    with pytest.raises(NotImplementedError):
        slic.segment(t(scene["lab"]), scene["geom"], p)
