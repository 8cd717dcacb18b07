"""SLIC: the port against the JAX package, fed JAX's own Lab image; the
edge snap's routing on the CPU and what its wrapper hands the C entry."""

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu import config as jcfg
from cl_multiview_stereo_tpu.ops import slic as jslic
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu.testing import mirror, synthetic
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.config import DerivedGeometry, SlicParams
from cl_multiview_stereo_tpu_torch.ops import slic
from torch_parity import CPU, jax_settings, n, small_settings, t


@pytest.fixture(scope="module")
def scene():
    s = small_settings()
    views, _ = synthetic.two_plane_scene(
        48, 64, array_width=2, array_height=2, disp_bg=5.0, disp_fg=9.0, bl_ratio=1.0, seed=11
    )
    js = jax_settings(s)
    jgeom, jp = jcfg.DerivedGeometry.create(64, 48, js), jcfg.SlicParams.create(js)
    lab = np.asarray(jax_rgb_to_lab(views))
    labels, spmap = jslic.segment(lab, jgeom, jp)
    return dict(s=s, geom=DerivedGeometry.create(64, 48, s), p=SlicParams.create(s), jgeom=jgeom,
                jp=jp, lab=lab, labels=np.asarray(labels), spmap=spmap)


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
    want0 = jslic.init_cluster_centers(lab, scene["jgeom"])
    np.testing.assert_array_equal(n(got0.center), np.asarray(want0.center))
    np.testing.assert_array_equal(n(got0.color), np.asarray(want0.color))
    # assignment against a converged JAX map (the parity swap matters there)
    spmap = convert.superpixel_map(
        {k: np.asarray(getattr(scene["spmap"], k)) for k in ("center", "color", "count")}, CPU
    )
    got = n(slic.find_center_association(t(lab), spmap, geom, p))
    want = np.asarray(jslic.find_center_association(lab, scene["spmap"], scene["jgeom"], scene["jp"]))
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
    want = jslic.update_cluster_centers(lab, labels, jspmap, scene["jgeom"])
    for field in ("center", "color", "count"):
        np.testing.assert_allclose(
            n(getattr(got, field)), np.asarray(getattr(want, field)), rtol=1e-4, atol=1e-3
        )



def test_compute_edges_matches_jax_and_mirror(scene):
    lab = scene["lab"]
    got = n(slic.compute_edges(t(lab)))
    np.testing.assert_allclose(got, np.asarray(jslic.compute_edges(lab)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[1], mirror.edge_compute(lab[1]), rtol=1e-5, atol=1e-4)


def test_edge_snap_matches_jax(scene):
    """Fed JAX's own edges, so the snap (a strict ``<``) is judged apart
    from the edges' ulps."""
    geom, lab = scene["geom"], scene["lab"]
    edges = np.asarray(jslic.compute_edges(lab))
    jmap = jslic.init_cluster_centers(lab, scene["jgeom"])
    want = jslic.apply_edge_snap(lab, edges, jmap)
    got = slic.apply_edge_snap(t(lab), t(edges), slic.init_cluster_centers(t(lab), geom))
    np.testing.assert_array_equal(n(got.center), np.asarray(want.center))
    np.testing.assert_allclose(n(got.color), np.asarray(want.color), rtol=1e-6)
    assert (n(got.center) != np.asarray(jmap.center)).any()
    c, col = mirror.apply_edge(lab[0], edges[0], np.asarray(jmap.center)[0], np.asarray(jmap.color)[0])
    np.testing.assert_array_equal(n(got.center)[0], c)


@pytest.mark.parametrize("source", ["segment", "noisy"])
def test_suppress_local_labels_bitwise(scene, source):
    labels = scene["labels"]
    if source == "noisy":  # flips enough neighbours to trigger the vote often
        rng = np.random.default_rng(2)
        labels = np.where(rng.random(labels.shape) < 0.4, rng.integers(0, 48, labels.shape), labels)
        labels = labels.astype(np.int32)
    got = n(slic.suppress_local_labels(t(labels, torch.int32)))
    np.testing.assert_array_equal(got, np.asarray(jslic.suppress_local_labels(labels)))
    np.testing.assert_array_equal(got[0], mirror.slic_suppress_labels(labels[0]))
    if source == "noisy":
        assert (got != labels).any()


@pytest.mark.parametrize(
    "flags",
    [{"edge_enable": True}, {"enforce_connectivity": True},
     {"edge_enable": True, "enforce_connectivity": True}],
    ids=lambda f: "+".join(f),
)
def test_segment_with_flags_matches_jax(scene, flags):
    s = scene["s"].replace(**flags)
    labels, spmap = slic.segment(t(scene["lab"]), scene["geom"], SlicParams.create(s))
    jlabels, jspmap = jslic.segment(scene["lab"], scene["jgeom"], jcfg.SlicParams.create(jax_settings(s)))
    agree = (n(labels) == np.asarray(jlabels)).mean()
    # tests/test_slic.py's bound for JAX against its scalar mirror
    assert agree > 0.995, f"label agreement {agree}"
    np.testing.assert_allclose(n(spmap.center), np.asarray(jspmap.center), rtol=1e-4, atol=1e-3)


# -- the edge snap's routing (``slic.edge_snap``; the kernel against the
# plain form on the card is in test_torch_kernels_cuda.py)

def test_edge_snap_on_the_cpu_is_the_plain_form(scene):
    """On CPU tensors the routed snap is ``apply_edge_snap`` on
    ``compute_edges``, bit for bit; count and disp pass through."""
    lab = t(scene["lab"])
    seeds = slic.init_cluster_centers(lab, scene["geom"])
    got = slic.edge_snap(lab, seeds)
    want = slic.apply_edge_snap(lab, slic.compute_edges(lab), seeds)
    for f in ("center", "color"):
        assert torch.equal(getattr(got, f).view(torch.int32), getattr(want, f).view(torch.int32)), f
    assert got.count is seeds.count and got.disp is seeds.disp
    ref = slic.edge_snap_reference(lab, seeds)
    assert torch.equal(ref.center, want.center) and torch.equal(ref.color, want.color)
    assert (got.center != seeds.center).any()


def test_segment_reference_with_the_edge_snap_is_segment_on_the_cpu(scene):
    s = scene["s"].replace(edge_enable=True, enforce_connectivity=True)
    p = SlicParams.create(s)
    labels, spmap = slic.segment(t(scene["lab"]), scene["geom"], p)
    want_labels, want_map = slic.segment_reference(t(scene["lab"]), scene["geom"], p)
    assert torch.equal(labels, want_labels)
    for f in ("center", "color", "count"):
        assert torch.equal(getattr(spmap, f), getattr(want_map, f)), f


def test_edge_snap_routes_by_device(monkeypatch):
    from cl_multiview_stereo_tpu_torch.kernels import build

    def refuse(name):
        raise AssertionError(f"a CPU call built {name}")

    monkeypatch.setattr(build, "load", refuse)
    lab = torch.zeros((2, 16, 16, 3))
    seeds = slic.init_cluster_centers(lab, DerivedGeometry.create(16, 16, small_settings()))
    before = slic.LAUNCHES["edge_snap"]
    slic.edge_snap(lab, seeds)
    assert slic.LAUNCHES["edge_snap"] == before
    with pytest.raises(ValueError, match="no SLIC kernel"):
        slic.edge_snap(lab.to("meta"), seeds)


@pytest.mark.parametrize("cells", [(6, 8), (0, 8)], ids=["6x8", "none"])
def test_edge_snap_wrapper_passes_the_c_entrys_arguments(monkeypatch, cells):
    """What the card's wrapper hands ``edge_snap_launch``, the launch itself
    replaced (CPU tensors routed to the kernel): lab, the seeds' centre and
    colour, fresh outputs of their shapes, the shape and the cell count; no
    launch for no cell."""
    calls = []
    monkeypatch.setattr(slic, "route", lambda dev: "plain" if dev == "never" else "kernel")
    monkeypatch.setattr(slic, "_launch", lambda name, dev, *a: calls.append((name, a)))
    v, h, w = 2, 45, 61
    lab = torch.rand((v, h, w, 3))
    mh, mw = cells
    seeds = slic.SuperpixelMap(center=torch.rand((v, mh, mw, 2)), color=torch.rand((v, mh, mw, 3)),
                               count=torch.zeros((v, mh, mw)), disp=torch.zeros((v, mh, mw)))
    got = slic.edge_snap(lab, seeds)
    assert got.center.shape == seeds.center.shape and got.color.shape == seeds.color.shape
    assert got.count is seeds.count and got.disp is seeds.disp
    if mh == 0:
        assert calls == []
        return
    (name, args), = calls
    assert name == "edge_snap" and len(args) == sum(slic._ENTRIES[name])
    assert args == (lab.data_ptr(), seeds.center.data_ptr(), seeds.color.data_ptr(), got.center.data_ptr(),
                    got.color.data_ptr(), v, h, w, mh * mw)


def test_edge_snap_work_counts_the_blocks_sectors():
    """``tools.roofline.edge_snap_work`` on one 1x4x4 view with a seed in
    the middle and one on the corner: the 5x5 block clamped into the view
    is the whole view (16 pixels, 192 bytes, 6 sectors), read once."""
    from cl_multiview_stereo_tpu_torch.tools import roofline

    lab = torch.rand((1, 4, 4, 3))
    seeds = slic.SuperpixelMap(center=torch.tensor([[[[1.5, 2.0], [0.0, 0.0]]]]), color=torch.rand((1, 1, 2, 3)),
                               count=torch.zeros((1, 1, 2)), disp=torch.zeros((1, 1, 2)))
    out = slic.edge_snap(lab, seeds)
    n_bytes, ops = roofline.edge_snap_work(lab, seeds, out)
    assert n_bytes == 6 * 32 + 2 * 4 * (2 * 2 + 2 * 3)
    ring = 8 + 3  # all 8 neighbours of (1, 2) lie in the view, 3 of (0, 0)'s
    assert ops == 60 * (2 + ring) + ring
