"""SLIC on the kernels of ``csrc/slic.cu``: the routing, the plain forms
that the CPU keeps (bitwise JAX's, fed JAX's own Lab image, map and labels),
and a torch emulation of the update kernel's order of sums against JAX's
update, labels that belong to no cluster included.  The kernels against
these plain forms are in test_torch_kernels_cuda.py (``-k slic``)."""

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu import config as jcfg
from cl_multiview_stereo_tpu.ops import slic as jslic
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu.testing import synthetic
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.config import DerivedGeometry, SlicParams
from cl_multiview_stereo_tpu_torch.kernels import build
from cl_multiview_stereo_tpu_torch.ops import slic
from torch_parity import CPU, jax_settings, n, small_settings, t

# the colour bound of the update kernel against its plain form on the card
# (the same sums, an order apart), held here to the emulation and to JAX's
# jitted segment; centre and count add integers below 2**24: bitwise
COLOR_RTOL, COLOR_ATOL = 1e-5, 1e-4
# (H, W, spixl_size): the two JAX-test sizes, a ragged one and S = 5
SHAPES = {"48x64": (48, 64, 8), "90x160": (90, 160, 8), "ragged-45x70": (45, 70, 8),
          "ragged-47x61-S5": (47, 61, 5)}


def _scene(h, w, s_px):
    s = small_settings(spixl_size=s_px)
    views, _ = synthetic.two_plane_scene(
        h, w, array_width=2, array_height=2, disp_bg=5.0, disp_fg=9.0, bl_ratio=1.0, seed=11
    )
    js = jax_settings(s)
    jgeom, jp = jcfg.DerivedGeometry.create(w, h, js), jcfg.SlicParams.create(js)
    lab = np.asarray(jax_rgb_to_lab(views))
    labels, spmap = jslic.segment(lab, jgeom, jp)
    return dict(s=s, geom=DerivedGeometry.create(w, h, s), p=SlicParams.create(s), jgeom=jgeom, jp=jp,
                lab=lab, labels=np.asarray(labels), jspmap=spmap,
                spmap=convert.superpixel_map({k: np.asarray(getattr(spmap, k)) for k in ("center", "color", "count")},
                                             CPU))


@pytest.fixture(scope="module", params=list(SHAPES))
def scene(request):
    return _scene(*SHAPES[request.param])


def _map_equal(got, want, fields=("center", "color", "count")):
    for f in fields:
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)


def emulate_update(lab: torch.Tensor, labels: torch.Tensor, geom: DerivedGeometry) -> slic.SuperpixelMap:
    """``slic_update``'s sums in its order, in float32: per home cell and
    class (dy, dx) each pixel column's S rows in ascending order, then the
    cell's S columns in ascending order (x as the column's x times its
    count); per cluster the nine classes' partials of its home cells, dy
    outer, dx inner; then the means, a cluster with no member zeroed."""
    v, h, w = lab.shape[:3]
    s, mh, mw = geom.spixl_size, geom.map_h, geom.map_w
    hp, wp = mh * s, mw * s
    lbl = torch.full((v, hp, wp), -1, dtype=torch.int64)
    lbl[:, :h, :w] = labels.to(torch.int64)
    vals = torch.zeros((5, v, hp, wp))  # L, a, b, y, count
    vals[0:3, :, :h, :w] = lab.permute(3, 0, 1, 2)
    vals[3, :, :h, :w] = torch.arange(h, dtype=torch.float32)[:, None]
    vals[4, :, :h, :w] = 1.0
    home_y = torch.arange(hp)[:, None] // s
    home_x = torch.arange(wp)[None, :] // s
    ok = (lbl >= 0) & (lbl < mh * mw)
    dy = torch.where(ok, lbl // mw - home_y, 9)
    dx = torch.where(ok, lbl % mw - home_x, 9)
    # (5, V, Mh, S rows, Mw, S cols)
    cells = vals.reshape(5, v, mh, s, mw, s)
    xs = torch.arange(wp, dtype=torch.float32).reshape(mw, s)
    partial = {}
    for ky in (-1, 0, 1):
        for kx in (-1, 0, 1):
            sel = ((dy == ky) & (dx == kx)).reshape(v, mh, s, mw, s)
            col = torch.zeros((5, v, mh, mw, s))
            for r in range(s):
                col = col + torch.where(sel[:, :, r], cells[:, :, :, r], 0.0)
            block = torch.zeros((6, v, mh, mw))
            for c in range(s):
                cx = col[..., c]
                block = block + torch.stack([cx[0], cx[1], cx[2], xs[:, c] * cx[4], cx[3], cx[4]])
            partial[(ky, kx)] = block
    rowm = torch.arange(mh)[:, None]
    colm = torch.arange(mw)[None, :]
    sums = torch.zeros((6, v, mh, mw))
    for ky in (-1, 0, 1):
        for kx in (-1, 0, 1):
            shifted = torch.roll(partial[(ky, kx)], shifts=(ky, kx), dims=(2, 3))
            inside = (rowm - ky >= 0) & (rowm - ky < mh) & (colm - kx >= 0) & (colm - kx < mw)
            sums = sums + torch.where(inside, shifted, 0.0)
    nz = sums[5] > 0
    denom = torch.where(nz, sums[5], 1.0)
    mean = torch.where(nz, sums / denom, 0.0)
    return slic.SuperpixelMap(center=mean[3:5].permute(1, 2, 3, 0), color=mean[0:3].permute(1, 2, 3, 0),
                              count=torch.where(nz, sums[5], 0.0), disp=torch.zeros((v, mh, mw)))


def _emulation_close(got, want):
    np.testing.assert_array_equal(n(got.center), np.asarray(want.center))
    np.testing.assert_array_equal(n(got.count), np.asarray(want.count))
    np.testing.assert_allclose(n(got.color), np.asarray(want.color), rtol=COLOR_RTOL, atol=COLOR_ATOL)


@pytest.mark.parametrize("device, want", [("cpu", "plain"), ("cuda", "kernel"), ("cuda:0", "kernel")])
def test_route(device, want):
    assert slic.route(device) == want
    assert slic.route(torch.device(device)) == want


def test_route_raises_for_other_devices():
    with pytest.raises(ValueError, match="no SLIC kernel"):
        slic.route("meta")
    meta = torch.empty((1, 8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no SLIC kernel"):
        slic.suppress_local_labels(meta)


def test_cpu_never_builds_the_kernels(monkeypatch):
    """The CPU path runs the plain forms and never asks for the library."""
    def refuse(name):
        raise AssertionError(f"the CPU path asked for the {name} kernels")

    monkeypatch.setattr(build, "load", refuse)
    sc = _scene(*SHAPES["48x64"])
    before = dict(slic.LAUNCHES)
    labels, _ = slic.segment(t(sc["lab"]), sc["geom"], SlicParams.create(sc["s"].replace(enforce_connectivity=True)))
    assert labels.dtype == torch.int32
    assert slic.LAUNCHES == before


def _jax_chain(lab, jgeom, jp):
    """JAX's SLIC sequence one function at a time, outside ``jax.jit``
    (``jslic.segment`` compiles it whole, and XLA's fusion then adds the
    colour sums in another order)."""
    spmap = jslic.init_cluster_centers(lab, jgeom)
    labels = jslic.find_center_association(lab, spmap, jgeom, jp)
    for _ in range(jp.no_iter):
        spmap = jslic.update_cluster_centers(lab, labels, spmap, jgeom)
        labels = jslic.find_center_association(lab, spmap, jgeom, jp)
    return labels, spmap


def test_segment_bitwise_jax(scene):
    """Labels, centres and counts bitwise ``jslic.segment``'s, the colours
    within the update's colour bound of them; the whole map bitwise JAX's
    functions chained."""
    labels, spmap = slic.segment(t(scene["lab"]), scene["geom"], scene["p"])
    np.testing.assert_array_equal(n(labels), scene["labels"])
    _map_equal(spmap, scene["jspmap"], ("center", "count"))
    np.testing.assert_allclose(n(spmap.color), np.asarray(scene["jspmap"].color), rtol=COLOR_RTOL,
                               atol=COLOR_ATOL)
    chain_labels, chain = _jax_chain(scene["lab"], scene["jgeom"], scene["jp"])
    np.testing.assert_array_equal(n(labels), np.asarray(chain_labels))
    _map_equal(spmap, chain)


def test_assignment_bitwise_jax(scene):
    got = slic.find_center_association(t(scene["lab"]), scene["spmap"], scene["geom"], scene["p"])
    want = jslic.find_center_association(scene["lab"], scene["jspmap"], scene["jgeom"], scene["jp"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_update_bitwise_jax(scene):
    got = slic.update_cluster_centers(t(scene["lab"]), t(scene["labels"], torch.int32), scene["spmap"],
                                      scene["geom"])
    _map_equal(got, jslic.update_cluster_centers(scene["lab"], scene["labels"], scene["jspmap"], scene["jgeom"]))


def test_update_kernel_order_emulation_matches_jax(scene):
    got = emulate_update(t(scene["lab"]), t(scene["labels"], torch.int32), scene["geom"])
    _emulation_close(got, jslic.update_cluster_centers(scene["lab"], scene["labels"], scene["jspmap"],
                                                       scene["jgeom"]))


def _stray_labels(labels, geom, seed=4):
    """``labels`` with three kinds of stray pixels at seeded places: -1, a
    label past Mh*Mw and the cluster two cell columns right of the pixel's
    home cell (or left, at the map's right edge).  Returns (labels, how
    many pixels were changed)."""
    rng = np.random.default_rng(seed)
    out = labels.copy()
    v, h, w = labels.shape
    s, mh, mw = geom.spixl_size, geom.map_h, geom.map_w
    pick = rng.choice(v * h * w, size=3 * 24, replace=False).reshape(3, 24)
    flat = out.reshape(-1)
    flat[pick[0]] = -1
    flat[pick[1]] = mh * mw + rng.integers(0, 40, 24)
    vv, yy, xx = np.unravel_index(pick[2], labels.shape)
    cx = xx // s
    far = np.where(cx + 2 < mw, cx + 2, cx - 2)
    flat[pick[2]] = (yy // s) * mw + far
    return out, pick.size


def test_update_drops_stray_labels_as_jax(scene):
    labels, n_stray = _stray_labels(scene["labels"], scene["geom"])
    want = jslic.update_cluster_centers(scene["lab"], labels, scene["jspmap"], scene["jgeom"])
    v, h, w = labels.shape
    assert float(np.asarray(want.count).sum()) == v * h * w - n_stray  # JAX drops all of them
    got = slic.update_cluster_centers(t(scene["lab"]), t(labels, torch.int32), scene["spmap"], scene["geom"])
    _map_equal(got, want)
    _emulation_close(emulate_update(t(scene["lab"]), t(labels, torch.int32), scene["geom"]), want)


def test_update_zeroes_empty_clusters_as_jax():
    """Every pixel of one view's top-left 3x3 cells relabelled to cluster 0
    empties the clusters that no neighbouring cell's pixels join; the
    emulation and the plain form zero them as JAX does."""
    sc = _scene(*SHAPES["48x64"])
    labels = sc["labels"].copy()
    s = sc["geom"].spixl_size
    labels[1, :3 * s, :3 * s] = 0
    want = jslic.update_cluster_centers(sc["lab"], labels, sc["jspmap"], sc["jgeom"])
    count = np.asarray(want.count)
    assert (count[1] == 0).any()
    got = slic.update_cluster_centers(t(sc["lab"]), t(labels, torch.int32), sc["spmap"], sc["geom"])
    _map_equal(got, want)
    _emulation_close(emulate_update(t(sc["lab"]), t(labels, torch.int32), sc["geom"]), want)
    assert not n(got.center)[1][count[1] == 0].any() and not n(got.color)[1][count[1] == 0].any()


@pytest.mark.parametrize("source", ["segment", "noisy"])
def test_vote_bitwise_jax(scene, source):
    labels = scene["labels"]
    if source == "noisy":  # flips enough neighbours to trigger the vote often
        rng = np.random.default_rng(2)
        labels = np.where(rng.random(labels.shape) < 0.4, rng.integers(0, 48, labels.shape), labels)
        labels = labels.astype(np.int32)
    got = n(slic.suppress_local_labels(t(labels, torch.int32)))
    np.testing.assert_array_equal(got, np.asarray(jslic.suppress_local_labels(labels)))
    if source == "noisy":
        assert (got != labels).any()
