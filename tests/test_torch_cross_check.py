"""Fusion cross-check (the warp + stability vote): the port against the JAX
functions and the scalar mirrors of ``testing/mirror.py``; the routing of
``ops/crosscheck`` on the CPU (the plain forms, no build, no launch) and
what its wrappers hand the C entries of ``csrc/crosscheck.cu``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu import config as jcfg
from cl_multiview_stereo_tpu.ops import fusion as jfusion
from cl_multiview_stereo_tpu.ops import slic as jslic
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu.testing import mirror, synthetic
from cl_multiview_stereo_tpu_torch.ops import crosscheck, fusion
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


# -- the routing of ops/crosscheck (the kernels against the plain forms on
# the card are in test_torch_kernels_cuda.py)

VIEW_RANGES = [None, (1, 2), (0, 0)]


def test_route_by_device_type():
    assert crosscheck.route("cpu") == crosscheck.route(torch.device("cpu")) == "plain"
    assert crosscheck.route("cuda") == crosscheck.route(torch.device("cuda", 1)) == "kernel"
    with pytest.raises(ValueError, match="no cross-check kernel"):
        crosscheck.route("meta")
    meta = torch.zeros((4, 3, 3), device="meta")
    with pytest.raises(ValueError, match="no cross-check kernel"):
        fusion.project_to_reference_inv(meta, 2, BL)
    with pytest.raises(ValueError, match="no cross-check kernel"):
        fusion.remove_view_inconsistency(meta, meta, 2, BL, FUSE)


@pytest.mark.parametrize("view_range", VIEW_RANGES, ids=str)
@pytest.mark.parametrize("name", list(FIXTURES))
def test_wrappers_on_the_cpu_are_the_plain_forms(name, view_range):
    """On CPU tensors the routed warp and vote are their plain forms, bit
    for bit, and the plain forms' view range is the whole run's views."""
    aw, d = FIXTURES[name]
    d = t(d)
    proj = fusion.project_to_reference_inv(d, aw, BL, view_range)
    plain = fusion.project_to_reference_inv_reference(d, aw, BL, view_range)
    assert torch.equal(proj.view(torch.int32), plain.view(torch.int32))
    whole = fusion.project_to_reference_inv(d, aw, BL)
    v0, nv = (0, d.shape[0]) if view_range is None else view_range
    assert torch.equal(proj, whole[v0:v0 + nv])
    got = fusion.remove_view_inconsistency(whole, d, aw, BL, FUSE, view_range)
    want = fusion.remove_view_inconsistency_reference(whole, d, aw, BL, FUSE, view_range)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, fusion.remove_view_inconsistency(whole, d, aw, BL, FUSE)[v0:v0 + nv])


def test_cpu_never_builds_or_launches(planes, monkeypatch):
    """With the build refused (as where there is no nvcc), the cross-check
    fusion on CPU tensors runs and counts no launch."""
    from cl_multiview_stereo_tpu_torch.kernels import build

    def refuse(name):
        raise AssertionError(f"a CPU call built {name}")

    monkeypatch.setattr(build, "load", refuse)
    before = dict(crosscheck.LAUNCHES)
    labels, center, d, nrm = planes
    fusion.fuse_views(t(labels, torch.int32), t(center), t(d), t(nrm), array_width=2, bl_ratio=BL, fuse=FUSE,
                      cross_check=True)
    assert crosscheck.LAUNCHES == before


def test_ctypes_signature_matches_the_c_entry():
    """Every C entry of ``csrc/crosscheck.cu`` is bound and counted;
    ``_ENTRIES`` gives ctypes its pointers, ints and floats, then the stream."""
    src = (Path(crosscheck.__file__).resolve().parent.parent / "csrc" / "crosscheck.cu").read_text()
    entries = {}
    for name, params in re.findall(r'extern "C" int (\w+)_launch\(([^)]*)\)', src):
        kinds = []
        for param in (p.strip() for p in " ".join(params.split()).split(",")):
            kinds.append("stream" if param == "void* stream" else "ptr" if "*" in param else param.split()[0])
        entries[name] = kinds
    assert set(entries) == set(crosscheck._ENTRIES) == set(crosscheck.LAUNCHES)
    for name, (ptrs, ints, floats) in crosscheck._ENTRIES.items():
        assert entries[name] == ["ptr"] * ptrs + ["int"] * ints + ["float"] * floats + ["stream"]


@pytest.mark.parametrize("view_range", VIEW_RANGES, ids=str)
def test_wrappers_pass_the_c_entries_arguments(monkeypatch, view_range):
    """What the card's wrappers hand their C entries, the launch itself
    replaced (CPU tensors routed to the kernel): the maps, a fresh (nv, H, W)
    output, the shape, the view range, the grid's width, bl_ratio and fuse
    as float32; no launch for an empty range."""
    calls = []
    monkeypatch.setattr(crosscheck, "route", lambda dev: "kernel")
    monkeypatch.setattr(crosscheck, "_launch", lambda name, dev, *a: calls.append((name, a)))
    aw, d = FIXTURES["3x3"]
    d = t(d)
    v, h, w = d.shape
    v0, nv = (0, v) if view_range is None else view_range
    proj = crosscheck.warp(d, aw, 1.1, view_range)
    out = crosscheck.vote(d, d, aw, 1.1, 0.3, view_range)
    assert proj.shape == out.shape == (nv, h, w)
    if nv == 0:
        assert calls == []
        return
    (wn, wa), (vn, va) = calls
    assert wn == "fuse_warp" and len(wa) == sum(crosscheck._ENTRIES[wn])
    assert wa[:2] == (d.data_ptr(), proj.data_ptr()) and wa[2:8] == (v, h, w, v0, nv, aw)
    assert wa[8] == float(np.float32(1.1))
    assert vn == "fuse_vote" and len(va) == sum(crosscheck._ENTRIES[vn])
    assert va[:3] == (d.data_ptr(), d.data_ptr(), out.data_ptr()) and va[3:9] == (v, h, w, v0, nv, aw)
    assert va[9:] == (float(np.float32(1.1)), float(np.float32(0.3)))


def _seeded_maps(v=9, h=24, w=40, seed=0) -> torch.Tensor:
    """Piecewise disparities on a half-pixel grid with zeros, NaN, +inf and
    -inf (test_torch_kernels_cuda.py's card maps at a smaller size):
    differences of exactly 0.5 and 1.0, and equal values in many views."""
    rng = np.random.default_rng(seed)
    d = rng.choice([0.0, 4.0, 7.0, 12.0], size=(v, h, w), p=[0.1, 0.4, 0.3, 0.2]) + rng.integers(0, 3, (v, h, w)) * 0.5
    d = d.astype(np.float32)
    u = rng.random((v, h, w))
    d[u < 0.01] = np.nan
    d[(u >= 0.01) & (u < 0.015)] = np.inf
    d[(u >= 0.015) & (u < 0.02)] = -np.inf
    return t(d)


def _walks_one_output_at_a_time(proj, d, aw, view_range):
    """Both walks of the vote, one output at a time on the plain form's
    votes: the view-order walk's (looked at, lookups) and the descending
    walk's (values scored, lookups), each pixel's NaN-free values in
    descending order for all its reference views, with its winners."""
    v, h, w = proj.shape
    cands = [(c, stab1, list(votes)) for c, stab1, votes in fusion.vote_stabilities(proj, d, aw, BL, FUSE,
                                                                                      view_range)]
    nv = cands[0][0].shape[0]

    def score(i, r, y, x):
        """(stability >= 0, lookups made) of candidate i for output (r, y, x)."""
        _, stab1, votes = cands[i]
        stability, made = int(stab1[y, x]), 0
        for j, vote in enumerate(votes):
            left = len(votes) - j
            if stability - left >= 0 or stability + left < 0:
                break
            made += 1
            stability += int(vote[r, y, x])
        return stability >= 0, made

    looked = lookups = scored = desc_lookups = 0
    winners = torch.zeros((nv, h, w))
    for y in range(h):
        for x in range(w):
            values = [float(c[0, y, x]) for c, _, _ in cands]
            nan = any(np.isnan(values))
            for r in range(nv):
                best = 0.0
                for i, c in enumerate(values):
                    if not (c != 0 and (best == 0 or best < c)):
                        continue
                    ok, made = score(i, r, y, x)
                    looked += 1
                    lookups += made
                    if nan:
                        scored, desc_lookups = scored + 1, desc_lookups + made
                    if ok:
                        best = c
                winners[r, y, x] = best
            if nan:
                continue
            open_ = set(range(nv))
            for c in sorted({c for c in values if c != 0}, reverse=True):
                if not open_:
                    break
                scored += 1
                for r in sorted(open_):
                    ok, made = score(values.index(c), r, y, x)
                    desc_lookups += made
                    if ok:
                        open_.discard(r)
                        assert winners[r, y, x] == c  # the view-order walk's winner
            for r in open_:
                assert winners[r, y, x] == 0
    return (looked, lookups), (scored, desc_lookups), winners


@pytest.mark.parametrize("view_range", [None, (2, 4)], ids=str)
def test_vote_counts_follow_the_kernels_rule(view_range):
    """``tools.roofline.vote_counts``: the work of both walks counted one
    output at a time: the view-order walk's (candidate, output) pairs
    looked at and lookups, the descending walk's values scored and lookups
    (the view-order walk's on a pixel with a NaN candidate), vote 2's
    lookups in view order while the lookups left could change the
    stability's sign, on the plain form's votes; and the operations and
    bytes of both, the lesser the bound's."""
    from cl_multiview_stereo_tpu_torch.tools import roofline

    aw, d = FIXTURES["3x3"]
    d = t(d)
    d[4, 3, 5] = d[7, 9, 2] = float("nan")
    proj = fusion.project_to_reference_inv_reference(d, aw, BL)
    view_order, descending, winners = _walks_one_output_at_a_time(proj, d, aw, view_range)
    counts = roofline.vote_counts(proj, d, aw, BL, FUSE, view_range)
    nan_looked, nan_lookups, nan_pixels = counts["nan"]
    assert counts["view_order"] == view_order
    assert (counts["descending"][0] + nan_looked, counts["descending"][1] + nan_lookups) == descending
    assert nan_pixels == int(torch.isnan(proj).any(0).sum()) > 0 and counts["pixels"] == d.shape[1] * d.shape[2]
    assert torch.equal(counts["winners"].view(torch.int32), winners.view(torch.int32))
    looked, lookups = view_order
    nv = winners.shape[0]
    assert 0 < looked < 9 * nv * d.shape[1] * d.shape[2] and 0 < lookups < 9 * looked
    out = fusion.remove_view_inconsistency_reference(proj, d, aw, BL, FUSE, view_range)
    n_bytes, ops, extra = roofline.fuse_vote_work(proj, d, aw, BL, FUSE, view_range, out)
    assert n_bytes == 4 * (2 * d.numel() + out.numel())
    assert extra["view_order_ops"] == 4 * 9 * out.numel() + looked * (1 + 9 * 5) + lookups * 23
    scored = descending[0] - nan_looked
    assert extra["descending_ops"] == (4 * 9 * (scored + nv * nan_pixels) + descending[0] * (1 + 9 * 5)
                                       + descending[1] * 23)
    assert ops == min(extra["view_order_ops"], extra["descending_ops"])
    for walk in ("view_order", "descending"):
        assert extra[f"{walk}_bound_ms"] == roofline.bound(n_bytes, extra[f"{walk}_ops"])[0]
    warped = fusion.project_to_reference_inv_reference(d, aw, BL, (2, 4))
    assert roofline.fuse_warp_work(d, warped) == (4 * (d.numel() + warped.numel()), 16 * warped.numel() * 8)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_descending_rule_matches_jax_and_the_plain_vote(name):
    """The vote's candidates walked in descending order (the ``fuse_vote``
    kernel's rule, ``tools.roofline.vote_counts``): within RTOL of JAX's
    vote and bitwise the port's plain vote, with no more candidates scored
    and no more lookups than the walk in view order."""
    from cl_multiview_stereo_tpu_torch.tools import roofline

    aw, d = FIXTURES[name]
    proj = mirror.project_to_reference_inv(d, aw, BL).astype(np.float32)
    counts = roofline.vote_counts(t(proj), t(d), aw, BL, FUSE)
    got = counts["winners"]
    np.testing.assert_allclose(n(got), np.asarray(jfusion.remove_view_inconsistency(proj, d, aw, BL, FUSE)),
                               rtol=RTOL)
    want = fusion.remove_view_inconsistency_reference(t(proj), t(d), aw, BL, FUSE)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got == 0).any() and (got != 0).any()
    _assert_fewer(counts)


def _assert_fewer(counts):
    """The descending walk scores no more candidates and makes no more
    lookups than the walk in view order, and fewer of either."""
    (looked, lookups), (scored, made), (nan_looked, nan_lookups, _) = (
        counts["view_order"], counts["descending"], counts["nan"])
    assert scored + nan_looked <= looked and made + nan_lookups <= lookups
    assert scored + nan_looked < looked or made + nan_lookups < lookups


@pytest.mark.parametrize("view_range", [None, (3, 3), (8, 1)], ids=str)
@pytest.mark.parametrize("fuse", [0.5, 1.0])
def test_descending_rule_bitwise_on_nan_inf_and_ties(fuse, view_range):
    """On a seeded map holding NaN, +-inf, differences exactly equal to
    ``fuse`` and equal candidates from several views, the descending rule
    gives the plain vote's bits (NaN where it puts NaN); its NaN-free
    pixels include some whose largest candidate loses for a view."""
    from cl_multiview_stereo_tpu_torch.tools import roofline

    d = _seeded_maps()
    proj = fusion.project_to_reference_inv_reference(d, 3, BL)
    counts = roofline.vote_counts(proj, d, 3, BL, fuse, view_range)
    want = fusion.remove_view_inconsistency_reference(proj, d, 3, BL, fuse, view_range)
    got = counts["winners"]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    nan = torch.isnan(proj).any(0)
    assert bool(nan.any()) and bool(torch.isnan(got).any()) and bool(torch.isinf(proj[:, ~nan]).any())
    top = torch.where(proj == 0, float("-inf"), proj).amax(0)
    assert bool(((got != top) & ~nan).any())
    # several views share a pixel's largest candidate
    assert bool(((proj == top).sum(0) > 1)[~nan].any())
    _assert_fewer(counts)
