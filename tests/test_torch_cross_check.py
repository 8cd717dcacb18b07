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


def test_vote_counts_follow_the_kernels_rule():
    """``tools.roofline.vote_counts``: the (candidate, output) pairs the
    vote looks at and the lookups it makes, counted one output at a time:
    the take rule, then vote 2's lookups in view order while the lookups
    left could change the stability's sign, on the plain form's votes."""
    from cl_multiview_stereo_tpu_torch.tools import roofline

    aw, d = FIXTURES["3x3"]
    d = t(d)
    proj = fusion.project_to_reference_inv_reference(d, aw, BL)
    cands = [(c, stab1, list(votes)) for c, stab1, votes in fusion.vote_stabilities(proj, d, aw, BL, FUSE, (2, 4))]
    looked = lookups = 0
    for r in range(4):
        for y in range(d.shape[1]):
            for x in range(d.shape[2]):
                best = 0.0
                for c, stab1, votes in cands:
                    c = float(c[r, y, x])
                    if not (c != 0 and (best == 0 or best < c)):
                        continue
                    looked += 1
                    stability = int(stab1[y, x])
                    for j, vote in enumerate(votes):
                        left = len(votes) - j
                        if stability - left >= 0 or stability + left < 0:
                            break
                        lookups += 1
                        stability += int(vote[r, y, x])
                    if stability >= 0:
                        best = c
    assert roofline.vote_counts(proj, d, aw, BL, FUSE, (2, 4)) == (looked, lookups)
    assert 0 < looked < 9 * 4 * d.shape[1] * d.shape[2] and 0 < lookups < 9 * looked
    out = fusion.remove_view_inconsistency_reference(proj, d, aw, BL, FUSE, (2, 4))
    n_bytes, ops = roofline.fuse_vote_work(proj, d, aw, BL, FUSE, (2, 4), out)
    assert n_bytes == 4 * (2 * d.numel() + out.numel())
    assert ops == 4 * 9 * out.numel() + looked * (1 + 9 * 5) + lookups * 23
    warped = fusion.project_to_reference_inv_reference(d, aw, BL, (2, 4))
    assert roofline.fuse_warp_work(d, warped) == (4 * (d.numel() + warped.numel()), 16 * warped.numel() * 8)
