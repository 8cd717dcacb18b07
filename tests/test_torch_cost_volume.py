"""Depth-init cost volume: the port's plain twin against the JAX strips
form (which runs the Pallas ``_win_extract_kernel`` in interpret mode on
the CPU) and the JAX dense form, and the port's gather form against JAX's
gather form and the scalar mirror.  The CUDA kernel against the twin is in
test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu import config as jcfg
from cl_multiview_stereo_tpu.ops import cost_volume as jcv
from cl_multiview_stereo_tpu.ops import slic as jslic
from cl_multiview_stereo_tpu.ops import superpixel as jsp
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu.testing import mirror, synthetic
from cl_multiview_stereo_tpu_torch.config import build_disp_levels, build_view_subsets
from cl_multiview_stereo_tpu_torch.kernels import build
from cl_multiview_stereo_tpu_torch.ops import cost_volume
from torch_parity import jax_settings, n, small_settings, t

# the JAX suite's bounds for strips against dense (tests/test_depth_init.py)
RTOL, ATOL, WTA_AGREE = 2e-7, 1e-3, 0.999


@pytest.fixture(scope="module")
def scene():
    """tests/test_depth_init.py's scene: fronto-parallel plane at d = 7."""
    s = small_settings()
    js = jax_settings(s)
    views, _ = synthetic.fronto_parallel_scene(
        48, 64, array_width=2, array_height=2, disp=7.0, bl_ratio=1.0, seed=5
    )
    geom = jcfg.DerivedGeometry.create(64, 48, js)
    lab = np.asarray(jax_rgb_to_lab(views))
    labels, spmap = jslic.segment(lab, geom, jcfg.SlicParams.create(js))
    ext = jsp.superpixel_extent(labels, spmap.center, geom)
    return dict(
        s=s, lab=lab, center=np.asarray(spmap.center), ext=np.asarray(ext),
        step=np.asarray(jsp.extent_step(ext)),
    )


def _wta(vol, levels):
    return n(cost_volume.wta_disparity(t(vol), levels, torch.ones(vol.shape[0])))


@pytest.mark.parametrize(
    "bl_ratio,inc", [(1.0, 1.0), (1.0359, 1.0), (1.0359, 0.5), (0.97, 1.0)]
)
def test_reference_matches_jax_strips_and_dense(scene, bl_ratio, inc):
    import jax.numpy as jnp

    s = scene["s"]
    levels = np.arange(s.min_disp, s.max_disp + inc / 2, inc, dtype=np.float32)
    args = (scene["lab"], scene["center"], scene["step"])
    strips = np.asarray(jcv.superpixel_cost_volume_strips(
        *args, tuple(float(d) for d in levels), s.array_width, bl_ratio,
        s.neib_hor, s.neib_ver,
    ))
    dense = np.asarray(jcv.superpixel_cost_volume_dense(
        *args, jnp.asarray(levels), s.array_width, bl_ratio, s.neib_hor, s.neib_ver,
        float(np.max(np.abs(levels))),
    ))
    got = n(cost_volume.cost_volume_reference(
        *(t(a) for a in args), levels, s.array_width, bl_ratio, s.neib_hor, s.neib_ver,
    ))
    assert got.shape == strips.shape and got.dtype == np.float32
    for name, want in (("strips", strips), ("dense", dense)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        agree = (_wta(got, levels) == _wta(want, levels)).mean()
        assert agree > WTA_AGREE, f"{name} WTA agreement {agree}"


def test_cpu_wrapper_runs_the_twin_without_the_build(scene, monkeypatch):
    """A CPU tensor takes the plain twin: no build, no launch counted."""
    def no_build(name):
        raise AssertionError(f"the CPU path tried to build {name}")

    monkeypatch.setattr(build, "load", no_build)
    s = scene["s"]
    levels = build_disp_levels(s)
    before = cost_volume.LAUNCHES
    args = (t(scene["lab"]), t(scene["center"]), t(scene["step"]), levels, s.array_width, s.bl_ratio)
    got = cost_volume.superpixel_cost_volume(*args)
    assert cost_volume.LAUNCHES == before
    np.testing.assert_array_equal(n(got), n(cost_volume.cost_volume_reference(*args)))


def test_initial_depth_estimation_matches_jax(scene):
    s = scene["s"]
    levels = build_disp_levels(s)
    subset, counts = build_view_subsets(s)
    args = (t(scene["lab"]), t(scene["center"]), t(scene["ext"], torch.int32), levels, subset,
            t(counts, torch.int32), s.array_width, s.bl_ratio)
    for method in ("strips", "gather"):
        want = np.asarray(jcv.initial_depth_estimation(
            scene["lab"], scene["center"], scene["ext"], levels, subset, counts,
            s.array_width, s.bl_ratio, method=method,
        ))
        for port_method in (("strips", "dense") if method == "strips" else ("gather",)):
            got = n(cost_volume.initial_depth_estimation(*args, method=port_method))
            assert (got == want).mean() > WTA_AGREE, port_method


@pytest.mark.parametrize("bl_ratio", [1.0, 1.0359, 0.97])
def test_gather_volume_matches_jax(scene, bl_ratio):
    """The gather form against JAX's: the volume within rtol=1e-6,
    atol=1e-4 and the WTA on >= 0.999 of cells."""
    s = scene["s"]
    levels = build_disp_levels(s)
    subset, _ = build_view_subsets(s)
    want = np.asarray(jcv.superpixel_cost_volume(
        scene["lab"], scene["center"], scene["step"], levels, subset, s.array_width, bl_ratio
    ))
    got = n(cost_volume.cost_volume_gather(
        t(scene["lab"]), t(scene["center"]), t(scene["step"]), levels, subset,
        s.array_width, bl_ratio,
    ))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    agree = (_wta(got, levels) == _wta(want, levels)).mean()
    assert agree >= WTA_AGREE, f"WTA agreement {agree}"


def test_gather_depth_init_matches_mirror(scene):
    """Against the float64 scalar mirror: the bound of
    tests/test_depth_init.py (WTA agreement > 0.98)."""
    s = scene["s"]
    levels = build_disp_levels(s)
    subset, counts = build_view_subsets(s)
    got = n(cost_volume.initial_depth_estimation(
        t(scene["lab"]), t(scene["center"]), t(scene["ext"], torch.int32), levels, subset,
        t(counts, torch.int32), s.array_width, s.bl_ratio, method="gather",
    ))
    want = mirror.initial_depth_estimation_v2(
        scene["lab"], scene["center"], scene["ext"], levels, subset, counts,
        s.array_width, s.bl_ratio,
    )
    agree = (got == want).mean()
    assert agree > 0.98, f"mirror agreement {agree}"


def test_unknown_depth_method_raises(scene):
    s = scene["s"]
    with pytest.raises(ValueError, match="depth method"):
        cost_volume.initial_depth_estimation(
            t(scene["lab"]), t(scene["center"]), t(scene["ext"], torch.int32),
            build_disp_levels(s), *build_view_subsets(s), s.array_width, s.bl_ratio,
            method="sparse",
        )
