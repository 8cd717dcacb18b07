"""Refinement: flatness, state init and one propagation sweep of the port,
each fed the JAX stage's own inputs through ``convert``."""

import numpy as np
import pytest

from cl_multiview_stereo_tpu import config as jcfg
from cl_multiview_stereo_tpu.ops import cost_volume as jcv
from cl_multiview_stereo_tpu.ops import refine as jref
from cl_multiview_stereo_tpu.ops import slic as jslic
from cl_multiview_stereo_tpu.ops import superpixel as jsp
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu.testing import synthetic
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.config import RefinementSchedule, build_disp_levels, build_view_subsets
from cl_multiview_stereo_tpu_torch.ops import refine
from torch_parity import CPU, jax_settings, n, small_settings, t


# tests/test_refine.py's two scenes: the 2x2 fixture, and the shipping
# geometry (3x3 views, bl_ratio 1.0359) of its slow reference-geometry test
GEOMETRIES = {
    "2x2": dict(array_width=2, array_height=2, bl_ratio=1.0, seed=7),
    "3x3-bl1.0359": dict(array_width=3, array_height=3, bl_ratio=1.0359, seed=13),
}


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def scene(request):
    """Two planes at d = 5 and 9, no_prop = 5."""
    g = GEOMETRIES[request.param]
    s = small_settings(
        no_prop=5, array_width=g["array_width"], array_height=g["array_height"],
        bl_ratio=g["bl_ratio"],
    )
    views, _ = synthetic.two_plane_scene(
        48, 64, array_width=g["array_width"], array_height=g["array_height"],
        disp_bg=5.0, disp_fg=9.0, bl_ratio=g["bl_ratio"], seed=g["seed"],
    )
    js = jax_settings(s)
    geom = jcfg.DerivedGeometry.create(64, 48, js)
    lab = np.asarray(jax_rgb_to_lab(views))
    labels, spmap = jslic.segment(lab, geom, jcfg.SlicParams.create(js))
    ext = jsp.superpixel_extent(labels, spmap.center, geom)
    subset, counts = build_view_subsets(s)
    disp0 = jcv.initial_depth_estimation(
        lab, spmap.center, ext, build_disp_levels(s), subset, counts,
        s.array_width, s.bl_ratio, method="strips",
    )
    sched = RefinementSchedule.create(s)
    fl = jref.compute_flatness(spmap.color, sched.gamma_eff)
    ck = {
        "center": np.asarray(spmap.center), "color": np.asarray(spmap.color),
        "labels": np.asarray(labels), "extent": np.asarray(ext),
        "disp_init": np.asarray(disp0), "flatness": np.asarray(fl),
    }
    jctx = jref.make_context(
        ck["center"], ck["color"], ck["disp_init"], ck["labels"], ck["extent"],
        ck["flatness"], subset, s.array_width,
    )
    ctx = refine.make_context(**convert.context_inputs(ck, CPU))
    kw = dict(
        gamma=sched.gamma_eff, alpha=sched.alpha_eff, fuse=sched.fuse_eff,
        bl_ratio=sched.bl_ratio, pairs=refine.pairs_from_subsets(subset, s.array_width),
    )
    jstate = jref.init_state(jctx, **kw, steps=sched.kernel_steps, step_size=sched.sp_kernel_step)
    return dict(s=s, sched=sched, ck=ck, jctx=jctx, ctx=ctx, kw=kw, jstate=jstate)


def test_flatness_matches_jax(scene):
    got = n(refine.compute_flatness(t(scene["ck"]["color"]), scene["sched"].gamma_eff))
    np.testing.assert_allclose(got, scene["ck"]["flatness"], rtol=1e-4, atol=1e-5)


def test_context_matches_jax(scene):
    ctx, jctx = scene["ctx"], scene["jctx"]
    for field in ("samples", "ras_color"):
        np.testing.assert_array_equal(n(getattr(ctx, field)), np.asarray(getattr(jctx, field)))


def test_init_state_matches_jax(scene):
    sched = scene["sched"]
    got = refine.init_state(
        scene["ctx"], **scene["kw"], steps=sched.kernel_steps, step_size=sched.sp_kernel_step
    )
    want = scene["jstate"]
    # tests/test_refine.py's bounds for JAX against its scalar mirror
    np.testing.assert_allclose(n(got.sm), np.asarray(want.sm), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(n(got.cs), np.asarray(want.cs), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(n(got.d), np.asarray(want.d), rtol=1e-6)
    np.testing.assert_array_equal(n(got.n), np.asarray(want.n))


@pytest.mark.parametrize("it", [0, 4])
def test_propagate_iteration_matches_jax(scene, it):
    """Both acceptance phases: ``it=0`` greedy, ``it=4`` product rule only.
    The port starts from JAX's init state."""
    sched = scene["sched"]
    reach = dict(steps=sched.steps_per_iter[it], step_size=sched.step_size_per_iter[it])
    jstate = scene["jstate"]
    state = convert.refine_state(
        {f"state_{f}": np.asarray(getattr(jstate, f)) for f in ("d", "sm", "cs", "n")}, CPU
    )
    got = refine.propagate_iteration(scene["ctx"], state, it, **scene["kw"], **reach)
    want = jref.propagate_iteration(scene["jctx"], jstate, it, **scene["kw"], **reach)
    size = n(got.d).size
    for field in ("d", "sm", "cs"):
        close = np.isclose(n(getattr(got, field)), np.asarray(getattr(want, field)),
                           rtol=1e-3, atol=1e-3)
        misses = int((~close).sum())
        print(f"it={it} {field}: {misses} of {size} superpixels differ")
        assert close.mean() >= 0.99 and misses <= max(2, size // 100), (it, field, misses)


def test_consistency_matches_jax_view_layout(scene):
    """The port's one gather scorer against JAX's view layout (per-view
    slots, bitwise equal to JAX's packed form), on candidate planes with
    random normals and on nz = 0 ones, at test_init_state_matches_jax's
    bounds; both sides start from JAX's init state."""
    sched, kw, jstate = scene["sched"], scene["kw"], scene["jstate"]
    reach = dict(steps=sched.kernel_steps, step_size=sched.sp_kernel_step)
    d, nrm = np.asarray(jstate.d), np.asarray(jstate.n)
    jcache = jref.build_cache(scene["jctx"], jstate.d, jstate.n, gamma=kw["gamma"], **reach)
    cache = refine.build_cache(scene["ctx"], t(d), t(nrm), gamma=kw["gamma"], **reach)
    rng = np.random.default_rng(4)
    n_c = rng.normal(0, 0.05, nrm.shape).astype(np.float32)
    n_c[..., 2] += 1.0
    n_c /= np.linalg.norm(n_c, axis=-1, keepdims=True)
    n_flat = n_c.copy()
    n_flat[:, ::2] = (1.0, 0.0, 0.0)  # nz = 0: non-finite candidate disparities
    for cand in (n_c, n_flat):
        got = n(refine.consistency_from_cache(scene["ctx"], cache, t(d)[None], t(cand)[None], **kw))[0]
        want = np.asarray(jref.consistency_from_cache(
            scene["jctx"], jcache, jstate.d, cand, pair_layout="view", **kw
        ))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_refine_view_layout_matches_jax(scene):
    """``refine(pair_layout="view")`` (the packed scorer in the port)
    against JAX's full view-layout refinement, init state and no_prop = 5
    sweeps, at test_torch_pipeline.py's disp_full bound (within 1e-3 on
    >= 0.98 of superpixels)."""
    sched, pairs = scene["sched"], scene["kw"]["pairs"]
    got = refine.refine(scene["ctx"], sched, pairs=pairs, pair_layout="view")
    want = jref.refine(scene["jctx"], sched, pairs=pairs, pair_layout="view")
    for field in ("d", "sm", "cs"):
        close = (np.abs(n(getattr(got, field)) - np.asarray(getattr(want, field))) <= 1e-3).mean()
        assert close >= 0.98, (field, close)


@pytest.mark.parametrize(
    "kw", [{"cons_engine": "strips", "pair_layout": "view"}, {"pair_layout": "diagonal"}], ids=str
)
def test_unported_refine_options_raise(kw):
    """The strips engines are packed-layout only, as in JAX
    (refine.py:1063); an unknown layout is refused."""
    sched = RefinementSchedule.create(small_settings())
    with pytest.raises(ValueError):
        refine.refine(None, sched, pairs=(), **kw)
