"""Strips consistency engine: the port's ``consistency_moves`` on CPU
tensors (its plain twin) against JAX's ``consistency_moves`` (the Pallas
``_terms_kernel`` in interpret mode) and against the port's own gather
form; one propagation sweep under each engine.  The scene is
tests/test_consistency_strips.py's (3x2 views, 48x64, bl_ratio 1.0359),
carried across by ``convert``.  The CUDA kernel against the twin is in
test_torch_kernels_cuda.py."""

import numpy as np
import pytest

from cl_multiview_stereo_tpu import config as jcfg
from cl_multiview_stereo_tpu.ops import cost_volume as jcv
from cl_multiview_stereo_tpu.ops import refine as jref
from cl_multiview_stereo_tpu.ops import slic as jslic
from cl_multiview_stereo_tpu.ops import superpixel as jsp
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu.ops.pallas.consistency import consistency_moves as jax_consistency_moves
from cl_multiview_stereo_tpu.testing import synthetic
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.config import RefinementSchedule, build_disp_levels, build_view_subsets
from cl_multiview_stereo_tpu_torch.kernels import build
from cl_multiview_stereo_tpu_torch.ops import consistency, refine
from torch_parity import CPU, jax_settings, n, small_settings, t

# the JAX suite's bound for strips against gather (test_consistency_strips.py)
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def scene():
    s = small_settings(array_width=3, array_height=2, bl_ratio=1.0359)
    js = jax_settings(s)
    views, _ = synthetic.two_plane_scene(
        48, 64, array_width=3, array_height=2, disp_bg=5.0, disp_fg=9.0, bl_ratio=1.0359, seed=3,
    )
    geom = jcfg.DerivedGeometry.create(64, 48, js)
    lab = np.asarray(jax_rgb_to_lab(views))
    labels, spmap = jslic.segment(lab, geom, jcfg.SlicParams.create(js))
    ext = np.asarray(jsp.superpixel_extent(labels, spmap.center, geom))
    subset, counts = build_view_subsets(s)
    disp0 = jcv.initial_depth_estimation(
        lab, spmap.center, ext, build_disp_levels(s), subset, counts, s.array_width, s.bl_ratio,
    )
    sched = RefinementSchedule.create(s)
    ck = {
        "center": np.asarray(spmap.center), "color": np.asarray(spmap.color),
        "labels": np.asarray(labels), "extent": ext, "disp_init": np.asarray(disp0),
        "flatness": np.asarray(jref.compute_flatness(spmap.color, sched.gamma_eff)),
    }
    jctx = jref.make_context(
        ck["center"], ck["color"], ck["disp_init"], ck["labels"], ck["extent"], ck["flatness"],
        subset, s.array_width,
    )
    pairs = jref.pairs_from_subsets(subset, s.array_width)
    kw = dict(gamma=sched.gamma_eff, alpha=sched.alpha_eff, fuse=sched.fuse_eff, bl_ratio=sched.bl_ratio)
    reach = dict(steps=sched.kernel_steps, step_size=sched.sp_kernel_step)
    jstate = jref.init_state(jctx, pairs=pairs, **kw, **reach)
    jcache = jref.build_cache(jctx, jstate.d, jstate.n, gamma=kw["gamma"], **reach)
    ctx = refine.make_context(**convert.context_inputs(ck, CPU))
    state = convert.refine_state(
        {f"state_{f}": np.asarray(getattr(jstate, f)) for f in ("d", "sm", "cs", "n")}, CPU
    )
    # the port's cache on JAX's rasterized state, so the engines are judged
    # apart from the rasterizer's FMA ulps (test_torch_fusion.py)
    cache = refine.build_cache(ctx, state.d, state.n, gamma=kw["gamma"], **reach)
    cache = cache._replace(ras=t(jcache.ras))
    return dict(jctx=jctx, jcache=jcache, jstate=jstate, ctx=ctx, cache=cache, state=state,
                pairs=pairs, kw=kw)


def _candidates(sc, which):
    """tests/test_consistency_strips.py's candidate sets, as numpy."""
    d = np.asarray(sc["jstate"].d)
    nrm = np.asarray(sc["jstate"].n)
    if which == "perturbed":
        rng = np.random.default_rng(0)
        d_c = d[None] + rng.normal(0, 1.5, (5,) + d.shape).astype(np.float32)
        n_c = np.broadcast_to(nrm[None], (5,) + nrm.shape).copy()
    elif which == "slanted":
        rng = np.random.default_rng(1)
        n_c = rng.normal(0, 0.2, (4,) + nrm.shape).astype(np.float32)
        n_c[..., 2] += 1.0
        n_c /= np.linalg.norm(n_c, axis=-1, keepdims=True)
        d_c = d[None] + rng.normal(0, 2.0, (4,) + d.shape).astype(np.float32)
    else:  # "escape": spread far beyond the TPU strip window
        rng = np.random.default_rng(2)
        shifts = np.asarray([0.0, 40.0, -35.0, 90.0], np.float32)
        d_c = d[None] + shifts[:, None, None, None] + rng.normal(0, 1.0, (4,) + d.shape).astype(np.float32)
        n_c = np.broadcast_to(nrm[None], (4,) + nrm.shape).copy()
    return d_c.astype(np.float32), n_c.astype(np.float32)


def _port(sc, d_c, n_c, **kw):
    return n(consistency.consistency_moves(
        sc["ctx"], sc["cache"], t(d_c), t(n_c), pairs=sc["pairs"], **sc["kw"], **kw
    ))


def _gather_stack(sc, d_c, n_c):
    return np.stack([
        n(refine.consistency_from_cache(
            sc["ctx"], sc["cache"], t(d_c[m])[None], t(n_c[m])[None], pairs=sc["pairs"], **sc["kw"],
        ))[0]
        for m in range(d_c.shape[0])
    ])


SETS = ["perturbed", "slanted", "escape"]


@pytest.mark.parametrize("which", SETS)
def test_consistency_moves_matches_jax(scene, which):
    d_c, n_c = _candidates(scene, which)
    want, esc = jax_consistency_moves(
        scene["jctx"], scene["jcache"], d_c, n_c, scene["jstate"].d, scene["jstate"].n,
        pairs=scene["pairs"], **scene["kw"],
    )
    assert int(esc) == 0
    np.testing.assert_allclose(_port(scene, d_c, n_c), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", SETS)
def test_consistency_moves_equals_gather_form(scene, which):
    """For finite candidates the strips twin is the gather form, bitwise,
    whatever the batch of moves scored together."""
    d_c, n_c = _candidates(scene, which)
    want = _gather_stack(scene, d_c, n_c)
    for chunk in (1, 4, 32):
        np.testing.assert_array_equal(_port(scene, d_c, n_c, score_chunk=chunk), want)


@pytest.mark.parametrize("which", SETS)
def test_moves_are_scored_independently(scene, which):
    """A move's score depends on it and the frozen state only: the moves
    one at a time, and in a permuted order, give the batched call's bits.
    The card kernel's layout of moves over threads relies on it."""
    d_c, n_c = _candidates(scene, which)
    batched = _port(scene, d_c, n_c)
    alone = np.stack([_port(scene, d_c[m:m + 1], n_c[m:m + 1])[0] for m in range(d_c.shape[0])])
    np.testing.assert_array_equal(alone, batched)
    perm = np.random.default_rng(4).permutation(d_c.shape[0])
    np.testing.assert_array_equal(_port(scene, d_c[perm], n_c[perm]), batched[perm])


@pytest.mark.parametrize(
    "pairs",
    [None, ((0, 1, 0.5, 0.0), (0, 3, 0.0, 1.0), (2, 1, -1.0, 0.0), (4, 5, 0.25, -0.75))],
    ids=["scene", "fractional"],
)
def test_device_pair_tables_match_pair_tables(scene, pairs):
    """The wrapper's cached device tables are ``pair_tables``' arrays,
    made once per (pairs, views, device)."""
    pairs = scene["pairs"] if pairs is None else pairs
    got = consistency.device_pair_tables(pairs, 6, "cpu")
    for g, w in zip(got, consistency.pair_tables(pairs, 6)):
        np.testing.assert_array_equal(n(g), w)
        assert n(g).dtype == w.dtype
    again = consistency.device_pair_tables(list(pairs), 6, CPU)
    assert all(a is b for a, b in zip(again, got))


def test_non_finite_candidates_count_as_outside(scene, monkeypatch):
    """nz = 0 planes have no finite disparity at any sample: no NaN, the
    0.01 floor where a whole candidate blows up, the gather form's scores
    wherever the candidate is finite.  A CPU tensor never builds."""
    def no_build(name):
        raise AssertionError(f"the CPU path tried to build {name}")

    monkeypatch.setattr(build, "load", no_build)
    d_c, n_c = _candidates(scene, "perturbed")
    d_c, n_c = d_c[:3], n_c[:3]
    n_c[1] = (1.0, 0.0, 0.0)
    n_c[2, :, ::2] = (0.6, 0.8, 0.0)
    before = consistency.LAUNCHES
    got = _port(scene, d_c, n_c)
    assert consistency.LAUNCHES == before
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], np.float32(0.01))
    want = _gather_stack(scene, d_c, n_c)
    finite = n_c[..., 2] != 0
    np.testing.assert_array_equal(got[finite], want[finite])


def _sweep(sc, engine):
    st = sc["state"]
    return refine.propagate_iteration(
        sc["ctx"], st, 0, **sc["kw"], pairs=sc["pairs"], steps=1, step_size=16.0, cons_engine=engine,
    )


def test_propagate_strips_matches_jax(scene):
    """One greedy sweep under the strips engine, port against JAX, with
    test_consistency_strips.py's whole-sweep bound."""
    got = _sweep(scene, "strips")
    want = jref._propagate_iteration(
        scene["jctx"], scene["jstate"], 0, cons_engine="strips", **scene["kw"], pairs=scene["pairs"],
        steps=1, step_size=16.0,
    )
    for field in ("d", "sm", "cs"):
        close = np.isclose(n(getattr(got, field)), np.asarray(getattr(want, field)), rtol=1e-3, atol=1e-3)
        assert close.mean() >= 0.995, (field, close.mean())


def test_propagate_engines_agree(scene):
    """"strips" and "strips_xla" are one function; both accept exactly
    the gather engine's moves."""
    gather = _sweep(scene, "gather")
    for engine in ("strips", "strips_xla"):
        got = _sweep(scene, engine)
        for field in ("d", "sm", "cs", "n"):
            np.testing.assert_array_equal(n(getattr(got, field)), n(getattr(gather, field)), err_msg=engine)


@pytest.mark.parametrize(
    "kw", [{"cons_engine": "strips_xla", "pair_layout": "view"}, {"cons_engine": "lanes"}],
    ids=str,
)
def test_refine_rejects_bad_engine(kw):
    sched = RefinementSchedule.create(small_settings())
    with pytest.raises(ValueError):
        refine.refine(None, sched, pairs=(), **kw)
    if "pair_layout" not in kw:
        with pytest.raises(ValueError):
            refine.propagate_iteration(None, None, 0, gamma=1.0, alpha=1.0, fuse=1.0, bl_ratio=1.0,
                                       steps=0, step_size=1.0, pairs=(), **kw)

