"""The gather engine's scorer on the consistency kernel: the plain twin of
each launch mode that the routing adds (the gather rule, the row window of
the row-sharded refinement, a block of views against the whole table)
against the port's ``consistency_from_cache`` and JAX's
``consistency_from_cache`` on the same seeded candidates, nz = 0 planes
included; ``pair_tables`` with a table view count; and the routing itself:
the CPU never builds a kernel, another device raises.  The scene is
tests/test_consistency_strips.py's (3x2 views, 48x64, bl_ratio 1.0359);
the kernel against these twins is in test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu import config as jcfg
from cl_multiview_stereo_tpu.ops import cost_volume as jcv
from cl_multiview_stereo_tpu.ops import refine as jref
from cl_multiview_stereo_tpu.ops import slic as jslic
from cl_multiview_stereo_tpu.ops import superpixel as jsp
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu.testing import synthetic
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.config import RefinementSchedule, build_disp_levels, build_view_subsets
from cl_multiview_stereo_tpu_torch.kernels import build
from cl_multiview_stereo_tpu_torch.ops import consistency, refine
from cl_multiview_stereo_tpu_torch.parallel import spatial
from cl_multiview_stereo_tpu_torch.parallel.sharded_pipeline import own_pairs
from torch_parity import CPU, jax_settings, n, small_settings, t

# the JAX suite's bound for the port's gather form against JAX's
# (test_torch_refine.py, test_init_state_matches_jax)
RTOL, ATOL = 2e-4, 2e-5
H, W = 48, 64
# the row window: 2 tiles of 24 pixel rows, each read with an 8-row halo
TILES, HALO = 2, 8
# the view block: views 3..5 of 6 (the second rank of 2)
V0, NV = 3, 3


@pytest.fixture(scope="module")
def scene():
    s = small_settings(array_width=3, array_height=2, bl_ratio=1.0359)
    js = jax_settings(s)
    views, _ = synthetic.two_plane_scene(
        H, W, array_width=3, array_height=2, disp_bg=5.0, disp_fg=9.0, bl_ratio=1.0359, seed=3,
    )
    geom = jcfg.DerivedGeometry.create(W, H, js)
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
    # the port's cache on JAX's rasterized state (test_torch_consistency.py)
    cache = refine.build_cache(ctx, state.d, state.n, gamma=kw["gamma"], **reach)
    cache = cache._replace(ras=t(jcache.ras))
    return dict(jctx=jctx, jcache=jcache, jstate=jstate, ctx=ctx, cache=cache, state=state,
                pairs=pairs, kw=kw, sched=sched)


# "nz0": table pixels set to NaN (the rasterized disparity of an nz = 0
# plane) in the interior, off every row and column where an infinite shift
# clamps (JAX wraps such an int32 shift where the port saturates the float,
# so the two clamp it to opposite edges; both count it as outside)
NAN_ROWS, NAN_COLS = (5, 9, 20, 26, 38, 42), slice(3, W - 3, 7)


def _clamped_only(sc, d_c, n_c):
    """(view, row, column) of the table pixels that samples outside the
    image read at their clamped position and no sample inside it reads,
    for the candidates (d_c, n_c): the plain form's projection."""
    ctx, pairs = sc["ctx"], sc["pairs"]
    refs = torch.tensor([p[0] for p in pairs])
    nbr = torch.tensor([p[1] for p in pairs])[:, None, None, None]
    dvx, dvy = (torch.tensor([p[k] for p in pairs])[:, None, None, None] for k in (2, 3))
    cx, cy = (ctx.center[..., k][:, :, None, :] for k in (0, 1))
    sx, sy = (c.to(torch.int64) + ctx.samples[..., k] for k, c in ((0, cx), (1, cy)))
    inside, outside = set(), set()
    for d, nrm in zip(t(d_c), t(n_c)):
        nx, ny, nz = (nrm[..., k].unsqueeze(-2) for k in range(3))
        dip = ((nx * (cx - sx) + ny * (cy - sy) + nz * d.unsqueeze(-2)) / nz)[refs]
        xp = sx[refs] - refine.cl_round(dip * dvx)
        yp = sy[refs] - refine.cl_round(sc["kw"]["bl_ratio"] * dip * dvy)
        inb = (xp >= 0) & (yp >= 0) & (xp < W) & (yp < H)
        pix = torch.stack([nbr.expand_as(xp), yp.clamp(0, H - 1).long(), xp.clamp(0, W - 1).long()], -1)
        inside.update(map(tuple, pix[inb].tolist()))
        outside.update(map(tuple, pix[~inb].tolist()))
    return tuple(np.asarray(sorted(outside - inside)).T)


def _candidates(sc, which):
    """Seeded candidate planes (M, V, Mh, Mw), (M, V, Mh, Mw, 3) and the
    table (V*H*W, 4) they are scored against.  "nz0": every cell of move 1
    and every other cell row of move 2 have nz = 0 (infinite sample
    disparities), move 3 has n = 0 on every third cell (0/0: NaN at every
    sample), and some interior table pixels are NaN; "outside": finite
    candidates against a table that is NaN only where samples outside the
    image read it, so that every NaN score is a 0 * NaN term."""
    d = np.asarray(sc["jstate"].d)
    nrm = np.asarray(sc["jstate"].n)
    rng = np.random.default_rng({"slanted": 1, "nz0": 5, "outside": 6}[which])
    m = 4
    n_c = rng.normal(0, 0.2, (m,) + nrm.shape).astype(np.float32)
    n_c[..., 2] += 1.0
    n_c /= np.linalg.norm(n_c, axis=-1, keepdims=True)
    d_c = d[None] + rng.normal(0, 2.0, (m,) + d.shape).astype(np.float32)
    ras = np.array(sc["jcache"].ras).reshape(-1, H, W, 4)
    if which == "nz0":
        n_c[1] = (1.0, 0.0, 0.0)
        n_c[2, :, ::2] = (0.6, 0.8, 0.0)
        n_c[3].reshape(-1, 3)[::3] = 0.0
        ras[:, NAN_ROWS, NAN_COLS, 0] = np.nan
    elif which == "outside":  # near the state, so that many samples are visible
        d_c = d[None] + rng.normal(0, 0.05, (m,) + d.shape).astype(np.float32)
        n_c[:] = nrm
        ras[_clamped_only(sc, d_c, n_c) + (0,)] = np.nan
    return d_c.astype(np.float32), n_c.astype(np.float32), ras.reshape(-1, 4)


def _jax_scores(jctx, jcache, d_c, n_c, pairs, kw, **geom):
    return np.stack([np.asarray(jref.consistency_from_cache(jctx, jcache, jnp.asarray(d_c[m]), jnp.asarray(n_c[m]),
                                                            pairs=pairs, **kw, **geom))
                     for m in range(d_c.shape[0])])


def _port_form(ctx, cache, d_c, n_c, pairs, kw, **geom):
    return np.stack([n(refine.consistency_from_cache(ctx, cache, t(d_c[m])[None], t(n_c[m])[None],
                                                     pairs=pairs, **kw, **geom))[0]
                     for m in range(d_c.shape[0])])


def _both(sc, ctx, jctx, d_c, n_c, ras, pairs, **geom):
    """(the twin under the gather rule, the port's gather form, JAX's)."""
    cache, jcache = sc["cache"]._replace(ras=t(ras)), sc["jcache"]._replace(ras=jnp.asarray(ras))
    twin = n(consistency.consistency_moves(ctx, cache, t(d_c), t(n_c), pairs=pairs, **sc["kw"],
                                           rule="gather", **geom))
    return (twin, _port_form(ctx, cache, d_c, n_c, pairs, sc["kw"], **geom),
            _jax_scores(jctx, jcache, d_c, n_c, pairs, sc["kw"], **geom))


def _hold(twin, form, jax_scores):
    """The twin is the port's gather form bitwise; both equal JAX's where
    finite and are NaN where it is."""
    np.testing.assert_array_equal(twin, form)
    assert np.array_equal(np.isnan(twin), np.isnan(jax_scores))
    np.testing.assert_allclose(twin, jax_scores, rtol=RTOL, atol=ATOL, equal_nan=True)


SETS = ["slanted", "nz0", "outside"]


@pytest.mark.parametrize("which", SETS)
def test_gather_rule_twin_matches_both_forms(scene, which):
    """The whole map against the whole table.  Against the strips rule:
    equal where every sample's disparity is finite; a NaN sample disparity
    counts as an occluded sample at offset 0, not as no sample.  A sample
    outside the image adds 0 * NaN where its clamped pixel is NaN (the
    "outside" set, whose every NaN is such a term)."""
    d_c, n_c, ras = _candidates(scene, which)
    twin, form, jax_scores = _both(scene, scene["ctx"], scene["jctx"], d_c, n_c, ras, scene["pairs"])
    _hold(twin, form, jax_scores)
    strips = n(consistency.consistency_moves(scene["ctx"], scene["cache"]._replace(ras=t(ras)), t(d_c),
                                             t(n_c), pairs=scene["pairs"], **scene["kw"]))
    finite_dip = n_c[..., 2] != 0
    np.testing.assert_array_equal(strips[finite_dip], twin[finite_dip])
    if which == "nz0":
        assert np.isnan(twin).any()
        assert not np.array_equal(strips[3], twin[3], equal_nan=True)
    if which == "outside":
        assert np.isnan(twin).any() and np.isfinite(twin[0]).any()


@pytest.mark.parametrize("which", SETS)
@pytest.mark.parametrize("tile", range(TILES))
def test_row_window_twin_matches_both_forms(scene, tile, which):
    """``img_hw``/``ras_rows`` as ``spatial.block_init``/``block_sweep``
    pass them: tile ``tile`` of TILES, its table rows and HALO rows each
    side (zero rows past the image, as the halo exchange pads)."""
    v, mh, _ = scene["state"].d.shape
    bh, bhp = mh // TILES, H // TILES
    row_lo, rows = tile * bhp - HALO, bhp + 2 * HALO
    d_all, n_all, ras = _candidates(scene, which)
    pad = np.zeros((v, HALO, W, 4), np.float32)
    table = np.concatenate([pad, ras.reshape(v, H, W, 4), pad], axis=1)
    win = np.ascontiguousarray(table[:, row_lo + HALO:row_lo + HALO + rows]).reshape(-1, 4)
    blk = spatial.block_context(scene["ctx"], tile, TILES)
    cells = lambda a: jnp.asarray(a)[:, tile * bh:(tile + 1) * bh]  # noqa: E731
    jblk = scene["jctx"]._replace(**{f: cells(getattr(scene["jctx"], f)) for f in ("center", "color", "samples", "fl")})
    d_c, n_c = (np.ascontiguousarray(a[:, :, tile * bh:(tile + 1) * bh]) for a in (d_all, n_all))
    twin, form, jax_scores = _both(scene, blk, jblk, d_c, n_c, win, scene["pairs"], img_hw=(H, W),
                                   ras_rows=(row_lo, rows))
    _hold(twin, form, jax_scores)
    # the window changes scores against the whole table
    whole, _, _ = _both(scene, scene["ctx"], scene["jctx"], d_all, n_all, ras, scene["pairs"])
    assert not np.array_equal(twin, whole[:, :, tile * bh:(tile + 1) * bh], equal_nan=True)


@pytest.mark.parametrize("which", SETS)
def test_view_block_twin_matches_both_forms(scene, which):
    """``sharded_pipeline.run_views``' scoring: views V0 .. V0 + NV - 1
    with their own pairs (references from 0, neighbours global) against
    the whole table, equal to the whole map's scores of those views."""
    pairs = own_pairs(scene["pairs"], V0, NV)
    assert max(p[1] for p in pairs) >= NV  # a neighbour outside the block
    views = lambda a: np.ascontiguousarray(np.asarray(a)[V0:V0 + NV])  # noqa: E731
    ctx = refine.RefineContext(*(t(views(x), x.dtype) if x.ndim > 2 else x for x in scene["ctx"]))
    jctx = scene["jctx"]._replace(**{f: jnp.asarray(getattr(scene["jctx"], f))[V0:V0 + NV]
                                     for f in ("center", "color", "samples", "fl", "disp0")})
    d_all, n_all, ras = _candidates(scene, which)
    d_c, n_c = (np.ascontiguousarray(a[:, V0:V0 + NV]) for a in (d_all, n_all))
    twin, form, jax_scores = _both(scene, ctx, jctx, d_c, n_c, ras, pairs)
    _hold(twin, form, jax_scores)
    whole, _, _ = _both(scene, scene["ctx"], scene["jctx"], d_all, n_all, ras, scene["pairs"])
    np.testing.assert_array_equal(twin, whole[:, V0:V0 + NV])


@pytest.mark.parametrize("v0", [0, 2, 4])
def test_pair_tables_with_table_views(scene, v0):
    """A block's own pairs give the whole table's rows of its views, the
    starts renumbered from 0; without the table's view count a neighbour
    outside the block is refused."""
    nv, v = 2, 6
    own = own_pairs(scene["pairs"], v0, nv)
    start, view, dv = consistency.pair_tables(own, nv, v)
    w_start, w_view, w_dv = consistency.pair_tables(scene["pairs"], v)
    lo, hi = w_start[v0], w_start[v0 + nv]
    np.testing.assert_array_equal(start, w_start[v0:v0 + nv + 1] - lo)
    np.testing.assert_array_equal(view, w_view[lo:hi])
    np.testing.assert_array_equal(dv, w_dv[lo:hi])
    assert start.dtype == view.dtype == np.int32 and dv.dtype == np.float32
    if view.max() >= nv:
        with pytest.raises(ValueError, match="outside"):
            consistency.pair_tables(own, nv)
    with pytest.raises(ValueError, match="outside"):
        consistency.pair_tables(own, nv, int(view.max()))
    got = consistency.device_pair_tables(own, nv, CPU, v)
    for g, w in zip(got, (start, view, dv)):
        np.testing.assert_array_equal(n(g), w)


@pytest.fixture
def no_build(monkeypatch):
    """kernels.build.load raises: a CPU tensor may never reach it."""
    def refuse(name):
        raise AssertionError(f"the CPU path tried to build {name}")

    monkeypatch.setattr(build, "load", refuse)
    return consistency.LAUNCHES


def test_cpu_refine_and_init_never_build(scene, no_build):
    """``refine.refine`` under the gather engine (its init state and two
    sweeps), ``init_scores`` and ``score_moves`` run the plain form on the
    CPU: the bits of ``consistency_from_cache`` called directly."""
    sc = scene
    kw = dict(sc["kw"], pairs=sc["pairs"])
    state = refine.refine(sc["ctx"], sc["sched"], pairs=sc["pairs"], cons_engine="gather")
    assert np.isfinite(n(state.cs)).all()
    st = sc["state"]
    got = refine.init_scores(sc["ctx"], sc["cache"], st.d, st.n, **kw)
    want = refine.consistency_from_cache(sc["ctx"], sc["cache"], st.d[None], st.n[None], **kw)[0]
    assert torch.equal(got.cs, want)
    d_c, n_c, _ = _candidates(sc, "nz0")
    sm, cs = refine.score_moves(sc["ctx"], sc["cache"], t(d_c), t(n_c), **kw)
    np.testing.assert_array_equal(n(cs), _port_form(sc["ctx"], sc["cache"], d_c, n_c, sc["pairs"], sc["kw"]))
    assert consistency.LAUNCHES == no_build


def test_cpu_block_local_work_never_builds(scene, no_build):
    """The row-sharded refinement's local work (``spatial.block_init``,
    ``block_sweep``), rank after rank with the whole table: the plain form
    with its ``img_hw``/``ras_rows``, equal to the unsharded init and
    sweep's rows (the gloo runs of test_torch_parallel.py and
    test_torch_sharded_pipeline.py patch ``load`` the same way in every
    rank)."""
    sc = scene
    ctx, sched, pairs = sc["ctx"], sc["sched"], sc["pairs"]
    kw = dict(sc["kw"], pairs=pairs)
    bh = ctx.disp0.shape[1] // TILES
    want0 = refine.init_state(ctx, **kw, steps=sched.kernel_steps, step_size=sched.sp_kernel_step)
    want1 = refine.propagate_iteration(ctx, want0, 0, **kw, steps=sched.steps_per_iter[0],
                                       step_size=sched.step_size_per_iter[0])
    table0 = refine.rasterize_table(ctx.labels, ctx.center, ctx.ras_color, ctx.disp0,
                                    refine._fronto_normals(ctx.disp0))
    table1 = refine.rasterize_table(ctx.labels, ctx.center, ctx.ras_color, want0.d, want0.n)
    for r in range(TILES):
        blk = spatial.block_context(ctx, r, TILES)
        rows = lambda a: a[:, r * bh:(r + 1) * bh]  # noqa: E731
        st = spatial.block_init(ctx, blk, sched, pairs, r, TILES, table0, (0, H))
        assert torch.equal(st.cs, rows(want0.cs)) and torch.equal(st.sm, rows(want0.sm))
        st = spatial.block_sweep(ctx, blk, sched, pairs, r, TILES, 0, refine.RefineState(*map(rows, want0)),
                                 want0.d, want0.n, table1, (0, H))
        for f in refine.RefineState._fields:
            assert torch.equal(getattr(st, f), rows(getattr(want1, f))), f
    assert consistency.LAUNCHES == no_build


def test_route_is_a_function_of_the_device_type(scene):
    """CPU: the plain twin; CUDA (any index): the kernel; any other
    device raises before a kernel or a plain form runs."""
    assert consistency.route("cpu") == consistency.route(CPU) == "plain"
    assert consistency.route("cuda") == consistency.route(torch.device("cuda", 3)) == "kernel"
    for dev in ("meta", torch.device("mps")):
        with pytest.raises(ValueError, match="no consistency kernel"):
            consistency.route(dev)
    sc = scene
    kw = dict(sc["kw"], pairs=sc["pairs"])
    meta = lambda x: x.to("meta") if isinstance(x, torch.Tensor) else x  # noqa: E731
    ctx = refine.RefineContext(*(meta(x) for x in sc["ctx"]))
    cache = refine.IterCache(*(meta(x) for x in sc["cache"]))
    d_c, n_c, _ = _candidates(sc, "slanted")
    with pytest.raises(ValueError, match="no consistency kernel"):
        refine.score_moves(ctx, cache, meta(t(d_c)), meta(t(n_c)), **kw)
    with pytest.raises(ValueError, match="no consistency kernel"):
        refine.init_scores(ctx, cache, meta(sc["state"].d), meta(sc["state"].n), **kw)
    with pytest.raises(ValueError, match="unknown rule"):
        consistency.consistency_moves(sc["ctx"], sc["cache"], t(d_c), t(n_c), **kw, rule="lanes")
