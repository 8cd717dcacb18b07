"""The rest of the refinement sweep on the CPU: the plain forms that
``ops/raster`` and ``ops/chain`` route the CPU to (the plane rasterization,
the update moves' candidates and the move chain's two accept walks) against
the JAX package's functions on the same numpy-seeded inputs; and the
routing itself: the CPU never builds a kernel and launches nothing, another
device raises, and the ctypes bindings read the C entries of
``csrc/raster.cu`` and ``csrc/chain.cu``.  The kernels against these forms
are in test_torch_kernels_cuda.py.

The inputs are cell maps, not SLIC's output: 3x3 views of 6x8 cells (a
48x64 image at S = 8), each pixel labelled with its own cell or one of its
neighbours (SLIC's bound, which JAX's gather-free lookup needs), random
planes with a few nz = 0 normals (inf and NaN disparities), and random
scores.  Bounds, port against
JAX:

- the table and fusion's map within test_torch_fusion.py's bound (rtol
  1e-6, atol 5e-6: XLA contracts the plane formula into FMAs), the table's
  colour bitwise;
- the candidates' normals and validity bitwise, their disparity within the
  same bound and their similarity within test_torch_smoothness.py's
  TAP_RTOL (XLA's exp and torch's differ by an ulp or two);
- a whole sweep within test_torch_refine.py's bound (1e-3 on >= 0.99 of
  the cells, at most max(2, 1 %) missing).
"""

import ctypes
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.ops import fusion as jfusion
from cl_multiview_stereo_tpu.ops import refine as jref
from cl_multiview_stereo_tpu_torch.config import DerivedGeometry, RefinementSchedule, build_view_subsets
from cl_multiview_stereo_tpu_torch.kernels import build
from cl_multiview_stereo_tpu_torch.ops import chain, fusion, raster, refine, superpixel
from torch_parity import CPU, n, small_settings, t

V, H, W, S = 9, 48, 64, 8
MH, MW = H // S, W // S
PLANE_RTOL, PLANE_ATOL = 1e-6, 5e-6
TAP_RTOL, TAP_ATOL = 1e-5, 1e-7
SWEEP_TOL, SWEEP_AGREE = 1e-3, 0.99
SETTINGS = small_settings(array_width=3, array_height=3, no_prop=5)


def _inputs(seed=5):
    """Centres near each cell's middle, Lab colours near one grey, labels of
    each pixel's cell or a neighbour, disparities, slanted normals (every
    seventh (1, 0, 0), whose planes rasterize to +-inf, and every eleventh
    from the fourth (0, 0, 0), to NaN) and scores;
    ``clean``: the normals before the degenerate ones went in."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(MH), np.arange(MW), indexing="ij")
    center = np.stack([xx * S + 3.5, yy * S + 3.5], -1)[None] + rng.uniform(-2, 2, (V, MH, MW, 2))
    color = np.array([50.0, 0.0, 0.0]) + rng.normal(0, [3.0, 1.5, 1.5], (V, MH, MW, 3))
    py, px = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ly = np.clip(py // S + rng.integers(-1, 2, (V, H, W)), 0, MH - 1)
    lx = np.clip(px // S + rng.integers(-1, 2, (V, H, W)), 0, MW - 1)
    labels = (ly * MW + lx).astype(np.int32)
    d = rng.uniform(4.0, 11.0, (V, MH, MW))
    nrm = rng.normal(0, 0.2, (V, MH, MW, 3))
    nrm[..., 2] = np.abs(nrm[..., 2]) + 0.8
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    clean = nrm.copy()
    nrm.reshape(-1, 3)[::7] = (1.0, 0.0, 0.0)
    nrm.reshape(-1, 3)[3::11] = 0.0
    sm, cs = rng.uniform(0.01, 1.0, (2, V, MH, MW))
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(center=f32(center), color=f32(color), labels=labels, d=f32(d), n=f32(nrm), clean=f32(clean),
                sm=f32(sm), cs=f32(cs))


@pytest.fixture(scope="module")
def scene():
    x = _inputs()
    sched = RefinementSchedule.create(SETTINGS)
    geom = DerivedGeometry.create(W, H, SETTINGS)
    labels = t(x["labels"], torch.int32)
    extent = superpixel.superpixel_extent(labels, t(x["center"]), geom)
    fl = refine.compute_flatness(t(x["color"]), sched.gamma_eff)
    ctx = refine.make_context(t(x["center"]), t(x["color"]), t(x["d"]), labels, extent, fl)
    subset, _ = build_view_subsets(SETTINGS)
    jctx = jref.make_context(x["center"], x["color"], x["d"], x["labels"], n(extent), n(fl), subset,
                             SETTINGS.array_width)
    state = refine.RefineState(d=t(x["d"]), sm=t(x["sm"]), cs=t(x["cs"]), n=t(x["n"]))
    jstate = jref.RefineState(*(jnp.asarray(x[f]) for f in ("d", "sm", "cs", "n")))
    # the sweep's input state: slanted planes, none degenerate (the
    # engines' non-finite rules are test_torch_consistency_routing.py's)
    clean = refine.RefineState(d=t(x["d"]), sm=t(x["sm"]), cs=t(x["cs"]), n=t(x["clean"]))
    jclean = jref.RefineState(*(jnp.asarray(x[f]) for f in ("d", "sm", "cs", "clean")))
    kw = dict(gamma=sched.gamma_eff, alpha=sched.alpha_eff, fuse=sched.fuse_eff, bl_ratio=sched.bl_ratio,
              pairs=refine.pairs_from_subsets(subset, SETTINGS.array_width))
    return dict(x=x, sched=sched, ctx=ctx, jctx=jctx, state=state, jstate=jstate, clean=clean, jclean=jclean,
                kw=kw)


def _reach(sched, it):
    return dict(steps=sched.steps_per_iter[it], step_size=sched.step_size_per_iter[it])


def _offs(sched, it):
    r = _reach(sched, it)
    return refine._update_move_offsets(r["steps"], r["step_size"], MW, MH)


def test_rasterize_table_matches_jax(scene):
    x, ctx = scene["x"], scene["ctx"]
    got = n(refine.rasterize_table(ctx.labels, ctx.center, ctx.ras_color, t(x["d"]), t(x["n"])))
    want = np.asarray(jref._rasterize_flat(scene["jctx"], jnp.asarray(x["d"]), jnp.asarray(x["n"])))
    assert got.shape == want.shape == (V * H * W, 4)
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    assert np.array_equal(np.isnan(got[:, 0]), np.isnan(want[:, 0])) and np.isnan(got[:, 0]).any()
    assert np.isinf(got[:, 0]).any()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=PLANE_RTOL, atol=PLANE_ATOL, equal_nan=True)


@pytest.mark.parametrize("row0", [0, 2 * S, 5 * S])
def test_rasterize_table_rows_are_the_whole_tables(scene, row0):
    """A band of pixel rows from ``row0`` (the row-sharded refinement's
    ``block_table``) is the whole table's rows."""
    x, ctx = scene["x"], scene["ctx"]
    whole = refine.rasterize_table(ctx.labels, ctx.center, ctx.ras_color, t(x["d"]), t(x["n"]))
    rows = S
    band = ctx.labels[:, row0:row0 + rows]
    color = fusion.gather_cells(band, ctx.color).reshape(-1, 3)
    got = refine.rasterize_table(band, ctx.center, color, t(x["d"]), t(x["n"]), row0=row0)
    want = whole.reshape(V, H, W, 4)[:, row0:row0 + rows].reshape(-1, 4)
    assert torch.equal(got.nan_to_num(nan=-1.0), want.nan_to_num(nan=-1.0))


@pytest.mark.parametrize("jax_form", ["rasterize_planes", "rasterize_planes_gather"])
def test_rasterize_planes_matches_jax(scene, jax_form):
    x = scene["x"]
    got = n(fusion.rasterize_planes(t(x["labels"], torch.int32), t(x["center"]), t(x["d"]), t(x["n"])))
    want = np.asarray(getattr(jfusion, jax_form)(x["labels"], x["center"], x["d"], x["n"]))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=PLANE_RTOL, atol=PLANE_ATOL, equal_nan=True)


@pytest.mark.parametrize("it", [0, 4])
def test_update_candidates_match_jax(scene, it):
    """The routed candidates against JAX's ``gather_update_moves``, move
    by move; JAX leaves the similarity unflushed, which only changes
    subnormals."""
    offs = _offs(scene["sched"], it)
    gamma = scene["kw"]["gamma"]
    d_c, n_c, sim, ok = (n(a) for a in refine.update_candidates(scene["ctx"], scene["state"], offs, gamma))
    jd, jnx, jny, jnz, jsim, jok = (np.moveaxis(np.asarray(a), -1, 0) for a in jref.gather_update_moves(
        scene["jctx"], scene["jstate"], offs, gamma))
    assert d_c.shape == (len(offs), V, MH, MW) and n_c.shape == d_c.shape + (3,)
    np.testing.assert_array_equal(n_c, np.stack([jnx, jny, jnz], -1))
    np.testing.assert_array_equal(ok, np.broadcast_to(jok, ok.shape))
    assert np.array_equal(np.isnan(d_c), np.isnan(jd))
    np.testing.assert_allclose(d_c, jd, rtol=PLANE_RTOL, atol=PLANE_ATOL, equal_nan=True)
    np.testing.assert_allclose(sim, jsim, rtol=TAP_RTOL, atol=TAP_ATOL)


@pytest.mark.parametrize("rows", [(0, 2), (2, 3), (5, 1), (3, 0)])
def test_update_candidates_band_is_the_whole_maps_rows(scene, rows):
    """A band of cell rows (``spatial.block_sweep``'s) is the whole map's
    candidates' rows: its neighbours, wrapped ones too, read the whole map."""
    offs = _offs(scene["sched"], 0)
    gamma = scene["kw"]["gamma"]
    whole = refine.update_candidates(scene["ctx"], scene["state"], offs, gamma)
    band = refine.update_candidates(scene["ctx"], scene["state"], offs, gamma, rows=rows)
    for a, b in zip(band, whole):
        want = b[:, :, rows[0]:rows[0] + rows[1]]
        assert a.shape == want.shape and torch.equal(a.nan_to_num(nan=-1.0), want.nan_to_num(nan=-1.0))


@pytest.mark.parametrize("it", [0, 4], ids=["greedy", "product"])
def test_move_chain_matches_jax(scene, it):
    """A whole sweep, whose chain the routed ``move_chain`` walks, against
    JAX's ``_propagate_iteration`` from the same state: ``it = 0`` with the
    greedy rules, ``it = 4`` with the product rule only."""
    reach = _reach(scene["sched"], it)
    got = refine.propagate_iteration(scene["ctx"], scene["clean"], it, **scene["kw"], **reach)
    want = jref._propagate_iteration(scene["jctx"], scene["jclean"], it, **scene["kw"], **reach)
    size = V * MH * MW
    for field in ("d", "sm", "cs", "n"):
        close = np.isclose(n(getattr(got, field)), np.asarray(getattr(want, field)), rtol=SWEEP_TOL,
                           atol=SWEEP_TOL)
        if field == "n":
            close = close.all(-1)
        misses = int((~close).sum())
        print(f"it={it} {field}: {misses} of {size} cells differ")
        assert close.mean() >= SWEEP_AGREE and misses <= max(2, size // 100), (it, field, misses)
    # the routed chain is its plain form's, bit for bit
    ctx, state, kw = scene["ctx"], scene["clean"], scene["kw"]
    cache = refine.build_cache(ctx, state.d, state.n, gamma=kw["gamma"], **reach)
    moves = refine.update_candidates(ctx, state, _offs(scene["sched"], it), kw["gamma"])

    def score(d_c, n_c):
        return refine.score_moves(ctx, cache, d_c, n_c, **kw)

    plain = refine.move_chain_reference(cache, state, moves, it, score)
    routed = refine.move_chain(cache, state, moves, it, score)
    for f in refine.RefineState._fields:
        assert torch.equal(getattr(routed, f), getattr(plain, f)), f
        assert torch.equal(getattr(routed, f), getattr(got, f)), f


@pytest.fixture
def no_build(monkeypatch):
    """kernels.build.load raises: a CPU tensor may never reach it."""
    def refuse(name):
        raise AssertionError(f"the CPU path tried to build {name}")

    monkeypatch.setattr(build, "load", refuse)
    return dict(raster.LAUNCHES), dict(chain.LAUNCHES)


def test_cpu_never_builds_or_launches(scene, no_build):
    """The init, a greedy and a product sweep and fusion on CPU tensors, the
    row-sharded path's band too: no build, every counter still 0."""
    ctx, state, kw, sched = scene["ctx"], scene["state"], scene["kw"], scene["sched"]
    s0 = refine.init_state(ctx, **kw, steps=sched.kernel_steps, step_size=sched.sp_kernel_step)
    for it in (0, 4):
        s0 = refine.propagate_iteration(ctx, s0, it, **kw, **_reach(sched, it))
    fusion.fuse_views(ctx.labels, ctx.center, s0.d, s0.n)
    refine.update_candidates(ctx, state, _offs(sched, 0), kw["gamma"], rows=(1, 2))
    assert (dict(raster.LAUNCHES), dict(chain.LAUNCHES)) == no_build
    assert set(no_build[0].values()) | set(no_build[1].values()) <= {0}


def test_route_is_a_function_of_the_device_type(scene):
    """CPU: the plain forms; CUDA (any index): the kernels; any other
    device raises in each wrapper before a kernel or a plain form runs."""
    for mod, word in ((raster, "raster"), (chain, "chain")):
        assert mod.route("cpu") == mod.route(CPU) == "plain"
        assert mod.route("cuda") == mod.route(torch.device("cuda", 3)) == "kernel"
        for dev in ("meta", torch.device("mps")):
            with pytest.raises(ValueError, match=f"no {word} kernel"):
                mod.route(dev)
    meta = lambda a: a.to("meta") if isinstance(a, torch.Tensor) else a  # noqa: E731
    ctx = refine.RefineContext(*(meta(a) for a in scene["ctx"]))
    state = refine.RefineState(*(meta(a) for a in scene["state"]))
    cache = refine.build_cache(scene["ctx"], scene["state"].d, scene["state"].n, gamma=scene["kw"]["gamma"],
                               **_reach(scene["sched"], 0))
    mcache = refine.IterCache(*(meta(a) for a in cache))
    moves = tuple(meta(a) for a in refine.update_candidates(scene["ctx"], scene["state"], _offs(scene["sched"], 0),
                                                            scene["kw"]["gamma"]))
    m = moves[0].shape[0]
    scores = torch.zeros((m, V, MH, MW), device="meta")
    refits = torch.zeros((8, V, MH, MW), device="meta")
    calls = {
        "raster.table": lambda: raster.table(ctx.labels, ctx.center, ctx.ras_color, state.d, state.n),
        "refine.rasterize_table": lambda: refine.rasterize_table(ctx.labels, ctx.center, ctx.ras_color, state.d,
                                                                 state.n),
        "raster.planes": lambda: raster.planes(ctx.labels, ctx.center, state.d, state.n),
        "fusion.rasterize_planes": lambda: fusion.rasterize_planes(ctx.labels, ctx.center, state.d, state.n),
        "chain.candidates": lambda: chain.candidates(ctx, state, _offs(scene["sched"], 0), 0.1),
        "refine.update_candidates": lambda: refine.update_candidates(ctx, state, [(1, 0)], 0.1, rows=(0, 2)),
        "chain.update": lambda: chain.update(mcache, state, moves, scores, scores, True),
        "chain.refit": lambda: chain.refit(state, torch.zeros((8, V, MH, MW, 3), device="meta"),
                                           refits.bool(), refits, refits, False),
        "refine.move_chain": lambda: refine.move_chain(mcache, state, moves, 0, lambda d_c, n_c: (scores, scores)),
    }
    for call in calls.values():
        with pytest.raises(ValueError, match="no (raster|chain) kernel"):
            call()


def _c_entries(source: str, prefix: str) -> dict[str, list[str]]:
    """Each ``extern "C"`` ``<prefix>*_launch`` of ``csrc/<source>.cu``: its
    parameters' kinds in order, "ptr", "int", "float" or "stream"."""
    src = (Path(chain.__file__).parent.parent / "csrc" / f"{source}.cu").read_text()
    out = {}
    for name, params in re.findall(rf'extern "C" int ({prefix}\w+)_launch\(([^)]*)\)', src):
        kinds = []
        for param in " ".join(params.split()).split(","):
            param = param.strip()
            if param == "void* stream":
                kinds.append("stream")
            elif "*" in param:
                kinds.append("ptr")
            elif param.startswith("int "):
                kinds.append("int")
            elif param.startswith("float "):
                kinds.append("float")
            else:
                raise AssertionError(f"{name}: parameter {param!r} of no known kind")
        out[name] = kinds
    return out


def test_c_entries_are_the_bound_ones():
    """Every C entry is bound and counted, and nothing else is."""
    assert set(_c_entries("chain", "chain_")) == set(chain._ENTRIES) == set(chain.LAUNCHES)
    assert set(_c_entries("raster", "raster_")) == set(raster._ENTRIES) == set(raster.LAUNCHES)


@pytest.mark.parametrize("name", [*chain._ENTRIES, *raster._ENTRIES])
def test_ctypes_signature_matches_the_c_entry(name):
    """Each module's ``_ENTRIES`` gives ctypes its entry's pointers, ints
    and floats, then the stream: the C signature must read the same."""
    mod, source = (chain, "chain") if name in chain._ENTRIES else (raster, "raster")
    ptrs, ints, floats = mod._ENTRIES[name]
    assert _c_entries(source, f"{source}_")[name] == ["ptr"] * ptrs + ["int"] * ints + ["float"] * floats + ["stream"]


@pytest.mark.parametrize("case", ["table", "table_band", "planes", "planes_band", "planes_empty"])
def test_raster_wrapper_passes_the_c_entrys_arguments(scene, monkeypatch, case):
    """What the card's wrapper hands ``raster_planes_launch``, the launch
    itself replaced (CPU tensors): the colour pointer for the table and
    NULL for fusion's map, the band's rows and ``row0``, and no launch for
    an empty output."""
    calls = []
    monkeypatch.setattr(raster, "_launch", lambda name, dev, *a: calls.append((name, a)))
    x, ctx = scene["x"], scene["ctx"]
    d, nrm = t(x["d"]), t(x["n"])
    band = case.endswith("_band")
    labels = ctx.labels[:, 8:24] if band else ctx.labels
    if case == "planes_empty":
        labels = ctx.labels[:, :0]
    rows, row0 = labels.shape[1], 8 if band else 0
    if case.startswith("table"):
        color = fusion.gather_cells(labels, ctx.color).reshape(-1, 3)
        out = raster._raster(labels, ctx.center, d, nrm, color, row0)
        assert out.shape == (V * rows * W, 4)
    else:
        out = raster._raster(labels, ctx.center, d, nrm, None, row0)
        assert out.shape == (V, rows, W)
    if case == "planes_empty":
        assert calls == []
        return
    (name, args), = calls
    assert name == "raster_planes" and len(args) == sum(raster._ENTRIES[name])
    assert args[-5:] == (V, MH * MW, rows, W, row0) and args[5] == out.data_ptr()
    assert (args[4] is None) == case.startswith("planes")


@pytest.mark.parametrize("case", ["whole", "band", "no_moves"])
def test_chain_wrappers_pass_the_c_entries_arguments(scene, monkeypatch, case):
    """What the card's chain wrappers hand their C entries, the launches
    replaced (CPU tensors): the move table (M x (dx, dy) int32), the band's
    first row and rows, each phase's move and cell counts, greedy as 0 or
    1, and no candidate launch where there are no moves."""
    calls = []
    monkeypatch.setattr(chain, "_launch", lambda name, dev, *a: calls.append((name, a)))
    ctx, state, kw, sched = scene["ctx"], scene["state"], scene["kw"], scene["sched"]
    offs = [] if case == "no_moves" else _offs(sched, 0)
    rows = (2, 3) if case == "band" else None
    d_c, n_c, sim, ok = chain._launch_candidates(ctx, state, offs, kw["gamma"], rows)
    n_rows = MH if rows is None else rows[1]
    m = len(offs)
    assert d_c.shape == (m, V, n_rows, MW) and n_c.shape == (m, V, n_rows, MW, 3) and ok.dtype == torch.bool
    if case == "no_moves":
        assert calls == []
    else:
        (name, args), = calls
        assert name == "chain_moves" and len(args) == sum(chain._ENTRIES[name])
        assert args[9:] == (m, V, MH, MW, 0 if rows is None else rows[0], n_rows, kw["gamma"])
        table = (ctypes.c_int32 * (2 * m)).from_address(args[4])
        assert [list(table[2 * k:2 * k + 2]) for k in range(m)] == [list(o) for o in offs]
    calls.clear()
    band = refine.RefineState(*(a[:, :n_rows] for a in state))
    cache = refine.build_cache(ctx, state.d, state.n, gamma=kw["gamma"], **_reach(sched, 0))
    cache = cache._replace(**{f: getattr(cache, f)[:, :n_rows] for f in ("ring_dcx", "ring_dcy", "ring_d",
                                                                          "ring_ok")})
    scores = torch.rand((m, V, n_rows, MW))
    after, n_ref, ok_ref = chain._launch_update(cache, band, (d_c, n_c, sim, ok), scores, scores, True)
    assert n_ref.shape == (8, V, n_rows, MW, 3) and ok_ref.shape == (8, V, n_rows, MW)
    refits = torch.rand((8, V, n_rows, MW))
    final = chain._launch_refit(after, n_ref, ok_ref, refits, refits, False)
    assert final.d is after.d
    (u_name, u_args), (r_name, r_args) = calls
    assert u_name == "chain_update" and len(u_args) == sum(chain._ENTRIES[u_name])
    assert u_args[-3:] == (m, V * n_rows * MW, 1)
    assert r_name == "chain_refit" and len(r_args) == sum(chain._ENTRIES[r_name])
    assert r_args[-2:] == (V * n_rows * MW, 0)


def test_default_schedule_update_move_counts():
    """The update moves a sweep of the default schedule walks on the main
    path's 135 x 240 cell map (1080x1920 at S = 8): the M that
    ``csrc/chain.cu``'s ``chain_update`` stages and walks, at most 16 (one
    chunk) a sweep."""
    from cl_multiview_stereo_tpu_torch.config import SystemSettings

    s = SystemSettings()
    geom = DerivedGeometry.create(1920, 1080, s)
    assert (geom.map_h, geom.map_w) == (135, 240)
    sched = RefinementSchedule.create(s)
    counts = [len(refine._update_move_offsets(steps, size, geom.map_w, geom.map_h))
              for steps, size in zip(sched.steps_per_iter, sched.step_size_per_iter)]
    assert counts == [8, 10, 14, 14, 16]


def test_chain_work_hand_count(scene):
    """``tools.roofline``'s counts for the four kernels, by hand: each input
    read once (the walks' scores only for valid moves, a cell's plane
    once) and each output written once, the operations a pixel, a (move,
    cell), an accept test and a refit normal."""
    from cl_multiview_stereo_tpu_torch.tools import roofline

    ctx, state, sched, kw = scene["ctx"], scene["clean"], scene["sched"], scene["kw"]
    pixels, cells = V * H * W, V * MH * MW
    table = refine.rasterize_table(ctx.labels, ctx.center, ctx.ras_color, state.d, state.n)
    assert roofline.raster_work(ctx.labels, ctx.center, state.d, state.n, ctx.ras_color, table) == (
        (4 + 12 + 16) * pixels + 4 * (2 + 1 + 3) * cells, 8 * pixels)
    disp = fusion.rasterize_planes(ctx.labels, ctx.center, state.d, state.n)
    assert roofline.raster_work(ctx.labels, ctx.center, state.d, state.n, None, disp) == (
        (4 + 4) * pixels + 4 * (2 + 1 + 3) * cells, 8 * pixels)
    offs = _offs(sched, 0)
    m = len(offs)
    moves = refine.update_candidates(ctx, state, offs, kw["gamma"])
    assert roofline.chain_moves_work(ctx, state, offs, moves) == (
        4 * (2 + 3 + 1 + 3) * cells + 8 * m + (4 + 12 + 4 + 1) * m * cells, 19 * m * cells)
    scores = torch.rand((m, V, MH, MW))
    cache = refine.build_cache(ctx, state.d, state.n, gamma=kw["gamma"], **_reach(sched, 0))
    out = refine.update_phase_reference(cache, state, moves, scores, scores, True)
    valid = int(moves[3].sum())
    assert 0 < valid < m * cells
    state_bytes = 4 * (1 + 1 + 1 + 3) * cells
    for greedy in (True, False):
        assert roofline.chain_update_work(cache, state, moves, scores, scores, greedy, out) == (
            m * cells + (12 if greedy else 8) * valid + state_bytes + 8 * (4 * 3 + 1) * cells + state_bytes
            + 8 * (12 + 1) * cells, (5 if greedy else 3) * valid + 20 * 8 * cells)
    refits = torch.rand((8, V, MH, MW))
    after = refine.refit_phase_reference(out[0], out[1], out[2], refits, refits, False)
    valid = int(out[2].sum())
    assert 0 < valid < 8 * cells
    assert roofline.chain_refit_work(out[0], out[1], out[2], refits, refits, False, after) == (
        8 * cells + 8 * valid + 2 * 4 * (1 + 1 + 3) * cells, 3 * valid)


def test_turns_runs_each_tool_in_each_tree(tmp_path):
    """``tools.turns`` without a parent: each tool once in this tree, its
    last line kept as the run's record."""
    from cl_multiview_stereo_tpu_torch.tools import turns

    tool = "roofline --device cpu --shapes row --views 2 --height 24 --width 40 --d 4 --kernel chain_refit"
    res = turns.main(["--tool", tool, "--out", str(tmp_path / "t.json")])
    assert res["order"] == ["this"] and res["card"] == "cpu" and len(res["runs"]) == 1
    run = res["runs"][0]
    assert run["tree"] == "this" and run["tool"] == tool and run["record"]["kernel"] == "chain_refit"
    assert run["record"]["ms"] == "not measured"
    assert json.loads((tmp_path / "t.json").read_text()) == res


def test_turns_same_tools_runs_this_trees_tool_source(tmp_path):
    """``--same-tools`` runs this tree's tool file (not ``-m``) on the
    tree's package; without ``--parent`` the tree is this one."""
    from cl_multiview_stereo_tpu_torch.tools import turns

    tool = "roofline --device cpu --shapes row --views 2 --height 24 --width 40 --d 4 --kernel fuse_warp"
    res = turns.main(["--same-tools", "--tool", tool])
    assert res["same_tools"] is True and res["order"] == ["this"]
    assert res["runs"][0]["record"]["kernel"] == "fuse_warp" and res["runs"][0]["record"]["bound_ms"] > 0
