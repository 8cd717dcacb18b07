"""Smoothness on the CPU: the plain forms that ``ops/smoothness`` routes the
CPU to (``refine.build_cell_cache`` and ``refine.smoothness_from_cache``,
their taps added one at a time in tap order) against JAX's functions of the
same names on the same numpy-seeded inputs, with NaN normals and cells
whose every tap is invalid; and the routing itself: the CPU never builds a
kernel, another device raises, and the ctypes bindings read the C entries
of ``csrc/smoothness.cu``.  The kernels against these forms are in
test_torch_kernels_cuda.py.

The inputs are cell maps, not SLIC's output: 4 views of 12x16 cells (a
96x128 image at S = 8), and 2 views of one cell, where no tap lies on the
map.  Bounds, port against JAX:

- the gathered fields (``tap_ax``, ``tap_ay``, ``tap_d``, the ring) bitwise:
  the same reads and one subtraction;
- ``tap_sim`` and ``wn`` within TAP_RTOL: XLA's and torch's exp differ by
  an ulp or two, and XLA sums the taps for ``wn`` in its own order;
- ``sm`` within test_torch_refine.py's bound (rtol 2e-4, atol 2e-5), NaN at
  the same places.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.ops import refine as jref
from cl_multiview_stereo_tpu_torch.kernels import build
from cl_multiview_stereo_tpu_torch.ops import refine, smoothness
from torch_parity import CPU, n, t

TAP_RTOL, TAP_ATOL = 1e-5, 1e-7
SM_RTOL, SM_ATOL = 2e-4, 2e-5
GAMMA, ALPHA = 0.125, 0.013888888888888888
# (views, cell rows, cell columns)
MAPS = {"4x12x16": (4, 12, 16), "2x1x1": (2, 1, 1)}
# (steps, step_size): the immediate taps alone, two reach steps, and the
# main path's 13 (T = 60), most of whose long taps leave a 12x16 map
REACH = {"steps0": (0, 2.0), "steps2": (2, 2.0), "steps13": (13, 1.5)}


def _inputs(shape, seed=11):
    """Centres near each cell's middle, Lab colours near one grey (so that
    neighbours are similar), one cell of each view far from every colour
    (all its weights flush to 0), disparities and flatness in (0, 1]."""
    v, mh, mw = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(mh), np.arange(mw), indexing="ij")
    center = np.stack([xx * 8 + 3.5, yy * 8 + 3.5], -1)[None] + rng.uniform(-2, 2, (v, mh, mw, 2))
    color = np.array([50.0, 0.0, 0.0]) + rng.normal(0, [3.0, 1.5, 1.5], (v, mh, mw, 3))
    if mh * mw > 1:
        color[:, mh // 2, mw // 2] = (400.0, 90.0, -90.0)
    tgt_d = rng.uniform(5.0, 9.0, (v, mh, mw))
    fl = np.stack([rng.uniform(0.05, 1.0, (v, mh, mw)), rng.uniform(0.0, 1.0, (v, mh, mw))], -1)
    return tuple(a.astype(np.float32) for a in (center, color, tgt_d, fl))


def _contexts(center, color, fl):
    """The port's and JAX's contexts, holding only what the cache reads."""
    port = refine.RefineContext(center=t(center), color=t(color), disp0=None, labels=None, samples=None,
                                fl=t(fl), ras_color=None)
    jax_ctx = jref.RefineContext(**{f: None for f in jref.RefineContext._fields}
                                 | dict(center=jnp.asarray(center), color=jnp.asarray(color), fl=jnp.asarray(fl)))
    return port, jax_ctx


@pytest.fixture(scope="module", params=list(MAPS))
def cell_map(request):
    center, color, tgt_d, fl = _inputs(MAPS[request.param])
    ctx, jctx = _contexts(center, color, fl)
    return dict(name=request.param, ctx=ctx, jctx=jctx, tgt_d=tgt_d)


def _caches(cm, steps, step_size):
    kw = dict(gamma=GAMMA, steps=steps, step_size=step_size)
    return (smoothness.cell_cache(cm["ctx"], t(cm["tgt_d"]), **kw),
            jref.build_cell_cache(cm["jctx"], jnp.asarray(cm["tgt_d"]), **kw))


@pytest.mark.parametrize("reach", list(REACH))
def test_cell_cache_matches_jax(cell_map, reach):
    got, want = _caches(cell_map, *REACH[reach])
    for f in ("tap_ax", "tap_ay", "tap_d", "ring_dcx", "ring_dcy", "ring_d", "ring_ok"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    for f in ("tap_sim", "wn"):
        np.testing.assert_allclose(n(getattr(got, f)), np.asarray(getattr(want, f)), rtol=TAP_RTOL, atol=TAP_ATOL,
                                   err_msg=f)
    wn = n(got.wn)
    if cell_map["name"] == "2x1x1":  # no tap on the map
        assert not n(got.ring_ok).any() and (n(got.tap_sim) == 0).all() and (wn == 0).all()
    else:  # the far colour's cell: every weight flushed to 0
        assert (wn[:, 6, 8] == 0).all() and (wn > 0).sum() == wn.size - wn.shape[0]


def _moves(cm, m, seed=3):
    """m seeded candidate planes near the input state; the first move's
    cells hold the degenerate normals: (1, 0, 0) (nz = 0: d_intrp inf, or
    NaN at a tap clamped onto the cell itself), (0, 0, 0) (0 / 0) and NaN
    (a refit through coincident neighbours)."""
    d = cm["tgt_d"]
    rng = np.random.default_rng(seed)
    d_c = d[None] + rng.normal(0, 0.5, (m,) + d.shape)
    n_c = rng.normal(0, 0.2, (m,) + d.shape + (3,))
    n_c[..., 2] += 1.0
    n_c /= np.linalg.norm(n_c, axis=-1, keepdims=True)
    flat = n_c[0].reshape(-1, 3)
    flat[0::5] = (1.0, 0.0, 0.0)
    flat[1::5] = 0.0
    flat[2::5] = np.nan
    return d_c.astype(np.float32), n_c.astype(np.float32)


@pytest.mark.parametrize("m", [1, 8, 13])
@pytest.mark.parametrize("reach", list(REACH))
def test_smoothness_moves_match_jax(cell_map, reach, m):
    """The routed plain form (``score_chunk`` batches) against JAX's
    ``smoothness_from_cache`` on the same cache inputs, move by move."""
    cache, jcache = _caches(cell_map, *REACH[reach])
    d_c, n_c = _moves(cell_map, m)
    got = n(smoothness.smoothness_moves(cache, t(d_c), t(n_c), alpha=ALPHA))
    want = np.stack([np.asarray(jref.smoothness_from_cache(jcache, jnp.asarray(d_c[k]), jnp.asarray(n_c[k]),
                                                           alpha=ALPHA)) for k in range(m)])
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=SM_RTOL, atol=SM_ATOL, equal_nan=True)
    first = got[0].reshape(-1)
    wn = n(cache.wn).reshape(-1)
    if cell_map["name"] == "2x1x1":  # no valid tap: the empty sum's 1e-6, whatever the normal
        assert (got == np.float32(1e-6)).all()
    else:
        assert np.isnan(first[1::5][wn[1::5] > 0]).all() and np.isnan(first[2::5][wn[2::5] > 0]).all()
        assert (first[wn == 0] == np.float32(1e-6)).all()
    # one launch form or the other: each move's row is the move scored alone
    for k in range(m):
        alone = n(refine.smoothness_from_cache(cache, t(d_c[k]), t(n_c[k]), alpha=ALPHA))
        np.testing.assert_array_equal(got[k], alone)


def test_tap_sums_run_in_tap_order():
    """``_sum_taps`` is the float32 sum of the taps one at a time from the
    first, on data whose sum depends on the order."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((5, 7, 60)) * 10.0 ** rng.integers(-6, 7, (5, 7, 60))).astype(np.float32)
    want = a[..., 0].copy()
    for k in range(1, a.shape[-1]):
        want = (want + a[..., k]).astype(np.float32)
    np.testing.assert_array_equal(n(refine._sum_taps(t(a))), want)
    backwards = a[..., -1].copy()
    for k in range(a.shape[-1] - 2, -1, -1):
        backwards = (backwards + a[..., k]).astype(np.float32)
    assert not np.array_equal(want, backwards)


def test_tap_gammas_are_the_plain_forms_doubles():
    """The kernel's table: each tap's weight a Python double rounded once to
    float32, not float32 gamma times (1 + i)."""
    g = refine.tap_gammas(0.1, 13)
    assert len(g) == 60 and g[:8] == [0.1] * 8 and g[8:12] == [0.2] * 4 and g[-1] == 0.1 * 14
    table = np.float32(g)
    f32_product = np.float32(0.1) * np.float32(1 + np.arange(1, 14)).repeat(4)
    assert not np.array_equal(table[8:], f32_product)


def test_rows_band_is_the_whole_caches_rows():
    """A band's fields of the scored cells are the whole cache's rows; its
    table and tap weights are the whole map's, and ``row0`` its first row."""
    center, color, tgt_d, fl = _inputs(MAPS["4x12x16"])
    ctx, _ = _contexts(center, color, fl)
    kw = dict(gamma=GAMMA, steps=2, step_size=2.0)
    whole = smoothness.cell_cache(ctx, t(tgt_d), **kw)
    band = smoothness.cell_cache(ctx, t(tgt_d), **kw, rows=(4, 5))
    for f in smoothness._BAND_FIELDS:
        assert torch.equal(getattr(band, f), getattr(whole, f)[:, 4:9]), f
    assert torch.equal(band.cell_table, whole.cell_table) and torch.equal(band.gammas, whole.gammas)
    assert whole.row0 == 0 and band.row0 == 4
    for rows in ((-1, 2), (10, 3)):
        with pytest.raises(ValueError, match="band"):
            smoothness.cell_cache(ctx, t(tgt_d), **kw, rows=rows)


@pytest.fixture
def no_build(monkeypatch):
    """kernels.build.load raises: a CPU tensor may never reach it."""
    def refuse(name):
        raise AssertionError(f"the CPU path tried to build {name}")

    monkeypatch.setattr(build, "load", refuse)
    return dict(smoothness.LAUNCHES)


def test_cpu_never_builds(no_build):
    center, color, tgt_d, fl = _inputs(MAPS["4x12x16"])
    ctx, _ = _contexts(center, color, fl)
    cache = smoothness.cell_cache(ctx, t(tgt_d), gamma=GAMMA, steps=13, step_size=1.5)
    smoothness.cell_cache(ctx, t(tgt_d), gamma=GAMMA, steps=13, step_size=1.5, rows=(0, 6))
    d_c, n_c = _moves(dict(tgt_d=tgt_d), 8)
    smoothness.smoothness_moves(cache, t(d_c), t(n_c), alpha=ALPHA)
    # the refit phase's broadcast input state
    d0 = t(tgt_d)[None].expand(8, *tgt_d.shape)
    smoothness.smoothness_moves(cache, d0, t(n_c), alpha=ALPHA)
    assert smoothness.LAUNCHES == no_build


def test_route_is_a_function_of_the_device_type():
    """CPU: the plain forms; CUDA (any index): the kernels; any other
    device raises before a kernel or a plain form runs."""
    assert smoothness.route("cpu") == smoothness.route(CPU) == "plain"
    assert smoothness.route("cuda") == smoothness.route(torch.device("cuda", 3)) == "kernel"
    for dev in ("meta", torch.device("mps")):
        with pytest.raises(ValueError, match="no smoothness kernel"):
            smoothness.route(dev)
    center, color, tgt_d, fl = _inputs(MAPS["4x12x16"])
    ctx, _ = _contexts(center, color, fl)
    cache = smoothness.cell_cache(ctx, t(tgt_d), gamma=GAMMA, steps=2, step_size=2.0)
    meta = lambda x: x.to("meta") if isinstance(x, torch.Tensor) else x  # noqa: E731
    with pytest.raises(ValueError, match="no smoothness kernel"):
        smoothness.cell_cache(refine.RefineContext(*(meta(x) for x in ctx)), meta(t(tgt_d)), gamma=GAMMA,
                              steps=2, step_size=2.0)
    d_c, n_c = _moves(dict(tgt_d=tgt_d), 2)
    with pytest.raises(ValueError, match="no smoothness kernel"):
        smoothness.smoothness_moves(refine.IterCache(*(meta(x) for x in cache)), meta(t(d_c)), meta(t(n_c)),
                                    alpha=ALPHA)


def _c_entries() -> dict[str, list[str]]:
    """Each ``extern "C"`` ``smooth_*_launch`` of ``csrc/smoothness.cu``: its
    parameters' kinds in order, "ptr", "int", "float" or "stream"."""
    src = (Path(smoothness.__file__).parent.parent / "csrc" / "smoothness.cu").read_text()
    out = {}
    for name, params in re.findall(r'extern "C" int (smooth_\w+)_launch\(([^)]*)\)', src):
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
    """Every C entry is bound; each kernel of the path is counted, the
    divide check is not."""
    assert set(_c_entries()) == set(smoothness._ENTRIES) == set(smoothness.LAUNCHES) | {"smooth_divide"}


@pytest.mark.parametrize("name", list(smoothness._ENTRIES))
def test_ctypes_signature_matches_the_c_entry(name):
    """``ops/smoothness._ENTRIES`` gives ctypes each entry's pointers, ints
    and floats, then the stream: the C signature must read the same."""
    ptrs, ints, floats = smoothness._ENTRIES[name]
    assert _c_entries()[name] == ["ptr"] * ptrs + ["int"] * ints + ["float"] * floats + ["stream"]


@pytest.mark.parametrize("case", ["dense", "broadcast_d", "no_moves", "empty_band", "band"])
def test_kernel_wrappers_pass_the_c_entries_arguments(monkeypatch, case):
    """What the card's wrappers hand the C entries, with the launch itself
    replaced (CPU tensors): a dense ``d_c`` with move stride N; the refit's
    broadcast d row with move stride 0 and its own storage, not a copy; no
    launch, and no count, where the output is empty; an empty band still
    writes the table, and a band's moves go with its first row and the
    whole map's table; the card's cache holds nothing T-wide."""
    calls = []
    monkeypatch.setattr(smoothness, "_launch", lambda name, dev, *a, **k: calls.append((name, a)))
    center, color, tgt_d, fl = _inputs(MAPS["4x12x16"])
    ctx, _ = _contexts(center, color, fl)
    v, mh, mw = tgt_d.shape
    if case == "empty_band":
        cache = smoothness._launch_cache(ctx, t(tgt_d), GAMMA, 2, 2.0, (5, 0))
        (name, args), = calls
        assert name == "smooth_cache" and len(args) == sum(smoothness._ENTRIES[name])
        assert args[4] == cache.cell_table.data_ptr() and args[-6:] == (v, mh, mw, 5, 0, 2.0)
        assert cache.ring_d.shape == (v, 0, mw, 8) and cache.cell_table.shape == (v, mh, mw, 8)
        assert all(getattr(cache, f) is None for f in ("tap_ax", "tap_ay", "tap_d", "tap_sim", "wn"))
        assert cache.gammas.shape == (16,) and cache.row0 == 5
        return
    rows = (3, 6) if case == "band" else None
    cache = smoothness.cell_cache(ctx, t(tgt_d), gamma=GAMMA, steps=2, step_size=2.0, rows=rows)
    n_rows = mh if rows is None else rows[1]
    m = {"dense": 3, "broadcast_d": 8, "no_moves": 0, "band": 2}[case]
    d_c, n_c = (t(np.ascontiguousarray(a[:, :, :n_rows])) for a in _moves(dict(tgt_d=tgt_d), max(m, 1)))
    if case == "broadcast_d":
        d_c = t(tgt_d)[None].expand(m, v, mh, mw)
    out = smoothness._launch_moves(cache, d_c[:m], n_c[:m], ALPHA)
    assert out.shape == (m, v, n_rows, mw)
    if case == "no_moves":
        assert calls == []
        return
    (name, args), = calls
    assert name == "smooth_moves" and len(args) == sum(smoothness._ENTRIES[name])
    stride = 0 if case == "broadcast_d" else v * n_rows * mw
    assert args[5:13] == (m, v, mh, mw, 0 if rows is None else rows[0], n_rows, 16, stride)
    assert args[0] == cache.cell_table.data_ptr() and args[1] == cache.gammas.data_ptr()
    assert args[2] == d_c.data_ptr()


def _taps_from_table(cache, steps):
    """The four tap fields as ``smooth_moves`` derives them from the table,
    in numpy, by the kernel's rules: the long taps' pitch at most Mw + Mh,
    each tap's unclamped position on the map or not, immediate taps
    wrapped and long ones clamped, then (cx - tap cx, cy - tap cy, tap d,
    sim); the similarity's exp by torch, as the plain form takes it."""
    table = n(cache.cell_table)
    v, mh, mw, _ = table.shape
    vv, yy, xx = np.meshgrid(np.arange(v), np.arange(mh), np.arange(mw), indexing="ij")
    pitch = np.minimum(table[..., 6].astype(np.int64), mw + mh)
    moves = [(dx, dy, True) for dx, dy in refine._IMM]
    for i in range(1, steps + 1):
        off = i * pitch + 1
        moves += [(-off, 0, False), (off, 0, False), (0, -off, False), (0, off, False)]
    src, on = [], []
    for dx, dy, imm in moves:
        lx, ly = xx + dx, yy + dy
        on.append((lx >= 0) & (lx < mw) & (ly >= 0) & (ly < mh))
        tx, ty = (lx % mw, ly % mh) if imm else (np.clip(lx, 0, mw - 1), np.clip(ly, 0, mh - 1))
        src.append((vv, ty, tx))
    s = np.stack([table[sv, sy, sx] for sv, sy, sx in src], axis=-2)  # (V, Mh, Mw, T, 8)
    on = np.stack(on, axis=-1)
    cdiff = refine._sqdist3(t(table[..., None, 2:5]), t(s[..., 2:5]))
    sim = torch.where(torch.as_tensor(on), refine._ftz(torch.exp(-cdiff * cache.gammas)), 0.0)
    return table[..., None, 0] - s[..., 0], table[..., None, 1] - s[..., 1], s[..., 5], n(sim), on


# the main path's reach at sweep 0 (pitches up to 328 cells, most past a
# 12x16 map) beside REACH's
TABLE_REACH = REACH | {"steps2-far": (2, 328.0)}


@pytest.mark.parametrize("reach", list(TABLE_REACH))
def test_plain_table_holds_the_tap_inputs(cell_map, reach):
    """The plain cache's table is its own inputs, one 32-byte row a cell
    (centre, colour, disparity, the long taps' pitch, 0), and every tap
    field the plain form stores follows bitwise from it by the kernel's
    rules; its ``gammas`` are the tap weights rounded once, ``row0`` 0."""
    steps, step_size = TABLE_REACH[reach]
    cm = cell_map
    cache = smoothness.cell_cache(cm["ctx"], t(cm["tgt_d"]), gamma=GAMMA, steps=steps, step_size=step_size)
    table = n(cache.cell_table)
    assert table.shape == n(cm["ctx"].center).shape[:3] + (8,) and table.dtype == np.float32
    np.testing.assert_array_equal(table[..., 0:2], n(cm["ctx"].center))
    np.testing.assert_array_equal(table[..., 2:5], n(cm["ctx"].color))
    np.testing.assert_array_equal(table[..., 5], cm["tgt_d"])
    np.testing.assert_array_equal(table[..., 6], n(refine.tap_step(cm["ctx"].fl, step_size)).astype(np.float32))
    assert (table[..., 7] == 0).all() and (table[..., 6] >= 1).all()
    np.testing.assert_array_equal(n(cache.gammas), np.float32(refine.tap_gammas(GAMMA, steps)))
    assert cache.row0 == 0
    ax, ay, td, sim, on = _taps_from_table(cache, steps)
    for name, want in (("tap_ax", ax), ("tap_ay", ay), ("tap_d", td), ("tap_sim", sim)):
        np.testing.assert_array_equal(n(getattr(cache, name)), want, err_msg=name)
    np.testing.assert_array_equal(on, n(refine.tap_on_map(refine.tap_step(cm["ctx"].fl, step_size), steps)))
    if reach == "steps2-far" and cm["name"] == "4x12x16":
        assert (table[..., 6] > 28).any() and not on[..., 8:].all()
