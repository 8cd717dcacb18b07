"""The kernels' work counts of ``tools/roofline`` (the bound of each kernel
that ``chip_smoke.py`` and the roofline tool print) against counts made
by hand or by brute force, and the bound itself."""

import types

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu_torch.config import DerivedGeometry, SystemSettings, build_disp_levels
from cl_multiview_stereo_tpu_torch.tools import roofline
from torch_parity import CPU  # noqa: F401  (two torch threads a worker)


def _brute_valid_terms(centers, step, levels, h, w, s) -> tuple[int, int]:
    """One (view, cell, sample, delta, hypothesis) at a time, in float32 as
    the kernel computes: truncated sample positions in the image, and
    -1 < x - d*gx < W, -1 < y - (bl*d)*gy < H at the neighbour."""
    v, mh, mw = centers.shape[:3]
    f32 = np.float32
    bl = f32(s.bl_ratio)
    valid = pairs = 0
    deltas = [(gx, gy) for gx in range(-s.neib_hor, s.neib_hor + 1)
              for gy in range(-s.neib_ver, s.neib_ver + 1) if (gx, gy) != (0, 0)]
    for z in range(v):
        for gx, gy in deltas:
            if not (0 <= z % s.array_width + gx < s.array_width and 0 <= z // s.array_width + gy < v // s.array_width):
                continue
            pairs += 1
            for my in range(mh):
                for mx in range(mw):
                    cx, cy = centers[z, my, mx]
                    sx, sy = step[z, my, mx]
                    for i in range(-2, 3):
                        x = int(f32(cx) + f32(i) * f32(sx))  # C truncation toward zero
                        for j in range(-2, 3):
                            y = int(f32(cy) + f32(j) * f32(sy))
                            if not (0 <= x < w and 0 <= y < h):
                                continue
                            for d in levels:
                                px = f32(x) - f32(d) * f32(gx)
                                py = f32(y) - f32(f32(d) * bl) * f32(gy)
                                valid += bool(-1.0 < px < w and -1.0 < py < h)
    return valid, pairs


def test_cost_volume_terms_equal_brute_force():
    """9 views of 24x40, 3x5 cells, centres reaching past the image on
    every side (so truncation toward zero and both validity tests bite)."""
    s = SystemSettings(min_disp=0, max_disp=12)
    h, w, mh, mw = 24, 40, 3, 5
    rng = np.random.default_rng(5)
    centers = np.stack([rng.uniform(-4, w + 4, (9, mh, mw)), rng.uniform(-4, h + 4, (9, mh, mw))], -1).astype(np.float32)
    step = rng.uniform(0.5, 7.0, (9, mh, mw, 2)).astype(np.float32)
    levels = build_disp_levels(s)
    got = roofline.cost_volume_terms(torch.from_numpy(centers), torch.from_numpy(step),
                                     torch.from_numpy(levels), h, w, s)
    want = _brute_valid_terms(centers, step, levels, h, w, s)
    assert got == want
    assert 0 < want[0] < 25 * len(levels) * mh * mw * want[1]  # some terms valid, some not

    lab = torch.zeros((9, h, w, 3))
    out = torch.zeros((9, len(levels), mh, mw))
    n_bytes, ops = roofline.cost_volume_work(lab, torch.from_numpy(centers), torch.from_numpy(step),
                                             torch.from_numpy(levels), s, out)
    terms = 25 * len(levels) * mh * mw * want[1]
    assert ops == 9 * want[0] + (terms - want[0]) + len(levels) * mh * mw * want[1]
    assert n_bytes == 4 * (lab.numel() + 2 * centers.size + levels.size + out.numel())


@pytest.mark.parametrize("rows", [None, 3])
def test_sweep_work_hand_count(rows):
    """2 views, ladder 1, 2, 3, two horizontal pairs, radius 2: per output
    pixel and hypothesis 2 * (8 + 8 + 1) + 2 operations; the tables hold
    start 3 + view 2 + shifts 2 * 3 * 4 + ladder 3 + one chunk's bounds 2
    and boxes 2 * 4 = 42 int32.  A row window reads its 9-row band and
    writes 3 rows."""
    band = 5 if rows is None else 9
    lab = torch.zeros((2, band, 7, 3))
    n_bytes, ops = roofline.sweep_work(lab, [1.0, 2.0, 3.0], ((0, 1, 1, 0), (1, 0, -1, 0)), 1.0, 2, rows)
    out_rows = 5 if rows is None else rows
    assert ops == 36 * 3 * out_rows * 7
    assert n_bytes == 4 * 2 * band * 7 * 3 + 2 * 4 * 2 * out_rows * 7 + 4 * 42


def test_consistency_work_hand_count():
    """M = 3 moves, V = 2 views of 3x4 cells over 6x8 images, 3 pairs."""
    m, v, mh, mw, h, w = 3, 2, 3, 4, 6, 8
    ctx = types.SimpleNamespace(
        center=torch.zeros((v, mh, mw, 2)), color=torch.zeros((v, mh, mw, 3)),
        samples=torch.zeros((v, mh, 9, mw, 2), dtype=torch.int32), fl=torch.zeros((v, mh, mw, 2)),
    )
    cache = types.SimpleNamespace(ras=torch.zeros((v * h * w, 4)))
    d_c, n_c = torch.zeros((m, v, mh, mw)), torch.zeros((m, v, mh, mw, 3))
    pairs = ((0, 1, 1.0, 0.0), (1, 0, -1.0, 0.0), (1, 0, -2.0, 0.0))
    n_bytes, ops = roofline.consistency_work(ctx, cache, d_c, n_c, pairs)
    assert ops == m * mh * mw * 9 * (3 * 36 + v * 8)
    cells = v * mh * mw
    assert n_bytes == 4 * (cells * (2 + 3 + 18 + 2) + v * h * w * 4 + m * cells * (1 + 3 + 1)) + 4 * (v + 1 + 9)


def test_smooth_work_hand_count():
    """V = 2 views of 3x4 cells, a band of 2 rows cached with T = 16 taps,
    then M = 5 moves scored against it, dense and with one d row broadcast
    over the moves (the refit phase's): the function's work, whatever the
    cache stores (the plain cache's T-wide fields count nothing)."""
    from cl_multiview_stereo_tpu_torch.ops import refine, smoothness

    v, mh, mw, rows, t, m = 2, 3, 4, 2, 16, 5
    ctx = refine.RefineContext(center=torch.zeros((v, mh, mw, 2)), color=torch.zeros((v, mh, mw, 3)),
                               disp0=None, labels=None, samples=None, fl=torch.ones((v, mh, mw, 2)),
                               ras_color=None)
    tgt_d = torch.zeros((v, mh, mw))
    cache = smoothness.cell_cache(ctx, tgt_d, gamma=0.1, steps=(t - 8) // 4, step_size=1.0, rows=(1, rows))
    band, cells = v * rows * mw, v * mh * mw
    n_bytes, ops = roofline.smooth_cache_work(ctx, tgt_d, cache)
    # inputs: centre, colour, disparity, flatness's first channel of the
    # whole map; outputs: 3 float ring fields, the ring's bools
    assert n_bytes == 4 * cells * (2 + 3 + 1 + 1) + 4 * band * 3 * 8 + band * 8
    assert ops == 2 * band * 8
    d_c, n_c = torch.zeros((m, v, rows, mw)), torch.zeros((m, v, rows, mw, 3))
    n_bytes, ops = roofline.smooth_moves_work(cache, d_c, n_c)
    assert n_bytes == 4 * cells * (2 + 3 + 1 + 1) + 4 * m * band * (1 + 3 + 1)
    assert ops == 12 * m * band * t + 14 * band * t
    d0 = torch.zeros((v, rows, mw))
    assert roofline.smooth_moves_work(cache, d0[None].expand(m, v, rows, mw), n_c) == (
        4 * cells * (2 + 3 + 1 + 1) + 4 * band + 4 * m * band * (3 + 1), ops)


def test_smooth_turns_bounds_from_the_calls_shapes():
    """``tools.smooth_turns`` keeps each call's shapes and rates them with
    these counts on meta tensors: the same bounds as the counts on the
    calls' own tensors, for a cache, a dense phase and the refit's
    broadcast d row."""
    from cl_multiview_stereo_tpu_torch.ops import refine, smoothness
    from cl_multiview_stereo_tpu_torch.tools import smooth_turns

    v, mh, mw, steps, m = 2, 3, 4, 2, 5
    ctx = refine.RefineContext(center=torch.zeros((v, mh, mw, 2)), color=torch.zeros((v, mh, mw, 3)),
                               disp0=None, labels=None, samples=None, fl=torch.ones((v, mh, mw, 2)),
                               ras_color=None)
    tgt_d = torch.zeros((v, mh, mw))
    kw = dict(gamma=0.1, steps=steps, step_size=1.0)
    cache = smoothness.cell_cache(ctx, tgt_d, **kw)
    d_c, n_c = torch.zeros((m, v, mh, mw)), torch.zeros((m, v, mh, mw, 3))
    d0 = tgt_d[None].expand(m, v, mh, mw)
    calls = [("init cache", "smooth_cache", (ctx, tgt_d), kw), ("update", "smooth_moves", (cache, d_c, n_c), {}),
             ("refit", "smooth_moves", (cache, d0, n_c), {})]
    recs = [{"tag": tag, "kernel": kernel, "shape": smooth_turns._call_shape(kernel, a, k, steps)}
            for tag, kernel, a, k in calls]
    assert recs[2]["shape"] == {"moves": m, "rows": mh, "taps": 8 + 4 * steps, "broadcast_d": True}
    assert smooth_turns._bounds(recs) == {
        "init cache": roofline.bound(*roofline.smooth_cache_work(ctx, tgt_d, cache)),
        "update": roofline.bound(*roofline.smooth_moves_work(cache, d_c, n_c)),
        "refit": roofline.bound(*roofline.smooth_moves_work(cache, d0, n_c)),
    }


def test_slic_work_counted_one_pixel_at_a_time():
    """2 views of 20x28 in 8-pixel cells (3x4 cells, ragged at both
    edges), labels drawn from -2 .. Mh*Mw + 1: the assignment's candidates
    inside the map and the update's member pixels counted pixel by pixel."""
    v, h, w, s = 2, 20, 28, 8
    geom = DerivedGeometry.create(w, h, SystemSettings(spixl_size=s))
    mh, mw = geom.map_h, geom.map_w
    assert (mh, mw) == (3, 4)
    labels = np.random.default_rng(6).integers(-2, mh * mw + 2, (v, h, w)).astype(np.int32)
    cand = members = 0
    for y in range(h):
        for x in range(w):
            dxp, dyp = (x % s + s // 2) // s, (y % s + s // 2) // s
            cand += sum(0 <= y // s + dxp + i < mh and 0 <= x // s + dyp + j < mw
                        for i in (-1, 0) for j in (-1, 0))
            for z in range(v):
                lbl = int(labels[z, y, x])
                members += (0 <= lbl < mh * mw and abs(lbl // mw - y // s) <= 1
                            and abs(lbl % mw - x // s) <= 1)
    assert 0 < members < v * h * w and cand < 4 * h * w
    lab, lab_t = torch.zeros((v, h, w, 3)), torch.from_numpy(labels)
    pix, cells = v * h * w, v * mh * mw
    assert roofline.slic_work("slic_assign", lab, lab_t, geom) == (4 * (3 * pix + pix + 5 * cells), 18 * v * cand)
    assert roofline.slic_work("slic_update", lab, lab_t, geom) == (4 * (3 * pix + pix + 6 * cells),
                                                                   5 * members + 59 * cells)
    assert roofline.slic_work("slic_vote", lab, lab_t, geom) == (4 * 2 * pix, 50 * v * (h - 4) * (w - 4))
    with pytest.raises(ValueError):
        roofline.slic_work("slic", lab, lab_t, geom)


def test_vote_rounds_on_the_cpu():
    """``vote_rounds``: round 1 on the labels, round 2 on round 1's output;
    the tool's ``slic_vote`` record holds each as a call."""
    from cl_multiview_stereo_tpu_torch.ops import slic

    labels = torch.from_numpy(np.random.default_rng(7).integers(0, 3, (2, 12, 14)).astype(np.int32))
    rounds = roofline.vote_rounds(labels)
    assert list(rounds) == ["round 1", "round 2"] and rounds["round 1"] is labels
    assert torch.equal(rounds["round 2"], slic.suppress_local_labels_reference(labels))
    rec, = roofline.main(["--device", "cpu", "--shapes", "row", "--views", "2", "--height", "24", "--width", "40",
                          "--kernel", "slic_vote"])
    assert [c["call"] for c in rec["calls"]] == ["round 1", "round 2"]
    assert rec["bound_ms"] == pytest.approx(sum(c["bound_ms"] for c in rec["calls"]), rel=1e-12)
    assert all(c["ms"] == c["share"] == "not measured" for c in rec["calls"])


@pytest.mark.parametrize("n_bytes, n_ops, want", [
    (3.35e9, 1.0, (1.0, "bytes")),
    (1.0, 67e9, (1.0, "operations")),
    (3.35e9, 134e9, (2.0, "operations")),
    (6.7e9, 67e9, (2.0, "bytes")),
    (3.35e9, 67e9, (1.0, "bytes")),  # a tie is the bytes'
])
def test_bound_is_the_larger_time(n_bytes, n_ops, want):
    ms, by = roofline.bound(n_bytes, n_ops)
    assert by == want[1]
    assert ms == pytest.approx(want[0], rel=1e-12)


def test_roofline_counts_on_the_cpu(capsys):
    """The tool at a tiny row case: bounds from the counts, no time."""
    recs = roofline.main(["--device", "cpu", "--shapes", "row", "--views", "2", "--height", "24",
                          "--width", "40", "--d", "4"])
    assert [r["kernel"] for r in recs] == list(roofline.KERNELS)
    for r in recs:
        assert r["card"] == "cpu" and r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
        assert r["ms"] == r["plain_ms"] == r["share"] == "not measured"
    assert len(capsys.readouterr().out.strip().splitlines()) == len(roofline.KERNELS)


def test_roofline_calls_path_on_the_cpu(tmp_path):
    """``--calls path``: a raster or chain kernel on every main-path call
    (the init's table, each sweep's, fusion's map; each sweep's walk), each
    call's bound beside the sum; ``--csrc`` refuses a directory with no
    kernel sources."""
    row = ["--device", "cpu", "--shapes", "row", "--views", "2", "--height", "24", "--width", "40", "--d", "4",
           "--calls", "path"]
    raster, = roofline.main(row + ["--kernel", "raster_planes"])
    update, = roofline.main(row + ["--kernel", "chain_update"])
    sweeps = range(5)  # the row case's SystemSettings: no_prop 5
    assert [c["call"] for c in raster["calls"]] == ["init table", *(f"sweep {i} table" for i in sweeps),
                                                    "fusion map"]
    assert [c["call"] for c in update["calls"]] == [f"sweep {i} update" for i in sweeps]
    for r in (raster, update):
        assert r["bound_ms"] == pytest.approx(sum(c["bound_ms"] for c in r["calls"]), rel=1e-12)
        assert all(c["ms"] == "not measured" for c in r["calls"])
    with pytest.raises(SystemExit):
        roofline.main(row + ["--kernel", "chain_update", "--csrc", str(tmp_path)])



def test_roofline_view_range_on_the_cpu():
    """``--view-range``: the cross-check's kernels on one reference view of
    two, as a rank of the sharded path runs them: the warp writes half the
    maps and the vote makes at most half the walks' work."""
    row = ["--device", "cpu", "--shapes", "row", "--views", "2", "--height", "24", "--width", "40", "--d", "4",
           "--kernel", "fuse_warp", "--kernel", "fuse_vote"]
    warp, vote = roofline.main(row)
    warp1, vote1 = roofline.main(row + ["--view-range", "1,1"])
    assert warp1["shape"] == warp["shape"] + ", reference views 1..1"
    assert warp1["bound_ms"] < warp["bound_ms"] and vote1["bound_ms"] <= vote["bound_ms"]
    for walk in ("view_order", "descending"):
        assert 0 < vote1["calls"][0][f"{walk}_ops"] < vote["calls"][0][f"{walk}_ops"]
