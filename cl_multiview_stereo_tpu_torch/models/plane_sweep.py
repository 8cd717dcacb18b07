"""Dense per-pixel plane-sweep stereo (port of
``cl_multiview_stereo_tpu/models/plane_sweep.py``).

The ``initial_depth_estimation_v2`` cost (``clMVDE/clcode.cl:1017-1067``)
at every pixel instead of per superpixel: for each disparity hypothesis d
and each (reference, neighbour) pair, the neighbour is read at
``(x - d*dvx, y - bl_ratio*d*dvy)`` with C truncation of the projected
coordinate, the Lab SAD is summed over a zero-padded box window, the cost
per hypothesis is the min over the view's pairs, and a strict-``<``
winner-take-all over the ladder picks the disparity.

:func:`plane_sweep_depth` is the entry point: on a CUDA tensor it launches
``csrc/sweep.cu`` (``ops/sweep.py``) or raises, on a CPU tensor it runs
:func:`plane_sweep_reference`, the same function in plain PyTorch.  Both
equal the JAX XLA form and its Pallas kernel bitwise.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from cl_multiview_stereo_tpu_torch.config import build_disp_levels, build_view_subsets
from cl_multiview_stereo_tpu_torch.ops import sweep

_OOB_PENALTY = 30.0
_BIG = 1.0e6


def build_pairs(view_subset, subset_num, array_width: int) -> tuple[tuple[int, int, int, int], ...]:
    """Static (ref, view, dvx, dvy) pair list from the config's view-subset
    tables, in subset order."""
    vs = np.asarray(view_subset)
    counts = np.asarray(subset_num)
    pairs = []
    for z in range(vs.shape[0]):
        for k in range(int(counts[z])):
            view = int(vs[z, k])
            dvx = view % array_width - z % array_width
            dvy = view // array_width - z // array_width
            pairs.append((z, view, dvx, dvy))
    return tuple(pairs)


def sweep_args(settings) -> tuple[np.ndarray, tuple[tuple[int, int, int, int], ...]]:
    """The dense sweep's ladder and pairs for ``settings``: the config's
    disparity levels and its view subsets as pairs."""
    return build_disp_levels(settings), build_pairs(*build_view_subsets(settings), settings.array_width)


def _ladder(disp_levels) -> tuple[float, ...]:
    return tuple(float(d) for d in np.asarray(disp_levels, dtype=np.float64).reshape(-1))


def _window_sum(x: torch.Tensor, radius: int, dim: int, n: int) -> torch.Tensor:
    """Sums of 2r+1 consecutive entries along ``dim`` of ``x`` (which holds
    ``n + 2r`` entries there), each from its first term in ascending offset:
    the JAX form's association order, so costs match bitwise."""
    acc = x.narrow(dim, 0, n)
    for i in range(1, 2 * radius + 1):
        acc = acc + x.narrow(dim, i, n)
    return acc


def plane_sweep_reference(
    lab: torch.Tensor,  # (V, Hb, W, 3) float32 Lab
    disp_levels: Sequence[float] | np.ndarray,
    pairs: Sequence[tuple[int, int, int, int]],
    bl_ratio: float,
    window_radius: int = 2,
    rows: sweep.RowWindow | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch dense sweep: (disp, cost), each (V, H, W) float32,
    or (V, out_rows, W) for a row window ``rows`` (``ops/sweep.RowWindow``:
    ``lab`` holds the rows ``band0 ..`` of an image ``height`` rows high;
    every row test is on the global row, as in the kernel).

    The zero-padded box sums rows first, then columns; reference rows
    outside the image add 0.  A view with no pairs keeps disp 0 and cost
    1e6 (clcode.cl:1014)."""
    v, hb, w = lab.shape[:3]
    dev = lab.device
    ladder = _ladder(disp_levels)
    r = window_radius
    h, band0, out0, ho = (hb, 0, 0, hb) if rows is None else (int(x) for x in rows)
    sweep.check_window(sweep.RowWindow(h, band0, out0, ho), hb, ladder, pairs, bl_ratio, r)
    planar = lab.permute(0, 3, 1, 2)  # (V, 3, Hb, W) view
    ys = torch.arange(out0 - r, out0 + ho + r, device=dev)  # global rows of the box's inputs
    in_img = ((ys >= 0) & (ys < h))[:, None]
    xs = torch.arange(w, device=dev)

    def band_rows(y: torch.Tensor) -> torch.Tensor:
        # global rows, clamped to the image, as rows of the band; rows that
        # only out-of-image (masked) box inputs read are clamped into it
        return (y.clamp(0, h - 1) - band0).clamp(0, hb - 1)

    tables = [sweep.shift_table(ladder, dvx, dvy, bl_ratio) for _, _, dvx, dvy in pairs]
    best_cost = torch.full((v, ho, w), _BIG, dtype=torch.float32, device=dev)
    best_disp = torch.zeros((v, ho, w), dtype=torch.float32, device=dev)
    for di, d in enumerate(ladder):
        per_ref_min = torch.full((v, ho, w), _BIG, dtype=torch.float32, device=dev)
        for (ref, view, _, _), table in zip(pairs, tables):
            sy, sx, loy, lox = table[di]
            moved = planar[view].index_select(1, band_rows(ys - sy))
            moved = moved.index_select(2, (xs - sx).clamp(0, w - 1))
            diff = torch.abs(planar[ref].index_select(1, band_rows(ys)) - moved)
            sad = (diff[0] + diff[1]) + diff[2]
            valid = ((ys >= loy) & (ys <= h - 1 + sy))[:, None] & ((xs >= lox) & (xs <= w - 1 + sx))[None, :]
            sad = torch.where(in_img, torch.where(valid, sad, _OOB_PENALTY), 0.0)
            box = _window_sum(sad, r, 0, ho)
            box = _window_sum(torch.nn.functional.pad(box, (r, r)), r, 1, w)
            per_ref_min[ref] = torch.minimum(per_ref_min[ref], box)
        take = per_ref_min < best_cost
        best_cost = torch.where(take, per_ref_min, best_cost)
        best_disp = torch.where(take, float(np.float32(d)), best_disp)
    return best_disp, best_cost


def plane_sweep_depth(
    lab: torch.Tensor,
    disp_levels: Sequence[float] | np.ndarray,
    pairs: Sequence[tuple[int, int, int, int]],
    bl_ratio: float,
    window_radius: int = 2,
    rows: sweep.RowWindow | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense plane sweep for a static pair list; (disp, cost) (V, H, W),
    or (V, out_rows, W) for a row window ``rows`` (``ops/sweep.RowWindow``).

    A CUDA ``lab`` launches the sweep kernel; a CPU ``lab`` runs the plain
    twin.  Nothing falls back from one to the other."""
    if lab.device.type == "cpu":
        return plane_sweep_reference(lab, disp_levels, pairs, bl_ratio, window_radius, rows)
    return sweep.plane_sweep(lab, _ladder(disp_levels), pairs, bl_ratio, window_radius, rows)
