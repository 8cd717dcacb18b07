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


def _ladder(disp_levels) -> tuple[float, ...]:
    return tuple(float(d) for d in np.asarray(disp_levels, dtype=np.float64).reshape(-1))


def _box_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Zero-padded (2r+1)^2 box sum over the last two axes: rows first,
    then columns, each summed from the first term in ascending offset (the
    JAX form's association order, so costs match bitwise)."""
    if radius == 0:
        return x
    k = 2 * radius + 1
    for dim in (-2, -1):
        n = x.shape[dim]
        pad = [0, 0, 0, 0]
        pad[0 if dim == -1 else 2] = radius
        pad[1 if dim == -1 else 3] = radius
        p = torch.nn.functional.pad(x, pad)
        acc = p.narrow(dim, 0, n)
        for i in range(1, k):
            acc = acc + p.narrow(dim, i, n)
        x = acc
    return x


def plane_sweep_reference(
    lab: torch.Tensor,  # (V, H, W, 3) float32 Lab
    disp_levels: Sequence[float] | np.ndarray,
    pairs: Sequence[tuple[int, int, int, int]],
    bl_ratio: float,
    window_radius: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch dense sweep: (disp, cost), each (V, H, W) float32.

    A view with no pairs keeps disp 0 and cost 1e6 (clcode.cl:1014)."""
    v, h, w = lab.shape[:3]
    dev = lab.device
    ladder = _ladder(disp_levels)
    planar = lab.permute(0, 3, 1, 2)  # (V, 3, H, W) view
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    tables = [sweep.shift_table(ladder, dvx, dvy, bl_ratio) for _, _, dvx, dvy in pairs]
    best_cost = torch.full((v, h, w), _BIG, dtype=torch.float32, device=dev)
    best_disp = torch.zeros((v, h, w), dtype=torch.float32, device=dev)
    for di, d in enumerate(ladder):
        per_ref_min = torch.full((v, h, w), _BIG, dtype=torch.float32, device=dev)
        for (ref, view, _, _), table in zip(pairs, tables):
            sy, sx, loy, lox = table[di]
            moved = planar[view].index_select(1, (ys - sy).clamp(0, h - 1))
            moved = moved.index_select(2, (xs - sx).clamp(0, w - 1))
            diff = torch.abs(planar[ref] - moved)
            sad = (diff[0] + diff[1]) + diff[2]
            valid = ((ys >= loy) & (ys <= h - 1 + sy))[:, None] & ((xs >= lox) & (xs <= w - 1 + sx))[None, :]
            sad = torch.where(valid, sad, _OOB_PENALTY)
            per_ref_min[ref] = torch.minimum(per_ref_min[ref], _box_sum(sad, window_radius))
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense plane sweep for a static pair list; (disp, cost) (V, H, W).

    A CUDA ``lab`` launches the sweep kernel; a CPU ``lab`` runs the plain
    twin.  Nothing falls back from one to the other."""
    if lab.device.type == "cpu":
        return plane_sweep_reference(lab, disp_levels, pairs, bl_ratio, window_radius)
    return sweep.plane_sweep(lab, _ladder(disp_levels), pairs, bl_ratio, window_radius)
