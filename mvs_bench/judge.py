"""The numbers by which a scene the timed window produced is held to the
plain reference, one a layer, each a worst case over the scenes checked.

- ``lab``: the largest absolute gap of the Lab image;
- ``labels``: the share of pixels whose superpixel label differs;
- ``spmap``: the share of superpixels whose centre or colour lies more than
  SPMAP_TOL from the reference's;
- ``extent``: the share of superpixels with a ray extent that differs;
- ``disp_init``: the share of superpixels whose initial disparity differs;
- ``d`` and ``n``: the shares of superpixels whose refined plane's
  disparity lies more than D_TOL, or whose normal more than N_TOL, from
  the reference's (not-a-number on one side only counts as far);
- ``disp_full``: the share of pixels of the maps on the host whose
  disparity lies more than D_TOL from the reference's.
"""

from __future__ import annotations

import torch

NUMBERS = ("lab", "labels", "spmap", "extent", "disp_init", "d", "n", "disp_full")
SPMAP_TOL, D_TOL, N_TOL = 1e-3, 1e-2, 1e-3


def _far(a: torch.Tensor, b: torch.Tensor, tol: float) -> torch.Tensor:
    """Elementwise: |a - b| > tol, or not a number on one side only."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    gap = torch.abs(torch.nan_to_num(a, nan=0.0, posinf=3e38, neginf=-3e38)
                    - torch.nan_to_num(b, nan=0.0, posinf=3e38, neginf=-3e38))
    return (nan_a != nan_b) | (~nan_a & ~nan_b & (gap > tol))


def _share(mask: torch.Tensor) -> float:
    return float(mask.to(torch.float64).mean())


def compare(got: dict, want) -> dict[str, float]:
    """``got``: the program's ``lab``, ``labels``, ``center``, ``color``,
    ``extent``, ``disp_init``, ``d``, ``n`` and the host's ``disp_full``;
    ``want``: the reference's ``Outputs`` of the same capture."""
    dev = want.lab.device
    g = {k: torch.as_tensor(t).to(dev) for k, t in got.items()}
    cell_far = (_far(g["center"], want.center, SPMAP_TOL).any(-1) | _far(g["color"], want.color, SPMAP_TOL).any(-1))
    return {
        "lab": float(torch.nan_to_num(torch.abs(g["lab"] - want.lab), nan=float("inf")).max()),
        "labels": _share(g["labels"].to(torch.int64) != want.labels.to(torch.int64)),
        "spmap": _share(cell_far),
        "extent": _share((g["extent"].to(torch.int64) != want.extent.to(torch.int64)).any(-1)),
        "disp_init": _share(_far(g["disp_init"], want.disp_init, 0.0)),
        "d": _share(_far(g["d"], want.d, D_TOL)),
        "n": _share(_far(g["n"], want.n, N_TOL).any(-1)),
        "disp_full": _share(_far(g["disp_full"], want.disp_full, D_TOL)),
    }


def worst(readings: list[dict]) -> dict[str, float]:
    """The largest of each number over the scenes checked."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}
