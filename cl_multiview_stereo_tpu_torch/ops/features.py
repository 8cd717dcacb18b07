"""Feature detection, description and matching (port of
``cl_multiview_stereo_tpu/ops/features.py``).

Harris corners, normalized patch descriptors and mutual-nearest matching,
batched over views with fixed shapes: K corners per view (top-K, not a
threshold) and ``max_matches`` slots per view pair.

Three places keep the JAX package's exact selection rule, because the SfM
track building of run_sfm reads every slot, valid or not:
  * ``lax.top_k`` puts the lower index first among equal values, and the
    ``-inf`` padding of both the Harris scores and the match keys ties
    often; ``torch.topk`` promises no order, so ``_top_k`` is a stable
    descending sort;
  * the NMS keeps strict maxima over the neighbours WITHOUT the centre
    (``resp > max(neighbours)``), which ``max_pool2d`` alone (centre
    included, ``>=``) does not give;
  * the box sums keep ``_box``'s form, differences of padded cumulative
    sums, not a convolution that sums in another order: ``det - k*tr*tr``
    cancels, and ulps reorder the corners.  XLA (a tree scan) and the card
    (a parallel scan) still round the running sums their own way, so the
    corners are held to JAX's by agreement, not bitwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Keypoints(NamedTuple):
    xy: torch.Tensor  # (V, K, 2) float32 pixel coords (x, y)
    score: torch.Tensor  # (V, K) float32 Harris response (-inf for padding)
    desc: torch.Tensor  # (V, K, D) float32 L2-normalized descriptors


class Matches(NamedTuple):
    idx: torch.Tensor  # (P, M, 2) int32 keypoint indices (in view a, in view b)
    valid: torch.Tensor  # (P, M) bool


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, the lower
    index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _box(x: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)^2 box sum over the trailing two axes via separable cumsum."""
    k = 2 * r + 1

    def slide(a: torch.Tensor, dim: int) -> torch.Tensor:
        pad = [0, 0] * (a.ndim - dim - 1) + [r + 1, r]  # F.pad counts from the last axis
        c = torch.cumsum(F.pad(a, pad), dim=dim)
        n = c.shape[dim]
        return c.narrow(dim, k, n - k) - c.narrow(dim, 0, n - k)

    return slide(slide(x, x.ndim - 1), x.ndim - 2)


def _neighbour_max(resp: torch.Tensor, rad: int) -> torch.Tensor:
    """Max over the (2r+1)^2 window WITHOUT its centre, outside the image
    -inf.  Separable and exact (a max has no rounding): per row the max of
    the r pixels left and the r pixels right of the centre; then per column
    the same over those rows' full-window maxima, joined with the centre
    row's.  JAX rolls the image 80 times instead; its wrap-around reads
    only the -inf border band, so the two agree wherever ``resp`` is
    finite."""

    def excl(a: torch.Tensor, dim: int) -> torch.Tensor:
        # sliding max of the r cells before and the r cells after each cell
        n = a.shape[dim]
        padded = F.pad(a.movedim(dim, -1), (rad, rad), value=-torch.inf)
        run = F.max_pool1d(padded.reshape(-1, 1, n + 2 * rad), rad, stride=1)
        run = run.reshape(*padded.shape[:-1], n + rad + 1)
        return torch.maximum(run[..., :n], run[..., rad + 1:]).movedim(-1, dim)

    row = excl(resp, 2)  # (V, H, W) left/right neighbours in the row
    cols = excl(torch.maximum(row, resp), 1)  # full rows above and below
    return torch.maximum(cols, row)


def harris_keypoints(
    gray: torch.Tensor,  # (V, H, W) float32 intensity
    k: int = 512,
    nms_radius: int = 4,
    patch: int = 8,
    harris_k: float = 0.04,
) -> Keypoints:
    """Top-``k`` Harris corners per view with patch descriptors."""
    v, h, w = gray.shape
    gx = (torch.roll(gray, -1, dims=2) - torch.roll(gray, 1, dims=2)) * 0.5
    gy = (torch.roll(gray, -1, dims=1) - torch.roll(gray, 1, dims=1)) * 0.5
    ixx = _box(gx * gx, 2)
    iyy = _box(gy * gy, 2)
    ixy = _box(gx * gy, 2)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    resp = det - harris_k * tr * tr

    # suppress borders (gradient wrap + patch extraction margin)
    m = max(nms_radius, patch // 2 + 1)
    interior = torch.zeros((h, w), dtype=torch.bool, device=gray.device)
    interior[m:h - m, m:w - m] = True
    resp = torch.where(interior, resp, -torch.inf)

    # NMS: keep strict local maxima of a (2r+1)^2 window
    is_max = resp > _neighbour_max(resp, nms_radius)
    scores = torch.where(is_max, resp, -torch.inf).reshape(v, -1)

    top_s, top_i = _top_k(scores, k)  # (V, K)
    ky, kx = top_i // w, top_i % w
    xy = torch.stack([kx, ky], dim=-1).to(torch.float32)

    # patch descriptors: normalized (patch x patch) intensity around each kp
    half = patch // 2
    offs = torch.arange(-half, half, device=gray.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    py = (ky[..., None, None] + oy).clamp(0, h - 1)
    px = (kx[..., None, None] + ox).clamp(0, w - 1)
    vid = torch.arange(v, device=gray.device)[:, None, None, None]
    d = gray[vid, py, px].reshape(v, k, patch * patch)
    d = d - d.mean(dim=-1, keepdim=True)
    d = d / (torch.sqrt((d * d).sum(dim=-1, keepdim=True)) + 1e-6)
    return Keypoints(xy=xy, score=top_s, desc=d)


def match_pairs(
    kp: Keypoints,
    pairs: torch.Tensor,  # (P, 2) int view-index pairs
    max_matches: int = 256,
    ratio: float = 0.9,
) -> Matches:
    """Mutual-nearest descriptor matching with Lowe ratio test, per pair.

    Distances via one batched matmul over the pairs (descriptors are
    L2-normalized so ``d2 = 2 - 2 * a.b``).  Only view a's scores screen
    the padding keypoints, as in the JAX package.
    """
    a, b = pairs[:, 0].long(), pairs[:, 1].long()
    sim = torch.bmm(kp.desc[a], kp.desc[b].transpose(1, 2))  # (P, K, K)
    # two best similarities per row for the ratio test
    top2, top2_i = _top_k(sim, 2)
    best_b = top2_i[..., 0]  # (P, K)
    # mutual check
    best_a_of_b = torch.argmax(sim, dim=1)  # (P, K)
    rows = torch.arange(sim.shape[1], device=sim.device)
    mutual = torch.gather(best_a_of_b, 1, best_b) == rows
    # ratio on squared distance: d2 = 2 - 2 s
    d1 = 2.0 - 2.0 * top2[..., 0]
    d2 = 2.0 - 2.0 * top2[..., 1]
    score_a = kp.score[a]
    good = mutual & (d1 < ratio * ratio * d2) & torch.isfinite(score_a) & (score_a > -torch.inf)
    # take up to max_matches by similarity
    key = torch.where(good, top2[..., 0], -torch.inf)
    sel_s, sel_i = _top_k(key, max_matches)
    idx = torch.stack([sel_i, torch.gather(best_b, 1, sel_i)], dim=-1).to(torch.int32)
    return Matches(idx=idx, valid=sel_s > -torch.inf)
