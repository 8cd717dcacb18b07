"""SfM front-end wired to the MVS pipeline (port of
``cl_multiview_stereo_tpu/models/sfm_pipeline.py``).

  RGB -> Harris keypoints -> mutual-nearest matching over grid-adjacent
  view pairs -> midpoint triangulation seeded by the grid-rig prior ->
  Schur-complement bundle adjustment -> recovered poses + metrics
  (reprojection RMS before/after, ATE vs the grid prior)

``pairs_from_poses`` converts recovered camera translations back into the
per-pair baseline deltas (dvx, dvy) the refinement consistency term
consumes, making the implicit grid one special case.

The device work (features, matching, the solvers) runs on ``device``; the
track building stays on the host in numpy, as in the JAX package, after
one pull each of the keypoints and the matches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.config import SystemSettings, build_view_subsets
from cl_multiview_stereo_tpu_torch.device import require_cuda
from cl_multiview_stereo_tpu_torch.models import sfm
from cl_multiview_stereo_tpu_torch.ops.features import harris_keypoints, match_pairs
from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer, maybe_stage

# ITU-R 601 luma weights, as float32
_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


class SfmResult(NamedTuple):
    aa: np.ndarray  # (V, 3) recovered axis-angle rotations
    t: np.ndarray  # (V, 3) recovered translations
    intr: np.ndarray  # (4,) intrinsics used (fx, fy, cx, cy)
    X: np.ndarray  # (P, 3) triangulated points (weight 0 rows are padding)
    obs_w: np.ndarray  # (N,) observation weights (0 = invalid match slot)
    rms_before: float  # reprojection RMS at the grid-prior seed
    rms_after: float  # reprojection RMS after bundle adjustment
    ate_vs_grid: float  # ATE of recovered translations vs the BA seed (the grid prior
    #                     unless pose_seed or the pose graph replaced it)
    n_matches: int  # valid pairwise matches used


def _unique_adjacent_pairs(settings: SystemSettings) -> np.ndarray:
    """Grid-adjacent unordered view pairs (a < b) from the same adjacency
    rule as the pipeline's view subsets (pipeline.cpp:130-142)."""
    view_subset, _ = build_view_subsets(settings)
    out = []
    for z in range(view_subset.shape[0]):
        for n in view_subset[z]:
            if n >= 0 and z < n:
                out.append((z, int(n)))
    return np.asarray(out, np.int32)


def gray_image(rgb: torch.Tensor) -> torch.Tensor:
    """(V, H, W, 3) uint8 -> (V, H, W) float32 luma, rounded as the JAX
    package's ``rgb @ weights`` is on the CPU: XLA contracts the dot into
    fused multiply-adds, ``fma(b, wb, fma(g, wg, r * wr))``.  Each step is
    exact in float64 (an 8-bit value times a float32 weight, plus a float32
    partial), so rounding it to float32 is the fused result, on any device."""
    x = rgb.to(torch.float64)
    w = torch.as_tensor(_LUMA, device=rgb.device).to(torch.float64)
    acc = (x[..., 0] * w[0]).to(torch.float32)
    for c in (1, 2):
        acc = (acc.to(torch.float64) + x[..., c] * w[c]).to(torch.float32)
    return acc


def run_sfm(
    rgb: np.ndarray,
    settings: SystemSettings,
    *,
    baseline: float = 1.0,
    k: int = 512,
    max_matches: int = 256,
    ba_iters: int = 12,
    mesh=None,
    pose_seed: tuple[np.ndarray, np.ndarray] | None = None,
    fix_rotations: bool = True,
    outlier_px: float = 6.0,
    intrinsics: np.ndarray | None = None,
    use_pose_graph: bool = False,
    device: str | torch.device = "cuda",
    timer: StageTimer | None = None,
) -> SfmResult:
    """Full SfM on a (V, H, W, 3) uint8 camera-array batch.

    ``baseline`` sets the metric scale of the grid-prior seed (the gauge:
    camera 0 is pinned and the seed keeps the free scale near the prior).
    ``use_pose_graph``: run the pose-graph backend first — per-edge
    two-view BA factors (``sfm.two_view_relative``) over the grid-adjacent
    match graph, a relative-pose solve (``sfm.pose_graph_optimize``, loop
    closures from the grid's 4-cycles), and THAT solution seeds the Schur
    BA.  ``mesh``: a ``DeviceMesh`` with a ``view`` axis
    (``parallel/mesh.make_mesh``); the bundle adjustment then runs with
    its observations sharded over that axis (``sfm.bundle_adjust_sharded``),
    every rank given the same images.  ``device`` defaults to ``cuda`` and
    fails without one; the CPU runs only when asked for.  ``timer`` (CUDA only) records the device ms
    of each stage and the host seconds of the track building.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    v, h, w = rgb.shape[:3]
    s = settings
    if v != s.view_num:
        raise ValueError(f"{v} views given, settings expect {s.view_num}")

    def on_dev(a, dtype=torch.float32) -> torch.Tensor:
        return convert.tensor(a, dtype, dev)

    with maybe_stage(timer, "gray"):
        gray = gray_image(torch.as_tensor(rgb, device=dev))
    with maybe_stage(timer, "harris"):
        kp = harris_keypoints(gray, k=k)
    pairs = _unique_adjacent_pairs(s)
    # a pair cannot hold more mutual matches than keypoints per view
    max_matches = min(max_matches, k)
    with maybe_stage(timer, "match"):
        matches = match_pairs(kp, on_dev(pairs, torch.int32), max_matches=max_matches)

    # grid-rig prior seed (the reference's implicit camera, made explicit);
    # ``pose_seed`` overrides it (e.g. a noise-perturbed seed in tests)
    grid_aa, grid_t = sfm.grid_rig_poses(v, s.array_width, baseline, s.bl_ratio)
    aa0, t0 = pose_seed if pose_seed is not None else (grid_aa, grid_t)
    if intrinsics is not None:
        intr = np.asarray(intrinsics, np.float32)
        if intr.shape != (4,):
            raise ValueError("intrinsics = (fx, fy, cx, cy)")
    else:
        # default guess when no calibration is configured: f = max(h, w)
        # (a wide-normal FOV prior), principal point at the image center
        f = float(max(h, w))
        intr = np.asarray([f, f, w / 2.0, h / 2.0], np.float32)

    # one pull each of the keypoints and the matches; this waits for the
    # device, so the host stage below times only the numpy work
    xy = kp.xy.cpu().numpy()
    idx_pm = matches.idx.cpu().numpy()
    valid_pm = matches.valid.cpu().numpy()

    # Track building (fixed shapes): a 3D point is anchored to the FIRST
    # view's keypoint — point id = a*K + idx_a for a match in pair (a, b).
    # Two pairs (a, b), (a, c) matching the same keypoint of view a then
    # share one point, which couples the pair graph.
    with maybe_stage(timer, "tracks", host=True):
        n_pair, m = idx_pm.shape[:2]
        pa = np.repeat(pairs[:, 0], m)  # (N/2,)
        pb = np.repeat(pairs[:, 1], m)
        idx = idx_pm.reshape(-1, 2)
        valid = valid_pm.reshape(-1)
        uv_a = xy[pa, idx[:, 0]]
        uv_b = xy[pb, idx[:, 1]]
    intr_d = on_dev(intr)

    if use_pose_graph:
        # measured relative factors from each adjacent pair's own matches
        # (two-view BA, batched over edges; scale gauged to the seed
        # baseline), then the relative-pose solve from the seed — its
        # output becomes the BA seed below
        with maybe_stage(timer, "two_view"):
            edges = on_dev(pairs, torch.int32)
            rel_seed_aa, rel_seed_t = sfm.relative_from_absolute(on_dev(aa0), on_dev(t0), edges)
            rel_aa, rel_t, rel_info = sfm.two_view_relative(
                on_dev(uv_a.reshape(n_pair, m, 2)), on_dev(uv_b.reshape(n_pair, m, 2)),
                on_dev(valid_pm), intr_d, rel_seed_aa, rel_seed_t,
                fix_rotations=fix_rotations, outlier_px=outlier_px,
            )
        with maybe_stage(timer, "pose_graph"):
            ones = torch.ones(len(pairs), dtype=torch.float32, device=dev)
            graph = sfm.PoseGraph(
                edges=edges, rel_aa=rel_aa, rel_t=rel_t, w_rot=ones, w_t=ones, info=rel_info,
            )
            aa_pg, t_pg = sfm.pose_graph_optimize(graph, on_dev(aa0), on_dev(t0))
        aa0, t0 = aa_pg.cpu().numpy(), t_pg.cpu().numpy()

    with maybe_stage(timer, "triangulate"):
        X_tri = sfm.triangulate(
            on_dev(aa0), on_dev(t0), intr_d, on_dev(np.stack([pa, pb], -1), torch.int32),
            on_dev(uv_a), on_dev(uv_b),
        )
    X_tri = X_tri.cpu().numpy()
    with maybe_stage(timer, "tracks", host=True):
        # guard degenerate triangulations (behind camera / blown up)
        good = valid & np.isfinite(X_tri).all(-1) & (X_tri[:, 2] > 0.1) & (X_tri[:, 2] < 1e6)
        X_tri = np.where(good[:, None], X_tri, 0.0)

        pt_id = (pa * k + idx[:, 0]).astype(np.int32)  # anchored point ids
        n_pt = v * k
        # point init: mean of this point's good triangulations
        acc = np.zeros((n_pt, 3), np.float64)
        cnt = np.zeros((n_pt,), np.float64)
        np.add.at(acc, pt_id, X_tri * good[:, None])
        np.add.at(cnt, pt_id, good.astype(np.float64))
        X0 = np.where(cnt[:, None] > 0, acc / np.maximum(cnt[:, None], 1.0), [0.0, 0.0, 1.0])

        obs_cam = np.concatenate([pa, pb]).astype(np.int32)
        obs_pt = np.concatenate([pt_id, pt_id]).astype(np.int32)
        obs_uv = np.concatenate([uv_a, uv_b]).astype(np.float32)
        obs_w = np.concatenate([good, good]).astype(np.float32)
        # exact slot width for the blocked Schur assembly: the true maximum
        # observation count per point (every obs slot counts, valid or not)
        max_deg = int(np.bincount(obs_pt, minlength=n_pt).max())

    with maybe_stage(timer, "outlier_gate"):
        prob = sfm.BAProblem(
            aa=on_dev(aa0), t=on_dev(t0), X=on_dev(X0), intr=intr_d,
            obs_cam=on_dev(obs_cam, torch.int32), obs_pt=on_dev(obs_pt, torch.int32),
            obs_uv=on_dev(obs_uv), obs_w=on_dev(obs_w),
        )
        # outlier gate: mutual-nearest matching still passes wrong matches
        # on repetitive texture; anything far off at the seed geometry is
        # an outlier, and one bad match dominates the least-squares objective
        res0 = sfm.residuals(prob).cpu().numpy()
        bad = np.sqrt((res0 ** 2).sum(-1)) > outlier_px
        obs_w = np.where(bad, 0.0, obs_w).astype(np.float32)
        prob = prob._replace(obs_w=on_dev(obs_w))
        rms_before = float(sfm.rms_error(prob))
    # default gauge: translation-only rig (the reference's camera model) —
    # narrow-FOV scenes make free rotations degenerate with translations
    with maybe_stage(timer, "ba"):
        if mesh is not None:
            out = sfm.bundle_adjust_sharded(
                prob, mesh, iters=ba_iters, fix_rotations=fix_rotations, max_deg=max_deg,
            )
        else:
            out = sfm.bundle_adjust(prob, iters=ba_iters, fix_rotations=fix_rotations, max_deg=max_deg)
        rms_after = float(sfm.rms_error(out))
        ate = float(sfm.ate(out.t, on_dev(t0)))
    return SfmResult(
        aa=out.aa.cpu().numpy(),
        t=out.t.cpu().numpy(),
        intr=intr,
        X=out.X.cpu().numpy(),
        obs_w=obs_w,
        rms_before=rms_before,
        rms_after=rms_after,
        ate_vs_grid=ate,
        n_matches=int(min((obs_w[: len(pa)] > 0).sum(), (obs_w[len(pa):] > 0).sum())),
    )


def pairs_from_poses(
    t: np.ndarray,
    view_subset: np.ndarray,
    baseline: float,
    bl_ratio: float,
    aa: np.ndarray | None = None,
) -> tuple:
    """Recovered poses -> the static (ref, view, dvx, dvy) pair list the
    refinement consistency term consumes (refine.pairs_from_subsets
    produces the integer-grid special case of this).

    The reference projects view n's sample at ``(x - d*dvx,
    y - bl_ratio*d*dvy)`` (clcode.cl:1033-1034) where dvx/dvy are camera-grid
    deltas.  With explicit poses, the delta is the baseline vector between
    camera centers ``C_i = -R_i^T t_i`` expressed in the reference view's
    frame: ``R_z (C_n - C_z) / baseline``; the vertical component divides
    out the ``bl_ratio`` the scorer multiplies back in.  ``aa`` (axis-angle,
    from a ``fix_rotations=False`` BA run) supplies the rotations; omitted,
    the rig is R = I and centers reduce to ``-t``.
    """
    t = np.asarray(t)
    vs = np.asarray(view_subset)
    if aa is None:
        centers = -t
        rot = np.broadcast_to(np.eye(3, dtype=t.dtype), (t.shape[0], 3, 3))
    else:
        rot = sfm.rodrigues(torch.as_tensor(np.asarray(aa, np.float32))).numpy()
        centers = -np.einsum("vij,vi->vj", rot, t)  # -R^T t
    pairs = []
    for z in range(vs.shape[0]):
        for n_ in vs[z]:
            if n_ < 0:
                continue
            n_ = int(n_)
            delta = rot[z] @ (centers[n_] - centers[z])
            pairs.append((
                z,
                n_,
                float(delta[0] / baseline),
                float(delta[1] / (baseline * bl_ratio)),
            ))
    return tuple(pairs)
