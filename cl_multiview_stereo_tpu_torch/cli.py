"""Command-line entry point of the port (``cl_multiview_stereo_tpu/cli.py``
with a ``--device`` flag).

An image-list file (the reference's ``data.txt`` format) drives one full
pipeline run; config files, ``--set`` overrides, stage dumps, the PLY and
the npz checkpoint are the JAX CLI's, with its file names and keys.

Usage:
    python -m cl_multiview_stereo_tpu_torch.cli run data.txt \\
        --device cuda --set min_disp=10 --set max_disp=100 \\
        --out results/ --dump-stages --cross-check --ply --checkpoint
    python -m cl_multiview_stereo_tpu_torch.cli sfm data.txt --pose-graph

``sfm`` runs the SfM front-end alone and writes ``sfm_poses.npz``; ``run
--sfm`` feeds its recovered poses to the refinement as pair deltas.
``--device`` defaults to ``cuda`` and fails when no CUDA device is visible;
the CPU is used only when ``--device cpu`` asks for it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cl-mvs-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run the full MVS pipeline on an image list")
    run.add_argument("image_list", help="newline-separated image paths (data.txt format)")
    run.add_argument("--config", help="JSON settings file (SystemSettings fields)")
    run.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                     help="override a settings field")
    run.add_argument("--device", default="cuda",
                     help="torch device: 'cuda' (default; fails without a GPU) or 'cpu'")
    run.add_argument("--out", default="results", help="output directory")
    run.add_argument("--dump-stages", action="store_true",
                     help="write per-stage PNG artifacts (reference results/ tree)")
    run.add_argument("--checkpoint", action="store_true",
                     help="save stage arrays as npz for resume/inspection")
    run.add_argument("--resume", metavar="NPZ",
                     help="re-enter the pipeline from a --checkpoint npz: "
                          "the deepest stage present is skipped, later "
                          "stages recompute")
    run.add_argument("--cross-check", action="store_true",
                     help="enable the cross-view fusion vote (the reference's "
                          "disabled-but-intended path)")
    run.add_argument("--ply", action="store_true",
                     help="export the fused point cloud as binary PLY")
    run.add_argument("--sfm", action="store_true",
                     help="recover poses with the SfM front-end first and "
                          "feed them into the refinement's generalized "
                          "projection path")

    sfm_p = sub.add_parser(
        "sfm", help="run the SfM front-end (features -> matches -> "
                    "triangulation -> bundle adjustment) and report metrics"
    )
    sfm_p.add_argument("image_list")
    sfm_p.add_argument("--config", help="JSON settings file")
    sfm_p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    sfm_p.add_argument("--device", default="cuda",
                       help="torch device: 'cuda' (default; fails without a GPU) or 'cpu'")
    sfm_p.add_argument("--out", default="results", help="output directory")
    sfm_p.add_argument("--keypoints", type=int, default=512)
    sfm_p.add_argument("--ba-iters", type=int, default=12)
    sfm_p.add_argument("--pose-graph", action="store_true",
                       help="run the pose-graph backend first (two-view "
                            "relative factors + information-weighted solve) "
                            "and seed the Schur BA from its solution")
    sfm_p.add_argument("--free-rotations", action="store_true",
                       help="optimize rotations too (default: translation-only "
                            "rig gauge matching the reference's camera model)")
    return ap


def settings_from(args: argparse.Namespace):
    """``SystemSettings`` from ``--config`` and the ``--set`` overrides."""
    from cl_multiview_stereo_tpu_torch.config import SystemSettings

    s = SystemSettings.from_json(args.config) if args.config else SystemSettings()
    if args.set:
        s = s.replace(**_parse_overrides(args.set))
    return s


def resolve_device(name: str) -> torch.device:
    """``cuda`` must exist (``device.require_cuda``); only an explicit
    ``cpu`` runs on the CPU."""
    from cl_multiview_stereo_tpu_torch.device import require_cuda

    dev = torch.device(name)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return dev


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from cl_multiview_stereo_tpu_torch.io.images import load_image_array

    s = settings_from(args)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    rgb = load_image_array(args.image_list, s.view_num)
    v, h, w = rgb.shape[:3]
    print(f"loaded {v} views of {w}x{h} in {time.perf_counter() - t0:.2f}s")
    if args.cmd == "sfm":
        _run_sfm_cmd(args, s, rgb, dev)
        return 0
    pair_deltas = _sfm_pair_deltas(rgb, s, dev) if args.sfm else None
    run_array(rgb, args, s, dev, pair_deltas=pair_deltas)
    return 0


def _intrinsics_from(s, w: int, h: int):
    """(fx, fy, cx, cy) from the config's ``sfm_focal``, or None for the
    run_sfm default FOV prior."""
    if s.sfm_focal is None:
        return None
    return np.asarray([s.sfm_focal, s.sfm_focal, w / 2.0, h / 2.0], np.float32)


def _sfm_pair_deltas(rgb: np.ndarray, s, dev: torch.device) -> tuple:
    """``run --sfm``: recover the poses, then the refinement's pair deltas."""
    from cl_multiview_stereo_tpu_torch.config import build_view_subsets
    from cl_multiview_stereo_tpu_torch.models.sfm_pipeline import pairs_from_poses, run_sfm

    h, w = rgb.shape[1:3]
    res = run_sfm(rgb, s, baseline=s.sfm_baseline, intrinsics=_intrinsics_from(s, w, h), device=dev)
    print(
        f"sfm: {res.n_matches} matches, reprojection RMS "
        f"{res.rms_before:.3f} -> {res.rms_after:.3f} px, "
        f"ATE vs grid prior {res.ate_vs_grid:.4f}"
    )
    view_subset, _ = build_view_subsets(s)
    # the same baseline scales both the BA gauge above and the pair deltas
    # here — one knob (s.sfm_baseline), never two literals
    return pairs_from_poses(res.t, view_subset, s.sfm_baseline, s.bl_ratio, aa=res.aa)


def _run_sfm_cmd(args: argparse.Namespace, s, rgb: np.ndarray, dev: torch.device) -> None:
    """``sfm`` subcommand: front-end + BA, metrics printed, poses saved.  On
    a CUDA device the stage times are printed too."""
    from cl_multiview_stereo_tpu_torch.models.sfm_pipeline import run_sfm
    from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer

    h, w = rgb.shape[1:3]
    timer = StageTimer() if dev.type == "cuda" else None
    t0 = time.perf_counter()
    res = run_sfm(
        rgb, s, k=args.keypoints, ba_iters=args.ba_iters,
        fix_rotations=not args.free_rotations,
        baseline=s.sfm_baseline, intrinsics=_intrinsics_from(s, w, h),
        use_pose_graph=args.pose_graph, device=dev, timer=timer,
    )
    dt = time.perf_counter() - t0
    print(f"sfm done in {dt:.2f}s: {res.n_matches} pairwise matches")
    print(f"reprojection RMS: {res.rms_before:.3f} -> {res.rms_after:.3f} px")
    print(f"ATE vs grid prior: {res.ate_vs_grid:.4f} (baseline units)")
    if timer is not None:
        print("stage ms: " + json.dumps({k: round(x, 3) for k, x in timer.ms().items()}))
        print("host s: " + json.dumps({k: round(x, 4) for k, x in timer.host_s.items()}))
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, "sfm_poses.npz")
    np.savez(
        out_path,
        aa=res.aa,
        t=res.t,
        intr=res.intr,
        X=res.X,
        rms_before=res.rms_before,
        rms_after=res.rms_after,
        ate_vs_grid=res.ate_vs_grid,
    )
    print(f"poses written to {out_path}")


def run_array(
    rgb: np.ndarray, args: argparse.Namespace, s, dev: torch.device, pair_deltas: tuple | None = None,
):
    """Everything ``run`` does after the image decode, on a (V, H, W, 3)
    uint8 array: the pipeline (or its resume), one device-to-host pull of
    the disparity maps, then the host outputs: the per-view disparity PNGs
    in ``8- Fusion``, ``--dump-stages``, ``--ply`` and ``--checkpoint``.
    ``pair_deltas`` (from ``run --sfm``) replaces the camera-grid deltas of
    the refinement.  On a CUDA device the per-stage device times are
    printed too, and the host seconds of each output in the last line.
    Returns the pipeline's artifacts."""
    from cl_multiview_stereo_tpu_torch.io.images import save_gray_png
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.utils import artifacts
    from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer

    v, h, w = rgb.shape[:3]
    pipe = MVSPipeline.create(
        w, h, s, device=dev, cross_check=args.cross_check, pair_deltas=pair_deltas
    )
    timer = StageTimer() if dev.type == "cuda" else None
    t0 = time.perf_counter()
    if args.resume:
        art = pipe.resume(rgb, args.resume, timer=timer)
    else:
        art = pipe.run(rgb, timer=timer)
    # one device-to-host pull of the whole (V, H, W) stack, which also
    # waits for the pipeline to finish
    disp_np = artifacts.to_host(art.disp_full)
    dt = time.perf_counter() - t0
    print(f"pipeline done in {dt:.2f}s ({v * h * w / dt / 1e6:.1f} MP/s) on {dev}")
    if timer is not None:
        print("stage ms: " + json.dumps({k: round(x, 3) for k, x in timer.ms().items()}))
    print("artifacts: disparity maps pulled to host", flush=True)

    os.makedirs(args.out, exist_ok=True)
    lo, hi = float(s.min_disp), float(s.max_disp)
    host_s = {}
    t0 = time.perf_counter()
    for view in range(v):
        save_gray_png(
            os.path.join(args.out, artifacts.STAGE_DIRS["fusion"], f"disp_{view}.png"),
            disp_np[view], lo, hi,
        )
    host_s["disparity_pngs"] = time.perf_counter() - t0
    if args.dump_stages:
        t0 = time.perf_counter()
        from cl_multiview_stereo_tpu_torch.io.images import draw_segmentation_lines, save_png

        overlay = draw_segmentation_lines(rgb, artifacts.to_host(art.labels))
        for view in range(v):
            save_png(os.path.join(args.out, "0- segmentation", f"seg_{view}.png"), overlay[view])
        artifacts.dump_stage_pngs(args.out, "disp_init", art.disp_init, lo, hi)
        artifacts.dump_stage_pngs(args.out, "flatness", art.flatness[..., 0], 0.0, 1.0)
        artifacts.dump_stage_pngs(args.out, "sm", art.state.sm, 0.0, 1.0)
        artifacts.dump_stage_pngs(args.out, "cs", art.state.cs, 0.0, 1.0)
        artifacts.dump_stage_pngs(args.out, "propagate", art.state.d, lo, hi)
        host_s["stage_pngs"] = time.perf_counter() - t0
    if args.ply:
        t0 = time.perf_counter()
        from cl_multiview_stereo_tpu_torch.io.pointcloud import disparity_to_points, save_ply

        pts, cols = disparity_to_points(disp_np, rgb, s.array_width, s.bl_ratio)
        save_ply(os.path.join(args.out, "fused.ply"), pts, cols)
        print(f"point cloud: {pts.shape[0]} points")
        host_s["ply"] = time.perf_counter() - t0
    if args.checkpoint:
        t0 = time.perf_counter()
        artifacts.save_checkpoint(
            os.path.join(args.out, "pipeline_state.npz"),
            labels=art.labels,
            center=art.spmap.center,
            color=art.spmap.color,
            count=art.spmap.count,
            disp_init=art.disp_init,
            state_d=art.state.d,
            state_sm=art.state.sm,
            state_cs=art.state.cs,
            state_n=art.state.n,
            disp_full=disp_np,
        )
        host_s["checkpoint"] = time.perf_counter() - t0
    print(f"results written to {args.out}; host s: "
          + json.dumps({k: round(x, 3) for k, x in host_s.items()}))
    return art


if __name__ == "__main__":
    sys.exit(main())
