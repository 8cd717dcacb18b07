#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

0. device: a CUDA device is visible; print its name and power limit;
1. build: compile ``csrc/cost_volume.cu`` with nvcc from this checkout;
2. kernel against plain: the CUDA cost volume and its plain PyTorch twin
   on the same device tensors, at the full 9-view 1080p size and one odd
   small shape, with both times from CUDA events;
3. the slice at full size: ``MVSPipeline(depth_method="strips")`` on a
   synthetic 9-view 1920x1080 fronto-parallel scene (31 hypotheses, 5 SLIC
   iterations, 5 propagation sweeps): one warm-up and two timed runs, the
   per-stage device times, MP/s and peak memory;
4. the card against the port's CPU path, at 3x3 views of 270x480.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# kernel-vs-plain bounds: the JAX suite's strips-vs-dense bounds
RTOL, ATOL, WTA_AGREE = 2e-7, 1e-3, 0.999
FULL_H, FULL_W = 1080, 1920
TRUE_DISP = 40.0


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _depth_inputs(rgb, settings, device):
    """Port stages up to the cost volume's inputs: (lab, centers, step)."""
    import torch

    from cl_multiview_stereo_tpu_torch import DerivedGeometry, SlicParams
    from cl_multiview_stereo_tpu_torch.ops import slic, superpixel
    from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab

    v, h, w = rgb.shape[:3]
    geom = DerivedGeometry.create(w, h, settings)
    lab = rgb_to_lab(torch.as_tensor(rgb, device=device))
    labels, spmap = slic.segment(lab, geom, SlicParams.create(settings))
    extent = superpixel.superpixel_extent(labels, spmap.center, geom)
    step = superpixel.extent_step(extent).contiguous()
    return lab.contiguous(), spmap.center.contiguous(), step


def phase_kernel_vs_plain(card: str) -> dict:
    import torch

    from cl_multiview_stereo_tpu_torch import (
        SystemSettings,
        build_disp_levels,
        fronto_parallel_scene,
    )
    from cl_multiview_stereo_tpu_torch.ops import cost_volume

    dev = torch.device("cuda")
    cases = [
        ("full 9x1080x1920", SystemSettings(), (FULL_H, FULL_W)),
        ("odd 4x61x45", SystemSettings(array_width=2, array_height=2, min_disp=4, max_disp=11), (61, 45)),
    ]
    rec = {}
    for label, s, (h, w) in cases:
        rgb, _ = fronto_parallel_scene(
            h, w, s.array_width, s.array_height, disp=TRUE_DISP if h == FULL_H else 7.0,
            bl_ratio=s.bl_ratio,
        )
        lab, centers, step = _depth_inputs(rgb, s, dev)
        levels = torch.as_tensor(build_disp_levels(s), device=dev)
        args = (lab, centers, step, levels, s.array_width, s.bl_ratio, s.neib_hor, s.neib_ver)
        kern = cost_volume.superpixel_cost_volume(*args)
        plain = cost_volume.cost_volume_reference(*args)
        torch.cuda.synchronize()
        err = (kern - plain).abs().max().item()
        if not torch.allclose(kern, plain, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{label}: kernel and plain disagree, max abs err {err}")
        ones = torch.ones(lab.shape[0], device=dev)
        agree = (
            cost_volume.wta_disparity(kern, levels, ones)
            == cost_volume.wta_disparity(plain, levels, ones)
        ).float().mean().item()
        if agree < WTA_AGREE:
            raise AssertionError(f"{label}: WTA agreement {agree} < {WTA_AGREE}")
        # in turns: kernel, plain, kernel, plain
        k_ms, p_ms = [], []
        for _ in range(2):
            k_ms.append(_cuda_ms(lambda: cost_volume.superpixel_cost_volume(*args), 10))
            p_ms.append(_cuda_ms(lambda: cost_volume.cost_volume_reference(*args), 2))
        k, p = sum(k_ms) / 2, sum(p_ms) / 2
        print(f"[2] {label}: shape {tuple(kern.shape)} max_abs_err {err:.3e} "
              f"wta_agree {agree:.6f} kernel {k:.3f} ms plain {p:.3f} ms ({card})")
        rec[label] = dict(max_abs_err=err, wta_agree=agree, ms=k, plain_ms=p)
    return rec["full 9x1080x1920"] | {"max_abs_err": max(r["max_abs_err"] for r in rec.values())}


def phase_slice(card: str) -> int:
    import numpy as np
    import torch

    from cl_multiview_stereo_tpu_torch import SystemSettings, fronto_parallel_scene
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.ops import cost_volume
    from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer

    s = SystemSettings()
    rgb, _ = fronto_parallel_scene(FULL_H, FULL_W, 3, 3, disp=TRUE_DISP, bl_ratio=s.bl_ratio)
    pipe = MVSPipeline.create(FULL_W, FULL_H, s, depth_method="strips", device="cuda")
    rgb_dev = torch.as_tensor(rgb, device="cuda")

    t0 = time.perf_counter()
    pipe.run(rgb_dev)
    torch.cuda.synchronize()
    print(f"[3] warm-up run {time.perf_counter() - t0:.3f} s ({card})")

    torch.cuda.reset_peak_memory_stats()
    cost_volume.LAUNCHES = 0
    times, timer = [], None
    for _ in range(2):
        timer = StageTimer()
        t0 = time.perf_counter()
        art = pipe.run(rgb_dev, timer=timer)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = cost_volume.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches < 1:
        raise AssertionError("the main path never launched the cost-volume kernel")

    d = art.disp_full
    if not bool(torch.isfinite(d).all()):
        raise AssertionError("disp_full has non-finite values")
    di = art.disp_init.cpu().numpy()[:, 8:-8, 8:-8]
    near = float((np.abs(di - TRUE_DISP) <= 1.0).mean())
    if near <= 0.9:
        raise AssertionError(f"disp_init within 1 of {TRUE_DISP} on only {near:.4f} of interior cells")

    t = min(times)
    mp_s = 9 * FULL_H * FULL_W / t / 1e6
    print(f"[3] runs {[round(x, 4) for x in times]} s; best {t:.4f} s = {mp_s:.4f} MP/s; "
          f"peak {peak / 2**30:.3f} GiB; disp_init near GT {near:.4f}; launches {launches} ({card})")
    print("[3] stage ms (last run): " + json.dumps({k: round(v, 3) for k, v in timer.ms().items()}))
    return launches


def phase_card_vs_cpu(card: str) -> None:
    import numpy as np
    import torch

    from cl_multiview_stereo_tpu_torch import SystemSettings, fronto_parallel_scene
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline

    s = SystemSettings()
    h, w = 270, 480
    rgb, _ = fronto_parallel_scene(h, w, 3, 3, disp=TRUE_DISP, bl_ratio=s.bl_ratio)
    out = {}
    for dev in ("cuda", "cpu"):
        art = MVSPipeline.create(w, h, s, depth_method="strips", device=dev).run(rgb)
        out[dev] = {k: getattr(art, k).cpu().numpy() for k in ("labels", "disp_init", "disp_full")}
    g, c = out["cuda"], out["cpu"]
    labels = float((g["labels"] == c["labels"]).mean())
    disp_init = float((g["disp_init"] == c["disp_init"]).mean())
    disp_full = float((np.abs(g["disp_full"] - c["disp_full"]) <= 1e-3).mean())
    print(f"[4] card vs CPU at 9x{h}x{w}: labels {labels:.6f} disp_init {disp_init:.6f} "
          f"disp_full(1e-3) {disp_full:.6f} ({card})")
    if labels <= 0.995 or disp_init < 0.99 or disp_full < 0.98:
        raise AssertionError("the card's output departs from the port's CPU path")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    try:
        from cl_multiview_stereo_tpu_torch.device import require_cuda
        from cl_multiview_stereo_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repo ({e})", file=sys.stderr)
        return 1

    require_cuda()
    card = _card()
    print(f"[0] {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _, log = build.build("cost_volume")
    build.load("cost_volume")
    print(f"[1] built cost_volume in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[1] ptxas: {line.strip()}")

    kv = phase_kernel_vs_plain(card)
    launches = phase_slice(card)
    phase_card_vs_cpu(card)

    record = {"kernels": [{
        "name": "cost_volume",
        "route": "cuda",
        "source": "cl_multiview_stereo_tpu_torch/csrc/cost_volume.cu",
        "replaces": "cl_multiview_stereo_tpu/ops/cost_volume.py:46",
        "launches": launches,
        "max_abs_err": kv["max_abs_err"],
        "ms": kv["ms"],
        "plain_ms": kv["plain_ms"],
    }]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
