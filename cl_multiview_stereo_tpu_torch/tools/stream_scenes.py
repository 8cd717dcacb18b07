"""Multi-scene streaming throughput (BASELINE config-5 stand-in; port of
the JAX package's ``tools/stream_scenes.py``).

Streams N scenes through the native C++ prefetcher (``io/prefetcher``:
background thread-pool decode of scenes i+1..i+d, pinned staging and a
non-blocking copy to the card, while the card runs scene i) and the
one-program forward (``MVSPipeline.jitted()``, a CUDA graph on a card), or
with ``--mesh N`` the view-sharded pipeline
(``parallel/sharded_pipeline.sharded_pipeline_fn``, eager) over an N-rank
group.  The reference blocks its main thread on synchronous OpenCV loads
per scene (clMVDE/pipeline.cpp:12, file_handler.cpp:30-57).

Usage:
  python -m cl_multiview_stereo_tpu_torch.tools.stream_scenes data.txt --repeat 4
  python -m cl_multiview_stereo_tpu_torch.tools.stream_scenes list1.txt list2.txt \\
      [--depth 2] [--mesh N] [--device cuda|cpu] [--set key=value ...]

The first scene runs once untimed (the graph's warm-up and capture); then
every scene, the lists repeated R times, is timed from the first decode to
the last disparity map.  Prints ONE JSON line: scenes, wall seconds,
views/s, MP/s, the prefetch depth, the mesh, the decode backend and the
device.  ``--mesh N`` needs a group of N ranks (torch's ``MASTER_ADDR``/
``WORLD_SIZE``/``RANK`` environment); without one a world-size-1 group
starts and only N = 1 runs.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="stream_scenes")
    ap.add_argument("lists", nargs="+", help="data.txt-style image lists")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--depth", type=int, default=2, help="prefetch depth")
    ap.add_argument("--mesh", type=int, default=0,
                    help="view-shard over N ranks (0 = unsharded, the CUDA graph)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--config", help="JSON settings file (SystemSettings fields)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="override a SystemSettings field")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    from cl_multiview_stereo_tpu_torch.cli import resolve_device, settings_from
    from cl_multiview_stereo_tpu_torch.io.images import load_image, read_image_list
    from cl_multiview_stereo_tpu_torch.io.prefetcher import ScenePrefetcher
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline

    s = settings_from(args)
    dev = resolve_device(args.device)
    scene_lists = [read_image_list(p) for p in args.lists] * args.repeat
    first = load_image(scene_lists[0][0])
    h, w = first.shape[:2]
    if len(scene_lists[0]) != s.view_num:
        raise SystemExit(f"scene has {len(scene_lists[0])} views, settings expect {s.view_num}")
    pipe = MVSPipeline.create(w, h, s, device=dev)

    if args.mesh:
        from cl_multiview_stereo_tpu_torch.parallel import initialize_distributed, make_mesh
        from cl_multiview_stereo_tpu_torch.parallel.sharded_pipeline import sharded_pipeline_fn

        initialize_distributed(device=dev.type)
        fwd = sharded_pipeline_fn(pipe, make_mesh(n_view=args.mesh, device_type=dev.type))
        pull = lambda out: float(out.reshape(-1)[::4096].sum())  # noqa: E731
    else:
        fwd = pipe.jitted()
        pull = lambda art: float(art.disp_full.reshape(-1)[::4096].sum())  # noqa: E731

    # warm-up (the graph's capture) on the first scene, not timed
    rgb0 = np.stack([first] + [load_image(p) for p in scene_lists[0][1:]])
    pull(fwd(torch.as_tensor(rgb0, device=dev)))

    n_done = 0
    t0 = time.perf_counter()
    with ScenePrefetcher(scene_lists, h, w, depth=args.depth, device=dev) as pf:
        for _, rgb in pf:
            pull(fwd(rgb))
            n_done += 1
    dt = time.perf_counter() - t0

    views = len(scene_lists[0])
    rec = {
        "metric": "stream_views_per_s",
        "scenes": n_done,
        "wall_s": dt,
        "value": n_done * views / dt,
        "unit": "views/s",
        "mp_per_s": n_done * views * h * w / dt / 1e6,
        "prefetch_depth": args.depth,
        "mesh": args.mesh,
        "decode_backend": pf.backend,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    if args.mesh:
        import torch.distributed as dist

        dist.destroy_process_group()
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
