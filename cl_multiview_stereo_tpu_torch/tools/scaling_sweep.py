"""Views/s of the view-sharded pipeline at 1, 2, 4, ... ranks, weak scaling
(port of the JAX package's ``tools/scaling_sweep.py``).

Usage:

  python -m cl_multiview_stereo_tpu_torch.tools.scaling_sweep [--n 8] [--hw 96x128] \\
      [--json out.json] [--device cuda|cpu]

Per-rank work is held constant: at ``n`` ranks the camera array is ``n``
wide and 2 tall (2 views a rank), with the JAX tool's settings
(``spixl_size=8``, disparity 2..9, ``kernel_size=8``, ``kernel_step=2``,
``no_prop=2``) on random RGB from seed 0.  Each ``n`` starts ``n`` ranks as
processes (``tools/ranks``); each runs ``parallel.sharded_pipeline``'s
pipeline once to warm up, then three times, each after a barrier and
ending in a synchronize, and checks that its ``disp_full`` is bitwise the
unsharded ``MVSPipeline.run`` on the same batch (what ``parallel/``
promises).  A run's seconds are the slowest rank's; the median of three
gives views/s, views/s per rank, and the efficiency against one rank's
(only when more than one ``n`` ran).  One line per ``n``, then one JSON
line of the records (``--json`` also writes them to a file).

``--device cuda``: NCCL, one rank a card; the sweep stops at
``torch.cuda.device_count()`` and says so.  ``--device cpu``: gloo, the
counterpart of the JAX tool's virtual CPU mesh, with the same caveat: the
ranks share the host's cores, so the per-rank efficiency falls roughly like
1/n by construction.  There the sweep shows that the sharded program runs
and stays bitwise at every size; efficiency needs one card a rank.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

MODULE = "cl_multiview_stereo_tpu_torch.tools.scaling_sweep"
SIZES = (1, 2, 4, 8, 16, 32)
RUNS = 3
VIEWS_HIGH = 2
TIMEOUT_S = 900.0


def settings(n: int):
    """The weak-scaling configuration at ``n`` ranks (the JAX tool's)."""
    from cl_multiview_stereo_tpu_torch.config import SystemSettings

    return SystemSettings(array_width=n, array_height=VIEWS_HIGH, spixl_size=8, min_disp=2, max_disp=9, inc=1,
                          bl_ratio=1.0, kernel_size=8, kernel_step=2, no_prop=2)


def rank_main(args) -> int:
    """One rank of ``args.world``: its times and its bitwise check."""
    import torch.distributed as dist

    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.parallel import make_mesh
    from cl_multiview_stereo_tpu_torch.parallel.sharded_pipeline import sharded_pipeline_fn
    from cl_multiview_stereo_tpu_torch.tools import ranks
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import parse_hw

    dev = torch.device(args.device)
    ranks.join(args, dev)
    try:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        s = settings(args.world)
        h, w = parse_hw(args.hw)
        pipe = MVSPipeline.create(w, h, s, device=dev)
        rgb = np.random.default_rng(0).integers(0, 256, size=(s.view_num, h, w, 3), dtype=np.uint8)
        fn = sharded_pipeline_fn(pipe, make_mesh(device_type=dev.type))
        got = fn(rgb)
        sync()
        times = []
        for _ in range(RUNS):
            dist.barrier()
            t0 = time.perf_counter()
            fn(rgb)
            sync()
            times.append(time.perf_counter() - t0)
        bitwise = bool(torch.equal(got, pipe.run(rgb).disp_full))
        ranks.write(args, {"rank": args.rank, "runs_s": times, "bitwise": bitwise, "backend": dist.get_backend()})
    finally:
        dist.destroy_process_group()
    return 0


def build_parser() -> argparse.ArgumentParser:
    from cl_multiview_stereo_tpu_torch.tools import ranks

    ap = argparse.ArgumentParser(prog="scaling_sweep")
    ap.add_argument("--n", type=int, default=8, help="most ranks (sweep 1, 2, 4, ..., n)")
    ap.add_argument("--hw", default="96x128", help="per-view height x width")
    ap.add_argument("--json", default=None, help="also write the records to this path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; NCCL, one rank a card, raises without a GPU) or cpu (gloo)")
    ranks.add_worker_args(ap)
    return ap


def main(argv: list[str] | None = None) -> list[dict]:
    args = build_parser().parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return []

    from cl_multiview_stereo_tpu_torch.cli import resolve_device
    from cl_multiview_stereo_tpu_torch.device import card_name
    from cl_multiview_stereo_tpu_torch.tools import ranks

    dev = resolve_device(args.device)
    top = args.n
    if dev.type == "cuda" and top > torch.cuda.device_count():
        top = torch.cuda.device_count()
        print(f"stopping at {top} rank(s): torch.cuda.device_count() is {top}, one rank a card", flush=True)
    sizes = [n for n in SIZES if n <= top]
    unit = "card" if dev.type == "cuda" else "rank"
    card = card_name() if dev.type == "cuda" else "cpu"
    results, base = [], None
    for n in sizes:
        done = ranks.spawn(MODULE, ["--hw", args.hw, "--device", args.device], n, TIMEOUT_S)
        if any(r.returncode != 0 or r.record is None for r in done):
            raise RuntimeError(f"scaling_sweep at {n} ranks failed:\n{ranks.failure(done)}")
        if not all(r.record["bitwise"] for r in done):
            bad = [i for i, r in enumerate(done) if not r.record["bitwise"]]
            raise AssertionError(f"at {n} ranks, ranks {bad}: disp_full is not bitwise the unsharded run's")
        runs = [max(r.record["runs_s"][k] for r in done) for k in range(RUNS)]
        views = settings(n).view_num
        dt = statistics.median(runs)
        rate = views / dt
        per = rate / n
        base = per if base is None else base
        eff = per / base if len(sizes) > 1 else None
        results.append({"devices": n, "views": views, "views_per_s": rate, "per_device": per, "efficiency": eff,
                        "median_s": dt, "runs_s": runs, "backend": done[0].record["backend"], "bitwise": True,
                        "card": card, "hw": args.hw})
        tail = f"eff {eff:5.1%}" if eff is not None else f"{n} {unit}: no scaling efficiency"
        print(f"devices={n:3d} views={views:3d} {rate:8.2f} views/s ({per:.2f}/{unit}, {tail}); "
              f"backend {results[-1]['backend']}; disp_full bitwise the unsharded run on every rank", flush=True)
    print(json.dumps(results), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
