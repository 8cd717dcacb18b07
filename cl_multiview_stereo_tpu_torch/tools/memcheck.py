"""Does a configuration fit in the card's memory (port of the JAX package's
``tools/memcheck.py``).

Usage:

  python -m cl_multiview_stereo_tpu_torch.tools.memcheck [H W] [key=val ...] \\
      [--pair-layout packed|view] [--sharded N] [--device cuda|cpu]

``key=val`` pairs override ``SystemSettings`` fields, each value parsed
with ``json.loads`` as the JAX tool parses it (BASELINE's config 4:
``2048 2048 array_width=7 array_height=7 min_disp=0 max_disp=255 inc=1``).
PyTorch has no ahead-of-time memory analysis, so the tool runs
``MVSPipeline.run`` once on the card on ``bench.py``'s synthetic scene at
that shape, after ``reset_peak_memory_stats()``.  Prints one JSON line:
``hw``, ``views``, ``settings``, ``pair_layout``, ``peak_allocated_gib``,
``peak_reserved_gib``, the card's ``total_gib``, the run's ``seconds``,
``fits`` and ``card``.  When the allocator refuses a request
(``torch.OutOfMemoryError``) ``fits`` is false, ``refused`` holds the
request and the exit code is 3: that is the answer, not a failure.  With
``--device cpu`` the run is on the CPU and the device fields are null.

``--sharded N``: ``N`` ranks (``tools/ranks``; NCCL with one rank a card
on ``cuda``, gloo on ``cpu``) run ``parallel.sharded_pipeline.run_sharded``
on the same scene, the views split over the ranks as ``view_block`` splits
them (``V`` a multiple of ``N``, else refused with exit 2, as is ``N``
above the card count).  Each rank resets its card's peak statistics, runs,
and prints its own record (``rank``, ``backend``, the two peaks,
``seconds``, ``fits``); the last line is the record above with the largest
peaks and seconds over the ranks, plus ``sharded``, ``backend`` and
``ranks``.  The exit codes are the unsharded mode's: 0 when every rank
fits, 3 when an allocator refuses (the other ranks, left waiting in a
collective, are stopped); a rank that fails otherwise is an error (exit 1).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import torch

MODULE = "cl_multiview_stereo_tpu_torch.tools.memcheck"
OOM_EXIT, REFUSED_EXIT = 3, 2
GIB = 2.0**30
SHARDED_TIMEOUT_S = 900.0


def build_parser() -> argparse.ArgumentParser:
    from cl_multiview_stereo_tpu_torch.tools import ranks

    ap = argparse.ArgumentParser(prog="memcheck")
    ap.add_argument("args", nargs="*", metavar="H W key=val", help="image height and width, then overrides")
    ap.add_argument("--pair-layout", default="packed", choices=("packed", "view"))
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="N ranks run the view-sharded pipeline (NCCL, one rank a card; gloo on cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu (runs, measures nothing)")
    ranks.add_worker_args(ap)
    return ap


def parse(argv: list[str] | None = None) -> argparse.Namespace:
    """The JAX tool's rule: words without ``=`` are H then W (default
    1080 1920), ``key=val`` words are settings overrides."""
    args = build_parser().parse_args(argv)
    pos = [a for a in args.args if "=" not in a]
    args.overrides = {k: json.loads(v) for k, v in (a.split("=", 1) for a in args.args if "=" in a)}
    args.h = int(pos[0]) if pos else 1080
    args.w = int(pos[1]) if len(pos) > 1 else 1920
    return args


def refused(e: torch.OutOfMemoryError) -> str:
    """The request the allocator refused, as its message states it."""
    asked = re.search(r"Tried to allocate [\d.]+ \w+", str(e))
    return asked.group(0) if asked else str(e).splitlines()[0]


def rank_main(args) -> int:
    """One rank of ``--sharded``: its own peaks, written as its record.  A
    refused allocation ends the process at once (exit 3): its peers wait in
    a collective that will not complete."""
    import torch.distributed as dist

    from cl_multiview_stereo_tpu_torch.config import SystemSettings
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.parallel import make_mesh
    from cl_multiview_stereo_tpu_torch.parallel.sharded_pipeline import run_sharded
    from cl_multiview_stereo_tpu_torch.tools import ranks
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import scene

    dev = torch.device(args.device)
    ranks.join(args, dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    s = SystemSettings().replace(**args.overrides)
    pipe = MVSPipeline.create(args.w, args.h, s, pair_layout=args.pair_layout, device=dev)
    mesh = make_mesh(device_type=dev.type)
    rgb = scene(s, args.h, args.w)
    rec = {"rank": args.rank, "backend": dist.get_backend(), "peak_allocated_gib": None, "peak_reserved_gib": None,
           "seconds": None, "fits": None}
    rc = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        run_sharded(pipe, rgb, mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            rec["fits"] = True
    except torch.OutOfMemoryError as e:
        rec.update(fits=False, refused=refused(e))
        rc = OOM_EXIT
    if dev.type == "cuda":
        rec.update(seconds=time.perf_counter() - t0, peak_allocated_gib=torch.cuda.max_memory_allocated(dev) / GIB,
                   peak_reserved_gib=torch.cuda.max_memory_reserved(dev) / GIB)
    ranks.write(args, rec)
    if rc:
        os._exit(rc)
    dist.destroy_process_group()
    return 0


def sharded(args, argv: list[str], s, dev) -> int:
    """``--sharded N`` from the launching process."""
    from cl_multiview_stereo_tpu_torch.device import card_name
    from cl_multiview_stereo_tpu_torch.parallel.sharded_pipeline import view_block
    from cl_multiview_stereo_tpu_torch.tools import ranks

    try:
        view_block(s.view_num, args.sharded, 0)
    except ValueError as e:
        print(f"memcheck --sharded {args.sharded}: {e}", file=sys.stderr)
        return REFUSED_EXIT
    short = ranks.check_cards(dev, args.sharded)
    if short:
        print(f"memcheck --sharded {args.sharded}: {short}", file=sys.stderr)
        return REFUSED_EXIT
    done = ranks.spawn(MODULE, argv, args.sharded, SHARDED_TIMEOUT_S)
    oom = any(r.returncode == OOM_EXIT for r in done)
    # after a refusal the peers are stopped: killed, with no record
    if not all(r.returncode == 0 or (oom and (r.returncode == OOM_EXIT or r.returncode < 0)) for r in done):
        print(f"memcheck --sharded {args.sharded} failed:\n{ranks.failure(done)}", file=sys.stderr)
        return 1
    recs = [r.record for r in done if r.record is not None]
    for rec in recs:
        print(json.dumps(rec), flush=True)

    def largest(key):
        vals = [r[key] for r in recs if r[key] is not None]
        return max(vals) if vals else None

    out = {"hw": f"{args.h}x{args.w}", "views": s.view_num, "settings": args.overrides,
           "pair_layout": args.pair_layout, "sharded": args.sharded, "backend": recs[0]["backend"],
           "ranks": recs, "peak_allocated_gib": largest("peak_allocated_gib"),
           "peak_reserved_gib": largest("peak_reserved_gib"), "total_gib": None, "seconds": largest("seconds"),
           "fits": None, "card": "cpu"}
    if dev.type == "cuda":
        out.update(card=card_name(), total_gib=torch.cuda.get_device_properties(dev).total_memory / GIB,
                   fits=not oom)
    refusals = [r["refused"] for r in recs if "refused" in r]
    if refusals:
        out["refused"] = refusals[0]
    print(json.dumps(out), flush=True)
    return OOM_EXIT if oom else 0


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    if args.rank is not None:
        return rank_main(args)

    from cl_multiview_stereo_tpu_torch.cli import resolve_device
    from cl_multiview_stereo_tpu_torch.config import SystemSettings
    from cl_multiview_stereo_tpu_torch.device import card_name
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import scene

    dev = resolve_device(args.device)
    s = SystemSettings().replace(**args.overrides)
    if args.sharded:
        return sharded(args, list(sys.argv[1:] if argv is None else argv), s, dev)
    h, w = args.h, args.w
    rec = {"hw": f"{h}x{w}", "views": s.view_num, "settings": args.overrides, "pair_layout": args.pair_layout,
           "peak_allocated_gib": None, "peak_reserved_gib": None, "total_gib": None, "seconds": None,
           "fits": None, "card": "cpu"}
    pipe = MVSPipeline.create(w, h, s, pair_layout=args.pair_layout, device=dev)
    rgb = scene(s, h, w)
    if dev.type == "cpu":
        pipe.run(rgb)
        print(json.dumps(rec), flush=True)
        return 0
    rec.update(card=card_name(), total_gib=torch.cuda.get_device_properties(dev).total_memory / GIB)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        pipe.run(rgb)
        torch.cuda.synchronize(dev)
    except torch.OutOfMemoryError as e:
        rec.update(fits=False, refused=refused(e), seconds=time.perf_counter() - t0)
        rc = OOM_EXIT
    else:
        rec.update(fits=True, seconds=time.perf_counter() - t0)
        rc = 0
    rec.update(peak_allocated_gib=torch.cuda.max_memory_allocated(dev) / GIB,
               peak_reserved_gib=torch.cuda.max_memory_reserved(dev) / GIB)
    print(json.dumps(rec), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
