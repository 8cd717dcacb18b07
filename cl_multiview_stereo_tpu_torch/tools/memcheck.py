"""Does a configuration fit in the card's memory (port of the JAX package's
``tools/memcheck.py``).

Usage:

  python -m cl_multiview_stereo_tpu_torch.tools.memcheck [H W] [key=val ...] \\
      [--pair-layout packed|view] [--device cuda|cpu]

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
The JAX tool's ``--sharded N`` needs more than one card and is not ported.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import torch

OOM_EXIT = 3
GIB = 2.0**30


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="memcheck")
    ap.add_argument("args", nargs="*", metavar="H W key=val", help="image height and width, then overrides")
    ap.add_argument("--pair-layout", default="packed", choices=("packed", "view"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu (runs, measures nothing)")
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


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)

    from cl_multiview_stereo_tpu_torch.cli import resolve_device
    from cl_multiview_stereo_tpu_torch.config import SystemSettings
    from cl_multiview_stereo_tpu_torch.device import card_name
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import scene

    dev = resolve_device(args.device)
    s = SystemSettings().replace(**args.overrides)
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
        asked = re.search(r"Tried to allocate [\d.]+ \w+", str(e))
        rec.update(fits=False, refused=asked.group(0) if asked else str(e).splitlines()[0],
                   seconds=time.perf_counter() - t0)
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
