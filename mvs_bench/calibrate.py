"""The readings that a cell's check limits are set from, in one process.

    python3 -m mvs_bench.calibrate --workload <cell> --seeds 11,12,... [--control-seeds 11,12,13] \\
        [--faults 11,12,13]

For each seed: the traffic's pool of captures, and ``check_scenes`` of them
drawn from the seed, each through the timed path (``jitted()``'s replay at
the cell's sizes, its maps copied to pinned host memory) and through the
plain reference; the numbers of ``judge.compare`` between the two are the
program's readings.  On the control seeds the reference in bfloat16
(``reference.run(lowp=True)``) is judged the same way: the control's
readings.  On the fault seeds the timed path's output is judged with one
fault planted at a time: a refined state left as the init's (``d``, ``n``
of ``disp_init`` and fronto-parallel normals, the maps rasterized from
them), half the views' maps left out (zeros), and one view's maps a pixel
off.  One JSON line a (seed, side), and the time the reference took.
"""

from __future__ import annotations

import argparse
import json
import random
import time

import torch

from mvs_bench import harness, judge, reference

FAULTS = ("state_unchanged", "half_the_views_left_out", "answer_altered")


def planted(fault: str, got: dict) -> dict:
    """``got`` with ``fault`` planted where the program produces it."""
    out = dict(got)
    if fault == "state_unchanged":
        d = got["disp_init"].clone()
        n = torch.zeros(d.shape + (3,), dtype=torch.float32, device=d.device)
        n[..., 2] = 1.0
        out.update(d=d, n=n, disp_full=reference.rasterize_planes(got["labels"], got["center"], d, n).cpu())
    elif fault == "half_the_views_left_out":
        full = got["disp_full"].clone()
        full[full.shape[0] // 2:] = 0.0
        out["disp_full"] = full
    else:
        full = got["disp_full"].clone()
        full[0] += 1.0
        out["disp_full"] = full
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="mvs_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    ints = lambda text: [int(x) for x in text.split(",") if x]  # noqa: E731
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(harness.PKG.parent / "BENCHMARK.json", harness.PKG, args.workload)
    st = harness.run_settings(cell)
    w, h = cell.config["image"]["width"], cell.config["image"]["height"]
    harness.load_kernels()
    port = harness.Port(st, w, h, dev)
    ref_st = reference.Settings.from_dict(st)
    control, faults = set(ints(args.control_seeds)), set(ints(args.faults))
    for seed in ints(args.seeds):
        pool = harness.make_pool(cell, seed, dev)
        picks = random.Random(seed).sample(range(len(pool)), min(cell.traffic["check_scenes"], len(pool)))
        sides: dict[str, list] = {"program": []}
        took = []
        for j in picks:
            art = port.forward(pool[j])
            host = torch.empty(art.disp_full.shape, dtype=torch.float32, pin_memory=True)
            host.copy_(art.disp_full)
            got = harness.artifacts(art, host)
            cap = pool[j].to(dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            want = reference.run(cap, ref_st)
            torch.cuda.synchronize()
            took.append(time.perf_counter() - t)
            sides["program"].append(judge.compare(got, want))
            if seed in control:
                low = reference.run(cap, ref_st, lowp=True)
                sides.setdefault("control", []).append(judge.compare(low._asdict(), want))
            if seed in faults:
                for f in FAULTS:
                    sides.setdefault(f, []).append(judge.compare(planted(f, got), want))
            del art, got, want
        for side, readings in sides.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side, "captures": picks,
                              "reference_s": took, "numbers": judge.worst(readings)}), flush=True)


if __name__ == "__main__":
    main()
