"""The highest capture rate an open-loop cell sustains, by a sweep on the card.

    python3 -m mvs_bench.rate_sweep --workload rig3x3.live --seed <n> --rates 30,40,50 [--seconds 10]

Set up as a run of the cell does, then a closed loop for ``--seconds``
(the service rate: scenes a second with one capture in flight), then the
open loop at each rate for ``--seconds``.  One JSON line a rate: the
scenes, the 50th and 95th percentile of capture-to-maps ms, the queue's
mean ms over the first and the last quarter of the window (a backlog that
grows shows as a last quarter far above the first), and the share of
captures that found the loop busy.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mvs_bench import harness


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="mvs_bench.rate_sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(harness.PKG.parent / "BENCHMARK.json", harness.PKG, args.workload)
    st = harness.run_settings(cell)
    harness.load_kernels()
    pool = harness.make_pool(cell, args.seed, dev)
    port = harness.Port(st, cell.config["image"]["width"], cell.config["image"]["height"], dev)
    loop = harness.Loop(port.forward, pool, 0, args.seed, dev)
    for j in range(len(pool)):
        loop.scene(j, sample=False)
    recs = loop.closed(args.seconds, sample=False)
    service = len(recs) / (recs[-1][2] - recs[0][1])
    print(json.dumps({"closed_loop_scenes_per_s": service, "scenes": len(recs)}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        recs, late = loop.open(rate, args.seconds, sample=False)
        scene = np.array([1e3 * (d - due) for due, _, d in recs])
        queue = np.array([1e3 * (s - due) for due, s, _ in recs])
        q = max(1, len(recs) // 4)
        print(json.dumps({"rate_per_s": rate, "load": rate / service, "scenes": len(recs),
                          "scene_ms_p50": float(np.percentile(scene, 50)),
                          "scene_ms_p95": float(np.percentile(scene, 95)),
                          "queue_ms_first_quarter": float(queue[:q].mean()),
                          "queue_ms_last_quarter": float(queue[-q:].mean()),
                          "found_busy": 1.0 - len(late) / len(recs)}), flush=True)


if __name__ == "__main__":
    main()
