"""Run one cell of the benchmark once and print its result line.

    python3 -m mvs_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``mvs_bench/``
and the port (``cl_multiview_stereo_tpu_torch/``), on a machine with the
card the cell asks for; the cells are those of ``BENCHMARK.json`` beside
``mvs_bench/``.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number held to
the plain reference beside its limit.  Standard error ends with the same
numbers, one a line.  Without a card, or with fewer than the cell asks for,
it prints no result and exits 2; where ``jax``, ``jaxlib``, ``flax`` or the
JAX package is loaded in the process once the run is over, it names them on
standard error, prints no result and exits 1.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mvs_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from mvs_bench import harness

    spec = harness.PKG.parent / "BENCHMARK.json"
    chips = {w["name"]: w["chips"] for w in json.loads(spec.read_text())["workloads"]}.get(args.workload)
    if chips is None:
        harness.say(f"no workload {args.workload!r} in {spec}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.say(f"the cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
                    f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}")
        return 2
    torch.set_num_threads(4)
    cell = harness.load_cell(spec, harness.PKG, args.workload)
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                              dev=torch.device("cuda", 0), root=harness.PKG, t_start=T_START)
    found = harness.forbidden_modules()  # the last step before the line: whatever the run loaded counts
    if found:
        harness.say(f"loaded in this process once the window closed: {', '.join(found)}; no result")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
