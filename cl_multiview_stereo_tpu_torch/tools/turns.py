"""The port's measurement tools, this checkout against another tree (an
unpacked parent commit), each run in its own process, in turns.

Usage:

  python -m cl_multiview_stereo_tpu_torch.tools.turns [--parent DIR] [--turns 1] [--out FILE] \\
      [--same-tools] [--tool "profile_propagate --engine gather" --tool "bench --cell slice --runs 5" ...]

Each ``--tool`` is a module of ``cl_multiview_stereo_tpu_torch.tools`` and
its arguments (default: ``DEFAULT_TOOLS``: sweep 0's components, each
stage's device ms and the slice's graph replays).  A turn runs every tool
in one tree, trees in the order parent, this, this, parent (``--turns``
pairs; without ``--parent`` this tree alone, ``--turns`` times), each with
the tree on ``PYTHONPATH`` and as its working directory, so each builds its
own kernels.  With ``--same-tools`` each tree runs this tree's tool
source (``python <this tree>/cl_multiview_stereo_tpu_torch/tools/<tool>.py``)
on its own package, for a tool option the other tree's tool lacks; the
tool then may use only what both packages have.  Every tool prints one
JSON object as its last line; this
prints one line per run (tree, tool, seconds, that object) and ends with
one JSON object, ``card``, ``order``, ``runs``, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import time
from pathlib import Path

THIS_TREE = Path(__file__).resolve().parents[2]
DEFAULT_TOOLS = ("profile_propagate --engine gather", "profile_stages --cell slice", "bench --cell slice --runs 5")
TOOL_TIMEOUT_S = 900


def run_tool(tree: Path, tool: str, same_tools: bool = False) -> dict:
    """``python -m cl_multiview_stereo_tpu_torch.tools.<tool>`` in ``tree``
    (with ``same_tools``, this tree's source of the tool on ``tree``'s
    package): its last stdout line as JSON; raises when it fails."""
    name, *argv = shlex.split(tool)
    env = dict(os.environ, PYTHONPATH=str(tree))
    module = ([str(THIS_TREE / "cl_multiview_stereo_tpu_torch" / "tools" / f"{name}.py")] if same_tools
              else ["-m", f"cl_multiview_stereo_tpu_torch.tools.{name}"])
    proc = subprocess.run([sys.executable, *module, *argv], cwd=tree,
                          env=env, capture_output=True, text=True, timeout=TOOL_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} in {tree} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="turns")
    ap.add_argument("--parent", type=Path, help="another tree (e.g. an unpacked parent commit)")
    ap.add_argument("--turns", type=int, default=1, help="pairs of runs of each tree")
    ap.add_argument("--tool", action="append", help="a tool and its arguments (repeatable)")
    ap.add_argument("--out", type=Path, help="also write the JSON record here")
    ap.add_argument("--same-tools", action="store_true", help="run this tree's tool sources in every tree")
    args = ap.parse_args(argv)

    import torch

    from cl_multiview_stereo_tpu_torch.device import card_name

    trees = {"this": THIS_TREE} | ({"parent": args.parent.resolve()} if args.parent else {})
    order = []
    for _ in range(args.turns):
        order += ["parent", "this", "this", "parent"] if args.parent else ["this"]
    runs = []
    for i, name in enumerate(order):
        for tool in args.tool or DEFAULT_TOOLS:
            t0 = time.perf_counter()
            rec = run_tool(trees[name], tool, args.same_tools)
            runs.append({"turn": i, "tree": name, "tool": tool, "seconds": time.perf_counter() - t0, "record": rec})
            print(f"[turns] {i} {name} {tool} ({runs[-1]['seconds']:.1f} s): {json.dumps(rec)}", flush=True)
    result = {"card": card_name() if torch.cuda.is_available() else "cpu", "order": order,
              "same_tools": args.same_tools, "runs": runs}
    print(json.dumps(result), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
