"""A tool's ranks as processes, for the tools that run the view-sharded
pipeline (``tools.scaling_sweep``, ``tools.memcheck --sharded``).

:func:`spawn` starts one process per rank, each the tool's own module
with the caller's arguments and four more (``--rank``, ``--world``,
``--init``, ``--out``; :func:`add_worker_args` declares them, hidden).  A
rank joins the group through :func:`join`: NCCL on ``cuda``, one rank a
card, or gloo on ``cpu``, meeting through a file in a temporary directory
(no TCP port), and writes its record with :func:`write`.  Nothing falls
back: :func:`check_cards` refuses more ranks than cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import torch

# the package's parent directory, put on each rank's import path
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# seconds the other ranks get to end after one rank has exited non-zero
# (a rank whose peer died waits in a collective until it is killed)
GRACE_S = 10.0
POLL_S = 0.1
LOG_CHARS = 4000


class Rank(NamedTuple):
    returncode: int  # negative: killed (the time limit, or a peer's failure)
    log: str  # the rank's standard output and error
    record: dict | None  # what the rank wrote with :func:`write`, if it did


def add_worker_args(ap: argparse.ArgumentParser) -> None:
    for name, kind in (("--rank", int), ("--world", int), ("--init", str), ("--out", str)):
        ap.add_argument(name, type=kind, help=argparse.SUPPRESS)


def check_cards(device: torch.device, world: int) -> str | None:
    """None when ``world`` ranks can run on ``device``, else why not: on
    ``cuda`` each rank takes its own card (NCCL refuses two ranks on one)."""
    if device.type == "cuda" and world > torch.cuda.device_count():
        return (f"{world} ranks need {world} cards (NCCL, one rank a card); "
                f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    return None


def spawn(module: str, argv: list[str], world: int, timeout: float) -> list[Rank]:
    """Run ``python -m module argv`` as ``world`` ranks and wait for them:
    all of them, at most ``timeout`` seconds, and at most GRACE_S after the
    first rank that exits non-zero; the rest are killed."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'init')}"
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
        try:
            procs = [subprocess.Popen(
                [sys.executable, "-m", module, *argv, "--rank", str(r), "--world", str(world), "--init", init,
                 "--out", outs[r]], stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=ROOT)
                for r in range(world)]
            try:
                deadline, failed_at = time.monotonic() + timeout, None
                while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                    if failed_at is None and any(p.poll() not in (None, 0) for p in procs):
                        failed_at = time.monotonic()
                    if failed_at is not None and time.monotonic() - failed_at > GRACE_S:
                        break
                    time.sleep(POLL_S)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                    p.wait()
            ranks = []
            for p, log, out in zip(procs, logs, outs):
                log.seek(0)
                rec = None
                if os.path.exists(out):
                    with open(out) as f:
                        rec = json.load(f)
                ranks.append(Rank(p.returncode, log.read(), rec))
            return ranks
        finally:
            for log in logs:
                log.close()


def failure(ranks: list[Rank]) -> str:
    """Each rank's exit code and the end of its log."""
    return "\n".join(f"rank {r} exited {k.returncode}:\n{k.log[-LOG_CHARS:]}" for r, k in enumerate(ranks))


def join(args, device: torch.device) -> None:
    """Join the tool's group as rank ``args.rank`` of ``args.world``."""
    from cl_multiview_stereo_tpu_torch.parallel import initialize_distributed

    if device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // args.world))
    initialize_distributed(args.init, args.world, args.rank, device=device.type)


def write(args, record: dict) -> None:
    with open(args.out, "w") as f:
        json.dump(record, f)
