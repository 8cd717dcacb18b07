"""Shared pieces of the benchmark's own tests: a data root holding a cell
made only of new data files, at a size the CPU runs in seconds."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "mvs_bench"
TINY = "tiny.cell"


def tiny_root(root: Path, limits_from: str = "rig3x3.offline") -> Path:
    """A data root with configuration ``tiny``, traffic ``tinymix`` and
    cell ``tiny.cell`` (a 3x3 rig of 64x96 views), written as new files
    beside a copy of the benchmark file that names only that cell."""
    for d in ("configs", "traffic", "limits"):
        (root / d).mkdir(parents=True, exist_ok=True)
    cfg = json.loads((BENCH / "configs/clmvde-3x3-1080p.json").read_text())
    cfg["image"] = {"width": 96, "height": 64}
    (root / "configs/tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((BENCH / "traffic/offline.json").read_text())
    tr.update(pool=2, check_scenes=2)
    (root / "traffic/tinymix.json").write_text(json.dumps(tr))
    (root / f"limits/{TINY}.json").write_text((BENCH / f"limits/{limits_from}.json").read_text())
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": TINY, "config": "tiny", "traffic": "tinymix", "chips": 1, "why": "a test cell"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY] if "rig3x3.offline" in m["workloads"] else []
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def card():
    """The CUDA device; skips where none is visible (decided here, never
    while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels have no CPU mode)")
    return torch.device("cuda")
