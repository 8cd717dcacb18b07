"""``tools.memcheck --sharded N`` (the JAX tool's ``--sharded``) on the
CPU: two gloo ranks run the view-sharded pipeline and print their records
with null peaks, then the largest; a view count that does not split over
the ranks, and ``--device cuda`` without a card, start no rank."""

import json

import pytest

from cl_multiview_stereo_tpu_torch.tools import memcheck, ranks

SMALL = ["36", "64", "array_width=2", "array_height=2", "min_disp=4", "max_disp=11"]


@pytest.fixture
def no_spawn(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(ranks, "spawn", refuse)


@pytest.mark.parametrize("layout", ["packed", "view"])
def test_two_gloo_ranks(layout, capsys):
    assert memcheck.main([*SMALL, "--sharded", "2", "--pair-layout", layout, "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["rank"] for r in lines[:2]] == [0, 1] and len(lines) == 3
    for r in lines[:2]:
        assert r["backend"] == "gloo" and r["peak_allocated_gib"] is None and r["peak_reserved_gib"] is None
        assert r["fits"] is None and r["seconds"] is None
    last = lines[-1]
    assert last["ranks"] == lines[:2] and last["sharded"] == 2 and last["backend"] == "gloo"
    assert last["views"] == 4 and last["hw"] == "36x64" and last["pair_layout"] == layout
    assert last["peak_allocated_gib"] is None and last["peak_reserved_gib"] is None and last["card"] == "cpu"


def test_views_must_split_over_the_ranks(no_spawn, capsys):
    assert memcheck.main([*SMALL, "--sharded", "3", "--device", "cpu"]) == memcheck.REFUSED_EXIT
    err = capsys.readouterr().err
    assert "4 views do not split over 3 ranks" in err


def test_cuda_without_a_card_raises(no_spawn):
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        memcheck.main([*SMALL, "--sharded", "2", "--device", "cuda"])


def test_more_ranks_than_cards_are_refused(monkeypatch):
    """On a card: one rank a card, so a second rank on one card is refused
    (NCCL refuses two ranks on one device) instead of moved to gloo."""
    monkeypatch.setattr(ranks.torch.cuda, "device_count", lambda: 1)
    cuda = ranks.torch.device("cuda")
    assert ranks.check_cards(cuda, 1) is None
    assert "2 ranks need 2 cards" in ranks.check_cards(cuda, 2)
    assert ranks.check_cards(ranks.torch.device("cpu"), 8) is None
