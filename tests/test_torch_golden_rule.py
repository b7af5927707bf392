"""The golden bound of ``esn_tpu_torch/tools/golden_run.py`` on the CPU:
``golden_spread.json`` holds the bound that the reference's own runs give
(seeds 1-4 from ``GOLDEN.json`` and the recorded runs), the held-out
seeds 5-8 meet it, and ``check``, ``check_runs`` and ``check_gap`` read
the rule as stated."""
import json
import os

import pytest

from esn_tpu_torch.tools import golden_run as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(seed, miou, tail, epochs=8):
    return {"seed": seed, "miou": miou, "losses": [3.0] * (epochs - 2)
            + [tail] * 2}


@pytest.fixture(scope="module")
def spread():
    return G.load_spread()


@pytest.mark.parametrize("name", list(G.CONFIGS))
def test_spread_bounds_are_the_reference_seeds(spread, name):
    with open(os.path.join(REPO, "GOLDEN.json")) as f:
        golden = json.load(f)
    runs = [golden["results"][name]] + [spread["seeds"][str(s)][name]
                                        for s in (2, 3, 4)]
    assert spread["bounds"][name] == G.spread_bounds(runs)
    assert spread["bounds"][name]["miou_floor"] == G.MIOU_FLOOR
    held = [spread["seeds"][str(s)][name] for s in range(5, 9)]
    assert all(G.check(r, spread["bounds"][name]) == [] for r in held)
    # the floor lies under every reference run
    assert min(r["miou"] for r in runs + held) > G.MIOU_FLOOR


def test_check_reads_ranges_and_floor():
    bound = {"miou": [0.0, 0.5], "tail_loss": [1.0, 2.0], "miou_floor": 0.07}
    assert G.check(_run(1, 0.3, 1.5), bound) == []
    assert len(G.check(_run(1, 0.03, 1.5), bound)) == 1       # the floor
    assert len(G.check(_run(1, 0.6, 2.5), bound)) == 2
    assert G.check(_run(1, 0.3, float("nan")), bound)


def test_check_runs_wants_a_majority():
    bound = {"miou": [0.0, 0.5], "tail_loss": [1.0, 2.0], "miou_floor": 0.07}
    ok, bad = _run(1, 0.3, 1.5), _run(2, 0.3, 2.5)
    assert G.check_runs([ok, ok, bad], bound) == []
    assert G.check_runs([ok, bad, bad], bound) != []
    assert G.check_runs([ok], bound) == [] and G.check_runs([bad], bound)
    assert G.check_runs([ok, bad], bound) != []


def test_check_gap_takes_medians():
    f32 = [_run(1, 0.2, 1.5), _run(2, 0.3, 1.6), _run(3, 0.9, 1.7)]
    low = [_run(1, 0.31, 1.62), _run(2, 0.0, 1.0), _run(3, 0.35, 1.8)]
    limit = {"miou": 0.02, "tail_loss": 0.05}
    assert G.check_gap(low, f32, limit) == []
    assert len(G.check_gap(low, f32, {"miou": 0.001,
                                      "tail_loss": 0.001})) == 2


def test_bf16_gap_limits_cover_every_config():
    assert set(G.BF16_GAP) == set(G.CONFIGS)
    assert all(set(v) == {"miou", "tail_loss"} and min(v.values()) > 0
               for v in G.BF16_GAP.values())


def test_the_cli_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``--device`` defaults to cuda: with no card the tool raises and
    names the CPU's flag, before it builds a fixture or trains."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"--device cpu"):
        G.main(["--configs", "enet", "--seeds", "1"])
    with pytest.raises(SystemExit):     # --write pins the CPU's runs only
        G.main(["--write"])
