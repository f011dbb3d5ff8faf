"""On the card only (marked ``cuda``; skipped without one): each cell run
end to end at a small size through the program's kernels comes out
correct, and its traced run reads every per-layer metric.

    python -m pytest --noconftest -q -m cuda perfbench/tests/test_pb_card.py
"""
from __future__ import annotations

import pytest

from perfbench.run import ROOT, run_cell

SMALL = {"width": 160, "height": 90}


@pytest.fixture
def card(monkeypatch):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    monkeypatch.chdir(ROOT)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["bunny-128spp", "rtow-100spp"])
@pytest.mark.parametrize("traced", [False, True])
def test_small_run_on_the_card(card, workload, traced):
    result = run_cell(workload, 2147483701, 2.0, traced,
                      config_override=dict(SMALL, spp=8))
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    names = set(result["metrics"])
    if traced:
        assert {"syncs_per_msample", "launches_per_msample",
                "closest_hit_roofline", "device_idle"} <= names
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    else:
        assert {"msamples_per_s", "setup_s"} <= names
