"""Trajectory parity gates: every frozen sequence must replay within its
ATE gate of the committed golden fixture (tools/parity.py; the C++
reference is unbuildable in this container, so golden trajectories stand in
— see the tools/parity.py docstring). Also enforces the north star's 'ATE
within 1%' against ground truth per sequence.

Gates scale with path length (max(1.5mm, 1% of path)) so short paths can't
hide >1% regressions behind an absolute gate."""

import json
import os

import numpy as np
import pytest

from tools import parity


@pytest.mark.parametrize("name", list(parity.SEQUENCES))
def test_golden_trajectory_parity(name):
    rep = parity.evaluate(name)

    if "per_seed" in rep:
        # multi-seed gate (production_defaults): per-seed drift vs golden,
        # per-seed truth-ATE blowup cap, per-seed match-quality median, and
        # the MEDIAN truth ATE across draws (single-draw cadence chaos
        # cannot pass/fail the config by luck — PERF.md findings 32/38)
        assert rep["ok"], json.dumps(rep, indent=1)
        return

    assert rep.get("median_ok", True), (
        f"{name}: enabled-obs median error "
        f"{rep['median_enabled_err_px']}px degraded past the fixture's "
        f"{rep['golden_median_px']}px + 0.1 (match quality can rot inside "
        f"the ATE gate)"
    )
    assert rep["ok"], (
        f"{name}: trajectory drifted {rep['ate_vs_golden_mm']}mm vs golden "
        f"(gate {rep['gate_mm']}mm)"
    )
    assert rep["ate_pct_of_path"] <= rep["truth_gate_pct"], (
        f"{name}: ATE {rep['ate_vs_ground_truth_mm']}mm is "
        f"{rep['ate_pct_of_path']}% of path "
        f"(> {rep['truth_gate_pct']}%)"
    )
