"""chip_smoke.py's phases as functions at a tiny size on the CPU mesh, and
its refusal to run without a GPU or outside the checkout."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

TINY = dict(k_spatial_centers=[4, 9], k_temporal_centers=[3, 5],
            hidden_dims=[16, 8], batch_size=64, obs_ratio=0.5)
LANES = 4


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("chip_smoke")


@pytest.fixture(scope="module")
def field(work):
    return cs.phase_data(work, shape=(6, 40), seed=3)


@pytest.fixture(scope="module")
def main_results(field, work):
    return cs.phase_main(field, work, cs.CompileClock(), n_lanes=LANES,
                         epochs=4, patience=2, **TINY)


def test_phase_data_writes_field(field):
    head = field.read_text().splitlines()
    assert head[0] == "x,y,t,z" and len(head) == 1 + 6 * 40


def test_phase_main_reports_every_lane(main_results, capsys):
    assert [r["experiment_id"] for r in main_results] == list(
        range(1, LANES + 1))
    for r in main_results:
        assert np.isfinite(r["test_crps"]) and np.isfinite(r["test_rmse"])
        assert 1 <= r["n_epochs_run"] <= 4


def test_phase_reference_within_tolerance(field, work):
    report = cs.phase_reference(field, work, n_lanes=LANES, epochs=4,
                                patience=2, **TINY)
    assert set(report) == {"initial/default", "trained/default",
                           "initial/highest", "trained/highest"}
    assert all(cs.within(m, cs.TOL_HIGHEST) for m in report.values())


def test_phase_tf32_compares_crps_means(field, work, main_results):
    out = cs.phase_tf32(field, work, main_results, n_lanes=LANES, epochs=4,
                        patience=2, **TINY)
    # the suite already runs at "highest", so both runs are the same
    assert out["diff"] == 0.0 and out["bound"] > 0.0


def test_phase_four_cards_matches_one_card(field, work):
    rows = cs.phase_four_cards(field, work, n_lanes=8, epochs=3, **TINY)
    assert [r["lane"] for r in rows] == list(range(1, 9))
    # the CPU backend sums in the same order on either mesh
    assert all(r["loss_rel"] == 0.0 and r["param_dist"] == 0.0 for r in rows)
    assert all(r["param_dist_other"] > 0.1 for r in rows)


@pytest.mark.parametrize("measured, tol, ok", [
    ({"pred_abs": 1e-3, "grad_cos": 0.9999}, cs.TOL_DEFAULT, True),
    ({"pred_abs": 5e-2, "grad_cos": 0.9999}, cs.TOL_DEFAULT, False),
    ({"pred_abs": 1e-3, "grad_cos": 0.99}, cs.TOL_DEFAULT, False),
    ({"pred_abs": 1e-5, "loss_rel": 2e-5}, cs.TOL_HIGHEST, False),
])
def test_within(measured, tol, ok):
    assert cs.within(measured, tol) is ok


def test_compare_measures_disagreement():
    pred = np.ones((5, 3))
    grad = {"w": np.ones(4)}
    same = cs.compare({"pred": pred, "loss": 2.0, "grad": grad},
                      {"pred": pred, "loss": 2.0, "grad": grad})
    assert same == {"pred_abs": 0.0, "loss_rel": 0.0, "grad_rel": 0.0,
                    "grad_cos": 1.0}
    off = cs.compare({"pred": pred, "loss": 2.0, "grad": grad},
                     {"pred": pred + 0.1, "loss": 2.2,
                      "grad": {"w": -np.ones(4)}})
    assert off["pred_abs"] == pytest.approx(0.1)
    assert off["loss_rel"] == pytest.approx(0.1)
    assert off["grad_cos"] == pytest.approx(-1.0)


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu():
    r = _run(REPO / "chip_smoke.py", REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_fails_outside_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    r = _run(lone, tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    last = (r.stdout.strip().splitlines() or [""])[-1]
    with pytest.raises(json.JSONDecodeError):
        json.loads(last)
