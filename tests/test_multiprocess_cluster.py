"""REAL multi-process run of the vmapped engine (2-process CPU cluster).

The other multihost tests exercise layout logic with fakes and single-
process degradations; this one actually forms a jax.distributed cluster of
two processes x 4 virtual CPU devices (8 global), runs the full
run_multiple_experiments vmap engine across it, and checks:

  - every lane's artifact set lands on disk (each process wrote only its
    addressable lanes; a fetch of non-owned rows hard-errors, so a clean
    run is itself evidence of correct gating),
  - the primary process aggregated all lanes, the non-primary none,
  - per-experiment metrics equal a plain single-process run of the same
    config (same seeds -> same masks/inits; lane math is device-layout
    independent),
  - a data-parallel fit whose per-step all-reduce crosses the process
    boundary matches the same fit on a single-process 8-device mesh.

M=6 lanes over 8 devices also covers the padded tail: process 1 owns lane
rows 4..8 of the padded axis but only experiments 5 and 6 are real.

Configs/synthetic data are imported from tests/mp_cluster_worker.py so the
cluster workers and the in-process parity runs share ONE definition.
"""
import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

# Workers hard-set JAX_PLATFORMS=cpu, so the in-process parity runs (vmap
# engine + the DP fit at the bottom) must also be CPU — on another backend
# the precision mismatch blows the rtol=1e-4 bounds. The DP comparison
# additionally needs this process to hold an 8-device mesh.
pytestmark = pytest.mark.skipif(
    len(jax.devices()) != 8 or jax.devices()[0].platform != "cpu",
    reason="needs the virtual 8-device CPU mesh (cluster workers force "
           "CPU)")

REPO = Path(__file__).resolve().parent.parent

_spec = importlib.util.spec_from_file_location(
    "mp_cluster_worker", REPO / "tests" / "mp_cluster_worker.py")
worker_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker_mod)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def toy_csv(tmp_path):
    rng = np.random.default_rng(5)
    coords = rng.uniform(size=(30, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 11):
        for s in range(30):
            z = np.sin(3 * coords[s, 0]) - 0.2 * coords[s, 1] \
                + 0.05 * t + rng.normal(0, 0.05)
            lines.append(f"{coords[s,0]},{coords[s,1]},{t},{z:.6f}")
    p = tmp_path / "toy.csv"
    p.write_text("\n".join(lines))
    return p


def test_two_process_cluster_runs_gated_engine(toy_csv, tmp_path):
    port = _free_port()
    out_mp = tmp_path / "mp"
    worker = REPO / "tests" / "mp_cluster_worker.py"
    M = worker_mod.N_EXPERIMENTS
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", str(port),
             str(toy_csv), str(out_mp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            # clean env: the conftest's 8-device XLA_FLAGS must not leak in
            env={k: v for k, v in os.environ.items()
                 if k not in ("XLA_FLAGS", "JAX_PLATFORMS",
                              "JAX_PLATFORM_NAME")},
            cwd=str(REPO))
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            outs.append(out)
    except subprocess.TimeoutExpired:
        # outs holds only the procs whose communicate() finished; kill the
        # rest, then drain their buffered output so the failure report
        # actually shows what the hung workers printed.
        for p in procs[len(outs):]:
            p.kill()
        for p in procs[len(outs):]:
            try:
                out, _ = p.communicate(timeout=30)
            except Exception:
                out = "<output unrecoverable>"
            outs.append(f"--- killed worker {len(outs)} ---\n{out or ''}")
        pytest.fail("cluster workers timed out\n" + "\n".join(outs))
    dp_vals = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"[p{pid}] OK" in out
        dp_vals.append(float(out.split(f"[p{pid}] DPVAL=")[1].split()[0]))
    # the cross-process gradient all-reduce gives both processes the same fit
    assert dp_vals[0] == dp_vals[1]

    # every lane's artifacts exist (written by two different processes)
    mp_results = {}
    for i in range(1, M + 1):
        f = out_mp / "experiments" / str(i) / "results.json"
        assert f.exists(), f"missing lane {i} results"
        with open(f) as fh:
            mp_results[i] = json.load(fh)
    with open(out_mp / "summary" / "summary_statistics.json") as fh:
        summary = json.load(fh)
    assert summary["n_experiments"] == M

    # single-process run of the identical config for value parity
    from st_dadk_tpu.config import ExperimentConfig
    from st_dadk_tpu.train.runner import run_multiple_experiments

    cfg = ExperimentConfig.from_dict({
        **worker_mod.CFG_DICT,
        "data_file": str(toy_csv), "save_artifacts": False,
    })
    out_sp = tmp_path / "sp"
    run_multiple_experiments(cfg, out_sp, engine="vmap")
    for i in range(1, M + 1):
        with open(out_sp / "experiments" / str(i) / "results.json") as fh:
            sp = json.load(fh)
        assert np.isclose(mp_results[i]["test_rmse"], sp["test_rmse"],
                          rtol=1e-4), (i, mp_results[i]["test_rmse"],
                                       sp["test_rmse"])
        assert mp_results[i]["experiment_seed"] == sp["experiment_seed"]

    # the workers' cross-process DP fit vs the same fit on this process's
    # own 8-device mesh (same program; only the process boundary inside
    # the all-reduce differs)
    import jax
    from jax.sharding import Mesh

    from st_dadk_tpu.models.st_interp import init_model, spec_from_config
    from st_dadk_tpu.train.loop import fit

    dp_cfg = ExperimentConfig.from_dict(worker_mod.DP_CFG_DICT)
    dp_spec = spec_from_config(dp_cfg)
    dp_params, dp_consts = init_model(jax.random.PRNGKey(42), dp_spec)
    res = fit(dp_cfg, dp_spec, dp_params, dp_consts,
              worker_mod.synth_pointset(512, 0),
              worker_mod.synth_pointset(128, 1), seed=42,
              mesh=Mesh(np.array(jax.devices()), ("data",)))
    assert np.isclose(dp_vals[0], float(res.history["val_rmse"][-1]),
                      rtol=1e-4, atol=1e-5)

    # phase-3 artifacts: engine='dp' lockstep fits, written once by the
    # primary, aggregated once
    dp_out = Path(str(out_mp) + "_dp")
    for e in (1, 2):
        assert (dp_out / "experiments" / str(e) / "results.json").exists()
    with open(dp_out / "summary" / "summary_statistics.json") as fh:
        assert json.load(fh)["n_experiments"] == 2
