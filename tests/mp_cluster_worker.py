"""Worker process for the REAL 2-process jax.distributed cluster test.

Launched by tests/test_multiprocess_cluster.py as
    python tests/mp_cluster_worker.py <pid> <nprocs> <port> <csv> <out_dir>

Each process brings 4 virtual CPU devices (8 global), joins the cluster,
and runs the SAME run_multiple_experiments call — the engine shards the
lane axis over the global mesh, each process writes only its own lanes'
artifacts (batch_engine._owned_lane_slice), and the primary aggregates.
Phase 2 runs one data-parallel fit over the global mesh (the per-step
gradient all-reduce crosses the process boundary).

The config dicts and synthetic data builder live at module level so the
test imports THE SAME definitions for its single-process parity runs
(import is side-effect-free; all cluster setup happens in main()).
"""
N_EXPERIMENTS = 6

CFG_DICT = dict(
    tag="mpcluster",
    k_spatial_centers=[9], k_temporal_centers=[4],
    hidden_dims=[16, 8], dropout=0.0, epochs=6, lr=5e-3,
    batch_size=64, patience=50, warmup_epochs=1, scheduler="cosine",
    grad_clip=10.0, regression_type="mean",
    obs_method="site-wise", obs_ratio=0.5, obs_spatial_pattern="uniform",
    split_method="random", train_ratio=0.8,
    n_experiments=N_EXPERIMENTS, base_seed=700,
    save_plots=False, save_artifacts=True,
)

DP_CFG_DICT = dict(
    k_spatial_centers=[16], k_temporal_centers=[5], hidden_dims=[32, 16],
    dropout=0.0, epochs=6, lr=1e-2, batch_size=64, patience=100,
    warmup_epochs=2, scheduler="cosine", grad_clip=10.0, weight_decay=1e-5,
    regression_type="mean",
)


def synth_pointset(n, seed):
    import numpy as np

    from st_dadk_tpu.dataio.arrays import PointSet

    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    t = rng.uniform(size=(n, 1)).astype(np.float32)
    y = (np.sin(3 * coords[:, :1]) + np.cos(2 * coords[:, 1:2]) + 0.5 * t
         ).astype(np.float32)
    return PointSet(coords=coords, t=t, y=y, w=np.ones(n, np.float32),
                    n_real=n)


def main():
    import os
    import sys

    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    csv_path, out_dir = sys.argv[4], sys.argv[5]

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_PLATFORM_NAME"] = "cpu"
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_enable_fast_math=false")
    os.environ["JAX_ENABLE_X64"] = "0"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nprocs, process_id=pid)
    assert jax.process_count() == nprocs
    assert len(jax.devices()) == 4 * nprocs

    import numpy as np
    from jax.sharding import Mesh

    from st_dadk_tpu.config import ExperimentConfig
    from st_dadk_tpu.models.st_interp import init_model, spec_from_config
    from st_dadk_tpu.train.loop import fit
    from st_dadk_tpu.train.runner import run_multiple_experiments

    cfg = ExperimentConfig.from_dict({**CFG_DICT, "data_file": csv_path})
    summary = run_multiple_experiments(cfg, out_dir, engine="vmap")
    if pid == 0:
        assert summary is not None \
            and summary["n_experiments"] == N_EXPERIMENTS, summary
    else:
        assert summary is None, "non-primary must not aggregate"

    # streaming setup guarantee: this process synthesized ONLY its own
    # lanes (owned real lanes + at most one pad-source), never the full
    # M=6 stack. With 2 procs x 4 devices: p0 owns lanes 1-4, p1 owns 5-6.
    from st_dadk_tpu.train.experiment import ExperimentSetup
    owned = 4 if pid == 0 else 2
    assert ExperimentSetup.n_constructed <= owned + 1, (
        f"p{pid} built {ExperimentSetup.n_constructed} setups "
        f"(> owned {owned} + 1): streaming setup regressed")

    # phase 2: one DP fit over the GLOBAL 8-device mesh
    dp_cfg = ExperimentConfig.from_dict(DP_CFG_DICT)
    dp_spec = spec_from_config(dp_cfg)
    dp_params, dp_consts = init_model(jax.random.PRNGKey(42), dp_spec)
    mesh = Mesh(np.array(jax.devices()), ("data",))
    res = fit(dp_cfg, dp_spec, dp_params, dp_consts, synth_pointset(512, 0),
              synth_pointset(128, 1), seed=42, mesh=mesh)
    print(f"[p{pid}] DPVAL={float(res.history['val_rmse'][-1]):.6f}",
          flush=True)

    # phase 3: engine='dp' through the runner — every process drives each
    # fit in lockstep over the global mesh; only the primary writes
    dp_out = out_dir + "_dp"
    dp_run_cfg = ExperimentConfig.from_dict({
        **CFG_DICT, "data_file": csv_path, "n_experiments": 2,
        "save_artifacts": False, "save_plots": False})
    summary = run_multiple_experiments(dp_run_cfg, dp_out, engine="dp")
    if pid == 0:
        assert summary is not None and summary["n_experiments"] == 2, summary
    else:
        assert summary is None
    print(f"[p{pid}] OK", flush=True)


if __name__ == "__main__":
    main()
