"""st_dadk_tpu: spatio-temporal DeepKriging framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of STLABTW/ST-DADK (the
reference, a PyTorch CPU codebase); it runs on a GPU (and on the CPU for
tests). The compute path is pure
functional JAX: multi-resolution RBF basis embeddings (Wendland C4 / Gaussian /
triangular) over space, Gaussian RBFs over time, an MLP regressor with mean /
quantile / joint multi-quantile heads (including the delta-reparameterized
non-crossing head), and a fully jitted training loop (AdamW, per-group LRs,
warmup+cosine, EMA, early stopping) that runs an entire fit as one XLA program.

Parallelism is lane-batched: repeated experiments and grid-search configs become a
vmapped leading batch axis sharded over a `jax.sharding.Mesh`, replacing the
reference's joblib process fan-out (ref: scripts/train_st_interp.py:2945-2991).
"""

__version__ = "0.1.0"

from st_dadk_tpu.config import ExperimentConfig  # noqa: F401
