"""Headline benchmark: fast-path Gibbs sweeps/s at ML-10M scale.

    python bench.py [n_rows] [rank]

Workload: the ML-10M-shaped one-hot design of ``chip_smoke.make_design``
(10,000,054 rows, 69,878 users x 10,677 items, a date one-hot main
table; user/item RelationBlocks), trained as a Bayesian FM at rank 32
— the structure of the reference's examples/ml-10m-regression.py.

Baseline: the reference C++ engine sweeps the blocked ML-100k problem
at 20 it/s on the author's CPU (doc/source/relation-blocks.rst:199).
Cost scales ~linearly in rows x rank, so its projected ML-10M rank-32
throughput is 20 x (1e5/1e7) x (10/32) ~= 0.0625 sweeps/s.

Runs on one GPU and exits 1 on any other platform; any failure exits
non-zero.  Progress and the secondary numbers go to stderr; the last
line of stdout is one JSON object:
  {"metric": ..., "value": N, "unit": "sweeps/sec", "vs_baseline": N, ...}
The compile cache goes to ``JAX_COMPILATION_CACHE_DIR`` when set, else
to ``.jax_cache`` in the checkout.
"""

import json
import os
import sys
import time

import numpy as np

from chip_smoke import ML10M, card_name_and_power, design_inputs, make_design

REPO = os.path.dirname(os.path.abspath(__file__))
REFERENCE_PROJECTED_SWEEPS_PER_SEC = 0.0625


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _trainer(X, blocks, y, shapes, rank):
    import jax

    from myfm_tpu.design_categorical import try_compile_categorical
    from myfm_tpu.ops.gibbs import GibbsConfig
    from myfm_tpu.trainer import CategoricalGibbsTrainer

    grouping = np.repeat(np.arange(len(shapes)), shapes).astype(np.int32)
    t0 = time.perf_counter()
    plan = try_compile_categorical(
        X, blocks, grouping, None, np.float32, rank=rank,
    )
    assert plan is not None, "the ML-10M design must take the fast path"
    jax.block_until_ready(plan)
    t_design = time.perf_counter() - t0
    tr = CategoricalGibbsTrainer(
        plan, y, GibbsConfig(task="regression"), rank, 0.1, 42,
        np.float32,
    )
    return tr, t_design


def _sweeps_per_sec(tr, n_timed, parts=None):
    """Steady sweeps/s through the trainer's sweep, one scalar fetched
    per sweep (as the fit loop harvests samples every iteration)."""
    import jax

    master = jax.random.PRNGKey(42)
    t0 = time.perf_counter()
    state = tr._initialize(jax.random.fold_in(master, 0))
    float(state.core.alpha)
    t1 = time.perf_counter()
    state = tr._sweep_call(state, jax.random.fold_in(master, 1))
    float(state.core.alpha)
    t2 = time.perf_counter()
    if parts is not None:
        parts["ttfs_init_s"] = t1 - t0
        parts["ttfs_first_sweep_s"] = t2 - t1
    t0 = time.perf_counter()
    for it in range(2, 2 + n_timed):
        state = tr._sweep_call(state, jax.random.fold_in(master, it))
        float(state.core.alpha)
    return n_timed / (time.perf_counter() - t0), state


def _predict_rows_per_sec(X, blocks, rank, state, n_samples=8):
    """Posterior-averaged serving through ``Predictor.predict`` with
    n_samples kept FMs; the second (warm) call is the number."""
    from myfm_tpu.containers import FM
    from myfm_tpu.predictor import Predictor

    core = state.core
    w0, w, V = float(core.w0), np.asarray(core.w), np.asarray(core.V)
    pred = Predictor(rank, w.shape[0], "regression", np.float32)
    for k in range(n_samples):
        pred.samples.append(FM(w0 + 1e-6 * (k + 1), w, V, []))
    pred.predict(X, blocks)
    t0 = time.perf_counter()
    out = pred.predict(X, blocks)
    float(out[0])
    return n_samples * X.shape[0] / (time.perf_counter() - t0)


def _vi_sweeps_per_sec(X, blocks, y, shapes, rank, n_timed=5):
    from myfm_tpu.design_categorical import try_compile_categorical
    from myfm_tpu.ops.variational import VariationalConfig
    from myfm_tpu.vi_trainer import CategoricalVITrainer

    grouping = np.repeat(np.arange(len(shapes)), shapes).astype(np.int32)
    plan = try_compile_categorical(
        X, blocks, grouping, None, np.float32, rank=3 * rank,
    )
    tr = CategoricalVITrainer(
        plan, y, VariationalConfig(task="regression"), rank, 0.1, 42,
        np.float32,
    )
    state = tr._initialize()

    def sweep(state):
        state = tr._sweep(
            tr.plan, state, tr.y, tr.y_tiles, tr.cfg, tr._gram_impl
        )
        float(state.core.elbo)
        return state

    state = sweep(state)
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state = sweep(state)
    return n_timed / (time.perf_counter() - t0)


def main() -> int:
    n_rows = int(sys.argv[1]) if len(sys.argv) > 1 else ML10M["n_rows"]
    rank = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    n_timed = 20

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench.py needs a GPU; JAX found {dev.platform}")
        return 1
    card = card_name_and_power()
    log(f"device: {dev.device_kind}; nvidia-smi: {card}")

    shape = dict(ML10M, n_rows=n_rows)
    t0 = time.perf_counter()
    users, items, days, y = make_design(**shape, seed=0)
    X, blocks, y, shapes = design_inputs(
        users, items, days, y, shape["n_users"], shape["n_items"],
        shape["n_days"],
    )
    log(f"data generated in {time.perf_counter() - t0:.1f}s")

    parts = {}
    tr, parts["ttfs_design_s"] = _trainer(X, blocks, y, shapes, rank)
    sps, state = _sweeps_per_sec(tr, n_timed, parts)
    log(f"fast path rank {rank}: {sps:.3f} sweeps/s "
        f"(gram={tr._gram_impl})")
    detail = dict(parts)
    detail["predict_rows_per_sec"] = _predict_rows_per_sec(
        X, blocks, rank, state
    )
    del tr, state
    tr128, _ = _trainer(X, blocks, y, shapes, 128)
    detail["fastpath_rank128_sweeps_per_sec"], _ = _sweeps_per_sec(
        tr128, 5
    )
    del tr128
    detail["vi_sweeps_per_sec"] = _vi_sweeps_per_sec(
        X, blocks, y, shapes, rank
    )
    log(f"detail: {json.dumps(detail)}")
    log(f"nvidia-smi: {card_name_and_power()}")
    print(json.dumps({
        "metric": (f"Gibbs sweeps/sec, ML-10M-shaped ({n_rows} rows, "
                   f"rank {rank}, user/item RelationBlocks + date one-hot)"),
        "value": sps,
        "unit": "sweeps/sec",
        "vs_baseline": sps / REFERENCE_PROJECTED_SWEEPS_PER_SEC,
        "device": dev.device_kind,
        "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
