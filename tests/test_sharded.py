"""Multi-chip parity: the sharded chain must reproduce the single-chip
chain sample-for-sample (the 'distributed tests' analogue of the
reference's blocked ≡ flattened contract, SURVEY §4)."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from myfm_tpu import MyFMGibbsRegressor
from myfm_tpu.ops.gibbs import GibbsConfig
from myfm_tpu.parallel.sharding import ShardedGibbsTrainer

from .test_block import _make_relational_problem


@pytest.mark.parametrize(
    "n_devices,max_unrolled", [(2, 16), (4, 16), (2, 0)]
)
def test_sharded_equals_single_chip(n_devices, max_unrolled):
    # max_unrolled=0 forces the ColorStack scans (incl. the incremental
    # block-aggregate path) on both sides, so the psum-once-per-stack
    # SPMD statistics are exercised too.
    X_main, blocks, y = _make_relational_problem(seed=13, n_rows=402)
    # 402 rows: deliberately NOT divisible by 4 to exercise row padding

    # "colored" explicitly: this test pins the chromatic machinery's
    # SPMD parity (the estimator's "auto" resolves this design to the
    # joint engine, which has its own sharded parity test below)
    fm = MyFMGibbsRegressor(
        rank=2, random_seed=7, dtype=np.float64,
        max_unrolled_colors=max_unrolled, sweep_strategy="colored",
    ).fit(X_main, y, X_rel=blocks, n_iter=8, n_kept_samples=8)

    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("data",))
    trainer = ShardedGibbsTrainer(
        X_main, blocks, y,
        GibbsConfig(task="regression"),
        rank=2, init_stdev=0.1, random_seed=7,
        mesh=mesh, dtype=np.float64,
        max_unrolled_colors=max_unrolled,
    )
    pred, _ = trainer.run(8, 8)

    assert len(pred.samples) == 8
    for s_n, fm_sample in zip(pred.samples, fm.predictor_.samples):
        np.testing.assert_allclose(s_n.w0, fm_sample.w0, rtol=1e-8)
        np.testing.assert_allclose(s_n.w, fm_sample.w, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(s_n.V, fm_sample.V, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_categorical_equals_single_chip(n_dev):
    """Fast-path SPMD: per-shard partial Grams psum to the global
    statistics, so the sharded chain matches single-chip up to float
    reassociation (f64 here -> ~1e-12)."""
    import scipy.sparse as sps

    from myfm_tpu import RelationBlock
    from myfm_tpu.design_categorical import try_compile_categorical
    from myfm_tpu.ops.gibbs import GibbsConfig
    from myfm_tpu.parallel.sharding_categorical import (
        ShardedCategoricalGibbsTrainer,
    )
    from myfm_tpu.trainer import CategoricalGibbsTrainer

    rng = np.random.RandomState(3)
    n, nu, ni = 777, 23, 17  # deliberately not divisible by n_dev
    u, i = rng.randint(0, nu, n), rng.randint(0, ni, n)
    y = (
        rng.normal(size=nu)[u] + rng.normal(size=ni)[i]
        + 0.3 * rng.normal(size=n)
    )
    blocks = [
        RelationBlock(u, sps.identity(nu, format="csr")),
        RelationBlock(i, sps.identity(ni, format="csr")),
    ]
    cfg = GibbsConfig(task="regression")

    plan1 = try_compile_categorical(
        None, blocks, None, None, np.float64, rank=2
    )
    tr1 = CategoricalGibbsTrainer(plan1, y, cfg, 2, 0.1, 7, np.float64)
    p1, _ = tr1.run(8, 8)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    tr_n = ShardedCategoricalGibbsTrainer(
        None, blocks, y, cfg, 2, 0.1, 7, mesh=mesh, dtype=np.float64
    )
    pred_n, _ = tr_n.run(8, 8)
    for a, b in zip(p1.samples, pred_n.samples):
        np.testing.assert_allclose(a.w0, b.w0, rtol=1e-9)
        np.testing.assert_allclose(a.w, b.w, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(a.V, b.V, rtol=1e-8, atol=1e-10)


def _make_categorical_problem(seed=3, n=777, nu=23, ni=17):
    import scipy.sparse as sps

    from myfm_tpu import RelationBlock

    rng = np.random.RandomState(seed)
    u, i = rng.randint(0, nu, n), rng.randint(0, ni, n)
    score = (
        rng.normal(size=nu)[u] + rng.normal(size=ni)[i]
        + 0.3 * rng.normal(size=n)
    )
    blocks = [
        RelationBlock(u, sps.identity(nu, format="csr")),
        RelationBlock(i, sps.identity(ni, format="csr")),
    ]
    return blocks, score


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_categorical_classification_parity(n_dev):
    """Sharded fast-path probit classification must reproduce the
    single-chip chain sample-for-sample: the latent truncated-normal
    draws slice one globally drawn uniform vector, and pad-row
    residuals are masked out of (Σe, Σe²) (advisor finding)."""
    from myfm_tpu.design_categorical import try_compile_categorical
    from myfm_tpu.ops.gibbs import GibbsConfig
    from myfm_tpu.parallel.sharding_categorical import (
        ShardedCategoricalGibbsTrainer,
    )
    from myfm_tpu.trainer import CategoricalGibbsTrainer

    # n=401: NOT divisible by n_dev -> exercises SPMD pad rows
    blocks, score = _make_categorical_problem(seed=5, n=401)
    y = np.where(score > 0, 1.0, -1.0)
    cfg = GibbsConfig(task="classification")

    plan1 = try_compile_categorical(
        None, blocks, None, None, np.float64, rank=2
    )
    tr1 = CategoricalGibbsTrainer(plan1, y, cfg, 2, 0.1, 7, np.float64)
    p1, _ = tr1.run(6, 6)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    tr_n = ShardedCategoricalGibbsTrainer(
        None, blocks, y, cfg, 2, 0.1, 7, mesh=mesh, dtype=np.float64
    )
    pred_n, _ = tr_n.run(6, 6)
    for a, b in zip(p1.samples, pred_n.samples):
        np.testing.assert_allclose(a.w0, b.w0, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a.w, b.w, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(a.V, b.V, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n_dev", [2])
def test_sharded_categorical_ordered_parity(n_dev):
    """Sharded fast-path ordered probit: the cutpoint MH objective is
    psum-reduced globally with a common proposal key, so every device
    takes the identical accept decision and cutpoints stay replicated
    (advisor finding: per-shard decisions silently diverged)."""
    from myfm_tpu.design_categorical import try_compile_categorical
    from myfm_tpu.ops.gibbs import GibbsConfig
    from myfm_tpu.parallel.sharding_categorical import (
        ShardedCategoricalGibbsTrainer,
    )
    from myfm_tpu.trainer import CategoricalGibbsTrainer

    blocks, score = _make_categorical_problem(seed=11, n=403)
    y = np.digitize(score, [-1.0, 0.0, 1.0]).astype(np.int32)  # 4 classes
    cfg = GibbsConfig(task="ordered", n_class=4)

    plan1 = try_compile_categorical(
        None, blocks, None, None, np.float64, rank=2
    )
    tr1 = CategoricalGibbsTrainer(plan1, y, cfg, 2, 0.1, 7, np.float64)
    p1, _ = tr1.run(6, 6)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    tr_n = ShardedCategoricalGibbsTrainer(
        None, blocks, y, cfg, 2, 0.1, 7, mesh=mesh, dtype=np.float64
    )
    pred_n, _ = tr_n.run(6, 6)
    for a, b in zip(p1.samples, pred_n.samples):
        np.testing.assert_allclose(a.w0, b.w0, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a.w, b.w, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(a.V, b.V, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(
            a.cutpoints[0], b.cutpoints[0], rtol=1e-8, atol=1e-10
        )


@pytest.mark.parametrize("n_dev", [2])
def test_sharded_colored_ordered_parity(n_dev):
    """Ordered probit on the colored (general-design) sharded path."""
    from myfm_tpu.design import compile_design
    from myfm_tpu.ops.gibbs import GibbsConfig
    from myfm_tpu.trainer import GibbsTrainer

    X_main, blocks, score_y = _make_relational_problem(
        seed=29, n_rows=402
    )
    y = np.digitize(
        score_y, np.quantile(score_y, [0.3, 0.6, 0.85])
    ).astype(np.int32)
    cfg = GibbsConfig(task="ordered", n_class=4)

    plan1 = compile_design(
        X_main, blocks, grouping=None, dtype=np.float64,
        for_training=True,
    )
    tr1 = GibbsTrainer(plan1, y, cfg, 2, 0.1, 7, np.float64)
    p1, _ = tr1.run(6, 6)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    tr_n = ShardedGibbsTrainer(
        X_main, blocks, y, cfg, rank=2, init_stdev=0.1, random_seed=7,
        mesh=mesh, dtype=np.float64,
    )
    pred_n, _ = tr_n.run(6, 6)
    for a, b in zip(p1.samples, pred_n.samples):
        np.testing.assert_allclose(a.w0, b.w0, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a.w, b.w, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(a.V, b.V, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(
            a.cutpoints[0], b.cutpoints[0], rtol=1e-8, atol=1e-10
        )


@pytest.mark.parametrize("n_dev", [2])
def test_sharded_joint_equals_single_chip(n_dev):
    """sweep_strategy='joint' under shard_map: psum'd joint statistics
    must reproduce the single-chip joint chain."""
    from myfm_tpu.gibbs import MyFMGibbsRegressor as _R

    X_main, blocks, y = _make_relational_problem(seed=23, n_rows=402)
    fm = _R(
        rank=2, random_seed=7, dtype=np.float64, sweep_strategy="joint"
    ).fit(X_main, y, X_rel=blocks, n_iter=6, n_kept_samples=6)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    trainer = ShardedGibbsTrainer(
        X_main, blocks, y,
        GibbsConfig(task="regression", joint_rows=True),
        rank=2, init_stdev=0.1, random_seed=7,
        mesh=mesh, dtype=np.float64,
    )
    pred_j, _ = trainer.run(6, 6)
    for s_n, fm_sample in zip(pred_j.samples, fm.predictor_.samples):
        np.testing.assert_allclose(s_n.w0, fm_sample.w0, rtol=1e-8)
        np.testing.assert_allclose(s_n.w, fm_sample.w, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(s_n.V, fm_sample.V, rtol=1e-6, atol=1e-9)


def test_auto_upgrade_consistent_under_n_devices():
    """The 'auto' -> joint engine upgrade must resolve identically on
    the single-chip and sharded cores (same gates), so
    fit(..., n_devices=2) with defaults still reproduces the
    single-chip chain sample-for-sample."""
    X_main, blocks, y = _make_relational_problem(seed=29, n_rows=402)
    kwargs = dict(rank=2, random_seed=11, dtype=np.float64)
    fm1 = MyFMGibbsRegressor(**kwargs).fit(
        X_main, y, X_rel=blocks, n_iter=6, n_kept_samples=6
    )
    fm2 = MyFMGibbsRegressor(n_devices=2, **kwargs).fit(
        X_main, y, X_rel=blocks, n_iter=6, n_kept_samples=6
    )
    np.testing.assert_allclose(
        fm1.w0_samples, fm2.w0_samples, rtol=1e-8
    )
    np.testing.assert_allclose(
        fm1.w_samples, fm2.w_samples, rtol=1e-6, atol=1e-9
    )
    np.testing.assert_allclose(
        fm1.V_samples, fm2.V_samples, rtol=1e-6, atol=1e-9
    )


def test_estimator_n_devices_api():
    """fm.fit(..., n_devices=2) is a first-class estimator feature:
    same samples as the single-chip fit, normal Predictor/History,
    callbacks and hyper trace included (round-1 VERDICT item 4d)."""
    blocks, score = _make_categorical_problem(seed=31, n=401)
    y = score

    fm1 = MyFMGibbsRegressor(
        rank=2, random_seed=9, dtype=np.float64
    ).fit(None, y, X_rel=blocks, n_iter=6, n_kept_samples=6)

    seen = []

    def cb(it, fm, hyper, hist):
        seen.append(it)
        return False, ""

    fm2 = MyFMGibbsRegressor(
        rank=2, random_seed=9, dtype=np.float64, n_devices=2
    ).fit(None, y, X_rel=blocks, n_iter=6, n_kept_samples=6,
          callback=cb)

    assert seen == list(range(6))
    assert len(fm2.predictor_.samples) == 6
    for a, b in zip(fm1.predictor_.samples, fm2.predictor_.samples):
        np.testing.assert_allclose(a.w0, b.w0, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a.w, b.w, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(a.V, b.V, rtol=1e-8, atol=1e-10)
    # normal estimator surface works on the sharded fit
    p1 = fm1.predict(None, X_rel=blocks)
    p2 = fm2.predict(None, X_rel=blocks)
    np.testing.assert_allclose(p1, p2, rtol=1e-7, atol=1e-9)
    tr = fm2.get_hyper_trace()
    assert tr.shape[0] == 6

    # general (non-categorical) designs route to the colored sharded
    # trainer through the same API
    X_main, blocks2, y2 = _make_relational_problem(seed=33, n_rows=202)
    fm3 = MyFMGibbsRegressor(
        rank=2, random_seed=5, dtype=np.float64
    ).fit(X_main, y2, X_rel=blocks2, n_iter=4, n_kept_samples=4)
    fm4 = MyFMGibbsRegressor(
        rank=2, random_seed=5, dtype=np.float64, n_devices=2
    ).fit(X_main, y2, X_rel=blocks2, n_iter=4, n_kept_samples=4)
    for a, b in zip(fm3.predictor_.samples, fm4.predictor_.samples):
        np.testing.assert_allclose(a.V, b.V, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_categorical_reduce_scatter_parity(n_dev):
    """Entity counts divisible by the mesh -> the fast path
    reduce-scatters each table's Gram by entity window and all-gathers
    only the drawn weights; the chain must still equal single-chip
    (per-feature noise makes the windowed draws identical values)."""
    import scipy.sparse as sps

    from myfm_tpu import RelationBlock
    from myfm_tpu.design_categorical import try_compile_categorical
    from myfm_tpu.ops.gibbs import GibbsConfig
    from myfm_tpu.parallel.sharding_categorical import (
        ShardedCategoricalGibbsTrainer,
    )
    from myfm_tpu.trainer import CategoricalGibbsTrainer

    rng = np.random.RandomState(7)
    n, nu, ni = 555, 24, 16  # entity counts divisible by 2 and 4
    u, i = rng.randint(0, nu, n), rng.randint(0, ni, n)
    y = (
        rng.normal(size=nu)[u] + rng.normal(size=ni)[i]
        + 0.3 * rng.normal(size=n)
    )
    blocks = [
        RelationBlock(u, sps.identity(nu, format="csr")),
        RelationBlock(i, sps.identity(ni, format="csr")),
    ]
    cfg = GibbsConfig(task="regression")
    assert cfg.gram_reduce_scatter  # default on

    plan1 = try_compile_categorical(
        None, blocks, None, None, np.float64, rank=3
    )
    tr1 = CategoricalGibbsTrainer(plan1, y, cfg, 3, 0.1, 7, np.float64)
    p1, _ = tr1.run(8, 8)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    tr_n = ShardedCategoricalGibbsTrainer(
        None, blocks, y, cfg, 3, 0.1, 7, mesh=mesh, dtype=np.float64
    )
    pred_n, _ = tr_n.run(8, 8)
    for a, b in zip(p1.samples, pred_n.samples):
        np.testing.assert_allclose(a.w0, b.w0, rtol=1e-9)
        np.testing.assert_allclose(a.w, b.w, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(a.V, b.V, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_predict_equals_single_chip(n_dev):
    """Row-sharded posterior serving ≡ single-chip serving (to float
    reassociation) — the predict_parallel analogue
    (predictor.hpp:35-76)."""
    import scipy.sparse as sps

    from myfm_tpu import RelationBlock
    from myfm_tpu.containers import FM
    from myfm_tpu.predictor import Predictor

    rng = np.random.RandomState(21)
    n, nu, ni, nd, rank = 203, 17, 9, 5, 3
    u = rng.randint(0, nu, n)
    i = rng.randint(0, ni, n)
    d = rng.randint(0, nd, n)
    X = sps.csr_matrix(
        (np.ones(n), (np.arange(n), d)), shape=(n, nd)
    )
    blocks = [
        RelationBlock(u, sps.identity(nu, format="csr")),
        RelationBlock(i, sps.identity(ni, format="csr")),
    ]
    F = nd + nu + ni
    pred = Predictor(rank, F, "regression", np.float64)
    for k in range(4):
        pred.samples.append(
            FM(
                float(rng.randn()),
                rng.randn(F) * 0.3,
                rng.randn(F, rank) * 0.3,
                [],
            )
        )
    single = pred.predict(X, blocks)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    sharded = pred.predict(X, blocks, mesh=mesh)
    np.testing.assert_allclose(sharded, single, rtol=1e-9, atol=1e-12)

    # classification squash path
    pred_c = Predictor(rank, F, "classification", np.float64)
    pred_c.samples = pred.samples
    np.testing.assert_allclose(
        pred_c.predict(X, blocks, mesh=mesh),
        pred_c.predict(X, blocks),
        rtol=1e-9, atol=1e-12,
    )

    # ordered-probit class probabilities
    pred_o = Predictor(rank, F, "ordered", np.float64)
    for s in pred.samples:
        pred_o.samples.append(
            FM(s.w0, s.w, s.V, [np.array([-0.5, 0.4, 1.3])])
        )
    np.testing.assert_allclose(
        pred_o.predict_parallel_oprobit(X, blocks, mesh=mesh),
        pred_o.predict_parallel_oprobit(X, blocks),
        rtol=1e-9, atol=1e-12,
    )
