"""Tests for the entity+attribute (EA) extension of the categorical
fast path: blocks shaped [one-hot id | per-entity side features]
(genres, demographics, implicit-feedback vectors — the reference's
ml-100k-extended / relation-blocks.rst:159-199 configurations).

Layers (mirroring the reference's test strategy, SURVEY §4):
1. pass unit: one `_ea_table_pass` == an independent numpy
   re-implementation of the per-color (R+1)-joint draws, exactly
   (same noise, same color order);
2. invariant: carried (Σe, Σe²) == recomputed score residuals after
   full sweeps through the public estimator path;
3. end-to-end posterior concentration with side features.
"""

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp

from myfm_tpu import MyFMGibbsRegressor, RelationBlock
from myfm_tpu.design_categorical import try_compile_categorical
from myfm_tpu.ops.categorical import (
    _ea_table_pass,
    categorical_sweep,
    eff_tables,
    init_categorical_state,
    make_y_tiles,
    score_rows,
)
from myfm_tpu.ops.gibbs import GibbsConfig, init_state

from .oracle import expand_blocks


def _ea_problem(seed=0, N=400, B1=13, B2=9, Fs=4, R=3, density=0.6):
    """Block 1 = [one-hot id | Fs-col side features]; block 2 one-hot."""
    rng = np.random.RandomState(seed)
    m1 = rng.randint(0, B1, N)
    side = rng.random((B1, Fs)) * (rng.random((B1, Fs)) < density)
    b1 = RelationBlock(
        m1,
        sps.hstack(
            [sps.eye(B1, format="csr"), sps.csr_matrix(side)]
        ).tocsr(),
    )
    m2 = rng.randint(0, B2, N)
    b2 = RelationBlock(m2, sps.eye(B2, format="csr"))
    grouping = np.asarray([0] * B1 + [1] * Fs + [2] * B2, np.int32)
    return (m1, side, m2), [b1, b2], grouping, rng


def test_extraction_shapes():
    (m1, side, m2), blocks, grouping, _ = _ea_problem()
    plan = try_compile_categorical(
        None, blocks, grouping, None, np.float64, fixed_ts=(32, 4), rank=3,
        allow_side=True,
    )
    assert plan is not None
    # id table, one-hot block, then the EA table (entities = block rows)
    kinds = [s is not None for s in plan.side]
    assert kinds == [False, False, True]
    si = plan.side[2]
    assert si.n_cols == side.shape[1]
    assert plan.tables[2].n_cols == side.shape[0]
    # without allow_side the design is rejected (strict one-hot rule)
    assert (
        try_compile_categorical(
            None, blocks, grouping, None, np.float64, rank=3
        )
        is None
    )


def test_ea_pass_matches_numpy_oracle():
    """_ea_table_pass == independent numpy implementation, exactly.

    The oracle reconstructs (e, Q) from the weights in row space, then
    walks the plan's colors in order, drawing each side feature's
    [w_j | V_j] row from its exact (R+1)-dim Gaussian conditional with
    the same noise, maintaining e and Q directly."""
    (m1, side, m2), blocks, grouping, rng = _ea_problem(seed=1)
    N = m1.shape[0]
    B1, Fs = side.shape
    B2 = blocks[1].block_size
    R = 3
    plan = try_compile_categorical(
        None, blocks, grouping, None, np.float64, fixed_ts=(32, 4), rank=R,
        allow_side=True,
    )
    assert plan is not None and plan.side[2] is not None
    F = B1 + Fs + B2
    G_n = 3

    w = rng.normal(size=F)
    V = rng.normal(size=(F, R))
    w0 = 0.4
    tau = rng.normal(size=N)
    alpha = 1.7
    lambda_w = rng.random(G_n) + 0.5
    mu_w = rng.normal(size=G_n) * 0.1
    lambda_V = rng.random((G_n, R)) + 0.5
    mu_V = rng.normal(size=(G_n, R)) * 0.1
    noise_w = rng.normal(size=F)
    noise_V = rng.normal(size=(F, R))
    cfg = GibbsConfig(task="regression")

    tau_tiles = make_y_tiles(plan, jnp.asarray(tau))
    w_j, V_j, moments = _ea_table_pass(
        plan, 2, jnp.asarray(w), jnp.asarray(V), w0, alpha,
        jnp.asarray(lambda_w), jnp.asarray(mu_w),
        jnp.asarray(lambda_V), jnp.asarray(mu_V), plan.group_index,
        jnp.asarray(noise_w), jnp.asarray(noise_V), tau_tiles[2],
        cfg, "interpret", want_moments=True,
    )
    w2, V2 = np.asarray(w_j), np.asarray(V_j)

    # ---- numpy oracle ------------------------------------------------
    w_o = w.copy()
    V_o = V.copy()
    gi = np.asarray(plan.group_index)
    x_of = side[m1]  # [N, Fs] side feature values per row
    # reconstruct e, Q in row space from the current weights
    lin = w_o[m1] + w_o[B1 + Fs + m2] + x_of @ w_o[B1 : B1 + Fs]
    Q = (
        V_o[m1]
        + V_o[B1 + Fs + m2]
        + x_of @ V_o[B1 : B1 + Fs]
    )  # [N, R]
    QS = (
        V_o[m1] ** 2
        + V_o[B1 + Fs + m2] ** 2
        + (x_of**2) @ V_o[B1 : B1 + Fs] ** 2
    )
    e = w0 + lin + 0.5 * (Q**2 - QS).sum(axis=1) - tau

    si = plan.side[2]
    stack_feat = np.asarray(si.stack_feat)
    for color in stack_feat:
        for f in color:
            if f >= plan.n_features:
                continue
            j = f - B1  # side column index
            x = x_of[:, j]  # [N]
            phi = Q - x[:, None] * V_o[f]  # [N, R]
            psi = x[:, None] * np.concatenate(
                [np.ones((N, 1)), phi], axis=1
            )  # [N, R+1]
            S = psi.T @ psi
            t_vec = psi.T @ e
            lam = np.concatenate(
                [[lambda_w[gi[f]]], lambda_V[gi[f]]]
            )
            mu = np.concatenate([[mu_w[gi[f]]], mu_V[gi[f]]])
            u_old = np.concatenate([[w_o[f]], V_o[f]])
            A = alpha * S + np.diag(lam)
            rhs = alpha * (S @ u_old - t_vec) + lam * mu
            L = np.linalg.cholesky(A)
            xi = np.concatenate([[noise_w[f]], noise_V[f]])
            u_new = np.linalg.solve(A, rhs) + np.linalg.solve(L.T, xi)
            delta = u_new - u_old
            e = e + psi @ delta
            Q = Q + x[:, None] * delta[1:]
            w_o[f] = u_new[0]
            V_o[f] = u_new[1:]

    np.testing.assert_allclose(w2, w_o, rtol=1e-7)
    np.testing.assert_allclose(V2, V_o, rtol=1e-7)
    np.testing.assert_allclose(float(moments[0]), e.sum(), rtol=1e-7)
    np.testing.assert_allclose(
        float(moments[1]), (e**2).sum(), rtol=1e-7
    )


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_ea_sweep_residual_invariant(task):
    """Carried (Σe, Σe²) == recomputed residual moments after sweeps."""
    (m1, side, m2), blocks, grouping, rng = _ea_problem(seed=3)
    N = m1.shape[0]
    plan = try_compile_categorical(
        None, blocks, grouping, None, np.float64, fixed_ts=(64, 4), rank=2,
        allow_side=True,
    )
    assert plan is not None
    cfg = GibbsConfig(task=task)
    key = jax.random.PRNGKey(0)
    if task == "regression":
        y = rng.normal(size=N)
    else:
        y = np.where(rng.random(N) < 0.5, -1.0, 1.0)
    yj = jnp.asarray(y)
    core = init_state(plan, 2, 0.1, key, cfg, np.float64)
    state = init_categorical_state(plan, core, yj, key, cfg)
    y_tiles = make_y_tiles(plan, yj)
    for it in range(3):
        state = categorical_sweep(
            plan, state, yj, y_tiles, jax.random.fold_in(key, it),
            cfg, gram_impl="interpret",
        )
    score = np.asarray(
        score_rows(plan, state.core.w0, state.core.w, state.core.V)
    )
    target = np.asarray(state.tau) if task != "regression" else y
    e_true = score - target
    np.testing.assert_allclose(
        float(state.sum_e), e_true.sum(), rtol=1e-8
    )
    np.testing.assert_allclose(
        float(state.sum_e2), (e_true**2).sum(), rtol=1e-8
    )


def test_ea_estimator_posterior_concentration():
    """End-to-end through MyFMGibbsRegressor on data generated from a
    known FM with genuine side-feature signal."""
    rng = np.random.RandomState(7)
    N, B1, B2, Fs = 1600, 23, 17, 5
    m1 = rng.randint(0, B1, N)
    m2 = rng.randint(0, B2, N)
    side = (rng.random((B1, Fs)) < 0.4).astype(np.float64)
    w_true = rng.normal(size=B1 + Fs + B2)
    y = (
        0.8
        + w_true[m1]
        + w_true[B1 + Fs + m2]
        + side[m1] @ w_true[B1 : B1 + Fs]
        + 0.3 * rng.normal(size=N)
    )
    blocks = [
        RelationBlock(
            m1,
            sps.hstack(
                [sps.eye(B1, format="csr"), sps.csr_matrix(side)]
            ).tocsr(),
        ),
        RelationBlock(m2, sps.eye(B2, format="csr")),
    ]
    fm = MyFMGibbsRegressor(rank=1, random_seed=42).fit(
        None, y, X_rel=blocks, n_iter=80, n_kept_samples=60,
        group_shapes=[B1, Fs, B2],
    )
    # the fast path with a side table must actually have been taken
    assert fm.predictor_ is not None
    alphas = np.asarray(fm.get_hyper_trace()["alpha"])[-30:]
    true_prec = 1.0 / 0.3**2
    assert (alphas > 0.4 * true_prec).all()
    assert (alphas < 2.5 * true_prec).all()
    pred = fm.predict(None, X_rel=blocks)
    rmse = np.sqrt(np.mean((pred - y) ** 2))
    assert rmse < 0.45


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_ea_equals_single_chip(n_dev):
    """SPMD EA: per-shard partial Grams psum to the global statistics;
    the side-color scan is replicated — sharded chain == single-chip
    chain up to float reassociation."""
    from jax.sharding import Mesh

    from myfm_tpu.parallel.sharding_categorical import (
        ShardedCategoricalGibbsTrainer,
    )
    from myfm_tpu.trainer import CategoricalGibbsTrainer

    (m1, side, m2), blocks, grouping, rng = _ea_problem(
        seed=9, N=403  # deliberately not divisible by n_dev
    )
    y = rng.normal(size=m1.shape[0])
    cfg = GibbsConfig(task="regression")
    plan1 = try_compile_categorical(
        None, blocks, grouping, None, np.float64, rank=2,
        allow_side=True,
    )
    assert plan1 is not None and any(s is not None for s in plan1.side)
    tr1 = CategoricalGibbsTrainer(plan1, y, cfg, 2, 0.1, 7, np.float64)
    p1, _ = tr1.run(6, 6)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    tr_n = ShardedCategoricalGibbsTrainer(
        None, blocks, y, cfg, 2, 0.1, 7, mesh=mesh,
        grouping=grouping, dtype=np.float64,
    )
    assert any(s is not None for s in tr_n.plan.side)
    pred_n, _ = tr_n.run(6, 6)
    for a, b in zip(p1.samples, pred_n.samples):
        np.testing.assert_allclose(a.w0, b.w0, rtol=1e-9)
        np.testing.assert_allclose(a.w, b.w, rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(a.V, b.V, rtol=1e-7, atol=1e-10)


def test_ea_ungrouped_block():
    """An ungrouped non-one-hot block becomes one EA table covering the
    whole block."""
    rng = np.random.RandomState(5)
    N, B = 300, 11
    m = rng.randint(0, B, N)
    tbl = rng.random((B, 6)) * (rng.random((B, 6)) < 0.5)
    blocks = [RelationBlock(m, sps.csr_matrix(tbl))]
    plan = try_compile_categorical(
        None, blocks, None, None, np.float64, rank=2, allow_side=True,
    )
    assert plan is not None
    assert plan.side[0] is not None and plan.side[0].n_cols == 6
    y = rng.normal(size=N)
    fm = MyFMGibbsRegressor(rank=2, random_seed=1).fit(
        None, y, X_rel=blocks, n_iter=5, n_kept_samples=5
    )
    assert np.isfinite(fm.predict(None, X_rel=blocks)).all()
