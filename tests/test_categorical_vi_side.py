"""Tests for the entity+attribute (EA) extension of the VI fast path:
CAVI over blocks shaped [one-hot id | per-entity side features]
(multi-hot genres, implicit-feedback vectors, numeric attributes — the
reference's variational relational configs, variational.hpp:556-833).

Layers (mirroring the reference's test strategy, SURVEY §4):
1. pass unit: one `_vi_ea_table_pass` == an independent numpy
   re-implementation of the per-coordinate CAVI updates, exactly
   (same color order, same coordinate order);
2. algorithmic invariant: the ELBO trace is monotone non-decreasing
   (each update is the exact coordinate maximiser);
3. fixed-point parity with the row-space colored VariationalTrainer;
4. end-to-end estimator runs for both tasks.
"""

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp

from myfm_tpu import RelationBlock, VariationalFMRegressor
from myfm_tpu.design_categorical import try_compile_categorical
from myfm_tpu.ops.categorical import make_y_tiles
from myfm_tpu.ops.categorical_vi import (
    _vi_ea_table_pass,
    vi_eff_tables,
    vi_refresh_rows,
)
from myfm_tpu.ops.variational import VariationalConfig


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


def test_vi_ea_pass_matches_numpy_oracle():
    """_vi_ea_table_pass == independent numpy CAVI, exactly.

    The oracle walks the plan's colors in order; for each side feature
    it applies the closed-form coordinate updates (w, then V_1..V_R)
    computed directly from row-space sums — maintaining e, Q and the
    variance caches A1 = Σxs, X2S = Σx²s, B2 = Σx²sv̄ after every
    coordinate."""
    (m1, side, m2), blocks, grouping, rng = _ea_problem(seed=1)
    N = m1.shape[0]
    B1, Fs = side.shape
    B2n = blocks[1].block_size
    R = 3
    plan = try_compile_categorical(
        None, blocks, grouping, None, np.float64, fixed_ts=(32, 4),
        rank=4 * R, allow_side=True,
    )
    assert plan is not None and plan.side[2] is not None
    F = B1 + Fs + B2n
    G_n = 3

    w = rng.normal(size=F)
    w_var = rng.random(F) * 0.3 + 0.05
    V = rng.normal(size=(F, R))
    V_var = rng.random((F, R)) * 0.3 + 0.05
    w0 = 0.4
    tau = rng.normal(size=N)
    alpha = 1.7
    lambda_w = rng.random(G_n) + 0.5
    mu_w = rng.normal(size=G_n) * 0.1
    lambda_V = rng.random((G_n, R)) + 0.5
    mu_V = rng.normal(size=(G_n, R)) * 0.1
    cfg = VariationalConfig(task="regression")

    eff = vi_eff_tables(
        plan, jnp.asarray(w), jnp.asarray(w_var), jnp.asarray(V),
        jnp.asarray(V_var),
    )
    tau_tiles = make_y_tiles(plan, jnp.asarray(tau))
    w_j, wv_j, V_j, s_j = _vi_ea_table_pass(
        plan, 2, jnp.asarray(w), jnp.asarray(w_var), jnp.asarray(V),
        jnp.asarray(V_var), w0, alpha,
        jnp.asarray(lambda_w), jnp.asarray(mu_w),
        jnp.asarray(lambda_V), jnp.asarray(mu_V), plan.group_index,
        tau_tiles[2], cfg, "interpret", eff,
    )

    # ---- numpy oracle ------------------------------------------------
    gi = np.asarray(plan.group_index)
    w_o, wv_o = w.copy(), w_var.copy()
    V_o, s_o = V.copy(), V_var.copy()
    x_of = side[m1]  # [N, Fs]
    oh2 = B1 + Fs + m2
    lin = w_o[m1] + w_o[oh2] + x_of @ w_o[B1 : B1 + Fs]
    Q = V_o[m1] + V_o[oh2] + x_of @ V_o[B1 : B1 + Fs]
    QS = (
        V_o[m1] ** 2
        + V_o[oh2] ** 2
        + (x_of**2) @ V_o[B1 : B1 + Fs] ** 2
    )
    e = w0 + lin + 0.5 * (Q**2 - QS).sum(axis=1) - tau
    A1 = s_o[m1] + s_o[oh2] + x_of @ s_o[B1 : B1 + Fs]
    X2S = s_o[m1] + s_o[oh2] + (x_of**2) @ s_o[B1 : B1 + Fs]
    B2c = (
        (s_o * V_o)[m1]
        + (s_o * V_o)[oh2]
        + (x_of**2) @ (s_o * V_o)[B1 : B1 + Fs]
    )

    si = plan.side[2]
    for color in np.asarray(si.stack_feat):
        for f in color:
            if f >= plan.n_features:
                continue
            j = f - B1
            x = x_of[:, j]
            x2 = x * x
            lam_w_f = lambda_w[gi[f]]
            # w coordinate
            quad = alpha * (x2).sum() + lam_w_f
            lin_w = alpha * (x2.sum() * w_o[f] - (x * e).sum()) \
                + lam_w_f * mu_w[gi[f]]
            w_new = lin_w / quad
            e = e + x * (w_new - w_o[f])
            w_o[f] = w_new
            wv_o[f] = 1.0 / quad
            # factor coordinates
            for r in range(R):
                v_old = V_o[f, r]
                s_old = s_o[f, r]
                phi = Q[:, r] - x * v_old
                sig_m = X2S[:, r] - x2 * s_old
                quad = alpha * (
                    (x2 * phi * phi).sum() + (x2 * sig_m).sum()
                ) + lambda_V[gi[f], r]
                cov = (
                    x
                    * (
                        Q[:, r] * (A1[:, r] - x * s_old)
                        - (B2c[:, r] - x2 * s_old * v_old)
                    )
                ).sum()
                lin_r = alpha * (
                    -(x * e * phi).sum()
                    + v_old * (x2 * phi * phi).sum()
                    + v_old * (x2 * sig_m).sum()
                    - cov
                ) + lambda_V[gi[f], r] * mu_V[gi[f], r]
                v_new = lin_r / quad
                s_new = 1.0 / quad
                e = e + x * phi * (v_new - v_old)
                Q[:, r] = Q[:, r] + x * (v_new - v_old)
                A1[:, r] = A1[:, r] + x * (s_new - s_old)
                X2S[:, r] = X2S[:, r] + x2 * (s_new - s_old)
                B2c[:, r] = B2c[:, r] + x2 * (
                    s_new * v_new - s_old * v_old
                )
                V_o[f, r] = v_new
                s_o[f, r] = s_new

    np.testing.assert_allclose(np.asarray(w_j), w_o, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(wv_j), wv_o, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(V_j), V_o, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(s_j), s_o, rtol=1e-7)


def test_vi_ea_refresh_matches_oracle():
    """vi_refresh_rows with EA eff == direct numpy mean/variance
    forward (the Var(f) identity per factor)."""
    (m1, side, m2), blocks, grouping, rng = _ea_problem(seed=5)
    N = m1.shape[0]
    B1, Fs = side.shape
    R = 2
    plan = try_compile_categorical(
        None, blocks, grouping, None, np.float64, fixed_ts=(32, 4),
        rank=4 * R, allow_side=True,
    )
    F = plan.n_features
    w = rng.normal(size=F)
    w_var = rng.random(F) * 0.3 + 0.02
    V = rng.normal(size=(F, R))
    V_var = rng.random((F, R)) * 0.3 + 0.02
    w0, w0_var = 0.3, 0.01

    eff = vi_eff_tables(
        plan, jnp.asarray(w), jnp.asarray(w_var), jnp.asarray(V),
        jnp.asarray(V_var),
    )
    score, evs = vi_refresh_rows(
        plan, w0, w0_var, jnp.asarray(w), jnp.asarray(w_var),
        jnp.asarray(V), jnp.asarray(V_var), eff=eff,
    )

    # numpy oracle: full per-row x vector over the expanded design
    X = np.zeros((N, F))
    X[np.arange(N), m1] = 1.0
    X[:, B1 : B1 + Fs] = side[m1]
    X[np.arange(N), B1 + Fs + m2] = 1.0
    lin = X @ w
    Q = X @ V
    QS = (X**2) @ (V**2)
    score_np = w0 + lin + 0.5 * (Q**2 - QS).sum(axis=1)
    var_np = w0_var + (X**2) @ w_var
    for r in range(R):
        A2 = (X**2) @ V_var[:, r]
        A5 = (X**3) @ (V_var[:, r] * V[:, r])
        A4 = (X**4) @ (V_var[:, r] ** 2)
        A7 = (X**4) @ (V_var[:, r] * V[:, r] ** 2)
        var_np = var_np + (
            Q[:, r] ** 2 * A2 - 2.0 * Q[:, r] * A5
            + 0.5 * A2**2 - 0.5 * A4 + A7
        )
    np.testing.assert_allclose(np.asarray(score), score_np, rtol=1e-9)
    np.testing.assert_allclose(float(evs), var_np.sum(), rtol=1e-9)


def test_vi_ea_estimator_elbo_monotone_and_fit():
    """End-to-end through VariationalFMRegressor on data with genuine
    side-feature signal: the EA fast path is taken, the ELBO trace is
    monotone (exact coordinate ascent), and the fit recovers the
    signal."""
    rng = np.random.RandomState(7)
    N, B1, B2n, Fs = 1600, 23, 17, 5
    m1 = rng.randint(0, B1, N)
    m2 = rng.randint(0, B2n, N)
    side = (rng.random((B1, Fs)) < 0.4).astype(np.float64)
    w_true = rng.normal(size=B1 + Fs + B2n)
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
        RelationBlock(m2, sps.eye(B2n, format="csr")),
    ]
    # the design is NOT all-one-hot, so reaching a finite ELBO trace
    # through sweep_strategy='categorical' proves the EA fast path ran
    fm = VariationalFMRegressor(
        rank=1, random_seed=42, sweep_strategy="categorical"
    ).fit(
        None, y, X_rel=blocks, n_iter=60, group_shapes=[B1, Fs, B2n],
    )
    elbos = np.asarray(fm.history_.elbos)
    assert np.isfinite(elbos).all()
    # coordinate ascent: monotone after the first refresh settles
    diffs = np.diff(elbos[2:])
    assert (diffs > -1e-6 * np.abs(elbos[2:-1])).all(), diffs.min()
    pred = fm.predict(None, X_rel=blocks)
    rmse = np.sqrt(np.mean((pred - y) ** 2))
    assert rmse < 0.45, rmse


def test_vi_ea_fixed_point_matches_colored():
    """The EA fast path and the row-space colored CAVI converge to the
    same mean-field stationary point (update orders differ, fixed
    points agree)."""
    from myfm_tpu import VariationalFMClassifier

    (m1, side, m2), blocks, grouping, rng = _ea_problem(
        seed=11, N=900, R=2
    )
    B1, Fs = side.shape
    w_true = rng.normal(size=B1)
    y = (
        w_true[m1] + side[m1] @ rng.normal(size=Fs)
        + 0.4 * rng.normal(size=m1.shape[0])
    )
    preds = {}
    for strategy in ("categorical", "colored"):
        fm = VariationalFMRegressor(
            rank=2, random_seed=3, sweep_strategy=strategy
        ).fit(
            None, y, X_rel=blocks, n_iter=150,
            group_shapes=[B1, Fs, blocks[1].block_size],
        )
        preds[strategy] = fm.predict(None, X_rel=blocks)
    np.testing.assert_allclose(
        preds["categorical"], preds["colored"], atol=5e-2
    )

    # classification through the same EA path stays finite and learns
    yb = (y > np.median(y)).astype(np.int64)
    fmc = VariationalFMClassifier(
        rank=2, random_seed=3, sweep_strategy="categorical"
    ).fit(None, yb, X_rel=blocks, n_iter=40)
    p = fmc.predict_proba(None, X_rel=blocks)
    assert np.isfinite(p).all()
    acc = ((p > 0.5) == yb).mean()
    assert acc > 0.7, acc
