"""VI tests: posterior-mean recovery (tighter bounds than Gibbs,
reference test_fit.py:63-67), blocked ≡ flattened determinism, ELBO
monotonicity, classifier behavior."""

import numpy as np
import pytest

from myfm_tpu import VariationalFMClassifier, VariationalFMRegressor

from .conftest import make_sparse_data
from .oracle import expand_blocks
from .test_block import _make_relational_problem


def test_vi_regression_recovery(middle_data, stub_weight):
    rng = np.random.RandomState(0)
    X, score = middle_data
    y = score + 1.0 * rng.normal(size=score.shape)

    vfm = VariationalFMRegressor(3)
    assert vfm.w0_mean is None
    assert vfm.w_mean is None
    assert vfm.V_mean is None
    vfm.fit(X, y, n_iter=50)

    weights = vfm.predictor_.weights()
    assert abs(weights.w0 - stub_weight.w0) < 0.5
    assert np.all(np.abs(weights.w - stub_weight.w) < 1.0)

    F = stub_weight.w.shape[0]
    for i in range(F):
        for j in range(i + 1, F):
            truth = stub_weight.V[i].dot(stub_weight.V[j])
            if abs(truth) < 0.1:
                continue
            sign = np.sign(truth)
            got = weights.V[i].dot(weights.V[j])
            assert got * sign > abs(truth) * 0.8
            assert got * sign < abs(truth) * 1.25

    # posterior variance accessors populated
    assert vfm.w0_var is not None and vfm.w0_var > 0
    assert np.all(vfm.w_var > 0)
    assert np.all(vfm.V_var > 0)

    # ELBO should be increasing towards convergence (tail monotone-ish)
    elbos = np.asarray(vfm.history_.elbos)
    assert elbos.shape[0] == 50
    assert elbos[-1] >= elbos[5]

    pred = vfm.predict(X)
    rmse = np.sqrt(((pred - y) ** 2).mean())
    assert rmse < 1.3  # noise level is 1.0


@pytest.mark.parametrize("max_unrolled", [16, 0])
def test_vi_blocked_equals_flattened(max_unrolled):
    # max_unrolled=0 forces every color through the ColorStack scans,
    # incl. the incremental block-aggregate path of _vi_w_block_stack /
    # _vi_V_block_stack, checked against the flattened main-table path.
    X_main, blocks, y = _make_relational_problem(seed=21)
    X_flat = expand_blocks(X_main, blocks)
    kwargs = dict(
        rank=2, random_seed=3, dtype=np.float64,
        max_unrolled_colors=max_unrolled,
    )
    vb = VariationalFMRegressor(**kwargs).fit(
        X_main, y, X_rel=blocks, n_iter=15
    )
    vf = VariationalFMRegressor(**kwargs).fit(X_flat, y, n_iter=15)
    np.testing.assert_allclose(
        vb.predictor_.weights().V, vf.predictor_.weights().V,
        rtol=1e-6, atol=1e-9,
    )
    np.testing.assert_allclose(
        vb.predictor_.weights().w, vf.predictor_.weights().w,
        rtol=1e-6, atol=1e-9,
    )
    np.testing.assert_allclose(
        vb.predictor_.weights().V_var, vf.predictor_.weights().V_var,
        rtol=1e-6, atol=1e-12,
    )
    np.testing.assert_allclose(
        vb.history_.elbos, vf.history_.elbos, rtol=1e-6
    )


def test_vi_serial_equals_colored(middle_data):
    rng = np.random.RandomState(5)
    X, score = middle_data
    y = score + rng.normal(size=score.shape)
    kwargs = dict(rank=2, random_seed=7, dtype=np.float64)
    v_serial = VariationalFMRegressor(
        sweep_strategy="serial", **kwargs
    ).fit(X, y, n_iter=10)
    v_auto = VariationalFMRegressor(
        sweep_strategy="auto", **kwargs
    ).fit(X, y, n_iter=10)
    np.testing.assert_allclose(
        v_serial.predictor_.weights().V,
        v_auto.predictor_.weights().V,
        rtol=1e-6,
        atol=1e-9,
    )


def test_vi_classifier(stub_weight):
    rng = np.random.RandomState(1)
    X, score = make_sparse_data(2000, stub_weight, seed=8)
    y = (score + rng.normal(size=score.shape) > 0).astype(np.int64)
    clf = VariationalFMClassifier(3).fit(X, y, n_iter=40)
    proba = clf.predict_proba(X)
    assert proba.min() >= 0 and proba.max() <= 1
    acc = ((proba > 0.5) == (y > 0)).mean()
    assert acc > 0.8
    np.testing.assert_array_equal(clf.predict(X), proba > 0.5)
