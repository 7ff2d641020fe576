"""Posterior-concentration and parity tests for the Gibbs regressor.

Mirrors the reference test strategy (tests/regression/test_fit.py):
generate data from a known FM, run the sampler, assert the posterior
concentrates around the truth.
"""

import numpy as np
import pytest

from myfm_tpu import MyFMGibbsRegressor


@pytest.mark.parametrize("alpha_inv", [0.3, 1.0])
def test_regression_posterior_concentration(
    alpha_inv, middle_data, stub_weight
):
    rng = np.random.RandomState(0)
    X, score = middle_data
    y = score + alpha_inv * rng.normal(0, 1, size=score.shape)

    fm_init = MyFMGibbsRegressor(3)
    assert fm_init.w0_samples is None
    assert fm_init.w_samples is None
    assert fm_init.V_samples is None

    fm = fm_init.fit(X, y, n_iter=100, n_kept_samples=100)

    trace = fm.get_hyper_trace()
    last_alphas = trace["alpha"].iloc[-20:].values
    assert np.all(last_alphas > (1 / alpha_inv**2) / 2)
    assert np.all(last_alphas < (1 / alpha_inv**2) * 2)

    last_w0 = fm.w0_samples[-20:]
    assert np.all(np.abs(last_w0 - stub_weight.w0) < 0.5)

    last_w = fm.w_samples[-20:]
    assert np.all(np.abs(last_w - stub_weight.w[None, :]) < 1.0)

    # pairwise Gram entries of V recover the truth within [1/2, 2]x
    last_V = fm.V_samples[-20:]
    F = stub_weight.w.shape[0]
    for i in range(F):
        for j in range(i + 1, F):
            truth = stub_weight.V[i].dot(stub_weight.V[j])
            if abs(truth) < 0.1:
                continue
            sign = np.sign(truth)
            for V_ in last_V:
                got = V_[i].dot(V_[j])
                assert got * sign > abs(truth) * 0.5
                assert got * sign < abs(truth) * 2.0

    # prediction ≈ average of per-sample scores
    pred = fm.predict(X)
    manual = np.mean(
        [s.predict_score(X) for s in fm.predictor_.samples], axis=0
    )
    np.testing.assert_allclose(pred, manual, rtol=1e-4, atol=1e-4)


def test_serial_vs_colored_parity(middle_data):
    """The chromatic sweep must reproduce the serial scan exactly
    (same per-feature noise stream) — the chromatic analogue of the
    reference's blocked ≡ flattened contract."""
    rng = np.random.RandomState(1)
    X, score = middle_data
    y = score + rng.normal(0, 1, size=score.shape)

    common = dict(rank=2, random_seed=11, dtype=np.float64)
    fm_serial = MyFMGibbsRegressor(
        sweep_strategy="serial", **common
    ).fit(X, y, n_iter=10, n_kept_samples=10)
    fm_auto = MyFMGibbsRegressor(
        sweep_strategy="colored", **common
    ).fit(X, y, n_iter=10, n_kept_samples=10)

    np.testing.assert_allclose(
        fm_serial.w_samples, fm_auto.w_samples, rtol=1e-6, atol=1e-8
    )
    np.testing.assert_allclose(
        fm_serial.V_samples, fm_auto.V_samples, rtol=1e-6, atol=1e-8
    )
    np.testing.assert_allclose(
        fm_serial.w0_samples, fm_auto.w0_samples, rtol=1e-6, atol=1e-8
    )


def test_fit_wo_flags(middle_data):
    X, score = middle_data
    rng = np.random.RandomState(2)
    y = score + rng.normal(0, 1, size=score.shape)
    fm = MyFMGibbsRegressor(2, fit_w0=False, fit_linear=False).fit(
        X, y, n_iter=10, n_kept_samples=5
    )
    assert np.all(fm.w0_samples == 0)
    assert np.all(fm.w_samples == 0)
    assert np.any(fm.V_samples != 0)


def test_regression_callback_accumulation(middle_data):
    """Callback running mean == predictor average over kept samples
    (reference contract, test_fit.py:39)."""
    from myfm_tpu.utils.callbacks import RegressionCallback

    rng = np.random.RandomState(3)
    X, score = middle_data
    y = score + rng.normal(size=score.shape)
    cb = RegressionCallback(20, X, y)
    fm = MyFMGibbsRegressor(2).fit(
        X, y, n_iter=20, n_kept_samples=20, callback=cb
    )
    np.testing.assert_allclose(
        fm.predict(X), cb.predictions / 20, rtol=2e-3, atol=2e-3
    )
    assert len(cb.result_trace) == 20
    assert np.isnan(cb.result_trace[0]["rmse_all_but_5"])
    assert not np.isnan(cb.result_trace[-1]["rmse_all_but_5"])


def test_early_stop(middle_data):
    X, score = middle_data
    calls = []

    def cb(i, fm, hyper, history):
        calls.append(i)
        return (i >= 3, None)

    fm = MyFMGibbsRegressor(2).fit(
        X, score, n_iter=100, n_kept_samples=100, callback=cb
    )
    assert calls[-1] == 3
    assert len(fm.w0_samples) == 4
