"""Entity-space VI fast path: numpy-oracle exactness, convergence
parity with the colored CAVI path, ELBO monotonicity, classifier."""

import numpy as np
import pytest
import scipy.sparse as sps

from myfm_tpu import RelationBlock, VariationalFMClassifier, \
    VariationalFMRegressor


def _make_onehot_problem(seed=0, n=500, nu=17, ni=11, noise=0.3):
    rng = np.random.RandomState(seed)
    u = rng.randint(0, nu, n)
    i = rng.randint(0, ni, n)
    fu = rng.normal(size=(nu, 2)) * 0.7
    fi = rng.normal(size=(ni, 2)) * 0.7
    score = (
        0.4 * rng.normal(size=nu)[u]
        + 0.4 * rng.normal(size=ni)[i]
        + (fu[u] * fi[i]).sum(axis=1)
    )
    y = score + noise * rng.normal(size=n)
    blocks = [
        RelationBlock(u, sps.identity(nu, format="csr")),
        RelationBlock(i, sps.identity(ni, format="csr")),
    ]
    return u, i, blocks, y, score


def _oracle_cat_vi_sweep(u_of, i_of, y, st, cfg_vals):
    """One CAVI sweep in the fast path's exact update order, computed
    naively in row space (numpy, f64)."""
    alpha_0, beta_0, gamma_0, mu_0, reg_0 = cfg_vals
    n = len(y)
    ents = [u_of, i_of]
    R = st["V"][0].shape[1]
    nu = st["V"][0].shape[0]
    ni = st["V"][1].shape[0]

    def score_rows():
        s = st["w0"] + st["w"][0][u_of] + st["w"][1][i_of]
        q = st["V"][0][u_of] + st["V"][1][i_of]
        qs = (st["V"][0][u_of] ** 2) + (st["V"][1][i_of] ** 2)
        return s + 0.5 * (q * q - qs).sum(axis=1)

    e = score_rows() - y

    # alpha
    e_all = (st["e"] ** 2).sum() + st["evs"]
    alpha_rate = (beta_0 + e_all) / 2.0
    alpha = (alpha_0 + n) / 2.0 / alpha_rate
    # w0 (stats from the carried e, like the fast path)
    quad0 = alpha * n + reg_0
    w0 = alpha * (n * st["w0"] - st["e"].sum()) / quad0
    st["w0"], st["w0_var"] = w0, 1.0 / quad0

    # hypers (single group)
    def lam_mu(weight, wv, mu, muv):
        cnt = weight.shape[0]
        dev2 = ((weight - mu) ** 2 + wv).sum(axis=0) + muv * cnt
        lam = (alpha_0 + cnt) / (beta_0 + dev2)
        s = weight.sum(axis=0)
        q = lam * (gamma_0 + cnt)
        mu_new = lam * (gamma_0 * mu_0 + s) / q
        return lam, mu_new, 1.0 / q

    w_all = np.concatenate(st["w"])
    wv_all = np.concatenate(st["w_var"])
    lam_w, mu_w, mu_w_var = lam_mu(
        w_all[:, None], wv_all[:, None], st["mu_w"], st["mu_w_var"]
    )
    lam_w, mu_w, mu_w_var = lam_w[0], mu_w[0], mu_w_var[0]
    V_all = np.concatenate(st["V"])
    S_all = np.concatenate(st["V_var"])
    lam_V, mu_V, mu_V_var = lam_mu(
        V_all, S_all, st["mu_V"], st["mu_V_var"]
    )
    st.update(
        mu_w=mu_w, mu_w_var=mu_w_var, lam_w=lam_w,
        mu_V=mu_V, mu_V_var=mu_V_var, lam_V=lam_V,
    )

    # per-table passes (w then factor scan), e recomputed fresh
    for t in range(2):
        ent = ents[t]
        B = st["V"][t].shape[0]
        other = 1 - t
        oe = ents[other]
        e_t = score_rows() - y  # mean residual with current weights
        phi = st["V"][other][oe]  # [n, R]
        sig = st["V_var"][other][oe]
        tau = (st["V_var"][other] * st["V"][other])[oe]

        card = np.bincount(ent, minlength=B).astype(float)
        E1 = np.bincount(ent, weights=e_t, minlength=B)
        quad = alpha * card + lam_w
        w_old = st["w"][t]
        w_new = (alpha * (card * w_old - E1) + lam_w * mu_w) / quad
        st["w"][t] = w_new
        st["w_var"][t] = 1.0 / quad
        e_t = e_t + (w_new - w_old)[ent]

        for r in range(R):
            ph = phi[:, r]
            Sphi2 = np.bincount(ent, weights=ph * ph, minlength=B)
            Seh = np.bincount(ent, weights=e_t * ph, minlength=B)
            Ssig = np.bincount(ent, weights=sig[:, r], minlength=B)
            Sps = np.bincount(ent, weights=ph * sig[:, r], minlength=B)
            Stau = np.bincount(ent, weights=tau[:, r], minlength=B)
            v_old = st["V"][t][:, r].copy()  # slice is a view
            quad = alpha * (Sphi2 + Ssig) + lam_V[r]
            lin = alpha * (
                -Seh + Sphi2 * v_old - (Sps - Stau)
            ) + lam_V[r] * mu_V[r]
            v_new = lin / quad
            st["V"][t][:, r] = v_new
            st["V_var"][t][:, r] = 1.0 / quad
            e_t = e_t + ((v_new - v_old)[ent]) * ph

    # refresh
    score = score_rows()
    st["e"] = score - y
    q = st["V"][0][u_of] + st["V"][1][i_of]
    x2s = st["V_var"][0][u_of] + st["V_var"][1][i_of]
    x3sv = (st["V_var"][0] * st["V"][0])[u_of] + (
        st["V_var"][1] * st["V"][1]
    )[i_of]
    x4s2 = (st["V_var"][0] ** 2)[u_of] + (st["V_var"][1] ** 2)[i_of]
    x4sv2 = (st["V_var"][0] * st["V"][0] ** 2)[u_of] + (
        st["V_var"][1] * st["V"][1] ** 2
    )[i_of]
    var_rows = (
        st["w0_var"]
        + st["w_var"][0][u_of]
        + st["w_var"][1][i_of]
        + (
            q * q * x2s + 0.5 * x2s * x2s - 2.0 * x3sv * q
            - 0.5 * x4s2 + x4sv2
        ).sum(axis=1)
    )
    st["evs"] = var_rows.sum()
    st["alpha"], st["alpha_rate"] = alpha, alpha_rate
    return st


def test_fast_vi_one_sweep_matches_numpy_oracle():
    """One entity-space CAVI sweep equals the naive row-space oracle
    executing the identical update order (pins every Gram formula)."""
    from myfm_tpu.design_categorical import try_compile_categorical
    from myfm_tpu.ops.variational import VariationalConfig
    from myfm_tpu.vi_trainer import CategoricalVITrainer

    u, i, blocks, y, _ = _make_onehot_problem(seed=2, n=300)
    R = 3
    cfg = VariationalConfig(task="regression")
    plan = try_compile_categorical(
        None, blocks, None, None, np.float64, rank=3 * R
    )
    tr = CategoricalVITrainer(
        plan, y, cfg, R, 0.1, 11, np.float64
    )
    state = tr._initialize()

    nu, ni = len(np.unique(u)), len(np.unique(i))
    core = state.core
    Vh = np.asarray(core.V)
    Sh = np.asarray(core.V_var)
    wh = np.asarray(core.w)
    wvh = np.asarray(core.w_var)
    st = dict(
        w0=float(core.w0), w0_var=float(core.w0_var),
        w=[wh[:nu].copy(), wh[nu:].copy()],
        w_var=[wvh[:nu].copy(), wvh[nu:].copy()],
        V=[Vh[:nu].copy(), Vh[nu:].copy()],
        V_var=[Sh[:nu].copy(), Sh[nu:].copy()],
        e=np.asarray(core.e).copy(),
        evs=float(core.e_var_sum),
        mu_w=0.0, mu_w_var=1.0, mu_V=np.zeros(R),
        mu_V_var=np.ones(R), lam_V=np.full(R, 1e-5), lam_w=1e-5,
    )

    for sweep in range(3):
        state = tr._sweep(
            tr.plan, state, tr.y, tr.y_tiles, tr.cfg, tr._gram_impl
        )
        st = _oracle_cat_vi_sweep(
            u, i, y, st, (1.0, 1.0, 1.0, 0.0, 1.0)
        )
        core = state.core
        np.testing.assert_allclose(
            np.asarray(core.w), np.concatenate(st["w"]), rtol=1e-9,
            atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(core.V), np.concatenate(st["V"]), rtol=1e-9,
            atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(core.V_var), np.concatenate(st["V_var"]),
            rtol=1e-9,
        )
        np.testing.assert_allclose(
            np.asarray(core.e), st["e"], rtol=1e-8, atol=1e-10
        )
        np.testing.assert_allclose(
            float(core.e_var_sum), st["evs"], rtol=1e-9
        )


def test_fast_vi_converges_with_colored_path():
    """Fast-path CAVI (table-interleaved order) and the colored
    reference-order CAVI converge to the same quality on an all-one-hot
    design; the fast-path ELBO is monotone after warmup."""
    u, i, blocks, y, score = _make_onehot_problem(seed=5, n=900)

    v_fast = VariationalFMRegressor(
        rank=2, random_seed=3, dtype=np.float64,
        sweep_strategy="categorical",
    ).fit(None, y, X_rel=blocks, n_iter=60)
    v_col = VariationalFMRegressor(
        rank=2, random_seed=3, dtype=np.float64, sweep_strategy="serial"
    ).fit(None, y, X_rel=blocks, n_iter=60)

    p_fast = v_fast.predict(None, X_rel=blocks)
    p_col = v_col.predict(None, X_rel=blocks)
    rmse_fast = float(np.sqrt(np.mean((p_fast - score) ** 2)))
    rmse_col = float(np.sqrt(np.mean((p_col - score) ** 2)))
    assert rmse_fast < 0.35
    assert abs(rmse_fast - rmse_col) < 0.1
    np.testing.assert_allclose(p_fast, p_col, atol=0.35)

    elbos = np.asarray(v_fast.history_.elbos)
    assert np.all(np.diff(elbos[3:]) > -1e-6 * np.abs(elbos[3:-1]))


def test_fast_vi_classifier():
    u, i, blocks, y, score = _make_onehot_problem(seed=9, n=1200)
    ybin = (score > np.median(score)).astype(np.int64)
    clf = VariationalFMClassifier(
        rank=2, random_seed=6, sweep_strategy="categorical"
    ).fit(None, ybin, X_rel=blocks, n_iter=40)
    proba = clf.predict_proba(None, X_rel=blocks)
    assert proba.min() >= 0 and proba.max() <= 1
    acc = ((proba > 0.5) == (ybin > 0)).mean()
    assert acc > 0.75
