"""The joint engine's stacked colour tail (ops/joint.dense_stack_tail)
and the joint pass around it, against float64 numpy loop oracles that
work on the explicit rows instead of the compressed block-row Gram."""

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp

from myfm_tpu.ops.joint import dense_stack_tail

from .test_joint import _oracle_joint_u_main


def _random_tail_problem(C, B, Pf, R, seed=0, dtype=np.float64):
    """Random but structurally valid stack: per color each block row
    holds at most one feature slot; the Gram is a genuine z-moment sum
    of explicit rows z = [1 | e | q] (returned with their block rows)."""
    rng = np.random.RandomState(seed)
    D = R + 2
    z = rng.normal(size=(8 * B, D))
    z[:, 0] = 1.0
    mapper = rng.randint(0, B, 8 * B)
    G = np.zeros((B, D, D))
    for n in range(8 * B):
        G[mapper[n]] += np.outer(z[n], z[n])
    G_flat = G.reshape(B, D * D).T.copy()  # [D², B]

    xw = np.zeros((C, B))
    segb = np.full((C, B), Pf, dtype=np.int32)
    for c in range(C):
        # each feature slot owns a random disjoint subset of block rows
        perm = rng.permutation(B)
        used = 0
        for p in range(Pf):
            k = rng.randint(1, max(2, B // (2 * Pf)))
            rows = perm[used : used + k]
            used += k
            segb[c, rows] = p
            xw[c, rows] = rng.choice([-1.0, 1.0, 0.5]) * (
                1.0 + 0.1 * rng.random(k)
            )
    u0 = rng.normal(size=(C, Pf, R + 1)) * 0.3
    lam = np.abs(rng.normal(size=(C, Pf, R + 1))) + 0.5
    mu = rng.normal(size=(C, Pf, R + 1)) * 0.1
    xi = rng.normal(size=(C, Pf, R + 1))
    arrays = [a.astype(dtype) for a in (G_flat, xw, u0, lam, mu, xi)]
    G_flat, xw, u0, lam, mu, xi = arrays
    return dict(G=G_flat, xw=xw, segb=segb, u0=u0, lam=lam, mu=mu, xi=xi,
                z=z.astype(dtype).astype(np.float64), mapper=mapper)


def _numpy_tail(prob, alpha):
    """Colour by colour, feature by feature, on the explicit rows:
    ψ_n = x·[1 | q_n − x v_old], S = Σψψᵀ, t = Σ e_n ψ_n, the exact
    (R+1)-dim Gaussian draw with the given noise, then e += ψ·Δu and
    q += xΔv on the feature's rows."""
    z = prob["z"].copy()
    mapper = prob["mapper"]
    xw, segb = prob["xw"].astype(np.float64), prob["segb"]
    C, Pf = prob["u0"].shape[:2]
    u_all = np.zeros(prob["u0"].shape)
    for c in range(C):
        for p in range(Pf):
            u_old = prob["u0"][c, p].astype(np.float64)
            lam = prob["lam"][c, p].astype(np.float64)
            mu = prob["mu"][c, p].astype(np.float64)
            xi = prob["xi"][c, p].astype(np.float64)
            rows = np.nonzero(segb[c][mapper] == p)[0]
            x = xw[c][mapper[rows]]
            e, q = z[rows, 1], z[rows, 2:]
            psi = x[:, None] * np.concatenate(
                [np.ones((len(rows), 1)), q - x[:, None] * u_old[1:]],
                axis=1,
            )
            S = psi.T @ psi
            A = alpha * S + np.diag(lam)
            rhs = alpha * (S @ u_old - psi.T @ e) + lam * mu
            L = np.linalg.cholesky(A)
            u_new = np.linalg.solve(A, rhs) + np.linalg.solve(L.T, xi)
            delta = u_new - u_old
            z[rows, 1] += psi @ delta
            z[rows, 2:] += np.outer(x, delta[1:])
            u_all[c, p] = u_new
    return z, u_all


def _run_scan_tail(prob, alpha, R):
    B = prob["xw"].shape[1]
    dt = prob["G"].dtype
    return dense_stack_tail(
        jnp.asarray(prob["G"]), jnp.zeros((R, B), dt), jnp.zeros((B,), dt),
        jnp.asarray(prob["xw"]), jnp.asarray(prob["segb"]),
        jnp.asarray(prob["u0"]), jnp.asarray(prob["lam"]),
        jnp.asarray(prob["mu"]), jnp.asarray(prob["xi"]), alpha, R + 2,
    )


def _check_against_rows(prob, got, z_new, u_want, rtol):
    """The scan's draws equal the row oracle's; its evolved Gram equals
    the Gram of the oracle's updated rows; and (Atot, Ct) reproduce the
    updated rows from the initial ones:
        q = q⁰ + Atot[m],   e = e⁰ + Ct[m] + q⁰·Atot[m]."""
    G, Atot, Ct, u_new = (np.asarray(a, np.float64) for a in got)
    B = G.shape[1]
    D = prob["z"].shape[1]
    m = prob["mapper"]
    z0 = prob["z"]
    np.testing.assert_allclose(u_new, u_want, rtol=rtol, atol=rtol,
                               err_msg="draws")
    G_rows = np.zeros((B, D, D))
    for n in range(len(m)):
        G_rows[m[n]] += np.outer(z_new[n], z_new[n])
    scale = np.abs(G_rows).max()
    np.testing.assert_allclose(G.T.reshape(B, D, D), G_rows, rtol=rtol,
                               atol=rtol * scale, err_msg="Gram")
    q_rec = z0[:, 2:] + Atot.T[m]
    e_rec = z0[:, 1] + Ct[m] + np.sum(z0[:, 2:] * Atot.T[m], axis=1)
    np.testing.assert_allclose(q_rec, z_new[:, 2:], rtol=rtol,
                               atol=rtol * np.abs(z_new).max())
    np.testing.assert_allclose(e_rec, z_new[:, 1], rtol=rtol,
                               atol=rtol * np.abs(z_new).max())


@pytest.mark.parametrize("dtype,rtol", [
    (np.float64, 1e-9),
    (np.float32, 2e-3),
])
def test_scan_tail_matches_numpy_loop_oracle(dtype, rtol):
    C, B, Pf, R = 7, 37, 4, 3
    alpha = 1.3
    prob = _random_tail_problem(C, B, Pf, R, seed=3, dtype=dtype)
    got = _run_scan_tail(prob, alpha, R)
    assert got[3].shape == (C, Pf, R + 1)
    z_new, u_want = _numpy_tail(prob, alpha)
    _check_against_rows(prob, got, z_new, u_want, rtol)


def test_scan_tail_pad_slots_inert():
    """Feature slots with no rows (segb never == p) draw from the prior
    alone and leave the carried state untouched."""
    C, B, Pf, R = 3, 16, 3, 2
    alpha = 1.1
    prob = _random_tail_problem(C, B, Pf, R, seed=9)
    # wipe slot Pf-1 everywhere: those features own no rows
    prob["segb"][prob["segb"] == Pf - 1] = Pf
    got = _run_scan_tail(prob, alpha, R)
    z_new, u_want = _numpy_tail(prob, alpha)
    _check_against_rows(prob, got, z_new, u_want, 1e-9)
    # the row-less slot's draw is the prior draw μ + ξ/√λ
    last = (slice(None), Pf - 1)
    np.testing.assert_allclose(
        np.asarray(got[3])[last],
        prob["mu"][last] + prob["xi"][last] / np.sqrt(prob["lam"][last]),
        rtol=1e-12,
    )


def _block_color_feats(plan, F):
    """Global feature ids per colour, in the joint pass's order."""
    colors = []
    for b in plan.blocks:
        for dc in b.dense_colors:
            feats = [int(f) for f in np.asarray(dc.feat) if f < F]
            if dc.id_feat is not None:
                feats = [int(f) for f in np.asarray(dc.id_feat)
                         if f < F] + feats
            colors.append(feats)
        if b.dense_stack is not None:
            for row in np.asarray(b.dense_stack.feat):
                colors.append([int(f) for f in row if f < F])
    return colors


def test_joint_trajectory_matches_blocked_oracle():
    """Five joint passes (dense head colours, the scanned tail, the
    identity colours) == a jointly blocked float64 oracle that draws
    each feature's [w_j | V_j] from the explicit expanded rows, with
    the same noise and colour order."""
    from myfm_tpu.design import compile_design
    from myfm_tpu.ops.forward import factor_q
    from myfm_tpu.ops.joint import sweep_joint_u
    from myfm_tpu.relational import RelationBlock

    from .oracle import expand_blocks

    rng = np.random.RandomState(8)
    n, nu, ni, R = 400, 25, 18, 3
    u = rng.randint(0, nu, n)
    i = rng.randint(0, ni, n)
    # multi-hot implicit features force a nontrivial colour tail
    imp = sps.csr_matrix((rng.random((nu, ni)) > 0.7).astype(np.float64))
    blocks = [
        RelationBlock(u, sps.hstack(
            [sps.identity(nu, format="csr"), imp], format="csr"
        )),
        RelationBlock(i, sps.identity(ni, format="csr")),
    ]
    y = rng.normal(size=n)
    plan = compile_design(
        None, blocks, grouping=None, dtype=np.float64,
        for_training=True, joint_dense=True, max_unrolled_colors=2,
    )
    assert any(b.dense_stack is not None for b in plan.blocks)
    X = sps.csc_matrix(expand_blocks(None, blocks))
    F = X.shape[1]
    colors = _block_color_feats(plan, F)
    assert sorted(f for c in colors for f in c) == list(range(F))

    G_n = 1
    g = np.zeros(F, np.int64)
    w = rng.normal(size=F) * 0.1
    V = rng.normal(size=(F, R)) * 0.1
    w0 = 0.3
    alpha = 2.0
    lam_w = np.asarray([1.5])
    mu_w = np.asarray([0.1])
    lam_V = rng.random((G_n, R)) + 0.8
    mu_V = rng.normal(size=(G_n, R)) * 0.1

    Xd = X.toarray()
    q = Xd @ V
    score = w0 + Xd @ w + 0.5 * (q**2 - (Xd**2) @ (V**2)).sum(1)
    e = score - y

    e_j, q_j = jnp.asarray(e), factor_q(plan, jnp.asarray(V))
    w_j, V_j = jnp.asarray(w), jnp.asarray(V)
    master = jax.random.PRNGKey(5)
    for it in range(5):
        key = jax.random.fold_in(master, it)
        w_j, V_j, e_j, q_j = sweep_joint_u(
            plan, e_j, w_j, V_j, alpha, jnp.asarray(lam_w),
            jnp.asarray(mu_w), jnp.asarray(lam_V), jnp.asarray(mu_V),
            key, q=q_j,
        )
        noise = np.asarray(
            jax.random.normal(key, (F, R + 1), dtype=jnp.float64)
        )
        for feats in colors:
            rows, vals, seg = [], [], []
            for s_idx, j in enumerate(feats):
                lo, hi = X.indptr[j], X.indptr[j + 1]
                rows.extend(X.indices[lo:hi])
                vals.extend(X.data[lo:hi])
                seg.extend([s_idx] * (hi - lo))
            e, q, w, V = _oracle_joint_u_main(
                np.asarray(rows, np.int64), np.asarray(vals),
                np.asarray(seg, np.int64), np.asarray(feats), e, q, w, V,
                alpha, lam_w, mu_w, lam_V, mu_V, noise, g,
            )
        np.testing.assert_allclose(np.asarray(w_j), w, rtol=1e-8,
                                   atol=1e-10, err_msg=f"w, pass {it}")
        np.testing.assert_allclose(np.asarray(V_j), V, rtol=1e-8,
                                   atol=1e-10, err_msg=f"V, pass {it}")
        np.testing.assert_allclose(np.asarray(e_j), e, rtol=1e-8,
                                   atol=1e-10, err_msg=f"e, pass {it}")
        np.testing.assert_allclose(np.asarray(q_j), q, rtol=1e-8,
                                   atol=1e-10, err_msg=f"q, pass {it}")
