"""Ordered-probit cutpoint sampler: Metropolis-within-Gibbs on the device.

Re-implementation of the reference's ``OprobitSampler``
(/root/reference/include/myfm/OProbitSampler.hpp): cutpoints γ are
reparameterized as unconstrained α (γ₀ = α₀, γᵢ = γᵢ₋₁ + exp αᵢ), the
penalized ordinal-probit log-likelihood is maximized by a damped Newton
iteration, and a multivariate-t proposal centred at the mode (precision
= Hessian, ν = nu_oprobit) drives a Metropolis-Hastings accept/reject.

Two deliberate departures from the C++:

* The gradient and Hessian of the penalized likelihood are obtained by
  automatic differentiation of a numerically stable log-interval
  probability (log_ndtr-based — replacing the hand-derived
  erfcx-formulas of OProbitSampler.hpp:111-236).  Identical math,
  machine-checked derivatives.
* The Newton loop and line search run inside jit via lax.while_loop
  with NaN-guarded step halving (mirroring the rejection semantics of
  OProbitSampler.hpp:289-357,367-371).

The latent-response refresh z ~ TN(score, 1; [γ_{y-1}, γ_y]) is a fully
vectorized truncated-normal draw (OProbitSampler.hpp:238-272).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import log_ndtr

from .special import safe_ldiff, truncated_std_normal_two_sided


def alpha_to_gamma(alpha):
    """γ₀ = α₀; γᵢ = γᵢ₋₁ + exp αᵢ (OProbitSampler.hpp:95-101)."""
    steps = jnp.concatenate([alpha[:1], jnp.exp(alpha[1:])])
    return jnp.cumsum(steps)


def gamma_to_alpha(gamma):
    return jnp.concatenate([gamma[:1], jnp.log(jnp.diff(gamma))])


def _interval_logprob(lower, upper, lower_inf, upper_inf):
    """log P(lower < N(0,1) < upper) with possibly infinite bounds.

    Inactive branches receive sanitized finite arguments so reverse-mode
    gradients stay NaN-free (the safe-where pattern).
    """
    low_s = jnp.where(lower_inf, upper - 1.0, lower)
    up_s = jnp.where(upper_inf, low_s + 1.0, upper)
    both = safe_ldiff(low_s, up_s)
    lo_only = log_ndtr(up_s)  # lower = -inf
    hi_only = log_ndtr(-low_s)  # upper = +inf
    return jnp.where(lower_inf, lo_only, jnp.where(upper_inf, hi_only, both))


def make_objective(score, y, n_class: int, reg: float,
                   weight=None, axis=None):
    """f(α) = −[Σᵢ log P(γ_{yᵢ-1} < zᵢ < γ_{yᵢ} | score) − ½ reg ‖α‖²].

    The per-row bounds follow OProbitSampler.hpp:402-413: class 0 uses
    the left CDF at γ₀ − s, class K−1 the right tail at γ_{K-2} − s.

    ``weight`` (row validity mask) excludes SPMD pad rows from the
    likelihood; ``axis`` psum-reduces the row sum over the data mesh so
    every shard evaluates the *global* objective.
    """
    f, _, _ = make_objective_fns(
        score, y, n_class, reg, weight=weight, axis=axis
    )
    return f


def make_objective_fns(score, y, n_class: int, reg: float,
                       weight=None, axis=None):
    """(f, grad_f, hess_f) for the penalized negative log-likelihood.

    Gradients/Hessians of the *local* row sum are taken by AD and then
    psum-reduced explicitly (never differentiating through a
    collective), so under shard_map every device holds the identical
    global derivatives and the Newton/MH decisions below are
    deterministic across the mesh.
    """
    y = y.astype(jnp.int32)
    lower_inf = y == 0
    upper_inf = y == (n_class - 1)
    yl = jnp.clip(y - 1, 0, n_class - 2)
    yu = jnp.clip(y, 0, n_class - 2)

    def local_nll(alpha):
        gamma = alpha_to_gamma(alpha)
        lower = gamma[yl] - score
        upper = gamma[yu] - score
        ll = _interval_logprob(lower, upper, lower_inf, upper_inf)
        if weight is not None:
            ll = ll * weight
        return -jnp.sum(ll)

    def _reduce(x):
        return x if axis is None else lax.psum(x, axis)

    def f(alpha):
        return _reduce(local_nll(alpha)) + 0.5 * reg * jnp.sum(
            alpha * alpha
        )

    def grad_f(alpha):
        return _reduce(jax.grad(local_nll)(alpha)) + reg * alpha

    def hess_f(alpha):
        eye = jnp.eye(alpha.shape[0], dtype=alpha.dtype)
        return _reduce(jax.hessian(local_nll)(alpha)) + reg * eye

    return f, grad_f, hess_f


def _newton_minimize(fns, alpha0, max_iter=100, max_halvings=30,
                     epsilon=1e-5, epsilon_rel=1e-5, delta=1e-5):
    """Damped Newton with backtracking, jit-compatible.

    Mirrors ``find_minimum`` (OProbitSampler.hpp:289-357): Cholesky
    Newton direction, step-halving line search with slack ``delta``,
    termination on gradient norm (absolute/relative) or stagnation,
    NaN-guarded (a NaN trial is treated as a rejected step).

    ``fns`` is the (f, grad_f, hess_f) triple from make_objective_fns;
    each already performs the global psum under SPMD.
    """
    f, grad_f, hess_f = fns
    dtype = alpha0.dtype

    def direction(alpha, g):
        H = hess_f(alpha)
        L = jnp.linalg.cholesky(H)
        d = -jax.scipy.linalg.cho_solve((L, True), g)
        bad = jnp.any(jnp.isnan(d))
        return jnp.where(bad, -g, d)

    def line_search(alpha, fval, d):
        def body(carry):
            step, _, _, halvings = carry
            cand = alpha + step * d
            fc = f(cand)
            ok = jnp.logical_and(
                jnp.logical_not(jnp.isnan(fc)),
                fc < fval * (1.0 + delta) + 1e-12,
            )
            return (
                jnp.where(ok, step, step * 0.5),
                ok,
                fc,
                halvings + 1,
            )

        def cond(carry):
            _, ok, _, halvings = carry
            return jnp.logical_and(
                jnp.logical_not(ok), halvings < max_halvings
            )

        step, ok, fc, _ = lax.while_loop(
            cond, body, (jnp.asarray(1.0, dtype), jnp.asarray(False),
                         fval, 0)
        )
        new_alpha = jnp.where(ok, alpha + step * d, alpha)
        new_f = jnp.where(ok, fc, fval)
        return new_alpha, new_f, ok

    def body(carry):
        alpha, fval, it, _ = carry
        g = grad_f(alpha)
        d = direction(alpha, g)
        new_alpha, new_f, ok = line_search(alpha, fval, d)
        gnorm = jnp.linalg.norm(grad_f(new_alpha))
        anorm = jnp.linalg.norm(new_alpha)
        converged = jnp.logical_or(
            gnorm < epsilon, gnorm < epsilon_rel * anorm
        )
        stalled = jnp.abs(new_f - fval) <= delta * jnp.maximum(
            jnp.maximum(jnp.abs(new_f), jnp.abs(fval)), 1.0
        )
        done = jnp.logical_or(
            converged, jnp.logical_or(stalled, jnp.logical_not(ok))
        )
        return new_alpha, new_f, it + 1, done

    def cond(carry):
        _, _, it, done = carry
        return jnp.logical_and(jnp.logical_not(done), it < max_iter)

    alpha, fval, _, _ = lax.while_loop(
        cond, body,
        (alpha0, f(alpha0), 0, jnp.asarray(False)),
    )
    H = hess_f(alpha)
    return alpha, H


def _sample_mvt(key, H, nu: float, dtype):
    """x ~ multivariate-t(0, H^{-1}, ν) (OProbitSampler.hpp:57-72)."""
    k_n, k_g = jax.random.split(key)
    z = jax.random.normal(k_n, (H.shape[0],), dtype=dtype)
    L = jnp.linalg.cholesky(H)
    x = jax.scipy.linalg.solve_triangular(L.T, z, lower=False)
    chi = jax.random.gamma(k_g, jnp.asarray(nu / 2.0, dtype), dtype=dtype)
    return x / jnp.sqrt(chi * 2.0 / nu)


def _log_p_mvt(H, mu, nu: float, x):
    """Unnormalized mvt log-density (OProbitSampler.hpp:51-55)."""
    d = x - mu
    hi = lax.Precision.HIGHEST
    q = jnp.dot(d, jnp.dot(H, d, precision=hi), precision=hi)
    return jnp.log1p(q / nu) * (-nu - H.shape[0]) / 2.0


@partial(jax.jit, static_argnames=("n_class", "reg", "nu", "axis"))
def oprobit_mh_step(key, score, y, alpha_now, accept_count,
                    n_class: int, reg: float, nu: float,
                    weight=None, axis=None):
    """One Metropolis-Hastings cutpoint update
    (OProbitSampler.hpp:359-387).

    Under SPMD (``axis``) the objective/gradient/Hessian are globally
    psum-reduced and the proposal/accept key is COMMON across shards
    (the caller must not fold it per-device), so every device takes the
    identical global MH decision — the sharded chain equals the
    single-chip chain.
    """
    dtype = score.dtype
    fns = make_objective_fns(score, y, n_class, reg, weight, axis)
    f = fns[0]
    alpha_hat, H = _newton_minimize(fns, alpha_now)

    k_prop, k_u = jax.random.split(key)
    cand = alpha_hat + _sample_mvt(k_prop, H, nu, dtype)
    ll_cand = -f(cand)
    ll_old = -f(alpha_now)
    lq_cand = _log_p_mvt(H, alpha_hat, nu, cand)
    lq_old = _log_p_mvt(H, alpha_hat, nu, alpha_now)
    log_ratio = ll_cand - lq_cand - ll_old + lq_old
    u = jax.random.uniform(k_u, (), dtype=dtype)
    accept = jnp.logical_and(
        jnp.log(u) < log_ratio, jnp.logical_not(jnp.isnan(log_ratio))
    )
    alpha_new = jnp.where(accept, cand, alpha_now)
    return alpha_new, accept_count + accept.astype(jnp.int32)


def sample_z_residual(key, score, y, gamma, n_class: int, u=None):
    """e = score − z with z ~ TN(score, 1; [γ_{y-1}, γ_y])
    (OProbitSampler.hpp:238-272).  Infinite edge bounds flow through the
    two-sided log-space inverse-CDF sampler naturally.  ``u`` optionally
    supplies the uniforms (SPMD global-slice parity)."""
    dtype = score.dtype
    y = y.astype(jnp.int32)
    gpad_lo = jnp.concatenate([jnp.array([-jnp.inf], dtype), gamma])
    gpad_hi = jnp.concatenate([gamma, jnp.array([jnp.inf], dtype)])
    lower = gpad_lo[y] - score
    upper = gpad_hi[y] - score
    t = truncated_std_normal_two_sided(key, lower, upper, u=u)
    # z = score + t  =>  e = score − z = −t
    return -t


def _init_cutpoints_from_score(score, y, key, n_class, reg,
                               weight=None, axis=None, u=None):
    """Newton MAP cutpoints from initial scores + latent-residual draw."""
    fns = make_objective_fns(score, y, n_class, reg, weight, axis)
    alpha0 = jnp.zeros((n_class - 1,), score.dtype)
    alpha_hat, _ = _newton_minimize(fns, alpha0)
    gamma = alpha_to_gamma(alpha_hat)
    e = sample_z_residual(key, score, y, gamma, n_class, u=u)
    if weight is not None:
        e = e * weight
    return alpha_hat, gamma, e


# ---------------------------------------------------------------------------
# Multiple cutpoint groups
# ---------------------------------------------------------------------------
#
# The C++ engine supports several independent cutpoint samplers, one per
# CutpointGroupType entry (FMLearningConfig.hpp:15, OProbitSampler.hpp
# instantiated per group in FMTrainer.hpp:99-119) — e.g. two ordinal
# questionnaires with different scales sharing one FM.  The layout here
# encodes the group INTO the integer target: group g's classes occupy
# the offset range [Σ_{j<g} K_j, Σ_{j<g} K_j + K_g), so no per-row group
# array has to be threaded through the sweeps — membership is recovered
# as a range test on the encoded y.  Cutpoints/alphas concatenate to
# single [Σ(K_g−1)] state vectors (static per-group slices); accept
# counts are a [G] vector matching the reference's per-sampler
# LearningHistory::n_mh_accept.


def oprobit_groups_update(k_mh, k_z, score, y_enc, alpha_cat,
                          accept_counts, n_classes, reg: float,
                          nu: float, weight=None, axis=None, u=None):
    """Per-group MH cutpoint step + latent residual redraw
    (FMTrainer.hpp:513-521 looped over cutpoint groups).

    ``y_enc`` carries class-offset-encoded targets (see module note);
    ``n_classes`` is the static tuple of class counts.  Rows outside a
    group enter its objective with weight 0 and its latent draw is
    discarded for them, so each row's residual comes exactly from its
    own group's cutpoints.  The same uniform vector ``u`` (or the same
    ``k_z``) feeds every group's truncated-normal draw — each row
    consumes its uniform once, in its own group's inverse CDF.

    Returns (alpha_cat, gamma_cat, accept_counts, e)."""
    dtype = score.dtype
    y_enc = y_enc.astype(jnp.int32)
    e = jnp.zeros_like(score)
    alphas, gammas, accs = [], [], []
    yoff = 0
    aoff = 0
    for g, K in enumerate(n_classes):
        y_g = y_enc - yoff
        in_g = jnp.logical_and(y_g >= 0, y_g < K)
        m_g = in_g.astype(dtype)
        if weight is not None:
            m_g = m_g * weight
        y_gc = jnp.clip(y_g, 0, K - 1)
        a_g = alpha_cat[aoff : aoff + K - 1]
        # distinct MH randomness per group; g=0 uses the caller's key
        # unchanged so the single-group chain is bit-identical to the
        # pre-grouping implementation
        kg = k_mh if g == 0 else jax.random.fold_in(k_mh, g)
        a_new, acc_new = oprobit_mh_step(
            kg, score, y_gc, a_g, accept_counts[g], K, reg, nu,
            weight=m_g, axis=axis,
        )
        gamma_g = alpha_to_gamma(a_new)
        e_g = sample_z_residual(k_z, score, y_gc, gamma_g, K, u=u)
        e = jnp.where(in_g, e_g, e)
        alphas.append(a_new)
        gammas.append(gamma_g)
        accs.append(acc_new)
        yoff += K
        aoff += K - 1
    return (
        jnp.concatenate(alphas),
        jnp.concatenate(gammas),
        jnp.stack(accs),
        e,
    )


def init_oprobit_groups(score, y_enc, key, n_classes, reg: float,
                        weight=None, axis=None, u=None):
    """Newton MAP cutpoints per group + latent residual draw
    (the multi-group initialize_e, FMTrainer.hpp:99-119).

    Returns (alpha_cat, gamma_cat, e)."""
    dtype = score.dtype
    y_enc = y_enc.astype(jnp.int32)
    e = jnp.zeros_like(score)
    alphas, gammas = [], []
    yoff = 0
    for g, K in enumerate(n_classes):
        y_g = y_enc - yoff
        in_g = jnp.logical_and(y_g >= 0, y_g < K)
        m_g = in_g.astype(dtype)
        if weight is not None:
            m_g = m_g * weight
        y_gc = jnp.clip(y_g, 0, K - 1)
        fns = make_objective_fns(score, y_gc, K, reg, m_g, axis)
        alpha_hat, _ = _newton_minimize(
            fns, jnp.zeros((K - 1,), dtype)
        )
        gamma = alpha_to_gamma(alpha_hat)
        e_g = sample_z_residual(key, score, y_gc, gamma, K, u=u)
        e = jnp.where(in_g, e_g, e)
        alphas.append(alpha_hat)
        gammas.append(gamma)
        yoff += K
    if weight is not None:
        e = e * weight
    return jnp.concatenate(alphas), jnp.concatenate(gammas), e


def initialize_oprobit_state(plan, state, y_int, cfg, key):
    """Reference initialize_e for ORDERED (FMTrainer.hpp:99-119):
    Newton MAP for the cutpoints from the initial scores, then draw the
    latent responses."""
    import dataclasses as _dc

    from .forward import predict_score

    groups = cfg.cutpoint_group_classes

    @partial(jax.jit, static_argnames=("n_classes", "reg"))
    def init(state, y, key, n_classes, reg):
        score = predict_score(plan, state.w0, state.w, state.V)
        return init_oprobit_groups(score, y, key, n_classes, reg)

    alpha_hat, gamma, e = init(
        state, y_int, key, groups, cfg.reg_0
    )
    return _dc.replace(
        state,
        e=e,
        cutpoints=gamma,
        oprobit_alpha=alpha_hat,
        n_mh_accept=jnp.zeros((len(groups),), jnp.int32),
    )


def initialize_oprobit_core(score, core, y_int, cfg, key,
                            weight=None, u=None):
    """Like initialize_oprobit_state but from a precomputed score
    vector (used by the categorical fast path).  Returns (core, e)."""
    import dataclasses as _dc

    groups = cfg.cutpoint_group_classes
    alpha_hat, gamma, e = init_oprobit_groups(
        score, y_int, key, groups, cfg.reg_0,
        weight=weight, axis=cfg.axis_name, u=u,
    )
    core = _dc.replace(
        core,
        e=e,
        cutpoints=gamma,
        oprobit_alpha=alpha_hat,
        n_mh_accept=jnp.zeros((len(groups),), jnp.int32),
    )
    return core, e
