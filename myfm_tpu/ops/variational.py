"""Coordinate-ascent variational inference (CAVI) for Bayesian FMs.

JAX re-derivation of the reference variational engine
(/root/reference/include/myfm/variational.hpp:147-915): the same
mean-field updates — posterior-mean assignments with variance
bookkeeping — executed through the chromatic color machinery of the
Gibbs sweep.  Where the reference maintains incrementally synchronized
second-moment caches (x2s/x3sv, and per-block c_x2s/c_x3sv/c_x2s_q), we
keep ground-truth per-row vectors

    q_j    = Σ_i x_{ji} V̄_i          (factor mean sum)
    x2s_j  = Σ_i x²_{ji} s_i          (factor variance sum)
    x3sv_j = Σ_i x³_{ji} s_i V̄_i

and recompute the per-block-row segment aggregates before each color
step; the conditional coefficients are algebraically identical.

Update order matches BaseFMTrainer::update_all:
α → w0 → λ_w → μ_w → w → λ_V → μ_V → V → (e, Var, ELBO).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..design import BlockPlan, ColorPlan, DesignPlan
from .forward import linear_term
from .gibbs import TASK_CLASSIFICATION, TASK_REGRESSION
from .special import (
    mean_var_truncated_normal_left,
    mean_var_truncated_normal_right,
)


@dataclasses.dataclass(frozen=True)
class VariationalConfig:
    task: str = TASK_REGRESSION
    alpha_0: float = 1.0
    beta_0: float = 1.0
    gamma_0: float = 1.0
    mu_0: float = 0.0
    reg_0: float = 1.0
    fit_w0: bool = True
    fit_linear: bool = True
    # SPMD execution (mirrors GibbsConfig): when axis_name is set the
    # CAVI sweep runs inside shard_map with rows partitioned over that
    # mesh axis — per-table Grams and residual statistics are
    # psum-reduced so every device performs the identical
    # (deterministic) coordinate updates.
    axis_name: Optional[str] = None
    n_devices: int = 1
    gram_reduce_scatter: bool = True


@dataclasses.dataclass
class VIState:
    w0: jax.Array
    w0_var: jax.Array
    w: jax.Array  # [F]
    w_var: jax.Array  # [F]
    V: jax.Array  # [F, R]
    V_var: jax.Array  # [F, R]
    e: jax.Array  # [N] mean residual
    e_var_sum: jax.Array  # scalar: Σ_j Var(score_j)
    alpha: jax.Array
    alpha_rate: jax.Array
    mu_w: jax.Array  # [G]
    mu_w_var: jax.Array  # [G]
    lambda_w: jax.Array  # [G]
    lambda_w_rate: jax.Array  # [G]
    mu_V: jax.Array  # [G, R]
    mu_V_var: jax.Array
    lambda_V: jax.Array
    lambda_V_rate: jax.Array
    elbo: jax.Array


jax.tree_util.register_dataclass(
    VIState,
    data_fields=[
        "w0", "w0_var", "w", "w_var", "V", "V_var", "e", "e_var_sum",
        "alpha", "alpha_rate", "mu_w", "mu_w_var", "lambda_w",
        "lambda_w_rate", "mu_V", "mu_V_var", "lambda_V", "lambda_V_rate",
        "elbo",
    ],
    meta_fields=[],
)


# ---------------------------------------------------------------------------
# weighted per-row cache computation (q, x2s, x3sv, ...)
# ---------------------------------------------------------------------------


def _row_cache(plan: DesignPlan, fn):
    """Σ over entries of fn(x, col) per original row, blocks gathered."""

    def table(coo_row, coo_col, coo_val, n_local):
        return jnp.zeros((n_local,), coo_val.dtype).at[coo_row].add(
            fn(coo_val, coo_col)
        )

    out = table(
        plan.main.coo_row, plan.main.coo_col, plan.main.coo_val, plan.n_rows
    )
    for b in plan.blocks:
        tb = table(b.coo_row, b.coo_col, b.coo_val, b.block_size)
        out = out + tb[b.mapper]
    return out


def _entry_weight_total(plan: DesignPlan, fn):
    """Σ over *expanded* entries of fn(x, col) (scalar)."""
    total = jnp.sum(fn(plan.main.coo_val, plan.main.coo_col))
    for b in plan.blocks:
        per_block_row = jnp.zeros(
            (b.block_size,), plan.main.coo_val.dtype
        ).at[b.coo_row].add(fn(b.coo_val, b.coo_col))
        total = total + jnp.sum(per_block_row * b.cardinality)
    return total


# ---------------------------------------------------------------------------
# hyperparameter CAVI updates (variational.hpp:248-318)
# ---------------------------------------------------------------------------


def vi_update_alpha(state: VIState, cfg, n_rows, dtype):
    if cfg.task == TASK_CLASSIFICATION:
        return jnp.asarray(1.0, dtype), jnp.asarray(1.0, dtype)
    e_all = jnp.sum(state.e * state.e) + state.e_var_sum
    exponent = jnp.asarray((cfg.alpha_0 + n_rows) / 2.0, dtype)
    rate = (cfg.beta_0 + e_all) / 2.0
    return exponent / rate, rate


def vi_update_lambda(weight, weight_var, mu, mu_var, group_index,
                     group_counts, cfg):
    """λ̂ = (α₀+n_g) / (β₀ + Σ_g[dev² + Var μ + Var w]); rate = β/2."""
    n_groups = mu.shape[0]
    dev2 = (weight - mu[group_index]) ** 2 + weight_var
    ssq = jax.ops.segment_sum(dev2, group_index, num_segments=n_groups)
    counts = group_counts
    mu_var_term = mu_var * counts if weight.ndim == 1 else None
    if weight.ndim == 2:
        counts = counts[:, None]
        mu_var_term = mu_var * counts
    shape = cfg.alpha_0 + counts
    beta = cfg.beta_0 + ssq + mu_var_term
    return shape / beta, beta / 2.0


def vi_update_mu(weight, lam, group_index, group_counts, cfg):
    n_groups = lam.shape[0]
    s = jax.ops.segment_sum(weight, group_index, num_segments=n_groups)
    counts = group_counts
    if weight.ndim == 2:
        counts = counts[:, None]
    quad = lam * (cfg.gamma_0 + counts)
    lin = lam * (cfg.gamma_0 * cfg.mu_0 + s)
    return lin / quad, 1.0 / quad


def vi_update_w0(state: VIState, cfg, n_rows):
    quad = state.alpha * n_rows + cfg.reg_0
    lin = state.alpha * (n_rows * state.w0 - jnp.sum(state.e))
    w0_new = lin / quad
    e = state.e + (w0_new - state.w0)
    return w0_new, 1.0 / quad, e


# ---------------------------------------------------------------------------
# linear-weight color steps (same conditionals as Gibbs; mean assignment)
# ---------------------------------------------------------------------------


def _vi_w_color_main(c: ColorPlan, e, w, w_var, alpha, lam_col, mu_col, g):
    n_seg = c.feat.shape[0]
    lam = lam_col[g[c.feat]]
    mu = mu_col[g[c.feat]]
    w_old = w[c.feat]
    xe = jax.ops.segment_sum(
        c.vals * e[c.rows], c.seg, num_segments=n_seg,
        indices_are_sorted=True,
    )
    quad = alpha * c.sx2 + lam
    lin = alpha * (c.sx2 * w_old - xe) + lam * mu
    w_new = lin / quad
    delta = w_new - w_old
    e = e.at[c.rows].add(delta[c.seg] * c.vals, unique_indices=True)
    w = w.at[c.feat].set(w_new, mode="drop", unique_indices=True)
    w_var = w_var.at[c.feat].set(1.0 / quad, mode="drop", unique_indices=True)
    return e, w, w_var


def _vi_w_color_block(b: BlockPlan, c: ColorPlan, e, w, w_var, alpha,
                      lam_col, mu_col, g):
    n_seg = c.feat.shape[0]
    lam = lam_col[g[c.feat]]
    mu = mu_col[g[c.feat]]
    w_old = w[c.feat]
    e1 = jax.ops.segment_sum(e, b.mapper, num_segments=b.block_size)
    xe = jax.ops.segment_sum(
        c.vals * e1[c.rows], c.seg, num_segments=n_seg,
        indices_are_sorted=True,
    )
    quad = alpha * c.sx2 + lam
    lin = alpha * (c.sx2 * w_old - xe) + lam * mu
    w_new = lin / quad
    delta = w_new - w_old
    dxb = jnp.zeros((b.block_size,), e.dtype).at[c.rows].add(
        delta[c.seg] * c.vals, unique_indices=True
    )
    e = e + dxb[b.mapper]
    w = w.at[c.feat].set(w_new, mode="drop", unique_indices=True)
    w_var = w_var.at[c.feat].set(1.0 / quad, mode="drop", unique_indices=True)
    return e, w, w_var


def _vi_w_block_stack(b: BlockPlan, stack, e, w, w_var, alpha, lam_col,
                      mu_col, g):
    """Fold ``_vi_w_color_block`` over a ColorStack in O(block_size)
    per color (same transform as ops/gibbs._w_block_stack: the
    conditional consumes the residual only through its per-block-row
    sum ``e1``, which evolves as ``e1 += cardinality * dxb``; the
    [n_rows] residual is touched once after the scan)."""
    B = b.block_size
    card = b.cardinality
    e1 = jax.ops.segment_sum(e, b.mapper, num_segments=B)
    zeros_b = jnp.zeros((B,), e.dtype)

    def body(carry, xs):
        e1_, acc, w_, wv_ = carry
        c = ColorPlan(xs.rows, xs.vals, xs.seg, xs.feat, xs.sx2)
        n_seg = c.feat.shape[0]
        lam = lam_col[g[c.feat]]
        mu = mu_col[g[c.feat]]
        w_old = w_[c.feat]
        xe = jax.ops.segment_sum(
            c.vals * e1_[c.rows], c.seg, num_segments=n_seg,
            indices_are_sorted=True,
        )
        quad = alpha * c.sx2 + lam
        lin = alpha * (c.sx2 * w_old - xe) + lam * mu
        w_new = lin / quad
        delta = w_new - w_old
        dxb = zeros_b.at[c.rows].add(
            delta[c.seg] * c.vals, unique_indices=True
        )
        w_ = w_.at[c.feat].set(w_new, mode="drop", unique_indices=True)
        wv_ = wv_.at[c.feat].set(
            1.0 / quad, mode="drop", unique_indices=True
        )
        return (e1_ + card * dxb, acc + dxb, w_, wv_), None

    (_, acc, w, w_var), _ = lax.scan(
        body, (e1, zeros_b, w, w_var), stack
    )
    e = e + acc[b.mapper]
    return e, w, w_var


def _vi_V_block_stack(b: BlockPlan, stack, carry, alpha, lam_col,
                      mu_col, g):
    """Fold ``_vi_V_color_block`` over a ColorStack in O(block_size)
    per color.  The CAVI conditional consumes the row caches only
    through seven per-block-row aggregates; under the color's updates
    (per-block-row constants a, b2, c2, c3 applied through the mapper)
    they evolve in closed form (old values on every right-hand side):

        E1   += a·Q1 − b2·card          Q1 += a·card
        Q2   += 2a·Q1 + a²·card         EQ += a·(Q2+E1) + (a²−b2)·Q1 − a·b2·card
        X2S1 += c2·card                 X3SV1 += c3·card
        QX2S += a·X2S1 + c2·Q1 + a·c2·card

    The [n_rows] caches are reconstructed once after the scan with
    A = Σa, S = Σₖ aₖ·(Σ_{j<k} aⱼ), ΣB2, ΣC2, ΣC3 (see
    ops/gibbs._V_block_stack for the prefix cross-term derivation).
    """
    e, q, x2s, x3sv, v, s = carry
    B = b.block_size
    card = b.cardinality
    E1 = jax.ops.segment_sum(e, b.mapper, num_segments=B)
    Q1 = jax.ops.segment_sum(q, b.mapper, num_segments=B)
    Q2 = jax.ops.segment_sum(q * q, b.mapper, num_segments=B)
    EQ = jax.ops.segment_sum(e * q, b.mapper, num_segments=B)
    X2S1 = jax.ops.segment_sum(x2s, b.mapper, num_segments=B)
    QX2S = jax.ops.segment_sum(q * x2s, b.mapper, num_segments=B)
    X3SV1 = jax.ops.segment_sum(x3sv, b.mapper, num_segments=B)
    zeros_b = jnp.zeros((B,), e.dtype)

    def body(scan_carry, xs):
        (E1_, Q1_, Q2_, EQ_, X2S1_, QX2S_, X3SV1_,
         A, S, B2s, C2s, C3s, v_, s_) = scan_carry
        c = ColorPlan(xs.rows, xs.vals, xs.seg, xs.feat, xs.sx2)
        n_seg = c.feat.shape[0]
        lam = lam_col[g[c.feat]]
        mu = mu_col[g[c.feat]]
        vo_f = v_[c.feat]
        so_f = s_[c.feat]
        x = c.vals
        m = c.rows
        vo = vo_f[c.seg]
        so = so_f[c.seg]
        x2 = x * x

        S_h2_e = x2 * (
            Q2_[m] - 2 * x * vo * Q1_[m] + x2 * vo * vo * card[m]
        )
        S_eh_e = x * (EQ_[m] - x * vo * E1_[m])
        S_qv_e = x2 * (X2S1_[m] - x2 * so * card[m])
        S_lcv_e = (
            x * QX2S_[m]
            - x2 * x * so * Q1_[m]
            - x2 * vo * X2S1_[m]
            + 2 * x2 * x2 * so * vo * card[m]
            - x * X3SV1_[m]
        )

        def seg(vals):
            return jax.ops.segment_sum(
                vals, c.seg, num_segments=n_seg, indices_are_sorted=True
            )

        S_h2, S_eh, S_qv, S_lcv = (
            seg(S_h2_e), seg(S_eh_e), seg(S_qv_e), seg(S_lcv_e)
        )
        quad = alpha * (S_h2 + S_qv) + lam
        lin = alpha * (-S_eh + S_h2 * vo_f - S_lcv) + lam * mu
        vn_f = lin / quad
        sn_f = 1.0 / quad
        delta = vn_f - vo_f
        dseg = delta[c.seg]
        sn = sn_f[c.seg]
        vn = vn_f[c.seg]

        a = zeros_b.at[m].add(dseg * x, unique_indices=True)
        b2 = zeros_b.at[m].add(dseg * x2 * vo, unique_indices=True)
        c2 = zeros_b.at[m].add(x2 * (sn - so), unique_indices=True)
        c3 = zeros_b.at[m].add(
            x2 * x * (sn * vn - so * vo), unique_indices=True
        )
        E1n = E1_ + a * Q1_ - b2 * card
        EQn = EQ_ + a * (Q2_ + E1_) + (a * a - b2) * Q1_ \
            - a * b2 * card
        Q2n = Q2_ + 2.0 * a * Q1_ + a * a * card
        Q1n = Q1_ + a * card
        QX2Sn = QX2S_ + a * X2S1_ + c2 * Q1_ + a * c2 * card
        X2S1n = X2S1_ + c2 * card
        X3SV1n = X3SV1_ + c3 * card
        v_ = v_.at[c.feat].set(vn_f, mode="drop", unique_indices=True)
        s_ = s_.at[c.feat].set(sn_f, mode="drop", unique_indices=True)
        return (
            E1n, Q1n, Q2n, EQn, X2S1n, QX2Sn, X3SV1n,
            A + a, S + a * A, B2s + b2, C2s + c2, C3s + c3, v_, s_,
        ), None

    carry0 = (
        E1, Q1, Q2, EQ, X2S1, QX2S, X3SV1,
        zeros_b, zeros_b, zeros_b, zeros_b, zeros_b, v, s,
    )
    out, _ = lax.scan(body, carry0, stack)
    A, S, B2s, C2s, C3s, v, s = out[7:]
    am = A[b.mapper]
    e = e + am * q + (S - B2s)[b.mapper]
    q = q + am
    x2s = x2s + C2s[b.mapper]
    x3sv = x3sv + C3s[b.mapper]
    return e, q, x2s, x3sv, v, s


def vi_sweep_w(plan: DesignPlan, e, w, w_var, alpha, lambda_w, mu_w):
    g = plan.group_index

    for c in plan.main.colors:
        e, w, w_var = _vi_w_color_main(
            c, e, w, w_var, alpha, lambda_w, mu_w, g
        )
    if plan.main.color_stack is not None:
        def body(carry, xs):
            c = ColorPlan(xs.rows, xs.vals, xs.seg, xs.feat, xs.sx2)
            return _vi_w_color_main(
                c, carry[0], carry[1], carry[2], alpha, lambda_w, mu_w, g
            ), None
        (e, w, w_var), _ = lax.scan(
            body, (e, w, w_var), plan.main.color_stack
        )
    for b in plan.blocks:
        for c in b.colors:
            e, w, w_var = _vi_w_color_block(
                b, c, e, w, w_var, alpha, lambda_w, mu_w, g
            )
        if b.color_stack is not None:
            e, w, w_var = _vi_w_block_stack(
                b, b.color_stack, e, w, w_var, alpha, lambda_w, mu_w, g
            )
    return e, w, w_var


# ---------------------------------------------------------------------------
# factor (V) color steps with variance corrections
# ---------------------------------------------------------------------------


def _vi_V_color_main(c: ColorPlan, carry, alpha, lam_col, mu_col, g):
    """CAVI conditional for V_{i,r} (variational.hpp:504-554):
    quad = α[Σ h̄² + Σ x² x2s₋ᵢ] + λ
    lin  = α[−Σ e h̄ + (Σ h̄²) v̄_old − Σ(h̄ x2s₋ᵢ − x x3sv₋ᵢ)] + λ μ
    """
    e, q, x2s, x3sv, v, s = carry
    n_seg = c.feat.shape[0]
    lam = lam_col[g[c.feat]]
    mu = mu_col[g[c.feat]]
    vo_f = v[c.feat]
    so_f = s[c.feat]
    vo = vo_f[c.seg]
    so = so_f[c.seg]
    x = c.vals
    x2 = x * x

    qv = q[c.rows]
    ev = e[c.rows]
    h = x * (qv - x * vo)
    x2e = x2s[c.rows] - x2 * so  # exclude own variance
    x3e = x3sv[c.rows] - x2 * x * so * vo

    S_h2 = jax.ops.segment_sum(
        h * h, c.seg, num_segments=n_seg, indices_are_sorted=True
    )
    S_eh = jax.ops.segment_sum(
        ev * h, c.seg, num_segments=n_seg, indices_are_sorted=True
    )
    S_qv = jax.ops.segment_sum(
        x2 * x2e, c.seg, num_segments=n_seg, indices_are_sorted=True
    )
    S_lcv = jax.ops.segment_sum(
        h * x2e - x * x3e, c.seg, num_segments=n_seg,
        indices_are_sorted=True,
    )
    quad = alpha * (S_h2 + S_qv) + lam
    lin = alpha * (-S_eh + S_h2 * vo_f - S_lcv) + lam * mu
    vn_f = lin / quad
    sn_f = 1.0 / quad
    delta = vn_f - vo_f
    dseg = delta[c.seg]
    sn = sn_f[c.seg]

    e = e.at[c.rows].add(dseg * h, unique_indices=True)
    q = q.at[c.rows].add(dseg * x, unique_indices=True)
    x2s = x2s.at[c.rows].add(x2 * (sn - so), unique_indices=True)
    x3sv = x3sv.at[c.rows].add(
        x2 * x * (sn * vn_f[c.seg] - so * vo), unique_indices=True
    )
    v = v.at[c.feat].set(vn_f, mode="drop", unique_indices=True)
    s = s.at[c.feat].set(sn_f, mode="drop", unique_indices=True)
    return e, q, x2s, x3sv, v, s


def _vi_V_color_block(b: BlockPlan, c: ColorPlan, carry, alpha, lam_col,
                      mu_col, g):
    """Block-feature CAVI step from segment aggregates over the mapper.

    Full-row re-derivation of the reference's c/c_S/e/e_q/c_x2s/c_x3sv/
    c_x2s_q cache algebra (variational.hpp:556-709): for block feature i
    with value x at block row m (card members, aggregates E1,Q1,Q2,EQ,
    X2S1,QX2S,X3SV1 over members j):
      Σ h̄²        = x²(Q2 − 2x v̄ Q1 + x² v̄² card)
      Σ e h̄        = x(EQ − x v̄ E1)
      Σ x² x2s₋ᵢ    = x²(X2S1 − x² s̄ card)
      Σ(h̄ x2s₋ᵢ − x x3sv₋ᵢ)
                    = x QX2S − x³ s̄ Q1 − x² v̄ X2S1 + 2 x⁴ s̄ v̄ card
                      − x X3SV1
    """
    e, q, x2s, x3sv, v, s = carry
    n_seg = c.feat.shape[0]
    B = b.block_size
    lam = lam_col[g[c.feat]]
    mu = mu_col[g[c.feat]]
    vo_f = v[c.feat]
    so_f = s[c.feat]

    E1 = jax.ops.segment_sum(e, b.mapper, num_segments=B)
    Q1 = jax.ops.segment_sum(q, b.mapper, num_segments=B)
    Q2 = jax.ops.segment_sum(q * q, b.mapper, num_segments=B)
    EQ = jax.ops.segment_sum(e * q, b.mapper, num_segments=B)
    X2S1 = jax.ops.segment_sum(x2s, b.mapper, num_segments=B)
    QX2S = jax.ops.segment_sum(q * x2s, b.mapper, num_segments=B)
    X3SV1 = jax.ops.segment_sum(x3sv, b.mapper, num_segments=B)
    card = b.cardinality

    x = c.vals
    m = c.rows
    vo = vo_f[c.seg]
    so = so_f[c.seg]
    x2 = x * x

    S_h2_e = x2 * (Q2[m] - 2 * x * vo * Q1[m] + x2 * vo * vo * card[m])
    S_eh_e = x * (EQ[m] - x * vo * E1[m])
    S_qv_e = x2 * (X2S1[m] - x2 * so * card[m])
    S_lcv_e = (
        x * QX2S[m]
        - x2 * x * so * Q1[m]
        - x2 * vo * X2S1[m]
        + 2 * x2 * x2 * so * vo * card[m]
        - x * X3SV1[m]
    )

    def seg(vals):
        return jax.ops.segment_sum(
            vals, c.seg, num_segments=n_seg, indices_are_sorted=True
        )

    S_h2, S_eh, S_qv, S_lcv = seg(S_h2_e), seg(S_eh_e), seg(S_qv_e), seg(
        S_lcv_e
    )
    quad = alpha * (S_h2 + S_qv) + lam
    lin = alpha * (-S_eh + S_h2 * vo_f - S_lcv) + lam * mu
    vn_f = lin / quad
    sn_f = 1.0 / quad
    delta = vn_f - vo_f
    dseg = delta[c.seg]
    sn = sn_f[c.seg]
    vn = vn_f[c.seg]

    # per-block-row update coefficients, gathered to original rows
    a = jnp.zeros((B,), e.dtype).at[m].add(dseg * x, unique_indices=True)
    b2 = jnp.zeros((B,), e.dtype).at[m].add(
        dseg * x2 * vo, unique_indices=True
    )
    c2 = jnp.zeros((B,), e.dtype).at[m].add(
        x2 * (sn - so), unique_indices=True
    )
    c3 = jnp.zeros((B,), e.dtype).at[m].add(
        x2 * x * (sn * vn - so * vo), unique_indices=True
    )
    am = a[b.mapper]
    e = e + am * q - b2[b.mapper]
    q = q + am
    x2s = x2s + c2[b.mapper]
    x3sv = x3sv + c3[b.mapper]
    v = v.at[c.feat].set(vn_f, mode="drop", unique_indices=True)
    s = s.at[c.feat].set(sn_f, mode="drop", unique_indices=True)
    return e, q, x2s, x3sv, v, s


def vi_V_factor(plan: DesignPlan, e, v_col, s_col, alpha, lam_r, mu_r):
    """One factor of the CAVI V sweep: (e, v_col, s_col) → updated."""
    g = plan.group_index
    q = _row_cache(plan, lambda x, col: x * v_col[col])
    x2s = _row_cache(plan, lambda x, col: x * x * s_col[col])
    x3sv = _row_cache(
        plan, lambda x, col: x * x * x * s_col[col] * v_col[col]
    )
    carry = (e, q, x2s, x3sv, v_col, s_col)
    for c in plan.main.colors:
        carry = _vi_V_color_main(c, carry, alpha, lam_r, mu_r, g)
    if plan.main.color_stack is not None:
        def body(carry, xs):
            c = ColorPlan(xs.rows, xs.vals, xs.seg, xs.feat, xs.sx2)
            return _vi_V_color_main(c, carry, alpha, lam_r, mu_r, g), None
        carry, _ = lax.scan(body, carry, plan.main.color_stack)
    for b in plan.blocks:
        for c in b.colors:
            carry = _vi_V_color_block(b, c, carry, alpha, lam_r, mu_r, g)
        if b.color_stack is not None:
            carry = _vi_V_block_stack(
                b, b.color_stack, carry, alpha, lam_r, mu_r, g
            )
    return carry[0], carry[4], carry[5]


def vi_sweep_V(plan: DesignPlan, e, V, V_var, alpha, lambda_V, mu_V):
    rank = V.shape[1]
    if rank == 0:
        return e, V, V_var

    def factor_body(e, xs):
        v_col, s_col, lam_r, mu_r = xs
        e, v_new, s_new = vi_V_factor(
            plan, e, v_col, s_col, alpha, lam_r, mu_r
        )
        return e, (v_new, s_new)

    e, (Vt, St) = lax.scan(
        factor_body, e, (V.T, V_var.T, lambda_V.T, mu_V.T)
    )
    return e, Vt.T, St.T


# ---------------------------------------------------------------------------
# e / Var(score) / ELBO refresh (variational.hpp:715-914)
# ---------------------------------------------------------------------------


def vi_e_var_linear(plan: DesignPlan, w0, w0_var, w, w_var):
    """Order-0/1 part of the residual/variance refresh."""
    n = plan.n_rows
    e = w0 + linear_term(plan, w)
    e_var_sum = n * w0_var + _entry_weight_total(
        plan, lambda x, col: x * x * w_var[col]
    )
    return e, e_var_sum


def vi_e_var_factor(plan: DesignPlan, e, e_var_sum, v, s):
    """One factor's contribution to the residual/variance refresh
    (variational.hpp:715-833)."""
    q = _row_cache(plan, lambda x, col: x * v[col])
    q_s = _row_cache(plan, lambda x, col: x * x * v[col] * v[col])
    x2s = _row_cache(plan, lambda x, col: x * x * s[col])
    x3sv = _row_cache(plan, lambda x, col: x**3 * s[col] * v[col])
    x4s2 = _row_cache(plan, lambda x, col: x**4 * s[col] * s[col])
    x4sv2 = _row_cache(
        plan, lambda x, col: x**4 * s[col] * v[col] * v[col]
    )
    e = e + 0.5 * (q * q - q_s)
    # per-row Var of the pairwise term (variational.hpp:829-830)
    e_var_sum = e_var_sum + jnp.sum(
        q * q * x2s + 0.5 * x2s * x2s - 2.0 * x3sv * q
        - 0.5 * x4s2 + x4sv2
    )
    return e, e_var_sum


def vi_update_e_and_var(plan: DesignPlan, w0, w0_var, w, w_var, V, V_var):
    e, e_var_sum = vi_e_var_linear(plan, w0, w0_var, w, w_var)
    for r in range(V.shape[1]):
        e, e_var_sum = vi_e_var_factor(
            plan, e, e_var_sum, V[:, r], V_var[:, r]
        )
    return e, e_var_sum


def _safe_log(x):
    return jnp.where(x > 0, jnp.log(jnp.maximum(x, 1e-300)), 0.0)


def vi_update_e(plan: DesignPlan, state: VIState, y, cfg) -> VIState:
    e, e_var_sum = vi_update_e_and_var(
        plan, state.w0, state.w0_var, state.w, state.w_var, state.V,
        state.V_var,
    )
    return vi_finish_e(plan, state, e, e_var_sum, y, cfg)


def vi_finish_e(plan: DesignPlan, state: VIState, e, e_var_sum, y,
                cfg) -> VIState:
    """Task residual + ELBO given the recomputed (e, e_var_sum)."""
    elbo = jnp.asarray(0.0, e.dtype)
    if cfg.task == TASK_REGRESSION:
        e = e - y
    elif cfg.task == TASK_CLASSIFICATION:
        pred = e
        m_l, v_l, z_l = mean_var_truncated_normal_left(pred)
        m_r, v_r, z_r = mean_var_truncated_normal_right(pred)
        mean = jnp.where(y > 0, m_l, m_r)
        logz = jnp.where(y > 0, z_l, z_r)
        e = pred - mean
        elbo = elbo + jnp.sum(logz + 0.5 * (mean - pred) ** 2)
    else:
        raise NotImplementedError(
            "Ordered probit for variational FM is not implemented "
            "(parity with the reference, variational.hpp:857-859)."
        )

    # ELBO accumulation (variational.hpp:861-913)
    elbo = elbo - state.alpha * (
        cfg.beta_0 + jnp.sum(e * e) + e_var_sum
    ) / 2.0
    elbo = elbo + state.alpha * state.alpha_rate * (
        1.0 - _safe_log(state.alpha_rate)
    )
    elbo = elbo - cfg.gamma_0 * (
        state.w0 * state.w0 + state.w0_var
    ) + 0.5 * _safe_log(state.w0_var)

    g = plan.group_index
    G = plan.n_groups
    counts = plan.group_counts

    # linear-weight group terms
    dev2_w = (state.w - state.mu_w[g]) ** 2
    rate_w = (
        cfg.beta_0
        + jax.ops.segment_sum(
            dev2_w + state.w_var, g, num_segments=G
        )
        + state.mu_w_var * counts
    )
    elbo = elbo + jnp.sum(0.5 * _safe_log(state.mu_w_var))
    elbo = elbo + jnp.sum(0.5 * _safe_log(state.w_var))
    elbo = elbo + jnp.sum(
        state.lambda_w * (-rate_w / 2.0 + state.lambda_w_rate)
    )
    elbo = elbo - jnp.sum(
        state.lambda_w * state.lambda_w_rate
        * _safe_log(state.lambda_w_rate)
    )
    elbo = elbo - jnp.sum(0.5 * (state.mu_w - cfg.mu_0) ** 2)

    # factor group terms
    if state.V.shape[1] > 0:
        dev2_V = (state.V - state.mu_V[g, :]) ** 2
        rate_V = (
            cfg.beta_0
            + jax.ops.segment_sum(
                dev2_V + state.V_var, g, num_segments=G
            )
            + state.mu_V_var * counts[:, None]
        )
        elbo = elbo + jnp.sum(0.5 * _safe_log(state.mu_V_var))
        elbo = elbo + jnp.sum(0.5 * _safe_log(state.V_var))
        elbo = elbo + jnp.sum(
            state.lambda_V * (-rate_V / 2.0 + state.lambda_V_rate)
        )
        elbo = elbo - jnp.sum(
            state.lambda_V * state.lambda_V_rate
            * _safe_log(state.lambda_V_rate)
        )

    return dataclasses.replace(state, e=e, e_var_sum=e_var_sum, elbo=elbo)


def vi_sweep_stage_a(plan: DesignPlan, state: VIState,
                     cfg: VariationalConfig) -> VIState:
    """Hyperparameter + linear stages of the CAVI iteration (everything
    before the factor sweep)."""
    dtype = state.e.dtype
    n = plan.n_rows

    alpha, alpha_rate = vi_update_alpha(state, cfg, n, dtype)
    state = dataclasses.replace(state, alpha=alpha, alpha_rate=alpha_rate)

    if cfg.fit_w0:
        w0, w0_var, e = vi_update_w0(state, cfg, n)
        state = dataclasses.replace(state, w0=w0, w0_var=w0_var, e=e)

    lambda_w, lambda_w_rate = vi_update_lambda(
        state.w, state.w_var, state.mu_w, state.mu_w_var,
        plan.group_index, plan.group_counts, cfg,
    )
    mu_w, mu_w_var = vi_update_mu(
        state.w, lambda_w, plan.group_index, plan.group_counts, cfg
    )
    state = dataclasses.replace(
        state, lambda_w=lambda_w, lambda_w_rate=lambda_w_rate,
        mu_w=mu_w, mu_w_var=mu_w_var,
    )
    if cfg.fit_linear:
        e, w, w_var = vi_sweep_w(
            plan, state.e, state.w, state.w_var, state.alpha,
            state.lambda_w, state.mu_w,
        )
        state = dataclasses.replace(state, e=e, w=w, w_var=w_var)

    lambda_V, lambda_V_rate = vi_update_lambda(
        state.V, state.V_var, state.mu_V, state.mu_V_var,
        plan.group_index, plan.group_counts, cfg,
    )
    mu_V, mu_V_var = vi_update_mu(
        state.V, lambda_V, plan.group_index, plan.group_counts, cfg
    )
    state = dataclasses.replace(
        state, lambda_V=lambda_V, lambda_V_rate=lambda_V_rate,
        mu_V=mu_V, mu_V_var=mu_V_var,
    )
    return state


def vi_sweep(plan: DesignPlan, state: VIState, y,
             cfg: VariationalConfig) -> VIState:
    """One full CAVI iteration."""
    state = vi_sweep_stage_a(plan, state, cfg)
    e, V, V_var = vi_sweep_V(
        plan, state.e, state.V, state.V_var, state.alpha,
        state.lambda_V, state.mu_V,
    )
    state = dataclasses.replace(state, e=e, V=V, V_var=V_var)

    return vi_update_e(plan, state, y, cfg)


def vi_init_state(plan: DesignPlan, rank: int, init_stdev: float, key,
                  cfg: VariationalConfig, dtype) -> VIState:
    """Reference VariationalFM::initialize_weight (variational.hpp:70-89)
    + initialize_hyper (variational.hpp:219-232)."""
    F = plan.n_features
    G = plan.n_groups
    k_v, k_w, k_w0 = jax.random.split(key, 3)
    V = init_stdev * jax.random.normal(k_v, (F, rank), dtype=dtype)
    V_var = jnp.full((F, rank), init_stdev**2, dtype=dtype)
    if cfg.fit_linear:
        w = init_stdev * jax.random.normal(k_w, (F,), dtype=dtype)
        w_var = jnp.full((F,), init_stdev**2, dtype=dtype)
    else:
        w = jnp.zeros((F,), dtype=dtype)
        w_var = jnp.zeros((F,), dtype=dtype)
    if cfg.fit_w0:
        w0 = init_stdev * jax.random.normal(k_w0, (), dtype=dtype)
        w0_var = jnp.asarray(1.0, dtype)
    else:
        w0 = jnp.zeros((), dtype=dtype)
        w0_var = jnp.zeros((), dtype=dtype)
    return VIState(
        w0=w0,
        w0_var=w0_var,
        w=w,
        w_var=w_var,
        V=V,
        V_var=V_var,
        e=jnp.zeros((plan.n_rows,), dtype=dtype),
        e_var_sum=jnp.asarray(0.0, dtype),
        alpha=jnp.asarray(1.0, dtype),
        # global row count under SPMD (n_real == n_rows single-chip)
        alpha_rate=jnp.asarray(
            getattr(plan, "n_real", plan.n_rows) * 0.5, dtype
        ),
        mu_w=jnp.zeros((G,), dtype=dtype),
        mu_w_var=jnp.ones((G,), dtype=dtype),
        lambda_w=jnp.full((G,), 1e-5, dtype=dtype),
        lambda_w_rate=jnp.ones((G,), dtype=dtype),
        mu_V=jnp.zeros((G, rank), dtype=dtype),
        mu_V_var=jnp.ones((G, rank), dtype=dtype),
        lambda_V=jnp.full((G, rank), 1e-5, dtype=dtype),
        lambda_V_rate=jnp.ones((G, rank), dtype=dtype),
        elbo=jnp.asarray(0.0, dtype),
    )
