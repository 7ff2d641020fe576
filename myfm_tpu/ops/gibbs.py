"""Chromatic Gibbs sweep for Bayesian FMs, fully vectorized.

Re-derivation of the reference's serial per-coordinate sampler
(/root/reference/include/myfm/FMTrainer.hpp:122-522) with identical
conditional distributions:

* hyperparameter draws (α, groupwise μ/λ) are closed-form Gamma/Normal
  conditionals computed with one segment-sum per group;
* weight draws are organized by *color* (row-disjoint feature sets, see
  design.py): within a color every coordinate's conditional Normal is
  independent of the others, so one fused gather → segment-sum → draw →
  scatter step replaces up to tens of thousands of serial scalar draws.
* RelationBlock features are drawn from block-level statistics.  Where
  the reference maintains incrementally (un)synchronized caches
  (FMTrainer.hpp:396-482), this sweep keeps ground-truth per-row
  residuals ``e`` and factor sums ``q`` and recomputes the four block
  aggregates (Σe, Σq, Σq², Σeq per block row) with O(n_rows)
  segment-sums before each color — identical math, no serial state.

Per-feature Gaussian noise is drawn once per (sweep, phase, factor) and
indexed by feature id, so the colored sweep and the serial oracle
(``strategy="serial"``) produce *identical* chains — the analogue of the
reference's blocked ≡ flattened contract.

The update order matches BaseFMTrainer::update_all
(BaseFMTrainer.hpp:135-152): α → w0 → λ_w → μ_w → w → λ_V → μ_V → V → e.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..design import BlockPlan, ColorPlan, DesignPlan
from .forward import factor_q_single, predict_score
from .special import truncated_std_normal_onesided

# float32 contractions are pinned: on the GPU the default precision
# runs them in TF32 (~1e-3 relative), enough to bias the draws
_HI = lax.Precision.HIGHEST

TASK_REGRESSION = "regression"
TASK_CLASSIFICATION = "classification"
TASK_ORDERED = "ordered"


@dataclasses.dataclass(frozen=True)
class GibbsConfig:
    """Static learning configuration (reference FMLearningConfig.hpp:12-91).

    ``axis_name``/``n_devices`` configure SPMD execution: when set, the
    sweep runs inside ``shard_map`` over a row-sharded mesh — per-row
    state (e, q, COO entries) is local to each device, per-feature
    statistics are ``psum``-reduced over the axis, and weight draws are
    computed identically on every device from the reduced statistics
    (replicated V/w, zero weight traffic).
    """

    task: str = TASK_REGRESSION
    alpha_0: float = 1.0
    beta_0: float = 1.0
    gamma_0: float = 1.0
    mu_0: float = 0.0
    reg_0: float = 1.0
    fit_w0: bool = True
    fit_linear: bool = True
    nu_oprobit: int = 5
    cutpoint_scale: float = 10.0
    n_class: int = 0
    # class count per cutpoint group (FMLearningConfig.hpp:15
    # CutpointGroupType); empty = the single group of ``n_class``
    # classes.  Group g's classes occupy the encoded-target range
    # [Σ_{j<g} K_j, Σ_{j<g} K_j + K_g) — see ops/oprobit.py.
    n_classes: Tuple[int, ...] = ()
    axis_name: Optional[str] = None
    n_devices: int = 1
    # sweep_strategy="joint": draw each feature's full extended row
    # [w_j | V_{j,:}] from its exact (R+1)-dim Gaussian conditional
    # (one pass over the colors instead of 1 + R) — a valid Gibbs
    # blocking with the same posterior but a different chain from the
    # reference's per-(j, f) scan.  With fit_linear=False only the
    # R-dim factor rows are drawn jointly (ops/gibbs.sweep_V_joint).
    joint_rows: bool = False
    # static unroll factor for the color-stack scans on the joint path
    # (fewer loop iterations per sweep; see ops/joint.py)
    joint_unroll: int = 4
    # SPMD fast path: reduce-scatter each table's [B, D, D] Gram by
    # entity window and all-gather only the [B, 1+R] drawn weights —
    # ~(D²/(1+R))x less traffic than psum'ing the full Gram (e.g.
    # ~2.6 GB -> ~75 MB per sweep at B=80k, rank 128).  Falls back to
    # the psum when the entity count doesn't divide the mesh.
    gram_reduce_scatter: bool = True

    @property
    def cutpoint_group_classes(self) -> Tuple[int, ...]:
        """Static per-group class counts ((n_class,) when ungrouped)."""
        if self.n_classes:
            return self.n_classes
        return (self.n_class,) if self.n_class else ()


@dataclasses.dataclass
class GibbsState:
    w0: jax.Array  # scalar
    w: jax.Array  # [F]
    V: jax.Array  # [F, R]
    e: jax.Array  # [N] residual: score - y (reg) / score - z (probit)
    alpha: jax.Array  # scalar noise precision
    mu_w: jax.Array  # [G]
    lambda_w: jax.Array  # [G]
    mu_V: jax.Array  # [G, R]
    lambda_V: jax.Array  # [G, R]
    cutpoints: Optional[jax.Array] = None  # [K-1] (ordered probit)
    oprobit_alpha: Optional[jax.Array] = None  # [K-1] unconstrained cutpoints
    n_mh_accept: Optional[jax.Array] = None  # scalar int


jax.tree_util.register_dataclass(
    GibbsState,
    data_fields=[
        "w0", "w", "V", "e", "alpha", "mu_w", "lambda_w", "mu_V",
        "lambda_V", "cutpoints", "oprobit_alpha", "n_mh_accept",
    ],
    meta_fields=[],
)


def _draw_normal(quad, lin, noise):
    """Sample N(lin/quad, 1/quad) — reference FMTrainer.hpp:122-125."""
    return lin / quad + noise * lax.rsqrt(quad)


def _psum(x, axis):
    """All-reduce over the SPMD data axis (identity single-chip)."""
    return x if axis is None else lax.psum(x, axis)


# ---------------------------------------------------------------------------
# Hyperparameter conditionals
# ---------------------------------------------------------------------------


def draw_alpha(key, e, cfg: GibbsConfig, n_rows: int, dtype, axis=None):
    """α | e ~ Gamma((α₀+n)/2, rate=(β₀+Σe²)/2) (FMTrainer.hpp:127-145)."""
    e2 = _psum(jnp.sum(e * e), axis)
    shape = jnp.asarray((cfg.alpha_0 + n_rows) / 2.0, dtype)
    rate = (jnp.asarray(cfg.beta_0, dtype) + e2) / 2.0
    return jax.random.gamma(key, shape, dtype=dtype) / rate


def draw_lambda(key, weight, mu, group_index, group_counts, cfg: GibbsConfig):
    """Groupwise λ | w,μ ~ Gamma((α₀+n_g)/2, rate=(β₀+Σ_g dev²)/2).

    Handles both the linear weights ([F] with μ [G]) and a full factor
    matrix ([F,R] with μ [G,R]) in one vectorized call
    (FMTrainer.hpp:150-169).
    """
    dtype = weight.dtype
    n_groups = mu.shape[0]
    dev2 = (weight - mu[group_index]) ** 2
    ssq = jax.ops.segment_sum(dev2, group_index, num_segments=n_groups)
    counts = group_counts
    if weight.ndim == 2:
        counts = counts[:, None]
    shape = (cfg.alpha_0 + counts) / 2.0
    rate = (cfg.beta_0 + ssq) / 2.0
    return jax.random.gamma(key, shape.astype(dtype), dtype=dtype) / rate


def draw_mu(key, weight, lam, group_index, group_counts, cfg: GibbsConfig):
    """Groupwise μ | w,λ ~ N(lin/quad, 1/quad) (FMTrainer.hpp:174-192)."""
    dtype = weight.dtype
    n_groups = lam.shape[0]
    s = jax.ops.segment_sum(weight, group_index, num_segments=n_groups)
    counts = group_counts
    if weight.ndim == 2:
        counts = counts[:, None]
    quad = lam * (cfg.gamma_0 + counts)
    lin = lam * (cfg.gamma_0 * cfg.mu_0 + s)
    noise = jax.random.normal(key, lam.shape, dtype=dtype)
    return _draw_normal(quad, lin, noise)


def draw_w0(key, e, w0, alpha, cfg: GibbsConfig, n_rows: int, axis=None):
    """w0 | e ~ N(·) with prior precision reg₀ (FMTrainer.hpp:218-229)."""
    dtype = e.dtype
    quad = alpha * n_rows + jnp.asarray(cfg.reg_0, dtype)
    lin = alpha * (n_rows * w0 - _psum(jnp.sum(e), axis))
    noise = jax.random.normal(key, (), dtype=dtype)
    w0_new = _draw_normal(quad, lin, noise)
    return w0_new, e + (w0_new - w0)


# ---------------------------------------------------------------------------
# Linear-weight color steps
# ---------------------------------------------------------------------------


def _per_feature_prior(c: ColorPlan, group_index, lam_col, mu_col):
    g = group_index[c.feat]
    return lam_col[g], mu_col[g]


def _w_color_main(c: ColorPlan, e, w, alpha, lam_col, mu_col, noise,
                  group_index, axis=None):
    n_seg = c.feat.shape[0]
    lam, mu = _per_feature_prior(c, group_index, lam_col, mu_col)
    w_old = w[c.feat]
    xe = _psum(jax.ops.segment_sum(
        c.vals * e[c.rows], c.seg, num_segments=n_seg,
        indices_are_sorted=True,
    ), axis)
    quad = alpha * c.sx2 + lam
    lin = alpha * (c.sx2 * w_old - xe) + lam * mu
    w_new = _draw_normal(quad, lin, noise[c.feat])
    delta = w_new - w_old
    e = e.at[c.rows].add(delta[c.seg] * c.vals, unique_indices=True)
    w = w.at[c.feat].set(w_new, mode="drop", unique_indices=True)
    return e, w


def _w_color_block(b: BlockPlan, c: ColorPlan, e, w, alpha, lam_col, mu_col,
                   noise, group_index, axis=None):
    n_seg = c.feat.shape[0]
    lam, mu = _per_feature_prior(c, group_index, lam_col, mu_col)
    w_old = w[c.feat]
    e1 = _psum(
        jax.ops.segment_sum(e, b.mapper, num_segments=b.block_size), axis
    )
    xe = jax.ops.segment_sum(
        c.vals * e1[c.rows], c.seg, num_segments=n_seg,
        indices_are_sorted=True,
    )
    quad = alpha * c.sx2 + lam
    lin = alpha * (c.sx2 * w_old - xe) + lam * mu
    w_new = _draw_normal(quad, lin, noise[c.feat])
    delta = w_new - w_old
    # expand δ·x to original rows through the mapper
    dxb = jnp.zeros((b.block_size,), e.dtype).at[c.rows].add(
        delta[c.seg] * c.vals, unique_indices=True
    )
    e = e + dxb[b.mapper]
    w = w.at[c.feat].set(w_new, mode="drop", unique_indices=True)
    return e, w


# ---------------------------------------------------------------------------
# Factor (V) color steps
# ---------------------------------------------------------------------------


def _V_color_main(c: ColorPlan, e, q, v, alpha, lam_col, mu_col, noise,
                  group_index, axis=None):
    """Fused conditional draw for a row-disjoint main-table feature set.

    Exactly the serial conditional of FMTrainer.hpp:343-376: with
    h_j = x_j (q_j − x_j v_old),
    quad = α Σ h² + λ, lin = α (Σ h² v_old − Σ e h) + λ μ.
    """
    n_seg = c.feat.shape[0]
    lam, mu = _per_feature_prior(c, group_index, lam_col, mu_col)
    v_old = v[c.feat]
    ev = e[c.rows]
    qv = q[c.rows]
    h = c.vals * (qv - c.vals * v_old[c.seg])
    sq = _psum(jax.ops.segment_sum(
        h * h, c.seg, num_segments=n_seg, indices_are_sorted=True
    ), axis)
    lin = _psum(jax.ops.segment_sum(
        -ev * h, c.seg, num_segments=n_seg, indices_are_sorted=True
    ), axis)
    lin = lin + sq * v_old
    quad = alpha * sq + lam
    lin = alpha * lin + lam * mu
    v_new = _draw_normal(quad, lin, noise[c.feat])
    delta = v_new - v_old
    e = e.at[c.rows].add(delta[c.seg] * h, unique_indices=True)
    q = q.at[c.rows].add(delta[c.seg] * c.vals, unique_indices=True)
    v = v.at[c.feat].set(v_new, mode="drop", unique_indices=True)
    return e, q, v


def _V_color_block(b: BlockPlan, c: ColorPlan, e, q, v, alpha, lam_col,
                   mu_col, noise, group_index, axis=None):
    """Block-feature draw from O(n_rows) segment aggregates.

    For block feature i with block-row value x at block row m, the
    expanded rows j ∈ m contribute
      Σ h²  = Σ_m x²(Q2_m − 2 x v_old Q1_m + x² v_old² card_m)
      Σ e·h = Σ_m x (EQ_m − x v_old E1_m)
    where E1/Q1/Q2/EQ are segment sums of e, q, q², e·q over the mapper —
    the same statistics the reference accumulates incrementally through
    its c/c_S/e/e_q caches (FMTrainer.hpp:396-482).
    """
    n_seg = c.feat.shape[0]
    B = b.block_size
    lam, mu = _per_feature_prior(c, group_index, lam_col, mu_col)
    v_old = v[c.feat]

    E1 = _psum(jax.ops.segment_sum(e, b.mapper, num_segments=B), axis)
    Q1 = _psum(jax.ops.segment_sum(q, b.mapper, num_segments=B), axis)
    Q2 = _psum(jax.ops.segment_sum(q * q, b.mapper, num_segments=B), axis)
    EQ = _psum(jax.ops.segment_sum(e * q, b.mapper, num_segments=B), axis)
    card = b.cardinality

    x = c.vals
    m = c.rows
    vo = v_old[c.seg]
    sq_e = x * x * (Q2[m] - 2.0 * x * vo * Q1[m] + x * x * vo * vo * card[m])
    lin_e = -x * (EQ[m] - x * vo * E1[m])
    sq = jax.ops.segment_sum(
        sq_e, c.seg, num_segments=n_seg, indices_are_sorted=True
    )
    lin = jax.ops.segment_sum(
        lin_e, c.seg, num_segments=n_seg, indices_are_sorted=True
    )
    lin = lin + sq * v_old
    quad = alpha * sq + lam
    lin = alpha * lin + lam * mu
    v_new = _draw_normal(quad, lin, noise[c.feat])
    delta = v_new - v_old

    # apply e_j += δ x (q_j − x v_old), q_j += δ x to all original rows:
    # per-block-row coefficients a = δx, b2 = δ x² v_old, then gather.
    a = jnp.zeros((B,), e.dtype).at[m].add(
        delta[c.seg] * x, unique_indices=True
    )
    b2 = jnp.zeros((B,), e.dtype).at[m].add(
        delta[c.seg] * x * x * vo, unique_indices=True
    )
    am = a[b.mapper]
    e = e + am * q - b2[b.mapper]
    q = q + am
    v = v.at[c.feat].set(v_new, mode="drop", unique_indices=True)
    return e, q, v


# ---------------------------------------------------------------------------
# Full sweeps
# ---------------------------------------------------------------------------


def _scan_colors(stack, carry, step):
    """Run one color step per scan iteration over a ColorStack."""

    def body(carry, xs):
        c = ColorPlan(
            rows=xs.rows, vals=xs.vals, seg=xs.seg, feat=xs.feat, sx2=xs.sx2
        )
        return step(carry, c), None

    carry, _ = lax.scan(body, carry, stack)
    return carry


def _w_block_stack(b: BlockPlan, stack, e, w, alpha, lam_col, mu_col,
                   noise, group_index, axis=None):
    """Fold ``_w_color_block`` over a ColorStack in O(block_size)/color.

    The per-color conditional consumes the residual only through its
    per-block-row segment sum ``e1``; recomputing that inside the scan
    is O(n_rows) per color (the dominant cost at ML-scale, and large
    enough to hit backend dispatch limits).  Under the color's update
    ``e += dxb[mapper]`` the aggregate evolves exactly as
    ``e1 += cardinality * dxb``, so ``e1`` is carried through the scan
    and the [n_rows] residual is touched once at the end with the
    accumulated per-block-row delta.  Bitwise this reorders float
    additions relative to the recomputing form; the math is identical.
    """
    B = b.block_size
    card = b.cardinality
    e1 = _psum(
        jax.ops.segment_sum(e, b.mapper, num_segments=B), axis
    )
    zeros_b = jnp.zeros((B,), e.dtype)

    def body(carry, xs):
        e1_, acc, w_ = carry
        c = ColorPlan(
            rows=xs.rows, vals=xs.vals, seg=xs.seg, feat=xs.feat,
            sx2=xs.sx2,
        )
        n_seg = c.feat.shape[0]
        lam, mu = _per_feature_prior(c, group_index, lam_col, mu_col)
        w_old = w_[c.feat]
        xe = jax.ops.segment_sum(
            c.vals * e1_[c.rows], c.seg, num_segments=n_seg,
            indices_are_sorted=True,
        )
        quad = alpha * c.sx2 + lam
        lin = alpha * (c.sx2 * w_old - xe) + lam * mu
        w_new = _draw_normal(quad, lin, noise[c.feat])
        delta = w_new - w_old
        dxb = zeros_b.at[c.rows].add(
            delta[c.seg] * c.vals, unique_indices=True
        )
        w_ = w_.at[c.feat].set(w_new, mode="drop", unique_indices=True)
        return (e1_ + card * dxb, acc + dxb, w_), None

    (_, acc, w), _ = lax.scan(body, (e1, zeros_b, w), stack)
    e = e + acc[b.mapper]
    return e, w


def _V_block_stack(b: BlockPlan, stack, e, q, v, alpha, lam_col, mu_col,
                   noise, group_index, axis=None):
    """Fold ``_V_color_block`` over a ColorStack in O(block_size)/color.

    The conditional consumes (e, q) only through the four per-block-row
    aggregates E1 = Σe, Q1 = Σq, Q2 = Σq², EQ = Σeq.  Each color's
    update is ``e += a[mapper]·q − b2[mapper]; q += a[mapper]`` with
    per-block-row constants (a, b2), under which the aggregates evolve
    in closed form (old values on every right-hand side):

        E1 ← E1 + a·Q1 − b2·card
        EQ ← EQ + a·(Q2 + E1) + (a² − b2)·Q1 − a·b2·card
        Q2 ← Q2 + 2a·Q1 + a²·card
        Q1 ← Q1 + a·card

    so the scan body is O(block_size + color nnz) with no [n_rows]
    operation.  The residual/factor arrays are reconstructed once after
    the scan: with A = Σₖ aₖ and S = Σₖ aₖ·(Σ_{j<k} aⱼ) (the prefix
    cross-term from each color seeing the q produced by earlier ones),

        e ← e + A[mapper]·q + (S − Σb2)[mapper],   q ← q + A[mapper].
    """
    B = b.block_size
    card = b.cardinality
    E1 = _psum(jax.ops.segment_sum(e, b.mapper, num_segments=B), axis)
    Q1 = _psum(jax.ops.segment_sum(q, b.mapper, num_segments=B), axis)
    Q2 = _psum(
        jax.ops.segment_sum(q * q, b.mapper, num_segments=B), axis
    )
    EQ = _psum(
        jax.ops.segment_sum(e * q, b.mapper, num_segments=B), axis
    )
    zeros_b = jnp.zeros((B,), e.dtype)

    def body(carry, xs):
        E1_, Q1_, Q2_, EQ_, A, S, B2, v_ = carry
        c = ColorPlan(
            rows=xs.rows, vals=xs.vals, seg=xs.seg, feat=xs.feat,
            sx2=xs.sx2,
        )
        n_seg = c.feat.shape[0]
        lam, mu = _per_feature_prior(c, group_index, lam_col, mu_col)
        v_old = v_[c.feat]
        x = c.vals
        m = c.rows
        vo = v_old[c.seg]
        sq_e = x * x * (
            Q2_[m] - 2.0 * x * vo * Q1_[m] + x * x * vo * vo * card[m]
        )
        lin_e = -x * (EQ_[m] - x * vo * E1_[m])
        sq = jax.ops.segment_sum(
            sq_e, c.seg, num_segments=n_seg, indices_are_sorted=True
        )
        lin = jax.ops.segment_sum(
            lin_e, c.seg, num_segments=n_seg, indices_are_sorted=True
        )
        lin = lin + sq * v_old
        quad = alpha * sq + lam
        lin = alpha * lin + lam * mu
        v_new = _draw_normal(quad, lin, noise[c.feat])
        delta = v_new - v_old
        a = zeros_b.at[m].add(delta[c.seg] * x, unique_indices=True)
        b2 = zeros_b.at[m].add(
            delta[c.seg] * x * x * vo, unique_indices=True
        )
        E1n = E1_ + a * Q1_ - b2 * card
        EQn = EQ_ + a * (Q2_ + E1_) + (a * a - b2) * Q1_ \
            - a * b2 * card
        Q2n = Q2_ + 2.0 * a * Q1_ + a * a * card
        Q1n = Q1_ + a * card
        v_ = v_.at[c.feat].set(v_new, mode="drop", unique_indices=True)
        return (
            E1n, Q1n, Q2n, EQn, A + a, S + a * A, B2 + b2, v_
        ), None

    carry0 = (E1, Q1, Q2, EQ, zeros_b, zeros_b, zeros_b, v)
    (_, _, _, _, A, S, B2, v), _ = lax.scan(body, carry0, stack)
    am = A[b.mapper]
    e = e + am * q + (S - B2)[b.mapper]
    q = q + am
    return e, q, v


def sweep_w(plan: DesignPlan, e, w, alpha, lambda_w, mu_w, key, axis=None):
    dtype = e.dtype
    noise = jax.random.normal(key, (plan.n_features,), dtype=dtype)
    g = plan.group_index

    for c in plan.main.colors:
        e, w = _w_color_main(
            c, e, w, alpha, lambda_w, mu_w, noise, g, axis
        )
    if plan.main.color_stack is not None:
        def step(carry, c):
            e_, w_ = carry
            return _w_color_main(
                c, e_, w_, alpha, lambda_w, mu_w, noise, g, axis
            )
        e, w = _scan_colors(plan.main.color_stack, (e, w), step)

    for b in plan.blocks:
        for c in b.colors:
            e, w = _w_color_block(
                b, c, e, w, alpha, lambda_w, mu_w, noise, g, axis
            )
        if b.color_stack is not None:
            e, w = _w_block_stack(
                b, b.color_stack, e, w, alpha, lambda_w, mu_w, noise,
                g, axis,
            )
    return w, e


def sweep_V(plan: DesignPlan, e, V, alpha, lambda_V, mu_V, key, axis=None):
    rank = V.shape[1]
    if rank == 0:
        return V, e
    dtype = e.dtype
    g = plan.group_index
    keys = jax.random.split(key, rank)

    def factor_body(e, xs):
        v_col, lam_r, mu_r, k = xs
        noise = jax.random.normal(k, (plan.n_features,), dtype=dtype)
        q = factor_q_single(plan, v_col)

        for c in plan.main.colors:
            e, q, v_col = _V_color_main(
                c, e, q, v_col, alpha, lam_r, mu_r, noise, g, axis
            )
        if plan.main.color_stack is not None:
            def step(carry, c):
                return _V_color_main(
                    c, carry[0], carry[1], carry[2], alpha, lam_r, mu_r,
                    noise, g, axis,
                )
            e, q, v_col = _scan_colors(
                plan.main.color_stack, (e, q, v_col), step
            )

        for b in plan.blocks:
            for c in b.colors:
                e, q, v_col = _V_color_block(
                    b, c, e, q, v_col, alpha, lam_r, mu_r, noise, g, axis
                )
            if b.color_stack is not None:
                e, q, v_col = _V_block_stack(
                    b, b.color_stack, e, q, v_col, alpha, lam_r, mu_r,
                    noise, g, axis,
                )
        return e, v_col

    e, Vt_new = lax.scan(
        factor_body, e, (V.T, lambda_V.T, mu_V.T, keys)
    )
    return Vt_new.T, e


# ---------------------------------------------------------------------------
# Joint-row factor sweep (sweep_strategy="joint")
# ---------------------------------------------------------------------------
#
# The FM score is exactly linear in feature j's factor row V_{j,:} given
# every other weight (in ½[(Σᵢxᵢvᵢ)² − Σᵢxᵢ²vᵢ²] the own-quadratic
# cancels), so p(V_{j,:} | rest) is a single R-dimensional Gaussian
#     A = α Σₙ xₙ²φₙφₙᵀ + diag(λ),   lin = α(S v_old − Σₙ xₙeₙφₙ) + λ∘μ
# with φₙ = qₙ − xₙ v_old (the R-vector analogue of the scalar
# conditional in _V_color_main; setting R=1 recovers it exactly).
# Drawing rows jointly is a *blocked* Gibbs update: the stationary
# posterior is identical, mixing is no worse, and the factor dimension
# collapses from R sequential passes over the colors to ONE pass — the
# per-feature cost moves onto batched R×R Cholesky factorizations (dense
# batched work) instead of scan-step overhead.  The chain differs from the
# reference's per-(j, f) scan, which is why this runs only under the
# opt-in ``sweep_strategy="joint"`` (the default colored sweep remains
# the reference-order parity oracle).  The blocked ≡ flattened contract
# is preserved: same table decomposition → same statistics → same draws.


def _chol_mean_sample(S, rhs, lam, xi, alpha):
    """mean = A⁻¹ rhs and sample = mean + L⁻ᵀξ for A = αS + diag(λ).

    Routes through ops/joint.solve_spd_sample: R ≤ 32 uses the
    unrolled λ-floored solver (jnp.linalg.cholesky NaNs outright when
    float32 roundoff makes a rank-deficient S's null-direction pivot
    negative, and costs 280-470 µs per scan step vs ~5 µs unrolled);
    larger ranks keep the batched linalg path with λ-scale jitter."""
    from .joint import solve_spd_sample

    A = alpha * S + jax.vmap(jnp.diag)(lam)
    return solve_spd_sample(A, rhs, xi, lam)


def _V_joint_color_main(c: ColorPlan, e, q, V, alpha, lam_g, mu_g,
                        noise, group_index, axis=None):
    """Joint-row draw for a main-table color.  q is the full [N, R]
    factor-sum cache; V the full [F, R] table."""
    n_seg = c.feat.shape[0]
    gidx = group_index[c.feat]
    lam = lam_g[gidx, :]
    mu = mu_g[gidx, :]
    v_old = V[c.feat]  # [Pf, R]
    x = c.vals[:, None]
    phi = q[c.rows] - x * v_old[c.seg]  # [Pe, R]
    xphi = x * phi
    S = _psum(jax.ops.segment_sum(
        xphi[:, :, None] * phi[:, None, :] * x[:, :, None],
        c.seg, num_segments=n_seg, indices_are_sorted=True,
    ), axis)
    # row-wise rhs (see ops/joint._joint_u_color_main): α(S·v − Σe·xφ)
    # cancels two ‖S‖-scale aggregates and leaves absolute float32
    # noise along rank-deficient S's null directions; the per-row form
    # keeps those components zero to relative precision
    resid = (
        jnp.sum(xphi * v_old[c.seg], axis=1) - e[c.rows]
    )  # [Pe]
    r = _psum(jax.ops.segment_sum(
        xphi * resid[:, None], c.seg, num_segments=n_seg,
        indices_are_sorted=True,
    ), axis)
    rhs = alpha * r + lam * mu
    v_new = _chol_mean_sample(S, rhs, lam, noise[c.feat], alpha)
    delta = v_new - v_old
    dseg = delta[c.seg]  # [Pe, R]
    e = e.at[c.rows].add(
        jnp.sum(dseg * x * phi, axis=1), unique_indices=True
    )
    q = q.at[c.rows].add(dseg * x, unique_indices=True)
    V = V.at[c.feat].set(v_new, mode="drop", unique_indices=True)
    return e, q, V


def _block_joint_stats(b: BlockPlan, e, q, axis=None):
    """Per-block-row aggregates for the joint draw: E1 = Σe, Q1 = Σq,
    EQ = Σeq, QQ = Σqqᵀ over the mapper."""
    B = b.block_size
    E1 = _psum(jax.ops.segment_sum(e, b.mapper, num_segments=B), axis)
    Q1 = _psum(jax.ops.segment_sum(q, b.mapper, num_segments=B), axis)
    EQ = _psum(jax.ops.segment_sum(
        e[:, None] * q, b.mapper, num_segments=B
    ), axis)
    QQ = _psum(jax.ops.segment_sum(
        q[:, :, None] * q[:, None, :], b.mapper, num_segments=B
    ), axis)
    return E1, Q1, EQ, QQ


def _V_joint_block_color(b: BlockPlan, c: ColorPlan, stats, V, alpha,
                         lam_g, mu_g, noise, group_index):
    """Joint-row draw for one block color from block-row aggregates.

    Within a color, block rows are feature-disjoint, so each block row
    m carries at most one drawn feature (value x): with v = V_{j,:},
        S_j = x²(QQ_m − x(vQ1ᵀ + Q1vᵀ) + x²·card·vvᵀ)
        t_j = x(EQ_m − x E1_m v)
    and the row updates are e += q·A − b2, q += A through the mapper
    with A_m = xΔ, b2_m = x²(v_old·Δ).  Returns the per-block-row
    (A [B,R], b2 [B]) update coefficients instead of applying them, so
    callers can either apply directly (unrolled colors) or fold them
    into carried aggregates (stacked scan).
    """
    E1, Q1, EQ, QQ = stats
    card = b.cardinality
    n_seg = c.feat.shape[0]
    gidx = group_index[c.feat]
    lam = lam_g[gidx, :]
    mu = mu_g[gidx, :]
    v_old = V[c.feat]  # [Pf, R]
    B = b.block_size
    R = v_old.shape[1]

    # gather one block row per feature entry, then segment-reduce the
    # (at most one-entry) segments to feature space
    x = c.vals
    m = c.rows
    vo = v_old[c.seg]
    qm = Q1[m]
    S_e = (
        x[:, None, None] ** 2 * (
            QQ[m]
            - x[:, None, None] * (
                vo[:, :, None] * qm[:, None, :]
                + qm[:, :, None] * vo[:, None, :]
            )
            + (x**2 * card[m])[:, None, None]
            * vo[:, :, None] * vo[:, None, :]
        )
    )
    t_e = x[:, None] * (EQ[m] - (x * E1[m])[:, None] * vo)

    def seg(vals):
        return jax.ops.segment_sum(
            vals, c.seg, num_segments=n_seg, indices_are_sorted=True
        )

    S = seg(S_e)
    t = seg(t_e)
    rhs = alpha * (
        jnp.einsum("pfg,pg->pf", S, v_old, precision=_HI) - t
    ) + lam * mu
    v_new = _chol_mean_sample(S, rhs, lam, noise[c.feat], alpha)
    delta = v_new - v_old
    A = jnp.zeros((B, R), v_old.dtype).at[m].add(
        x[:, None] * delta[c.seg], unique_indices=True
    )
    b2 = jnp.zeros((B,), v_old.dtype).at[m].add(
        x * x * jnp.sum(vo * delta[c.seg], axis=1), unique_indices=True
    )
    V = V.at[c.feat].set(v_new, mode="drop", unique_indices=True)
    return V, A, b2


def _update_joint_stats(stats, A, b2, card):
    """Exact O(B·R²) aggregate recurrences under e += q·A − b2,
    q += A (per block row; old values on every right-hand side)."""
    E1, Q1, EQ, QQ = stats
    QA = jnp.einsum("br,br->b", Q1, A, precision=_HI)
    E1n = E1 + QA - b2 * card
    EQn = (
        EQ
        + jnp.einsum("bfg,bg->bf", QQ, A, precision=_HI)
        + E1[:, None] * A
        + QA[:, None] * A
        - b2[:, None] * Q1
        - (b2 * card)[:, None] * A
    )
    QQn = (
        QQ
        + A[:, :, None] * Q1[:, None, :]
        + Q1[:, :, None] * A[:, None, :]
        + card[:, None, None] * A[:, :, None] * A[:, None, :]
    )
    Q1n = Q1 + card[:, None] * A
    return E1n, Q1n, EQn, QQn


def _V_joint_block_stack(b: BlockPlan, stack, e, q, V, alpha, lam_g,
                         mu_g, noise, group_index, axis=None):
    """Fold the joint block draw over a ColorStack with O(B·R²)/color
    incremental aggregates (vector analogue of _V_block_stack):

        E1 += Q1·A − b2·card          Q1 += A·card
        QQ += A Q1ᵀ + Q1 Aᵀ + card·A Aᵀ
        EQ += QQ·A + E1·A + (Q1·A)·A − b2·Q1 − b2·card·A

    (old values on every right-hand side), with the [n_rows] caches
    reconstructed once after the scan: e += q·Atot + (S − ΣB2)[mapper]
    where S accumulates the prefix cross-term Σₖ Aₖ·P_{k−1} evaluated
    against q's running shift (see _V_block_stack)."""
    B = b.block_size
    card = b.cardinality
    E1, Q1, EQ, QQ = _block_joint_stats(b, e, q, axis)
    R = V.shape[1]
    zA = jnp.zeros((B, R), e.dtype)
    zs = jnp.zeros((B,), e.dtype)

    def body(carry, xs):
        stats, At, St, B2t, V_ = carry
        c = ColorPlan(
            rows=xs.rows, vals=xs.vals, seg=xs.seg, feat=xs.feat,
            sx2=xs.sx2,
        )
        V_, A, b2 = _V_joint_block_color(
            b, c, stats, V_, alpha, lam_g, mu_g, noise, group_index,
        )
        stats = _update_joint_stats(stats, A, b2, card)
        Stn = St + jnp.einsum("br,br->b", A, At, precision=_HI)
        return (stats, At + A, Stn, B2t + b2, V_), None

    carry0 = ((E1, Q1, EQ, QQ), zA, zs, zs, V)
    (_, At, St, B2t, V), _ = lax.scan(body, carry0, stack)
    am = At[b.mapper]  # [N, R]
    e = e + jnp.sum(am * q, axis=1) + (St - B2t)[b.mapper]
    q = q + am
    return e, q, V


def sweep_V_joint(plan: DesignPlan, e, V, alpha, lambda_V, mu_V, key,
                  axis=None):
    """One pass over the colors drawing full factor rows jointly."""
    rank = V.shape[1]
    if rank == 0:
        return V, e
    dtype = e.dtype
    g = plan.group_index
    noise = jax.random.normal(
        key, (plan.n_features, rank), dtype=dtype
    )
    from .forward import factor_q

    q = factor_q(plan, V)  # [N, R]

    for c in plan.main.colors:
        e, q, V = _V_joint_color_main(
            c, e, q, V, alpha, lambda_V, mu_V, noise, g, axis
        )
    if plan.main.color_stack is not None:
        def step(carry, xs):
            c = ColorPlan(
                rows=xs.rows, vals=xs.vals, seg=xs.seg, feat=xs.feat,
                sx2=xs.sx2,
            )
            e_, q_, V_ = carry
            return _V_joint_color_main(
                c, e_, q_, V_, alpha, lambda_V, mu_V, noise, g, axis
            ), None
        (e, q, V), _ = lax.scan(
            step, (e, q, V), plan.main.color_stack
        )

    for b in plan.blocks:
        if b.colors:
            stats = _block_joint_stats(b, e, q, axis)
            for c in b.colors:
                V, A, b2 = _V_joint_block_color(
                    b, c, stats, V, alpha, lambda_V, mu_V, noise, g
                )
                am = A[b.mapper]
                e = e + jnp.sum(am * q, axis=1) - b2[b.mapper]
                q = q + am
                stats = _update_joint_stats(stats, A, b2, b.cardinality)
        if b.color_stack is not None:
            e, q, V = _V_joint_block_stack(
                b, b.color_stack, e, q, V, alpha, lambda_V, mu_V,
                noise, g, axis,
            )
    return V, e


def refresh_e(plan: DesignPlan, state: GibbsState, w0, w, V, y, key,
              cfg: GibbsConfig):
    """Recompute residuals from scratch (FMTrainer.hpp:493-522).

    Regression: e = score − y.  Classification: redraw the latent probit
    response z ~ TN(score, 1; sign(y)) and set e = score − z.  Ordered:
    MH cutpoint step, then z ~ TN(score, 1; class interval).

    Returns (e, cutpoints, oprobit_alpha, n_mh_accept).
    """
    score = predict_score(plan, w0, w, V)

    def _mask(e):
        return e if plan.row_mask is None else e * plan.row_mask

    if cfg.task == TASK_REGRESSION:
        return _mask(score - y), None, None, None
    elif cfg.task == TASK_CLASSIFICATION:
        if cfg.axis_name is None:
            t = truncated_std_normal_onesided(key, -score, y > 0)
        else:
            # draw the global uniform vector and slice this shard's
            # chunk: all shards stay decorrelated AND the sharded chain
            # matches the single-chip chain sample-for-sample.
            dtype = score.dtype
            n_local = score.shape[0]
            tiny = jnp.finfo(dtype).tiny
            u_global = jax.random.uniform(
                key, (n_local * cfg.n_devices,), dtype=dtype,
                minval=tiny, maxval=1.0,
            )
            idx = lax.axis_index(cfg.axis_name)
            u = lax.dynamic_slice(u_global, (idx * n_local,), (n_local,))
            t = truncated_std_normal_onesided(key, -score, y > 0, u=u)
        return _mask(-t), None, None, None
    elif cfg.task == TASK_ORDERED:
        from .oprobit import oprobit_groups_update

        # k_mh stays common across shards: the MH objective is globally
        # psum-reduced, so every device takes the identical decision
        k_mh, k_z = jax.random.split(key)
        u = None
        if cfg.axis_name is not None:
            # global-uniform slice: sharded == single-chip row-for-row
            dtype = score.dtype
            n_local = score.shape[0]
            tiny = jnp.finfo(dtype).tiny
            u_global = jax.random.uniform(
                k_z, (n_local * cfg.n_devices,), dtype=dtype,
                minval=tiny, maxval=1.0,
            )
            idx = lax.axis_index(cfg.axis_name)
            u = lax.dynamic_slice(u_global, (idx * n_local,), (n_local,))
        alpha_new, gamma, acc, e = oprobit_groups_update(
            k_mh, k_z, score, y, state.oprobit_alpha,
            state.n_mh_accept, cfg.cutpoint_group_classes, cfg.reg_0,
            float(cfg.nu_oprobit), weight=plan.row_mask,
            axis=cfg.axis_name, u=u,
        )
        return _mask(e), gamma, alpha_new, acc
    raise NotImplementedError(f"refresh_e for task {cfg.task}")


def gibbs_sweep(plan: DesignPlan, state: GibbsState, y, key,
                cfg: GibbsConfig) -> GibbsState:
    """One full Gibbs iteration (BaseFMTrainer.hpp:135-152 order)."""
    dtype = state.e.dtype
    axis = cfg.axis_name
    # plan.n_rows is the per-device row count under shard_map; padded
    # rows (row_mask == 0) are excluded from the row-count statistics.
    if plan.row_mask is not None:
        n = _psum(jnp.sum(plan.row_mask), axis)
    else:
        n = plan.n_rows * cfg.n_devices
    (k_alpha, k_w0, k_lw, k_mw, k_w, k_lv, k_mv, k_v, k_e) = jax.random.split(
        key, 9
    )

    if cfg.task == TASK_REGRESSION:
        alpha = draw_alpha(k_alpha, state.e, cfg, n, dtype, axis)
    else:
        alpha = jnp.asarray(1.0, dtype)

    e = state.e
    w0 = state.w0
    if cfg.fit_w0:
        w0, e = draw_w0(k_w0, e, w0, alpha, cfg, n, axis)

    lambda_w = draw_lambda(
        k_lw, state.w, state.mu_w, plan.group_index, plan.group_counts, cfg
    )
    mu_w = draw_mu(
        k_mw, state.w, lambda_w, plan.group_index, plan.group_counts, cfg
    )
    w = state.w
    # the merged joint path draws (w_j, V_j) together below
    merged = cfg.joint_rows and cfg.fit_linear
    if cfg.fit_linear and not merged:
        w, e = sweep_w(plan, e, w, alpha, lambda_w, mu_w, k_w, axis)

    lambda_V = draw_lambda(
        k_lv, state.V, state.mu_V, plan.group_index, plan.group_counts, cfg
    )
    mu_V = draw_mu(
        k_mv, state.V, lambda_V, plan.group_index, plan.group_counts, cfg
    )
    if merged:
        from .joint import sweep_joint_u

        # q is rebuilt from V at every sweep (q=None -> factor_q), NOT
        # carried across sweeps: in float32 the incrementally-maintained
        # cache drifts, the drift biases the (S, t) draw statistics,
        # and the bias feeds back through the draws — observed as a
        # runaway chain (|V| -> 1e4/NaN within ~100 sweeps) on dense
        # main-table designs.  One O(nnz*R) rebuild per sweep is noise
        # next to the color scan, and matches the reference's per-sweep
        # cache refresh (FMTrainer.hpp:493-497).
        w, V, e, _ = sweep_joint_u(
            plan, e, w, state.V, alpha, lambda_w, mu_w, lambda_V,
            mu_V, k_v, axis, unroll=cfg.joint_unroll, q=None,
        )
    elif cfg.joint_rows:
        V, e = sweep_V_joint(
            plan, e, state.V, alpha, lambda_V, mu_V, k_v, axis
        )
    else:
        V, e = sweep_V(plan, e, state.V, alpha, lambda_V, mu_V, k_v, axis)

    # per-sweep residual refresh for EVERY task and engine (reference
    # update_e, FMTrainer.hpp:493-522).  The merged joint pass maintains
    # e = score − y exactly in exact arithmetic, but in float32 the
    # maintenance drift compounds across sweeps and feeds back into the
    # draw statistics (same runaway as the q carry above) — the one
    # re-forward per sweep pins it.
    e, cutpoints, oprobit_alpha, n_mh_accept = refresh_e(
        plan, state, w0, w, V, y, k_e, cfg
    )
    if cfg.task != TASK_ORDERED:
        cutpoints = state.cutpoints
        oprobit_alpha = state.oprobit_alpha
        n_mh_accept = state.n_mh_accept

    return GibbsState(
        w0=w0, w=w, V=V, e=e, alpha=alpha,
        mu_w=mu_w, lambda_w=lambda_w, mu_V=mu_V, lambda_V=lambda_V,
        cutpoints=cutpoints,
        oprobit_alpha=oprobit_alpha,
        n_mh_accept=n_mh_accept,
    )


def init_state(plan: DesignPlan, rank: int, init_stdev: float, key,
               cfg: GibbsConfig, dtype) -> GibbsState:
    """Weight init N(0, init_stdev²) (FM.hpp:34-45) + hyper init
    (FMTrainer.hpp:89-97).  When a fit flag is off the corresponding
    weight starts (and stays) exactly zero."""
    F = plan.n_features
    G = plan.n_groups
    k_v, k_w, k_w0 = jax.random.split(key, 3)
    V = init_stdev * jax.random.normal(k_v, (F, rank), dtype=dtype)
    if cfg.fit_linear:
        w = init_stdev * jax.random.normal(k_w, (F,), dtype=dtype)
    else:
        w = jnp.zeros((F,), dtype=dtype)
    if cfg.fit_w0:
        w0 = init_stdev * jax.random.normal(k_w0, (), dtype=dtype)
    else:
        w0 = jnp.zeros((), dtype=dtype)
    return GibbsState(
        w0=w0,
        w=w,
        V=V,
        e=jnp.zeros((plan.n_rows,), dtype=dtype),
        alpha=jnp.asarray(1.0, dtype),
        mu_w=jnp.zeros((G,), dtype=dtype),
        lambda_w=jnp.full((G,), 1e-5, dtype=dtype),
        mu_V=jnp.zeros((G, rank), dtype=dtype),
        lambda_V=jnp.full((G, rank), 1e-5, dtype=dtype),
    )
