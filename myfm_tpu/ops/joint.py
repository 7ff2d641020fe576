"""Merged (R+1)-dimensional joint-row Gibbs sweep (sweep_strategy="joint").

The FM score is exactly linear in feature j's extended weight row
u_j = [w_j | V_{j,:}] given every other weight: with φ_n = q_n − x v_old
the per-row regressor is ψ_n = x·[1 | φ_n], so

    p(u_j | rest) = N(A⁻¹ rhs, A⁻¹),
    A = α Σ_n ψψᵀ + diag([λ_w, λ_V]),
    rhs = α (S u_old − Σ_n e_n ψ_n) + λ∘μ,   S = Σ_n ψψᵀ.

One pass over the colors draws BOTH the linear weight and the whole
factor row — replacing the reference's separate w sweep and R factor
sweeps (FMTrainer.hpp:231-486) with a single blocked-Gibbs pass whose
stationary distribution is identical.  This supersedes the round-1
two-pass joint sweep (sweep_w + sweep_V_joint in ops/gibbs.py, kept as
the ``fit_linear=False`` fallback).

Design decisions:

* every color stack scans with a static unroll factor (fewer loop
  iterations, each with more fused work);
* the batched Cholesky/solve below is hand-unrolled: every
  intermediate is a plain [batch]-vector op with no XLA control flow,
  where ``jnp.linalg.cholesky`` + triangular solves would add library
  calls inside every scan step at these tiny [Pf, D', D'] sizes.
* Block statistics live in ONE symmetric per-block-row Gram
      Ĝ_m = Σ_{n: m(n)=m} z zᵀ,  z = [1, e_n, q_n] ∈ R^{R+2},
  which contains card, Σe, Σq, Σeq, Σqqᵀ (and Σe², used by nothing but
  kept for free).  The color step's residual/factor updates
  e += a0 + q·A, q += A (per block row) are the linear map
  z ← T z, T = I + e₁sᵀ + ŝe₀ᵀ with s = [a0, 0, A], ŝ = [0, 0, A], so
  the aggregates evolve EXACTLY as Ĝ ← T Ĝ Tᵀ, implemented as two
  symmetric rank-structure updates:
      p = Ĝs + ½(sᵀĜs)e₁ + (sᵀĜe₀)ŝ,   r = Ĝe₀ + ½Ĝ₀₀ŝ,
      Ĝ += e₁pᵀ + pe₁ᵀ + ŝrᵀ + rŝᵀ.
* Per-entry draw statistics are gathered from Ĝ once and reduced with
  ONE segment-sum of a packed [Pe, D'+3, D'] tensor (Σx²Ĝ, ΣxĜ[1,:],
  Σx³Ĝ[0,:], Σx⁴Ĝ[0,:]), from which S and t are assembled with the
  v_old border terms:
      S[0,0]  = Σx²card,         S[0,1:] = Σx²Q1 − (Σx³card)v
      S[1:,1:] = Σx²QQ − v(Σx³Q1)ᵀ − (Σx³Q1)vᵀ + (Σx⁴card)vvᵀ
      t[0]    = ΣxE1,            t[1:]   = ΣxEQ − (Σx²E1)v.

Float32 note: the MAIN-table color step assembles its rhs ROW-WISE as
α·Σψ(ψᵀu−e) (see _joint_u_color_main) so rank-deficient-S null
components stay zero to relative precision.  The block paths CANNOT —
their statistics come from the compressed Ĝ, whose entries are
separately-rounded aggregates, so an α(S·u−t)-style cancellation is
inherent to the Gram design.  The residual absolute noise there is
eps·(per-entity aggregate scale), which stays ≪ λ as long as scores
stay moderate — guaranteed in the regime the auto gate admits (large
hyper-groups ⇒ tight λ ⇒ no score blow-ups; verified by a 2000-sweep
f32 stress run on a blocked design incl. cold entities).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..design import BlockPlan, ColorPlan, DenseColor, DesignPlan
from .forward import factor_q

_HI = lax.Precision.HIGHEST


def _psum(x, axis):
    return x if axis is None else lax.psum(x, axis)


# ---------------------------------------------------------------------------
# Hand-unrolled batched Cholesky sampler
# ---------------------------------------------------------------------------


def chol_solve_sample(A, rhs, xi, pivot_floor=None):
    """sample = A⁻¹rhs + L⁻ᵀξ for batched SPD A [B, D, D], unrolled.

    L⁻ᵀ(L⁻¹rhs + ξ) via one forward and one backward substitution (two
    triangular solves — the textbook three-solve form is one more).
    Everything is a [B]-vector op: no XLA While/Scan, so the whole draw
    fuses into a handful of kernels (see module docstring).

    ``pivot_floor`` [B, D]: a per-coordinate lower bound on the exact
    Cholesky pivots.  For A = αS + diag(λ) with S PSD, every Schur
    complement stays ⪰ the remaining diag(λ) block, so pivot_j ≥ λ_j
    EXACTLY — pass λ here.  This matters when S is rank-deficient
    (features whose co-active span is < R, e.g. few overlapping
    features or cold entities): float32 roundoff in the assembled S is
    then absolute-scale (~eps·‖S‖, possibly ≫ λ) and can push a
    null-direction pivot toward 0 or negative; the eps-scale fallback
    floor below admits draw noise ~ ‖S‖/pivot, which was observed to
    inflate |V| by 100s and collapse the λ draws (a runaway chain).
    Flooring at λ restores the prior-bounded draw variance the exact
    conditional has — healthy pivots are untouched.
    """
    B, D, _ = A.shape
    dtype = A.dtype
    # fallback floor: float32 cancellation in the assembled S can push
    # a numerically-degenerate pivot non-positive (observed on ordered
    # probit at ML-100k timesvdpp scale, alpha pinned to 1) — clamp it
    # relative to the diagonal so the factorization never NaNs
    eps8 = 8.0 * jnp.finfo(dtype).eps
    cols = []  # cols[j]: column j of L as [B, D] (rows < j zeroed)
    for j in range(D):
        col = A[:, :, j]
        for k in range(j):
            col = col - cols[k] * cols[k][:, j : j + 1]
        floor_j = eps8 * jnp.abs(A[:, j, j]) + jnp.finfo(dtype).tiny
        if pivot_floor is not None:
            floor_j = jnp.maximum(floor_j, pivot_floor[:, j])
        pivot = jnp.maximum(col[:, j], floor_j)
        inv_d = lax.rsqrt(pivot)
        colj = (col.at[:, j].set(pivot)) * inv_d[:, None]
        mask = (jnp.arange(D) >= j).astype(dtype)
        cols.append(colj * mask)
    # forward: L z = rhs
    z = []
    for j in range(D):
        acc = rhs[:, j]
        for k in range(j):
            acc = acc - cols[k][:, j] * z[k]
        z.append(acc / cols[j][:, j])
    zx = jnp.stack(z, axis=1) + xi
    # backward: Lᵀ s = z + ξ
    s = [None] * D
    for j in reversed(range(D)):
        acc = zx[:, j]
        for k in range(j + 1, D):
            acc = acc - cols[j][:, k] * s[k]
        s[j] = acc / cols[j][:, j]
    return jnp.stack(s, axis=1)


def solve_spd_sample(A, rhs, xi, lam):
    """A⁻¹rhs + L⁻ᵀξ for batched A = αS + diag(λ), S PSD.

    D ≤ 32 uses the unrolled clamped solver (pivots floored at λ, the
    exact lower bound); an explicit sweep_strategy="joint" carries no
    rank gate, and beyond D=32 the unrolled form would inline O(D²)
    vector ops per draw site into the traced program — large ranks use
    batched linalg with a diagonal ridge instead.  The exact pivots are
    ≥ λ, but the *computed* ones carry ~D·eps·max(diag A) absolute
    roundoff (for PSD A the largest element sits on the diagonal),
    which can exceed λ outright when αS is rank-deficient and
    ‖αS‖ ≫ λ — jnp.linalg.cholesky then silently NaNs.  The ridge is
    therefore scaled to (2D+64)·eps·max(diag) per batch element, an
    upper bound on that roundoff, perturbing the conditional at
    relative O(D·eps) — far below the draw's own noise."""
    D = A.shape[-1]
    if D <= 32:
        return chol_solve_sample(A, rhs, xi, pivot_floor=lam)
    diag_max = jnp.max(
        jnp.diagonal(A, axis1=-2, axis2=-1), axis=-1, keepdims=True
    )
    ridge = (2.0 * D + 64.0) * jnp.finfo(A.dtype).eps * jnp.maximum(
        diag_max, lam
    )
    A = A + jax.vmap(jnp.diag)(jnp.broadcast_to(ridge, lam.shape))
    L = jnp.linalg.cholesky(A)

    def solve_one(Lp, rp, xp):
        z = jax.scipy.linalg.solve_triangular(Lp, rp, lower=True)
        # one upper solve serves mean + noise: L⁻ᵀ(z + ξ)
        return jax.scipy.linalg.solve_triangular(
            Lp.T, z + xp, lower=False
        )

    return jax.vmap(solve_one)(L, rhs, xi)


def _draw_u(S, t, u_old, lam, mu, alpha, xi):
    """Draw u_new ~ p(u | rest) from (S, t) statistics (module doc)."""
    A = alpha * S + jax.vmap(jnp.diag)(lam)
    rhs = alpha * (
        jnp.einsum("pfg,pg->pf", S, u_old, precision=_HI) - t
    ) + lam * mu
    return solve_spd_sample(A, rhs, xi, lam)


# ---------------------------------------------------------------------------
# Main-table color step (direct per-row state)
# ---------------------------------------------------------------------------


def _joint_u_color_main(c: ColorPlan, e, q, U, alpha, lam_gu, mu_gu,
                        noise, group_index, axis=None):
    """(R+1)-joint draw for a row-disjoint main-table feature set."""
    n_seg = c.feat.shape[0]
    gidx = group_index[c.feat]
    lam = lam_gu[gidx]
    mu = mu_gu[gidx]
    u_old = U[c.feat]  # [Pf, R+1]
    v_old = u_old[:, 1:]
    x = c.vals[:, None]
    phi = q[c.rows] - x * v_old[c.seg]  # [Pe, R]
    psi = x * jnp.concatenate(
        [jnp.ones_like(c.vals)[:, None], phi], axis=1
    )  # [Pe, R+1]
    S = _psum(jax.ops.segment_sum(
        psi[:, :, None] * psi[:, None, :], c.seg, num_segments=n_seg,
        indices_are_sorted=True,
    ), axis)
    # rhs assembled ROW-WISE as α·Σ ψ(ψᵀu_old − e) + λ∘μ, not as
    # α(S·u_old − Σeψ): the two are equal in exact arithmetic, but the
    # latter cancels two separately-rounded ‖S‖-scale aggregates.
    # Along a rank-deficient S's null directions (features whose
    # co-active span < R) the exact component is pure prior λμ while
    # the float32 cancellation noise is absolute (~eps·‖S‖) — divided
    # by the prior-scale pivot it produced 100s-scale draws and a
    # λ→0 runaway.  Per-row products keep the null component zero to
    # relative precision.
    resid = (
        jnp.sum(psi * u_old[c.seg], axis=1) - e[c.rows]
    )  # [Pe]
    r = _psum(jax.ops.segment_sum(
        psi * resid[:, None], c.seg, num_segments=n_seg,
        indices_are_sorted=True,
    ), axis)
    A = alpha * S + jax.vmap(jnp.diag)(lam)
    rhs = alpha * r + lam * mu
    u_new = solve_spd_sample(A, rhs, noise[c.feat], lam)
    delta = u_new - u_old
    dseg = delta[c.seg]
    e = e.at[c.rows].add(
        jnp.sum(dseg * psi, axis=1), unique_indices=True
    )
    q = q.at[c.rows].add(dseg[:, 1:] * x, unique_indices=True)
    U = U.at[c.feat].set(u_new, mode="drop", unique_indices=True)
    return e, q, U


# ---------------------------------------------------------------------------
# Block pass: Ĝ statistics
# ---------------------------------------------------------------------------


def build_block_gram(b: BlockPlan, e, q, axis=None, row_chunk=1 << 20,
                     flat=False):
    """Ĝ [B, D', D'] = segment outer-product sums of z = [1, e, q],
    chunked over rows so the temporary stays bounded.

    The outer products are computed in a FLAT [N, D'²] layout (static
    index-vector take) that the scatter-add consumes row by row."""
    B = b.block_size
    R = q.shape[1]
    D = R + 2
    N = e.shape[0]
    dtype = e.dtype
    ii, jj = jnp.meshgrid(
        jnp.arange(D), jnp.arange(D), indexing="ij"
    )
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)

    def accum(G, sl_e, sl_q, sl_m):
        z = jnp.concatenate(
            [jnp.ones_like(sl_e)[:, None], sl_e[:, None], sl_q], axis=1
        )
        zz = z[:, ii] * z[:, jj]  # [n, D*D] flat
        return G.at[sl_m].add(zz)

    G = jnp.zeros((B, D * D), dtype)
    if N <= row_chunk:
        G = accum(G, e, q, b.mapper)
    else:
        nb = -(-N // row_chunk)
        Np = nb * row_chunk

        def pad(a, fill):
            padw = [(0, Np - N)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, padw, constant_values=fill).reshape(
                (nb, row_chunk) + a.shape[1:]
            )

        ep, qp, mp = pad(e, 0.0), pad(q, 0.0), pad(b.mapper, B)

        def body(G, xs):
            sl_e, sl_q, sl_m = xs
            Gp = jnp.concatenate(
                [G, jnp.zeros((1, D * D), dtype)], axis=0
            )
            Gp = accum(Gp, sl_e, sl_q, sl_m)
            return Gp[:B], None

        G, _ = lax.scan(body, G, (ep, qp, mp))
    G = _psum(G, axis)
    return G if flat else G.reshape(B, D, D)


def _joint_u_block_color(b: BlockPlan, c: ColorPlan, G, U, alpha,
                         lam_gu, mu_gu, noise, group_index):
    """One block color: draw u rows from Ĝ; return the per-block-row
    update coefficients (a0 [B], A [B, R]) instead of applying them."""
    n_seg = c.feat.shape[0]
    B, D, _ = G.shape
    R = D - 2
    gidx = group_index[c.feat]
    lam = lam_gu[gidx]
    mu = mu_gu[gidx]
    u_old = U[c.feat]
    v_old = u_old[:, 1:]

    x = c.vals
    m = c.rows
    Gm = G[m]  # [Pe, D, D]
    x2 = (x * x)[:, None, None]
    packed = jnp.concatenate(
        [
            x2 * Gm,
            (x[:, None] * Gm[:, 1, :])[:, None, :],
            ((x**3)[:, None] * Gm[:, 0, :])[:, None, :],
            ((x**4)[:, None] * Gm[:, 0, :])[:, None, :],
        ],
        axis=1,
    )  # [Pe, D+3, D]
    T = jax.ops.segment_sum(
        packed, c.seg, num_segments=n_seg, indices_are_sorted=True
    )
    G2 = T[:, :D, :]       # Σ x² Ĝ
    row1 = T[:, D, :]      # Σ x  Ĝ[1,:]
    row0_3 = T[:, D + 1, :]  # Σ x³ Ĝ[0,:]
    s4c = T[:, D + 2, 0]   # Σ x⁴ card

    s3c = row0_3[:, 0]
    s3q = row0_3[:, 2:]
    top = jnp.concatenate(
        [
            G2[:, 0:1, 0:1],
            G2[:, 0:1, 2:] - (s3c[:, None] * v_old)[:, None, :],
        ],
        axis=2,
    )  # [Pf, 1, R+1]
    bot_left = jnp.swapaxes(top[:, :, 1:], 1, 2)  # [Pf, R, 1]
    bot_right = (
        G2[:, 2:, 2:]
        - v_old[:, :, None] * s3q[:, None, :]
        - s3q[:, :, None] * v_old[:, None, :]
        + s4c[:, None, None] * v_old[:, :, None] * v_old[:, None, :]
    )
    S = jnp.concatenate(
        [top, jnp.concatenate([bot_left, bot_right], axis=2)], axis=1
    )
    t = jnp.concatenate(
        [
            row1[:, 0:1],
            row1[:, 2:] - G2[:, 0, 1][:, None] * v_old,
        ],
        axis=1,
    )
    u_new = _draw_u(S, t, u_old, lam, mu, alpha, noise[c.feat])
    delta = u_new - u_old
    dseg = delta[c.seg]
    # e_n += x·Δw − x²(v_old·Δv) + q_n·(x·Δv)   (per block row)
    a0 = jnp.zeros((B,), G.dtype).at[m].add(
        x * dseg[:, 0]
        - x * x * jnp.sum(v_old[c.seg] * dseg[:, 1:], axis=1),
        unique_indices=True,
    )
    A = jnp.zeros((B, R), G.dtype).at[m].add(
        x[:, None] * dseg[:, 1:], unique_indices=True
    )
    U = U.at[c.feat].set(u_new, mode="drop", unique_indices=True)
    return U, a0, A


def _update_gram(G, a0, A):
    """Ĝ ← T Ĝ Tᵀ for z ← Tz, e += a0 + q·A, q += A (module doc)."""
    B, D, _ = G.shape
    s_vec = jnp.concatenate(
        [a0[:, None], jnp.zeros((B, 1), G.dtype), A], axis=1
    )
    g = jnp.einsum("bij,bj->bi", G, s_vec, precision=_HI)
    sgs = jnp.einsum("bi,bi->b", s_vec, g, precision=_HI)
    e1 = jnp.zeros((D,), G.dtype).at[1].set(1.0)
    sh = s_vec.at[:, 0].set(0.0)
    p = g + 0.5 * sgs[:, None] * e1 + g[:, 0:1] * sh
    r = G[:, :, 0] + 0.5 * G[:, 0:1, 0] * sh
    G = G.at[:, 1, :].add(p).at[:, :, 1].add(p)
    G = G.at[:, 2:, :].add(A[:, :, None] * r[:, None, :])
    G = G.at[:, :, 2:].add(r[:, :, None] * A[:, None, :])
    return G


def _joint_u_block_pass(b: BlockPlan, e, q, U, alpha, lam_gu, mu_gu,
                        noise, group_index, axis=None, unroll=4):
    """All colors of one block: Ĝ built once, evolved per color with
    the exact T Ĝ Tᵀ recurrence; [n_rows] state touched once at the end:
        e += (Ct + q⁰·Atot)[mapper-expanded],   q += Atot[mapper]
    where Ct accumulates a0 plus the prefix cross-terms A_k·(Σ_{j<k}A_j)
    (each color sees the q produced by earlier colors)."""
    B = b.block_size
    R = q.shape[1]
    G = build_block_gram(b, e, q, axis)
    Atot = jnp.zeros((B, R), e.dtype)
    Ct = jnp.zeros((B,), e.dtype)

    for c in b.colors:
        U, a0, A = _joint_u_block_color(
            b, c, G, U, alpha, lam_gu, mu_gu, noise, group_index
        )
        Ct = Ct + a0 + jnp.einsum("br,br->b", A, Atot, precision=_HI)
        Atot = Atot + A
        G = _update_gram(G, a0, A)

    if b.color_stack is not None:
        def body(carry, xs):
            G_, At_, Ct_, U_ = carry
            c = ColorPlan(
                rows=xs.rows, vals=xs.vals, seg=xs.seg, feat=xs.feat,
                sx2=xs.sx2,
            )
            U_, a0, A = _joint_u_block_color(
                b, c, G_, U_, alpha, lam_gu, mu_gu, noise, group_index
            )
            Ct_ = Ct_ + a0 + jnp.einsum(
                "br,br->b", A, At_, precision=_HI
            )
            At_ = At_ + A
            G_ = _update_gram(G_, a0, A)
            return (G_, At_, Ct_, U_), None

        (G, Atot, Ct, U), _ = lax.scan(
            body, (G, Atot, Ct, U), b.color_stack, unroll=unroll
        )

    am = Atot[b.mapper]
    e = e + jnp.sum(am * q, axis=1) + Ct[b.mapper]
    q = q + am
    return e, q, U


# ---------------------------------------------------------------------------
# Dense (lanes-major) block pass — the fast path for the joint sweep
# ---------------------------------------------------------------------------
#
# The ragged Ĝ pass spends its scan body in dynamic-update-slice copies
# of the [B, D', D'] carry (every Ĝ row/col update copies it).  The
# dense pass keeps everything "lanes-major":
#
# * Ĝ is carried as [D'², B] — B minor, so every update is one
#   elementwise op over contiguous B-vectors;
# * per color, the ragged entry lists become B-length vectors
#   (xw = x value at block row, segb = feature slot; a block row
#   belongs to at most one feature per color), so the draw statistics
#   need NO gather at all: ONE matmul  [D'², B] @ [B, 4·Pf]  computes
#   Σx²Ĝ, Σx³Ĝ, Σx⁴Ĝ, ΣxĜ for every feature simultaneously (the
#   one-hot(segb) weights make it a plain GEMM);
# * the update coefficients return to B-space through the same one-hot
#   (two tiny matmuls), and Ĝ ← T Ĝ Tᵀ is applied as four lane-wise
#   slab updates.


def _dense_color_step(G, xw, segb, u_old, lam, mu, xi, alpha, D):
    """One dense color: G is the FLAT lanes-major Gram [D·D, B]
    (flat row k = Ĝ[k//D, k%D]; B is the minor dim, so
    the physical footprint has no tile padding on the stats dims).

    Each feature belongs to exactly ONE color, so its weight row,
    prior and noise (u_old/lam/mu/xi, all [Pf, R+1]) are pre-gathered
    by the caller once per sweep — the scan body does no gathers or
    scatters at all.

    Returns (u_new [Pf, R+1], a0 [B], A_B [R, B]) — the per-block-row
    update coefficients for e += a0 + q·A, q += A."""
    R = D - 2
    dtype = G.dtype
    Pf = u_old.shape[0]
    vT = u_old[:, 1:].T  # [R, Pf]

    oh = jax.nn.one_hot(segb, Pf + 1, dtype=dtype)[:, :Pf]  # [B, Pf]
    x2 = xw * xw
    wq = jnp.concatenate(
        [
            x2[:, None] * oh,
            (x2 * xw)[:, None] * oh,
            (x2 * x2)[:, None] * oh,
            xw[:, None] * oh,
        ],
        axis=1,
    )  # [B, 4Pf]
    TT = jnp.einsum("kb,bq->kq", G, wq, precision=_HI).reshape(
        D, D, 4 * Pf
    )
    G2 = TT[..., :Pf]  # Σx²Ĝ [D, D, Pf]
    s3 = TT[0, :, Pf : 2 * Pf]  # Σx³Ĝ[0,:] [D, Pf]
    x4c = TT[0, 0, 2 * Pf : 3 * Pf]  # Σx⁴card [Pf]
    w1 = TT[1, :, 3 * Pf :]  # ΣxĜ[1,:] [D, Pf] (e-row: E1, ·, EQ)
    s3c = s3[0]
    s3q = s3[2:]  # [R, Pf]

    S00 = G2[0:1, 0:1, :]
    S0q = (G2[0, 2:, :] - s3c[None] * vT)[None]  # [1, R, Pf]
    Sqq = (
        G2[2:, 2:, :]
        - vT[:, None] * s3q[None]
        - s3q[:, None] * vT[None]
        + x4c * vT[:, None] * vT[None]
    )
    S = jnp.concatenate(
        [
            jnp.concatenate([S00, S0q], axis=1),
            jnp.concatenate([jnp.swapaxes(S0q, 0, 1), Sqq], axis=1),
        ],
        axis=0,
    )  # [R+1, R+1, Pf]
    S = jnp.moveaxis(S, 2, 0)
    t = jnp.concatenate(
        [w1[0:1], w1[2:] - G2[0, 1][None] * vT], axis=0
    ).T  # [Pf, R+1]

    u_new = _draw_u(S, t, u_old, lam, mu, alpha, xi)
    delta = u_new - u_old
    dw = delta[:, 0]
    dv = delta[:, 1:]
    c0 = jnp.sum(u_old[:, 1:] * dv, axis=1)  # v_old·Δv per feature
    dwB = jnp.einsum("bp,p->b", oh, dw, precision=_HI)
    c0B = jnp.einsum("bp,p->b", oh, c0, precision=_HI)
    a0 = xw * dwB - x2 * c0B
    A_B = jnp.einsum("bp,pr->rb", oh, dv, precision=_HI) * xw[None]
    return u_new, a0, A_B


def _update_gram_lanes(G, a0, A_B, D):
    """Ĝ ← T Ĝ Tᵀ in flat [D·D, B] layout (see _update_gram).

    The whole correction is one elementwise expression over the flat
    rows: corr[k] = e1_i p_j + p_i e1_j + ŝ_i r_j + r_i ŝ_j with
    i = k//D, j = k%D — the static takes fuse into the single
    read-modify-write of G (no slab DUS copies)."""
    import numpy as _np

    B = G.shape[1]
    dtype = G.dtype
    II = _np.arange(D * D) // D  # static index maps
    JJ = _np.arange(D * D) % D
    s = jnp.concatenate(
        [a0[None], jnp.zeros((1, B), dtype), A_B], axis=0
    )  # [D, B]
    sh = s.at[0].set(0.0)  # ŝ = [0, 0, A]
    # g = Ĝ·s: one-pass batched matvec (the r_sum-matmul formulation
    # materialized G*s[JJ] first — an extra full-Gram HBM pass per
    # sequential color)
    g = jnp.einsum(
        "djb,jb->db", G.reshape(D, D, B), s, precision=_HI
    )  # [D, B]
    sgs = jnp.sum(s * g, axis=0)  # [B]
    p = (g + g[0:1] * sh).at[1].add(0.5 * sgs)
    col0 = G[_np.arange(D) * D]  # Ĝ[:, 0] as [D, B]
    r = col0 + 0.5 * col0[0:1] * sh
    m_i1 = jnp.asarray((II == 1), dtype)[:, None]
    m_j1 = jnp.asarray((JJ == 1), dtype)[:, None]
    corr = (
        m_i1 * p[JJ]
        + p[II] * m_j1
        + sh[II] * r[JJ]
        + r[II] * sh[JJ]
    )
    return G + corr


def _chol_solve_sample_lanes(Svv, rhs, xi, eps8, tiny, floor=None):
    """chol_solve_sample on lists of [B]-lane vectors.

    ``Svv``: list of lists, Svv[i][j] a [B] vector (i, j < Dp);
    ``rhs``/``xi``: lists of [B] vectors.  Returns the solution list.
    Identical recurrences and pivot clamp as the scan path; ``floor``
    is the per-coordinate exact pivot lower bound (the prior λ for
    A = αS + diag(λ) — see chol_solve_sample)."""
    Dp = len(rhs)
    cols = []  # cols[j][i] for i >= j: column j of L
    for j in range(Dp):
        col = [Svv[i][j] for i in range(Dp)]
        for k in range(j):
            ck = cols[k]
            col = [
                col[i] - ck[i - k] * ck[j - k] if i >= j else col[i]
                for i in range(Dp)
            ]
        floor_j = eps8 * jnp.abs(Svv[j][j]) + tiny
        if floor is not None:
            floor_j = jnp.maximum(floor_j, floor[j])
        pivot = jnp.maximum(col[j], floor_j)
        inv_d = jax.lax.rsqrt(pivot)
        colj = [pivot * inv_d] + [
            col[i] * inv_d for i in range(j + 1, Dp)
        ]
        cols.append(colj)
    z = []
    for j in range(Dp):
        acc = rhs[j]
        for k in range(j):
            acc = acc - cols[k][j - k] * z[k]
        z.append(acc / cols[j][0])
    zx = [z[j] + xi[j] for j in range(Dp)]
    s = [None] * Dp
    for j in reversed(range(Dp)):
        acc = zx[j]
        for k in range(j + 1, Dp):
            acc = acc - cols[j][k - j] * s[k]
        s[j] = acc / cols[j][0]
    return s


def _identity_color_apply(dc, G, Atot, Ct, U, alpha, lam_gu, mu_gu,
                          noise, group_index, D):
    """Draw a color's single-entry features straight off the Gram.

    Each such feature touches exactly one block row b (one-hot id
    columns in block space), so its (S, t) statistics are that row's
    Ĝ entries scaled by powers of x — no one-hot projection, no
    matmul: ~50 lane-parallel [B]-vector ops plus the unrolled batched
    Cholesky.  Exactness: features of one color are row-disjoint, so
    drawing the identity subset before the color's ragged remainder
    produces bit-for-bit the same draws as the combined one-hot step
    (their Gram/residual updates touch disjoint lanes).

    Returns (G, Atot, Ct, U)."""
    R = D - 2
    dtype = G.dtype
    x = dc.id_xw
    f = dc.id_feat
    has = f < U.shape[0]  # F_total marks rows without a feature
    u_old = U[f]  # [B, R+1]; out-of-range gathers clip (masked below)
    gidx = group_index[f]
    lam = lam_gu[gidx]
    mu = mu_gu[gidx]
    xi = noise[f]

    x2 = x * x
    x3 = x2 * x
    x4 = x2 * x2

    def row(i, j):
        return G[i * D + j]

    v = [u_old[:, 1 + r] for r in range(R)]
    g00 = row(0, 0)
    s3c = x3 * g00
    Dp = R + 1
    S = [[None] * Dp for _ in range(Dp)]
    S[0][0] = x2 * g00
    for r in range(R):
        S[0][1 + r] = x2 * row(0, 2 + r) - s3c * v[r]
        S[1 + r][0] = S[0][1 + r]
    for r in range(R):
        for r2 in range(r, R):
            val = (
                x2 * row(2 + r, 2 + r2)
                - v[r] * x3 * row(0, 2 + r2)
                - x3 * row(0, 2 + r) * v[r2]
                + x4 * g00 * v[r] * v[r2]
            )
            S[1 + r][1 + r2] = val
            S[1 + r2][1 + r] = val
    t = [x * row(1, 0)] + [
        x * row(1, 2 + r) - x2 * row(0, 1) * v[r] for r in range(R)
    ]

    u0v = [u_old[:, i] for i in range(Dp)]
    lamv = [lam[:, i] for i in range(Dp)]
    A = [
        [
            alpha * S[i][j] + (lamv[i] if i == j else 0.0)
            for j in range(Dp)
        ]
        for i in range(Dp)
    ]
    rhs = []
    for i in range(Dp):
        acc = S[i][0] * u0v[0]
        for j in range(1, Dp):
            acc = acc + S[i][j] * u0v[j]
        rhs.append(alpha * (acc - t[i]) + lamv[i] * mu[:, i])
    eps8 = 8.0 * jnp.finfo(dtype).eps
    tiny = jnp.finfo(dtype).tiny
    s = _chol_solve_sample_lanes(
        A, rhs, [xi[:, i] for i in range(Dp)], eps8, tiny,
        floor=lamv,
    )
    u_new = jnp.stack(s, axis=1)  # [B, R+1]

    delta = jnp.where(has[:, None], u_new - u_old, 0.0)
    dv = delta[:, 1:]
    a0 = x * delta[:, 0] - x2 * jnp.sum(u_old[:, 1:] * dv, axis=1)
    A_B = (x[:, None] * dv).T  # [R, B]
    Ct = Ct + a0 + jnp.sum(A_B * Atot, axis=0)
    Atot = Atot + A_B
    G = _update_gram_lanes(G, a0, A_B, D)
    U = U.at[f].set(
        jnp.where(has[:, None], u_new, u_old),
        mode="drop", unique_indices=True,
    )
    return G, Atot, Ct, U


def _dense_color_apply(G, Atot, Ct, xw, segb, u_old, lam, mu, xi, alpha,
                       D):
    """One dense color: draw its features, then carry the block-row
    update into (G, Atot, Ct).  Returns (G, Atot, Ct, u_new)."""
    u_new, a0, A_B = _dense_color_step(
        G, xw, segb, u_old, lam, mu, xi, alpha, D
    )
    Ct = Ct + a0 + jnp.sum(A_B * Atot, axis=0)
    Atot = Atot + A_B
    G = _update_gram_lanes(G, a0, A_B, D)
    return G, Atot, Ct, u_new


def dense_stack_tail(G, Atot, Ct, xw, segb, u0, lam, mu, xi, alpha, D,
                     unroll=4):
    """The stacked colour tail of a block: ``_dense_color_apply`` over
    the C colours of a DenseStack in one ``lax.scan``.

    ``G`` is the flat lanes-major Gram [D·D, B], ``Atot`` [R, B], ``Ct``
    [B]; ``xw``/``segb`` are [C, B] and ``u0``/``lam``/``mu``/``xi``
    [C, Pf, R+1] (pre-gathered per colour).  Returns
    (G, Atot, Ct, u_new [C, Pf, R+1])."""
    def body(carry, xs):
        G_, At_, Ct_, u_new = _dense_color_apply(*carry, *xs, alpha, D)
        return (G_, At_, Ct_), u_new

    (G, Atot, Ct), u_all = lax.scan(
        body, (G, Atot, Ct), (xw, segb, u0, lam, mu, xi), unroll=unroll,
    )
    return G, Atot, Ct, u_all


def _joint_u_block_pass_dense(b: BlockPlan, e, q, U, alpha, lam_gu,
                              mu_gu, noise, group_index, axis=None,
                              unroll=4):
    """All colors of one block via the dense lanes-major machinery.

    Weight rows, priors and noise are pre-gathered per color (features
    partition across colors) so the scan body is gather/scatter-free;
    drawn rows come back through the scan's stacked ys and are written
    to U with one scatter per stack."""
    B = b.block_size
    R = q.shape[1]
    D = R + 2
    dtype = e.dtype
    # flat lanes-major Gram [D·D, B]
    G = build_block_gram(b, e, q, axis, flat=True).T
    Atot = jnp.zeros((R, B), dtype)
    Ct = jnp.zeros((B,), dtype)

    def pergather(feat):
        gidx = group_index[feat]
        return U[feat], lam_gu[gidx], mu_gu[gidx], noise[feat]

    for dc in b.dense_colors:
        if dc.id_feat is not None:
            G, Atot, Ct, U = _identity_color_apply(
                dc, G, Atot, Ct, U, alpha, lam_gu, mu_gu, noise,
                group_index, D,
            )
        u_old, lam, mu, xi = pergather(dc.feat)
        G, Atot, Ct, u_new = _dense_color_apply(
            G, Atot, Ct, dc.xw, dc.segb, u_old, lam, mu, xi, alpha, D
        )
        U = U.at[dc.feat].set(u_new, mode="drop", unique_indices=True)

    if b.dense_stack is not None:
        ds = b.dense_stack
        u0, lam_s, mu_s, xi_s = pergather(ds.feat)  # [C, Pf, R+1] each
        G, Atot, Ct, u_all = dense_stack_tail(
            G, Atot, Ct, ds.xw, ds.segb, u0, lam_s, mu_s, xi_s, alpha, D,
            unroll=unroll,
        )
        U = U.at[ds.feat.reshape(-1)].set(
            u_all.reshape(-1, R + 1), mode="drop", unique_indices=True
        )

    am = Atot.T[b.mapper]  # [N, R]
    e = e + jnp.sum(am * q, axis=1) + Ct[b.mapper]
    q = q + am
    return e, q, U


def sweep_joint_u(plan: DesignPlan, e, w, V, alpha, lambda_w, mu_w,
                  lambda_V, mu_V, key, axis=None, unroll=4, q=None):
    """One merged (w, V) joint pass over all colors of all tables.

    Returns (w, V, e, q).  ``q`` (the factor-sum cache) is maintained
    exactly by every color update, so callers carry it across sweeps
    instead of recomputing X·V each time; pass None to (re)build it.
    Requires fit_linear (the caller falls back to the two-pass sweep
    otherwise)."""
    rank = V.shape[1]
    dtype = e.dtype
    F = plan.n_features
    g = plan.group_index
    noise = jax.random.normal(key, (F, rank + 1), dtype=dtype)
    U = jnp.concatenate([w[:, None], V], axis=1)  # [F, R+1]
    lam_gu = jnp.concatenate([lambda_w[:, None], lambda_V], axis=1)
    mu_gu = jnp.concatenate([mu_w[:, None], mu_V], axis=1)

    if q is None:
        q = factor_q(plan, V)  # [N, R]

    for c in plan.main.colors:
        e, q, U = _joint_u_color_main(
            c, e, q, U, alpha, lam_gu, mu_gu, noise, g, axis
        )
    if plan.main.color_stack is not None:
        def step(carry, xs):
            c = ColorPlan(
                rows=xs.rows, vals=xs.vals, seg=xs.seg, feat=xs.feat,
                sx2=xs.sx2,
            )
            e_, q_, U_ = carry
            return _joint_u_color_main(
                c, e_, q_, U_, alpha, lam_gu, mu_gu, noise, g, axis
            ), None

        (e, q, U), _ = lax.scan(
            step, (e, q, U), plan.main.color_stack, unroll=unroll
        )

    for b in plan.blocks:
        if b.dense_colors or b.dense_stack is not None:
            e, q, U = _joint_u_block_pass_dense(
                b, e, q, U, alpha, lam_gu, mu_gu, noise, g, axis,
                unroll=unroll,
            )
        else:
            e, q, U = _joint_u_block_pass(
                b, e, q, U, alpha, lam_gu, mu_gu, noise, g, axis,
                unroll=unroll,
            )

    return U[:, 0], U[:, 1:], e, q
