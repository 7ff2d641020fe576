"""Entity-space CAVI for all-categorical designs (the VI fast path).

Same architecture as the Gibbs fast path (ops/categorical.py): for
one-hot tables every per-row cache is a pure function of the small
per-entity tables, so each table pass reconstructs its state in tile
space from cross-table gathers and needs ONE fused Gram per table —
extended with the variational second-moment columns:

    z = [1 | e | φ_1..R | σ_1..R | τ_1..R],   D = 3R + 2,

where (per row, excluding the own table; x = 1 everywhere)
    φ_r = Σ_other V̄_r        (factor mean sum      — Gibbs' q_other)
    σ_r = Σ_other s_r        (factor variance sum  — x2s minus own)
    τ_r = Σ_other s_r V̄_r    (x3sv minus own).

The per-entity CAVI conditionals (reference variational.hpp:450-554,
specialised to x = 1 which collapses every x²/x³ power) read entirely
off the Gram G_u = Σ z zᵀ:

    w:    quad = α·card + λ_w,     lin = α(card·w̄ − E1) + λ_w μ_w
    V_r:  quad = α(Σφ_r² + Σσ_r) + λ
          lin  = α(−Σeφ_r + (Σφ_r²)v̄ − (Σφ_rσ_r − Στ_r)) + λμ
    with card = G[0,0], E1 = G[0,1], Σφ_r = G[0,2+r],
    Σeφ_r = G[1,2+r], Σφ_r² = G[2+r,2+r], Σσ_r = G[0,2+R+r],
    Σφ_rσ_r = G[2+r,2+R+r], Στ_r = G[0,2+2R+r];
    updates are posterior-mean assignments with s = 1/quad variance
    bookkeeping.  The only cross-coordinate coupling inside a table
    pass is through e: after the w step Σeφ_s += Δw·Σφ_s, after factor
    r Σeφ_s += Δ_r·G[2+r,2+s] (σ/τ columns are factor-local and never
    change during the own table's pass).

Update order: α → w0 → λ_w/μ_w → λ_V/μ_V → per table {w_t, V_t factor
scan} → (e, Var, ELBO) refresh.  Relative to the reference's
all-w-then-all-V order this interleaves each table's w with its factor
scan (same deviation the Gibbs fast path documents); every update is
still the exact coordinate-wise CAVI maximiser given the current state
of all others, so the ELBO increases monotonically and the algorithm
converges to a mean-field stationary point exactly as the reference
does.

The (e, e_var_sum, ELBO) refresh is ONE streaming chunked row pass
(score_rows-style) over gathers of per-entity [w | w_var | V | s | sV]
tables — the 3rd/4th-moment caches collapse for x = 1:
x4s2 = Σs², x4sv2 = Σ s·V̄² (computed in-chunk from the gathers).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..design_categorical import CategoricalPlan, CategoricalTable
from .categorical import _pad_zero_row, _row_validity, _table_slice
from .gibbs import TASK_CLASSIFICATION, TASK_REGRESSION
from .gram import table_gram
from .special import (
    mean_var_truncated_normal_left,
    mean_var_truncated_normal_right,
)
from .variational import (
    VariationalConfig,
    VIState,
    _safe_log,
    vi_update_lambda,
    vi_update_mu,
)


@dataclasses.dataclass
class CategoricalVIState:
    """VIState plus the latent mean target tau (classification: the
    analytic truncated-normal mean; regression: None, y used
    directly)."""

    core: VIState
    tau: Optional[jax.Array]


jax.tree_util.register_dataclass(
    CategoricalVIState, data_fields=["core", "tau"], meta_fields=[]
)


def _ext_table(w, w_var, V, V_var, t2: CategoricalTable):
    """Per-entity [w | w_var | V | s | sV | qs] rows ([B, 3+3R]).
    qs = Σ_r V̄² is precomputed in the [B]-sized source so Gram/refresh
    consumers never square-and-reduce gathered rows (same trick as the
    Gibbs ops/categorical._wv_table)."""
    w_t = _table_slice(w, t2)
    wv_t = _table_slice(w_var, t2)
    V_t = _table_slice(V, t2)
    s_t = _table_slice(V_var, t2)
    return jnp.concatenate(
        [
            w_t[:, None], wv_t[:, None], V_t, s_t, s_t * V_t,
            jnp.sum(V_t * V_t, axis=1)[:, None],
        ],
        axis=1,
    )


def _ext_rows(w, w_var, V, V_var, t2: CategoricalTable, idx):
    """_ext_table rows gathered by entity (pad→0)."""
    return _pad_zero_row(_ext_table(w, w_var, V, V_var, t2))[idx]


@dataclasses.dataclass
class _VIEff:
    """Per-entity VI reductions of one entity+attribute table's side
    features (the variational analogue of ops/categorical.eff_tables;
    reference second/fourth-moment caches, variational.hpp:556-833).

    With xs the dense [B, Fs] side matrix, w̄/w_var/V̄/s the side
    features' posterior moments:

        ext  [B, 2+3R]: [Σxw̄ | Σx²wvar | Σxv̄ | Σx²s | Σx³sv̄]
                        (the _ext_rows layout: one-hot consumers read
                        σ = Var(q) from the Σx²s block and their Cov
                        term / the refresh A5 from the x³-weighted sv̄
                        block — all three weightings coincide at x = 1)
        a1   [B, R]:    Σ x s        (x¹-weighted variance sum — the
                        EA Gram's `a` column)
        b2   [B, R]:    Σ x² s v̄    (the EA Gram's `b` column)
        qs   [B]:       Σ_r Σ_j x²v̄²  (the per-row Σx²V̄² that one-hot
                        consumers reconstruct as ΣṼ² — ds = qs − ΣṼ²)
        x4s2 [B]:       Σ_r Σ x⁴ s²   (refresh A4, summed over r)
        x4sv2 [B]:      Σ_r Σ x⁴ s v̄² (refresh A7, summed over r)
    """

    ext: jax.Array
    a1: jax.Array
    b2: jax.Array
    qs: jax.Array
    x4s2: jax.Array
    x4sv2: jax.Array


def vi_eff_tables(plan: CategoricalPlan, w, w_var, V, V_var):
    """Per-table VI effective arrays: None for one-hot tables, a
    ``_VIEff`` for entity+attribute tables."""
    hi = jax.lax.Precision.HIGHEST
    out = []
    for t, si in zip(plan.tables, plan.side):
        if si is None:
            out.append(None)
            continue
        w_s = w[si.feat_cols]
        wv_s = w_var[si.feat_cols]
        V_s = V[si.feat_cols]
        s_s = V_var[si.feat_cols]
        xs = si.xs
        xs2 = xs * xs
        xs3 = xs2 * xs
        xs4 = xs2 * xs2

        def mm(m, a):
            return jnp.matmul(m, a, precision=hi)

        w_eff = mm(xs, w_s)
        wvar_eff = mm(xs2, wv_s)
        V_eff = mm(xs, V_s)
        c_eff = mm(xs2, s_s)  # Σx²s (σ slot)
        t_eff = mm(xs3, s_s * V_s)  # Σx³sv̄ (τ slot)
        ext = jnp.concatenate(
            [w_eff[:, None], wvar_eff[:, None], V_eff, c_eff, t_eff],
            axis=1,
        )
        out.append(
            _VIEff(
                ext=ext,
                a1=mm(xs, s_s),
                b2=mm(xs2, s_s * V_s),
                qs=jnp.sum(mm(xs2, V_s * V_s), axis=1),
                x4s2=jnp.sum(mm(xs4, s_s * s_s), axis=1),
                x4sv2=jnp.sum(mm(xs4, s_s * V_s * V_s), axis=1),
            )
        )
    return out


def _vi_other_gather(w, w_var, V, V_var, t2: CategoricalTable,
                     eff2: Optional[_VIEff], idx, rank: int):
    """One other-table contribution at gathered rows.

    Returns (ext [n, 2+3R], qs [n], a1 [n, R], b2 [n, R]): the
    _ext_rows layout (σ = Σx²s, τ = Σx³sv̄), the per-row Σx²V̄², the
    x¹-weighted variance sum, and the x²-weighted sv̄ sum.  For one-hot
    tables (x = 1) a1 = σ and b2 = τ."""
    if eff2 is None:
        ext = _ext_rows(w, w_var, V, V_var, t2, idx)
        sg = ext[:, 2 + rank : 2 + 2 * rank]
        svg = ext[:, 2 + 2 * rank : 2 + 3 * rank]
        return ext[:, : 2 + 3 * rank], ext[:, 2 + 3 * rank], sg, svg
    packed = jnp.concatenate(
        [eff2.ext, eff2.qs[:, None], eff2.a1, eff2.b2], axis=1
    )
    rows = _pad_zero_row(packed)[idx]
    W = eff2.ext.shape[1]
    return (
        rows[:, :W],
        rows[:, W],
        rows[:, W + 1 : W + 1 + rank],
        rows[:, W + 1 + rank :],
    )


def _vi_table_pass(
    plan: CategoricalPlan,
    ti: int,
    w, w_var, V, V_var,  # [F], [F], [F, R], [F, R]
    w0,
    alpha,
    lambda_w, mu_w, lambda_V, mu_V,  # per-group
    group_index,
    tau_tile,  # [NT] mean target in this table's tile order (pad 0)
    cfg: VariationalConfig,
    gram_impl: str,
    eff=None,  # vi_eff_tables result (EA designs)
):
    """One table's CAVI w update + factor scan in entity space."""
    t = plan.tables[ti]
    rank = V.shape[1]
    # the CAVI updates read only Gram rows [1 | e | q]: table_gram
    # builds the [2+R, 3R+2] rectangle instead of the full square
    w_t = _table_slice(w, t)
    V_t = _table_slice(V, t)
    s_t = _table_slice(V_var, t)
    g_t = group_index[t.col_offset : t.col_offset + t.n_cols]

    B = t.n_cols
    if eff is None:
        eff = [None] * len(plan.tables)

    def src(t2, eff2):
        # [w | V | σ | τ | qs]: the Gram's z block is [φ | σ | τ]
        if eff2 is None:
            ext = _ext_table(w, w_var, V, V_var, t2)
        else:
            ext = jnp.concatenate([eff2.ext, eff2.qs[:, None]], axis=1)
        return _pad_zero_row(
            jnp.concatenate([ext[:, :1], ext[:, 2:]], axis=1)
        )

    others = [
        (t2i, t2) for t2i, t2 in enumerate(plan.tables) if t2i != ti
    ]
    own_rows = jnp.concatenate(
        [w_t[:, None], V_t, jnp.sum(V_t * V_t, axis=1)[:, None]], axis=1
    )
    G = table_gram(
        _pad_zero_row(own_rows), t.ent_of_tile_row,
        [src(t2, eff[t2i]) for t2i, t2 in others],
        [plan.cross_ent[ti][t2i] for t2i, _ in others],
        tau_tile, t.slot, t.seg, t.ent_slots,
        rank=rank, n_entities=B, tile_rows=t.tile_rows,
        tile_entities=t.tile_entities, chunk_tiles=t.chunk_tiles,
        impl=gram_impl,
    )

    wv_t = _table_slice(w_var, t)
    use_rs = (
        cfg.axis_name is not None
        and cfg.gram_reduce_scatter
        and B % cfg.n_devices == 0
        and cfg.n_devices > 1
    )
    if use_rs:
        # SPMD, reduce-scatter layout (same scheme as the Gibbs fast
        # path): each device receives the summed Gram for ITS
        # contiguous entity window, performs that window's
        # deterministic CAVI updates, and the four [Bw(,R)] update
        # results are all-gathered — ~D²/(2+2R)× less traffic
        # than psum'ing the [B, D, D] Gram (D = 3R+2 here).
        Bw = B // cfg.n_devices
        Gw = lax.psum_scatter(
            G, cfg.axis_name, scatter_dimension=0, tiled=True
        )
        idx = lax.axis_index(cfg.axis_name)
        start = idx * Bw

        def win(a):
            begin = (start,) + tuple(
                jnp.zeros((), start.dtype) for _ in range(a.ndim - 1)
            )
            return lax.dynamic_slice(a, begin, (Bw,) + a.shape[1:])

        w_new, wv_new, V_new, s_new = _vi_entity_updates(
            Gw, w0, win(w_t), win(wv_t), win(V_t), win(s_t), win(g_t),
            alpha, lambda_w, mu_w, lambda_V, mu_V, cfg,
        )
        w_new = lax.all_gather(w_new, cfg.axis_name, axis=0, tiled=True)
        wv_new = lax.all_gather(
            wv_new, cfg.axis_name, axis=0, tiled=True
        )
        V_new = lax.all_gather(V_new, cfg.axis_name, axis=0, tiled=True)
        s_new = lax.all_gather(s_new, cfg.axis_name, axis=0, tiled=True)
    else:
        if cfg.axis_name is not None:
            # SPMD: per-shard partial Grams sum to the global
            # statistics; every device then performs the identical
            # deterministic updates
            G = lax.psum(G, cfg.axis_name)
        w_new, wv_new, V_new, s_new = _vi_entity_updates(
            G, w0, w_t, wv_t, V_t, s_t, g_t,
            alpha, lambda_w, mu_w, lambda_V, mu_V, cfg,
        )

    w = lax.dynamic_update_slice(w, w_new, (t.col_offset,))
    w_var = lax.dynamic_update_slice(w_var, wv_new, (t.col_offset,))
    V = lax.dynamic_update_slice(V, V_new, (t.col_offset, 0))
    V_var = lax.dynamic_update_slice(V_var, s_new, (t.col_offset, 0))
    return w, w_var, V, V_var


def _vi_entity_updates(G, w0, w_t, wv_t, V_t, s_t, g_t,
                       alpha, lambda_w, mu_w, lambda_V, mu_V,
                       cfg: VariationalConfig):
    """Per-entity CAVI w update + factor scan from Gram statistics.

    The kernel builds G over z = [1 | e⁰ | ...] with e⁰ = e − w0 (same
    contract as the Gibbs cross kernel); the true-residual statistics
    follow exactly from z₁ = z₁⁰ + w0·z₀: E1 = E1⁰ + w0·card and
    Σeφ_r = Σe⁰φ_r + w0·Σφ_r — [B]-sized arithmetic.

    Operates on any contiguous entity window (the full table, or one
    device's reduce-scatter shard); all operands are window-sliced.
    Returns (w_new, w_var_new, V_new, V_var_new)."""
    rank = V_t.shape[1]
    card = G[:, 0, 0]
    Sphi = G[:, 0, 2 : 2 + rank]  # [B, R]
    E1 = G[:, 0, 1] + w0 * card
    EQphi = G[:, 1, 2 : 2 + rank] + w0 * Sphi
    Ssig = G[:, 0, 2 + rank : 2 + 2 * rank]
    Stau = G[:, 0, 2 + 2 * rank : 2 + 3 * rank]

    lam_w = lambda_w[g_t]
    mu_wg = mu_w[g_t]

    if cfg.fit_linear:
        quad = alpha * card + lam_w
        lin = alpha * (card * w_t - E1) + lam_w * mu_wg
        w_new = lin / quad
        wv_new = 1.0 / quad
        dw = w_new - w_t
        EQphi = EQphi + dw[:, None] * Sphi
    else:
        w_new, wv_new = w_t, wv_t

    if rank:
        C = min(8, rank)
        lam_V = lambda_V[g_t]
        mu_Vg = mu_V[g_t]

        v_new_cols = []
        s_new_cols = []
        EQ_corr = jnp.zeros_like(EQphi)
        for c0 in range(0, rank, C):
            c1 = min(c0 + C, rank)
            Gc = G[:, 2 + c0 : 2 + c1, 2 : 2 + rank]  # [B, c, R]
            # diag of the φσ cross block for this factor chunk
            Gps = G[:, 2 + c0 : 2 + c1, 2 + rank : 2 + 2 * rank]
            EQ_chunk = (EQphi + EQ_corr)[:, c0:c1]
            deltas = []
            for j in range(c1 - c0):
                r = c0 + j
                Sphi2_r = Gc[:, j, r]
                Sphisig_r = Gps[:, j, r]
                v_old = V_t[:, r]
                quad = alpha * (Sphi2_r + Ssig[:, r]) + lam_V[:, r]
                lin = (
                    alpha
                    * (
                        -EQ_chunk[:, j]
                        + Sphi2_r * v_old
                        - (Sphisig_r - Stau[:, r])
                    )
                    + lam_V[:, r] * mu_Vg[:, r]
                )
                v_new = lin / quad
                delta = v_new - v_old
                if j + 1 < c1 - c0:
                    EQ_chunk = EQ_chunk.at[:, j + 1 :].add(
                        delta[:, None] * Gc[:, j, r + 1 : c1]
                    )
                v_new_cols.append(v_new)
                s_new_cols.append(1.0 / quad)
                deltas.append(delta)
            if c1 < rank:
                delta_c = jnp.stack(deltas, axis=1)
                EQ_corr = EQ_corr.at[:, c1:].add(
                    jnp.einsum(
                        "bc,bcr->br", delta_c, Gc[:, :, c1:],
                        precision=jax.lax.Precision.HIGHEST,
                    )
                )
        V_new = jnp.stack(v_new_cols, axis=1)
        s_new = jnp.stack(s_new_cols, axis=1)
    else:
        V_new, s_new = V_t, s_t
    return w_new, wv_new, V_new, s_new


def _update_gram_lanes_u(G, s_vec, u_vec, D):
    """Ĝ ← T Ĝ Tᵀ in flat lanes-major [D·D, B] layout for the VI
    entity+attribute transform T = I + e₁ sᵀ + u e₀ᵀ.

    Generalizes ops/joint._update_gram_lanes (where u = ŝ): the VI
    z-rows carry variance-sum columns (a = Σxs, b = Σx²sv̄, c = Σx²s)
    whose per-update shifts are CONSTANT per block row — they ride the
    z₀ = 1 column through u, exactly like the factor-mean shifts.
    Expansion (g = Ĝs, r₀ = Ĝe₀):
        Ĝ' = Ĝ + e₁pᵀ + pe₁ᵀ + urᵀ + ruᵀ,
        p = g + (sᵀr₀)u + ½(sᵀg)e₁,   r = r₀ + ½Ĝ₀₀u.
    """
    import numpy as _np

    B = G.shape[1]
    rows_r = G.shape[0] // D  # rectangle rows (2+R; D·D would be full)
    dtype = G.dtype
    II = _np.arange(rows_r * D) // D
    JJ = _np.arange(rows_r * D) % D
    # one-pass batched matvec g[j, b] = Σ_k Ĝ[k, j, b] s[k, b] over the
    # rectangle's rows (s is supported on rows {0, q} ⊂ rect; Ĝ is
    # symmetric, so this is Ĝ·s over ALL j) — the round-2 r_sum-einsum
    # formulation materialized G*s ([D², B]) first, an extra full-Gram
    # device-memory pass per color (the EA side scans run ~2k
    # sequential colors per sweep)
    g = jnp.einsum(
        "kjb,kb->jb", G.reshape(rows_r, D, B), s_vec[:rows_r],
        precision=jax.lax.Precision.HIGHEST,
    )  # [D, B] = Ĝ·s
    sgs = jnp.sum(s_vec * g, axis=0)
    p = (g + g[0:1] * u_vec).at[1].add(0.5 * sgs)
    col0 = G[0:D]  # Ĝ[0, :] = Ĝ[:, 0] by symmetry, [D, B]
    r = col0 + 0.5 * col0[0:1] * u_vec
    m_i1 = jnp.asarray((II == 1), dtype)[:, None]
    m_j1 = jnp.asarray((JJ == 1), dtype)[:, None]
    corr = (
        m_i1 * p[JJ]
        + p[II] * m_j1
        + u_vec[II] * r[JJ]
        + r[II] * u_vec[JJ]
    )
    return G + corr


def _vi_dense_color_step(G, xw, segb, u0, s0, lam, mu, alpha, rank,
                         fit_linear: bool):
    """One entity+attribute VI color: exact sequential CAVI updates of
    every feature's (w, V_1..V_R) coordinates, vectorized over the
    color's features (row-disjoint), followed by the Ĝ ← T Ĝ Tᵀ
    evolution so later colors see exact post-update statistics.

    ``G`` is the flat lanes-major [D·D, B] Gram over
    z = [1 | e | q (R) | a (R) | b (R) | c (R)], D = 4R+2, with
    a = Σ_k x_k s_k, b = Σ_k x_k² s_k v̄_k, c = Σ_k x_k² s_k over ALL
    features (own-feature borders subtracted below).  Derivation: for
    coordinate v = V_jr the score is linear, score = c_n + h_n v with
    h = xφ_r, so the CAVI update is
        quad = α Σ(E[h²] = x²φ̄² + x²σ^{-j})+ λ
        lin  = α Σ(−h̄e + v̄(h̄² + Var h) − Cov(h, score)) + λμ
    with Cov(h, score) = x_j[q̄_r(a_r − x_j s_jr) − (b_r − x_j²s_jr v̄_jr)]
    (reference per-coordinate VI scan with the x2s/x3sv caches,
    variational.hpp:450-713, re-derived against the Gram).  Sequential
    exactness inside a feature: the w update shifts Σxeφ_r by
    Δw·Σx²φ_r, factor r shifts Σxeφ_r' by Δv_r·Σx²φ_rφ_r' — both read
    off the same Gram aggregates.

    Returns (u_new [Pf, 1+R], var_new [Pf, 1+R], G)."""
    dtype = G.dtype
    Pf = u0.shape[0]
    R = rank
    D = 4 * R + 2
    B = xw.shape[0]
    hi = jax.lax.Precision.HIGHEST

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
    rows_r = G.shape[0] // D  # [1|e|q] rectangle rows (= 2+R)
    TT = jnp.einsum("kb,bq->kq", G, wq, precision=hi).reshape(
        rows_r, D, 4 * Pf
    )
    G2 = TT[..., :Pf]          # Σx²Ĝ [D, D, Pf]
    S30 = TT[0, :, Pf : 2 * Pf]  # Σx³Ĝ[0,:] [D, Pf]
    x4c = TT[0, 0, 2 * Pf : 3 * Pf]  # Σx⁴ [Pf]
    W1 = TT[..., 3 * Pf :]     # ΣxĜ [D, D, Pf]

    card2 = G2[0, 0]
    s3c = S30[0]
    sxe = W1[1, 0]   # Σxe
    sx2e = G2[0, 1]  # Σx²e

    w_old = u0[:, 0]
    vT = u0[:, 1:].T      # [R, Pf] v̄ (old)
    sT = s0[:, 1:].T      # [R, Pf] s (old)
    lam_w = lam[:, 0]
    mu_w = mu[:, 0]
    lam_V = lam[:, 1:].T
    mu_V = mu[:, 1:].T

    cq = lambda r: 2 + r
    ca = lambda r: 2 + R + r
    cb = lambda r: 2 + 2 * R + r
    cc = lambda r: 2 + 3 * R + r

    # Σx²φ_r and Σxeφ_r with the v̄ borders (φ_r = q_r − x v̄_jr)
    Sphi = [G2[0, cq(r)] - vT[r] * s3c for r in range(R)]
    Exephi = [W1[1, cq(r)] - vT[r] * sx2e for r in range(R)]

    if fit_linear:
        quad_w = alpha * card2 + lam_w
        lin_w = alpha * (card2 * w_old - sxe) + lam_w * mu_w
        w_new = lin_w / quad_w
        wv_new = 1.0 / quad_w
        dw = w_new - w_old
        Exephi = [Exephi[r] + dw * Sphi[r] for r in range(R)]
    else:
        w_new, wv_new = w_old, s0[:, 0]
        dw = jnp.zeros_like(w_old)

    v_new_l, s_new_l, dv_l = [], [], []
    for r in range(R):
        Sphi2 = (
            G2[cq(r), cq(r)]
            - 2.0 * vT[r] * S30[cq(r)]
            + vT[r] * vT[r] * x4c
        )
        sig = G2[0, cc(r)] - sT[r] * x4c  # Σx²σ^{-j}
        quad = alpha * (Sphi2 + sig) + lam_V[r]
        covx = (
            W1[cq(r), ca(r)]
            - sT[r] * G2[0, cq(r)]
            - W1[0, cb(r)]
            + sT[r] * vT[r] * s3c
        )
        lin = (
            alpha
            * (
                -Exephi[r]
                + vT[r] * Sphi2
                + vT[r] * sig
                - covx
            )
            + lam_V[r] * mu_V[r]
        )
        v_new = lin / quad
        s_new = 1.0 / quad
        dv = v_new - vT[r]
        for r2 in range(r + 1, R):
            # Σx²φ_rφ_r' (both borders at OLD v̄ — q columns still
            # hold pre-color values)
            cross = (
                G2[cq(r), cq(r2)]
                - vT[r] * S30[cq(r2)]
                - vT[r2] * S30[cq(r)]
                + vT[r] * vT[r2] * x4c
            )
            Exephi[r2] = Exephi[r2] + dv * cross
        v_new_l.append(v_new)
        s_new_l.append(s_new)
        dv_l.append(dv)

    if R:
        dV = jnp.stack(dv_l, axis=0)        # [R, Pf]
        V_new = jnp.stack(v_new_l, axis=0)  # [R, Pf]
        S_new = jnp.stack(s_new_l, axis=0)
        dS = S_new - sT
        dSV = S_new * V_new - sT * vT
        c0 = jnp.sum(vT * dV, axis=0)       # v̄_old·Δv per feature
    else:
        dV = V_new = S_new = dS = dSV = jnp.zeros((0, Pf), dtype)
        c0 = jnp.zeros((Pf,), dtype)

    # B-space update coefficients (one feature per row within a color)
    dwB = jnp.einsum("bp,p->b", oh, dw, precision=hi)
    c0B = jnp.einsum("bp,p->b", oh, c0, precision=hi)
    a0 = xw * dwB - x2 * c0B
    A_q = jnp.einsum("bp,rp->rb", oh, dV, precision=hi) * xw[None]
    dS_B = jnp.einsum("bp,rp->rb", oh, dS, precision=hi)
    dSV_B = jnp.einsum("bp,rp->rb", oh, dSV, precision=hi)
    zeros1 = jnp.zeros((1, B), dtype)
    s_vec = jnp.concatenate(
        [a0[None], zeros1, A_q, jnp.zeros((3 * R, B), dtype)], axis=0
    )
    u_vec = jnp.concatenate(
        [
            zeros1, zeros1, A_q,
            dS_B * xw[None],        # Δa = x Δs
            dSV_B * x2[None],       # Δb = x² Δ(s v̄)
            dS_B * x2[None],        # Δc = x² Δs
        ],
        axis=0,
    )
    G = _update_gram_lanes_u(G, s_vec, u_vec, D)

    u_new = jnp.concatenate([w_new[:, None], V_new.T], axis=1)
    var_new = jnp.concatenate([wv_new[:, None], S_new.T], axis=1)
    return u_new, var_new, G


def _vi_ea_table_pass(
    plan: CategoricalPlan,
    ti: int,
    w, w_var, V, V_var,
    w0,
    alpha,
    lambda_w, mu_w, lambda_V, mu_V,
    group_index,
    tau_tile,
    cfg: VariationalConfig,
    gram_impl: str,
    eff,
):
    """Entity+attribute table pass for CAVI: the side features'
    coordinates are updated color by color in entity space, mirroring
    the Gibbs _ea_table_pass (ops/categorical.py) with variance
    bookkeeping.

    table_gram builds the per-block-row Gram over
    z = [1 | e | φ_o | a_o | b_o | c_o] from the OTHER tables'
    contributions (D = 4R+2); converting with the own-table per-entity
    constants (Ṽ and the ã/b̃/c̃ variance reductions ride the z₀ = 1
    column: G ← (I + Ue₀ᵀ) G (I + e₀Uᵀ)) yields the total-statistics
    Gram the color steps consume."""
    si = plan.side[ti]
    t = plan.tables[ti]
    rank = V.shape[1]
    D = 4 * rank + 2
    # every read in the color steps has its FIRST Gram index in the
    # [1 | e | q] rows — the variance-column x variance-column block
    # ((3R)^2 of the D^2 entries) is never consumed, and the
    # [rows_r, D] rectangle is closed under both the own-contribution
    # conversion and the T G T' color evolution (see
    # _update_gram_lanes_u) — ~(4R+2)/(R+2) x less Gram traffic
    rows_r = 2 + rank
    dtype = V.dtype
    B = t.n_cols
    own = eff[ti]

    def src(t2, eff2):
        # [lin | φ | a | b | c | qs]; for one-hot tables (x = 1) the
        # x-weighted variance sums a = c = s and b = sV̄
        if eff2 is None:
            ext = _ext_table(w, w_var, V, V_var, t2)
            s2 = ext[:, 2 + rank : 2 + 2 * rank]
            cols = [ext[:, :1], ext[:, 2 : 2 + rank], s2,
                    ext[:, 2 + 2 * rank : 2 + 3 * rank], s2,
                    ext[:, -1:]]
        else:
            cols = [eff2.ext[:, :1], eff2.ext[:, 2 : 2 + rank],
                    eff2.a1, eff2.b2,
                    eff2.ext[:, 2 + rank : 2 + 2 * rank],
                    eff2.qs[:, None]]
        return _pad_zero_row(jnp.concatenate(cols, axis=1))

    others = [
        (t2i, t2) for t2i, t2 in enumerate(plan.tables) if t2i != ti
    ]
    # own [w̃ | Ṽ | qs̃]: qs̃ = Σx²v̄² carries the own QS − Ṽ² term
    own_rows = jnp.concatenate(
        [own.ext[:, 0:1], own.ext[:, 2 : 2 + rank], own.qs[:, None]],
        axis=1,
    )
    # this pass's Gram keeps w0 inside e (the conversion below assumes
    # it): shifting the target by w0 does exactly that
    G = table_gram(
        _pad_zero_row(own_rows), t.ent_of_tile_row,
        [src(t2, eff[t2i]) for t2i, t2 in others],
        [plan.cross_ent[ti][t2i] for t2i, _ in others],
        tau_tile - w0, t.slot, t.seg, t.ent_slots,
        rank=rank, n_entities=B, tile_rows=t.tile_rows,
        tile_entities=t.tile_entities, chunk_tiles=t.chunk_tiles,
        impl=gram_impl,
    )

    if cfg.axis_name is not None:
        # side features couple entities across the whole table: psum
        # the Gram whole, then every device runs the identical
        # deterministic color scan (cf. Gibbs _ea_table_pass)
        G = lax.psum(G, cfg.axis_name)

    # own-contribution conversion: z_total = z + U·z₀ with per-entity
    # U = [0, 0, Ṽ, ã, b̃, c̃]  ⇒  G ← G + U g₀ᵀ + g₀ Uᵀ + G₀₀ UUᵀ
    U_conv = jnp.concatenate(
        [
            jnp.zeros((B, 2), dtype),
            own.ext[:, 2 : 2 + rank],           # Ṽ
            own.a1,                              # ã = Σxs
            own.b2,                              # b̃ = Σx²sv̄
            own.ext[:, 2 + rank : 2 + 2 * rank],  # c̃ = Σx²s
        ],
        axis=1,
    )
    U_r = U_conv[:, :rows_r]  # = [0, 0, Ṽ] (a/b/c rows are outside)
    col0 = G[:, :, 0:1]  # Ĝ[rect rows, 0]
    G = (
        G
        + U_r[:, :, None] * G[:, 0:1, :]
        + col0 * U_conv[:, None, :]
        + (U_r[:, :, None] * U_conv[:, None, :]) * G[:, 0:1, 0:1]
    )
    Gf = G.reshape(B, rows_r * D).T  # flat lanes-major [rows_r·D, B]

    # per-color pre-gathered moments/priors
    feat = si.stack_feat  # [C, Pf]
    U_all = jnp.concatenate([w[:, None], V], axis=1)
    S_all = jnp.concatenate([w_var[:, None], V_var], axis=1)
    lam_gu = jnp.concatenate([lambda_w[:, None], lambda_V], axis=1)
    mu_gu = jnp.concatenate([mu_w[:, None], mu_V], axis=1)
    gidx = group_index[feat]
    u0 = U_all[feat]
    s0 = S_all[feat]
    lam_s = lam_gu[gidx]
    mu_s = mu_gu[gidx]

    def body(Gc, xs_c):
        xw, segb, u_old, s_old, lam, mu = xs_c
        u_new, var_new, Gc = _vi_dense_color_step(
            Gc, xw, segb, u_old, s_old, lam, mu, alpha, rank,
            bool(cfg.fit_linear),
        )
        return Gc, (u_new, var_new)

    n_colors = feat.shape[0]
    if n_colors == 1:
        Gf, (u_n, var_n) = body(
            Gf,
            (si.stack_xw[0], si.stack_segb[0], u0[0], s0[0],
             lam_s[0], mu_s[0]),
        )
        u_all = u_n[None]
        var_all = var_n[None]
    else:
        Gf, (u_all, var_all) = lax.scan(
            body, Gf,
            (si.stack_xw, si.stack_segb, u0, s0, lam_s, mu_s),
            unroll=min(4, n_colors),
        )

    flat_feat = feat.reshape(-1)
    u_flat = u_all.reshape(-1, rank + 1)
    var_flat = var_all.reshape(-1, rank + 1)
    w = w.at[flat_feat].set(
        u_flat[:, 0], mode="drop", unique_indices=True
    )
    w_var = w_var.at[flat_feat].set(
        var_flat[:, 0], mode="drop", unique_indices=True
    )
    V = V.at[flat_feat].set(
        u_flat[:, 1:], mode="drop", unique_indices=True
    )
    V_var = V_var.at[flat_feat].set(
        var_flat[:, 1:], mode="drop", unique_indices=True
    )
    return w, w_var, V, V_var


def vi_refresh_rows(
    plan: CategoricalPlan,
    w0, w0_var, w, w_var, V, V_var,
    row_chunk: int = 1 << 20,
    eff=None,
):
    """(score [N], per-row Var(score) summed → scalar) in one chunked
    streaming pass (reference update_e_and_var, variational.hpp:715-833).

    Per factor the pairwise term f = ½(q² − Σx²V²) = Σ_{k<l} x_kx_lV_kV_l
    has Var(f) = q̄²·A2 − 2q̄·A5 + ½A2² − ½A4 + A7 with
    A2 = Σx²s, A5 = Σx³sv̄, A4 = Σx⁴s², A7 = Σx⁴sv̄² — for one-hot
    tables every x-power collapses; entity+attribute tables supply the
    true power-weighted sums via ``eff`` (vi_eff_tables)."""
    N = plan.n_rows
    rank = V.shape[1]
    nb = -(-N // row_chunk)
    Np = nb * row_chunk
    t0 = plan.tables[0]
    dtype = V.dtype
    if eff is None:
        eff = [None] * len(plan.tables)

    def pad_map(m, fill):
        if Np != N:
            m = jnp.concatenate([m, jnp.full((Np - N,), fill, m.dtype)])
        return m.reshape(nb, row_chunk)

    maps = [pad_map(t.ent_main, t.n_cols) for t in plan.tables]

    def block(ms):
        n = ms[0].shape[0]
        ones = (ms[0] < t0.n_cols).astype(dtype)
        lin = jnp.zeros((n,), dtype)
        wvar_s = jnp.zeros((n,), dtype)
        Q = jnp.zeros((n, rank), dtype)
        QS = jnp.zeros((n,), dtype)
        X2S = jnp.zeros((n, rank), dtype)
        X3SV = jnp.zeros((n, rank), dtype)
        X4S2 = jnp.zeros((n,), dtype)
        X4SV2 = jnp.zeros((n,), dtype)
        for t2, eff2, idx in zip(plan.tables, eff, ms):
            if eff2 is None:
                ext = _ext_rows(w, w_var, V, V_var, t2, idx)
                gth = ext[:, : 2 + 3 * rank]
                Vg = gth[:, 2 : 2 + rank]
                sg = gth[:, 2 + rank : 2 + 2 * rank]
                svg = gth[:, 2 + 2 * rank : 2 + 3 * rank]
                QS = QS + ext[:, 2 + 3 * rank]
                X4S2 = X4S2 + jnp.sum(sg * sg, axis=1)
                X4SV2 = X4SV2 + jnp.sum(svg * Vg, axis=1)
            else:
                packed = jnp.concatenate(
                    [
                        eff2.ext,
                        eff2.qs[:, None],
                        eff2.x4s2[:, None],
                        eff2.x4sv2[:, None],
                    ],
                    axis=1,
                )
                rows = _pad_zero_row(packed)[idx]
                W = eff2.ext.shape[1]
                gth = rows[:, :W]
                Vg = gth[:, 2 : 2 + rank]
                sg = gth[:, 2 + rank : 2 + 2 * rank]
                svg = gth[:, 2 + 2 * rank :]  # Σx³sv̄
                QS = QS + rows[:, W]
                X4S2 = X4S2 + rows[:, W + 1]
                X4SV2 = X4SV2 + rows[:, W + 2]
            lin = lin + gth[:, 0]
            wvar_s = wvar_s + gth[:, 1]
            Q = Q + Vg
            X2S = X2S + sg
            X3SV = X3SV + svg
        score = ones * w0 + lin
        if rank:
            score = score + 0.5 * (jnp.sum(Q * Q, axis=1) - QS)
        var_row = ones * w0_var + wvar_s
        if rank:
            var_row = var_row + jnp.sum(
                Q * Q * X2S - 2.0 * X3SV * Q, axis=1
            ) + 0.5 * jnp.sum(X2S * X2S, axis=1) \
                - 0.5 * X4S2 + X4SV2
        return score, jnp.sum(var_row * ones)

    if nb == 1:
        score, evs = block(tuple(m[0] for m in maps))
        score = score[:N]
    else:
        score, evs_blocks = lax.map(block, tuple(maps))
        score = score.reshape(Np)[:N]
        evs = jnp.sum(evs_blocks)
    return score, evs


def _group_elbo_terms(plan, state: VIState, cfg, elbo):
    """Hyper-group ELBO contributions (variational.hpp:861-913),
    shared with the colored path's vi_finish_e."""
    g = plan.group_index
    G = plan.n_groups
    counts = plan.group_counts

    elbo = elbo + state.alpha * state.alpha_rate * (
        1.0 - _safe_log(state.alpha_rate)
    )
    elbo = elbo - cfg.gamma_0 * (
        state.w0 * state.w0 + state.w0_var
    ) + 0.5 * _safe_log(state.w0_var)

    dev2_w = (state.w - state.mu_w[g]) ** 2
    rate_w = (
        cfg.beta_0
        + jax.ops.segment_sum(dev2_w + state.w_var, g, num_segments=G)
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
    return elbo


def categorical_vi_sweep(
    plan: CategoricalPlan,
    state: CategoricalVIState,
    y: jax.Array,
    y_tiles: Tuple[jax.Array, ...],
    cfg: VariationalConfig,
    gram_impl: str = "xla",
) -> CategoricalVIState:
    """One full CAVI iteration on the entity-space fast path."""
    core = state.core
    dtype = core.V.dtype
    n = plan.n_real
    rank = core.V.shape[1]

    # row-sum statistics of the (locally stored) residual; under SPMD
    # these psum to the global sums while e_var_sum is already stored
    # as the global scalar (replicated)
    sum_e = jnp.sum(core.e)
    sum_e2 = jnp.sum(core.e * core.e)
    if cfg.axis_name is not None:
        sum_e = lax.psum(sum_e, cfg.axis_name)
        sum_e2 = lax.psum(sum_e2, cfg.axis_name)

    # α
    if cfg.task == TASK_CLASSIFICATION:
        alpha = jnp.asarray(1.0, dtype)
        alpha_rate = jnp.asarray(1.0, dtype)
    else:
        e_all = sum_e2 + core.e_var_sum
        alpha_rate = (cfg.beta_0 + e_all) / 2.0
        alpha = jnp.asarray((cfg.alpha_0 + n) / 2.0, dtype) / alpha_rate

    # w0 (e is refreshed at sweep end; only the stats are needed here)
    w0, w0_var = core.w0, core.w0_var
    if cfg.fit_w0:
        quad = alpha * n + cfg.reg_0
        lin = alpha * (n * w0 - sum_e)
        w0 = lin / quad
        w0_var = 1.0 / quad

    lambda_w, lambda_w_rate = vi_update_lambda(
        core.w, core.w_var, core.mu_w, core.mu_w_var,
        plan.group_index, plan.group_counts, cfg,
    )
    mu_w, mu_w_var = vi_update_mu(
        core.w, lambda_w, plan.group_index, plan.group_counts, cfg
    )
    lambda_V, lambda_V_rate = vi_update_lambda(
        core.V, core.V_var, core.mu_V, core.mu_V_var,
        plan.group_index, plan.group_counts, cfg,
    )
    mu_V, mu_V_var = vi_update_mu(
        core.V, lambda_V, plan.group_index, plan.group_counts, cfg
    )

    w, w_var, V, V_var = core.w, core.w_var, core.V, core.V_var
    has_side = any(si is not None for si in plan.side)
    eff = (
        vi_eff_tables(plan, w, w_var, V, V_var) if has_side else None
    )
    for ti, t in enumerate(plan.tables):
        if cfg.task == TASK_REGRESSION:
            tau_tile = y_tiles[ti]
        else:
            tau_tile = _pad_zero_row(state.tau[:, None])[t.src][:, 0]
        if plan.side[ti] is not None:
            w, w_var, V, V_var = _vi_ea_table_pass(
                plan, ti, w, w_var, V, V_var, w0, alpha,
                lambda_w, mu_w, lambda_V, mu_V,
                plan.group_index, tau_tile, cfg, gram_impl, eff,
            )
            # the pass changed this table's side moments — later
            # tables' cross-gathers and the final refresh must see
            # the updated reductions
            eff = vi_eff_tables(plan, w, w_var, V, V_var)
        else:
            w, w_var, V, V_var = _vi_table_pass(
                plan, ti, w, w_var, V, V_var, w0, alpha,
                lambda_w, mu_w, lambda_V, mu_V,
                plan.group_index, tau_tile, cfg, gram_impl, eff=eff,
            )

    # refresh (e, e_var_sum) + task finish + ELBO
    score, e_var_sum = vi_refresh_rows(
        plan, w0, w0_var, w, w_var, V, V_var, eff=eff
    )
    # SPMD pad rows: scores are forced to 0 but the probit
    # truncated-normal moments of 0 are nonzero — mask the latent
    # mean/residual and the per-row ELBO term by row validity
    valid = _row_validity(plan, cfg, dtype)
    if cfg.axis_name is not None:
        e_var_sum = lax.psum(e_var_sum, cfg.axis_name)
    tau = state.tau
    elbo = jnp.asarray(0.0, dtype)
    if cfg.task == TASK_REGRESSION:
        e = score - y
    elif cfg.task == TASK_CLASSIFICATION:
        m_l, v_l, z_l = mean_var_truncated_normal_left(score)
        m_r, v_r, z_r = mean_var_truncated_normal_right(score)
        mean = jnp.where(y > 0, m_l, m_r)
        logz = jnp.where(y > 0, z_l, z_r)
        e = score - mean
        tau = mean
        row_elbo = logz + 0.5 * (mean - score) ** 2
        if valid is not None:
            e = e * valid
            tau = tau * valid
            row_elbo = row_elbo * valid
        elbo = elbo + jnp.sum(row_elbo)
    else:
        raise NotImplementedError(
            "Ordered probit for variational FM is not implemented "
            "(parity with the reference, variational.hpp:857-859)."
        )

    new_core = VIState(
        w0=w0, w0_var=w0_var, w=w, w_var=w_var, V=V, V_var=V_var,
        e=e, e_var_sum=e_var_sum, alpha=alpha, alpha_rate=alpha_rate,
        mu_w=mu_w, mu_w_var=mu_w_var,
        lambda_w=lambda_w, lambda_w_rate=lambda_w_rate,
        mu_V=mu_V, mu_V_var=mu_V_var,
        lambda_V=lambda_V, lambda_V_rate=lambda_V_rate,
        elbo=jnp.asarray(0.0, dtype),
    )
    row_sq = jnp.sum(e * e)
    if cfg.axis_name is not None:
        # elbo holds only row-local terms at this point; the
        # weight-space terms below are replicated and added after
        row_sq = lax.psum(row_sq, cfg.axis_name)
        elbo = lax.psum(elbo, cfg.axis_name)
    elbo = elbo - alpha * (cfg.beta_0 + row_sq + e_var_sum) / 2.0
    elbo = _group_elbo_terms(plan, new_core, cfg, elbo)
    new_core = dataclasses.replace(new_core, elbo=elbo)
    return CategoricalVIState(core=new_core, tau=tau)


def init_categorical_vi_state(
    plan: CategoricalPlan, core: VIState, y, cfg: VariationalConfig
) -> CategoricalVIState:
    """Reference initialize (variational.hpp:234-241): full
    mean/variance forward, e = score − y for all tasks."""
    eff = (
        vi_eff_tables(plan, core.w, core.w_var, core.V, core.V_var)
        if any(si is not None for si in plan.side)
        else None
    )
    score, e_var_sum = vi_refresh_rows(
        plan, core.w0, core.w0_var, core.w, core.w_var, core.V,
        core.V_var, eff=eff,
    )
    if cfg.axis_name is not None:
        # store the GLOBAL Var(score) sum (replicated scalar); pad
        # rows are already masked inside vi_refresh_rows
        e_var_sum = lax.psum(e_var_sum, cfg.axis_name)
    e = score - y
    tau = None
    if cfg.task == TASK_CLASSIFICATION:
        # first sweep's table passes need a target; start from y
        # (±1 coding) exactly like the reference's initial residual
        tau = jnp.asarray(y, dtype=score.dtype)
    core = dataclasses.replace(core, e=e, e_var_sum=e_var_sum)
    return CategoricalVIState(core=core, tau=tau)
