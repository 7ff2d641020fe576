"""Entity-space Gibbs sweep for all-categorical designs (fast path).

For designs where every table is one-hot per row (user id, item id,
date bucket — the reference's MovieLens protocols), the Gibbs sweep is
re-derived so that NO [N]-sized state is permuted between tables at
all: because every table is categorical, the residual and the factor
sums are pure functions of the small per-entity weight tables,

    score_n = w0 + sum_t w_t[c_t(n)] + 1/2 sum_r (Q_{nr}^2 - QS_{nr}),
    Q_n = sum_t V_t[c_t(n)],  QS_n = sum_t V_t[c_t(n)]^2,
    e_n = score_n - tau_n     (tau = y, or the probit latent z),

so each table pass reconstructs (e, phi) **in its own tile space** with
small-source row-gathers ([B_t', 2+R] weight tables, which stay in
cache) instead of permuting [N, 1+R] row state, and writes back only
the updated weight slices.

Math (per categorical table t; entity u ≡ feature; x = 1):

  Linear weight draw (reference FMTrainer.hpp:231-314):
      quad = alpha * card_u + lambda_w
      lin  = alpha * (card_u * w_old − E1_u) + lambda_w * mu_w,
      E1_u = sum_{n in u} e_n.

  Factor r draw (FMTrainer.hpp:316-486): with phi_{r,n} = q_{r,n} − v_old,
      quad = alpha * Sphi2_{r,u} + lambda_V[r]
      lin  = alpha * (Sphi2_{r,u} v_old − EQ_{r,u}) + lambda_V mu_V.

  All per-entity statistics are entries of ONE Gram matrix
      G_u = sum_{n in u} z z^T,  z = [1 | e | phi_1..phi_R]
  (ops/gram.py):
      card = G[0,0], E1 = G[0,1], Sphi_r = G[0,2+r],
      EQ_r = G[1,2+r], Sphi2_r = G[2+r,2+r], sum phi_r phi_s = G[2+r,2+s].

  Sequential correctness: within a table the phi_r columns are fixed
  during the table's scan (updating factor r changes q_r only, which
  later factors never read), so the only cross-coordinate coupling is
  through e — and e's updates live in the Gram too:
      after the w draw:        EQ_r += delta_w Sphi_r
      after drawing factor r:  EQ_s += delta_r G[2+r, 2+s]
  so the whole scan is [B]-vectorized arithmetic with zero row traffic.

Update order (a valid fixed-scan Gibbs; deviates from the reference's
all-w-then-all-V order only in that each table's w draw immediately
precedes its factor scan — same stationary distribution):
  alpha -> w0 -> lambda_w/mu_w -> lambda_V/mu_V ->
  per table: {w_t, V_t factor scan} -> task residual refresh.

e is recomputed from the weights at every use (the reference's own
update_e recomputes it once per sweep, FMTrainer.hpp:493-522), so there
is no incremental float drift at all.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..design_categorical import CategoricalPlan, CategoricalTable
from .gibbs import (
    GibbsConfig,
    GibbsState,
    TASK_CLASSIFICATION,
    TASK_ORDERED,
    TASK_REGRESSION,
    _draw_normal,
    draw_lambda,
    draw_mu,
)
from .gram import table_gram
from .special import truncated_std_normal_onesided


@dataclasses.dataclass
class CategoricalState:
    """GibbsState plus the latent target tau (tau = z for the probit
    tasks; for regression it is None and y is used directly) and the
    carried residual moments sum_e = Σe, sum_e2 = Σe².

    For regression the α and w0 conditionals need only these two
    scalars, and both are maintained exactly in entity space from the
    Gram statistics — the fast path never materializes e at all."""

    core: GibbsState
    tau: Optional[jax.Array]
    sum_e: jax.Array
    sum_e2: jax.Array


jax.tree_util.register_dataclass(
    CategoricalState,
    data_fields=["core", "tau", "sum_e", "sum_e2"],
    meta_fields=[],
)


def _pad_zero_row(arr: jax.Array) -> jax.Array:
    """Append one all-zero row so pad indices gather zeros in-bounds
    (fill-mode gathers lower to a much slower XLA path)."""
    return jnp.concatenate(
        [arr, jnp.zeros((1,) + arr.shape[1:], arr.dtype)], axis=0
    )


def _table_slice(W: jax.Array, t: CategoricalTable) -> jax.Array:
    return W[t.col_offset : t.col_offset + t.n_cols]


def _wv_table(w, V, t2: CategoricalTable) -> jax.Array:
    """Per-entity [w | V | qs] rows ([B, 2+R]) of a one-hot table.  The
    trailing qs = Σ_r V² column is computed once per [B]-sized table so
    consumers of gathered rows add one column instead of squaring and
    reducing every row."""
    V_t = _table_slice(V, t2)
    return jnp.concatenate(
        [
            _table_slice(w, t2)[:, None],
            V_t,
            jnp.sum(V_t * V_t, axis=1)[:, None],
        ],
        axis=1,
    )


def eff_tables(plan: CategoricalPlan, w, V):
    """Per-table effective entity weights.

    ``None`` for plain one-hot tables (their [w_t | V_t] slices ARE the
    per-entity tables).  For an entity+attribute table (plan.side[t]),
    the gather source is the dense per-entity reduction of the side
    weights (round-1 design; reference treats these columns through the
    generic coordinate scan, FMTrainer.hpp:256-314):

        w̃_u = Xs[u,:]·w_s,  Ṽ_u = Xs[u,:]@V_s,
        qs_u = Σ_r Xs²[u,:]·V_s²[:,r]   (the TRUE per-entity Σ x²V²),

    packed as one [B, 1+R+1] array [w̃ | Ṽ | qs] — the same
    [w | V | qs] layout _wv_table produces for one-hot tables, so every
    gathered row carries its squared-factor sum precomputed."""
    out = []
    for t, si in zip(plan.tables, plan.side):
        if si is None:
            out.append(None)
            continue
        w_s = w[si.feat_cols]  # [Fs]
        V_s = V[si.feat_cols]  # [Fs, R]
        hi = lax.Precision.HIGHEST
        w_eff = jnp.matmul(si.xs, w_s, precision=hi)  # [B]
        V_eff = jnp.matmul(si.xs, V_s, precision=hi)  # [B, R]
        S_eff = jnp.matmul(si.xs * si.xs, V_s * V_s, precision=hi)
        qs = jnp.sum(S_eff, axis=1)  # [B] true Σ_i x² V² per entity
        out.append(
            jnp.concatenate(
                [w_eff[:, None], V_eff, qs[:, None]], axis=1
            )
        )
    return out


def _src_table(w, V, t2: CategoricalTable, eff2) -> jax.Array:
    """Table t2's per-entity contribution rows [B, 2+R] = [w | V | qs]
    (qs the true per-row Σᵢ x²V²; Σ_r V² for one-hot tables)."""
    return _wv_table(w, V, t2) if eff2 is None else eff2


def _eff_rows(w, V, t2: CategoricalTable, eff2, idx: jax.Array):
    """Gather table t2's [w | V | qs] contribution rows by entity index
    (pad index B → zero row)."""
    return _pad_zero_row(_src_table(w, V, t2, eff2))[idx]


def _score_parts(plan: CategoricalPlan, w, V, w0, ent_maps, ones,
                 eff=None):
    """(score, Q) at the rows addressed by ent_maps[t2] for each table.

    ``ones`` masks pad rows (only needed for the w0 term; gathered pad
    rows are already zero).  The squared term is accumulated as a
    per-row scalar — never materializing an [n, R] QS matrix (device memory
    matters at 1e7 rows)."""
    rank = V.shape[1]
    n = ent_maps[0].shape[0]
    dtype = V.dtype
    if eff is None:
        eff = eff_tables(plan, w, V)
    lin = jnp.zeros((n,), dtype)
    Q = jnp.zeros((n, rank), dtype)
    qs_sum = jnp.zeros((n,), dtype)
    for t2, eff2, idx in zip(plan.tables, eff, ent_maps):
        g = _eff_rows(w, V, t2, eff2, idx)  # [n, 2+R] = [w | V | qs]
        lin = lin + g[:, 0]
        Q = Q + g[:, 1 : 1 + rank]
        qs_sum = qs_sum + g[:, 1 + rank]
    score = ones * w0 + lin
    if rank:
        score = score + 0.5 * (jnp.sum(Q * Q, axis=1) - qs_sum)
    return score, Q


def score_rows(plan: CategoricalPlan, w0, w, V,
               row_chunk: int = 1 << 20):
    """Forward pass in main row order, chunked over rows so peak memory
    stays O(row_chunk * R) (eager init at 1e7 rows x rank 128 would
    otherwise materialize ~15 GB).  Rows masked for SPMD padding
    (ent_main == B) score zero."""
    N = plan.n_rows
    nb = -(-N // row_chunk)
    Np = nb * row_chunk
    t0 = plan.tables[0]

    def pad_map(m, fill):
        if Np != N:
            m = jnp.concatenate(
                [m, jnp.full((Np - N,), fill, m.dtype)]
            )
        return m.reshape(nb, row_chunk)

    maps = [pad_map(t.ent_main, t.n_cols) for t in plan.tables]
    eff = eff_tables(plan, w, V)

    def block(ms):
        ones = (ms[0] < t0.n_cols).astype(V.dtype)
        s, _ = _score_parts(plan, w, V, w0, list(ms), ones, eff)
        return s

    if nb == 1:
        score = block(tuple(m[0] for m in maps))
    else:
        score = lax.map(block, tuple(maps)).reshape(Np)
    return score[:N]


def score_and_q(plan: CategoricalPlan, w0, w, V):
    """(score [N], Q [N, R]) in main row order (unchunked; prefer
    score_rows when Q is not needed)."""
    t0 = plan.tables[0]
    ones = (t0.ent_main < t0.n_cols).astype(V.dtype)
    ent_maps = [t.ent_main for t in plan.tables]
    return _score_parts(plan, w, V, w0, ent_maps, ones)


def _build_table_gram(
    plan: CategoricalPlan,
    ti: int,
    w: jax.Array,
    V: jax.Array,
    eff,  # per-table effective rows (eff_tables)
    own_rows: jax.Array,  # [B, 2+R] own per-entity [w | V | qs]
    tau_tile: jax.Array,
    gram_impl: str,
):
    """Per-entity Gram G_u = Σ_{n∈u} z zᵀ, z = [1 | e⁰ | φ_other], for
    table ti, reconstructed from the current weights (ops/gram.py).

    e⁰ EXCLUDES w0: consumers apply the exact rank-1 correction
    z₁ += w0·z₀ to the Gram statistics (_entity_draws / _ea_table_pass),
    so the per-row side data stays two [NT] vectors (slot, τ)."""
    t = plan.tables[ti]
    others = [
        (t2i, t2) for t2i, t2 in enumerate(plan.tables) if t2i != ti
    ]
    return table_gram(
        _pad_zero_row(own_rows),
        t.ent_of_tile_row,
        [_pad_zero_row(_src_table(w, V, t2, eff[t2i]))
         for t2i, t2 in others],
        [plan.cross_ent[ti][t2i] for t2i, _ in others],
        tau_tile, t.slot, t.seg, t.ent_slots,
        rank=V.shape[1], n_entities=t.n_cols, tile_rows=t.tile_rows,
        tile_entities=t.tile_entities, chunk_tiles=t.chunk_tiles,
        impl=gram_impl,
    )


def _table_pass(
    plan: CategoricalPlan,
    ti: int,
    w: jax.Array,  # [F]
    V: jax.Array,  # [F, R]
    w0,
    alpha,
    lambda_w,
    mu_w,
    lambda_V,
    mu_V,
    group_index,
    noise_w,  # [F]
    noise_V,  # [F, R]
    tau_tile,  # [NT] latent target in this table's tile order (pad 0)
    cfg: GibbsConfig,
    gram_impl: str,
    want_moments: bool = False,
    eff=None,
):
    """One table's w draw + factor scan; returns (w, V, moments).

    ``moments`` (when requested — the sweep's last table) is the exact
    post-draw (Σe, Σe²), computed purely from Gram statistics:
    with Δ_n = δw_u + Σ_r δ_r φ_rn,
        Σe'  = Σe + Σ_u [δw card + Σ_r δ_r Sφ_r]
        Σe'² = Σe² + 2 Σ_u [δw E1 + Σ_r δ_r EQφ⁰_r]
               + Σ_u [δw² card + 2 δw Σ_r δ_r Sφ_r + δᵀ Gφ δ].
    """
    t = plan.tables[ti]
    B = t.n_cols

    w_t = _table_slice(w, t)  # [B]
    V_t = _table_slice(V, t)  # [B, R]
    g_t = group_index[t.col_offset : t.col_offset + t.n_cols]  # [B]
    if eff is None:
        eff = eff_tables(plan, w, V)

    G = _build_table_gram(
        plan, ti, w, V, eff, _wv_table(w, V, t), tau_tile, gram_impl,
    )

    nw_t = noise_w[t.noise_feat]
    nV_t = noise_V[t.noise_feat]
    use_rs = (
        cfg.axis_name is not None
        and cfg.gram_reduce_scatter
        and B % cfg.n_devices == 0
        and cfg.n_devices > 1
    )
    if use_rs:
        # SPMD, reduce-scatter layout: each device receives the summed
        # Gram for ITS contiguous entity window only ((n−1)/n of the
        # psum's bytes), draws that window's weights (per-feature
        # noise ⇒ identical values regardless of which device computes
        # them), and the [Bw, 1+R] drawn weights are all-gathered —
        # a factor ~(D²/(1+R)) less traffic than psum'ing [B, D, D].
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
            return lax.dynamic_slice(
                a, begin, (Bw,) + a.shape[1:]
            )

        w_new_w, V_new_w, parts = _entity_draws(
            Gw, w0, win(w_t), win(V_t), win(g_t), alpha, lambda_w,
            mu_w, lambda_V, mu_V, win(nw_t), win(nV_t), cfg,
            want_moments,
        )
        w_new = lax.all_gather(
            w_new_w, cfg.axis_name, axis=0, tiled=True
        )
        V_new = lax.all_gather(
            V_new_w, cfg.axis_name, axis=0, tiled=True
        )
        moments = None
        if want_moments:
            sum_e = lax.psum(parts[0], cfg.axis_name)
            sum_e2 = lax.psum(parts[1], cfg.axis_name)
            moments = (sum_e, sum_e2)
    else:
        if cfg.axis_name is not None:
            # SPMD: rows are sharded; per-shard partial Grams sum to
            # the global per-entity statistics.  Weights/noise are
            # replicated, so every draw downstream is identical on
            # every device.
            G = lax.psum(G, cfg.axis_name)
        w_new, V_new, parts = _entity_draws(
            G, w0, w_t, V_t, g_t, alpha, lambda_w, mu_w, lambda_V,
            mu_V, nw_t, nV_t, cfg, want_moments,
        )
        moments = parts if want_moments else None

    w = lax.dynamic_update_slice(w, w_new, (t.col_offset,))
    V = lax.dynamic_update_slice(V, V_new, (t.col_offset, 0))
    return w, V, moments


def _entity_draws(G, w0, w_t, V_t, g_t, alpha, lambda_w, mu_w,
                  lambda_V, mu_V, noise_w_t, noise_V_t, cfg,
                  want_moments):
    """Per-entity w draw + factor scan from the Gram statistics.

    The kernel builds G over z = [1 | e⁰ | φ] with e⁰ = e − w0; the
    true-residual statistics follow exactly from z₁ = z₁⁰ + w0·z₀:
        E1 = E1⁰ + w0·card,  Σeφ_r = Σe⁰φ_r + w0·Σφ_r,
        Σe² = Σe⁰² + 2·w0·E1⁰ + w0²·card
    ([B]-sized arithmetic, so the Gram pass needs no w0 operand).

    Operates on any contiguous entity window (the full table, or one
    device's reduce-scatter shard); all operands are window-sliced.
    Returns (w_new, V_new, (Σe, Σe²) partial sums over the window)."""
    rank = V_t.shape[1]
    card = G[:, 0, 0]
    Sphi = G[:, 0, 2:]  # [B, R]
    E1_0 = G[:, 0, 1]  # Σ e⁰ (w0-less residual)
    E1 = E1_0 + w0 * card
    EQphi0 = G[:, 1, 2:] + w0 * Sphi  # [B, R] pre-draw Σ e φ

    lam_w = lambda_w[g_t]
    mu_wg = mu_w[g_t]

    # --- linear weight draw (vectorized over the whole window) --------
    if cfg.fit_linear:
        quad = alpha * card + lam_w
        lin = alpha * (card * w_t - E1) + lam_w * mu_wg
        w_new = _draw_normal(quad, lin, noise_w_t)
        dw = w_new - w_t
        # e_n += dw_u  ->  EQ_r += dw * Sphi_r  (E1 not reused)
        EQphi = EQphi0 + dw[:, None] * Sphi
    else:
        w_new = w_t
        dw = jnp.zeros_like(w_t)
        EQphi = EQphi0

    # --- factor scan in entity space, chunked --------------------------
    # Sequential per-coordinate draws over factors; the cross-factor
    # coupling EQ_s += delta_r * G[r, s] is applied densely within a
    # chunk of C factors and lazily to later chunks with one einsum per
    # chunk — the [B, R, R] Gram block is never transposed whole.
    if rank:
        C = min(8, rank)
        lam_V = lambda_V[g_t]  # [B, R]
        mu_Vg = mu_V[g_t]  # [B, R]

        v_new_cols = []
        EQ_corr = jnp.zeros_like(EQphi)
        for c0 in range(0, rank, C):
            c1 = min(c0 + C, rank)
            Gc = G[:, 2 + c0 : 2 + c1, 2:]  # [B, c, R] contiguous
            EQ_chunk = (EQphi + EQ_corr)[:, c0:c1]  # [B, c]
            deltas = []
            for j in range(c1 - c0):
                r = c0 + j
                diag_r = Gc[:, j, r]  # G[:, 2+r, 2+r]
                v_old = V_t[:, r]
                EQ_col = EQ_chunk[:, j]
                quad = alpha * diag_r + lam_V[:, r]
                lin = (
                    alpha * (diag_r * v_old - EQ_col)
                    + lam_V[:, r] * mu_Vg[:, r]
                )
                v_new = _draw_normal(quad, lin, noise_V_t[:, r])
                delta = v_new - v_old
                if j + 1 < c1 - c0:
                    EQ_chunk = EQ_chunk.at[:, j + 1 :].add(
                        delta[:, None] * Gc[:, j, r + 1 : c1]
                    )
                v_new_cols.append(v_new)
                deltas.append(delta)
            if c1 < rank:
                delta_c = jnp.stack(deltas, axis=1)  # [B, c]
                EQ_corr = EQ_corr.at[:, c1:].add(
                    jnp.einsum(
                        "bc,bcr->br", delta_c, Gc[:, :, c1:],
                        precision=jax.lax.Precision.HIGHEST,
                    )
                )
        V_new = jnp.stack(v_new_cols, axis=1)  # [B, R]
    else:
        V_new = V_t

    parts = None
    if want_moments:
        dV = V_new - V_t  # [B, R]
        # Σe² from the w0-less kernel stats (see docstring identity)
        E2 = (
            jnp.sum(G[:, 1, 1])
            + 2.0 * w0 * jnp.sum(E1_0)
            + w0 * w0 * jnp.sum(card)
        )
        dphi = jnp.sum(dV * Sphi, axis=1)  # [B] Σ_r δ_r Sφ_r
        sum_e = jnp.sum(E1) + jnp.sum(dw * card) + jnp.sum(dphi)
        cross = jnp.sum(dw * E1) + jnp.sum(dV * EQphi0)
        quad_term = (
            jnp.sum(dw * dw * card)
            + 2.0 * jnp.sum(dw * dphi)
            + jnp.einsum(
                "br,brs,bs->", dV, G[:, 2:, 2:], dV,
                precision=jax.lax.Precision.HIGHEST,
            )
        )
        sum_e2 = E2 + 2.0 * cross + quad_term
        parts = (sum_e, sum_e2)

    return w_new, V_new, parts


def _ea_table_pass(
    plan: CategoricalPlan,
    ti: int,
    w: jax.Array,
    V: jax.Array,
    w0,
    alpha,
    lambda_w,
    mu_w,
    lambda_V,
    mu_V,
    group_index,
    noise_w,
    noise_V,
    tau_tile,
    cfg: GibbsConfig,
    gram_impl: str,
    want_moments: bool = False,
    eff=None,
):
    """Entity+attribute table pass: the side features are drawn with
    (R+1)-dim joint conditionals per feature, one graph color at a
    time, entirely in entity space.

    The tile kernel produces the per-entity Gram over z = [1|e|φ_other]
    (φ_other excludes THIS table).  Converting to Q-space with the
    current effective factors Ṽ_u (z_Q = [1, e, φ+Ṽ] = M z, so
    G_Q = M G Mᵀ) yields exactly the per-block-row Gram the joint
    sweep's dense color machinery consumes (ops/joint.py): per color,
    draw statistics come from one [D², B] @ [B, 4Pf] matmul, and the
    e/q effects of the draws evolve the Gram exactly as Ĝ ← T Ĝ Tᵀ —
    so later colors (and the returned residual moments) see exact
    post-draw statistics.  Same stationary distribution as the
    reference's w-then-per-factor coordinate scans over these columns
    (FMTrainer.hpp:231-314, 379-482): a blocked Gibbs draw of each
    feature's joint [w_j | V_j] row."""
    from .joint import _dense_color_step, _update_gram_lanes

    si = plan.side[ti]
    rank = V.shape[1]
    D = rank + 2
    dtype = V.dtype
    if eff is None:
        eff = eff_tables(plan, w, V)
    own = eff[ti]  # [B, 2+R] = [w̃ | Ṽ | qs̃]

    G = _build_table_gram(
        plan, ti, w, V, eff, own, tau_tile, gram_impl,
    )
    if cfg.axis_name is not None:
        # side features couple entities across the whole table, so the
        # Gram is psum'd whole (no reduce-scatter window for EA); the
        # color scan below is then replicated — identical draws on
        # every device
        G = lax.psum(G, cfg.axis_name)

    # φ→Q (and e⁰→e) conversion: G' = M G Mᵀ with
    # M = I + w0·e₁e₀ᵀ + Σ_r Ṽ_r e_{2+r} e₀ᵀ — the kernel's z is
    # [1 | e−w0 | φ], the color machinery consumes [1 | e | Q]; both
    # fixes are rank-1 additions of the z₀ column
    w0b = jnp.broadcast_to(
        jnp.asarray(w0, dtype), (own.shape[0], 1)
    )
    vv = jnp.concatenate(
        [jnp.zeros((own.shape[0], 1), dtype), w0b, own[:, 1:-1]],
        axis=1,
    )  # [B, D]
    G = (
        G
        + vv[:, :, None] * G[:, 0:1, :]
        + G[:, :, 0:1] * vv[:, None, :]
        + (vv[:, :, None] * vv[:, None, :]) * G[:, 0:1, 0:1]
    )
    Gf = G.reshape(-1, D * D).T  # flat lanes-major [D², B]

    # per-color pre-gathered operands (features partition across
    # colors, so weight rows / priors / noise are gathered once)
    feat = si.stack_feat  # [C, Pf]
    U = jnp.concatenate([w[:, None], V], axis=1)
    lam_gu = jnp.concatenate([lambda_w[:, None], lambda_V], axis=1)
    mu_gu = jnp.concatenate([mu_w[:, None], mu_V], axis=1)
    xi_all = jnp.concatenate([noise_w[:, None], noise_V], axis=1)
    gidx = group_index[feat]
    u0 = U[feat]  # [C, Pf, R+1]
    lam_s = lam_gu[gidx]
    mu_s = mu_gu[gidx]
    xi_s = xi_all[feat]

    def body(Gc, xs):
        xw, segb, u_old, lam, mu, xi = xs
        u_new, a0, A_B = _dense_color_step(
            Gc, xw, segb, u_old, lam, mu, xi, alpha, D
        )
        Gc = _update_gram_lanes(Gc, a0, A_B, D)
        return Gc, u_new

    n_colors = feat.shape[0]
    if n_colors == 1:
        Gf, u_new = body(
            Gf,
            (si.stack_xw[0], si.stack_segb[0], u0[0], lam_s[0],
             mu_s[0], xi_s[0]),
        )
        u_all = u_new[None]
    else:
        Gf, u_all = lax.scan(
            body, Gf,
            (si.stack_xw, si.stack_segb, u0, lam_s, mu_s, xi_s),
            unroll=min(4, n_colors),
        )

    flat_feat = feat.reshape(-1)
    u_flat = u_all.reshape(-1, rank + 1)
    w = w.at[flat_feat].set(
        u_flat[:, 0], mode="drop", unique_indices=True
    )
    V = V.at[flat_feat].set(
        u_flat[:, 1:], mode="drop", unique_indices=True
    )

    moments = None
    if want_moments:
        # z rows are [1, e, Q]: flat row 1 is Σe per entity, row D+1
        # is Σe² — exact post-draw values (already global under SPMD)
        moments = (jnp.sum(Gf[1]), jnp.sum(Gf[D + 1]))
    return w, V, moments


def _row_validity(plan: CategoricalPlan, cfg: GibbsConfig, dtype):
    """SPMD row-validity mask ([n_local], 1.0 on real rows) or None
    single-chip (where no pad rows exist)."""
    if cfg.axis_name is None:
        return None
    t0 = plan.tables[0]
    return (t0.ent_main < t0.n_cols).astype(dtype)


def _sliced_global_uniform(key, plan: CategoricalPlan, cfg: GibbsConfig,
                           dtype):
    """This shard's contiguous slice of one globally drawn U(0,1)
    vector (threefry prefix property: uniform(key, (m,))[:n] ==
    uniform(key, (n,)), so the n_devices=1 chain and the sharded chain
    see identical uniforms row-for-row).  None single-chip."""
    if cfg.axis_name is None:
        return None
    n_local = plan.n_rows
    tiny = jnp.finfo(dtype).tiny
    u_global = jax.random.uniform(
        key, (n_local * cfg.n_devices,), dtype=dtype,
        minval=tiny, maxval=1.0,
    )
    idx = lax.axis_index(cfg.axis_name)
    return lax.dynamic_slice(u_global, (idx * n_local,), (n_local,))


def categorical_sweep(
    plan: CategoricalPlan,
    state: CategoricalState,
    y: jax.Array,
    y_tiles: Tuple[jax.Array, ...],
    key,
    cfg: GibbsConfig,
    gram_impl: str = "xla",
) -> CategoricalState:
    """One full Gibbs iteration on the categorical fast path.

    ``y_tiles[t]`` is y gathered to table t's tile order (precomputed
    once per fit; for the probit tasks the latent tau is gathered here
    instead, once per sweep).  ``gram_impl`` is an ops/gram.IMPLS
    entry (gram.choose_impl picks it for the platform)."""
    core = state.core
    dtype = core.V.dtype
    n = plan.n_real
    rank = core.V.shape[1]
    (k_alpha, k_w0, k_lw, k_mw, k_w, k_lv, k_mv, k_v, k_e) = (
        jax.random.split(key, 9)
    )

    sum_e = state.sum_e
    sum_e2 = state.sum_e2
    if cfg.task == TASK_REGRESSION:
        # α | e ~ Gamma((α₀+n)/2, rate=(β₀+Σe²)/2) from the carried
        # moment (FMTrainer.hpp:127-145) — no [N] residual needed
        shape = jnp.asarray((cfg.alpha_0 + n) / 2.0, dtype)
        rate = (jnp.asarray(cfg.beta_0, dtype) + sum_e2) / 2.0
        alpha = jax.random.gamma(k_alpha, shape, dtype=dtype) / rate
    else:
        alpha = jnp.asarray(1.0, dtype)

    w0 = core.w0
    if cfg.fit_w0:
        # w0 conditional from Σe (FMTrainer.hpp:218-229); moments are
        # updated exactly for the constant shift Δ = w0' − w0
        quad = alpha * n + jnp.asarray(cfg.reg_0, dtype)
        lin = alpha * (n * w0 - sum_e)
        w0_new = _draw_normal(
            quad, lin, jax.random.normal(k_w0, (), dtype=dtype)
        )
        d0 = w0_new - w0
        sum_e2 = sum_e2 + 2.0 * d0 * sum_e + n * d0 * d0
        sum_e = sum_e + n * d0
        w0 = w0_new

    lambda_w = draw_lambda(
        k_lw, core.w, core.mu_w, plan.group_index, plan.group_counts, cfg
    )
    mu_w = draw_mu(
        k_mw, core.w, lambda_w, plan.group_index, plan.group_counts, cfg
    )
    lambda_V = draw_lambda(
        k_lv, core.V, core.mu_V, plan.group_index, plan.group_counts, cfg
    )
    mu_V = draw_mu(
        k_mv, core.V, lambda_V, plan.group_index, plan.group_counts, cfg
    )

    noise_w = jax.random.normal(k_w, (plan.n_features,), dtype=dtype)
    noise_V = jax.random.normal(
        k_v, (plan.n_features, rank), dtype=dtype
    )

    w, V = core.w, core.V
    n_tables = len(plan.tables)
    moments = None
    eff = eff_tables(plan, w, V)
    for ti, t in enumerate(plan.tables):
        if cfg.task == TASK_REGRESSION:
            tau_tile = y_tiles[ti]
        else:
            tau_tile = _pad_zero_row(state.tau[:, None])[t.src][:, 0]
        pass_fn = (
            _ea_table_pass if plan.side[ti] is not None else _table_pass
        )
        w, V, moments = pass_fn(
            plan, ti, w, V, w0, alpha, lambda_w, mu_w, lambda_V, mu_V,
            plan.group_index, noise_w, noise_V, tau_tile, cfg, gram_impl,
            want_moments=(
                cfg.task == TASK_REGRESSION and ti == n_tables - 1
            ),
            eff=eff,
        )
        if plan.side[ti] is not None and ti != n_tables - 1:
            # refresh this table's effective entity rows for the
            # remaining passes (one small dense matmul per refresh)
            eff = list(eff)
            eff[ti] = eff_tables(plan, w, V)[ti]

    cutpoints = core.cutpoints
    oprobit_alpha = core.oprobit_alpha
    n_mh_accept = core.n_mh_accept
    tau = state.tau
    e = core.e
    if cfg.task == TASK_REGRESSION:
        # no residual refresh needed: the last table pass computed the
        # exact post-sweep moments in entity space (φ's last snapshot
        # already reflects every earlier table through the weights)
        sum_e, sum_e2 = moments
    else:
        # probit tasks redraw the latent target per row
        # (FMTrainer.hpp:493-522), which requires the score.  Under
        # SPMD every shard slices its chunk of a globally drawn uniform
        # vector (rows partition contiguously), so the sharded chain
        # reproduces the single-chip chain sample-for-sample; pad rows
        # are masked out of the residual moments (their scores are
        # forced to 0 but the truncated-normal draw is still nonzero).
        valid = _row_validity(plan, cfg, dtype)
        score = score_rows(plan, w0, w, V)
        if cfg.task == TASK_CLASSIFICATION:
            u = _sliced_global_uniform(k_e, plan, cfg, dtype)
            t_draw = truncated_std_normal_onesided(
                k_e, -score, y > 0, u=u
            )
            tau = score + t_draw  # latent z
            e = -t_draw
        elif cfg.task == TASK_ORDERED:
            from .oprobit import oprobit_groups_update

            # k_mh stays COMMON across shards: the MH objective is
            # psum-reduced globally, so every shard takes the identical
            # accept/reject decision on identical proposals
            k_mh, k_z = jax.random.split(k_e)
            u = _sliced_global_uniform(k_z, plan, cfg, dtype)
            oprobit_alpha, cutpoints, n_mh_accept, e = (
                oprobit_groups_update(
                    k_mh, k_z, score, y, core.oprobit_alpha,
                    core.n_mh_accept, cfg.cutpoint_group_classes,
                    cfg.reg_0, float(cfg.nu_oprobit), weight=valid,
                    axis=cfg.axis_name, u=u,
                )
            )
            tau = score - e  # z
        else:  # pragma: no cover
            raise NotImplementedError(cfg.task)
        if valid is not None:
            e = e * valid
            tau = tau * valid
        sum_e = jnp.sum(e)
        sum_e2 = jnp.sum(e * e)
        if cfg.axis_name is not None:
            sum_e = lax.psum(sum_e, cfg.axis_name)
            sum_e2 = lax.psum(sum_e2, cfg.axis_name)

    new_core = GibbsState(
        w0=w0, w=w, V=V, e=e, alpha=alpha,
        mu_w=mu_w, lambda_w=lambda_w, mu_V=mu_V, lambda_V=lambda_V,
        cutpoints=cutpoints, oprobit_alpha=oprobit_alpha,
        n_mh_accept=n_mh_accept,
    )
    return CategoricalState(
        core=new_core, tau=tau, sum_e=sum_e, sum_e2=sum_e2
    )


def init_categorical_state(
    plan: CategoricalPlan, core: GibbsState, y, key, cfg: GibbsConfig
) -> CategoricalState:
    """Initialize e (and the latent tau) from freshly initialized
    weights, matching the reference's initialize_e
    (FMTrainer.hpp:99-119)."""
    score = score_rows(plan, core.w0, core.w, core.V)
    tau = None
    if cfg.task == TASK_ORDERED:
        from .oprobit import initialize_oprobit_core

        valid = _row_validity(plan, cfg, score.dtype)
        u = _sliced_global_uniform(key, plan, cfg, score.dtype)
        core, e = initialize_oprobit_core(
            score, core, y, cfg, key, weight=valid, u=u
        )
        tau = score - e
    else:
        # regression and (±1-coded) classification both start with
        # e = score − y
        e = score - y
        core = dataclasses.replace(core, e=e)
        if cfg.task == TASK_CLASSIFICATION:
            # explicit copy: tau lives in the donated state while y is
            # a regular argument — aliasing them trips buffer donation
            tau = jnp.array(y, dtype=score.dtype, copy=True)
    se = jnp.sum(e)
    se2 = jnp.sum(e * e)
    if cfg.axis_name is not None:
        se = lax.psum(se, cfg.axis_name)
        se2 = lax.psum(se2, cfg.axis_name)
    return CategoricalState(core=core, tau=tau, sum_e=se, sum_e2=se2)


def make_y_tiles(plan: CategoricalPlan, y: jax.Array):
    """Per-table tile-order copies of y (regression; computed once)."""
    return tuple(
        _pad_zero_row(y[:, None])[t.src][:, 0] for t in plan.tables
    )