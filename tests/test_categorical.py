"""Tests for the categorical entity-space fast path.

Layers (mirroring the reference's test strategy, SURVEY §4):
1. Gram unit: the plain path and the Triton kernel (interpret mode)
   == brute-force numpy per-entity Grams, across split/pad patterns;
2. table-pass unit: one `_table_pass` == an independent numpy
   re-implementation of the entity-space update rules, exactly (same
   noise);
3. invariant: after a full sweep, the maintained residual equals the
   recomputed score minus the latent target;
4. parity: identity-blocked ≡ grouped-flattened (both resolve to the
   same table decomposition ⇒ identical chains);
5. end-to-end posterior concentration through the public API.
"""

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp

from myfm_tpu import MyFMGibbsRegressor, RelationBlock
from myfm_tpu.design_categorical import (
    compile_categorical_table,
    try_compile_categorical,
)
from myfm_tpu.ops.categorical import (
    _table_pass,
    categorical_sweep,
    init_categorical_state,
)
from myfm_tpu.ops.gibbs import GibbsConfig, init_state
from myfm_tpu.ops.gram import (
    table_gram,
    tile_grams_kernel,
    tile_grams_reference,
)

from .oracle import expand_blocks


def _gram_problem(rng, N, B, others, rank, n_body=1, dtype=np.float64):
    """Entity maps and [lin | body | qs] source rows of one table pass:
    own table of B entities, other tables of the given sizes."""
    ent = rng.randint(0, B, N)
    ent[ent == 7] = 8  # an entity with zero rows
    ents2 = [rng.randint(0, b, N) for b in others]

    def source(b, nb):
        out = np.zeros((b + 1, 2 + nb * rank), dtype)
        out[:b, :-1] = rng.normal(size=(b, 1 + nb * rank)) * 0.5
        out[:b, -1] = (out[:b, 1 : 1 + rank] ** 2).sum(1) + 0.1
        return out

    return (ent, ents2, source(B, 1), [source(b, n_body) for b in others],
            rng.normal(size=N).astype(dtype))


def _numpy_grams(ent, ents2, own_src, srcs, tau, B, rank):
    """Brute force: per row z = [1 | e | Σ_other body], G_u = Σ z zᵀ
    over the rows of u (rows restricted to [1 | e | φ])."""
    own = own_src[ent].astype(np.float64)
    gs = [s_[e2].astype(np.float64) for s_, e2 in zip(srcs, ents2)]
    Z = sum(g[:, 1:-1] for g in gs)
    lin = own[:, 0] + sum(g[:, 0] for g in gs)
    qs = own[:, -1] + sum(g[:, -1] for g in gs)
    qf = Z[:, :rank] + own[:, 1 : 1 + rank]
    e = lin - tau + 0.5 * ((qf * qf).sum(1) - qs)
    z = np.concatenate([np.ones((len(e), 1)), e[:, None], Z], axis=1)
    G = np.zeros((B, 2 + rank, z.shape[1]))
    for u in range(B):
        zu = z[ent == u]
        G[u] = zu[:, : 2 + rank].T @ zu
    return G


def _table_gram_of(tab, ent2s, own_src, srcs, tau, rank, impl,
                   chunk_tiles):
    N = tab.ent_main.shape[0]
    src = np.asarray(tab.src)
    row = np.minimum(src, N - 1)
    tau_t = np.where(src < N, tau[row], 0.0)
    idx2 = [np.where(src < N, e2[row], s_.shape[0] - 1)
            for e2, s_ in zip(ent2s, srcs)]
    return np.asarray(table_gram(
        jnp.asarray(own_src), tab.ent_of_tile_row,
        [jnp.asarray(s_) for s_ in srcs], [jnp.asarray(i) for i in idx2],
        jnp.asarray(tau_t), tab.slot, tab.seg, tab.ent_slots,
        rank=rank, n_entities=tab.n_cols, tile_rows=tab.tile_rows,
        tile_entities=tab.tile_entities, chunk_tiles=chunk_tiles,
        impl=impl,
    ))


@pytest.mark.parametrize("T,S", [(16, 2), (64, 8), (1024, 8)])
@pytest.mark.parametrize("seed", [0, 3])
def test_entity_grams_vs_numpy(T, S, seed):
    """Both Gram implementations == brute-force numpy per-entity Grams,
    with entities split across tiles and tiles split across chunks."""
    rng = np.random.RandomState(seed)
    N, B, rank = 700, 29, 3
    ent, ents2, own_src, srcs, tau = _gram_problem(
        rng, N, B, (11, 6), rank
    )
    tab = compile_categorical_table(
        ent, B, 0, N, np.float64, fixed_ts=(T, S)
    )
    want = _numpy_grams(ent, ents2, own_src, srcs, tau, B, rank)
    for impl in ("xla", "interpret"):
        for chunk_tiles in (tab.chunk_tiles, 2):
            G = _table_gram_of(tab, ents2, own_src, srcs, tau, rank,
                               impl, chunk_tiles)
            np.testing.assert_allclose(
                G, want, rtol=1e-9, atol=1e-9,
                err_msg=f"impl={impl} chunk_tiles={chunk_tiles}",
            )


@pytest.mark.parametrize("gram_impl", ["xla", "interpret"])
def test_table_pass_matches_numpy_oracle(gram_impl):
    """_table_pass == independent numpy implementation, exactly.

    Two one-hot tables; the oracle reconstructs e from the weights
    (like the pass does), then draws per-coordinate with identical
    conditionals and the same noise."""
    rng = np.random.RandomState(1)
    N, B1, B2, R, G_n = 300, 11, 7, 3, 2
    ent1 = rng.randint(0, B1, N)
    ent2 = rng.randint(0, B2, N)
    X1 = sps.csr_matrix(
        (np.ones(N), (np.arange(N), ent1)), shape=(N, B1)
    )
    X2 = sps.csr_matrix(
        (np.ones(N), (np.arange(N), ent2)), shape=(N, B2)
    )
    grouping = np.asarray([0] * B1 + [1] * B2, np.int32)
    plan = try_compile_categorical(
        sps.hstack([X1, X2]).tocsr(), [], grouping, None, np.float64,
        fixed_ts=(32, 4), rank=R,
    )
    assert plan is not None and len(plan.tables) == 2
    F = B1 + B2

    w = jnp.asarray(rng.normal(size=F))
    V = jnp.asarray(rng.normal(size=(F, R)))
    w0 = 0.4
    tau = rng.normal(size=N)  # latent target
    alpha = 1.7
    lambda_w = jnp.asarray([1.1, 0.7])
    mu_w = jnp.asarray([0.2, -0.1])
    lambda_V = jnp.asarray(rng.random((G_n, R)) + 0.5)
    mu_V = jnp.asarray(rng.normal(size=(G_n, R)) * 0.1)
    noise_w = jnp.asarray(rng.normal(size=F))
    noise_V = jnp.asarray(rng.normal(size=(F, R)))
    cfg = GibbsConfig(task="regression")

    from myfm_tpu.ops.categorical import make_y_tiles

    tau_tiles = make_y_tiles(plan, jnp.asarray(tau))
    w_j, V_j = jnp.asarray(w), jnp.asarray(V)
    for ti in range(2):
        w_j, V_j, moments = _table_pass(
            plan, ti, w_j, V_j, w0, alpha, lambda_w, mu_w, lambda_V,
            mu_V, plan.group_index, noise_w, noise_V, tau_tiles[ti],
            cfg, gram_impl, want_moments=(ti == 1),
        )
    w2, V2 = np.asarray(w_j), np.asarray(V_j)

    # ---- numpy oracle ------------------------------------------------
    w_o = np.asarray(w).copy()
    V_o = np.asarray(V).copy()
    gi = np.asarray(plan.group_index)
    nw = np.asarray(noise_w)
    nV = np.asarray(noise_V)
    lw = np.asarray(lambda_w)[gi]
    mw = np.asarray(mu_w)[gi]
    lV = np.asarray(lambda_V)[gi]
    mV = np.asarray(mu_V)[gi]
    ents = [ent1, ent2 + 0]
    offs = [0, B1]
    for ti in range(2):
        # reconstruct e, Q from current weights
        Q_o = V_o[ents[0]] + V_o[B1 + ents[1]]
        QS_o = V_o[ents[0]] ** 2 + V_o[B1 + ents[1]] ** 2
        score = (
            w0 + w_o[ents[0]] + w_o[B1 + ents[1]]
            + 0.5 * (Q_o**2 - QS_o).sum(axis=1)
        )
        e_o = score - tau
        ent = ents[ti]
        off = offs[ti]
        B = [B1, B2][ti]
        for u in range(B):
            f = off + u
            rows = np.nonzero(ent == u)[0]
            quad = alpha * len(rows) + lw[f]
            lin = (
                alpha * (len(rows) * w_o[f] - e_o[rows].sum())
                + lw[f] * mw[f]
            )
            w_new = lin / quad + nw[f] / np.sqrt(quad)
            e_o[rows] += w_new - w_o[f]
            w_o[f] = w_new
        for r in range(R):
            for u in range(B):
                f = off + u
                rows = np.nonzero(ent == u)[0]
                phi = Q_o[rows, r] - V_o[f, r]
                sq = (phi**2).sum()
                quad = alpha * sq + lV[f, r]
                lin = (
                    alpha * (sq * V_o[f, r] - (e_o[rows] * phi).sum())
                    + lV[f, r] * mV[f, r]
                )
                v_new = lin / quad + nV[f, r] / np.sqrt(quad)
                d = v_new - V_o[f, r]
                e_o[rows] += d * phi
                Q_o[rows, r] += d
                V_o[f, r] = v_new

    np.testing.assert_allclose(w2, w_o, rtol=1e-8)
    np.testing.assert_allclose(V2, V_o, rtol=1e-8)
    # exact residual moments from the Gram algebra vs numpy e
    np.testing.assert_allclose(float(moments[0]), e_o.sum(), rtol=1e-8)
    np.testing.assert_allclose(
        float(moments[1]), (e_o**2).sum(), rtol=1e-8
    )


def _cf_problem(seed=0, n=600, n_users=31, n_items=19, noise=0.3):
    rng = np.random.RandomState(seed)
    u = rng.randint(0, n_users, n)
    i = rng.randint(0, n_items, n)
    y = (
        1.5
        + rng.normal(size=n_users)[u]
        + rng.normal(size=n_items)[i]
        + noise * rng.normal(size=n)
    )
    blocks = [
        RelationBlock(u, sps.identity(n_users, format="csr")),
        RelationBlock(i, sps.identity(n_items, format="csr")),
    ]
    return blocks, y, (n_users, n_items)


def test_sweep_residual_invariant():
    """e after a sweep == recomputed score − y."""
    blocks, y, (n_users, n_items) = _cf_problem()
    plan = try_compile_categorical(
        None, blocks, None, None, np.float64, rank=3
    )
    assert plan is not None
    cfg = GibbsConfig(task="regression")
    key = jax.random.PRNGKey(0)
    core = init_state(plan, 3, 0.1, key, cfg, np.float64)
    yj = jnp.asarray(y)
    state = init_categorical_state(plan, core, yj, key, cfg)
    from myfm_tpu.ops.categorical import make_y_tiles, score_and_q

    y_tiles = make_y_tiles(plan, yj)
    for it in range(3):
        state = categorical_sweep(
            plan, state, yj, y_tiles, jax.random.fold_in(key, it),
            cfg, gram_impl="interpret",
        )
    score, _ = score_and_q(
        plan, state.core.w0, state.core.w, state.core.V
    )
    e_true = np.asarray(score - yj)
    np.testing.assert_allclose(float(state.sum_e), e_true.sum(),
                               rtol=1e-8)
    np.testing.assert_allclose(float(state.sum_e2), (e_true**2).sum(),
                               rtol=1e-8)


def test_blocked_equals_grouped_flattened():
    """Identity-blocked and grouped-flattened inputs resolve to the
    same table decomposition ⇒ identical chains."""
    blocks, y, (n_users, n_items) = _cf_problem(seed=4)
    X_flat = expand_blocks(None, blocks)
    kwargs = dict(rank=2, random_seed=11, dtype=np.float64)
    fm_blocked = MyFMGibbsRegressor(**kwargs).fit(
        None, y, X_rel=blocks, n_iter=8, n_kept_samples=8,
        group_shapes=[n_users, n_items],
    )
    fm_flat = MyFMGibbsRegressor(**kwargs).fit(
        X_flat, y, n_iter=8, n_kept_samples=8,
        group_shapes=[n_users, n_items],
    )
    np.testing.assert_allclose(
        fm_blocked.w_samples, fm_flat.w_samples, rtol=1e-8
    )
    np.testing.assert_allclose(
        fm_blocked.V_samples, fm_flat.V_samples, rtol=1e-8
    )


def test_fast_path_posterior_concentration():
    blocks, y, (n_users, n_items) = _cf_problem(seed=2, n=1500)
    fm = MyFMGibbsRegressor(rank=2, random_seed=42).fit(
        None, y, X_rel=blocks, n_iter=60, n_kept_samples=40,
        group_shapes=[n_users, n_items],
    )
    # noise precision 1/0.3² ≈ 11.1 — late alpha samples in [0.5, 2]×
    alphas = np.asarray(
        [h.alpha for h in fm.history_.hypers[-20:]]
    )
    assert 0.5 * 11.1 < alphas.mean() < 2.0 * 11.1
    pred = fm.predict(None, blocks)
    rmse = float(np.sqrt(np.mean((pred - y) ** 2)))
    assert rmse < 0.45


def test_fast_path_classifier():
    blocks, y_cont, (n_users, n_items) = _cf_problem(seed=6, n=1500)
    y = (y_cont > np.median(y_cont)).astype(np.int64)
    from myfm_tpu import MyFMGibbsClassifier

    fm = MyFMGibbsClassifier(rank=2, random_seed=1).fit(
        None, y, X_rel=blocks, n_iter=40, n_kept_samples=30,
        group_shapes=[n_users, n_items],
    )
    proba = fm.predict_proba(None, blocks)
    acc = float(((proba > 0.5) == (y > 0)).mean())
    assert acc > 0.85


def test_non_categorical_falls_back():
    """Side features disable the fast path; 'categorical' raises."""
    rng = np.random.RandomState(0)
    X = sps.csr_matrix(rng.normal(size=(50, 4)))
    y = rng.normal(size=50)
    assert (
        try_compile_categorical(X, [], None, None, np.float32) is None
    )
    with pytest.raises(ValueError):
        MyFMGibbsRegressor(
            rank=1, sweep_strategy="categorical"
        ).fit(X, y, n_iter=2)


def test_block_with_categorical_side_attributes_fast_path():
    """Blocks shaped [id | one-hot attributes] split into categorical
    tables via composed entity maps (the ml-100k side-info layout)."""
    rng = np.random.RandomState(0)
    n, nu, ni = 900, 37, 23

    def onehot(vals, k):
        return sps.csr_matrix(
            (np.ones(len(vals)), (np.arange(len(vals)), vals)),
            shape=(len(vals), k),
        )

    u, i = rng.randint(0, nu, n), rng.randint(0, ni, n)
    age = rng.randint(0, 5, nu)
    ub = sps.hstack(
        [sps.identity(nu, format="csr"), onehot(age, 5)]
    ).tocsr()
    ib = sps.identity(ni, format="csr")
    blocks = [RelationBlock(u, ub), RelationBlock(i, ib)]
    grouping = np.asarray(
        [0] * nu + [1] * 5 + [2] * ni, np.int32
    )
    plan = try_compile_categorical(
        None, blocks, grouping, None, np.float64, rank=2
    )
    assert plan is not None and len(plan.tables) == 3
    # the attribute table's entity map composes through the mapper
    np.testing.assert_array_equal(
        np.asarray(plan.tables[1].ent_main), age[u]
    )

    true_age = rng.normal(size=5)
    y = (
        rng.normal(size=nu)[u] + true_age[age[u]]
        + rng.normal(size=ni)[i] + 0.3 * rng.normal(size=n)
    )
    fm = MyFMGibbsRegressor(rank=2, random_seed=1).fit(
        None, y, X_rel=blocks, n_iter=50, n_kept_samples=30,
        grouping=list(grouping),
    )
    pred = fm.predict(None, blocks)
    assert float(np.sqrt(np.mean((pred - y) ** 2))) < 0.5


def _chunk_problem(rng, K, T, S, R, n_body, dtype=np.float64):
    """One chunk of tiles: sorted slots with pad rows at each tile's
    end and one empty slot, seg table, and source rows."""
    slot = np.sort(rng.randint(0, S - 1, size=(K, T)), axis=1)
    slot[:, -3:] = S  # pad rows
    slot[slot == 1] = 0  # slot 1 owns no rows
    seg = np.zeros((K, S, 2), np.int32)
    for k in range(K):
        for s_ in range(S):
            r = np.nonzero(slot[k] == s_)[0]
            seg[k, s_] = (r[0] if len(r) else 0, len(r))
    sizes = (9, 7, 5)
    own = np.concatenate(
        [rng.normal(size=(sizes[0], 2 + R)), np.zeros((1, 2 + R))]
    ).astype(dtype)
    srcs = [
        np.concatenate([rng.normal(size=(b, 2 + n_body * R)),
                        np.zeros((1, 2 + n_body * R))]).astype(dtype)
        for b in sizes[1:]
    ]
    valid = slot < S
    own_idx = np.where(valid, rng.randint(0, sizes[0], (K, T)), sizes[0])
    idx = [np.where(valid, rng.randint(0, b, (K, T)), b)
           for b in sizes[1:]]
    tau = (rng.normal(size=(K, T)) * valid).astype(dtype)
    return [jnp.asarray(a) for a in (own, own_idx)], \
        [jnp.asarray(a) for a in srcs], [jnp.asarray(a) for a in idx], \
        jnp.asarray(tau), jnp.asarray(slot.astype(np.int32)), \
        jnp.asarray(seg)


def test_fused_gram_extra_columns_vs_oracle():
    """Extra z-columns (the CAVI [φ | σ | τ] layout, three body blocks)
    ride the same Gram: kernel == plain path, and the leading
    [1|e|φ] block equals the one-block Gram of the same rows."""
    rng = np.random.RandomState(7)
    K, T, S, R = 3, 32, 4, 3
    (own, oidx), srcs, idx, tau, slot, seg = _chunk_problem(
        rng, K, T, S, R, n_body=3
    )
    ref = tile_grams_reference(own, oidx, srcs, idx, tau, slot, S, R)
    got = tile_grams_kernel(own, oidx, srcs, idx, tau, seg, S, R,
                            interpret=True)
    assert ref.shape == (K, S, 2 + R, 2 + 3 * R)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-10, atol=1e-10)
    base = tile_grams_reference(
        own, oidx, [s_[:, list(range(1 + R)) + [-1]] for s_ in srcs],
        idx, tau, slot, S, R,
    )
    np.testing.assert_allclose(
        np.asarray(ref)[..., : 2 + R], np.asarray(base), rtol=1e-12
    )


def test_fused_gram_cross_vs_separate_meta():
    """The kernel (gathers and z built per row segment) and the plain
    path (gathers, z, then one slot-masked einsum) agree on every
    (tile, slot) partial, pad rows and row-less slots included."""
    rng = np.random.RandomState(11)
    K, T, S, R = 3, 64, 4, 5
    (own, oidx), srcs, idx, tau, slot, seg = _chunk_problem(
        rng, K, T, S, R, n_body=1
    )
    ref = np.asarray(
        tile_grams_reference(own, oidx, srcs, idx, tau, slot, S, R)
    )
    got = np.asarray(
        tile_grams_kernel(own, oidx, srcs, idx, tau, seg, S, R,
                          interpret=True)
    )
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)
    assert np.all(ref[:, 1] == 0)  # slot 1 owns no rows
    # card = rows per (tile, slot)
    np.testing.assert_array_equal(ref[:, :, 0, 0], np.asarray(seg)[..., 1])


def test_tiling_rule_dense_and_scattered_tables():
    """Dense tables (rows per entity >> T) get one entity per tile and
    the largest tiles; scattered tables (one row per entity) pack many
    entities per tile; the returned inflation is the exact packing."""
    from myfm_tpu.design_categorical import _packed_rows, choose_tiling

    counts = np.full(2_000, 930, dtype=np.int64)  # items-like
    T, S, infl = choose_tiling(counts, 32)
    assert S == 1 and T >= 256, (T, S)
    assert infl <= 1.3

    counts1 = np.ones(20_000, dtype=np.int64)
    T1, S1, infl1 = choose_tiling(counts1, 32)
    assert S1 >= 16, (T1, S1)
    assert infl1 == _packed_rows(counts1, T1, S1) / 20_000


@pytest.mark.parametrize("rank", [8, 32, 96, 128])
def test_tiling_rule_gives_kernel_shapes(rank):
    """Every tiling the rule picks is one the kernel takes: T a power of
    two and a multiple of its row block, S a power of two; heavier
    Grams never get more entities per tile."""
    from myfm_tpu.design_categorical import choose_tiling
    from myfm_tpu.ops.gram import KERNEL_ROWS

    rng = np.random.RandomState(rank)
    counts = (rng.pareto(1.2, 3_000) * 40 + 1).astype(np.int64)
    T, S, infl = choose_tiling(counts, rank)
    assert T & (T - 1) == 0 and T % KERNEL_ROWS == 0, T
    assert S & (S - 1) == 0, S
    assert infl >= 1.0
    _, S_small, _ = choose_tiling(counts, 4)
    assert S <= S_small


def test_gram_path_runs_at_float32_precision():
    """Every contraction of the Gram path asks for HIGHEST precision
    (on the GPU the default runs float32 products in TF32, ~1e-3
    relative), and a float32 Gram of full-mantissa data stays within
    float32 accumulation error of the float64 result."""
    rng = np.random.RandomState(2)
    K, T, S, R = 2, 64, 2, 16
    (own, oidx), srcs, idx, tau, slot, seg = _chunk_problem(
        rng, K, T, S, R, n_body=1, dtype=np.float32
    )
    jaxpr = jax.make_jaxpr(
        lambda *a: tile_grams_reference(*a, S, R)
    )(own, oidx, srcs, idx, tau, slot)
    dots = [
        e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"
    ]
    assert dots
    for e in dots:
        prec = e.params["precision"]
        assert prec == (jax.lax.Precision.HIGHEST,) * 2, prec
    got = np.asarray(
        tile_grams_reference(own, oidx, srcs, idx, tau, slot, S, R)
    )
    with jax.enable_x64(True):
        ref = np.asarray(tile_grams_reference(
            own.astype(jnp.float64), oidx,
            [s_.astype(jnp.float64) for s_ in srcs], idx,
            tau.astype(jnp.float64), slot, S, R,
        ))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    kern = np.asarray(tile_grams_kernel(own, oidx, srcs, idx, tau, seg,
                                        S, R, interpret=True))
    assert np.abs(kern - ref).max() <= 1e-5 * np.abs(ref).max()


def test_gram_impl_choice():
    """The CPU gets the plain path; the GPU gets the compiled kernel or
    the plain path and never interpret mode; any other platform, and
    any unknown implementation name, is an error."""
    from myfm_tpu.ops.gram import choose_impl

    assert choose_impl(np.float32, 32, platform="cpu") == "xla"
    assert choose_impl(np.float64, 32, platform="cpu") == "xla"
    assert choose_impl(np.float32, 32, platform="gpu") == "triton"
    assert choose_impl(np.float32, 32, 4, platform="gpu") == "triton"
    assert choose_impl(np.float64, 32, platform="gpu") == "xla"
    assert choose_impl(np.float32, 128, 3, platform="gpu") == "xla"
    for rank in (1, 3, 10, 32, 64, 100, 128, 256):
        for nb in (1, 3, 4):
            for dt in (np.float32, np.float64):
                assert choose_impl(dt, rank, nb, platform="gpu") in (
                    "triton", "xla"
                )
    assert choose_impl(np.float32, 8) == "xla"  # this test host: CPU
    from myfm_tpu.ops.gram import platform_of

    assert platform_of(jnp.zeros(3)) == "cpu"
    with pytest.raises(ValueError, match="platform"):
        choose_impl(np.float32, 32, platform="rocm")
    tab = compile_categorical_table(
        np.arange(40) % 5, 5, 0, 40, np.float32, fixed_ts=(16, 2)
    )
    with pytest.raises(ValueError, match="unknown Gram"):
        table_gram(
            jnp.zeros((6, 4)), tab.ent_of_tile_row, [], [],
            jnp.zeros(tab.slot.shape), tab.slot, tab.seg, tab.ent_slots,
            rank=2, n_entities=5, tile_rows=16, tile_entities=2,
            chunk_tiles=1, impl="mosaic",
        )


@pytest.mark.parametrize("T,S", [(16, 2), (64, 8), (256, 4)])
@pytest.mark.parametrize("seed,masked", [(0, False), (5, True)])
def test_device_derived_src_slot_matches_host_pack(T, S, seed, masked):
    """The single-jit on-device src/slot derivation (TTFS path:
    _plan_tiles + _derive_src_slot_device) must reproduce the host
    packing bit-for-bit, including SPMD pad rows and row-less
    entities."""
    rng = np.random.RandomState(seed)
    N, B = 650, 23
    ent = rng.randint(0, B, N)
    ent[ent == 5] = 6  # entity with zero rows
    if masked:
        ent[rng.rand(N) < 0.1] = B  # SPMD pad rows
    host = compile_categorical_table(
        ent, B, 0, N, np.float32, fixed_ts=(T, S),
        derive_src_on_device=False,
    )
    dev = compile_categorical_table(
        ent, B, 0, N, np.float32, fixed_ts=(T, S),
        derive_src_on_device=True,
    )
    for field in ("src", "slot", "ent_of_tile_row", "ent_slots", "seg"):
        np.testing.assert_array_equal(
            np.asarray(getattr(host, field)),
            np.asarray(getattr(dev, field)),
            err_msg=field,
        )

    # the SPMD shape-padding path (fixed tiling + padded tile count)
    host_p = compile_categorical_table(
        ent, B, 0, N, np.float32, fixed_ts=(T, S),
        pad_tiles_to=host.n_tiles + 3,
        derive_src_on_device=False,
    )
    dev_p = compile_categorical_table(
        ent, B, 0, N, np.float32, fixed_ts=(T, S),
        pad_tiles_to=host.n_tiles + 3,
        derive_src_on_device=True,
    )
    for field in ("src", "slot", "ent_of_tile_row", "ent_slots", "seg"):
        np.testing.assert_array_equal(
            np.asarray(getattr(host_p, field)),
            np.asarray(getattr(dev_p, field)),
            err_msg=f"padded {field}",
        )


@pytest.mark.gpu
def test_triton_gram_compiled_matches_plain(gpu_device):
    """On the card the compiled kernel (no interpret mode) matches the
    plain path at float32, one and three body blocks."""
    from myfm_tpu.ops.gram import choose_impl

    assert choose_impl(np.float32, 32) == "triton"
    for n_body, R in ((1, 32), (3, 16)):
        rng = np.random.RandomState(n_body)
        (own, oidx), srcs, idx, tau, slot, seg = _chunk_problem(
            rng, 6, 128, 4, R, n_body=n_body, dtype=np.float32
        )
        ref = np.asarray(jax.jit(
            tile_grams_reference, static_argnums=(6, 7)
        )(own, oidx, srcs, idx, tau, slot, 4, R))
        got = np.asarray(jax.jit(
            tile_grams_kernel, static_argnums=(6, 7)
        )(own, oidx, srcs, idx, tau, seg, 4, R))
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.gpu
def test_gpu_trainer_sweep_runs_compiled_kernel(gpu_device):
    """A float32 fit on the card picks the Triton Gram, and the compiled
    sweep contains the kernel."""
    from myfm_tpu.trainer import CategoricalGibbsTrainer

    blocks, y, _ = _cf_problem(seed=3, n=3000)
    plan = try_compile_categorical(
        None, blocks, None, None, np.float32, rank=8
    )
    tr = CategoricalGibbsTrainer(
        plan, y, GibbsConfig(task="regression"), 8, 0.1, 1, np.float32
    )
    assert tr._gram_impl == "triton"
    key = jax.random.PRNGKey(0)
    state = tr._initialize(key)
    hlo = tr._sweep.lower(
        tr.plan, state, tr.y, tr.y_tiles, key, tr.cfg, tr._gram_impl
    ).compile().as_text()
    assert "fastpath_tile_gram" in hlo
    for it in range(2):
        state = tr._sweep_call(state, jax.random.fold_in(key, it))
    assert np.isfinite(np.asarray(state.core.V)).all()


@pytest.mark.parametrize("T,S", [(16, 2), (64, 8), (32, 1)])
def test_native_pack_tiles_matches_numpy(T, S):
    """The C++ tile packer (host path of the design compile) returns the
    numpy packer's (src, slot, ent, ent_slots), pads included."""
    from myfm_tpu._native import pack_tiles_native
    from myfm_tpu.design_categorical import _pack_tiles

    if pack_tiles_native is None:
        pytest.skip("no C++ compiler for the native planner")
    rng = np.random.RandomState(T + S)
    N, B = 650, 23
    ent = rng.randint(0, B, N)
    ent[ent == 5] = 6  # entity with zero rows
    order = np.argsort(ent, kind="stable")
    counts = np.bincount(ent, minlength=B)
    got = pack_tiles_native(order, counts, N, T, S)
    want = _pack_tiles(ent[order], order, B, T, S)
    for name, g, w in zip(("src", "slot", "ent", "ent_slots"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
