"""Entity-space serving fast path (ops/forward_categorical) vs the
numpy oracle and the row-space predictor path.

Reference contract: Predictor averages the posterior predictive over
kept samples (predictor.hpp:126-147), probit-squashed per sample for
classification, per-class interval probabilities for ordered probit
(FM.hpp:137-162)."""

import numpy as np
import pytest
import scipy.sparse as sps

from myfm_tpu import RelationBlock
from myfm_tpu.containers import FM
from myfm_tpu.ops.forward_categorical import (
    compile_categorical_inference,
    scores_samples_reduce,
    stack_sources,
)
from myfm_tpu.predictor import Predictor, _LiveKey

from .oracle import FMWeights, expand_blocks, fm_oracle_score


def _categorical_design(rng, n=200, n_users=13, n_items=7, n_days=5):
    users = rng.randint(0, n_users, n)
    items = rng.randint(0, n_items, n)
    days = rng.randint(0, n_days, n)
    X = sps.csr_matrix(
        (np.ones(n), (np.arange(n), days)), shape=(n, n_days)
    )
    blocks = [
        RelationBlock(users, sps.identity(n_users, format="csr")),
        RelationBlock(items, sps.identity(n_items, format="csr")),
    ]
    return X, blocks


def _ea_design(rng, n=150, n_users=11, n_items=6, n_genre=4):
    """User block = [user one-hot | dense side columns] — an
    entity+attribute block; item block plain one-hot."""
    users = rng.randint(0, n_users, n)
    items = rng.randint(0, n_items, n)
    side = (rng.rand(n_users, n_genre) < 0.5).astype(np.float64) * (
        0.5 + rng.rand(n_users, n_genre)
    )
    user_table = sps.hstack(
        [sps.identity(n_users, format="csr"), sps.csr_matrix(side)]
    ).tocsr()
    blocks = [
        RelationBlock(users, user_table),
        RelationBlock(items, sps.identity(n_items, format="csr")),
    ]
    return None, blocks


def _samples(rng, F, rank, S):
    out = []
    for _ in range(S):
        out.append(
            FMWeights(
                w0=float(rng.randn()),
                w=rng.randn(F) * 0.3,
                V=rng.randn(F, rank) * 0.3,
            )
        )
    return out


@pytest.mark.parametrize("design", ["categorical", "ea"])
@pytest.mark.parametrize("rank", [0, 3])
def test_scores_samples_match_oracle(design, rank):
    rng = np.random.RandomState(0)
    X, blocks = (
        _categorical_design(rng)
        if design == "categorical"
        else _ea_design(rng)
    )
    plan = compile_categorical_inference(X, blocks, np.float64)
    assert plan is not None
    F = plan.n_features
    S = 3
    samples = _samples(rng, F, rank, S)
    w0s = np.array([s.w0 for s in samples])
    ws = np.stack([s.w for s in samples])
    Vs = np.stack([s.V for s in samples])
    got = np.asarray(
        scores_samples_reduce(
            plan, w0s, ws, Vs, mode="sum", row_chunk=64
        )
    )
    Xd = expand_blocks(X, blocks)
    want = sum(fm_oracle_score(Xd, s) for s in samples)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_ea_onehot_run_peeling():
    """The EA user block must split into a one-hot table + a dense side
    table (not one giant side matrix)."""
    rng = np.random.RandomState(1)
    X, blocks = _ea_design(rng)
    plan = compile_categorical_inference(X, blocks, np.float64)
    kinds = [(t.xs is None, t.n_cols) for t in plan.tables]
    # user one-hot (11 entities), user side (11 entities), item one-hot
    assert (True, 11) in kinds and (False, 11) in kinds
    assert (True, 6) in kinds


def test_predictor_uses_fast_path_and_matches_slow():
    rng = np.random.RandomState(2)
    X, blocks = _categorical_design(rng)
    plan = compile_categorical_inference(X, blocks, np.float64)
    F = plan.n_features
    pred = Predictor(rank=3, n_features=F, task="regression",
                     dtype=np.float64)
    for s in _samples(rng, F, 3, 4):
        pred.samples.append(FM(s.w0, s.w, s.V, []))
    fast = pred.predict(X, blocks)
    assert pred._fast_plan_cache[1] is not None  # fast path taken
    # force the row-space path by disabling the fast compile
    pred2 = Predictor(rank=3, n_features=F, task="regression",
                      dtype=np.float64)
    pred2.samples = pred.samples
    pred2._fast_plan_cache = (_LiveKey((X,) + tuple(blocks)), None)
    slow = pred2.predict(X, blocks)
    np.testing.assert_allclose(fast, slow, rtol=1e-9, atol=1e-9)


def test_plan_cache_rejects_recycled_id():
    """A freed design followed by a new object at the same address must
    MISS the plan cache (round-4 VERDICT weak 6: id()-keyed caches can
    silently serve a stale plan after GC id reuse)."""
    rng = np.random.RandomState(11)
    X, blocks = _categorical_design(rng)
    key = _LiveKey((X,) + tuple(blocks))
    assert key.matches((X,) + tuple(blocks))

    X2, blocks2 = _categorical_design(np.random.RandomState(12))
    # different live object → id mismatch → miss
    assert not key.matches((X2,) + tuple(blocks2))

    # simulate id recycling: kill the original, then point the key's
    # stored ids/fingerprints at the new object as if the allocator
    # reused the address — the dead weakref must still force a miss
    del X, blocks
    import gc

    gc.collect()
    key._ids = (id(X2),) + tuple(id(b) for b in blocks2)
    key._prints = tuple(
        key._fingerprint(o) for o in (X2,) + tuple(blocks2)
    )
    assert not key.matches((X2,) + tuple(blocks2))


def test_sample_stack_cache_invalidates_on_new_samples():
    """Appending or replacing kept samples must re-stage the stacked
    device weights (predictor.hpp:126-147 averages over exactly the
    current sample set)."""
    rng = np.random.RandomState(13)
    X, blocks = _categorical_design(rng)
    plan = compile_categorical_inference(X, blocks, np.float64)
    F = plan.n_features
    pred = Predictor(rank=2, n_features=F, task="regression",
                     dtype=np.float64)
    for s in _samples(rng, F, 2, 3):
        pred.samples.append(FM(s.w0, s.w, s.V, []))
    out1 = pred.predict(X, blocks)
    # replace one sample with a different-content FM (same shapes)
    s_new = _samples(np.random.RandomState(14), F, 2, 1)[0]
    pred.samples[0] = FM(s_new.w0, s_new.w, s_new.V, [])
    out2 = pred.predict(X, blocks)
    X_full = expand_blocks(X, blocks)
    oracle = np.mean(
        [
            fm_oracle_score(X_full, FMWeights(s.w0, s.w, s.V))
            for s in pred.samples
        ],
        axis=0,
    )
    assert not np.allclose(out1, out2)
    np.testing.assert_allclose(out2, oracle, rtol=1e-6, atol=1e-6)


def test_predictor_classification_squash():
    rng = np.random.RandomState(3)
    X, blocks = _categorical_design(rng)
    plan = compile_categorical_inference(X, blocks, np.float64)
    F = plan.n_features
    pred = Predictor(rank=2, n_features=F, task="classification",
                     dtype=np.float64)
    samples = _samples(rng, F, 2, 3)
    for s in samples:
        pred.samples.append(FM(s.w0, s.w, s.V, []))
    got = pred.predict(X, blocks)
    Xd = expand_blocks(X, blocks)
    from scipy.special import ndtr

    want = np.mean(
        [ndtr(fm_oracle_score(Xd, s)) for s in samples], axis=0
    )
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_predictor_oprobit_probs():
    rng = np.random.RandomState(4)
    X, blocks = _categorical_design(rng)
    plan = compile_categorical_inference(X, blocks, np.float64)
    F = plan.n_features
    K = 4
    pred = Predictor(rank=2, n_features=F, task="ordered",
                     dtype=np.float64)
    samples = _samples(rng, F, 2, 3)
    cps = []
    for s in samples:
        c = np.sort(rng.randn(K - 1))
        cps.append(c)
        pred.samples.append(FM(s.w0, s.w, s.V, [c]))
    got = pred.predict_parallel_oprobit(X, blocks)
    from scipy.special import ndtr

    Xd = expand_blocks(X, blocks)
    want = np.zeros((Xd.shape[0], K))
    for s, c in zip(samples, cps):
        sc = fm_oracle_score(Xd, s)
        cdf = ndtr(c[None, :] - sc[:, None])
        lower = np.concatenate([np.zeros_like(cdf[:, :1]), cdf], axis=1)
        upper = np.concatenate([cdf, np.ones_like(cdf[:, :1])], axis=1)
        want += upper - lower
    want /= len(samples)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert np.allclose(got.sum(axis=1), 1.0)


def test_serving_row_chunk_bounds_working_set():
    """The scoring working set is [row_chunk, S*R]; with many kept
    samples the chunk must shrink (a 295-sample predict at the fixed
    2^19 chunk compiled a 30 GB program — 2026-08-20 regression)."""
    from myfm_tpu.ops.forward_categorical import (
        _ROW_CHUNK,
        serving_row_chunk,
    )

    assert serving_row_chunk(8, 32) <= _ROW_CHUNK
    rc = serving_row_chunk(295, 10)
    assert rc * 295 * 10 <= (1 << 25)
    assert rc >= 512
    # monotone non-increasing in S*R
    prev = 1 << 30
    for s in (1, 8, 64, 295, 1000):
        cur = serving_row_chunk(s, 16)
        assert cur <= prev
        prev = cur


def test_predict_many_samples_matches_oracle():
    """End-to-end predict with a large kept-sample count exercises the
    adaptive row chunk through the real Predictor path."""
    rng = np.random.RandomState(8)
    X, blocks = _categorical_design(rng, n=300)
    plan = compile_categorical_inference(X, blocks, np.float64)
    F = plan.n_features
    pred = Predictor(rank=2, n_features=F, task="regression",
                     dtype=np.float64)
    samples = _samples(rng, F, 2, 40)
    for s in samples:
        pred.samples.append(FM(s.w0, s.w, s.V, []))
    got = pred.predict(X, blocks)
    Xd = expand_blocks(X, blocks)
    want = np.mean([fm_oracle_score(Xd, s) for s in samples], axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_stack_sources_shapes():
    rng = np.random.RandomState(6)
    X, blocks = _categorical_design(rng)
    plan = compile_categorical_inference(X, blocks, np.float32)
    S, R = 2, 3
    ws = rng.randn(S, plan.n_features).astype(np.float32)
    Vs = rng.randn(S, plan.n_features, R).astype(np.float32)
    for (sv, swq), t in zip(stack_sources(plan, ws, Vs), plan.tables):
        assert sv.shape == (t.n_cols + 1, S * R)
        assert swq.shape == (t.n_cols + 1, 2 * S)
        assert np.all(np.asarray(sv[-1]) == 0)
