"""Entity-space posterior-predictive scoring (the serving fast path).

The reference makes parallel inference a first-class feature
(/root/reference/include/myfm/predictor.hpp:35-124: a std::thread pool
averaging FM scores over kept samples).  The device equivalent
batches the SAMPLE axis into the minor dimension: for a categorical /
entity+attribute design, each table's per-entity weight rows for all S
kept samples are stacked into one gather source, so scoring S samples
costs ONE row-gather per table per row chunk instead of S — and all
arithmetic is wide elementwise work on contiguous rows.

Layout (per table, S samples, rank R):

    src_v  [B+1, S*R]   factor rows, sample-major (pad row zero)
    src_wq [B+1, 2*S]   [w_s | qs_s] where qs_s = sum_r V_sr^2
                        (for entity+attribute tables: the per-entity
                        effective rows w~, V~, and the TRUE
                        sum_i x^2 V^2, so the same identity applies)

Per row chunk the gathers produce [n, S*R] and [n, 2S]; the squared
factor sums reduce per sample with one fused reshape-sum, giving

    score[n, s] = w0_s + lin[n, s] + 1/2 (sum_r Q^2 - qs)[n, s]

— the q-cache identity of FM.hpp:89-135, vectorized over samples.
The posterior average (probit-squashed per sample for
classification, per-class interval probabilities for ordered probit —
predictor.hpp:126-147, FM.hpp:137-162) reduces on device; only the
[N]-sized (or [N, K]) result ever reaches the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import sparse as sps

import jax
import jax.numpy as jnp
from jax import lax


@dataclasses.dataclass(frozen=True)
class InferenceTable:
    """One categorical (or entity+attribute) table of an inference
    design: just the per-row entity map plus, for EA tables, the dense
    per-entity side matrix — no tile packing (that machinery exists for
    the Gibbs sweep's Gram builds, not for scoring)."""

    ent: jax.Array  # [N] int32 — entity id per row (pad = n_cols)
    col_offset: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    xs: Optional[jax.Array] = None  # [B, Fs] dense side matrix
    feat_cols: Optional[jax.Array] = None  # [Fs] global feature ids


jax.tree_util.register_dataclass(
    InferenceTable,
    data_fields=["ent", "xs", "feat_cols"],
    meta_fields=["col_offset", "n_cols"],
)


@dataclasses.dataclass(frozen=True)
class InferencePlan:
    tables: Tuple[InferenceTable, ...]
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_features: int = dataclasses.field(metadata=dict(static=True))


jax.tree_util.register_dataclass(
    InferencePlan,
    data_fields=["tables"],
    meta_fields=["n_rows", "n_features"],
)


def compile_categorical_inference(
    X: Optional[sps.spmatrix],
    blocks: Sequence,
    dtype,
) -> Optional[InferencePlan]:
    """Inference plan for a categorical / entity+attribute design, or
    None when any table fails the gates (caller falls back to the
    row-space COO path).  Unlike the training compile this needs no
    grouping — side columns of a block are whatever is left after its
    one-hot column runs are peeled off."""
    from ..design_categorical import (
        SIDE_DENSE_ELEMS,
        _upload_ids,
        categorical_mapping,
    )

    dtype = np.dtype(dtype)
    if X is None:
        if not blocks:
            return None
        n_rows = blocks[0].mapper_size
        X = sps.csr_matrix((n_rows, 0), dtype=dtype)
    X = sps.csr_matrix(X)
    n_rows = X.shape[0]
    n_features = X.shape[1] + sum(b.feature_size for b in blocks)

    tables: List[InferenceTable] = []

    def add_onehot(ent, B, off):
        tables.append(
            InferenceTable(
                ent=_upload_ids(ent.astype(np.int64), B),
                col_offset=off,
                n_cols=B,
            )
        )

    if X.shape[1] > 0:
        ent = categorical_mapping(X)
        if ent is None:
            return None
        add_onehot(ent, X.shape[1], 0)

    offset = X.shape[1]
    for b in blocks:
        bx = sps.csr_matrix(b.data)
        mapper = np.asarray(b.original_to_block, dtype=np.int64)
        ent = categorical_mapping(bx, mapper)
        if ent is not None:
            add_onehot(ent, b.feature_size, offset)
            offset += b.feature_size
            continue
        # entity+attribute block: peel maximal one-hot column runs
        # (each block row has exactly one hit with value 1.0 inside the
        # run) into their own tables; everything left is a dense side
        # matrix over the block rows
        bc = bx.tocsc()
        Fs_all = b.feature_size
        nnz_col = np.diff(bc.indptr)
        onehot_runs: List[Tuple[int, int]] = []
        side_cols: List[int] = []
        lo = 0
        while lo < Fs_all:
            hi = lo
            # grow a candidate run of 0/1 columns
            while hi < Fs_all:
                d = bc.data[bc.indptr[hi] : bc.indptr[hi + 1]]
                if d.size and not (d == 1.0).all():
                    break
                hi += 1
            run_found = False
            if hi > lo:
                sub = bc[:, lo:hi].tocsr()
                if (np.diff(sub.indptr) == 1).all():
                    onehot_runs.append((lo, hi))
                    run_found = True
            if run_found:
                lo = hi
            else:
                side_cols.append(lo)
                lo += 1
        for rlo, rhi in onehot_runs:
            ent = categorical_mapping(bc[:, rlo:rhi].tocsr(), mapper)
            if ent is None:  # pragma: no cover — run check above
                side_cols.extend(range(rlo, rhi))
                continue
            add_onehot(ent, rhi - rlo, offset + rlo)
        if side_cols:
            B = b.block_size
            if B * len(side_cols) > SIDE_DENSE_ELEMS:
                return None
            cols = np.asarray(side_cols, dtype=np.int64)
            Xs = bc[:, cols].toarray().astype(dtype)
            tables.append(
                InferenceTable(
                    ent=_upload_ids(mapper, B),
                    col_offset=offset + int(cols[0]),
                    n_cols=B,
                    xs=jnp.asarray(Xs),
                    feat_cols=_upload_ids(offset + cols, n_features),
                )
            )
        offset += Fs_all
    if not tables:
        return None
    return InferencePlan(
        tables=tuple(tables), n_rows=n_rows, n_features=n_features
    )


def _pad_zero_row(arr: jax.Array) -> jax.Array:
    return jnp.concatenate(
        [arr, jnp.zeros((1,) + arr.shape[1:], arr.dtype)], axis=0
    )


def stack_sources(plan: InferencePlan, ws: jax.Array, Vs: jax.Array):
    """Per-table stacked gather sources for S samples.

    Returns a list of (src_v [B+1, S*R], src_wq [B+1, 2*S]); the pad
    row (entity id == B) is all zero, so masked rows contribute
    nothing."""
    S, F, R = Vs.shape
    out = []
    for t in plan.tables:
        if t.xs is None:
            off, B = t.col_offset, t.n_cols
            V_t = Vs[:, off : off + B, :]  # [S, B, R]
            w_t = ws[:, off : off + B]  # [S, B]
            qs_t = jnp.sum(V_t * V_t, axis=2)  # [S, B]
        else:
            xs = t.xs  # [B, Fs]
            w_s = ws[:, t.feat_cols]  # [S, Fs]
            V_s = Vs[:, t.feat_cols, :]  # [S, Fs, R]
            hi = lax.Precision.HIGHEST
            w_t = jnp.einsum("bf,sf->sb", xs, w_s, precision=hi)
            V_t = jnp.einsum("bf,sfr->sbr", xs, V_s, precision=hi)
            # true per-entity sum_i x^2 V^2 (NOT V~^2): with it the
            # q-cache identity holds verbatim for multi-hot rows
            qs_t = jnp.einsum(
                "bf,sf->sb", xs * xs, jnp.sum(V_s * V_s, axis=2),
                precision=hi,
            )
        B = t.n_cols
        src_v = jnp.transpose(V_t, (1, 0, 2)).reshape(B, S * R)
        src_wq = jnp.concatenate([w_t.T, qs_t.T], axis=1)  # [B, 2S]
        out.append((_pad_zero_row(src_v), _pad_zero_row(src_wq)))
    return out


def _chunk_scores(plan, sources, w0s, idxs, n_samples, rank):
    """Scores [n, S] for one chunk of rows (idxs: per-table entity ids,
    pad id == n_cols -> zero rows)."""
    S = n_samples
    n = idxs[0].shape[0]
    dtype = sources[0][0].dtype
    accQ = jnp.zeros((n, S * rank), dtype)
    lin = jnp.zeros((n, S), dtype)
    qs = jnp.zeros((n, S), dtype)
    for (src_v, src_wq), idx in zip(sources, idxs):
        gv = src_v[idx]  # [n, S*R]
        gwq = src_wq[idx]  # [n, 2S]
        accQ = accQ + gv
        lin = lin + gwq[:, :S]
        qs = qs + gwq[:, S:]
    ones = (idxs[0] < plan.tables[0].n_cols).astype(dtype)
    q2 = jnp.sum((accQ * accQ).reshape(n, S, rank), axis=2)
    return ones[:, None] * w0s[None, :] + lin + 0.5 * (q2 - qs)


_ROW_CHUNK = 1 << 19


def serving_row_chunk(
    n_samples: int, rank: int, budget_elems: int = 1 << 25
) -> int:
    """Row-chunk size bounding the scoring pass's working set: the
    accQ accumulator and the per-table gather outputs are
    [row_chunk, S*R]-shaped, so row_chunk must shrink as S*R grows
    (a Predictor with 295 kept samples at the default 2^19 chunk
    compiled a 30 GB program — observed 2026-08-20)."""
    per_row = max(n_samples * max(rank, 1), 1)
    rc = max(budget_elems // per_row, 512)
    return min(_ROW_CHUNK, 1 << (rc.bit_length() - 1))


def scores_samples_reduce(
    plan: InferencePlan,
    w0s: jax.Array,  # [S]
    ws: jax.Array,  # [S, F]
    Vs: jax.Array,  # [S, F, R]
    mode: str = "sum",  # "sum" | "probit_sum" | "oprobit_sum"
    cutpoints: Optional[jax.Array] = None,  # [S, K-1] for oprobit
    row_chunk: int = _ROW_CHUNK,
):
    """Device-reduced posterior-predictive sums over S samples.

    mode "sum":        sum_s score_s            -> [N]
    mode "probit_sum": sum_s Phi(score_s)       -> [N]
    mode "oprobit_sum": sum_s P(class | score_s, gamma_s) -> [N, K]
    (callers divide by the total sample count; summing keeps chunked
    sample batches exact)."""
    N = plan.n_rows
    S, F, R = Vs.shape
    sources = stack_sources(plan, ws, Vs)
    nb = -(-N // row_chunk)
    Np = nb * row_chunk

    def pad_map(t):
        m = t.ent
        if Np != N:
            m = jnp.concatenate(
                [m, jnp.full((Np - N,), t.n_cols, m.dtype)]
            )
        return m.reshape(nb, row_chunk)

    maps = tuple(pad_map(t) for t in plan.tables)

    def block(ms):
        sc = _chunk_scores(plan, sources, w0s, list(ms), S, R)
        if mode == "sum":
            return jnp.sum(sc, axis=1)
        if mode == "probit_sum":
            return jnp.sum(_std_cdf(sc), axis=1)
        if mode == "oprobit_sum":
            cdf = _std_cdf(
                cutpoints[None, :, :] - sc[:, :, None]
            )  # [n, S, K-1]
            lower = jnp.concatenate(
                [jnp.zeros_like(cdf[:, :, :1]), cdf], axis=2
            )
            upper = jnp.concatenate(
                [cdf, jnp.ones_like(cdf[:, :, :1])], axis=2
            )
            return jnp.sum(upper - lower, axis=1)  # [n, K]
        raise ValueError(mode)  # pragma: no cover

    if nb == 1:
        out = block(tuple(m[0] for m in maps))
    else:
        out = lax.map(block, maps)
        out = out.reshape((Np,) + out.shape[2:])
    return out[:N]


def _std_cdf(x):
    return 0.5 * (1.0 + jax.scipy.special.erf(x * np.sqrt(0.5)))


def scores_samples_reduce_sharded(
    plan: InferencePlan,
    w0s: jax.Array,
    ws: jax.Array,
    Vs: jax.Array,
    mesh,
    mode: str = "sum",
    cutpoints: Optional[jax.Array] = None,
    row_chunk: int = _ROW_CHUNK,
):
    """Multi-chip posterior-predictive scoring: rows shard over the
    mesh's ``('data',)`` axis, the sample-stacked gather sources are
    replicated, and each device runs the single-chip scoring pass on
    its row shard (no cross-device communication — scoring is
    row-independent, exactly like the reference's thread pool over
    samples, predictor.hpp:35-124, transposed to rows).

    Returns the same [N] / [N, K] sums as scores_samples_reduce up to
    float reassociation (the per-chunk accumulation order differs)."""
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_dev = int(mesh.devices.size)
    N = plan.n_rows
    local_N = -(-N // n_dev)
    Np = local_N * n_dev

    ents = []
    for t in plan.tables:
        m = t.ent
        if Np != N:
            m = jnp.concatenate(
                [m, jnp.full((Np - N,), t.n_cols, m.dtype)]
            )
        ents.append(m)
    ents = tuple(
        jax.device_put(m, NamedSharding(mesh, P("data")))
        for m in ents
    )
    aux = tuple((t.xs, t.feat_cols) for t in plan.tables)
    metas = tuple((t.col_offset, t.n_cols) for t in plan.tables)
    lchunk = min(row_chunk, 1 << max(local_N - 1, 1).bit_length())

    def local_fn(ents, w0s, ws, Vs, cps):
        tables = tuple(
            InferenceTable(
                ent=e, col_offset=off, n_cols=B, xs=xs, feat_cols=fc
            )
            for e, (xs, fc), (off, B) in zip(ents, aux, metas)
        )
        lplan = InferencePlan(
            tables=tables, n_rows=local_N,
            n_features=plan.n_features,
        )
        return scores_samples_reduce(
            lplan, w0s, ws, Vs, mode=mode, cutpoints=cps,
            row_chunk=lchunk,
        )

    cps = (
        cutpoints
        if cutpoints is not None
        else jnp.zeros((w0s.shape[0], 1), w0s.dtype)
    )
    ent_specs = tuple(P("data") for _ in ents)
    f = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(ent_specs, P(), P(), P(), P()),
        out_specs=P("data"),
        check_vma=False,
    )
    out = f(ents, w0s, ws, Vs, cps)
    return out[:N]
