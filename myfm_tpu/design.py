"""Host-side design-matrix compilation for the device samplers.

The reference engine walks scipy-CSR columns serially in C++
(include/myfm/FMTrainer.hpp:231-486).  Here we instead
*compile* the design matrix once, on the host, into a static plan:

* every table (the main table plus each RelationBlock) is lowered to
  flat COO arrays for the forward pass, and
* the features of each table are partitioned into **colors** — sets of
  columns that share no row.  Within a color, the per-coordinate Gibbs
  conditionals are mutually independent (updating one feature's weight
  touches only rows no other feature in the color touches), so an entire
  color can be drawn in one fused, vectorized step with *exactly* the
  same conditional distributions as the serial scan.  This is the
  chromatic-Gibbs re-derivation of the reference's sequential sweep.

For the one-hot encodings that dominate factorization-machine workloads
(user id, item id, time bucket) each table needs only ``max_row_nnz``
colors, so the whole sweep is a handful of large segment-sum steps —
a good fit for a bandwidth-bound accelerator.

All emitted arrays have static shapes (padded to a multiple of 8) so a
single XLA compilation covers the whole training run.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import sparse as sps

import jax
import jax.numpy as jnp

from .relational import RelationBlock

try:  # optional native planner (C++); pure-numpy fallback below
    from ._native import greedy_color_native  # type: ignore
except Exception:  # pragma: no cover
    greedy_color_native = None


def _pad_to(n: int, multiple: int = 8) -> int:
    if n == 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


# minimum number of single-entry features in an unrolled dense color
# before they are split into the identity fast step (DenseColor.id_*);
# below this the one-hot machinery handles them with no split overhead
IDENTITY_SPLIT_MIN = 32


# ---------------------------------------------------------------------------
# Pytree plan dataclasses
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColorPlan:
    """One parallel (row-disjoint) set of features of a single table.

    Entry arrays are sorted by ``seg`` (feature-within-color index) and
    padded with ``val == 0`` entries, which contribute nothing to any
    statistic.  ``feat`` holds *global* feature indices, padded with
    ``n_features`` (out-of-range ⇒ dropped by scatter, clamped by gather
    and discarded).
    """

    rows: jax.Array  # [Pe] int32 — local row space (orig rows / block rows)
    vals: jax.Array  # [Pe] float
    seg: jax.Array  # [Pe] int32 — index into `feat`, pad = n_feat
    feat: jax.Array  # [Pf] int32 — global feature ids, pad = F_total
    sx2: jax.Array  # [Pf] float — Σ x² over *expanded* rows (static)


jax.tree_util.register_dataclass(
    ColorPlan,
    data_fields=["rows", "vals", "seg", "feat", "sx2"],
    meta_fields=[],
)


@dataclasses.dataclass(frozen=True)
class ColorStack:
    """Many same-shaped colors stacked for a ``lax.scan`` sweep.

    Used when a table needs more colors than we are willing to unroll
    (e.g. multi-hot "implicit feedback" columns whose conflict graph has
    large cliques).  Each scan step executes one color.
    """

    rows: jax.Array  # [C, Pe]
    vals: jax.Array  # [C, Pe]
    seg: jax.Array  # [C, Pe]
    feat: jax.Array  # [C, Pf]
    sx2: jax.Array  # [C, Pf]


jax.tree_util.register_dataclass(
    ColorStack,
    data_fields=["rows", "vals", "seg", "feat", "sx2"],
    meta_fields=[],
)


@dataclasses.dataclass(frozen=True)
class TablePlan:
    """Compiled main table: COO for forwards + colors for the sweep."""

    coo_row: jax.Array  # [Pe_all] int32
    coo_col: jax.Array  # [Pe_all] int32 — *global* feature ids (pad F_total)
    coo_val: jax.Array  # [Pe_all] float (pad 0)
    colors: Tuple[ColorPlan, ...]
    color_stack: Optional[ColorStack]
    col_offset: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))


jax.tree_util.register_dataclass(
    TablePlan,
    data_fields=["coo_row", "coo_col", "coo_val", "colors", "color_stack"],
    meta_fields=["col_offset", "n_cols"],
)


@dataclasses.dataclass(frozen=True)
class DenseColor:
    """One color in dense block-row form (for the joint sweep).

    Within a color every block row belongs to at most one drawn
    feature, so the ragged entry lists collapse to B-length vectors —
    all per-step work becomes lane-parallel [B]-vector arithmetic and
    tiny one-hot matmuls, with no gathers or scatters in the scan body
    (see ops/joint.py for the measured motivation).

    ``id_xw``/``id_feat`` (optional) carve out the color's
    *single-entry* features — features touching exactly ONE block row,
    e.g. the one-hot id columns, which in block space each have a
    single entry.  For those the per-feature draw statistics are just
    that row's Gram entries scaled by powers of x, so the step needs
    no one-hot projection or matmul at all (ops/joint.py
    ``_identity_color_apply``); they are drawn before the remaining
    ragged features of the color (exact: same-color features are
    row-disjoint, so their Gram/state updates don't interact).
    """

    xw: jax.Array  # [B] float — x value at each block row (0 = absent)
    segb: jax.Array  # [B] int32 — feature slot in `feat` (pad = Pf)
    feat: jax.Array  # [Pf] int32 — global feature ids (pad = F_total)
    id_xw: Optional[jax.Array] = None  # [B] float — x of the row's
    #   single-entry feature (0 = none)
    id_feat: Optional[jax.Array] = None  # [B] int32 — that feature's
    #   global id (F_total = none)


jax.tree_util.register_dataclass(
    DenseColor,
    data_fields=["xw", "segb", "feat", "id_xw", "id_feat"],
    meta_fields=[],
)


@dataclasses.dataclass(frozen=True)
class DenseStack:
    """Stacked DenseColors (common Pf) for a lax.scan sweep."""

    xw: jax.Array  # [C, B]
    segb: jax.Array  # [C, B]
    feat: jax.Array  # [C, Pf]


jax.tree_util.register_dataclass(
    DenseStack, data_fields=["xw", "segb", "feat"], meta_fields=[]
)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Compiled RelationBlock: block-row COO + mapper + cardinality.

    Mirrors the role of the reference's ``RelationWiseCache``
    (/root/reference/include/myfm/definitions.hpp:54-84) but re-derived:
    instead of incrementally un-/re-synchronised caches, the sweep
    recomputes the four segment aggregates (Σe, Σq, Σq², Σeq per block
    row) with O(n_rows) segment-sums before each color step.

    ``dense_colors``/``dense_stack`` are the joint-sweep dense color
    operands (compiled only with ``joint_dense=True`` and when the
    C×B footprint fits the budget).
    """

    coo_row: jax.Array  # [Pe_all] int32 — block rows
    coo_col: jax.Array  # [Pe_all] int32 — global feature ids
    coo_val: jax.Array  # [Pe_all] float
    colors: Tuple[ColorPlan, ...]
    color_stack: Optional[ColorStack]
    mapper: jax.Array  # [N] int32 — original row -> block row
    cardinality: jax.Array  # [B] float — #originals per block row
    col_offset: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    block_size: int = dataclasses.field(metadata=dict(static=True))
    dense_colors: Tuple[DenseColor, ...] = ()
    dense_stack: Optional[DenseStack] = None


jax.tree_util.register_dataclass(
    BlockPlan,
    data_fields=[
        "coo_row",
        "coo_col",
        "coo_val",
        "colors",
        "color_stack",
        "mapper",
        "cardinality",
        "dense_colors",
        "dense_stack",
    ],
    meta_fields=["col_offset", "n_cols", "block_size"],
)


@dataclasses.dataclass(frozen=True)
class DesignPlan:
    """The full compiled design: one main table + any relation blocks.

    ``row_mask`` is only present on sharded plans whose row count was
    padded to a multiple of the device count: 1.0 for real rows, 0.0
    for padding (padding rows carry no COO entries and their mapper
    points at a dropped segment, so the mask is consulted only by the
    residual refresh and the row-count statistics).
    """

    main: TablePlan
    blocks: Tuple[BlockPlan, ...]
    group_index: jax.Array  # [F] int32
    group_counts: jax.Array  # [G] float
    row_mask: Optional[jax.Array]  # [N] or None
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_features: int = dataclasses.field(metadata=dict(static=True))
    n_groups: int = dataclasses.field(metadata=dict(static=True))


jax.tree_util.register_dataclass(
    DesignPlan,
    data_fields=["main", "blocks", "group_index", "group_counts",
                 "row_mask"],
    meta_fields=["n_rows", "n_features", "n_groups"],
)


# ---------------------------------------------------------------------------
# Greedy chromatic planner
# ---------------------------------------------------------------------------


# sweep_strategy="auto" upgrades to the merged joint-row sweep up to
# this rank.  The solver tiers by D' = rank+1 (ops/joint.py
# solve_spd_sample): D' ≤ 32 uses the hand-unrolled Cholesky (~D'³/6
# vector ops, traced once in the scan body); D' > 32 uses batched
# linalg (~300 µs/step — slower per color but still several× the
# chromatic fallback on 2k-color relational designs).  Program-size
# control at rank > JOINT_UNROLL_MAX_RANK: the identity-color split
# (O(R³) inlined lane ops per unrolled color) is disabled and the
# unrolled dense head is capped at 4 colors (_build_dense_colors).
# One-hot designs never get here — they take the entity-space fast
# path first.
JOINT_AUTO_MAX_RANK = 128

# above this rank the joint compile drops the per-color unrolled
# fast-step machinery (identity split, wide unrolled head) to keep the
# traced program bounded
JOINT_UNROLL_MAX_RANK = 16


def _joint_auto_core(rank: int, dtype, group_counts) -> bool:
    """The (rank, dtype, grouping) thresholds shared by BOTH halves of
    the "auto" → joint decision — the one place to tune them."""
    if rank > JOINT_AUTO_MAX_RANK:
        return False
    if np.dtype(dtype) == np.float64:
        return True
    counts = np.asarray(group_counts)
    return counts.size > 0 and float(counts.min()) >= max(
        16, 4 * (rank + 2)
    )


def joint_auto_candidate(
    rank: int, fit_linear: bool, dtype, group_index
) -> bool:
    """Pre-compile part of the "auto" → joint upgrade decision (the
    single source of truth for the single-chip AND sharded cores, so
    their engine choices cannot drift apart).

    True when the linear terms are fit, the rank is within
    JOINT_AUTO_MAX_RANK, and — under float32 — every hyper-group is
    large enough to identify its λ draws tightly.  Tiny groups (a
    handful of features sharing one Gamma prior) give λ a heavy
    posterior tail; during a λ→small excursion the scores inflate and
    the joint draw's Gram-assembled statistics lose their
    null-direction information to absolute float32 roundoff — observed
    as a runaway chain on a 3-feature stub.  The per-coordinate colored
    sweep assembles every statistic row-wise (relative error only) and
    rides out the same excursions, so it stays the fallback there.
    float64 joint is robust at any group size.

    Computable from (rank, dtype, grouping) alone — callers check it
    BEFORE compiling the design so a guaranteed-rejected upgrade never
    pays for dense color operands."""
    return fit_linear and _joint_auto_core(
        rank, dtype,
        np.bincount(np.asarray(group_index, dtype=np.int64)),
    )


def joint_auto_eligible(
    plan: "DesignPlan", rank: int, dtype=np.float32
) -> bool:
    """Post-compile part of the "auto" → joint decision: the
    (rank, dtype, grouping) thresholds (re-checked from the plan's own
    group counts via the shared ``_joint_auto_core``) plus "every block
    got dense color operands" (compiled with ``joint_dense=True``
    inside the C×B budget) — the regime where the joint sweep is
    measured 10-25× the chromatic sweep.  ``fit_linear`` is NOT
    re-checked here: both call sites conjoin this with the
    ``joint_auto_candidate`` result, which enforces it.

    Representation consistency: the candidate gates depend only on
    (rank, dtype, grouping), which blocked and flattened forms of the
    same design share, so they resolve identically and the reference's
    blocked ≡ flattened sample contract holds under "auto".  The ONE
    exception is the dense budget: a block whose n_colors × block_size
    exceeds the 64M-element budget falls back to colored while its
    flattened form (no blocks) would take the joint engine.  That
    boundary sits at ~10M-row scale where materializing the flattened
    matrix is already infeasible, so no practical workload observes it
    — but when exact cross-representation parity is required at any
    scale, pin the engine explicitly (sweep_strategy="colored" or
    "joint")."""
    return all(
        b.dense_colors or b.dense_stack is not None
        for b in plan.blocks
        if b.n_cols > 0
    ) and _joint_auto_core(rank, dtype, plan.group_counts)


def greedy_color(csc: sps.csc_matrix) -> List[np.ndarray]:
    """Partition columns into row-disjoint sets (a valid coloring).

    Greedy single pass in column order: maintain per-row counters ``c``
    where ``c[r]`` is the smallest color safe for any future column
    touching row ``r``.  A column's color is ``max(c[rows])``; after
    assignment ``c[rows]`` is raised to ``color + 1``.  Columns sharing
    a row therefore always receive distinct colors.  The number of
    colors is at most ``max_row_nnz`` plus ordering slack; for one-hot
    groups laid out contiguously it is exactly the row nnz.
    """
    n_rows, n_cols = csc.shape
    indptr, indices = csc.indptr, csc.indices
    if greedy_color_native is not None:
        assign = greedy_color_native(n_rows, n_cols, indptr, indices)
    else:
        c = np.zeros(n_rows, dtype=np.int32)
        assign = np.zeros(n_cols, dtype=np.int32)
        for f in range(n_cols):
            rows = indices[indptr[f] : indptr[f + 1]]
            if rows.size == 0:
                assign[f] = 0
                continue
            col = int(c[rows].max())
            assign[f] = col
            c[rows] = np.maximum(c[rows], col + 1)
    n_colors = int(assign.max()) + 1 if n_cols else 0
    order = np.argsort(assign, kind="stable")
    bounds = np.searchsorted(assign[order], np.arange(n_colors + 1))
    return [order[bounds[i] : bounds[i + 1]] for i in range(n_colors)]


def _serial_colors(n_cols: int) -> List[np.ndarray]:
    return [np.array([f]) for f in range(n_cols)]


# ---------------------------------------------------------------------------
# Table compilation
# ---------------------------------------------------------------------------


def _take_segments(
    indptr: np.ndarray, feats: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized multi-slice gather: flat nnz indices of the given
    columns (in column order) plus per-column counts — no Python loop."""
    counts = (indptr[feats + 1] - indptr[feats]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), counts
    starts = indptr[feats].astype(np.int64)
    offs = np.zeros(len(feats), dtype=np.int64)
    np.cumsum(counts[:-1], out=offs[1:])
    idx = (
        np.arange(total, dtype=np.int64)
        + np.repeat(starts - offs, counts)
    )
    return idx, counts


def _build_color_arrays(
    csc: sps.csc_matrix,
    feats_local: np.ndarray,
    col_offset: int,
    n_features_total: int,
    sx2_all: np.ndarray,
    dtype: np.dtype,
    pe: Optional[int] = None,
    pf: Optional[int] = None,
    as_numpy: bool = False,
) -> ColorPlan:
    indptr, indices, data = csc.indptr, csc.indices, csc.data
    idx, counts = _take_segments(indptr, feats_local)
    nnz = int(counts.sum())
    n_feat = len(feats_local)
    Pe = pe if pe is not None else _pad_to(nnz)
    Pf = pf if pf is not None else _pad_to(n_feat)

    rows = np.zeros(Pe, dtype=np.int32)
    vals = np.zeros(Pe, dtype=dtype)
    seg = np.full(Pe, n_feat, dtype=np.int32)
    rows[:nnz] = indices[idx]
    vals[:nnz] = data[idx]
    seg[:nnz] = np.repeat(
        np.arange(n_feat, dtype=np.int32), counts
    )

    feat = np.full(Pf, n_features_total, dtype=np.int32)
    feat[:n_feat] = feats_local + col_offset
    sx2 = np.zeros(Pf, dtype=dtype)
    sx2[:n_feat] = sx2_all[feats_local]

    if as_numpy:
        # caller stacks the host arrays and uploads ONCE instead of
        # ~5 tiny device_puts per color (thousands of colors)
        return ColorPlan(
            rows=rows, vals=vals, seg=seg, feat=feat, sx2=sx2
        )
    return ColorPlan(
        rows=jnp.asarray(rows),
        vals=jnp.asarray(vals),
        seg=jnp.asarray(seg),
        feat=jnp.asarray(feat),
        sx2=jnp.asarray(sx2),
    )


def _build_dense_colors(
    csc: sps.csc_matrix,
    groups: List[np.ndarray],
    col_offset: int,
    n_features_total: int,
    dtype: np.dtype,
    max_unrolled_colors: int,
    budget_elements: int,
    identity_split: bool = True,
) -> Tuple[Optional[Tuple[DenseColor, ...]], Optional[DenseStack]]:
    """Dense per-block-row color operands for the joint sweep.

    The first ``max_unrolled_colors`` (large) colors become individual
    DenseColors with their own Pf; the tail is stacked with a common Pf
    for the scan.  Returns (None, None) when C×B exceeds the budget.
    ``identity_split=False`` (high ranks) skips the single-entry
    fast-step carve-out, whose unrolled draw is O(rank³) inlined ops
    per color (ops/joint._identity_color_apply)."""
    B = csc.shape[0]
    if len(groups) * B > budget_elements:
        return None, None
    indptr, indices, data = csc.indptr, csc.indices, csc.data

    def one(feats_local, pf=None):
        idx, counts = _take_segments(indptr, feats_local)
        n_feat = len(feats_local)
        Pf = pf if pf is not None else _pad_to(n_feat)
        xw = np.zeros(B, dtype=dtype)
        segb = np.full(B, Pf, dtype=np.int32)
        rows = indices[idx]
        xw[rows] = data[idx]
        segb[rows] = np.repeat(
            np.arange(n_feat, dtype=np.int32), counts
        )
        feat = np.full(Pf, n_features_total, dtype=np.int32)
        feat[:n_feat] = feats_local + col_offset
        return xw, segb, feat

    unrolled = groups[:max_unrolled_colors]
    stacked = groups[max_unrolled_colors:]
    dense_colors = []
    for g in unrolled:
        counts_g = indptr[g + 1] - indptr[g]
        singles_mask = counts_g == 1
        id_xw = id_feat = None
        if identity_split and int(singles_mask.sum()) >= IDENTITY_SPLIT_MIN:
            # single-entry features (e.g. one-hot id columns): draw
            # statistics come straight from their row's Gram entries —
            # split them out of the one-hot machinery entirely
            singles = g[singles_mask]
            g = g[~singles_mask]
            pos = indptr[singles]
            srows = indices[pos]
            id_xw = np.zeros(B, dtype=dtype)
            id_feat = np.full(B, n_features_total, dtype=np.int32)
            id_xw[srows] = data[pos]
            id_feat[srows] = (singles + col_offset).astype(np.int32)
        x, s, f = one(g)
        dense_colors.append(
            DenseColor(
                xw=jnp.asarray(x), segb=jnp.asarray(s),
                feat=jnp.asarray(f),
                id_xw=None if id_xw is None else jnp.asarray(id_xw),
                id_feat=(
                    None if id_feat is None else jnp.asarray(id_feat)
                ),
            )
        )
    dense_colors = tuple(dense_colors)
    dense_stack = None
    if stacked:
        pf = _pad_to(max(len(g) for g in stacked))
        built = [one(g, pf=pf) for g in stacked]
        dense_stack = DenseStack(
            xw=jnp.asarray(np.stack([b[0] for b in built])),
            segb=jnp.asarray(np.stack([b[1] for b in built])),
            feat=jnp.asarray(np.stack([b[2] for b in built])),
        )
    return dense_colors, dense_stack


def _compile_table(
    X: sps.csr_matrix,
    col_offset: int,
    n_features_total: int,
    dtype: np.dtype,
    strategy: str,
    expanded_weight: Optional[np.ndarray],
    max_unrolled_colors: int,
    for_training: bool,
    joint_dense: bool = False,
    dense_budget: int = 64 << 20,
    joint_rank: Optional[int] = None,
):
    """Shared compilation for main tables and block tables.

    ``expanded_weight``: per-local-row multiplicity used for the static
    Σx² (1 for the main table, ``cardinality`` for blocks).
    ``joint_rank``: the model rank the joint operands will be swept at
    — above JOINT_UNROLL_MAX_RANK the per-color unrolled machinery is
    trimmed (no identity split, head capped at 4 colors) so the traced
    program stays bounded.
    """
    n_rows_local, n_cols = X.shape
    coo = X.tocoo()
    nnz = coo.nnz
    Pe = _pad_to(nnz)
    coo_row = np.zeros(Pe, dtype=np.int32)
    coo_col = np.full(Pe, n_features_total, dtype=np.int32)
    coo_val = np.zeros(Pe, dtype=dtype)
    coo_row[:nnz] = coo.row
    coo_col[:nnz] = coo.col + col_offset
    coo_val[:nnz] = coo.data

    colors: Tuple[ColorPlan, ...] = ()
    color_stack = None
    dense_colors: Optional[Tuple[DenseColor, ...]] = None
    dense_stack: Optional[DenseStack] = None
    if for_training and n_cols > 0:
        csc = X.tocsc()
        csc.sort_indices()
        if expanded_weight is None:
            sx2_all = np.asarray(
                csc.power(2).sum(axis=0), dtype=dtype
            ).ravel()
        else:
            w = np.asarray(expanded_weight, dtype=np.float64)
            sx2_all = np.asarray(
                csc.power(2).T.dot(w), dtype=dtype
            ).ravel()
        if strategy == "serial":
            groups = _serial_colors(n_cols)
        else:
            groups = greedy_color(csc)

        if joint_dense:
            wide = (
                joint_rank is not None
                and joint_rank > JOINT_UNROLL_MAX_RANK
            )
            dense_colors, dense_stack = _build_dense_colors(
                csc, groups, col_offset, n_features_total, dtype,
                min(max_unrolled_colors, 4) if wide
                else max_unrolled_colors,
                dense_budget,
                identity_split=not wide,
            )

        unrolled = groups[:max_unrolled_colors]
        stacked = groups[max_unrolled_colors:]
        colors = tuple(
            _build_color_arrays(
                csc, g, col_offset, n_features_total, sx2_all, dtype
            )
            for g in unrolled
        )
        if stacked:
            indptr = csc.indptr
            pe = _pad_to(
                max(
                    int((indptr[g + 1] - indptr[g]).sum())
                    for g in stacked
                )
            )
            pf = _pad_to(max(len(g) for g in stacked))
            planned = [
                _build_color_arrays(
                    csc,
                    g,
                    col_offset,
                    n_features_total,
                    sx2_all,
                    dtype,
                    pe=pe,
                    pf=pf,
                    as_numpy=True,
                )
                for g in stacked
            ]
            color_stack = ColorStack(
                rows=jnp.asarray(np.stack([c.rows for c in planned])),
                vals=jnp.asarray(np.stack([c.vals for c in planned])),
                seg=jnp.asarray(np.stack([c.seg for c in planned])),
                feat=jnp.asarray(np.stack([c.feat for c in planned])),
                sx2=jnp.asarray(np.stack([c.sx2 for c in planned])),
            )

    return (
        jnp.asarray(coo_row),
        jnp.asarray(coo_col),
        jnp.asarray(coo_val),
        colors,
        color_stack,
        dense_colors,
        dense_stack,
    )


def compile_design(
    X: Optional[sps.spmatrix],
    blocks: Sequence[RelationBlock] = (),
    grouping: Optional[np.ndarray] = None,
    n_groups: Optional[int] = None,
    dtype=np.float32,
    strategy: str = "auto",
    max_unrolled_colors: int = 16,
    for_training: bool = True,
    joint_dense: bool = False,
    dense_budget: int = 64 << 20,
    joint_rank: Optional[int] = None,
) -> DesignPlan:
    """Compile (X, blocks) into a static device plan.

    ``strategy``: ``"auto"`` uses chromatic coloring; ``"serial"`` makes
    every feature its own color (the bit-faithful analogue of the
    reference's serial scan — same conditionals, same draw order).

    ``joint_dense``: additionally emit dense block-row color operands
    for the merged joint sweep (ops/joint.py) when each block's
    n_colors × block_size fits ``dense_budget`` elements; pass
    ``joint_rank`` so high-rank compiles trim the unrolled machinery
    (JOINT_UNROLL_MAX_RANK).
    """
    dtype = np.dtype(dtype)
    if X is None:
        if not blocks:
            raise ValueError("At least X or blocks must be provided.")
        n_rows = blocks[0].mapper_size
        X = sps.csr_matrix((n_rows, 0), dtype=dtype)
    X = sps.csr_matrix(X).astype(dtype)
    n_rows = X.shape[0]
    for b in blocks:
        if b.mapper_size != n_rows:
            raise ValueError(
                "RelationBlock mapper size "
                f"{b.mapper_size} != number of rows {n_rows}."
            )
    n_features = X.shape[1] + sum(b.feature_size for b in blocks)

    if grouping is None:
        grouping = np.zeros(n_features, dtype=np.int32)
        n_groups = 1
    else:
        grouping = np.asarray(grouping, dtype=np.int32)
        if grouping.shape[0] != n_features:
            raise ValueError(
                f"grouping has length {grouping.shape[0]}, expected "
                f"{n_features}."
            )
        if n_groups is None:
            n_groups = int(grouping.max()) + 1 if grouping.size else 1
        uniq = np.unique(grouping)
        if uniq.size and (
            uniq[0] < 0 or uniq[-1] >= n_groups or uniq.size != n_groups
        ):
            raise ValueError(
                "group indices must cover 0..n_groups-1 contiguously "
                "(reference contract, FMLearningConfig.hpp:33-40)."
            )
    group_counts = np.bincount(grouping, minlength=n_groups).astype(dtype)

    coo_row, coo_col, coo_val, colors, cstack, _, _ = _compile_table(
        X, 0, n_features, dtype, strategy, None, max_unrolled_colors,
        for_training,
    )
    main = TablePlan(
        coo_row=coo_row,
        coo_col=coo_col,
        coo_val=coo_val,
        colors=colors,
        color_stack=cstack,
        col_offset=0,
        n_cols=X.shape[1],
    )

    compiled_blocks: List[BlockPlan] = []
    offset = X.shape[1]
    for b in blocks:
        card = np.bincount(
            b.original_to_block, minlength=b.block_size
        ).astype(dtype)
        bx = sps.csr_matrix(b.data).astype(dtype)
        (coo_row, coo_col, coo_val, colors, cstack, dcolors,
         dstack) = _compile_table(
            bx,
            offset,
            n_features,
            dtype,
            strategy,
            card,
            max_unrolled_colors,
            for_training,
            joint_dense=joint_dense,
            dense_budget=dense_budget,
            joint_rank=joint_rank,
        )
        compiled_blocks.append(
            BlockPlan(
                coo_row=coo_row,
                coo_col=coo_col,
                coo_val=coo_val,
                colors=colors,
                color_stack=cstack,
                mapper=jnp.asarray(b.original_to_block, dtype=np.int32),
                cardinality=jnp.asarray(card),
                col_offset=offset,
                n_cols=b.feature_size,
                block_size=b.block_size,
                dense_colors=dcolors if dcolors is not None else (),
                dense_stack=dstack,
            )
        )
        offset += b.feature_size

    return DesignPlan(
        main=main,
        blocks=tuple(compiled_blocks),
        group_index=jnp.asarray(grouping),
        group_counts=jnp.asarray(group_counts),
        row_mask=None,
        n_rows=n_rows,
        n_features=n_features,
        n_groups=int(n_groups),
    )
