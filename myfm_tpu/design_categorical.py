"""Design compilation for the *categorical fast path*.

A table (the main table or a RelationBlock, viewed through its mapper)
is **categorical** when every original row has exactly one active
feature with value 1.0 — the dominant structure of factorization-
machine workloads (user id, item id, date bucket; the reference's
ML-10M protocol is three such tables, examples/ml-10m-regression.py).

For categorical tables the Gibbs sweep admits an *entity-space*
formulation with no per-row scatters:

* rows are pre-sorted by entity (feature) at design time and packed
  into tiles of ``T`` rows with at most ``S`` distinct entities per
  tile (entities may split across tiles — partial sums add up);
* per-entity sufficient statistics (Gram matrices of ``[1 | e | φ]``
  rows) are computed per (tile, slot) segment (ops/gram.py) and summed
  into entities by a scatter-add over the (tile, slot) → entity map;
* the per-coordinate factor scan runs in entity space ([B, R] arrays),
  touching the [N]-sized state only via a handful of wide row-gathers.

This module computes the static layout arrays; the sweep itself lives
in ops/categorical.py.  Equivalent role to the reference's
RelationWiseCache construction (include/myfm/definitions.hpp:54-84).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import sparse as sps

import jax
import jax.numpy as jnp

try:  # native C++ planner (ctypes); numpy fallbacks below
    from ._native import pack_tiles_native, packed_rows_native
except Exception:  # pragma: no cover
    pack_tiles_native = packed_rows_native = None

# Entity+attribute gates: a non-one-hot column group of a block is
# compiled as a dense per-entity side matrix only when the dense
# [B, Fs] footprint and the stacked per-color operands [C, B] both
# stay bounded (f32 elements), and the greedy coloring of the side
# columns (conflict = co-occurrence in a block row) stays shallow.
SIDE_DENSE_ELEMS = 1 << 25
SIDE_MAX_COLORS = 2048


def _packed_rows(counts: np.ndarray, T: int, S: int) -> int:
    """Exact padded row count of the greedy packing, computed from the
    cardinality sequence without materializing the layout."""
    if packed_rows_native is not None:
        return packed_rows_native(counts, T, S)
    total = 0
    row_fill = 0
    ent_fill = 0
    for c in counts:
        c = int(c)
        if c == 0:
            continue
        taken = 0
        while taken < c:
            if row_fill >= T or ent_fill >= S:
                total += T
                row_fill = 0
                ent_fill = 0
            take = min(c - taken, T - row_fill)
            taken += take
            row_fill += take
            ent_fill += 1
    if row_fill:
        total += T
    return total


# Tile shapes the Gram implementations take (ops/gram.py): T is a power
# of two and a multiple of the kernel's 32-row block (Triton blocks are
# powers of two); S bounds the partial Grams written per tile.
TILE_ROWS = (32, 64, 128, 256, 512, 1024)
TILE_ENTITIES = (1, 2, 4, 8, 16, 32)


def choose_tiling(counts: np.ndarray, gram_cols: int):
    """(T, S, inflation) for one table: the tiling that moves the fewest
    modeled bytes through a table pass's Gram.

    Per padded row the plain path writes and reads z and its
    slot-expanded operand ((S + 1)·D floats); per (tile, slot) both
    paths write one partial Gram and scatter-add it back (2·D²
    floats).  Dense tables (thousands of rows per entity) therefore get
    large T and small S; scattered tables trade pad rows against
    partials.  ``inflation`` is the exact packed/real row ratio."""
    n = max(int(counts.sum()), 1)
    D = gram_cols + 2
    best = None
    for Tc in TILE_ROWS:
        for Sc in TILE_ENTITIES:
            packed = _packed_rows(counts, Tc, Sc)
            cost = packed * (Sc + 1) * D + 2 * (packed // Tc) * Sc * D * D
            if best is None or cost < best[0]:
                best = (cost, Tc, Sc, packed / n)
    return best[1:]


def categorical_mapping(
    X: sps.csr_matrix,
    mapper: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """If (X, mapper) encodes a one-hot feature per original row,
    return ``ent[n]`` = the active *local column* per original row,
    else None.

    For the main table, ``mapper`` is None and X has n_rows rows.
    For a RelationBlock, X is the block table and ``mapper`` maps
    original rows to block rows; the composition must be one-hot.
    """
    X = sps.csr_matrix(X)
    nnz_per_row = np.diff(X.indptr)
    if not (nnz_per_row == 1).all():
        return None
    if not (X.data == 1.0).all():
        return None
    col_of_row = X.indices.astype(np.int64)  # [n_local_rows]
    if mapper is None:
        return col_of_row
    return col_of_row[np.asarray(mapper, dtype=np.int64)]


@dataclasses.dataclass(frozen=True)
class CategoricalTable:
    """Static layout of one categorical table's sorted-tile space.

    ``NT = n_tiles * T`` tile rows.  Pad tile rows have ``src == N``
    (out of range: gathers through a zero pad row) and ``slot == S``,
    so they contribute nothing to any statistic.  Rows of one
    (tile, slot) pair are contiguous; ``seg`` gives each pair's
    (start row, length) and ``ent_slots`` its entity, which is how the
    Gram pass sums the pieces of entities that span tiles.
    """

    src: jax.Array  # [NT] int32 — main-order row index (pad = N)
    slot: jax.Array  # [NT] int32 — local entity slot within tile (pad S)
    ent_of_tile_row: jax.Array  # [NT] int32 — local entity id (pad = B)
    ent_slots: jax.Array  # [K, S] int32 — entity id per slot (pad=B)
    seg: jax.Array  # [K, S, 2] int32 — (start, length) per slot
    cardinality: jax.Array  # [B] float — rows per entity
    ent_main: jax.Array  # [N] int32 — entity id per main-order row
    noise_feat: jax.Array  # [B] int32 — global feature ids of entities
    col_offset: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))  # B
    n_tiles: int = dataclasses.field(metadata=dict(static=True))
    tile_rows: int = dataclasses.field(metadata=dict(static=True))  # T
    tile_entities: int = dataclasses.field(metadata=dict(static=True))  # S
    chunk_tiles: int = dataclasses.field(
        default=0, metadata=dict(static=True)
    )


jax.tree_util.register_dataclass(
    CategoricalTable,
    data_fields=[
        "src", "slot", "ent_of_tile_row", "ent_slots", "seg",
        "cardinality", "ent_main", "noise_feat",
    ],
    meta_fields=[
        "col_offset", "n_cols", "n_tiles", "tile_rows", "tile_entities",
        "chunk_tiles",
    ],
)


@dataclasses.dataclass(frozen=True)
class SideInfo:
    """Per-entity side features of one entity+attribute table.

    The owning ``CategoricalTable`` tiles the *block rows* themselves
    (``ent[n] = mapper[n]``, ``B = block_size``); the side matrix holds
    the non-one-hot feature values of each block row.  The reference
    treats these columns through its generic per-coordinate scan
    (FMTrainer.hpp:256-314, 379-482); here they are drawn with
    (R+1)-dim joint conditionals per feature, one graph color at a
    time, entirely in entity space (ops/categorical.py:_ea_table_pass).

    Colors partition the side columns into row-disjoint sets, so the
    per-color operands collapse to dense B-vectors (``xw``: the x value
    at each block row, 0 where absent; ``segb``: the feature slot).
    """

    xs: jax.Array  # [B, Fs] float — dense side matrix
    feat_cols: jax.Array  # [Fs] int32 — global feature ids
    stack_xw: jax.Array  # [C, B] float
    stack_segb: jax.Array  # [C, B] int32 (pad = Pf)
    stack_feat: jax.Array  # [C, Pf] int32 global ids (pad = F_total)
    n_cols: int = dataclasses.field(metadata=dict(static=True))  # Fs


jax.tree_util.register_dataclass(
    SideInfo,
    data_fields=["xs", "feat_cols", "stack_xw", "stack_segb",
                 "stack_feat"],
    meta_fields=["n_cols"],
)


def compile_side_info(
    Xs: sps.csr_matrix,
    col_ids: np.ndarray,
    n_features: int,
    dtype,
) -> Optional[SideInfo]:
    """Dense side matrix + stacked per-color draw operands, or None
    when the footprint/coloring gates fail."""
    from .design import greedy_color

    Xs = sps.csr_matrix(Xs)
    B, Fs = Xs.shape
    if B * Fs > SIDE_DENSE_ELEMS:
        return None
    colors = greedy_color(Xs.tocsc())
    C = len(colors)
    if C > SIDE_MAX_COLORS or C * B > SIDE_DENSE_ELEMS:
        return None
    col_ids = np.asarray(col_ids, dtype=np.int64)
    Pf = max(max(len(c) for c in colors), 1)
    xw = np.zeros((C, B), dtype=dtype)
    segb = np.full((C, B), Pf, dtype=np.int32)
    feat = np.full((C, Pf), n_features, dtype=np.int64)
    csc = Xs.tocsc()
    for ci, cols in enumerate(colors):
        for sj, j in enumerate(cols):
            lo, hi = csc.indptr[j], csc.indptr[j + 1]
            rows = csc.indices[lo:hi]
            xw[ci, rows] = csc.data[lo:hi]
            segb[ci, rows] = sj
            feat[ci, sj] = col_ids[j]
    return SideInfo(
        xs=jnp.asarray(Xs.toarray().astype(dtype)),
        feat_cols=_upload_ids(col_ids, n_features),
        stack_xw=jnp.asarray(xw),
        stack_segb=jnp.asarray(segb),
        stack_feat=_upload_ids(feat, n_features),
        n_cols=Fs,
    )


# rows per Gram chunk in the sweep's lax.scan — bounds both the
# [chunk, R]-sized temporaries and (via per-chunk Gram consumption)
# removes any K*S*D*D-sized array
CHUNK_ROWS = 1 << 20
# bytes allowed for one chunk's partial-Gram output [Kc*S, D, D]
CHUNK_FLAT_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class CategoricalPlan:
    """All-categorical design: one CategoricalTable per table, in the
    reference's table order (main first if non-empty, then blocks).

    ``cross_ent[t][t2]`` maps table t's tile rows to table t2's entity
    ids (pad rows -> B_{t2}), so each table pass can reconstruct the
    residual/factor state in its own tile space purely from the small
    per-entity weight tables — no [N]-sized permutation gathers.
    """

    tables: Tuple[CategoricalTable, ...]
    cross_ent: Tuple[Tuple[jax.Array, ...], ...]
    group_index: jax.Array  # [F] int32
    group_counts: jax.Array  # [G] float
    row_mask: Optional[jax.Array]  # [N] float or None
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_features: int = dataclasses.field(metadata=dict(static=True))
    n_groups: int = dataclasses.field(metadata=dict(static=True))
    # real (unmasked) rows across ALL shards — the n in the alpha/w0
    # conditionals; equals n_rows on single-chip plans
    n_real: int = dataclasses.field(default=-1, metadata=dict(static=True))
    # side[t] is the SideInfo of table t when t is an entity+attribute
    # table (its entities are block rows carrying per-entity side
    # features), else None; all-None for plain all-one-hot designs
    side: Tuple[Optional[SideInfo], ...] = ()

    def __post_init__(self):
        if self.n_real < 0:
            object.__setattr__(self, "n_real", self.n_rows)
        if len(self.side) != len(self.tables):
            object.__setattr__(
                self, "side", tuple(None for _ in self.tables)
            )


jax.tree_util.register_dataclass(
    CategoricalPlan,
    data_fields=["tables", "cross_ent", "group_index", "group_counts",
                 "row_mask", "side"],
    meta_fields=["n_rows", "n_features", "n_groups", "n_real"],
)


def _pack_tiles(
    ent_sorted: np.ndarray, order: np.ndarray, n_entities: int,
    T: int, S: int,
):
    """Pack entity-sorted rows into (T-row, ≤S-entity) tiles.

    Returns (src, slot, ent_of_tile_row, ent_slots).  Pads use src = N
    (out of range), slot = S, ent = n_entities.

    Greedy: walk entities in order, filling the current tile; start a
    new tile when it is full (T rows) or already holds S entities.
    Entities longer than the remaining space split across consecutive
    tiles (their partial Grams add up).  One trailing all-pad tile is
    appended, as the native packer does.
    """
    n = ent_sorted.shape[0]
    counts = np.bincount(ent_sorted, minlength=n_entities)

    src_chunks: List[np.ndarray] = []
    slot_chunks: List[np.ndarray] = []
    ent_chunks: List[np.ndarray] = []
    tile_slot_ents: List[List[int]] = []  # per tile: entity per slot
    cur_slot_ents: List[int] = []

    row_fill = 0
    ent_fill = 0

    def close_tile():
        nonlocal row_fill, ent_fill, cur_slot_ents
        pad_rows = T - row_fill
        if pad_rows:
            src_chunks.append(np.full(pad_rows, -1, dtype=np.int64))
            slot_chunks.append(np.full(pad_rows, S, dtype=np.int64))
            ent_chunks.append(
                np.full(pad_rows, n_entities, dtype=np.int64)
            )
        tile_slot_ents.append(
            cur_slot_ents + [n_entities] * (S - len(cur_slot_ents))
        )
        row_fill = 0
        ent_fill = 0
        cur_slot_ents = []

    pos = 0
    for u in range(n_entities):
        c = int(counts[u])
        if c == 0:
            continue
        taken = 0
        while taken < c:
            if row_fill >= T or ent_fill >= S:
                close_tile()
            take = min(c - taken, T - row_fill)
            src_chunks.append(order[pos : pos + take])
            slot_chunks.append(np.full(take, ent_fill, dtype=np.int64))
            ent_chunks.append(np.full(take, u, dtype=np.int64))
            cur_slot_ents.append(u)
            pos += take
            taken += take
            row_fill += take
            ent_fill += 1
    if row_fill:
        close_tile()
    close_tile()  # trailing all-pad tile

    n_tiles = len(tile_slot_ents)
    ent_slots = np.asarray(tile_slot_ents, dtype=np.int32).reshape(
        n_tiles, S
    )
    src = np.concatenate(src_chunks)
    slot = np.concatenate(slot_chunks)
    ent = np.concatenate(ent_chunks)
    src = np.where(src < 0, n, src)  # pad -> N (OOB fill)
    return (
        src.astype(np.int32),
        slot.astype(np.int32),
        ent.astype(np.int32),
        ent_slots,
    )


def _plan_tiles(counts: np.ndarray, T: int, S: int):
    """Metadata-only tile packing: the same greedy walk as
    ``_pack_tiles`` but touching only counts-sized state — no O(N)
    src/slot arrays are materialized on the host.  Those are derived on
    the device from ``ent_main`` + the per-segment layout this returns
    (``_derive_src_slot_device``).

    Returns (seg_starts, seg_shift, seg_slot, n_tiles, ent_slots) where
    segment i covers entity-sorted positions [seg_starts[i],
    seg_starts[i+1]) and scatters to tile-row dest = pos + seg_shift[i]
    with slot value seg_slot[i]; ``ent_slots`` is bit-identical to
    ``_pack_tiles``' (tests/test_categorical.py parity)."""
    n_entities = counts.shape[0]
    seg_starts: List[int] = []
    seg_dest: List[int] = []
    seg_slot: List[int] = []
    tile_slot_ents: List[List[int]] = []
    cur_slot_ents: List[int] = []

    row_fill = 0
    ent_fill = 0

    def close_tile():
        nonlocal row_fill, ent_fill, cur_slot_ents
        tile_slot_ents.append(
            cur_slot_ents + [n_entities] * (S - len(cur_slot_ents))
        )
        row_fill = 0
        ent_fill = 0
        cur_slot_ents = []

    pos = 0
    for u in range(n_entities):
        c = int(counts[u])
        if c == 0:
            continue
        taken = 0
        while taken < c:
            if row_fill >= T or ent_fill >= S:
                close_tile()
            take = min(c - taken, T - row_fill)
            seg_starts.append(pos)
            seg_dest.append(len(tile_slot_ents) * T + row_fill)
            seg_slot.append(ent_fill)
            cur_slot_ents.append(u)
            pos += take
            taken += take
            row_fill += take
            ent_fill += 1
    if row_fill:
        close_tile()
    close_tile()  # trailing all-pad tile (same as _pack_tiles)

    n_tiles = len(tile_slot_ents)
    ent_slots = np.asarray(tile_slot_ents, dtype=np.int32).reshape(
        n_tiles, S
    )
    starts = np.asarray(seg_starts + [pos], dtype=np.int32)
    # sentinel segment covers sorted positions past the last real row
    # (SPMD pad rows, which argsort places last); the device derivation
    # routes it out of range via the static nt (a huge shift constant
    # would wrap: jax lowers scatter indices to int32 on small arrays)
    shift = np.asarray(
        [d - s for d, s in zip(seg_dest, seg_starts)] + [0],
        dtype=np.int32,
    )
    slots = np.asarray(seg_slot + [0], dtype=np.int32)
    return starts, shift, slots, n_tiles, ent_slots


def _derive_src_slot_device(
    ent_main: jax.Array,  # [n] int32, pad rows carry id == n_entities
    seg_starts: jax.Array,  # [n_seg+1] int32, ascending, sentinel last
    seg_shift: jax.Array,  # [n_seg+1] int32 (sentinel value = nt)
    seg_slot: jax.Array,  # [n_seg+1] int32 (sentinel 0)
    nt: int,
    n_rows: int,
    S: int,
):
    """src/slot tile layouts derived on the device inside ONE jitted
    program: a stable argsort of ent_main recovers the entity-sorted
    row order (pad ids sort last, exactly the host's argsort over real
    rows), searchsorted assigns each sorted position its packing
    segment, and two scatters place row indices / slot ids at their
    tile-row destinations.  Pad tile rows keep the initial (src=n_rows,
    slot=S) values; sorted positions past the last real segment land in
    the sentinel segment whose shift pushes them out of range (dropped
    by the scatter)."""
    order = jnp.argsort(ent_main, stable=True).astype(jnp.int32)
    p = jnp.arange(ent_main.shape[0], dtype=jnp.int32)
    seg = jnp.searchsorted(seg_starts, p, side="right") - 1
    sentinel = seg_starts.shape[0] - 1
    dest = jnp.where(seg < sentinel, p + seg_shift[seg], nt)
    src = jnp.full((nt,), n_rows, jnp.int32).at[dest].set(
        order, mode="drop"
    )
    slot = jnp.full((nt,), S, jnp.int32).at[dest].set(
        seg_slot[seg], mode="drop"
    )
    return src, slot


_derive_src_slot_jit = jax.jit(
    _derive_src_slot_device, static_argnums=(4, 5, 6)
)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _segments(slot: jax.Array, T: int, S: int) -> jax.Array:
    """(start, length) [K, S, 2] of every (tile, slot) row segment
    (rows of a slot are contiguous and slots ascend within a tile)."""
    K = slot.shape[0] // T
    s2 = slot.reshape(K, T)
    flat = jnp.where(
        s2 < S, jnp.arange(K, dtype=jnp.int32)[:, None] * S + s2, K * S
    )
    length = (
        jnp.zeros((K * S + 1,), jnp.int32).at[flat.reshape(-1)].add(1)
    )[: K * S].reshape(K, S)
    start = jnp.cumsum(length, axis=1) - length
    return jnp.stack([start, length], axis=2)


def _upload_ids(a: np.ndarray, max_id: int) -> jax.Array:
    """Upload an id array with the narrowest dtype that holds
    0..max_id (inclusive, pads use max_id), widening to int32 on
    device."""
    if max_id <= np.iinfo(np.uint8).max:
        return jnp.asarray(a.astype(np.uint8)).astype(jnp.int32)
    if max_id <= np.iinfo(np.int16).max:
        return jnp.asarray(a.astype(np.int16)).astype(jnp.int32)
    return jnp.asarray(a.astype(np.int32))


# Where the O(NT) src/slot tile layouts are built.  Both derivations
# give identical layouts (tests/test_categorical.py); on the GPU the
# device derivation took 0.2-1.1 s per table of the 10M design against
# 1.8-2.1 s for host packing plus upload (PERF.md), so it is the
# default.
DERIVE_SRC_ON_DEVICE = True


def compile_categorical_table(
    ent: np.ndarray,
    n_entities: int,
    col_offset: int,
    n_rows: int,
    dtype,
    rank: int = 32,
    max_inflation: Optional[float] = None,
    fixed_ts: Optional[Tuple[int, int]] = None,
    pad_tiles_to: Optional[int] = None,
    derive_src_on_device: bool = DERIVE_SRC_ON_DEVICE,
) -> Optional[CategoricalTable]:
    """``rank`` is the Gram's z-column count the tiling is chosen for;
    ``fixed_ts`` pins (T, S) (SPMD shards must agree on tiling);
    ``pad_tiles_to`` appends extra all-pad tiles so every shard's
    arrays share a static shape.

    ``derive_src_on_device`` derives the O(NT) src/slot tile layouts on
    the device from ent_main + the counts-only packing metadata
    (_plan_tiles/_derive_src_slot_device) instead of packing them on
    the host and uploading them."""
    ent = np.asarray(ent, dtype=np.int64)
    # rows with ent == n_entities are masked (SPMD row padding): they
    # never enter any tile; their ent_main stays the pad id so every
    # gather sees the zero pad row
    real = ent < n_entities
    counts = np.bincount(ent[real], minlength=n_entities)
    if fixed_ts is not None:
        T, S = fixed_ts
    else:
        T, S, inflation = choose_tiling(counts, rank)
        if max_inflation is not None and inflation > max_inflation:
            # pathological cardinality profile (e.g. one row per entity
            # at huge B): let the caller fall back to the colored path
            return None
    src = slot = None
    if derive_src_on_device:
        seg_starts, seg_shift, seg_slot, k_tiles, ent_slots = (
            _plan_tiles(counts, T, S)
        )
        nt = k_tiles * T
    else:
        order = np.argsort(ent[real], kind="stable")
        order = np.nonzero(real)[0][order]
        if pack_tiles_native is not None:
            src, slot, _ent_tile, ent_slots = pack_tiles_native(
                order, counts, ent.shape[0], T, S
            )
        else:
            src, slot, _ent_tile, ent_slots = _pack_tiles(
                ent[order], order, n_entities, T, S
            )
        nt = src.shape[0]
    assert nt % T == 0
    if pad_tiles_to is not None and nt // T < pad_tiles_to:
        extra = pad_tiles_to - nt // T
        n = ent.shape[0]
        if src is not None:
            src = np.concatenate(
                [src, np.full(extra * T, n, np.int32)]
            )
            slot = np.concatenate(
                [slot, np.full(extra * T, S, np.int32)]
            )
        ent_slots = np.concatenate(
            [ent_slots, np.full((extra, S), n_entities, np.int32)]
        )
        nt = nt + extra * T
    card = counts.astype(dtype)

    K = nt // T
    D = rank + 2
    chunk_tiles = max(
        1,
        min(
            K,
            CHUNK_ROWS // T,
            CHUNK_FLAT_BYTES // max(S * D * D * 4, 1),
        ),
    )

    # narrow dtypes are uploaded and widened on device; ent_of_tile_row
    # is derived on device (a gather of already-present arrays)
    ent_main_dev = _upload_ids(ent.astype(np.int64), n_entities)
    if src is None:
        src_dev, slot_dev = _derive_src_slot_jit(
            ent_main_dev,
            jnp.asarray(seg_starts),
            jnp.asarray(seg_shift),
            jnp.asarray(seg_slot),
            nt,
            n_rows,
            S,
        )
        if pad_tiles_to is not None and src_dev.shape[0] < nt:
            extra_rows = nt - src_dev.shape[0]
            src_dev = jnp.concatenate(
                [src_dev, jnp.full((extra_rows,), n_rows, jnp.int32)]
            )
            slot_dev = jnp.concatenate(
                [slot_dev, jnp.full((extra_rows,), S, jnp.int32)]
            )
    else:
        src_dev = jnp.asarray(src)
        slot_dev = _upload_ids(np.asarray(slot, np.int64), S)
    ent_pad_dev = jnp.concatenate(
        [ent_main_dev, jnp.asarray([n_entities], jnp.int32)]
    )
    ent_tile_dev = ent_pad_dev[jnp.minimum(src_dev, n_rows)]
    return CategoricalTable(
        src=src_dev,
        slot=slot_dev,
        ent_of_tile_row=ent_tile_dev,
        ent_slots=jnp.asarray(ent_slots),
        seg=_segments(slot_dev, T, S),
        cardinality=jnp.asarray(card),
        ent_main=ent_main_dev,
        noise_feat=jnp.asarray(
            col_offset + np.arange(n_entities, dtype=np.int32)
        ),
        col_offset=col_offset,
        n_cols=n_entities,
        n_tiles=nt // T,
        tile_rows=T,
        tile_entities=S,
        chunk_tiles=chunk_tiles,
    )



def extract_categorical_mappings(
    X: Optional[sps.spmatrix],
    blocks: Sequence,
    grouping: Optional[np.ndarray],
    dtype,
    allow_side: bool = False,
):
    """(mappings, side_specs, n_rows, n_features, grouping) for a
    categorical / entity+attribute design, or None.

    A mapping is (ent [N], B, col_offset) — one one-hot table.  A side
    spec is (ent [N], block_size, Xs csr [block_size, Fs], col_ids):
    the non-one-hot column groups of one block, compiled (when
    ``allow_side``) into an entity+attribute table whose entities are
    the block rows.  A grouped flattened main table splits into one
    table per column group so blocked ≡ flattened stays exact."""
    if X is None:
        if not blocks:
            return None
        n_rows = blocks[0].mapper_size
        X = sps.csr_matrix((n_rows, 0), dtype=dtype)
    X = sps.csr_matrix(X)
    n_rows = X.shape[0]
    n_features = X.shape[1] + sum(b.feature_size for b in blocks)

    if grouping is not None:
        grouping = np.asarray(grouping, dtype=np.int32)

    mappings: List[Tuple[np.ndarray, int, int]] = []  # (ent, B, offset)
    side_specs: List[Tuple[np.ndarray, int, sps.csr_matrix, np.ndarray]]
    side_specs = []
    if X.shape[1] > 0:
        ent = categorical_mapping(X)
        if ent is not None:
            mappings.append((ent, X.shape[1], 0))
        elif grouping is not None:
            # main-table rows have no entity compression, so non-one-
            # hot main groups stay on the colored/joint paths
            g_main = grouping[: X.shape[1]]
            if g_main.size and (np.diff(g_main) >= 0).all():
                bounds = np.searchsorted(
                    g_main, np.arange(g_main.max() + 2)
                )
                Xc = X.tocsc()
                for gi in range(g_main.max() + 1):
                    lo, hi = int(bounds[gi]), int(bounds[gi + 1])
                    if hi <= lo:
                        continue
                    sub = Xc[:, lo:hi].tocsr()
                    ent = categorical_mapping(sub)
                    if ent is None:
                        return None
                    mappings.append((ent, hi - lo, lo))
            else:
                return None
        else:
            return None
    offset = X.shape[1]
    for b in blocks:
        bx = sps.csr_matrix(b.data)
        mapper = np.asarray(b.original_to_block)
        ent = categorical_mapping(bx, mapper)
        if ent is not None:
            mappings.append((ent, b.feature_size, offset))
            offset += b.feature_size
            continue
        # split the block by column group: one-hot groups become
        # categorical tables (entity maps composed through the block
        # mapper); the remaining groups — multi-hot genres, implicit-
        # feedback vectors, numeric attributes — are per-entity side
        # features of the block rows (entity+attribute table)
        side_cols: List[int] = []
        if grouping is not None:
            g_blk = grouping[offset : offset + b.feature_size]
            if not (g_blk.size and (np.diff(g_blk) >= 0).all()):
                return None
            bounds = np.searchsorted(
                g_blk - g_blk[0], np.arange(g_blk[-1] - g_blk[0] + 2)
            )
            bc = bx.tocsc()
            for gi in range(g_blk[-1] - g_blk[0] + 1):
                lo, hi = int(bounds[gi]), int(bounds[gi + 1])
                if hi <= lo:
                    continue
                sub = bc[:, lo:hi].tocsr()
                ent = categorical_mapping(sub, mapper)
                if ent is not None:
                    mappings.append((ent, hi - lo, offset + lo))
                elif allow_side:
                    side_cols.extend(range(lo, hi))
                else:
                    return None
        elif allow_side:
            # ungrouped non-one-hot block: the whole block is one
            # entity+attribute table
            side_cols = list(range(b.feature_size))
        else:
            return None
        if side_cols:
            side_cols_a = np.asarray(side_cols, dtype=np.int64)
            Xs = bx.tocsc()[:, side_cols_a].tocsr()
            side_specs.append(
                (
                    mapper.astype(np.int64),
                    b.block_size,
                    Xs,
                    offset + side_cols_a,
                )
            )
        offset += b.feature_size
    if not mappings and not side_specs:
        return None
    return mappings, side_specs, n_rows, n_features, grouping


def try_compile_categorical(
    X: Optional[sps.spmatrix],
    blocks: Sequence,
    grouping: Optional[np.ndarray],
    n_groups: Optional[int],
    dtype,
    rank: int = 32,
    max_inflation: float = 4.0,
    allow_side: bool = False,
    fixed_ts: Optional[Tuple[int, int]] = None,
) -> Optional[CategoricalPlan]:
    """Compile the fast-path plan, or None if any table is neither
    one-hot nor (with ``allow_side``) an entity+attribute block.
    Mirrors compile_design's grouping semantics.  ``fixed_ts`` pins
    every table's (T, S)."""
    dtype = np.dtype(dtype)
    extracted = extract_categorical_mappings(
        X, blocks, grouping, dtype, allow_side=allow_side
    )
    if extracted is None:
        return None
    mappings, side_specs, n_rows, n_features, grouping = extracted

    if grouping is None:
        grouping = np.zeros(n_features, dtype=np.int32)
        n_groups = 1
    else:
        grouping = np.asarray(grouping, dtype=np.int32)
        if n_groups is None:
            n_groups = int(grouping.max()) + 1 if grouping.size else 1
    group_counts = np.bincount(grouping, minlength=n_groups).astype(dtype)

    tables = []
    side: List[Optional[SideInfo]] = []
    for ent, B, off in mappings:
        tab = compile_categorical_table(
            ent, B, off, n_rows, dtype, rank=rank,
            max_inflation=max_inflation, fixed_ts=fixed_ts,
        )
        if tab is None:
            return None
        tables.append(tab)
        side.append(None)
    for ent, B, Xs, col_ids in side_specs:
        info = compile_side_info(Xs, col_ids, n_features, dtype)
        if info is None:
            return None
        tab = compile_categorical_table(
            ent, B, int(col_ids[0]), n_rows, dtype, rank=rank,
            max_inflation=max_inflation, fixed_ts=fixed_ts,
        )
        if tab is None:
            return None
        tables.append(tab)
        side.append(info)
    tables = tuple(tables)

    # cross-table entity maps in each table's tile-row order — pure
    # device gathers of the already-uploaded per-table mappings (no
    # [NT]-sized host↔device traffic per table pair)
    cross_ent = []
    for t in tables:
        row = []
        for t2 in tables:
            if t2 is t:
                row.append(t.ent_of_tile_row)
                continue
            ent2_pad = jnp.concatenate(
                [t2.ent_main,
                 jnp.asarray([t2.n_cols], jnp.int32)]
            )
            row.append(ent2_pad[jnp.minimum(t.src, n_rows)])
        cross_ent.append(tuple(row))

    return CategoricalPlan(
        tables=tables,
        cross_ent=tuple(cross_ent),
        group_index=jnp.asarray(grouping),
        group_counts=jnp.asarray(group_counts),
        row_mask=None,
        side=tuple(side),
        n_rows=n_rows,
        n_features=n_features,
        n_groups=int(n_groups),
    )
