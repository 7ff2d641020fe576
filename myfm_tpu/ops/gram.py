"""Per-entity Gram matrices over entity-sorted row tiles.

The categorical fast path (ops/categorical.py, ops/categorical_vi.py)
needs, per table pass, for every entity u of the table

    G_u = sum_{rows n of u} z_n[:rows] z_n^T,   z_n = [1 | e_n | Z_n]

where Z_n is the sum of the OTHER tables' factor-like columns at row n
(φ for Gibbs; φ | σ | τ for CAVI) and e_n the residual rebuilt from all
tables' [lin | body | qs] rows (w0 excluded: consumers apply the exact
rank-1 correction).  Rows are packed by design_categorical into tiles
of T rows holding at most S entities each, sorted by entity, so every
(tile, slot) pair is one contiguous row segment.

Two implementations produce the per-(tile, slot) partial Grams of one
chunk of tiles; a scatter-add by the (tile, slot) → entity map
(``ent_slots``) sums the partials of entities that span tiles:

* ``"xla"`` — plain jnp: gathers, z, and one batched
  ``einsum("kts,ktd,kte->ksde")`` at HIGHEST precision.  It is also the
  reference the kernel is tested against.
* ``"triton"`` — a Pallas kernel through Triton, one program per
  (tile, slot) segment.  It gathers the source rows, builds z in
  registers and accumulates the segment's Gram with full-float32 dots,
  so neither z nor the slot-expanded operand is written to memory.
* ``"interpret"`` — the same kernel under the Pallas interpreter, for
  the CPU tests only.

``choose_impl`` is the one place that maps a platform to an
implementation; the trainers ask it and nothing else falls back.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_HI = lax.Precision.HIGHEST

IMPLS = ("xla", "triton", "interpret")

# Rows per inner block of the kernel (Triton dots need every dim >= 16).
KERNEL_ROWS = 32
# The kernel keeps its [Rp, n_body*Rp] accumulator in registers; past
# this many floats a program spills, so wider Grams take the plain path.
KERNEL_MAX_ACC = 128 * 128


def _pow2_at_least(n: int, lo: int = 16) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def kernel_fits(rank: int, n_body: int = 1) -> bool:
    """Whether the kernel's register accumulator holds this Gram."""
    rp = _pow2_at_least(rank)
    return rank > 0 and n_body * rp * rp <= KERNEL_MAX_ACC


def platform_of(x: jax.Array) -> str:
    """Platform of the device holding ``x``: trainers choose the Gram
    for where their data lives, which a ``jax.default_device`` scope
    can move off the default backend."""
    return next(iter(x.devices())).platform


def choose_impl(dtype, rank: int, n_body: int = 1,
                platform: Optional[str] = None) -> str:
    """Gram implementation for this platform and Gram width.

    The CPU runs the plain path.  The GPU runs the kernel for float32
    Grams whose accumulator fits (``kernel_fits``) and the plain path
    otherwise (float64, or very wide CAVI Grams).  Any other platform
    is an error — there is no silent fallback.  ``platform`` defaults
    to JAX's default backend."""
    if platform is None:
        platform = jax.default_backend()
    if platform == "cpu":
        return "xla"
    if platform == "gpu":
        if jnp.dtype(dtype) == jnp.float32 and kernel_fits(rank, n_body):
            return "triton"
        return "xla"
    raise ValueError(
        f"no Gram implementation for platform {platform!r}"
    )


# ----------------------------------------------------------------------
# plain path


def _z_rows(own_src, own_idx, other_srcs, other_idx, tau, valid, rank):
    """z = [1 | e | Z_other] at the given rows ([n, 2 + n_z])."""
    dtype = own_src.dtype
    n = own_idx.shape[0]
    own = own_src[own_idx]  # [n, 2+R]: [lin | V | qs]
    n_z = other_srcs[0].shape[1] - 2 if other_srcs else rank
    lin = own[:, 0]
    qs = own[:, 1 + rank]
    Z = jnp.zeros((n, n_z), dtype)
    for src, idx in zip(other_srcs, other_idx):
        g = src[idx]
        lin = lin + g[:, 0]
        Z = Z + g[:, 1 : 1 + n_z]
        qs = qs + g[:, 1 + n_z]
    qf = Z[:, :rank] + own[:, 1 : 1 + rank]
    e = (lin - tau + 0.5 * (jnp.sum(qf * qf, axis=1) - qs)) * valid
    return jnp.concatenate([valid[:, None], e[:, None], Z], axis=1)


def tile_grams_reference(own_src, own_idx, other_srcs, other_idx, tau,
                         slot, S: int, rank: int):
    """Plain-jnp partial Grams of one chunk: [Kc, S, 2+R, 2+n_z].

    ``own_idx``/``other_idx``/``tau``/``slot`` are [Kc, T]; pad rows
    carry slot == S (and pad ids, which gather zero rows)."""
    Kc, T = slot.shape
    dtype = own_src.dtype
    valid = (slot < S).astype(dtype).reshape(-1)
    z = _z_rows(
        own_src, own_idx.reshape(-1), other_srcs,
        [i.reshape(-1) for i in other_idx], tau.reshape(-1), valid, rank,
    ).reshape(Kc, T, -1)
    m = jax.nn.one_hot(slot, S, dtype=dtype)  # pad rows: all-zero
    return jnp.einsum(
        "kts,ktd,kte->ksde", m, z[:, :, : 2 + rank], z, precision=_HI
    )


# ----------------------------------------------------------------------
# Triton kernel


def _gram_kernel(seg_ref, tau_ref, own_idx_ref, own_src_ref, *refs,
                 n_other: int, T: int, Rp: int, nb: int):
    """One program = one (tile, slot) row segment.

    Loops over the tile's KERNEL_ROWS-row blocks that meet the segment;
    per block gathers every table's [body | lin | qs] source rows,
    builds e and the other tables' body sum Z, and accumulates
    φᵀ[Z] (φ = Z's first block) with full-float32 dots plus the head
    sums (card, Σe, Σe², ΣZ, ΣeZ)."""
    idx_refs = refs[:n_other]
    src_refs = refs[n_other : 2 * n_other]
    pp_ref, hv_ref, hs_ref = refs[2 * n_other :]
    BT = KERNEL_ROWS if T >= KERNEL_ROWS else T
    k = pl.program_id(0)
    s = pl.program_id(1)
    lo = seg_ref[k, s, 0]
    n = seg_ref[k, s, 1]
    base = k * T
    dt = own_src_ref.dtype

    def body(b, carry):
        pp, hz, hez, card, se, se2 = carry
        r = b * BT + jnp.arange(BT)
        ones = ((r >= lo) & (r < lo + n)).astype(dt)
        start = base + b * BT
        tau = tau_ref[pl.ds(start, BT)]
        oi = own_idx_ref[pl.ds(start, BT)]
        v_own = own_src_ref[oi, pl.ds(0, Rp)]
        lin = own_src_ref[oi, Rp]
        qs = own_src_ref[oi, Rp + 1]
        Z = [jnp.zeros((BT, Rp), dt) for _ in range(nb)]
        for c in range(n_other):
            ic = idx_refs[c][pl.ds(start, BT)]
            for j in range(nb):
                Z[j] = Z[j] + src_refs[c][ic, pl.ds(j * Rp, Rp)]
            lin = lin + src_refs[c][ic, nb * Rp]
            qs = qs + src_refs[c][ic, nb * Rp + 1]
        qf = Z[0] + v_own
        e = (lin - tau + 0.5 * (jnp.sum(qf * qf, axis=1) - qs)) * ones
        Zm = [z * ones[:, None] for z in Z]
        # φᵀ Z_j in the operands' dtype (pl.dot would force a float32
        # result, which the float64 interpret-mode tests must not get)
        pp = tuple(
            pp[j] + lax.dot_general(
                Zm[0], Zm[j], (((0,), (0,)), ((), ())),
                precision=_HI, preferred_element_type=dt,
            )
            for j in range(nb)
        )
        hz = tuple(hz[j] + jnp.sum(Zm[j], axis=0) for j in range(nb))
        hez = tuple(
            hez[j] + jnp.sum(e[:, None] * Zm[j], axis=0)
            for j in range(nb)
        )
        return (pp, hz, hez, card + jnp.sum(ones), se + jnp.sum(e),
                se2 + jnp.sum(e * e))

    zero_v = tuple(jnp.zeros((Rp,), dt) for _ in range(nb))
    zero = jnp.zeros((), dt)
    carry0 = (
        tuple(jnp.zeros((Rp, Rp), dt) for _ in range(nb)),
        zero_v, zero_v, zero, zero, zero,
    )
    pp, hz, hez, card, se, se2 = lax.fori_loop(
        lo // BT, (lo + n + BT - 1) // BT, body, carry0
    )
    for j in range(nb):
        pp_ref[k, s, :, pl.ds(j * Rp, Rp)] = pp[j]
        hv_ref[k, s, 0, pl.ds(j * Rp, Rp)] = hz[j]
        hv_ref[k, s, 1, pl.ds(j * Rp, Rp)] = hez[j]
    i4 = jnp.arange(4)
    hs_ref[k, s, :] = jnp.where(
        i4 == 0, card, jnp.where(i4 == 1, se, jnp.where(i4 == 2, se2, 0.0))
    )


def _pad_blocks(src, rank: int, nb: int, Rp: int):
    """[lin | nb body blocks of width rank | qs] -> [nb blocks of width
    Rp | lin | qs] (the kernel's power-of-two gather layout)."""
    pad = [(0, 0), (0, Rp - rank)]
    blocks = [
        jnp.pad(src[:, 1 + j * rank : 1 + (j + 1) * rank], pad)
        for j in range(nb)
    ]
    return jnp.concatenate(
        blocks + [src[:, :1], src[:, -1:]], axis=1
    )


def tile_grams_kernel(own_src, own_idx, other_srcs, other_idx, tau,
                      seg, S: int, rank: int, interpret: bool = False):
    """Kernel partial Grams of one chunk: same contract as
    ``tile_grams_reference`` but with the (start, length) segment table
    ``seg`` [Kc, S, 2] in place of the per-row slots."""
    Kc, T = own_idx.shape
    n_z = other_srcs[0].shape[1] - 2 if other_srcs else rank
    nb = n_z // rank
    Rp = _pow2_at_least(rank)
    own_p = _pad_blocks(own_src, rank, 1, Rp)
    srcs_p = [_pad_blocks(s_, rank, nb, Rp) for s_ in other_srcs]
    num_warps = 4 if nb * Rp * Rp <= 64 * 64 else 8
    dt = own_src.dtype
    pp, hv, hs = pl.pallas_call(
        functools.partial(
            _gram_kernel, n_other=len(other_srcs), T=T, Rp=Rp, nb=nb
        ),
        out_shape=(
            jax.ShapeDtypeStruct((Kc, S, Rp, nb * Rp), dt),
            jax.ShapeDtypeStruct((Kc, S, 2, nb * Rp), dt),
            jax.ShapeDtypeStruct((Kc, S, 4), dt),
        ),
        grid=(Kc, S),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        interpret=interpret,
        name="fastpath_tile_gram",
    )(
        seg, tau.reshape(-1), own_idx.reshape(-1), own_p,
        *[i.reshape(-1) for i in other_idx], *srcs_p,
    )

    def unpad(x):  # [..., nb*Rp] -> [..., n_z]
        return jnp.concatenate(
            [x[..., j * Rp : j * Rp + rank] for j in range(nb)], axis=-1
        )

    hz = unpad(hv[:, :, 0])  # [Kc, S, n_z]
    hez = unpad(hv[:, :, 1])
    card, se, se2 = hs[..., 0:1], hs[..., 1:2], hs[..., 2:3]
    row0 = jnp.concatenate([card, se, hz], axis=-1)
    row1 = jnp.concatenate([se, se2, hez], axis=-1)
    body = jnp.concatenate(
        [hz[..., :rank, None], hez[..., :rank, None],
         unpad(pp[:, :, :rank, :])],
        axis=-1,
    )  # [Kc, S, R, 2+n_z]
    return jnp.concatenate([row0[:, :, None], row1[:, :, None], body],
                           axis=2)


# ----------------------------------------------------------------------
# table-level driver


def table_gram(
    own_src: jax.Array,  # [B+1, 2+R] own [lin | V | qs] rows (pad row 0)
    own_idx: jax.Array,  # [NT] own entity per tile row (pad = B)
    other_srcs: Sequence[jax.Array],  # each [B2+1, 2+n_z]
    other_idx: Sequence[jax.Array],  # each [NT] (pad = B2)
    tau: jax.Array,  # [NT] target in tile order (pad 0)
    slot: jax.Array,  # [NT] slot within tile (pad = S)
    seg: jax.Array,  # [K, S, 2] (start, length) per (tile, slot)
    ent_slots: jax.Array,  # [K, S] entity per (tile, slot) (pad = B)
    *,
    rank: int,
    n_entities: int,
    tile_rows: int,
    tile_entities: int,
    chunk_tiles: int,
    impl: str,
) -> jax.Array:
    """All-entity Grams [B, 2+R, 2+n_z] of one table pass.

    Tiles are consumed ``chunk_tiles`` at a time (bounding the partial
    Grams and, on the plain path, the [chunk, D] temporaries); each
    chunk's partials are scatter-added into G by ``ent_slots``, which
    sums the pieces of entities that span tiles or chunks."""
    if impl not in IMPLS:
        raise ValueError(f"unknown Gram implementation {impl!r}")
    T, S, Kc = tile_rows, tile_entities, chunk_tiles
    K = ent_slots.shape[0]
    B = n_entities
    n_z = other_srcs[0].shape[1] - 2 if other_srcs else rank
    dtype = own_src.dtype
    n_chunks = -(-K // Kc)
    Kp = n_chunks * Kc

    def pad_k(arr, fill, tile_shape):
        flat = arr.reshape((K,) + tile_shape)
        if Kp != K:
            pad = jnp.full((Kp - K,) + tile_shape, fill, flat.dtype)
            flat = jnp.concatenate([flat, pad])
        return flat.reshape((n_chunks, Kc) + tile_shape)

    xs = dict(
        own_idx=pad_k(own_idx, B, (T,)),
        other_idx=[
            pad_k(i, s_.shape[0] - 1, (T,))
            for i, s_ in zip(other_idx, other_srcs)
        ],
        tau=pad_k(tau, 0.0, (T,)),
        slot=pad_k(slot, S, (T,)),
        seg=pad_k(seg, 0, (S, 2)),
        ent=pad_k(ent_slots, B, (S,)),
    )

    def chunk(G, xc):
        if impl == "xla":
            part = tile_grams_reference(
                own_src, xc["own_idx"], other_srcs, xc["other_idx"],
                xc["tau"], xc["slot"], S, rank,
            )
        else:
            part = tile_grams_kernel(
                own_src, xc["own_idx"], other_srcs, xc["other_idx"],
                xc["tau"], xc["seg"], S, rank,
                interpret=(impl == "interpret"),
            )
        G = G.at[xc["ent"].reshape(-1)].add(
            part.reshape(Kc * S, 2 + rank, 2 + n_z),
            mode="drop",
        )
        return G, None

    G = jnp.zeros((B, 2 + rank, 2 + n_z), dtype)
    if n_chunks == 1:
        G, _ = chunk(G, jax.tree_util.tree_map(lambda a: a[0], xs))
    else:
        G, _ = lax.scan(chunk, G, xs)
    return G
