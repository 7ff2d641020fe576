"""Multi-chip SPMD execution of the Gibbs sweep.

The reference has no distributed path at all (SURVEY §2: std::thread at
inference only).  Here the whole training step runs under ``shard_map``
over a 1-D ``('data',)`` mesh:

* per-row state (residuals e, factor sums q, the main-table COO
  entries, the block mappers, y) is sharded along rows;
* V, w and all hyperparameters are replicated — every device computes
  the identical weight draw from ``psum``-reduced per-feature
  statistics (same PRNG key ⇒ same Gaussian noise), so no weight
  traffic crosses the interconnect at all;
* RelationBlock tables (unique entities) are replicated; their per-
  block-row aggregates are psum-reduced partial segment sums.

Per sweep, the bytes on the wire are exactly the per-color feature
statistics — O(colors × (n_features + block_size)) floats — which ride
ICI as cheap all-reduces.  The sharded chain reproduces the single-chip
chain sample-for-sample (same noise, psum-reduced statistics), which
the parity tests assert on a virtual CPU mesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import sparse as sps

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map as _shard_map  # jax >= 0.7 style
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

from ..design import (
    BlockPlan,
    ColorPlan,
    ColorStack,
    DenseColor,
    DenseStack,
    DesignPlan,
    TablePlan,
    compile_design,
)
from ..ops.gibbs import GibbsConfig, GibbsState, gibbs_sweep, init_state
from ..ops.forward import predict_score
from ..relational import RelationBlock


def _np(x):
    return np.asarray(x)


def _partition_entries(rows, vals, seg, n_local, n_devices, extra=None):
    """Split entry arrays by row shard; relabel rows locally; pad each
    shard to the common max with zero-valued entries."""
    rows = _np(rows)
    vals = _np(vals)
    seg = _np(seg)
    shard_of = np.minimum(rows // n_local, n_devices - 1)
    # padding entries (val == 0) can go anywhere; keep them on shard 0
    order = np.argsort(shard_of, kind="stable")
    bounds = np.searchsorted(shard_of[order], np.arange(n_devices + 1))
    max_len = max(
        8, int(np.max(bounds[1:] - bounds[:-1])) if len(rows) else 8
    )
    max_len = ((max_len + 7) // 8) * 8
    out_rows = np.zeros((n_devices, max_len), dtype=rows.dtype)
    out_vals = np.zeros((n_devices, max_len), dtype=vals.dtype)
    pad_seg = seg.max() if seg.size else 0
    out_seg = np.full((n_devices, max_len), pad_seg, dtype=seg.dtype)
    for d in range(n_devices):
        sl = order[bounds[d] : bounds[d + 1]]
        m = len(sl)
        out_rows[d, :m] = rows[sl] - d * n_local
        out_vals[d, :m] = vals[sl]
        out_seg[d, :m] = seg[sl]
    return out_rows, out_vals, out_seg


def _rep(x, n_devices):
    """Mark replicated (no leading device axis needed — spec P())."""
    return x


def shard_design(
    X: Optional[sps.spmatrix],
    blocks: Sequence[RelationBlock],
    grouping: Optional[np.ndarray],
    n_devices: int,
    dtype=np.float32,
    strategy: str = "auto",
    max_unrolled_colors: int = 16,
    joint_dense: bool = False,
    joint_rank: Optional[int] = None,
) -> Tuple[DesignPlan, DesignPlan, np.ndarray]:
    """Compile globally, then shard by rows.

    Returns (stacked_plan, spec_plan, row_mask_global): the stacked plan
    has a leading device axis on sharded leaves; spec_plan mirrors its
    structure with PartitionSpecs for shard_map in_specs.
    """
    plan = compile_design(
        X, blocks, grouping=grouping, dtype=dtype, strategy=strategy,
        max_unrolled_colors=max_unrolled_colors, for_training=True,
        joint_dense=joint_dense, joint_rank=joint_rank,
    )
    n = plan.n_rows
    n_local = -(-n // n_devices)  # ceil
    n_pad = n_local * n_devices
    mask = np.zeros(n_pad, dtype=dtype)
    mask[:n] = 1.0

    data2 = P("data")  # leading device axis consumed by shard_map
    rep = P()

    def shard_color(c: ColorPlan, local_rows: bool):
        if local_rows:
            r, v, s = _partition_entries(
                c.rows, c.vals, c.seg, n_local, n_devices
            )
            return (
                ColorPlan(
                    rows=jnp.asarray(r.reshape(-1)),
                    vals=jnp.asarray(v.reshape(-1)),
                    seg=jnp.asarray(s.reshape(-1)),
                    feat=c.feat, sx2=c.sx2,
                ),
                ColorPlan(
                    rows=data2, vals=data2, seg=data2, feat=rep, sx2=rep
                ),
            )
        return c, ColorPlan(rows=rep, vals=rep, seg=rep, feat=rep, sx2=rep)

    def shard_stack(cs: Optional[ColorStack], local_rows: bool):
        if cs is None:
            return None, None
        if not local_rows:
            return cs, ColorStack(
                rows=rep, vals=rep, seg=rep, feat=rep, sx2=rep
            )
        rows = _np(cs.rows)
        vals = _np(cs.vals)
        seg = _np(cs.seg)
        C = rows.shape[0]
        parts = [
            _partition_entries(rows[i], vals[i], seg[i], n_local, n_devices)
            for i in range(C)
        ]
        max_len = max(p[0].shape[1] for p in parts)

        def pad(p, fill, dt):
            out = np.full((n_devices, max_len), fill, dtype=dt)
            out[:, : p.shape[1]] = p
            return out

        r = np.stack(
            [pad(p[0], 0, rows.dtype) for p in parts], axis=1
        )  # [D, C, Pe] -> flat [D*C, Pe] (contiguous per-device chunks)
        v = np.stack([pad(p[1], 0, vals.dtype) for p in parts], axis=1)
        s = np.stack(
            [pad(p[2], int(seg.max()) if seg.size else 0, seg.dtype)
             for p in parts],
            axis=1,
        )
        stacked = ColorStack(
            rows=jnp.asarray(r.reshape(n_devices * C, -1)),
            vals=jnp.asarray(v.reshape(n_devices * C, -1)),
            seg=jnp.asarray(s.reshape(n_devices * C, -1)),
            feat=cs.feat, sx2=cs.sx2,
        )
        spec = ColorStack(rows=data2, vals=data2, seg=data2, feat=rep,
                          sx2=rep)
        return stacked, spec

    # --- main table: rows sharded -------------------------------------
    mr, mv, ms = _partition_entries(
        plan.main.coo_row,
        plan.main.coo_val,
        plan.main.coo_col,  # reuse partitioner: 'seg' slot carries cols
        n_local,
        n_devices,
    )
    # coo_col padding must stay out-of-range (n_features)
    col_pad = plan.n_features
    ms = np.where(_np(mv) == 0.0, col_pad, ms).astype(np.int32)

    main_colors = [shard_color(c, True) for c in plan.main.colors]
    main_stack, main_stack_spec = shard_stack(plan.main.color_stack, True)
    main = TablePlan(
        coo_row=jnp.asarray(mr.reshape(-1)),
        coo_col=jnp.asarray(np.asarray(ms).reshape(-1)),
        coo_val=jnp.asarray(mv.reshape(-1)),
        colors=tuple(c for c, _ in main_colors),
        color_stack=main_stack,
        col_offset=plan.main.col_offset,
        n_cols=plan.main.n_cols,
    )
    main_spec = TablePlan(
        coo_row=data2,
        coo_col=data2,
        coo_val=data2,
        colors=tuple(s for _, s in main_colors),
        color_stack=main_stack_spec,
        col_offset=plan.main.col_offset,
        n_cols=plan.main.n_cols,
    )

    # --- blocks: tables replicated, mapper sharded --------------------
    out_blocks = []
    out_block_specs = []
    for b in plan.blocks:
        mapper = np.full(n_pad, b.block_size, dtype=np.int32)
        mapper[:n] = _np(b.mapper)
        mapper = mapper.reshape(n_devices, n_local)
        bp = BlockPlan(
            coo_row=b.coo_row,
            coo_col=b.coo_col,
            coo_val=b.coo_val,
            colors=b.colors,
            color_stack=b.color_stack,
            mapper=jnp.asarray(mapper.reshape(-1)),
            cardinality=b.cardinality,
            col_offset=b.col_offset,
            n_cols=b.n_cols,
            block_size=b.block_size,
            dense_colors=b.dense_colors,
            dense_stack=b.dense_stack,
        )
        spec_colors = tuple(
            ColorPlan(rows=rep, vals=rep, seg=rep, feat=rep, sx2=rep)
            for _ in b.colors
        )
        spec_stack = (
            None
            if b.color_stack is None
            else ColorStack(rows=rep, vals=rep, seg=rep, feat=rep, sx2=rep)
        )
        bs = BlockPlan(
            coo_row=rep,
            coo_col=rep,
            coo_val=rep,
            colors=spec_colors,
            color_stack=spec_stack,
            mapper=data2,
            cardinality=rep,
            col_offset=b.col_offset,
            n_cols=b.n_cols,
            block_size=b.block_size,
            dense_colors=tuple(
                DenseColor(
                    xw=rep, segb=rep, feat=rep,
                    id_xw=None if dc.id_xw is None else rep,
                    id_feat=None if dc.id_feat is None else rep,
                )
                for dc in b.dense_colors
            ),
            dense_stack=(
                None
                if b.dense_stack is None
                else DenseStack(xw=rep, segb=rep, feat=rep)
            ),
        )
        out_blocks.append(bp)
        out_block_specs.append(bs)

    stacked = DesignPlan(
        main=main,
        blocks=tuple(out_blocks),
        group_index=plan.group_index,
        group_counts=plan.group_counts,
        row_mask=jnp.asarray(mask),
        n_rows=n_local,
        n_features=plan.n_features,
        n_groups=plan.n_groups,
    )
    specs = DesignPlan(
        main=main_spec,
        blocks=tuple(out_block_specs),
        group_index=rep,
        group_counts=rep,
        row_mask=data2,
        n_rows=n_local,
        n_features=plan.n_features,
        n_groups=plan.n_groups,
    )
    return stacked, specs, mask


class ShardedGibbsTrainer:
    """Data-parallel Gibbs trainer over a ('data',) device mesh."""

    @property
    def engine_name(self) -> str:
        return "joint" if self.cfg.joint_rows else "colored"

    def __init__(
        self,
        X,
        X_rel: Sequence[RelationBlock],
        y: np.ndarray,
        cfg: GibbsConfig,
        rank: int,
        init_stdev: float,
        random_seed: int,
        mesh: Optional[Mesh] = None,
        grouping: Optional[np.ndarray] = None,
        dtype=np.float32,
        strategy: str = "auto",
        max_unrolled_colors: int = 16,
        joint_auto: bool = False,
    ):
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), ("data",))
        self.mesh = mesh
        n_devices = mesh.devices.size
        self.dtype = np.dtype(dtype)
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed

        self.plan, self.specs, mask = shard_design(
            X, X_rel, grouping, n_devices, dtype=self.dtype,
            strategy=strategy, max_unrolled_colors=max_unrolled_colors,
            joint_dense=cfg.joint_rows or joint_auto,
            joint_rank=rank,
        )
        from ..design import joint_auto_eligible

        if joint_auto and not cfg.joint_rows and joint_auto_eligible(
            self.plan, rank, self.dtype
        ):
            # the estimator-level "auto" upgrade (gibbs._train_core):
            # identical gates, so sharded == single-chip engine choice
            cfg = dataclasses.replace(cfg, joint_rows=True)
        self.cfg = dataclasses.replace(
            cfg, axis_name="data", n_devices=n_devices,
        )
        n_pad = mask.shape[0]
        y_pad = np.zeros(n_pad, dtype=self.dtype)
        y_arr = np.asarray(y).astype(self.dtype)
        y_pad[: y_arr.shape[0]] = y_arr
        self.y = jnp.asarray(y_pad)
        ordered = cfg.task == "ordered"
        if ordered:
            yi = np.zeros(n_pad, dtype=np.int32)
            yi[: y_arr.shape[0]] = np.asarray(y, dtype=np.int32)
            self.y_int = jnp.asarray(yi)
        else:
            self.y_int = None

        state_spec = GibbsState(
            w0=P(), w=P(), V=P(), e=P("data"), alpha=P(),
            mu_w=P(), lambda_w=P(), mu_V=P(), lambda_V=P(),
            cutpoints=P() if ordered else None,
            oprobit_alpha=P() if ordered else None,
            n_mh_accept=P() if ordered else None,
        )
        cfg_static = self.cfg

        def step(plan, state, y, key):
            return gibbs_sweep(plan, state, y, key, cfg_static)

        self._sweep = jax.jit(
            _shard_map(
                step,
                mesh=self.mesh,
                in_specs=(self.specs, state_spec, P("data"), P()),
                out_specs=state_spec,
                check_vma=False,
            ),
            donate_argnums=(1,),
        )

        def init_e(plan, state, y):
            # reference initialize_e (FMTrainer.hpp:99-119): e = score−y
            # for regression and ±1-coded classification
            score = predict_score(plan, state.w0, state.w, state.V)
            return (score - y) * plan.row_mask

        init_spec = dataclasses.replace(
            state_spec,
            cutpoints=None, oprobit_alpha=None, n_mh_accept=None,
        )
        self._init_e = jax.jit(
            _shard_map(
                init_e,
                mesh=self.mesh,
                in_specs=(self.specs, init_spec, P("data")),
                out_specs=P("data"),
                check_vma=False,
            )
        )

        if ordered:
            from ..ops.oprobit import init_oprobit_groups

            n_devices_ = n_devices
            cp_groups = cfg_static.cutpoint_group_classes

            def init_ordered(plan, state, y, key):
                score = predict_score(
                    plan, state.w0, state.w, state.V
                )
                n_local = score.shape[0]
                tiny = jnp.finfo(score.dtype).tiny
                u_global = jax.random.uniform(
                    key, (n_local * n_devices_,), dtype=score.dtype,
                    minval=tiny, maxval=1.0,
                )
                idx = jax.lax.axis_index("data")
                u = jax.lax.dynamic_slice(
                    u_global, (idx * n_local,), (n_local,)
                )
                alpha_hat, gamma, e = init_oprobit_groups(
                    score, y, key, cp_groups, cfg_static.reg_0,
                    weight=plan.row_mask, axis="data", u=u,
                )
                return dataclasses.replace(
                    state, e=e, cutpoints=gamma,
                    oprobit_alpha=alpha_hat,
                    n_mh_accept=jnp.zeros(
                        (len(cp_groups),), jnp.int32
                    ),
                )

            self._init_ordered = jax.jit(
                _shard_map(
                    init_ordered,
                    mesh=self.mesh,
                    in_specs=(
                        self.specs, init_spec, P("data"), P()
                    ),
                    out_specs=state_spec,
                    check_vma=False,
                )
            )

    @property
    def n_features(self) -> int:
        return self.plan.n_features

    def _initialize(self, state_key):
        # identical key schedule to GibbsTrainer._initialize so the
        # sharded chain matches the single-chip chain exactly
        k_init, k_e = jax.random.split(state_key)
        state = init_state(
            self.plan, self.rank, self.init_stdev, k_init, self.cfg,
            self.dtype,
        )
        # init_state sized e per-device; the outer view is the global
        # padded vector
        n_pad = int(self.y.shape[0])
        state = dataclasses.replace(
            state, e=jnp.zeros((n_pad,), self.dtype)
        )
        if self.cfg.task == "ordered":
            state = self._init_ordered(
                self.plan, state, self.y_int, k_e
            )
        else:
            e = self._init_e(self.plan, state, self.y)
            state = dataclasses.replace(state, e=e)
        return state

    def _sweep_call(self, state, key):
        y_arg = self.y_int if self.cfg.task == "ordered" else self.y
        return self._sweep(self.plan, state, y_arg, key)

    def run(
        self,
        n_iter: int,
        n_kept_samples: int,
        callback=None,
        checkpoint_path=None,
        checkpoint_every: int = 0,
        resume: bool = False,
    ):
        """Same contract as GibbsTrainer.run: (Predictor, History) with
        callbacks, hyper trace, and checkpointing — multi-chip training
        is a normal estimator feature, not a bare tuple API."""
        from ..trainer import run_mcmc_loop

        return run_mcmc_loop(
            self, n_iter, n_kept_samples, callback, checkpoint_path,
            checkpoint_every, resume,
        )
