"""Multi-chip SPMD execution of the categorical fast path.

Rows partition contiguously across the ('data',) mesh.  Each device
gets its own sorted-tile layout (compiled per shard with a COMMON
(T, S) tiling and padded to common tile counts, so the stacked plan has
one static shape); weights, hyperparameters and PRNG keys are
replicated.  Per table, each device computes partial per-entity Gram
matrices over its rows; one ``psum`` per table turns them into the
global statistics, after which every device performs the identical
entity-space draws — zero weight traffic, one [B, D, D] all-reduce per
table per sweep.

The sharded chain equals the single-chip chain up to float
reassociation of the Gram partials (asserted with tight tolerances in
tests/test_sharded.py on the virtual CPU mesh).  The reference has no
distributed execution at all (SURVEY §2); its single-process semantics
is the correctness oracle.
"""

from __future__ import annotations

import dataclasses
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

from ..design_categorical import (
    CategoricalPlan,
    CategoricalTable,
    choose_tiling,
    compile_categorical_table,
    compile_side_info,
    extract_categorical_mappings,
)
from ..ops.categorical import (
    CategoricalState,
    categorical_sweep,
    init_categorical_state,
    make_y_tiles,
)
from ..ops.gibbs import GibbsConfig, GibbsState, init_state
from ..ops.gram import choose_impl


def compile_sharded_categorical(
    X,
    blocks: Sequence,
    grouping: Optional[np.ndarray],
    n_devices: int,
    dtype,
    rank: int,
    allow_side: bool = False,
) -> Optional[Tuple[CategoricalPlan, np.ndarray]]:
    """Per-device fast-path plans stacked on a leading device axis.

    Returns (stacked_plan, y_row_bounds) or None when the design is not
    categorical.  The stacked plan's array leaves all carry a leading
    [n_devices] axis (consumed by shard_map); its static meta is shared:
    per-device row count = ceil(N / n_devices) with the tail masked.

    Entity+attribute tables shard like any other table (their tile
    layouts cover each device's row slice); the SideInfo payloads are
    shared (replicated) and are attached to the stacked plan by the
    caller with replicated partition specs — every device then runs the
    identical side-color scan on the psum'd global Gram.
    """
    dtype = np.dtype(dtype)
    extracted = extract_categorical_mappings(
        X, blocks, grouping, dtype, allow_side=allow_side
    )
    if extracted is None:
        return None
    mappings, side_specs, n_rows, n_features, grouping = extracted
    # unify: side tables are tiled exactly like one-hot tables (their
    # entities are the block rows); col_offset is only a label for them
    mappings = list(mappings) + [
        (ent, B, int(col_ids[0])) for ent, B, _Xs, col_ids in side_specs
    ]
    n_plain = len(mappings) - len(side_specs)
    side_infos = [
        compile_side_info(Xs, col_ids, n_features, dtype)
        for _ent, _B, Xs, col_ids in side_specs
    ]
    if any(si is None for si in side_infos):
        return None

    if grouping is None:
        grouping = np.zeros(n_features, dtype=np.int32)
    n_groups = int(grouping.max()) + 1 if grouping.size else 1
    group_counts = np.bincount(grouping, minlength=n_groups).astype(dtype)

    n_local = -(-n_rows // n_devices)

    # one (T, S) per table, chosen from global cardinalities so every
    # shard agrees on it
    tilings = [
        choose_tiling(np.bincount(ent, minlength=B), rank)[:2]
        for ent, B, _ in mappings
    ]

    # compile per device with masked row padding
    dev_tables = []  # [n_dev][n_tables]
    for d in range(n_devices):
        lo, hi = d * n_local, min((d + 1) * n_local, n_rows)
        tabs = []
        for (ent, B, off), (T, S) in zip(mappings, tilings):
            ent_d = np.full(n_local, B, dtype=np.int64)
            ent_d[: hi - lo] = ent[lo:hi]
            tabs.append(
                compile_categorical_table(
                    ent_d, B, off, n_local, dtype, rank=rank,
                    fixed_ts=(T, S),
                )
            )
        dev_tables.append(tabs)

    # reconcile static shapes across devices: tile counts must match
    # for shard_map
    for ti in range(len(mappings)):
        k_max = max(dev_tables[d][ti].n_tiles for d in range(n_devices))
        for d in range(n_devices):
            t = dev_tables[d][ti]
            if t.n_tiles < k_max:
                (ent, B, off), (T, S) = mappings[ti], tilings[ti]
                lo, hi = d * n_local, min((d + 1) * n_local, n_rows)
                ent_d = np.full(n_local, B, dtype=np.int64)
                ent_d[: hi - lo] = ent[lo:hi]
                dev_tables[d][ti] = compile_categorical_table(
                    ent_d, B, off, n_local, dtype, rank=rank,
                    fixed_ts=(T, S), pad_tiles_to=k_max,
                )

    # per-device cross maps, then stack everything on a device axis
    def build_plan(d):
        tabs = tuple(dev_tables[d])
        lo, hi = d * n_local, min((d + 1) * n_local, n_rows)
        cross = []
        for t in tabs:
            src = np.asarray(t.src)
            row = []
            for t2, (ent2, B2, _o) in zip(tabs, mappings):
                if t2 is t:
                    row.append(t.ent_of_tile_row)
                    continue
                ent2_d = np.full(n_local + 1, B2, dtype=np.int64)
                ent2_d[: hi - lo] = ent2[lo:hi]
                row.append(
                    jnp.asarray(
                        ent2_d[np.minimum(src, n_local)].astype(
                            np.int32
                        )
                    )
                )
            cross.append(tuple(row))
        return CategoricalPlan(
            tables=tabs,
            cross_ent=tuple(cross),
            group_index=jnp.asarray(grouping),
            group_counts=jnp.asarray(group_counts),
            row_mask=None,
            n_rows=n_local,
            n_features=n_features,
            n_groups=n_groups,
            n_real=n_rows,
        )

    plans = [build_plan(d) for d in range(n_devices)]
    # concatenate every array leaf along axis 0: shard_map with
    # P('data') splits that axis back into the per-device arrays
    stacked = jax.tree_util.tree_map(
        lambda *leaves: jnp.concatenate(leaves, axis=0), *plans
    )
    if side_infos:
        stacked = dataclasses.replace(
            stacked,
            side=tuple([None] * n_plain + side_infos),
        )
    return stacked, n_local


class ShardedCategoricalGibbsTrainer:
    """Data-parallel fast-path Gibbs over a ('data',) device mesh."""

    engine_name = "fastpath"

    def __init__(
        self,
        X,
        X_rel: Sequence,
        y: np.ndarray,
        cfg: GibbsConfig,
        rank: int,
        init_stdev: float,
        random_seed: int,
        mesh: Optional[Mesh] = None,
        grouping: Optional[np.ndarray] = None,
        dtype=np.float32,
    ):
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), ("data",))
        self.mesh = mesh
        n_devices = mesh.devices.size
        self.dtype = np.dtype(dtype)
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed

        compiled = compile_sharded_categorical(
            X, X_rel, grouping, n_devices, self.dtype, rank,
            allow_side=bool(cfg.fit_linear),
        )
        if compiled is None:
            raise ValueError(
                "Design is not all-categorical; use ShardedGibbsTrainer."
            )
        self.plan, n_local = compiled
        self.cfg = dataclasses.replace(
            cfg, axis_name="data", n_devices=n_devices,
        )
        y_pad = np.zeros(n_local * n_devices, dtype=self.dtype)
        y_arr = np.asarray(y).astype(self.dtype)
        y_pad[: y_arr.shape[0]] = y_arr
        self.y = jnp.asarray(y_pad)
        if cfg.task == "ordered":
            yi = np.zeros(n_local * n_devices, dtype=np.int32)
            yi[: y_arr.shape[0]] = np.asarray(y, dtype=np.int32)
            self.y_int = jnp.asarray(yi)
        else:
            self.y_int = None

        # every plan leaf is row-sharded except the SideInfo payloads,
        # which are replicated (each device runs the identical side-
        # color scan on the psum'd global Gram)
        plan_spec = jax.tree_util.tree_map(
            lambda _: P("data"),
            dataclasses.replace(self.plan, side=()),
        )
        plan_spec = dataclasses.replace(
            plan_spec,
            side=jax.tree_util.tree_map(lambda _: P(), self.plan.side),
        )
        state_spec = CategoricalState(
            core=GibbsState(
                w0=P(), w=P(), V=P(), e=P("data"), alpha=P(),
                mu_w=P(), lambda_w=P(), mu_V=P(), lambda_V=P(),
                cutpoints=(
                    P() if cfg.task == "ordered" else None
                ),
                oprobit_alpha=(
                    P() if cfg.task == "ordered" else None
                ),
                n_mh_accept=(
                    P() if cfg.task == "ordered" else None
                ),
            ),
            tau=(None if cfg.task == "regression" else P("data")),
            sum_e=P(),
            sum_e2=P(),
        )
        cfg_static = self.cfg
        gram_impl = choose_impl(
            self.dtype, rank, platform=self.mesh.devices.flat[0].platform
        )
        self._gram_impl = gram_impl

        def sweep(plan, state, y, y_tiles, key):
            return categorical_sweep(
                plan, state, y, y_tiles, key, cfg_static, gram_impl
            )

        def init(plan, y, key):
            k_init, k_e = jax.random.split(key)
            core = init_state(
                plan, rank, init_stdev, k_init, cfg_static, self.dtype
            )
            return init_categorical_state(
                plan, core, y, k_e, cfg_static
            )

        y_tiles_spec = tuple(P("data") for _ in self.plan.tables)
        self._sweep = jax.jit(
            _shard_map(
                sweep,
                mesh=self.mesh,
                in_specs=(
                    plan_spec, state_spec, P("data"), y_tiles_spec, P()
                ),
                out_specs=state_spec,
                check_vma=False,
            ),
            donate_argnums=(1,),
        )
        self._init = jax.jit(
            _shard_map(
                init,
                mesh=self.mesh,
                in_specs=(plan_spec, P("data"), P()),
                out_specs=state_spec,
                check_vma=False,
            )
        )

        def tiles(plan, y):
            return make_y_tiles(plan, y)

        self._y_tiles = jax.jit(
            _shard_map(
                tiles,
                mesh=self.mesh,
                in_specs=(plan_spec, P("data")),
                out_specs=y_tiles_spec,
                check_vma=False,
            )
        )(self.plan, self.y)

    @property
    def n_features(self) -> int:
        return self.plan.n_features

    def _initialize(self, key):
        y_arg = self.y_int if self.cfg.task == "ordered" else self.y
        return self._init(self.plan, y_arg, key)

    def _sweep_call(self, state, key):
        y_arg = self.y_int if self.cfg.task == "ordered" else self.y
        return self._sweep(
            self.plan, state, y_arg, self._y_tiles, key
        )

    def run(
        self,
        n_iter: int,
        n_kept_samples: int,
        callback=None,
        checkpoint_path=None,
        checkpoint_every: int = 0,
        resume: bool = False,
    ):
        """Same contract as GibbsTrainer.run (Predictor, History)."""
        from ..trainer import run_mcmc_loop

        return run_mcmc_loop(
            self, n_iter, n_kept_samples, callback, checkpoint_path,
            checkpoint_every, resume, core_of=lambda s: s.core,
        )


class ShardedCategoricalVITrainer:
    """Data-parallel CAVI over a ('data',) device mesh (fast path).

    Same compile/spec machinery as the Gibbs trainer above; CAVI is
    deterministic, so sharded ≡ single-chip holds exactly (up to float
    reassociation of the psum'd Gram partials) with no RNG plumbing:
    per table, each device builds its rows' partial Gram, one
    psum/psum_scatter per table yields the global statistics, and every
    device performs the identical coordinate updates.  Inherits the
    run() contract of vi_trainer.CategoricalVITrainer (Predictor,
    History with ELBO trace).
    """

    def __init__(
        self,
        X,
        X_rel: Sequence,
        y: np.ndarray,
        cfg,  # VariationalConfig
        rank: int,
        init_stdev: float,
        random_seed: int,
        mesh: Optional[Mesh] = None,
        grouping: Optional[np.ndarray] = None,
        dtype=np.float32,
    ):
        from ..ops.categorical_vi import (
            CategoricalVIState,
            categorical_vi_sweep,
            init_categorical_vi_state,
        )
        from ..ops.gibbs import TASK_CLASSIFICATION
        from ..ops.variational import VIState, vi_init_state

        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), ("data",))
        self.mesh = mesh
        n_devices = mesh.devices.size
        self.dtype = np.dtype(dtype)
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed

        # the VI Gram carries 3R+2 z-columns — tile for that width
        compiled = compile_sharded_categorical(
            X, X_rel, grouping, n_devices, self.dtype,
            max(3 * rank, 1),
        )
        if compiled is None:
            # entity+attribute designs: the EA table's Gram carries
            # 4R+2 z-columns (ops/categorical_vi._vi_ea_table_pass) —
            # Grams psum whole, SideInfo replicated, updates identical
            # on every device
            compiled = compile_sharded_categorical(
                X, X_rel, grouping, n_devices, self.dtype,
                max(4 * rank, 1), allow_side=True,
            )
        if compiled is None:
            raise ValueError(
                "Multi-chip variational training requires an "
                "all-categorical or entity+attribute design."
            )
        self.plan, n_local = compiled
        self.cfg = dataclasses.replace(
            cfg, axis_name="data", n_devices=n_devices,
        )
        y_pad = np.zeros(n_local * n_devices, dtype=self.dtype)
        y_arr = np.asarray(y).astype(self.dtype)
        y_pad[: y_arr.shape[0]] = y_arr
        self.y = jnp.asarray(y_pad)

        is_classification = self.cfg.task == TASK_CLASSIFICATION
        plan_spec = jax.tree_util.tree_map(
            lambda _: P("data"),
            dataclasses.replace(self.plan, side=()),
        )
        plan_spec = dataclasses.replace(
            plan_spec,
            side=jax.tree_util.tree_map(lambda _: P(), self.plan.side),
        )
        rep = P()
        core_spec = VIState(
            w0=rep, w0_var=rep, w=rep, w_var=rep, V=rep, V_var=rep,
            e=P("data"), e_var_sum=rep, alpha=rep, alpha_rate=rep,
            mu_w=rep, mu_w_var=rep, lambda_w=rep, lambda_w_rate=rep,
            mu_V=rep, mu_V_var=rep, lambda_V=rep, lambda_V_rate=rep,
            elbo=rep,
        )
        state_spec = CategoricalVIState(
            core=core_spec,
            tau=(P("data") if is_classification else None),
        )
        cfg_static = self.cfg
        gram_impl = choose_impl(
            self.dtype, rank, n_body=4,
            platform=self.mesh.devices.flat[0].platform,
        )
        self._gram_impl = gram_impl

        def sweep(plan, state, y, y_tiles):
            return categorical_vi_sweep(
                plan, state, y, y_tiles, cfg_static, gram_impl
            )

        def init(plan, y, key):
            core = vi_init_state(
                plan, rank, init_stdev, jax.random.fold_in(key, 0),
                cfg_static, self.dtype,
            )
            return init_categorical_vi_state(plan, core, y, cfg_static)

        y_tiles_spec = tuple(P("data") for _ in self.plan.tables)
        self._sweep_sharded = jax.jit(
            _shard_map(
                sweep,
                mesh=self.mesh,
                in_specs=(plan_spec, state_spec, P("data"), y_tiles_spec),
                out_specs=state_spec,
                check_vma=False,
            ),
            donate_argnums=(1,),
        )
        self._init_sharded = jax.jit(
            _shard_map(
                init,
                mesh=self.mesh,
                in_specs=(plan_spec, P("data"), P()),
                out_specs=state_spec,
                check_vma=False,
            )
        )

        def tiles(plan, y):
            return make_y_tiles(plan, y)

        self.y_tiles = jax.jit(
            _shard_map(
                tiles,
                mesh=self.mesh,
                in_specs=(plan_spec, P("data")),
                out_specs=y_tiles_spec,
                check_vma=False,
            )
        )(self.plan, self.y)

    def _initialize(self):
        key = jax.random.PRNGKey(self.random_seed)
        return self._init_sharded(self.plan, self.y, key)

    def _sweep(self, plan, state, y, y_tiles, cfg, gram_impl):
        # seam-compatible with CategoricalVITrainer._sweep (cfg /
        # gram_impl are baked into the shard_map closure)
        return self._sweep_sharded(plan, state, y, y_tiles)

    def run(self, n_iter: int, callback=None):
        """Identical loop to the single-chip fast-path trainer's
        (deterministic sweeps with ELBO trace + callback)."""
        from ..vi_trainer import run_cavi_loop

        return run_cavi_loop(self, n_iter, callback)
