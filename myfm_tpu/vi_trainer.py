"""Variational training loop (reference variational.hpp:192-217)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

import jax

from .containers import (
    VariationalFM,
    VariationalFMHyperParameters,
    VariationalLearningHistory,
)
from .design import DesignPlan
from .ops.variational import (
    VariationalConfig,
    VIState,
    vi_init_state,
    vi_sweep,
    vi_update_e_and_var,
)
from .predictor import VariationalPredictor


def _fetch_vfm(state: VIState) -> VariationalFM:
    return VariationalFM(
        w0=float(state.w0),
        w=np.asarray(state.w),
        V=np.asarray(state.V),
        w0_var=float(state.w0_var),
        w_var=np.asarray(state.w_var),
        V_var=np.asarray(state.V_var),
    )


class LazyVFMView:
    """VariationalFM view over live device state; fetches on access.

    Valid during the callback invocation only (the next sweep donates
    the underlying buffers) — same contract as trainer.LazyFMView."""

    def __init__(self, state: VIState):
        self._state = state
        self._vals = {}

    def _get(self, name, scalar=False):
        if name not in self._vals:
            v = getattr(self._state, name)
            self._vals[name] = float(v) if scalar else np.asarray(v)
        return self._vals[name]

    @property
    def w0(self):
        return self._get("w0", scalar=True)

    @property
    def w0_var(self):
        return self._get("w0_var", scalar=True)

    @property
    def w(self):
        return self._get("w")

    @property
    def w_var(self):
        return self._get("w_var")

    @property
    def V(self):
        return self._get("V")

    @property
    def V_var(self):
        return self._get("V_var")

    @property
    def n_factors(self) -> int:
        return int(self._state.V.shape[1])

    def predict_score(self, X, X_rel=()):
        from .containers import fm_predict_score_numpy

        return fm_predict_score_numpy(self.w0, self.w, self.V, X, X_rel)


class LazyVHyperView:
    """VariationalFMHyperParameters view over live device state."""

    _FIELDS = (
        "alpha", "alpha_rate", "mu_w", "mu_w_var", "lambda_w",
        "lambda_w_rate", "mu_V", "mu_V_var", "lambda_V",
        "lambda_V_rate",
    )

    def __init__(self, state: VIState):
        object.__setattr__(self, "_state", state)
        object.__setattr__(self, "_vals", {})

    def __getattr__(self, name):
        if name not in self._FIELDS:
            raise AttributeError(name)
        if name not in self._vals:
            v = getattr(self._state, name)
            self._vals[name] = (
                float(v) if name in ("alpha", "alpha_rate")
                else np.asarray(v)
            )
        return self._vals[name]


class _LazyElbo:
    """history.elbos entry backed by a snapshot device scalar; behaves
    as a float once forced (always finalized to a real float after the
    loop)."""

    __slots__ = ("_bufs", "_val")

    def __init__(self, buf):
        self._bufs = (buf,)
        self._val = None

    def force(self) -> float:
        if self._val is None:
            self._val = float(np.asarray(self._bufs[0]))
            self._bufs = ()
        return self._val

    def materialize(self) -> float:
        return self.force()

    def __float__(self):
        return self.force()

    def __repr__(self):
        return repr(self.force())


def _fetch_hyper(state: VIState) -> VariationalFMHyperParameters:
    return VariationalFMHyperParameters(
        alpha=float(state.alpha),
        alpha_rate=float(state.alpha_rate),
        mu_w=np.asarray(state.mu_w),
        mu_w_var=np.asarray(state.mu_w_var),
        lambda_w=np.asarray(state.lambda_w),
        lambda_w_rate=np.asarray(state.lambda_w_rate),
        mu_V=np.asarray(state.mu_V),
        mu_V_var=np.asarray(state.mu_V_var),
        lambda_V=np.asarray(state.lambda_V),
        lambda_V_rate=np.asarray(state.lambda_V_rate),
    )


class CategoricalVITrainer:
    """CAVI trainer on the entity-space fast path (all tables
    categorical; ops/categorical_vi.py).  Same run() contract as
    VariationalTrainer."""

    def __init__(
        self,
        plan,  # CategoricalPlan (tiled for D = 3R+2)
        y: np.ndarray,
        cfg: VariationalConfig,
        rank: int,
        init_stdev: float,
        random_seed: int,
        dtype=np.float32,
    ):
        from .ops.categorical import make_y_tiles
        from .ops.categorical_vi import (
            categorical_vi_sweep,
            init_categorical_vi_state,
        )

        from .ops.gram import choose_impl, platform_of

        self.plan = plan
        self.cfg = cfg
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed
        self.dtype = np.dtype(dtype)
        self.y = jax.numpy.asarray(np.asarray(y).astype(self.dtype))
        self.y_tiles = make_y_tiles(plan, self.y)
        # the entity+attribute pass's Gram is the widest (4 z blocks)
        self._gram_impl = choose_impl(
            dtype, rank, n_body=4, platform=platform_of(self.y)
        )
        self._init_fn = jax.jit(
            init_categorical_vi_state, static_argnums=(3,)
        )
        self._sweep = jax.jit(
            categorical_vi_sweep, static_argnums=(4, 5),
            donate_argnums=(1,),
        )

    def _initialize(self):
        key = jax.random.PRNGKey(self.random_seed)
        core = vi_init_state(
            self.plan, self.rank, self.init_stdev,
            jax.random.fold_in(key, 0), self.cfg, self.dtype,
        )
        return self._init_fn(self.plan, core, self.y, self.cfg)

    def run(
        self,
        n_iter: int,
        callback: Optional[Callable] = None,
    ) -> Tuple[VariationalPredictor, VariationalLearningHistory]:
        return run_cavi_loop(self, n_iter, callback)


def _cavi_loop(
    trainer,
    n_iter: int,
    callback,
    sweep_once,
    core_of,
    engine: str,
) -> Tuple[VariationalPredictor, VariationalLearningHistory]:
    """Shared CAVI driver (deterministic sweeps, ELBO trace, early-stop
    callback) — the VI analogue of trainer.run_mcmc_loop, with the same
    two harvesting modes: eager per-sweep fetches for user callbacks,
    or async snapshot/prefetch of the ELBO trace when the callback
    permits it (trainer.callback_allows_async)."""
    from .trainer import _AsyncDrain, _snap, callback_allows_async

    state = trainer._initialize()
    history = VariationalLearningHistory(
        hypers=None, elbos=[], engine=engine
    )
    use_async = callback_allows_async(callback)
    drain = _AsyncDrain() if use_async else None
    for it in range(n_iter):
        state = sweep_once(state)
        core = core_of(state)
        if use_async:
            le = _LazyElbo(_snap((core.elbo,))[0])
            history.elbos.append(le)
            drain.push(le)
            if callback is not None and callback(
                it, LazyVFMView(core), LazyVHyperView(core), history
            ):
                break
        else:
            history.elbos.append(float(core.elbo))
            if callback is not None and callback(
                it, _fetch_vfm(core), _fetch_hyper(core), history
            ):
                break
    if drain is not None:
        drain.drain()
        history.elbos = [
            e.materialize() if isinstance(e, _LazyElbo) else e
            for e in history.elbos
        ]
    core = core_of(state)
    history.hypers = _fetch_hyper(core)
    predictor = VariationalPredictor(
        trainer.rank, trainer.plan.n_features, trainer.cfg.task,
        trainer.dtype,
    )
    predictor.samples.append(_fetch_vfm(core))
    return predictor, history


def run_cavi_loop(
    trainer,
    n_iter: int,
    callback: Optional[Callable] = None,
) -> Tuple[VariationalPredictor, VariationalLearningHistory]:
    """Fast-path CAVI driver.  ``trainer`` provides ``_initialize()``,
    a ``_sweep(plan, state, y, y_tiles, cfg, gram_impl)`` callable, and
    the ``plan / y / y_tiles / cfg / rank / dtype / _gram_impl``
    attributes; used by the single-chip CategoricalVITrainer and the
    sharded parallel.sharding_categorical.ShardedCategoricalVITrainer."""

    def sweep_once(state):
        return trainer._sweep(
            trainer.plan, state, trainer.y, trainer.y_tiles,
            trainer.cfg, trainer._gram_impl,
        )

    return _cavi_loop(
        trainer, n_iter, callback, sweep_once,
        core_of=lambda s: s.core, engine="fastpath",
    )


class VariationalTrainer:
    def __init__(
        self,
        plan: DesignPlan,
        y: np.ndarray,
        cfg: VariationalConfig,
        rank: int,
        init_stdev: float,
        random_seed: int,
        dtype=np.float32,
    ):
        self.plan = plan
        self.cfg = cfg
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed
        self.dtype = np.dtype(dtype)
        self.y = jax.numpy.asarray(np.asarray(y).astype(self.dtype))
        self._sweep = jax.jit(
            vi_sweep, static_argnums=(3,), donate_argnums=(1,)
        )

    def _initialize(self) -> VIState:
        key = jax.random.PRNGKey(self.random_seed)
        state = vi_init_state(
            self.plan, self.rank, self.init_stdev,
            jax.random.fold_in(key, 0), self.cfg, self.dtype,
        )

        @jax.jit
        def init_e(state, y):
            # reference initialize_e (variational.hpp:234-241):
            # full mean/variance forward, then e -= y for all tasks.
            e, e_var_sum = vi_update_e_and_var(
                self.plan, state.w0, state.w0_var, state.w, state.w_var,
                state.V, state.V_var,
            )
            return e - y, e_var_sum

        e, e_var_sum = init_e(state, self.y)
        return dataclasses.replace(state, e=e, e_var_sum=e_var_sum)

    def run(
        self,
        n_iter: int,
        callback: Optional[Callable] = None,
    ) -> Tuple[VariationalPredictor, VariationalLearningHistory]:
        def sweep_once(state):
            return self._sweep(self.plan, state, self.y, self.cfg)

        return _cavi_loop(
            self, n_iter, callback, sweep_once,
            core_of=lambda s: s, engine="colored",
        )
