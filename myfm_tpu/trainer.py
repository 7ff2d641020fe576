"""Training loop driving the jitted Gibbs sweep.

Equivalent of the reference's ``learn_with_callback``
(/root/reference/include/myfm/FMTrainer.hpp:56-87): runs ``n_iter``
sweeps, keeps the last ``n_kept_samples`` weight samples, records the
hyperparameter trace every iteration, invokes the (Python) callback with
early-stop support.

The sweep itself is a single jitted, buffer-donating XLA program; the
Python loop only dispatches it and harvests small host copies.  Weight
samples are staged to host memory as they are kept so the device never
holds the chain (the reference similarly copies FMs into process RAM).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .containers import FM, FMHyperParameters, LearningHistory
from .design import DesignPlan
from .ops import oprobit as oprobit_ops
from .ops.forward import predict_score
from .ops.gibbs import (
    TASK_ORDERED,
    GibbsConfig,
    GibbsState,
    gibbs_sweep,
    init_state,
)
from .predictor import Predictor


class LazyFMView(FM):
    """FM view over device state; fetches arrays to host only on access.

    ``cut_groups`` (static per-group class counts) splits the
    concatenated cutpoint state vector back into the per-group list the
    FM container exposes (reference FM::cutpoints is one vector per
    cutpoint group, FM.hpp:137-162)."""

    def __init__(self, state: GibbsState, cut_groups=()):
        self._state = state
        self._cut_groups = cut_groups
        self._w0 = None
        self._w = None
        self._V = None
        self._cutpoints = None

    @property
    def w0(self):  # type: ignore[override]
        if self._w0 is None:
            self._w0 = float(self._state.w0)
        return self._w0

    @property
    def w(self):  # type: ignore[override]
        if self._w is None:
            self._w = np.asarray(self._state.w)
        return self._w

    @property
    def V(self):  # type: ignore[override]
        if self._V is None:
            self._V = np.asarray(self._state.V)
        return self._V

    @property
    def cutpoints(self):  # type: ignore[override]
        if self._cutpoints is None:
            if self._state.cutpoints is None:
                self._cutpoints = []
            else:
                cat = np.asarray(self._state.cutpoints)
                groups = self._cut_groups or (cat.shape[0] + 1,)
                out, off = [], 0
                for K in groups:
                    out.append(cat[off : off + K - 1])
                    off += K - 1
                self._cutpoints = out
        return self._cutpoints

    def materialize(self) -> FM:
        return FM(self.w0, self.w, self.V, self.cutpoints)


def _fetch_hyper(state: GibbsState) -> FMHyperParameters:
    return FMHyperParameters(
        alpha=float(state.alpha),
        mu_w=np.asarray(state.mu_w),
        lambda_w=np.asarray(state.lambda_w),
        mu_V=np.asarray(state.mu_V),
        lambda_V=np.asarray(state.lambda_V),
    )


# ---------------------------------------------------------------------
# Async trace machinery.
#
# The reference's learn_with_callback crosses the C++/Python boundary
# once per sweep (FMTrainer.hpp:78) at near-zero cost; here every
# host<->device synchronization stalls the dispatch queue, so a loop
# that fetches the hyper trace and tqdm postfix eagerly leaves the
# device idle between sweeps.  When the callback does not demand per-sweep
# host values (the tqdm default reads them every 10th sweep only), the
# loop instead snapshots the trace fields into fresh device buffers
# (one tiny jitted copy per sweep, dispatch-only), prefetches them with
# copy_to_host_async, and materializes them a few sweeps later — so the
# chain never stalls, while keeping at most _SNAP_LAG sweeps in flight
# (bounding the buffers held for pending fetches).


_SNAP_LAG = 3


def _fresh(a):
    # jnp.copy of an unchanged input can be returned as a pass-through
    # (aliasing the donated sweep state); an explicit add forces a new
    # output buffer.
    return a + jnp.zeros((), a.dtype)


@jax.jit
def _snap(arrays):
    """Fresh device copies (donation-safe snapshots) of array tuples."""
    return tuple(_fresh(a) for a in arrays)


class _AsyncDrain:
    """Bounded queue of pending host fetches: push() starts the async
    device->host copy and forces entries older than ``lag`` sweeps;
    drain() forces everything (end of loop)."""

    def __init__(self, lag: int = _SNAP_LAG):
        self.lag = lag
        self._pending = deque()

    def push(self, obj) -> None:
        for buf in obj._bufs:
            try:
                buf.copy_to_host_async()
            except AttributeError:  # non-jax array (tests/stubs)
                pass
        self._pending.append(obj)
        while len(self._pending) > self.lag:
            self._pending.popleft().force()

    def drain(self) -> None:
        while self._pending:
            self._pending.popleft().force()


def _split_cutpoints(cat: np.ndarray, groups) -> list:
    """Split the concatenated cutpoint vector back into the per-group
    list the FM container exposes (reference FM.hpp:137-162)."""
    groups = groups or (cat.shape[0] + 1,)
    out, off = [], 0
    for K in groups:
        out.append(cat[off : off + K - 1])
        off += K - 1
    return out


class LazyHyper:
    """Hyper-trace entry backed by snapshot device buffers; fetches on
    first attribute access, duck-typing FMHyperParameters."""

    __slots__ = ("_bufs", "_vals", "_nacc")

    def __init__(self, bufs, has_accept: bool = False):
        self._bufs = bufs
        self._vals = None
        self._nacc = None if not has_accept else ()

    def force(self):
        if self._vals is None:
            a, mu_w, lam_w, mu_V, lam_V = self._bufs[:5]
            self._vals = FMHyperParameters(
                alpha=float(a),
                mu_w=np.asarray(mu_w),
                lambda_w=np.asarray(lam_w),
                mu_V=np.asarray(mu_V),
                lambda_V=np.asarray(lam_V),
            )
            if self._nacc is not None:
                self._nacc = [
                    int(c)
                    for c in np.atleast_1d(np.asarray(self._bufs[5]))
                ]
            self._bufs = ()
        return self._vals

    def materialize(self) -> FMHyperParameters:
        return self.force()

    def accept_counts(self):
        self.force()
        return self._nacc

    @property
    def alpha(self):
        return self.force().alpha

    @property
    def mu_w(self):
        return self.force().mu_w

    @property
    def lambda_w(self):
        return self.force().lambda_w

    @property
    def mu_V(self):
        return self.force().mu_V

    @property
    def lambda_V(self):
        return self.force().lambda_V


class _LazyAccept:
    """Per-sweep n_mh_accept_trace entry view over a LazyHyper."""

    __slots__ = ("_hyper",)

    def __init__(self, hyper: LazyHyper):
        self._hyper = hyper

    # _AsyncDrain protocol (already pushed via its hyper; no own bufs)
    _bufs = ()

    def force(self):
        return self._hyper.accept_counts()

    def materialize(self):
        return self._hyper.accept_counts()


class LazyPackedFM:
    """Kept posterior sample backed by snapshot buffers (w0, w, V
    [, cutpoints]); duck-types FM until finalized to a real FM."""

    __slots__ = ("_bufs", "_vals", "_cut_groups")

    def __init__(self, bufs, cut_groups=()):
        self._bufs = bufs
        self._vals = None
        self._cut_groups = cut_groups

    def force(self) -> FM:
        if self._vals is None:
            w0, w, V = self._bufs[:3]
            cuts = []
            if len(self._bufs) > 3:
                cuts = _split_cutpoints(
                    np.asarray(self._bufs[3]), self._cut_groups
                )
            self._vals = FM(float(w0), np.asarray(w), np.asarray(V),
                            cuts)
            self._bufs = ()
        return self._vals

    def materialize(self) -> FM:
        return self.force()

    @property
    def w0(self):
        return self.force().w0

    @property
    def w(self):
        return self.force().w

    @property
    def V(self):
        return self.force().V

    @property
    def cutpoints(self):
        return self.force().cutpoints

    @property
    def n_factors(self):
        return self.force().n_factors

    def predict_score(self, X, X_rel=()):
        return self.force().predict_score(X, X_rel)

    def oprobit_predict_proba(self, X, X_rel=(), cutpoint_index=0):
        return self.force().oprobit_predict_proba(
            X, X_rel, cutpoint_index
        )


def callback_allows_async(callback) -> bool:
    """True when the trace may be harvested asynchronously: no
    callback, or one tagged ``allow_async_trace`` (the tqdm default
    wrapper in base._fit, which only reads host values every
    ``callback_default_freq`` sweeps).  User-supplied callbacks get the
    eager per-sweep semantics of the reference (FMTrainer.hpp:78)."""
    return callback is None or bool(
        getattr(callback, "allow_async_trace", False)
    )


def run_mcmc_loop(
    trainer,
    n_iter: int,
    n_kept_samples: int,
    callback=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    core_of=lambda s: s,
) -> Tuple[Predictor, LearningHistory]:
    """Shared MCMC driver (reference learn_with_callback,
    FMTrainer.hpp:56-87): runs the chain, keeps the last
    ``n_kept_samples`` weight samples, records the hyper trace, invokes
    the callback with early-stop, and checkpoints every N sweeps.

    ``trainer`` provides ``_initialize(key)``, ``_sweep_call(state,
    key)``, and the ``rank / n_features / cfg / dtype / random_seed``
    attributes; ``core_of`` maps the trainer's state to its GibbsState
    (identity for the row-space trainers, ``.core`` for the
    categorical fast path).

    Two harvesting modes (see the async-trace note above): the eager
    per-sweep fetches of the reference when a user callback wants live
    host values, or the pipelined snapshot/prefetch path (device never
    idles on the trace) when the callback permits it."""
    import os

    from .checkpoint import load_checkpoint, save_checkpoint

    master = jax.random.PRNGKey(trainer.random_seed)
    state = trainer._initialize(jax.random.fold_in(master, 0))
    start_it = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, start_it = load_checkpoint(checkpoint_path, state)

    predictor = Predictor(
        trainer.rank, trainer.n_features, trainer.cfg.task,
        trainer.dtype,
    )
    history = LearningHistory(engine=getattr(trainer, "engine_name", ""))
    ordered = trainer.cfg.task == TASK_ORDERED
    cut_groups = trainer.cfg.cutpoint_group_classes
    use_async = callback_allows_async(callback)
    drain = _AsyncDrain() if use_async else None
    for it in range(start_it, n_iter):
        key = jax.random.fold_in(master, 1 + it)
        state = trainer._sweep_call(state, key)
        core = core_of(state)
        view = LazyFMView(core, cut_groups)
        keep = it + n_kept_samples >= n_iter
        if use_async:
            hyper_fields = [core.alpha, core.mu_w, core.lambda_w,
                            core.mu_V, core.lambda_V]
            if ordered:
                hyper_fields.append(core.n_mh_accept)
            lh = LazyHyper(_snap(tuple(hyper_fields)),
                           has_accept=ordered)
            history.hypers.append(lh)
            drain.push(lh)
            if ordered:
                history.n_mh_accept_trace.append(_LazyAccept(lh))
            if keep:
                sample_fields = [core.w0, core.w, core.V]
                if core.cutpoints is not None:
                    sample_fields.append(core.cutpoints)
                ls = LazyPackedFM(_snap(tuple(sample_fields)),
                                  cut_groups)
                predictor.samples.append(ls)
                drain.push(ls)
            if callback is not None and callback(it, view, lh, history):
                break
        else:
            if keep:
                predictor.samples.append(view.materialize())
            history.hypers.append(_fetch_hyper(core))
            if ordered:
                # cumulative accept count per cutpoint-group sampler
                # (reference FMTrainer.hpp:83-85)
                history.n_mh_accept_trace.append(
                    [int(c) for c in np.atleast_1d(
                        np.asarray(core.n_mh_accept)
                    )]
                )
            if callback is not None:
                if callback(it, view, history.hypers[-1], history):
                    break
        if (
            checkpoint_path
            and checkpoint_every
            and (it + 1) % checkpoint_every == 0
        ):
            save_checkpoint(checkpoint_path, state, it + 1)

    if drain is not None:
        drain.drain()
        # finalize the lazies into plain picklable containers
        history.hypers = [
            h.materialize() if isinstance(h, LazyHyper) else h
            for h in history.hypers
        ]
        history.n_mh_accept_trace = [
            t.materialize() if isinstance(t, _LazyAccept) else t
            for t in history.n_mh_accept_trace
        ]
        predictor.samples = [
            s.materialize() if isinstance(s, LazyPackedFM) else s
            for s in predictor.samples
        ]

    final = core_of(state)
    if trainer.cfg.task == TASK_ORDERED and final.n_mh_accept is not None:
        history.n_mh_accept = [
            int(c)
            for c in np.atleast_1d(np.asarray(final.n_mh_accept))
        ]
    return predictor, history


class GibbsTrainer:
    def __init__(
        self,
        plan: DesignPlan,
        y: np.ndarray,
        cfg: GibbsConfig,
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
        if cfg.task == TASK_ORDERED:
            # latent class labels stay integer; residuals use z
            self.y_int = jnp.asarray(np.asarray(y, dtype=np.int32))
            self.y = jnp.asarray(np.asarray(y).astype(self.dtype))
        else:
            self.y = jnp.asarray(np.asarray(y).astype(self.dtype))
            self.y_int = None
        self._sweep = jax.jit(
            gibbs_sweep, static_argnums=(4,), donate_argnums=(1,)
        )

    @property
    def n_features(self) -> int:
        return self.plan.n_features

    @property
    def engine_name(self) -> str:
        return "joint" if self.cfg.joint_rows else "colored"

    def _sweep_call(self, state, key):
        y_arg = self.y_int if self.cfg.task == TASK_ORDERED else self.y
        return self._sweep(self.plan, state, y_arg, key, self.cfg)

    def _initialize(self, key) -> GibbsState:
        k_init, k_e = jax.random.split(key)
        state = init_state(
            self.plan, self.rank, self.init_stdev, k_init, self.cfg,
            self.dtype,
        )

        if self.cfg.task == TASK_ORDERED:
            state = oprobit_ops.initialize_oprobit_state(
                self.plan, state, self.y_int, self.cfg, k_e
            )
        else:

            @jax.jit
            def init_e(state, y):
                score = predict_score(
                    self.plan, state.w0, state.w, state.V
                )
                # reference initialize_e (FMTrainer.hpp:99-119):
                # e = score - y for regression and ±1 classification.
                return score - y

            e = init_e(state, self.y)
            state = GibbsState(
                w0=state.w0, w=state.w, V=state.V, e=e,
                alpha=state.alpha, mu_w=state.mu_w,
                lambda_w=state.lambda_w, mu_V=state.mu_V,
                lambda_V=state.lambda_V,
            )
        return state

    def run(
        self,
        n_iter: int,
        n_kept_samples: int,
        callback: Optional[
            Callable[[int, FM, FMHyperParameters, LearningHistory], bool]
        ] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
    ) -> Tuple[Predictor, LearningHistory]:
        """Run the chain.  With ``checkpoint_path`` + ``checkpoint_every``
        the full chain state is dumped every N sweeps; ``resume=True``
        continues from the checkpoint and reproduces the exact chain an
        uninterrupted run would have produced (keys are derived from
        (seed, iteration), so no RNG state needs saving)."""
        return run_mcmc_loop(
            self, n_iter, n_kept_samples, callback, checkpoint_path,
            checkpoint_every, resume,
        )


class CategoricalGibbsTrainer:
    """Gibbs trainer on the entity-space fast path (all tables
    categorical; see ops/categorical.py).  Same run() contract as
    GibbsTrainer."""

    def __init__(
        self,
        plan,  # CategoricalPlan
        y: np.ndarray,
        cfg: GibbsConfig,
        rank: int,
        init_stdev: float,
        random_seed: int,
        dtype=np.float32,
    ):
        from .ops.categorical import (
            categorical_sweep,
            init_categorical_state,
            make_y_tiles,
        )

        from .ops.gram import choose_impl, platform_of

        self.plan = plan
        self.cfg = cfg
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed
        self.dtype = np.dtype(dtype)
        if cfg.task == TASK_ORDERED:
            self.y_int = jnp.asarray(np.asarray(y, dtype=np.int32))
            self.y = jnp.asarray(np.asarray(y).astype(self.dtype))
        else:
            self.y = jnp.asarray(np.asarray(y).astype(self.dtype))
            self.y_int = None
        # per-table tile-order copies of y (regression target path)
        self.y_tiles = make_y_tiles(plan, self.y)
        self._gram_impl = choose_impl(
            dtype, rank, platform=platform_of(self.y)
        )
        self._init_fn = init_categorical_state
        self._sweep = jax.jit(
            categorical_sweep, static_argnums=(5, 6), donate_argnums=(1,)
        )

    @property
    def n_features(self) -> int:
        return self.plan.n_features

    @property
    def engine_name(self) -> str:
        return "fastpath"

    def _sweep_call(self, state, key):
        y_arg = self.y_int if self.cfg.task == TASK_ORDERED else self.y
        return self._sweep(
            self.plan, state, y_arg, self.y_tiles, key, self.cfg,
            self._gram_impl,
        )

    def _initialize(self, key):
        k_init, k_e = jax.random.split(key)
        core = init_state(
            self.plan, self.rank, self.init_stdev, k_init, self.cfg,
            self.dtype,
        )
        y_arg = self.y_int if self.cfg.task == TASK_ORDERED else self.y
        return self._init_fn(self.plan, core, y_arg, k_e, self.cfg)

    def run(
        self,
        n_iter: int,
        n_kept_samples: int,
        callback: Optional[
            Callable[[int, FM, FMHyperParameters, LearningHistory], bool]
        ] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
    ) -> Tuple[Predictor, LearningHistory]:
        return run_mcmc_loop(
            self, n_iter, n_kept_samples, callback, checkpoint_path,
            checkpoint_every, resume, core_of=lambda s: s.core,
        )
