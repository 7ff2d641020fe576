"""Posterior-predictive averaging over kept Gibbs samples.

Device analogue of the reference ``Predictor``
(/root/reference/include/myfm/predictor.hpp:14-167).  Where the
reference spreads samples over a std::thread pool, here the sample axis
is batched on-device: samples are stacked in memory-bounded chunks and
scored with a vmapped forward pass, so the averaging is data-parallel by
construction.  ``n_workers`` is accepted for API parity and ignored.
"""

from __future__ import annotations

import weakref
from typing import List, Optional, Sequence, Union

import numpy as np
from scipy import sparse as sps

import jax
import jax.numpy as jnp

from .containers import FM
from .design import compile_design
from .ops.forward import predict_score
from .ops.forward_categorical import (
    compile_categorical_inference,
    scores_samples_reduce,
    scores_samples_reduce_sharded,
    serving_row_chunk,
)
from .relational import RelationBlock

_scores_reduce_jit = jax.jit(
    scores_samples_reduce, static_argnames=("mode", "row_chunk")
)

ArrayLike = Union[np.ndarray, sps.spmatrix]

TASK_REGRESSION = "regression"
TASK_CLASSIFICATION = "classification"
TASK_ORDERED = "ordered"

_CHUNK_ELEMENTS = 1 << 26


def _std_cdf(x):
    return 0.5 * (1.0 + jax.scipy.special.erf(x * np.sqrt(0.5)))


class _LiveKey:
    """Identity cache key that cannot alias recycled ids.

    ``id()`` tuples alone are unsound as cache keys: Python reuses
    addresses after GC, so a freed design matrix followed by a new one
    at the same address would silently serve the stale cached plan.
    This key holds a weakref per object — if any keyed object has been
    collected the key reports a miss — plus a cheap structural
    fingerprint (shape/nnz) as a second factor for objects that cannot
    be weak-referenced."""

    def __init__(self, objs):
        self._ids = tuple(id(o) for o in objs)
        self._prints = tuple(self._fingerprint(o) for o in objs)
        refs = []
        for o in objs:
            try:
                refs.append(weakref.ref(o))
            except TypeError:
                refs.append(None)
        self._refs = tuple(refs)

    @staticmethod
    def _fingerprint(o):
        shape = getattr(o, "shape", None)
        nnz = getattr(o, "nnz", None)
        return (type(o).__name__, shape, nnz)

    def matches(self, objs) -> bool:
        if len(objs) != len(self._ids):
            return False
        if tuple(id(o) for o in objs) != self._ids:
            return False
        if tuple(self._fingerprint(o) for o in objs) != self._prints:
            return False
        # any dead weakref means the original object was collected and
        # this id belongs to a different object now
        return all(r is None or r() is not None for r in self._refs)


class Predictor:
    """Holds kept posterior samples; averages the posterior predictive."""

    def __init__(self, rank: int, n_features: int, task: str,
                 dtype=np.float32):
        self.rank = rank
        self.n_features = n_features
        self.task = task
        self.dtype = np.dtype(dtype)
        self.samples: List[FM] = []

    # -- internals ----------------------------------------------------

    def _compile(self, X: Optional[ArrayLike],
                 X_rel: Sequence[RelationBlock]):
        return compile_design(
            X, X_rel, dtype=self.dtype, for_training=False
        )

    def _compile_fast(self, X: Optional[ArrayLike],
                      X_rel: Sequence[RelationBlock]):
        """Entity-space inference plan (ops/forward_categorical), or
        None when the design is not categorical.  Cached per (X, X_rel)
        identity (weakref-validated, _LiveKey) so repeated serving
        calls on the same design pay the entity-map upload once while a
        recycled id can never serve a stale plan."""
        objs = (X,) + tuple(X_rel)
        cached = getattr(self, "_fast_plan_cache", None)
        if cached is not None and cached[0].matches(objs):
            return cached[1]
        try:
            plan = compile_categorical_inference(X, X_rel, self.dtype)
        except Exception:
            plan = None
        self._fast_plan_cache = (_LiveKey(objs), plan)
        return plan

    def _sample_chunks(self):
        """Stacked (w0s, ws, Vs) device arrays per memory-bounded
        sample chunk, cached across predict calls (serving reuses the
        same kept samples; re-uploading the stacked weights through a
        slow host->device link would otherwise dominate every call)."""
        cached = getattr(self, "_sample_stack_cache", None)
        if cached is not None and cached[0].matches(tuple(self.samples)):
            yield from cached[1]
            return
        per_sample = max(1, self.n_features * max(self.rank, 1))
        chunk = max(1, min(len(self.samples), _CHUNK_ELEMENTS // per_sample))
        staged = []
        for s0 in range(0, len(self.samples), chunk):
            part = self.samples[s0 : s0 + chunk]
            w0s = jnp.asarray(
                np.array([s.w0 for s in part], dtype=self.dtype)
            )
            ws = jnp.asarray(
                np.stack([s.w for s in part]).astype(self.dtype)
            )
            vs = jnp.asarray(
                np.stack([s.V for s in part]).astype(self.dtype)
            )
            staged.append((part, w0s, ws, vs))
            yield part, w0s, ws, vs
        self._sample_stack_cache = (_LiveKey(tuple(self.samples)), staged)

    # -- public API (parity with predictor.hpp) -----------------------

    def predict(
        self,
        X: Optional[ArrayLike],
        X_rel: Sequence[RelationBlock] = (),
        n_workers: Optional[int] = None,
        mesh=None,
    ) -> np.ndarray:
        """Posterior-predictive mean (probit-squashed per sample for
        classification, then averaged — predictor.hpp:126-147).

        ``mesh``: an optional ``jax.sharding.Mesh`` with a ``('data',)``
        axis — rows shard across its devices and each chip scores its
        shard against the replicated sample stack (the multi-chip
        analogue of the reference's ``predict_parallel`` thread pool,
        predictor.hpp:35-76).  Requires the entity-space fast path."""
        if not self.samples:
            raise RuntimeError("Predictor has no samples.")
        squash = self.task == TASK_CLASSIFICATION
        fast = self._compile_fast(X, X_rel)
        if mesh is not None and fast is None:
            raise ValueError(
                "mesh-sharded prediction requires the entity-space "
                "fast path; this design fell back to the row-space "
                "scorer (single-chip only)."
            )
        if fast is not None:
            mode = "probit_sum" if squash else "sum"
            total = np.zeros(fast.n_rows, dtype=np.float64)
            for part, w0s, ws, vs in self._sample_chunks():
                if mesh is not None:
                    out = scores_samples_reduce_sharded(
                        fast, w0s, ws, vs, mesh, mode=mode,
                        row_chunk=serving_row_chunk(
                            len(part), self.rank
                        ),
                    )
                else:
                    out = _scores_reduce_jit(
                        fast, w0s, ws, vs, mode=mode,
                        row_chunk=serving_row_chunk(
                            len(part), self.rank
                        ),
                    )
                total += np.asarray(out, dtype=np.float64)
            return total / len(self.samples)
        plan = self._compile(X, X_rel)

        @jax.jit
        def score_sum(w0s, ws, vs):
            def one(w0, w, V):
                s = predict_score(plan, w0, w, V)
                return _std_cdf(s) if squash else s

            return jnp.sum(jax.vmap(one)(w0s, ws, vs), axis=0)

        total = np.zeros(plan.n_rows, dtype=np.float64)
        for part, w0s, ws, vs in self._sample_chunks():
            total += np.asarray(score_sum(w0s, ws, vs), dtype=np.float64)
        return total / len(self.samples)

    # thread-count arguments kept for reference API parity; batching on
    # the accelerator replaces the reference's thread pool.
    def predict_parallel(
        self,
        X: Optional[ArrayLike],
        X_rel: Sequence[RelationBlock] = (),
        n_workers: Optional[int] = None,
        mesh=None,
    ) -> np.ndarray:
        return self.predict(X, X_rel, mesh=mesh)

    def predict_parallel_oprobit(
        self,
        X: Optional[ArrayLike],
        X_rel: Sequence[RelationBlock] = (),
        n_workers: Optional[int] = None,
        cutpoint_index: int = 0,
        mesh=None,
    ) -> np.ndarray:
        """Average per-sample ordinal class probabilities
        (predictor.hpp:78-124 + FM.hpp:137-162); ``mesh`` shards rows
        as in ``predict``."""
        if not self.samples:
            raise RuntimeError("Predictor has no samples.")
        fast = self._compile_fast(X, X_rel)
        if mesh is not None and fast is None:
            raise ValueError(
                "mesh-sharded prediction requires the entity-space "
                "fast path; this design fell back to the row-space "
                "scorer (single-chip only)."
            )
        if fast is not None:
            total = None
            for part, w0s, ws, vs in self._sample_chunks():
                cps = jnp.asarray(
                    np.stack(
                        [s.cutpoints[cutpoint_index] for s in part]
                    ).astype(self.dtype)
                )
                rc = serving_row_chunk(len(part), self.rank)
                if mesh is not None:
                    raw = scores_samples_reduce_sharded(
                        fast, w0s, ws, vs, mesh, mode="oprobit_sum",
                        cutpoints=cps, row_chunk=rc,
                    )
                else:
                    raw = _scores_reduce_jit(
                        fast, w0s, ws, vs, mode="oprobit_sum",
                        cutpoints=cps, row_chunk=rc,
                    )
                out = np.asarray(raw, dtype=np.float64)
                total = out if total is None else total + out
            return total / len(self.samples)
        plan = self._compile(X, X_rel)

        @jax.jit
        def proba_sum(w0s, ws, vs, cps):
            def one(w0, w, V, gamma):
                s = predict_score(plan, w0, w, V)
                cdf = _std_cdf(gamma[None, :] - s[:, None])  # [N, K-1]
                lower = jnp.concatenate(
                    [jnp.zeros_like(cdf[:, :1]), cdf], axis=1
                )
                upper = jnp.concatenate(
                    [cdf, jnp.ones_like(cdf[:, :1])], axis=1
                )
                return upper - lower

            return jnp.sum(jax.vmap(one)(w0s, ws, vs, cps), axis=0)

        total = None
        for part, w0s, ws, vs in self._sample_chunks():
            cps = jnp.asarray(
                np.stack(
                    [s.cutpoints[cutpoint_index] for s in part]
                ).astype(self.dtype)
            )
            out = np.asarray(proba_sum(w0s, ws, vs, cps), dtype=np.float64)
            total = out if total is None else total + out
        return total / len(self.samples)

    def __getstate__(self):
        return {
            "rank": self.rank,
            "n_features": self.n_features,
            "task": self.task,
            "dtype": self.dtype,
            "samples": self.samples,
        }

    def __setstate__(self, state):
        self.rank = state["rank"]
        self.n_features = state["n_features"]
        self.task = state["task"]
        self.dtype = state["dtype"]
        self.samples = state["samples"]


class VariationalPredictor:
    """Wraps the single converged VI weight set (declare_module.hpp:343-346)."""

    def __init__(self, rank: int, n_features: int, task: str,
                 dtype=np.float32):
        self.rank = rank
        self.n_features = n_features
        self.task = task
        self.dtype = np.dtype(dtype)
        self.samples = []  # exactly one VariationalFM after fit

    def weights(self):
        return self.samples[0]

    def predict(
        self,
        X: Optional[ArrayLike],
        X_rel: Sequence[RelationBlock] = (),
        n_workers: Optional[int] = None,
    ) -> np.ndarray:
        if not self.samples:
            raise RuntimeError("Predictor has no samples.")
        vfm = self.samples[0]
        score = vfm.predict_score(X, X_rel)
        if self.task == TASK_CLASSIFICATION:
            from scipy.special import ndtr

            return ndtr(score)
        return score
