"""Estimator base classes: the sklearn-style template-method API.

Mirrors the reference's ``myfm.base``
(/root/reference/src/myfm/base.py:72-399): constructor hyperparameter
surface, ``_fit`` data-validation/grouping/callback plumbing, and the
Regressor/Classifier mixins — but ``_train_core`` dispatches to the
JAX trainers instead of a pybind11 module.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections import OrderedDict
from typing import (
    Callable,
    Dict,
    List,
    Optional,
    Tuple,
    Union,
)

import numpy as np
from scipy import sparse as sps
from scipy.special import ndtr

try:
    from tqdm import tqdm
except Exception:  # pragma: no cover

    class tqdm:  # type: ignore
        def __init__(self, total=None, **kwargs):
            self.total = total

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def update(self, n=1):
            pass

        def set_description(self, s):
            pass


from .containers import FM, FMHyperParameters, LearningHistory
from .relational import RelationBlock

REAL = np.float64

ArrayLike = Union[np.ndarray, sps.spmatrix]

TASK_REGRESSION = "regression"
TASK_CLASSIFICATION = "classification"
TASK_ORDERED = "ordered"


def std_cdf(x: np.ndarray) -> np.ndarray:
    return ndtr(np.asarray(x, dtype=np.float64))


def check_data_consistency(
    X: Optional[ArrayLike], X_rel: List[RelationBlock]
) -> int:
    """Reference base.py:46-61: consistent row counts, X may be None."""
    if X_rel:
        shape_rel_all = {rel.mapper_size for rel in X_rel}
        if len(shape_rel_all) > 1:
            raise ValueError("Inconsistent case size for X_rel.")
        shape = list(shape_rel_all)[0]
        if X is not None and X.shape[0] != shape:
            raise ValueError("X and X_rel have different shape.")
        return int(shape)
    if X is None:
        raise ValueError("At least X or X_rel must be provided.")
    return int(X.shape[0])


class ConfigBuilder:
    """Fluent config builder, API-compatible with the reference's
    ``_myfm.ConfigBuilder`` (FMLearningConfig.hpp:92-201)."""

    def __init__(self) -> None:
        self.alpha_0 = 1.0
        self.beta_0 = 1.0
        self.gamma_0 = 1.0
        self.mu_0 = 0.0
        self.reg_0 = 1.0
        self.fit_w0 = True
        self.fit_linear = True
        self.n_iter = 100
        self.n_kept_samples = 10
        self.task_type = TASK_REGRESSION
        self.nu_oprobit = 5
        self.cutpoint_scale = 10.0
        self.group_index: Optional[List[int]] = None
        self.cutpoint_groups: List[Tuple[int, List[int]]] = []

    def _setter(name):  # noqa: N805
        def set_(self, value):
            setattr(self, name, value)
            return self

        return set_

    set_alpha_0 = _setter("alpha_0")
    set_beta_0 = _setter("beta_0")
    set_gamma_0 = _setter("gamma_0")
    set_mu_0 = _setter("mu_0")
    set_reg_0 = _setter("reg_0")
    set_fit_w0 = _setter("fit_w0")
    set_fit_linear = _setter("fit_linear")
    set_n_iter = _setter("n_iter")
    set_n_kept_samples = _setter("n_kept_samples")
    set_task_type = _setter("task_type")
    set_nu_oprobit = _setter("nu_oprobit")
    set_cutpoint_scale = _setter("cutpoint_scale")
    set_cutpoint_groups = _setter("cutpoint_groups")
    del _setter

    def set_group_index(self, group_index) -> "ConfigBuilder":
        self.group_index = list(group_index)
        return self

    def set_identical_groups(self, dim: int) -> "ConfigBuilder":
        self.group_index = [0] * dim
        return self


class MyFMBase(ABC):
    r"""Bayesian Factorization Machine base (reference base.py:72-350)."""

    def __init__(
        self,
        rank: int,
        init_stdev: float = 0.1,
        random_seed: int = 42,
        alpha_0: float = 1.0,
        beta_0: float = 1.0,
        gamma_0: float = 1.0,
        mu_0: float = 0.0,
        reg_0: float = 1.0,
        fit_w0: bool = True,
        fit_linear: bool = True,
        dtype=np.float32,
        sweep_strategy: str = "auto",
        max_unrolled_colors: int = 16,
        n_devices: Optional[int] = None,
        mesh=None,
    ):
        """Set up the sampler configuration.

        The first eleven parameters follow the reference exactly
        (priors: α, λ ~ Gamma(α₀/2, β₀/2); μ ~ N(μ₀, 1/γ₀);
        w0 ~ N(0, 1/reg₀)).  Extras of this rebuild:

        dtype:
            On-device compute precision (default float32; the reference
            is float64-only on CPU).
        sweep_strategy:
            "auto" → the fastest exact engine for the design: the
            entity-space fast path when every table is one-hot (or
            [one-hot | side-feature] within the EA gates), else the
            merged joint-row sweep when rank and the dense color
            machinery allow it, else the chromatic (colored) sweep;
            "serial" → one feature per color, the faithful analogue of
            the reference's sequential scan (same chain up to float
            reassociation, used as a parity oracle in tests);
            "colored" → force the chromatic per-coordinate sweep (the
            engine that reproduces "serial" sample-for-sample);
            "categorical" → require the entity-space fast path;
            "joint" → colored sweep drawing each feature's [w_j | V_j]
            row from its exact (R+1)-dim Gaussian conditional (valid
            Gibbs blocking, one pass over the colors instead of R+1).
        max_unrolled_colors:
            Colors beyond this many per table execute via lax.scan
            instead of being unrolled into the XLA program.
        n_devices / mesh:
            Multi-chip SPMD training: rows shard over a 1-D ``('data',)
            jax.sharding.Mesh`` (built from the first ``n_devices``
            local devices unless ``mesh`` is given); per-feature
            statistics are psum-reduced so the sharded chain reproduces
            the single-chip chain sample-for-sample.  Gibbs estimators
            only (the reference has no distributed path at all).
        """
        if sweep_strategy not in ("auto", "serial", "colored",
                                  "categorical", "joint"):
            raise ValueError(
                "sweep_strategy must be one of 'auto', 'serial', "
                "'colored', 'categorical', 'joint'; got "
                f"{sweep_strategy!r}."
            )
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed
        self.alpha_0 = alpha_0
        self.beta_0 = beta_0
        self.gamma_0 = gamma_0
        self.mu_0 = mu_0
        self.reg_0 = reg_0
        self.fit_w0 = fit_w0
        self.fit_linear = fit_linear
        self.dtype = np.dtype(dtype)
        self.sweep_strategy = sweep_strategy
        self.max_unrolled_colors = max_unrolled_colors
        self.n_devices = n_devices
        self.mesh = mesh

        self.predictor_ = None
        self.history_ = None
        self.n_groups_: Optional[int] = None

    def __str__(self) -> str:
        return (
            "{class_name}(init_stdev={init_stdev}, alpha_0={alpha_0}, "
            "beta_0={beta_0}, gamma_0={gamma_0}, mu_0={mu_0}, "
            "reg_0={reg_0})"
        ).format(
            class_name=self.__class__.__name__,
            init_stdev=self.init_stdev,
            alpha_0=self.alpha_0,
            beta_0=self.beta_0,
            gamma_0=self.gamma_0,
            mu_0=self.mu_0,
            reg_0=self.reg_0,
        )

    # -- abstract hooks ------------------------------------------------

    @property
    @abstractmethod
    def _task_type(self) -> str:
        raise NotImplementedError

    @abstractmethod
    def _train_core(
        self,
        rank,
        init_stdev,
        X,
        X_rel,
        y,
        random_seed,
        config: ConfigBuilder,
        callback,
    ):
        raise NotImplementedError

    @abstractmethod
    def _status_report(self, fm: FM, hyper: FMHyperParameters) -> str:
        raise NotImplementedError

    @abstractmethod
    def _prepare_prediction_for_test(self, fm, X, X_rel) -> np.ndarray:
        raise NotImplementedError

    @abstractmethod
    def _measure_score(self, prediction, y) -> Dict[str, float]:
        raise NotImplementedError

    def _process_y(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y).astype(np.float64)

    def _build_mesh(self):
        """The ('data',) mesh for multi-chip training: the user's
        ``mesh`` verbatim, else the first ``n_devices`` local devices."""
        import jax
        from jax.sharding import Mesh

        if self.mesh is not None:
            return self.mesh
        devices = jax.devices()
        if len(devices) < self.n_devices:
            raise ValueError(
                f"n_devices={self.n_devices} requested but only "
                f"{len(devices)} JAX devices are visible."
            )
        return Mesh(np.array(devices[: self.n_devices]), ("data",))

    # -- the fit template (same kwargs surface as reference
    # base.py:207-323; the body is organized around small local
    # helpers instead of one linear block) ----------------------------

    @staticmethod
    def _coerce_design(X, X_rel, y, what: str):
        """Validate (X, X_rel, y) row counts and return X as csr
        (an empty [n, 0] matrix when the design is blocks-only)."""
        n_rows = check_data_consistency(X, X_rel)
        X = (
            sps.csr_matrix((n_rows, 0), dtype=REAL)
            if X is None
            else sps.csr_matrix(X)
        )
        if y.shape[0] != n_rows:
            raise ValueError(
                f"{what} design has {n_rows} rows but its target has "
                f"{y.shape[0]} entries."
            )
        return X

    def _resolve_iteration_counts(self, n_iter, n_kept_samples):
        """Typed n_iter/n_kept validation (the reference does this in
        FMLearningConfig.hpp:48-56); default keeps all but the first 5
        draws, floored at 5."""
        if n_iter <= 0:
            raise ValueError(f"n_iter must be positive; got {n_iter}.")
        if n_kept_samples is None:
            return n_iter, min(max(n_iter - 5, 5), n_iter)
        if n_kept_samples <= 0:
            raise ValueError(
                f"n_kept_samples must be positive; got {n_kept_samples}."
            )
        if n_kept_samples > n_iter:
            raise ValueError(
                f"n_kept_samples ({n_kept_samples}) cannot exceed "
                f"n_iter ({n_iter})."
            )
        return n_iter, n_kept_samples

    def _resolve_grouping(self, builder, n_features, grouping,
                          group_shapes):
        """Feature→hyper-group map: explicit per-feature ids, contiguous
        run lengths (group_shapes), or one shared group."""
        if grouping is None and group_shapes is not None:
            grouping = np.repeat(
                np.arange(len(group_shapes)), group_shapes
            ).tolist()
        if grouping is None:
            self.n_groups_ = 1
            builder.set_identical_groups(n_features)
            return
        if len(grouping) != n_features:
            raise ValueError(
                f"grouping has {len(grouping)} entries but the "
                f"design has {n_features} features."
            )
        self.n_groups_ = len(set(grouping))
        builder.set_group_index(grouping)

    def _fit(
        self,
        X: Optional[ArrayLike],
        y: np.ndarray,
        X_rel: List[RelationBlock] = [],
        X_test: Optional[ArrayLike] = None,
        y_test: Optional[np.ndarray] = None,
        X_rel_test: List[RelationBlock] = [],
        n_iter: int = 100,
        n_kept_samples: Optional[int] = None,
        grouping: Optional[List[int]] = None,
        group_shapes: Optional[List[int]] = None,
        callback: Optional[
            Callable[
                [int, FM, FMHyperParameters, LearningHistory],
                Tuple[bool, Optional[str]],
            ]
        ] = None,
        config_builder: Optional[ConfigBuilder] = None,
        callback_default_freq: int = 10,
    ) -> None:
        builder = config_builder or ConfigBuilder()

        y = np.asarray(y)
        X = self._coerce_design(X, X_rel, y, "training")
        n_features = X.shape[1] + sum(b.feature_size for b in X_rel)

        n_iter, n_kept_samples = self._resolve_iteration_counts(
            n_iter, n_kept_samples
        )
        self._resolve_grouping(builder, n_features, grouping,
                               group_shapes)

        # estimator ctor priors flow into the config verbatim
        for prior in ("alpha_0", "beta_0", "gamma_0", "mu_0", "reg_0",
                      "fit_w0", "fit_linear"):
            getattr(builder, f"set_{prior}")(getattr(self, prior))
        builder.set_n_iter(n_iter).set_n_kept_samples(n_kept_samples)
        builder.set_task_type(self._task_type)

        # optional held-out set scored by the default callback
        have_test_design = X_test is not None or bool(X_rel_test)
        if have_test_design != (y_test is not None):
            raise RuntimeError(
                "Must specify both (X_test or X_rel_test) and y_test."
            )
        if have_test_design:
            y_test = np.asarray(y_test)
            X_test = self._coerce_design(
                X_test, X_rel_test, y_test, "test"
            )

        def default_callback(i, fm, hyper, history):
            if i % callback_default_freq:
                return False, None
            report = self._status_report(fm, hyper)
            if have_test_design:
                scores = self._measure_score(
                    self._prepare_prediction_for_test(
                        fm, X_test, X_rel_test
                    ),
                    y_test,
                )
                report += "".join(
                    f" {name}_this: {value:.2f}"
                    for name, value in scores.items()
                )
            return False, report

        user_callback = callback or default_callback

        # disable=None: tqdm renders on a TTY and stays silent when
        # stdout/stderr is captured (benchmark drivers, CI logs)
        with tqdm(total=n_iter, disable=None) as progress:

            def on_iteration(i, fm, hyper, history) -> bool:
                should_stop, message = user_callback(
                    i, fm, hyper, history
                )
                if message is not None:
                    progress.set_description(message)
                progress.update(1)
                return should_stop

            # the default callback touches host values only every
            # callback_default_freq sweeps, so the trainer may harvest
            # the trace asynchronously (trainer.callback_allows_async);
            # a user-supplied callback keeps the reference's eager
            # per-sweep view semantics unless it opts in by exposing
            # a truthy ``allow_async_trace`` attribute
            on_iteration.allow_async_trace = callback is None or bool(
                getattr(callback, "allow_async_trace", False)
            )

            self.predictor_, self.history_ = self._train_core(
                self.rank,
                self.init_stdev,
                X,
                X_rel,
                self._process_y(y),
                self.random_seed,
                builder,
                on_iteration,
            )

    def _fetch_predictor(self):
        if self.predictor_ is None:
            raise RuntimeError("Predictor called before fit.")
        return self.predictor_

    # pickling: estimators hold only numpy state
    def __getstate__(self):
        return dict(self.__dict__)

    def __setstate__(self, state):
        self.__dict__.update(state)


class RegressorMixin:
    @property
    def _task_type(self) -> str:
        return TASK_REGRESSION

    def _prepare_prediction_for_test(self, fm, X, X_rel):
        return fm.predict_score(X, X_rel)

    def _status_report(self, fm, hyper) -> str:
        return "alpha = {:.2f} w0 = {:.2f} ".format(hyper.alpha, fm.w0)

    def _measure_score(self, prediction, y) -> Dict[str, float]:
        result = OrderedDict()
        result["rmse"] = float(((y - prediction) ** 2).mean() ** 0.5)
        result["mae"] = float(np.abs(y - prediction).mean())
        return result


class ClassifierMixin:
    @property
    def _task_type(self) -> str:
        return TASK_CLASSIFICATION

    def _prepare_prediction_for_test(self, fm, X, X_rel):
        return std_cdf(fm.predict_score(X, X_rel))

    def _process_y(self, y: np.ndarray) -> np.ndarray:
        # {0,1} → {-1,+1} (reference base.py:385-386)
        return np.asarray(y).astype(np.float64) * 2 - 1

    def _measure_score(self, prediction, y) -> Dict[str, float]:
        result = OrderedDict()
        lp = np.log(prediction + 1e-15)
        l1mp = np.log(1 - prediction + 1e-15)
        gt = np.asarray(y) > 0
        result["ll"] = float(
            (-lp.dot(gt) - l1mp.dot(~gt)) / max(1, prediction.shape[0])
        )
        result["accuracy"] = float(np.mean((prediction >= 0.5) == gt))
        return result

    def _status_report(self, fm, hyper) -> str:
        return "w0 = {:.2f} ".format(fm.w0)
