"""myfm_tpu — Bayesian Factorization Machines in JAX, run on the GPU.

A from-scratch JAX/XLA/Pallas re-implementation of the capabilities of
tohtsky/myFM: MCMC (Gibbs) and variational Bayesian FMs with feature
grouping, relational-block compression, binary probit classification and
ordinal (cumulative-probit) regression — re-architected as a chromatic,
fully vectorized sampler over device-resident sparse plans.

Public API parity: /root/reference/src/myfm/__init__.py:9-25.
"""

from .base import ConfigBuilder, MyFMBase, std_cdf
from .containers import (
    FM,
    FMHyperParameters,
    LearningHistory,
    VariationalFM,
    VariationalFMHyperParameters,
    VariationalLearningHistory,
)
from .gibbs import (
    MyFMGibbsBase,
    MyFMGibbsClassifier,
    MyFMGibbsRegressor,
    MyFMOrderedProbit,
)
from .ops.special import (  # reference declare_module.hpp:400-403
    mean_var_truncated_normal_left,
    mean_var_truncated_normal_right,
)
from .design_cache import clear_plan_cache
from .predictor import Predictor, VariationalPredictor
from .relational import RelationBlock
from .variational import (
    MyFMVariationalBase,
    VariationalFMClassifier,
    VariationalFMRegressor,
)

# Reference aliases (myfm/__init__.py:17-20)
MyFMRegressor = MyFMGibbsRegressor
MyFMClassifier = MyFMGibbsClassifier

__version__ = "0.1.0"

__all__ = [
    "RelationBlock",
    "ConfigBuilder",
    "MyFMBase",
    "std_cdf",
    "FM",
    "FMHyperParameters",
    "LearningHistory",
    "VariationalFM",
    "VariationalFMHyperParameters",
    "VariationalLearningHistory",
    "MyFMGibbsBase",
    "MyFMGibbsRegressor",
    "MyFMGibbsClassifier",
    "MyFMOrderedProbit",
    "MyFMRegressor",
    "MyFMClassifier",
    "MyFMVariationalBase",
    "VariationalFMRegressor",
    "VariationalFMClassifier",
    "Predictor",
    "VariationalPredictor",
    "mean_var_truncated_normal_left",
    "mean_var_truncated_normal_right",
    "clear_plan_cache",
    "__version__",
]
