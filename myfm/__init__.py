"""Compatibility shim: ``import myfm`` resolves to the JAX
rebuild, so code written against the reference (tohtsky/myFM) runs
unchanged.  See myfm_tpu for the actual implementation."""

import importlib
import sys

from myfm_tpu import *  # noqa: F401,F403
from myfm_tpu import (  # noqa: F401
    MyFMClassifier,
    MyFMGibbsClassifier,
    MyFMGibbsRegressor,
    MyFMOrderedProbit,
    MyFMRegressor,
    RelationBlock,
    VariationalFMClassifier,
    VariationalFMRegressor,
    __version__,
)

# register submodule aliases so `from myfm.utils.encoders import ...`
# style imports (the reference layout) resolve
for _sub in (
    "base",
    "gibbs",
    "variational",
    "containers",
    "trainer",
    "predictor",
    "relational",
    "checkpoint",
    "utils",
    "utils.encoders",
    "utils.callbacks",
    "utils.benchmark_data",
    "utils.dummy_data",
):
    sys.modules[f"myfm.{_sub}"] = importlib.import_module(
        f"myfm_tpu.{_sub}"
    )
