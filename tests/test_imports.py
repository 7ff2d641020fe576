"""The fit/predict path needs only jax, numpy and scipy: with pandas
made unimportable, ``import myfm_tpu`` and a fit/predict still work
(run in a fresh interpreter so no earlier import leaks in)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import sys
sys.modules["pandas"] = None  # any `import pandas` now raises
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np, scipy.sparse as sps
import myfm_tpu
from myfm_tpu import MyFMRegressor, RelationBlock, VariationalFMRegressor
rng = np.random.RandomState(0)
u, i = rng.randint(0, 20, 400), rng.randint(0, 15, 400)
y = (rng.normal(size=20)[u] + rng.normal(size=15)[i]
     + 0.3 * rng.normal(size=400))
blocks = [RelationBlock(u, sps.identity(20, format="csr")),
          RelationBlock(i, sps.identity(15, format="csr"))]
"""


def _run(body):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-c", _PRELUDE + body], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )


def test_fit_predict_without_pandas():
    r = _run("""
fm = MyFMRegressor(rank=2, random_seed=0).fit(
    None, y, X_rel=blocks, n_iter=5, group_shapes=[20, 15])
p = fm.predict(None, blocks)
vfm = VariationalFMRegressor(rank=2).fit(None, y, X_rel=blocks, n_iter=3)
q = vfm.predict(None, blocks)
assert np.isfinite(p).all() and np.isfinite(q).all()
assert "pandas" not in {m for m, v in sys.modules.items() if v is not None}
print("OK", fm.history_.engine)
""")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK fastpath" in r.stdout


def test_hyper_trace_alone_needs_pandas():
    r = _run("""
fm = MyFMRegressor(rank=2, random_seed=0).fit(
    None, y, X_rel=blocks, n_iter=3, group_shapes=[20, 15])
try:
    fm.get_hyper_trace()
except ImportError:
    print("ImportError")
""")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ImportError" in r.stdout
