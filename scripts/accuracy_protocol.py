"""Fixed-seed accuracy-parity protocol.

Runs the reference's committed benchmark configurations end-to-end and
writes ACCURACY.md: RMSE/MAE (and oprobit expected-rating RMSE) beside
the reference's real-data numbers.  In this zero-egress environment the
data is the synthetic ML-100k-shaped stand-in (fixed seed 42), so the
absolute values are not directly comparable to the reference's real
MovieLens numbers — the committed artifact is the *protocol*: the same
script run with the real zips present (or `--real`) produces the
apples-to-apples comparison.

Configs (sources in /root/reference):
  A  rank 8, 100 iters, grouped            README.md:119-121  (0.89594)
  B  rank 8, 100 iters, ungrouped          README.md:115-117  (0.90321)
  C  timeSVD++-flipped rank 10, 300 iters  relation-blocks.rst:214 (0.889)
  D  oprobit timeSVD++ rank 10, 200 iters  ordinal-regression.rst:153 (0.8906)
  E  VI rank 8, 100 iters, grouped         movielens.rst VI examples
"""

import argparse
import os
import sys
import time

_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _root)
sys.path.insert(0, os.path.join(_root, "examples"))

import numpy as np
import scipy.sparse as sps

from ml_features import build_feature_blocks, load_movielens


def rmse_mae(pred, y):
    return (
        float(np.sqrt(np.mean((pred - y) ** 2))),
        float(np.mean(np.abs(pred - y))),
    )


class PhaseTimer:
    """fit() callback capturing the first-iteration wall (compile) and
    the steady-state iteration rate.

    Tagged ``allow_async_trace`` so the trainer keeps its pipelined
    harvesting (the timer never reads the model views) — the steady
    rate then measures what a default-callback user gets.  The i == 0
    sync forces first-sweep completion so the compile wall is
    attributed to t_first, not smeared into the first few stamps; the
    median over later diffs is robust to the ≤3-deep pipeline ramp."""

    allow_async_trace = True

    def __init__(self):
        self.t0 = time.time()
        self.stamps = []

    def __call__(self, i, fm, hyper, history):
        if i == 0:
            float(fm.w0)  # block on the first sweep (compile wall)
        self.stamps.append(time.time())
        return False, None

    def split(self):
        if len(self.stamps) < 3:
            return float("nan"), float("nan")
        t_first = self.stamps[0] - self.t0
        steady = np.diff(self.stamps[1:])
        it_s = 1.0 / max(float(np.median(steady)), 1e-9)
        return t_first, it_s


def basic_design(df_train, df_test):
    from myfm_tpu.utils.encoders import CategoryValueToSparseEncoder

    user_enc = CategoryValueToSparseEncoder(df_train.user_id.values)
    movie_enc = CategoryValueToSparseEncoder(df_train.movie_id.values)

    def enc(df):
        return sps.hstack(
            [
                user_enc.to_sparse(df.user_id.values),
                movie_enc.to_sparse(df.movie_id.values),
            ],
            format="csr",
        )

    return enc(df_train), enc(df_test), [len(user_enc), len(movie_enc)]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--real", action="store_true",
                   help="use the real ML-100k zip (requires cache)")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default=os.path.join(_root, "ACCURACY.md"))
    args = p.parse_args()

    from myfm_tpu import (
        MyFMGibbsRegressor,
        MyFMOrderedProbit,
        VariationalFMRegressor,
    )

    # Breast-cancer AUC — the one REAL-data reference number that is
    # reproducible offline (sklearn ships the dataset; reference
    # doc/source/index.rst:28-51 publishes AUC 0.9954 on this exact
    # recipe: StandardScaler, train_test_split(random_state=42),
    # MyFMClassifier(rank=2) defaults)
    real_rows = []
    try:
        from sklearn import metrics
        from sklearn.datasets import load_breast_cancer
        from sklearn.model_selection import train_test_split
        from sklearn.preprocessing import StandardScaler

        from myfm_tpu import MyFMGibbsClassifier

        t0 = time.time()
        data = load_breast_cancer()
        Xb = StandardScaler().fit_transform(data["data"])
        Xb_tr, Xb_te, yb_tr, yb_te = train_test_split(
            Xb, data["target"], random_state=42
        )
        clf = MyFMGibbsClassifier(rank=2).fit(Xb_tr, yb_tr)
        auc = metrics.roc_auc_score(
            yb_te, clf.predict_proba(Xb_te)
        )
        real_rows.append((
            "Breast-cancer AUC (real data, rank 2 defaults)",
            float(auc), 0.9954, time.time() - t0,
        ))
        print(real_rows[-1], flush=True)
    except Exception as exc:  # pragma: no cover
        print(f"breast-cancer row skipped: {exc!r}", flush=True)

    df_train, df_test = load_movielens(
        "100k", args.fold, synthetic=not args.real, random_seed=args.seed
    )
    y_tr = df_train.rating.values.astype(np.float64)
    y_te = df_test.rating.values.astype(np.float64)
    rows = []

    def clip(x):
        return np.clip(x, 1.0, 5.0)

    # A/B: plain one-hot design, rank 8, 100 iters
    Xtr, Xte, shapes = basic_design(df_train, df_test)
    for grouped, ref in ((True, 0.89594), (False, 0.90321)):
        t0 = time.time()
        timer = PhaseTimer()
        fm = MyFMGibbsRegressor(rank=8, random_seed=args.seed).fit(
            Xtr, y_tr, n_iter=100, n_kept_samples=95,
            group_shapes=shapes if grouped else None,
            callback=timer,
        )
        r, m = rmse_mae(clip(fm.predict(Xte)), y_te)
        rows.append((
            f"Gibbs rank 8, 100 it, {'grouped' if grouped else 'ungrouped'}",
            r, m, ref, time.time() - t0, fm.history_.engine,
            *timer.split(),
        ))
        print(rows[-1], flush=True)

    # E: VI rank 8, grouped
    t0 = time.time()
    timer = PhaseTimer()
    vfm = VariationalFMRegressor(rank=8, random_seed=args.seed).fit(
        Xtr, y_tr, n_iter=100, group_shapes=shapes, callback=timer,
    )
    r, m = rmse_mae(clip(vfm.predict(Xte)), y_te)
    rows.append((
        "VI rank 8, 100 it, grouped", r, m, 0.8958, time.time() - t0,
        vfm.history_.engine, *timer.split(),
    ))
    print(rows[-1], flush=True)

    # C: timeSVD++-flipped RelationBlocks, rank 10, 300 iters (joint)
    X_date_tr, X_date_te, blocks_tr, blocks_te, grouping = (
        build_feature_blocks(df_train, df_test, "timesvdpp_flipped")
    )
    t0 = time.time()
    timer = PhaseTimer()
    fm = MyFMGibbsRegressor(
        rank=10, random_seed=args.seed, sweep_strategy="joint"
    ).fit(
        X_date_tr, y_tr, X_rel=blocks_tr, n_iter=300,
        n_kept_samples=295, grouping=grouping, callback=timer,
    )
    r, m = rmse_mae(
        clip(fm.predict(X_date_te, X_rel=blocks_te)), y_te
    )
    rows.append((
        "Gibbs timeSVD++-flipped rank 10, 300 it (joint)", r, m, 0.889,
        time.time() - t0, fm.history_.engine, *timer.split(),
    ))
    print(rows[-1], flush=True)

    # D: ordered probit on the same features, 200 iters
    t0 = time.time()
    timer = PhaseTimer()
    fmo = MyFMOrderedProbit(
        rank=10, random_seed=args.seed, sweep_strategy="joint"
    ).fit(
        X_date_tr, (y_tr - 1).astype(np.int64), X_rel=blocks_tr,
        n_iter=200, n_kept_samples=195, grouping=grouping,
        callback=timer,
    )
    proba = fmo.predict_proba(X_date_te, X_rel=blocks_te)
    expected = proba @ (np.arange(proba.shape[1]) + 1.0)
    r, m = rmse_mae(clip(expected), y_te)
    rows.append((
        "OProbit timeSVD++ rank 10, 200 it (expected rating)", r, m,
        0.8906, time.time() - t0, fmo.history_.engine, *timer.split(),
    ))
    print(rows[-1], flush=True)

    src = "real ML-100k" if args.real else (
        f"synthetic ML-100k stand-in (seed {args.seed})"
    )
    lines = [
        "# Accuracy-parity protocol",
        "",
        f"Data: {src}, fold {args.fold}.  Reference columns are the",
        "reference's committed numbers on the REAL dataset",
        "(README.md:115-121, doc/source/relation-blocks.rst:214,",
        "doc/source/ordinal-regression.rst:153) — directly comparable",
        "only when this script runs with `--real` and the zips cached.",
        "Regenerate: `python scripts/accuracy_protocol.py`.",
        "",
        "| config | RMSE | MAE | reference RMSE (real data) | engine |",
        "|---|---|---|---|---|",
    ]
    # times are left out: they belong in PERF.md with the card's name
    for name, r, m, ref, _wall, eng, _t_first, _it_s in rows:
        lines.append(f"| {name} | {r:.5f} | {m:.5f} | {ref} | {eng} |")
    if real_rows:
        lines += [
            "",
            "Real-data parity (sklearn's bundled breast-cancer set — "
            "the one reference",
            "number reproducible in this zero-egress environment; "
            "reference recipe and",
            "value: doc/source/index.rst:28-51):",
            "",
            "| config | AUC | reference AUC |",
            "|---|---|---|",
        ]
        for name, auc, ref, _wall in real_rows:
            lines.append(f"| {name} | {auc:.5f} | {ref} |")
    lines.append("")
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
