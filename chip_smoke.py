"""Smoke test of the main fit/predict path on one NVIDIA GPU.

    python chip_smoke.py               # every one-card phase
    python chip_smoke.py --devices 4   # the sharded paths against one card

Phases (one process, one card):

0. device, card name and power limit, JAX version;
1. the fast-path Gram (ops/gram.py) at real tiles of the ML-10M-shaped
   design's item and user tables, rank 32 and 128, each implementation
   the platform runs against the float64 plain path on the host CPU;
2. ``MyFMRegressor(rank=32).fit`` on the full ML-10M-shaped one-hot
   design (10,000,054 rows, 69,878 users, 10,677 items, date one-hot),
   then ``predict`` on 1M rows: time to first sweep by phase, steady
   sweeps/s, the sweep's memory analysis;
3. chain parity: 2 sweeps on a 200k-row slice, card against CPU;
4. ``VariationalFMRegressor(rank=32)`` on the 10M design;
5. classification and ordered probit on the fast path at 1M rows, and
   the joint engine on an ML-100k-sized side-feature design.

``--devices 4`` runs only the sharded fast-path Gibbs fit (10M rows,
rank 32, 3 sweeps), sharded CAVI and mesh-sharded ``predict``, each
against the one-card result.

The data is generated with numpy from ``--seed``.  The last line of
standard output is one JSON object; any failed phase exits non-zero
without it.  The compile cache goes to ``JAX_COMPILATION_CACHE_DIR``
when set, else to ``.jax_cache`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ML10M = dict(n_rows=10_000_054, n_users=69_878, n_items=10_677,
             n_days=5_110)

# Gram entries relative to the largest entry of the float64 reference:
# float32 accumulation over at most T = 1024 rows stays near 1e-6;
# TF32 products (10-bit mantissa) would show as ~1e-3.
GRAM_TOL = 1e-4
# 2 Gibbs sweeps on the card against the same chain (same keys) on the
# CPU in float32: only the order of float32 sums differs.
CHAIN_TOL = 1e-3
# the sharded chain sums Gram partials per device before the
# all-reduce, so its sums are ordered differently again
SHARD_TOL = 1e-3


def log(*a):
    print(*a, flush=True)


def card_name_and_power():
    """``nvidia-smi``'s card name and power limit, as it prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_design(n_rows, n_users, n_items, n_days, seed=0):
    """ML-10M-shaped one-hot design from a seed (numpy only).

    Every user has at least 20 ratings (ML-10M's floor) plus a
    heavy-tailed excess; item popularity is Zipf-like; dates ramp up
    over the span.  Returns (users, items, days, y) in a random row
    order."""
    rng = np.random.default_rng(seed)
    extra = rng.pareto(1.2, n_users)
    counts = 20 + np.floor(
        extra / extra.sum() * (n_rows - 20 * n_users)
    ).astype(np.int64)
    counts[: n_rows - counts.sum()] += 1
    users = np.repeat(np.arange(n_users, dtype=np.int64), counts)
    p = 1.0 / np.arange(1, n_items + 1) ** 0.9
    items = rng.permutation(n_items)[
        rng.choice(n_items, n_rows, p=p / p.sum())
    ]
    days = (n_days * np.sqrt(rng.random(n_rows))).astype(np.int64)
    days = np.minimum(days, n_days - 1)
    perm = rng.permutation(n_rows)
    users, items, days = users[perm], items[perm], days[perm]
    bu = rng.normal(0, 0.4, n_users)
    bi = rng.normal(0, 0.5, n_items)
    pu = rng.normal(0, 0.3, (n_users, 4))
    qi = rng.normal(0, 0.3, (n_items, 4))
    y = 3.5 + bu[users] + bi[items] + 0.8 * rng.normal(size=n_rows)
    for r in range(4):
        y += pu[users, r] * qi[items, r]
    y = np.clip(np.round(y * 2) / 2, 0.5, 5.0)
    return users, items, days, y


def design_inputs(users, items, days, y, n_users, n_items, n_days):
    """(X_date, X_rel, y, group_shapes) for the estimators."""
    import scipy.sparse as sps

    from myfm_tpu import RelationBlock

    n = len(y)
    X_date = sps.csr_matrix(
        (np.ones(n), (np.arange(n), days)), shape=(n, n_days)
    )
    blocks = [
        RelationBlock(users, sps.identity(n_users, format="csr")),
        RelationBlock(items, sps.identity(n_items, format="csr")),
    ]
    return X_date, blocks, y, [n_days, n_users, n_items]


# ----------------------------------------------------------------------
# phases


def phase_device():
    import jax

    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind} "
        f"count={len(jax.devices())}")
    log(f"nvidia-smi: {card_name_and_power()}")
    log(f"jax {jax.__version__}")


def _gram_chunk(ent, B, others, n_rows, rank, rows_cap, seed):
    """Real tiles of one table at its production tiling, with seeded
    random [lin | V | qs] source rows for every table."""
    from myfm_tpu.design_categorical import compile_categorical_table

    tab = compile_categorical_table(ent, B, 0, n_rows, np.float32,
                                    rank=rank)
    T, S = tab.tile_rows, tab.tile_entities
    Kc = min(tab.n_tiles, max(1, rows_cap // T))
    src = np.asarray(tab.src[: Kc * T])
    row = np.minimum(src, n_rows - 1)
    rng = np.random.default_rng(seed)

    def source(b):
        V = rng.normal(0, 0.1, (b, rank))
        w = rng.normal(0, 0.1, b)
        out = np.zeros((b + 1, rank + 2))
        out[:b, 0], out[:b, 1 : 1 + rank] = w, V
        out[:b, -1] = (V * V).sum(axis=1)
        return out

    args = dict(
        own_src=source(B),
        own_idx=np.asarray(tab.ent_of_tile_row[: Kc * T]).reshape(Kc, T),
        other_srcs=[source(b2) for _, b2 in others],
        other_idx=[
            np.where(src < n_rows, e2[row], b2).reshape(Kc, T)
            for e2, b2 in others
        ],
        tau=np.where(src < n_rows, rng.normal(3.5, 1.0, Kc * T),
                     0.0).reshape(Kc, T),
        slot=np.asarray(tab.slot[: Kc * T]).reshape(Kc, T),
        seg=np.asarray(tab.seg[:Kc]),
    )
    return args, (T, S, Kc)


def phase_gram(users, items, days, ranks=(32, 128), rows_cap=1 << 18,
               shape=ML10M):
    """Each Gram implementation the card runs, at real tiles, against
    the float64 plain path on the host CPU.  Returns the implementations
    checked per rank."""
    import jax
    import jax.numpy as jnp

    from myfm_tpu.ops import gram

    n = len(users)
    cfg = shape
    tables = {
        "item": (items, cfg["n_items"],
                 [(users, cfg["n_users"]), (days, cfg["n_days"])]),
        "user": (users, cfg["n_users"],
                 [(items, cfg["n_items"]), (days, cfg["n_days"])]),
    }
    cpu = jax.devices("cpu")[0]
    checked = {}
    for rank in ranks:
        impls = {"xla"} | {gram.choose_impl(np.float32, rank)}
        checked[rank] = sorted(impls)
        for name, (ent, B, others) in tables.items():
            args, (T, S, Kc) = _gram_chunk(
                ent, B, others, n, rank, rows_cap, seed=rank
            )
            with jax.enable_x64(True), jax.default_device(cpu):
                ref = np.asarray(gram.tile_grams_reference(
                    jnp.asarray(args["own_src"]),
                    jnp.asarray(args["own_idx"]),
                    [jnp.asarray(a) for a in args["other_srcs"]],
                    [jnp.asarray(a) for a in args["other_idx"]],
                    jnp.asarray(args["tau"]), jnp.asarray(args["slot"]),
                    S, rank,
                ))
            scale = float(np.abs(ref).max())
            f32 = {
                k: (jnp.asarray(v, jnp.float32)
                    if np.asarray(v).dtype == np.float64
                    else jnp.asarray(v))
                for k, v in args.items()
                if k not in ("other_srcs", "other_idx")
            }
            o_srcs = [jnp.asarray(a, jnp.float32)
                      for a in args["other_srcs"]]
            o_idx = [jnp.asarray(a) for a in args["other_idx"]]
            for impl in sorted(impls):
                if impl == "xla":
                    fn = jax.jit(
                        gram.tile_grams_reference, static_argnums=(6, 7)
                    )
                    got = fn(f32["own_src"], f32["own_idx"], o_srcs,
                             o_idx, f32["tau"], f32["slot"], S, rank)
                else:
                    fn = jax.jit(
                        gram.tile_grams_kernel, static_argnums=(6, 7)
                    )
                    got = fn(f32["own_src"], f32["own_idx"], o_srcs,
                             o_idx, f32["tau"], f32["seg"], S, rank)
                err = float(np.abs(np.asarray(got) - ref).max()) / scale
                log(f"gram rank={rank} table={name} T={T} S={S} "
                    f"tiles={Kc} impl={impl}: max rel err {err:.3e} "
                    f"(tol {GRAM_TOL:.0e}, float32 vs float64 CPU)")
                if not err <= GRAM_TOL:
                    raise AssertionError(
                        f"Gram {impl} rank {rank} {name}: {err:.3e}"
                    )
    return checked


def phase_fit(users, items, days, y, rank=32, n_iter=6,
              n_predict=1_000_000, expect_kernel=True, shape=ML10M):
    """Time to first sweep by phase through the trainer, then the
    public fit/predict path."""
    import jax

    from myfm_tpu import MyFMRegressor
    from myfm_tpu.design_categorical import try_compile_categorical
    from myfm_tpu.ops.gibbs import GibbsConfig
    from myfm_tpu.trainer import CategoricalGibbsTrainer

    cfg = shape
    X, blocks, y, shapes = design_inputs(
        users, items, days, y, cfg["n_users"], cfg["n_items"],
        cfg["n_days"],
    )
    grouping = np.repeat(np.arange(3), shapes).astype(np.int32)

    # time to first sweep, by phase
    t = [time.perf_counter()]
    plan = try_compile_categorical(
        X, blocks, grouping, None, np.float32, rank=rank,
    )
    jax.block_until_ready(plan)
    t.append(time.perf_counter())
    tr = CategoricalGibbsTrainer(
        plan, y, GibbsConfig(task="regression"), rank, 0.1, 1,
        np.float32,
    )
    jax.block_until_ready(tr.y_tiles)
    t.append(time.perf_counter())
    master = jax.random.PRNGKey(1)
    state = jax.block_until_ready(
        tr._initialize(jax.random.fold_in(master, 0))
    )
    t.append(time.perf_counter())
    key = jax.random.fold_in(master, 1)
    compiled = tr._sweep.lower(
        tr.plan, state, tr.y, tr.y_tiles, key, tr.cfg, tr._gram_impl
    ).compile()
    t.append(time.perf_counter())
    state = jax.block_until_ready(tr._sweep_call(state, key))
    t.append(time.perf_counter())
    names = ("design_compile", "trainer_init", "state_init",
             "sweep_compile", "first_sweep")
    phases = {k: t[i + 1] - t[i] for i, k in enumerate(names)}
    log("time to first sweep (s): " + ", ".join(
        f"{k}={v:.2f}" for k, v in phases.items()
    ) + f", total={t[-1] - t[0]:.2f}")
    log(f"tilings (T, S): "
        f"{[(tb.tile_rows, tb.tile_entities) for tb in plan.tables]}")
    log(f"gram impl: {tr._gram_impl}")
    log(f"sweep memory_analysis: {compiled.memory_analysis()}")
    hlo = compiled.as_text()
    has_kernel = "fastpath_tile_gram" in hlo
    log(f"compiled sweep contains the Triton Gram kernel: {has_kernel}")
    if expect_kernel and not (tr._gram_impl == "triton" and has_kernel):
        raise AssertionError("the sweep does not run the compiled kernel")
    if not np.isfinite(np.asarray(state.core.V)).all():
        raise AssertionError("non-finite V after the first sweep")
    del state, compiled, tr

    # the public path: fit through the estimator, steady sweeps/s from
    # the per-sweep callback clock (a user callback syncs every sweep)
    stamps = []

    def cb(it, fm, hyper, hist):
        float(fm.w0)
        stamps.append(time.perf_counter())
        return False, None

    t0 = time.perf_counter()
    fm = MyFMRegressor(rank=rank, random_seed=1).fit(
        X, y, X_rel=blocks, n_iter=n_iter, n_kept_samples=2,
        group_shapes=shapes, callback=cb,
    )
    steady = (len(stamps) - 2) / (stamps[-1] - stamps[1])
    log(f"fit: engine={fm.history_.engine} first sweep at "
        f"{stamps[0] - t0:.2f}s, steady {steady:.3f} sweeps/s "
        f"over {len(stamps) - 2} sweeps")
    if fm.history_.engine != "fastpath":
        raise AssertionError(f"engine {fm.history_.engine}")
    for s in fm.predictor_.samples:
        if not (np.isfinite(s.w).all() and np.isfinite(s.V).all()):
            raise AssertionError("non-finite sample")
    Xp, bp, yp, _ = design_inputs(
        users[:n_predict], items[:n_predict], days[:n_predict],
        y[:n_predict], cfg["n_users"], cfg["n_items"], cfg["n_days"],
    )
    tp = time.perf_counter()
    pred = fm.predict(Xp, bp)
    tp = time.perf_counter() - tp
    rmse = float(np.sqrt(np.mean((pred - yp) ** 2)))
    log(f"predict {n_predict} rows in {tp:.2f}s: train rmse {rmse:.4f} "
        f"(std(y) {np.std(yp):.4f})")
    if not (np.isfinite(pred).all() and rmse < np.std(yp)):
        raise AssertionError("train rmse not below std(y)")
    return steady


def _chain(plan, y, rank, n_sweeps, dtype, device):
    import jax

    from myfm_tpu.ops.gibbs import GibbsConfig
    from myfm_tpu.trainer import CategoricalGibbsTrainer

    with jax.default_device(device):
        tr = CategoricalGibbsTrainer(
            plan, y, GibbsConfig(task="regression"), rank, 0.1, 3, dtype
        )
        master = jax.random.PRNGKey(3)
        state = tr._initialize(jax.random.fold_in(master, 0))
        for it in range(n_sweeps):
            state = tr._sweep_call(
                state, jax.random.fold_in(master, 1 + it)
            )
        return (np.asarray(state.core.w, np.float64),
                np.asarray(state.core.V, np.float64), tr._gram_impl)


def phase_chain(users, items, days, y, n=200_000, rank=32, n_sweeps=2,
                shape=ML10M):
    """The same 2-sweep chain (same keys) on the card and on the CPU.
    Both run in float32: the sampler draws its noise in the chain's
    dtype, so a float64 chain would be a different chain."""
    import jax

    from myfm_tpu.design_categorical import try_compile_categorical

    cfg = shape
    X, blocks, ys, shapes = design_inputs(
        users[:n], items[:n], days[:n], y[:n], cfg["n_users"],
        cfg["n_items"], cfg["n_days"],
    )
    grouping = np.repeat(np.arange(3), shapes).astype(np.int32)
    cpu = jax.devices("cpu")[0]
    out = {}
    for dev in (jax.devices()[0], cpu):
        with jax.default_device(dev):
            plan = try_compile_categorical(
                X, blocks, grouping, None, np.float32, rank=rank,
            )
            out[dev.platform] = _chain(
                plan, ys, rank, n_sweeps, np.float32, dev
            )
    (wg, Vg, ig), (wc, Vc, ic) = out[jax.devices()[0].platform], out["cpu"]
    err = max(
        float(np.abs(wg - wc).max() / np.abs(wc).max()),
        float(np.abs(Vg - Vc).max() / np.abs(Vc).max()),
    )
    log(f"chain parity ({n} rows, rank {rank}, {n_sweeps} sweeps, "
        f"card gram={ig} vs cpu gram={ic}): max rel err {err:.3e} "
        f"(tol {CHAIN_TOL:.0e})")
    if not err <= CHAIN_TOL:
        raise AssertionError(f"chain parity {err:.3e}")


def phase_vi(users, items, days, y, rank=32, n_iter=4, shape=ML10M):
    from myfm_tpu import VariationalFMRegressor

    cfg = shape
    X, blocks, y, shapes = design_inputs(
        users, items, days, y, cfg["n_users"], cfg["n_items"],
        cfg["n_days"],
    )
    t0 = time.perf_counter()
    fm = VariationalFMRegressor(rank=rank, random_seed=1).fit(
        X, y, X_rel=blocks, n_iter=n_iter, group_shapes=shapes,
    )
    elbos = [float(e) for e in fm.history_.elbos]
    log(f"vi: engine={fm.history_.engine} {n_iter} iterations in "
        f"{time.perf_counter() - t0:.2f}s, elbo {elbos}")
    if not (np.isfinite(elbos).all()
            and all(b > a for a, b in zip(elbos[1:], elbos[2:]))):
        raise AssertionError("ELBO not finite and rising")


def phase_tasks(users, items, days, y, n=1_000_000, rank=32, n_iter=4,
                shape=ML10M, joint_shape=(100_000, 943, 1_682)):
    import scipy.sparse as sps

    from myfm_tpu import (
        MyFMClassifier, MyFMOrderedProbit, MyFMRegressor, RelationBlock,
    )

    cfg = shape
    X, blocks, ys, shapes = design_inputs(
        users[:n], items[:n], days[:n], y[:n], cfg["n_users"],
        cfg["n_items"], cfg["n_days"],
    )
    clf = MyFMClassifier(rank=rank, random_seed=2).fit(
        X, (ys >= 4).astype(np.int64), X_rel=blocks, n_iter=n_iter,
        group_shapes=shapes,
    )
    proba = clf.predict_proba(X, blocks)
    log(f"classifier: engine={clf.history_.engine} "
        f"proba range [{proba.min():.3f}, {proba.max():.3f}]")
    if clf.history_.engine != "fastpath" or not np.isfinite(proba).all():
        raise AssertionError("classifier")
    classes = np.clip(np.ceil(ys).astype(np.int64) - 1, 0, 4)
    op = MyFMOrderedProbit(rank=rank, random_seed=2).fit(
        X, classes, X_rel=blocks, n_iter=n_iter, group_shapes=shapes,
    )
    cuts = np.asarray(op.cutpoint_samples)
    log(f"ordered probit: engine={op.history_.engine} last cutpoints "
        f"{np.round(cuts[-1], 3).tolist()}")
    if (op.history_.engine != "fastpath" or not np.isfinite(cuts).all()
            or not (np.diff(cuts, axis=-1) > 0).all()):
        raise AssertionError("ordered probit cutpoints")

    # joint engine: ML-100k-sized users/items with an implicit-feedback
    # side block (multi-hot rows), which the fast path declines
    rng = np.random.default_rng(5)
    n1, nu, ni = joint_shape
    u = rng.integers(0, nu, n1)
    i = rng.integers(0, ni, n1)
    imp = sps.random(nu, ni, density=0.06, random_state=5,
                     data_rvs=lambda k: np.ones(k)).tocsr()
    imp = sps.diags(1 / np.sqrt(np.maximum(imp.sum(1).A1, 1))) @ imp
    yj = rng.normal(3.5, 1.0, n1)
    jb = [
        RelationBlock(u, sps.hstack(
            [sps.identity(nu, format="csr"), imp], format="csr")),
        RelationBlock(i, sps.identity(ni, format="csr")),
    ]
    t0 = time.perf_counter()
    jfm = MyFMRegressor(rank=10, random_seed=3,
                        sweep_strategy="joint").fit(
        None, yj, X_rel=jb, n_iter=n_iter,
        group_shapes=[nu, ni, ni],
    )
    pj = jfm.predict(None, jb)
    log(f"joint: engine={jfm.history_.engine} {n_iter} sweeps in "
        f"{time.perf_counter() - t0:.2f}s, predictions finite "
        f"{bool(np.isfinite(pj).all())}")
    if jfm.history_.engine != "joint" or not np.isfinite(pj).all():
        raise AssertionError("joint engine")


def phase_sharded(users, items, days, y, n_devices, rank=32,
                  n_iter=3, shape=ML10M):
    """Sharded fast-path Gibbs and CAVI against one card, and
    mesh-sharded predict against single-card predict."""
    import jax
    from jax.sharding import Mesh

    from myfm_tpu import MyFMRegressor, VariationalFMRegressor

    cfg = shape
    X, blocks, y, shapes = design_inputs(
        users, items, days, y, cfg["n_users"], cfg["n_items"],
        cfg["n_days"],
    )
    kw = dict(X_rel=blocks, group_shapes=shapes)
    res = {}
    for nd in (1, n_devices):
        t0 = time.perf_counter()
        fm = MyFMRegressor(rank=rank, random_seed=4, n_devices=nd).fit(
            X, y, n_iter=n_iter, n_kept_samples=1, **kw
        )
        s = fm.predictor_.samples[-1]
        res[nd] = (fm, np.asarray(s.w), np.asarray(s.V))
        log(f"gibbs n_devices={nd}: engine={fm.history_.engine} "
            f"{n_iter} sweeps in {time.perf_counter() - t0:.2f}s")
    (_, w1, V1), (fmn, wn, Vn) = res[1], res[n_devices]
    err = max(float(np.abs(wn - w1).max() / np.abs(w1).max()),
              float(np.abs(Vn - V1).max() / np.abs(V1).max()))
    log(f"sharded gibbs vs one card: max rel err {err:.3e} "
        f"(tol {SHARD_TOL:.0e})")
    if not err <= SHARD_TOL:
        raise AssertionError(f"sharded gibbs {err:.3e}")

    vi = {}
    for nd in (1, n_devices):
        vfm = VariationalFMRegressor(
            rank=rank, random_seed=4, n_devices=nd
        ).fit(X, y, n_iter=n_iter, **kw)
        vi[nd] = np.asarray(vfm.predictor_.samples[-1].V)
    err = float(np.abs(vi[n_devices] - vi[1]).max() / np.abs(vi[1]).max())
    log(f"sharded cavi vs one card: max rel err {err:.3e} "
        f"(tol {SHARD_TOL:.0e})")
    if not err <= SHARD_TOL:
        raise AssertionError(f"sharded cavi {err:.3e}")

    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("data",))
    p1 = fmn.predictor_.predict(X, blocks)
    pm = fmn.predictor_.predict(X, blocks, mesh=mesh)
    err = float(np.abs(pm - p1).max() / np.abs(p1).max())
    log(f"predict(mesh=) vs one card: max rel err {err:.3e} "
        f"(tol {SHARD_TOL:.0e})")
    if not err <= SHARD_TOL:
        raise AssertionError(f"sharded predict {err:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"no GPU: JAX found {devs[0].platform}")
        return 1
    if len(devs) < args.devices:
        log(f"--devices {args.devices} but {len(devs)} found")
        return 1
    import myfm_tpu  # noqa: F401  (fails outside a checkout)

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    users, items, days, y = make_design(**ML10M, seed=args.seed)
    log(f"ML-10M-shaped design generated in "
        f"{time.perf_counter() - t0:.1f}s")
    if args.devices > 1:
        phase_device()
        phase_sharded(users, items, days, y, args.devices)
    else:
        steps = [
            lambda: phase_device(),
            lambda: phase_gram(users, items, days),
            lambda: phase_fit(users, items, days, y),
            lambda: phase_chain(users, items, days, y),
            lambda: phase_vi(users, items, days, y),
            lambda: phase_tasks(users, items, days, y),
        ]
        for p, fn in enumerate(steps):
            t0 = time.perf_counter()
            fn()
            log(f"phase {p} done in {time.perf_counter() - t0:.1f}s")
    log(f"all phases done in {time.perf_counter() - t_all:.1f}s")
    log(f"nvidia-smi: {card_name_and_power()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
