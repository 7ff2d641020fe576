"""Card measurements behind the GPU bring-up choices (one process).

    python scripts/measure_bring_up.py [--sweeps 10]
        [--parts gram,tiling,src,joint]

* ``gram``: the fast-path Gibbs sweep on the ML-10M-shaped design at
  rank 32 and 128 with the Triton Gram kernel against the plain XLA
  Gram, in turns (kernel, plain, plain, kernel), end to end (sweeps/s)
  and for the table Grams alone;
* ``tiling``: the rank-32 sweep at the tiling rule's choice against
  two pinned tilings;
* ``src``: the host packer against the on-device src/slot derivation,
  per table, as design-compile time;
* ``joint``: the joint engine's colour-tail scan on an ML-100k-sized
  side-feature design: time per colour and kernel launches per colour
  from a profiler trace.

Prints one line per number with the card's name and power limit, and
writes them to ``<out>/bring_up.json`` (``--out``, default
``.measure_out`` in the checkout) with the joint profiler trace.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

OUT = {}


def log(key, value, note=""):
    OUT.setdefault(key, []).append(value)
    print(f"{key} = {value} {note}".rstrip(), flush=True)


def _sweep_rate(trainer, state, impl, n_sweeps, master):
    import jax

    def run(state, base):
        for it in range(n_sweeps):
            state = trainer._sweep(
                trainer.plan, state, trainer.y, trainer.y_tiles,
                jax.random.fold_in(master, base + it), trainer.cfg, impl,
            )
        return jax.block_until_ready(state)

    state = run(state, 0)  # compile + warm
    t0 = time.perf_counter()
    state = run(state, 1000)
    return n_sweeps / (time.perf_counter() - t0), state


def _plan_and_trainer(design, rank, fixed_ts=None):
    import jax

    from myfm_tpu.design_categorical import try_compile_categorical
    from myfm_tpu.ops.gibbs import GibbsConfig
    from myfm_tpu.trainer import CategoricalGibbsTrainer

    X, blocks, y, shapes = design
    grouping = np.repeat(np.arange(3), shapes).astype(np.int32)
    plan = try_compile_categorical(
        X, blocks, grouping, None, np.float32, rank=rank,
        fixed_ts=fixed_ts,
    )
    tr = CategoricalGibbsTrainer(
        plan, y, GibbsConfig(task="regression"), rank, 0.1, 1,
        np.float32,
    )
    state = tr._initialize(jax.random.PRNGKey(0))
    return plan, tr, state


def part_gram(design, n_sweeps):
    import jax

    from myfm_tpu.ops.categorical import _build_table_gram, eff_tables
    from myfm_tpu.ops.categorical import _wv_table

    master = jax.random.PRNGKey(7)
    for rank in (32, 128):
        plan, tr, state = _plan_and_trainer(design, rank)
        log(f"tilings_rank{rank}",
            [(t.tile_rows, t.tile_entities) for t in plan.tables])
        rates = {"triton": [], "xla": []}
        for impl in ("triton", "xla", "xla", "triton"):
            r, state = _sweep_rate(tr, state, impl, n_sweeps, master)
            rates[impl].append(r)
        for impl, rs in rates.items():
            log(f"sweeps_per_s_rank{rank}_{impl}", rs)

        # the table Grams alone (all tables of one sweep)
        w, V = state.core.w, state.core.V
        tau = tr.y_tiles

        def grams(plan, w, V, tau, impl):
            eff = eff_tables(plan, w, V)
            return [
                _build_table_gram(
                    plan, ti, w, V, eff, _wv_table(w, V, t), tau[ti],
                    impl,
                )
                for ti, t in enumerate(plan.tables)
            ]

        # the plan is an argument, not a closure constant
        fn = jax.jit(grams, static_argnums=(4,))
        for impl in ("triton", "xla", "xla", "triton"):
            jax.block_until_ready(fn(plan, w, V, tau, impl))
            t0 = time.perf_counter()
            for _ in range(n_sweeps):
                out = fn(plan, w, V, tau, impl)
            jax.block_until_ready(out)
            log(f"gram_ms_rank{rank}_{impl}",
                round((time.perf_counter() - t0) / n_sweeps * 1e3, 3))
        del tr, state, plan


def part_tiling(design, n_sweeps):
    import jax

    master = jax.random.PRNGKey(8)
    for ts in (None, (1024, 4), (128, 2)):
        plan, tr, state = _plan_and_trainer(design, 32, fixed_ts=ts)
        r, _ = _sweep_rate(tr, state, tr._gram_impl, n_sweeps, master)
        log(f"tiling_{ts or 'rule'}_sweeps_per_s_rank32", round(r, 3),
            str([(t.tile_rows, t.tile_entities) for t in plan.tables]))
        del tr, state, plan


def part_src(raw):
    import jax

    from myfm_tpu.design_categorical import compile_categorical_table

    users, items, days, _ = raw
    cfg = chip_smoke.ML10M
    for name, ent, B in (("item", items, cfg["n_items"]),
                         ("user", users, cfg["n_users"]),
                         ("date", days, cfg["n_days"])):
        for dev in (False, True, True, False):
            t0 = time.perf_counter()
            tab = compile_categorical_table(
                ent, B, 0, len(ent), np.float32, rank=32,
                derive_src_on_device=dev,
            )
            jax.block_until_ready(tab)
            log(f"src_{name}_{'device' if dev else 'host'}_s",
                round(time.perf_counter() - t0, 3))


def part_joint(n_sweeps, out_dir):
    """Joint engine colour tail: seconds per colour and device kernel
    launches per colour (profiler trace of the steady sweeps)."""
    import jax
    import scipy.sparse as sps

    from myfm_tpu import RelationBlock
    from myfm_tpu.design import compile_design
    from myfm_tpu.ops.gibbs import GibbsConfig
    from myfm_tpu.trainer import GibbsTrainer

    rng = np.random.default_rng(5)
    n, nu, ni = 100_000, 943, 1_682
    u = rng.integers(0, nu, n)
    i = rng.integers(0, ni, n)
    imp = sps.random(nu, ni, density=0.06, random_state=5,
                     data_rvs=lambda k: np.ones(k)).tocsr()
    blocks = [
        RelationBlock(u, sps.hstack(
            [sps.identity(nu, format="csr"), imp], format="csr")),
        RelationBlock(i, sps.identity(ni, format="csr")),
    ]
    y = rng.normal(3.5, 1.0, n)
    rank = 10
    plan = compile_design(None, blocks, grouping=None, dtype=np.float32,
                          for_training=True, joint_dense=True,
                          joint_rank=rank)
    n_colors = sum(
        int(b.dense_stack.feat.shape[0]) for b in plan.blocks
        if b.dense_stack is not None
    )
    log("joint_tail_colors", n_colors)
    tr = GibbsTrainer(plan, y, GibbsConfig(task="regression",
                                           joint_rows=True),
                      rank, 0.1, 1, np.float32)
    master = jax.random.PRNGKey(2)
    state = tr._initialize(jax.random.fold_in(master, 0))
    state = jax.block_until_ready(
        tr._sweep_call(state, jax.random.fold_in(master, 1))
    )
    t0 = time.perf_counter()
    for it in range(n_sweeps):
        state = tr._sweep_call(state, jax.random.fold_in(master, 2 + it))
    jax.block_until_ready(state)
    dt = (time.perf_counter() - t0) / n_sweeps
    log("joint_sweep_ms", round(dt * 1e3, 3))

    trace_dir = os.path.join(out_dir, "joint_trace")
    with jax.profiler.trace(trace_dir):
        for it in range(2):
            state = tr._sweep_call(
                state, jax.random.fold_in(master, 100 + it)
            )
        jax.block_until_ready(state)
    path = sorted(glob.glob(
        os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb")
    ))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    kernels = 0
    busy_ns = 0
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for ev in line.events:
                kernels += 1
                busy_ns += ev.duration_ns
    log("joint_kernels_per_sweep", kernels / 2)
    log("joint_kernels_per_tail_color", round(kernels / 2 / n_colors, 2))
    log("joint_device_busy_ms_per_sweep", round(busy_ns / 2 / 1e6, 3))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--parts", default="gram,tiling,src,joint")
    ap.add_argument("--out", default=os.path.join(REPO, ".measure_out"))
    args = ap.parse_args()
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    if jax.devices()[0].platform != "gpu":
        print("no GPU", flush=True)
        return 1
    card = chip_smoke.card_name_and_power()
    log("card", card)
    parts = args.parts.split(",")
    cfg = chip_smoke.ML10M
    raw = chip_smoke.make_design(**cfg, seed=0)
    design = chip_smoke.design_inputs(
        *raw, cfg["n_users"], cfg["n_items"], cfg["n_days"]
    )
    if "gram" in parts:
        part_gram(design, args.sweeps)
    if "tiling" in parts:
        part_tiling(design, args.sweeps)
    if "src" in parts:
        part_src(raw)
    if "joint" in parts:
        part_joint(args.sweeps, args.out)
    log("card_after", chip_smoke.card_name_and_power())
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "bring_up.json"), "w") as f:
        json.dump(OUT, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
