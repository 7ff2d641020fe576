"""chip_smoke.py's phases at tiny sizes on the CPU: each phase's checks
run (the Gram against its float64 reference, fit/predict, chain parity,
CAVI, the other tasks, the sharded paths on the virtual mesh), and the
script refuses to run without a GPU."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
import chip_smoke  # noqa: E402

SHAPE = dict(n_rows=20_000, n_users=150, n_items=60, n_days=30)


@pytest.fixture(scope="module")
def design():
    return chip_smoke.make_design(**SHAPE, seed=0)


def test_make_design_shapes(design):
    users, items, days, y = design
    n = SHAPE["n_rows"]
    assert users.shape == items.shape == days.shape == y.shape == (n,)
    assert users.max() < SHAPE["n_users"] and items.max() < SHAPE["n_items"]
    assert days.max() < SHAPE["n_days"]
    # every user has at least 20 ratings; ratings are half stars
    assert (np.bincount(users, minlength=SHAPE["n_users"]) >= 20).all()
    assert ((y * 2) % 1 == 0).all() and y.min() >= 0.5 and y.max() <= 5


def test_phase_gram(design):
    users, items, days, _ = design
    checked = chip_smoke.phase_gram(
        users, items, days, ranks=(4, 16), rows_cap=2048, shape=SHAPE
    )
    assert checked == {4: ["xla"], 16: ["xla"]}


def test_phase_fit(design, capsys):
    chip_smoke.phase_fit(
        *design, rank=4, n_iter=4, n_predict=4000, expect_kernel=False,
        shape=SHAPE,
    )
    out = capsys.readouterr().out
    assert "engine=fastpath" in out and "gram impl: xla" in out


def test_phase_chain(design):
    chip_smoke.phase_chain(*design, n=6000, rank=4, shape=SHAPE)


def test_phase_vi(design):
    chip_smoke.phase_vi(*design, rank=4, n_iter=4, shape=SHAPE)


def test_phase_tasks(design):
    chip_smoke.phase_tasks(
        *design, n=8000, rank=4, n_iter=3, shape=SHAPE,
        joint_shape=(2000, 40, 50),
    )


def test_phase_sharded_on_virtual_mesh(design):
    chip_smoke.phase_sharded(*design, 4, rank=4, n_iter=3, shape=SHAPE)


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines and "no GPU" in lines[-1]
    with pytest.raises(json.JSONDecodeError):
        json.loads(lines[-1])
