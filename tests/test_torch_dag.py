"""The port's ``core/dag.py`` (Alg. 4.2) against the reference's: the
tiles ``choose_oc_tile`` and ``choose_fc_block`` pick, the task DAG's
levels and priorities, and ``priority_schedule(...).summary()``, over
``tests/test_dag.py``'s grids and seeds.  Both are pure Python, so the
answers must be equal, not close."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import dag as jdag  # noqa: E402
from repro_torch.core import dag  # noqa: E402

CONV_GRID = [(1, 4), (2, 16), (8, 32), (3, 12), (16, 128), (4, 4),
             (1, 128), (64, 32), (1, 64), (2, 32), (5, 16), (32, 12),
             (16, 12), (64, 10)]
FC_GRID = [1, 4, 10, 64, 128, 500, 512, 1000, 1500, 2000, 250, 750, 1023]
WORKERS = [1, 2, 8, 16]


@pytest.mark.parametrize("workers", WORKERS)
def test_choose_oc_tile_equals_the_reference(workers):
    for batch, cout in CONV_GRID:
        assert dag.choose_oc_tile(batch, cout, workers=workers) == \
            jdag.choose_oc_tile(batch, cout, workers=workers), (batch, cout)


@pytest.mark.parametrize("workers", WORKERS)
def test_choose_fc_block_equals_the_reference(workers):
    for d_out in FC_GRID:
        assert dag.choose_fc_block(d_out, workers=workers) == \
            jdag.choose_fc_block(d_out, workers=workers), d_out


def test_choosers_refuse_as_the_reference():
    for fn, args in ((dag.choose_oc_tile, (0, 4)),
                     (dag.choose_oc_tile, (4, 0)),
                     (dag.choose_fc_block, (0,))):
        with pytest.raises(ValueError) as got:
            fn(*args)
        with pytest.raises(ValueError) as want:
            getattr(jdag, fn.__name__)(*args)
        assert str(got.value) == str(want.value)
    for fn, kw in ((dag.conv_grid_tasks, dict(batch=1, cout=16, oc_tile=5)),
                   (dag.fc_grid_tasks, dict(d_out=64, block=5))):
        with pytest.raises(ValueError):
            fn(dag.TaskDAG(), **kw)


SPECS = [
    [{"kind": "conv", "hx": 8, "wx": 8, "hf": 3, "wf": 3, "depth": 3},
     {"kind": "pool", "hx": 8, "wx": 8, "k": 2},
     {"kind": "fc", "in": 128, "out": 64}],
    [{"kind": "conv", "hx": 16, "wx": 16, "hf": 3, "wf": 3, "depth": 3,
      "pad": 1},
     {"kind": "conv", "hx": 16, "wx": 16, "hf": 3, "wf": 3, "depth": 8,
      "pad": 1},
     {"kind": "pool", "hx": 16, "wx": 16, "k": 2},
     {"kind": "fc", "in": 512, "out": 500, "block": 100},
     {"kind": "fc", "in": 500, "out": 10}],
]


def _tasks(d):
    return [(t.tid, t.name, t.cost, t.deps, t.level, t.priority)
            for t in d.tasks.values()]


@pytest.mark.parametrize("spec", range(len(SPECS)))
@pytest.mark.parametrize("tile", [1, 2, 4])
@pytest.mark.parametrize("threads", [1, 2, 4, 8])
def test_training_dag_and_schedule_equal_the_reference(spec, tile,
                                                       threads):
    got = dag.cnn_training_dag(SPECS[spec], tile=tile)
    want = jdag.cnn_training_dag(SPECS[spec], tile=tile)
    r, wr = dag.priority_schedule(got, threads), \
        jdag.priority_schedule(want, threads)
    assert _tasks(got) == _tasks(want)       # levels and priorities too
    assert r.summary() == wr.summary()
    np.testing.assert_array_equal(r.thread_busy, wr.thread_busy)
    assert got.critical_path() == want.critical_path()


@pytest.mark.parametrize("seed", range(0, 100, 9))
@pytest.mark.parametrize("threads", [1, 3, 12])
def test_random_dags_schedule_as_the_reference(seed, threads):
    """``tests/test_dag.py``'s random DAGs, built alike in both."""
    built = []
    for mod in (dag, jdag):
        rng = np.random.default_rng(seed)
        d = mod.TaskDAG()
        tids = []
        for i in range(2 + seed % 39):
            k = rng.integers(0, min(i, 3) + 1)
            deps = rng.choice(tids, size=k, replace=False) \
                if tids and k else []
            tids.append(d.add(f"t{i}", float(rng.random() + 0.1),
                              deps=list(deps)))
        built.append((d, mod.priority_schedule(d, threads)))
    (d, r), (wd, wr) = built
    assert r.summary() == wr.summary()
    assert _tasks(d) == _tasks(wd)
    assert r.waiting_time == wr.waiting_time


def test_cycle_is_refused_as_the_reference():
    for mod in (dag, jdag):
        d = mod.TaskDAG()
        a = d.add("a", 1.0, deps=[1])
        d.add("b", 1.0, deps=[a])
        with pytest.raises(ValueError, match="cycle"):
            d.mark_priorities()
