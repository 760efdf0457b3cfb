"""The port's copies of IDPA (``core/idpa.py``), the fault schedules
(``core/faults.py``) and the data pipeline (``data/pipeline.py``) against
the reference's: each scenario, over the cases of ``tests/test_idpa.py``,
runs on both packages and must give bit-identical allocations, churn
masks, state dicts, batches and error messages."""
import numpy as np
import pytest

from repro.core import faults as jfaults
from repro.core import idpa as jidpa
from repro.data import pipeline as jpipeline
from repro_torch.core import faults, idpa
from repro_torch.data import pipeline

REF = (jidpa, jpipeline, jfaults)
PORT = (idpa, pipeline, faults)


def _drive(p, t, active_fn=None):
    """first_batch, then next_batch from durations t * n_j until done."""
    out = [p.first_batch()]
    k = 0
    while not p.done:
        active = active_fn(k) if active_fn else None
        out.append(p.next_batch(t * np.maximum(p.totals, 1), active=active))
        k += 1
    return out + [p.totals.copy(), p.per_sample_time.copy()
                  if hasattr(p, "per_sample_time") else None]


def _random_churn(mod, m, a, seed, mode):
    """tests/test_idpa.py's random-churn property, one fixed draw."""
    rng = np.random.default_rng(seed)
    N = 200 * m
    p = mod.IDPAPartitioner(N, m, a, frequencies=1 + rng.random(m),
                            mode=mode)
    out = [p.first_batch()]
    while not p.done:
        active = rng.random(m) > 0.3
        if not active.any():
            active[int(rng.integers(m))] = True
        durs = (0.2 + rng.random(m)) * np.maximum(p.totals, 1)
        if rng.random() < 0.3 and active.sum() > 1:
            durs[int(np.flatnonzero(active)[0])] = np.inf
        out.append(p.next_batch(durs, active=active))
    return out + [p.state_dict()]


def _invariants(mod, m, a, n_per, seed, mode):
    rng = np.random.default_rng(seed)
    t = 0.25 + rng.random(m)
    p = mod.IDPAPartitioner(n_per * m, m, a, frequencies=1 / t, mode=mode)
    return _drive(p, t) + [p.history]


def _churn_cases(mod):
    out = []
    p = mod.IDPAPartitioner(1200, 4, 2, frequencies=[1, 2, 1, 2])
    out.append(p.first_batch(active=[True, False, True, True]))
    p = mod.IDPAPartitioner(4000, 4, 2, frequencies=np.ones(4))
    p.first_batch()
    t = np.array([2.0, 1.0, 1.0, 1.0])
    out.append(p.next_batch(t * np.maximum(p.totals, 1),
                            active=[True, True, True, False]))
    p = mod.IDPAPartitioner(1000, 4, 2, frequencies=np.ones(4))
    p.first_batch()
    out.append(p.next_batch(np.array([1.0, np.inf, 1.0, 1.0])
                            * np.maximum(p.totals, 1)))
    p = mod.IDPAPartitioner(1000, 3, 2, frequencies=np.ones(3))
    p.first_batch()
    out.append(p.next_batch([100.0, -1.0, 100.0],
                            active=[True, False, True]))
    p = mod.IDPAPartitioner(1200, 3, 3, frequencies=np.ones(3))
    p.first_batch()
    p.next_batch(np.maximum(p.totals, 1).astype(float),
                 active=[True, True, False])
    out.append(p.next_batch(np.maximum(p.totals, 1).astype(float)))
    p = mod.UDPAPartitioner(900, 3, 3)
    p.first_batch()
    out.append(p.next_batch(active=[True, False, True]))
    p = mod.UDPAPartitioner(1200, 4, 3)
    out.append(p.allocate_all())
    return out


def _state_round_trip(mod, other):
    """A partitioner's state mid-churn, loaded into a fresh one of the
    ``other`` package, continues with the identical next allocation."""
    p = mod.IDPAPartitioner(2000, 4, 4, frequencies=[1, 2, 1, 2])
    p.first_batch()
    p.next_batch(np.maximum(p.totals, 1).astype(float),
                 active=[True, True, True, False])
    q = other.IDPAPartitioner(2000, 4, 4, frequencies=[1, 2, 1, 2])
    q.load_state_dict(p.state_dict())
    assert q.state_dict() == p.state_dict()
    t = np.array([1.0, 0.5, 1.0, 0.5])
    return [p.next_batch(t * np.maximum(p.totals, 1)),
            q.next_batch(t * np.maximum(q.totals, 1)), q.state_dict()]


def _errors(mod):
    """The error messages, in order."""
    def msg(fn):
        try:
            fn()
        except (ValueError, RuntimeError) as e:
            return f"{type(e).__name__}: {e}"
        return "no error"

    part = mod.IDPAPartitioner
    p = part(1000, 2, 2, frequencies=np.ones(2))
    p.first_batch()
    q = part(1000, 4, 2, frequencies=np.ones(4))
    return [msg(lambda: mod.effective_iterations(4, 4)),
            msg(lambda: mod.effective_iterations(4, 0)),
            msg(lambda: part(1000, 4, 2, frequencies=np.ones(4))
                .first_batch(active=[True, False])),
            msg(lambda: part(1000, 4, 2, frequencies=np.ones(4))
                .first_batch(active=np.zeros(4, dtype=bool))),
            msg(lambda: p.next_batch([np.inf, np.inf])),
            msg(lambda: q.next_batch(np.ones(4))),
            msg(lambda: part(1000, 4, 2, frequencies=[1, 1, 1])),
            msg(lambda: part(1000, 4, 2, frequencies=np.ones(4),
                             mode="fast")),
            msg(lambda: part(3, 4, 2, frequencies=np.ones(4))),
            msg(lambda: mod.UDPAPartitioner(100, 0, 2))]


def _pipeline(pipe, uneven, partitioning, mode):
    xs = np.arange(300 * 4, dtype=np.float32).reshape(300, 2, 2)
    ys = np.arange(300, dtype=np.int32) % 7
    speeds = np.array([1.0, 1.3, 1.7, 2.2])
    ds = pipe.IDPADataset({"images": xs, "labels": ys}, num_nodes=4,
                          batches=3, frequencies=1.0 / speeds,
                          partitioning=partitioning, idpa_mode=mode)
    rng = np.random.default_rng(7)
    out = [ds.totals.copy(), ds.node_views(),
           ds.node_round_batch_sizes(16)]
    out.append(ds.stacked_round_batches(16, 2, rng, uneven=uneven))
    out.append(ds.report_durations(speeds * np.maximum(ds.totals, 1)))
    out.append(ds.node_batch(2, 16, rng))
    out.append(ds.report_durations(speeds * np.maximum(ds.totals, 1),
                                   active=[True, False, True, True]))
    out += [ds.totals.copy(), ds.state_dict(),
            ds.stacked_round_batches(16, 3, rng, uneven=uneven),
            ds.report_durations(np.ones(4)), ds.node_round_batch_sizes(40)]
    corpus = np.arange(50, dtype=np.int64)
    out.append(pipe.host_batch(pipe.pack_sequences(corpus, 7)))
    return out


def _faults(mod):
    f = mod.FaultSchedule.from_spec("fail:1@3,rejoin:1@6,slow:2@4x2.5",
                                    num_nodes=4)
    out = [[(e.round, e.node, e.kind, e.factor) for e in f],
           [f.status_at(r, 4) for r in range(8)],
           [f.alive_at(r, 4) for r in range(8)],
           [(e.round, e.node, e.kind) for e in f.between(2, 5)], f.empty]
    for spec in ("fail:1@3,fail:1@4", "rejoin:0@2", "boom:1@2",
                 "slow:1@2x0", "fail:5@1"):
        try:
            mod.FaultSchedule.from_spec(spec, num_nodes=4)
            out.append("no error")
        except ValueError as e:
            out.append(str(e))
    return out


def _same(a, b, path="out"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), \
            (path, a, b)


SCENARIOS = {
    "eq6_and_balance": lambda i, p, f: (
        [i.effective_iterations(K, A) for K in range(2, 30)
         for A in range(1, K)]
        + [i.workload_balance_degree(x) for x in
           ([], [0, 0], [1.0, 3.0, 2.0], [0.1, 100.0], [5.0])]),
    "first_batch_eq2": lambda i, p, f: [
        i.IDPAPartitioner(1000, 4, 2, frequencies=[1, 1, 1, 1])
        .first_batch(),
        i.IDPAPartitioner(1000, 2, 2, frequencies=[1, 3]).first_batch()],
    "churn_cases": lambda i, p, f: _churn_cases(i),
    "errors": lambda i, p, f: _errors(i),
    "faults": lambda i, p, f: _faults(f),
    **{f"drive_{mode}_{seed}": (
        lambda i, p, f, mode=mode, seed=seed: _drive(
            i.IDPAPartitioner(8000, 4, 4, frequencies=1 / (
                0.5 + np.random.default_rng(seed).random(4)), mode=mode),
            0.5 + np.random.default_rng(seed).random(4)))
       for mode in ("paper", "balanced") for seed in (0, 3)},
    **{f"invariants_{m}_{a}_{n}_{s}_{mode}": (
        lambda i, p, f, m=m, a=a, n=n, s=s, mode=mode: _invariants(
            i, m, a, n, s, mode))
       for m, a, n, s, mode in ((2, 1, 50, 0, "paper"),
                                (3, 4, 120, 5, "balanced"),
                                (5, 5, 400, 17, "paper"),
                                (8, 6, 500, 99, "balanced"),
                                (7, 3, 77, 42, "paper"))},
    **{f"random_churn_{m}_{a}_{s}_{mode}": (
        lambda i, p, f, m=m, a=a, s=s, mode=mode: _random_churn(
            i, m, a, s, mode))
       for m, a, s, mode in ((2, 2, 0, "paper"), (4, 5, 11, "balanced"),
                             (8, 3, 123, "balanced"), (6, 4, 500, "paper"))},
    **{f"pipeline_{part}_{mode}_{'uneven' if u else 'even'}": (
        lambda i, p, f, u=u, part=part, mode=mode: _pipeline(
            p, u, part, mode))
       for part, mode in (("idpa", "balanced"), ("idpa", "paper"),
                          ("udpa", "paper"))
       for u in (False, True)},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_is_bit_identical_to_the_reference(name):
    _same(SCENARIOS[name](*REF), SCENARIOS[name](*PORT))


@pytest.mark.parametrize("src,dst", [(REF, PORT), (PORT, REF)],
                         ids=["ref_to_port", "port_to_ref"])
def test_partitioner_state_crosses_packages(src, dst):
    a, b, state = _state_round_trip(src[0], dst[0])
    np.testing.assert_array_equal(a, b)
    _same(state, _state_round_trip(REF[0], REF[0])[2])


def test_dataset_state_round_trip():
    xs, ys = np.zeros((400, 1), np.float32), np.zeros(400, np.int32)
    kw = dict(num_nodes=4, batches=4, frequencies=[1, 2, 1, 2])
    src = pipeline.IDPADataset({"x": xs, "y": ys}, **kw)
    src.report_durations(np.maximum(src.totals, 1).astype(float),
                         active=[True, True, False, True])
    ref = jpipeline.IDPADataset({"x": xs, "y": ys}, **kw)
    ref.load_state_dict(src.state_dict())
    dst = pipeline.IDPADataset({"x": xs, "y": ys}, **kw)
    dst.load_state_dict(ref.state_dict())
    durs = np.array([1.0, 0.5, 1.0, 0.5])
    for d in (src, ref, dst):
        d.report_durations(durs * np.maximum(d.totals, 1))
    _same(ref.state_dict(), src.state_dict())
    _same(ref.state_dict(), dst.state_dict())
