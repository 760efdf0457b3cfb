"""The port's dry-run collectives on the prefill path held against the
JAX dry-run's, on ``tiny`` (2 x 2), as
``tests/test_torch_dryrun_collectives.py`` holds the decode steps' (and
``tests/test_torch_dryrun_train_collectives.py`` the training steps').

Pairs: Mamba2, Hymba, SeamlessM4T and InternVL2 at ``prefill_32k``, their
sequences cut to 2048 tokens.  The reference's dry-run runs in one
subprocess a shape (8 forced host devices) while the port's runs here;
both are read at one width, every floating payload at 4 bytes an
element.  For each pair:

- the calibrated total and per-layer collective bytes lie within a
  factor of 2 of the reference's both ways (Mamba2's and Hymba's were
  13.4x and 7.7x a layer), at most 1.37x and 1.39x for SeamlessM4T and
  InternVL2 (their ratios before the dry-run's prefill layout), and
  ``outside`` is not negative;
- no dense gathers its activation once per projection: the weight is
  gathered where x is sharded on its batch or sequence (SeamlessM4T's
  encoder gathers its normed x once for all its projections, as the
  reference does, and no more often);
- Mamba2's and Hymba's mixer: the chunked SSD issues no collective inside
  its chunks and moves the chunk states once a layer, at no more than the
  reference's bytes; the causal conv moves only its halo, by
  collective-permute, the reference's kind; the cache tail is an
  all-gather of the last rows, and nothing is all-to-all'ed; Hymba's
  branch norms reduce no partial sum.

Then the pieces the dry-run's shard-local SSD and conv take from the
model (``mamba.ssd_chunk_terms`` and ``mamba.ssd_chunk_output`` per
shard; ``mamba._causal_conv`` after a halo), on plain tensors split into
shards, hold ``mamba.ssd_chunked`` (y and the final state, a ragged last
chunk included) and the whole conv to 1e-6.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun_collectives import (  # noqa: E402
    REPO, _line_of, hlo_collectives, port_sites, reference_at_f32)

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.models import layers, mamba  # noqa: E402

MESH = "tiny"
SHAPES = {"prefill_32k": (2048, ("mamba2-370m", "hymba-1.5b",
                                 "seamless-m4t-large-v2", "internvl2-26b"))}
PAIRS = [a for _, archs in SHAPES.values() for a in archs]
SSM = ("mamba2-370m", "hymba-1.5b")
# the per-layer ratios before the dry-run's prefill layout, not exceeded
CEILING = {"seamless-m4t-large-v2": 1.37, "internvl2-26b": 1.39}

# argv: shape, its sequence cut, archs.  The reference's calibrated costs
# and its 1- and 2-layer compiled HLO texts, without the full-depth
# compile ``lower_and_compile`` adds (which no comparison reads)
_REFERENCE = r"""
import dataclasses, json, sys
from repro import configs
from repro.configs import shapes
from repro.launch import dryrun
from repro.launch.mesh import make_mesh
shape, seq = sys.argv[1], int(sys.argv[2])
shapes.SHAPES[shape] = dataclasses.replace(shapes.SHAPES[shape], seq_len=seq)
texts = []
costs = dryrun._costs
def keep(compiled, chips):
    texts.append(compiled.as_text())
    return costs(compiled, chips)
dryrun._costs = keep
mesh = make_mesh(%r)
out = {}
for arch in sys.argv[3:]:
    texts.clear()
    cal = dryrun.calibrated_costs(configs.get_config(arch),
                                  configs.get_shape(shape), mesh)
    out[arch] = {"calibrated": cal, "hlo_L1": texts[0], "hlo_L2": texts[1]}
print(json.dumps(out))
""" % MESH


def _start_reference(*archs, shape, seq):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    return subprocess.Popen([sys.executable, "-c", _REFERENCE, shape,
                             str(seq), *archs],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs():
    """{arch: (reference, port record)}: one reference subprocess a shape
    while the port's runs go here."""
    procs = {shape: _start_reference(*archs, shape=shape, seq=seq)
             for shape, (seq, archs) in SHAPES.items()}
    try:
        port = {}
        for shape, (seq, archs) in SHAPES.items():
            saved = configs.SHAPES[shape]
            configs.SHAPES[shape] = dataclasses.replace(saved, seq_len=seq)
            try:
                port.update({arch: dryrun.lower_and_compile(
                    arch, shape, MESH, verbose=False) for arch in archs})
            finally:
                configs.SHAPES[shape] = saved
        ref = {}
        for proc in procs.values():
            out, err = proc.communicate(timeout=400)
            assert proc.returncode == 0, err[-3000:]
            ref.update(json.loads(out.splitlines()[-1]))
    finally:
        for proc in procs.values():
            proc.kill()
    assert not torch.distributed.is_initialized()
    return {arch: (ref[arch], port[arch]) for arch in PAIRS}


def _layer(sites_of, record):
    """Per-layer counts and bytes of ``sites_of(L)``'s (kind, dims,
    bytes, frames) sites: the 2-layer run's less the 1-layer run's."""
    one, two = (sites_of(record, k) for k in (1, 2))
    return len(two) - len(one), sum(s[2] for s in two) - sum(
        s[2] for s in one)


def _port(record, k):
    """[(kind, dims, bytes at f32, frames)] of the k-layer run, one entry
    a collective."""
    sites = record["coll_sites"][f"L{k}"]
    return [(kind, dims, nbytes // n, frames)
            for (n, _), (kind, dims, nbytes, frames) in zip(
                sites.values(), port_sites(sites), strict=True)
            for _ in range(n)]


def _at(sites, fn, text):
    """The sites with a frame at ``fn``'s source line holding ``text``."""
    line = f"{fn.__code__.co_filename.split('repro_torch/')[-1]}:" \
        f"{_line_of(fn, text)}"
    return [s for s in sites if line in s[3]]


@pytest.mark.parametrize("arch", PAIRS)
def test_collective_bytes_within_bounds_of_reference(runs, arch):
    ref, port = runs[arch]
    rc = ref["calibrated"]
    assert reference_at_f32(ref, arch, f32=False) == (
        rc["coll_bytes"], rc["per_layer"]["coll_bytes"],
        rc["outside"]["coll_bytes"])
    r, p = reference_at_f32(ref, arch), dryrun.collectives_at_f32(port)
    top = CEILING.get(arch, 2.0)
    for name, want, got in (("total", r[0], p["coll_bytes"]),
                            ("per layer", r[1], p["per_layer"])):
        assert 0.5 <= got / want <= top, \
            f"{arch} {name}: {got:.4g} vs {want:.4g}"
    assert p["outside"] >= 0
    assert port["calibrated"]["outside"]["coll_bytes"] >= 0


def _is_weight(dims, cfg):
    """Whether an all-gather's recorded dims are a weight's (a, b) of the
    config: gathered on its rows, or on its columns over the model axis's
    2 devices (DTensor gathers on dim 0 and then moves the pieces)."""
    return any(tuple(dims) in ((a, b), (2 * a, b // 2)) for a, b in {
        tuple(t.shape[-2:]) for t in torch.utils._pytree.tree_leaves(
            steps.abstract_params(cfg)) if t.ndim >= 2})


@pytest.mark.parametrize("arch", PAIRS)
def test_dense_gathers_weights_not_activations(runs, arch):
    ref, port = runs[arch]
    cfg = configs.get_config(arch)

    def activations(record, k):
        return [s for s in _at(_port(record, k), layers.dense,
                               'ops.dense(x, params["w"])')
                if s[0] == "all-gather" and not _is_weight(s[1], cfg)]

    def ref_activations(record, k):
        return [c for c in hlo_collectives(ref[f"hlo_L{k}"])
                if c[0] == "all-gather" and "dot_general" in c[3]
                and len(c[1][0][1]) == 3]
    n, _ = _layer(activations, port)
    assert activations(port, 1) == [] or cfg.arch_type == "encdec"
    assert n <= _layer(ref_activations, ref)[0]
    # every projection's weight moves at most by all-gather
    assert {s[0] for s in _at(_port(port, 1), layers.dense,
                              'ops.dense(x, params["w"])')} <= {
        "all-gather", "all-reduce"}


@pytest.mark.parametrize("arch", SSM)
def test_ssd_moves_only_the_chunk_states(runs, arch):
    ref, port = runs[arch]
    sites = _port(port, 1)
    lines = range(mamba.ssd_chunked.__code__.co_firstlineno,
                  mamba._causal_conv.__code__.co_firstlineno)
    assert not [s for s in sites if s[3][0].startswith("models/mamba.py:")
                and int(s[3][0].split(":")[1]) in lines]
    at = _at(sites, mamba.mamba_mixer, "y = ssd_chunked(")
    assert sorted((s[0], len(s[1])) for s in at) == [
        ("all-gather", 3), ("all-gather", 5)]
    states = [c for c in hlo_collectives(ref["hlo_L1"])
              if c[0] == "all-gather" and len(c[1][0][1]) == 5]
    assert len(states) == 1
    assert next(s[2] for s in at if len(s[1]) == 5) <= states[0][2]
    n, _ = _layer(lambda r, k: _at(_port(r, k), mamba.mamba_mixer,
                                   "y = ssd_chunked("), port)
    assert n == 2                            # the states and the decays


@pytest.mark.parametrize("arch", SSM)
def test_conv_moves_its_halo_and_the_tail_its_rows(runs, arch):
    ref, port = runs[arch]
    hlo = hlo_collectives(ref["hlo_L1"])
    sites = _port(port, 1)
    conv = _at(sites, mamba.mamba_mixer, "conv_out = _causal_conv(")
    permutes = [c for c in hlo if c[0] == "collective-permute"
                and "while/body" in c[3]]
    assert {s[0] for s in conv} == {c[0] for c in permutes}
    assert sum(s[2] for s in conv) <= sum(c[2] for c in permutes)
    tail = _at(sites, mamba.mamba_mixer, '"conv": _conv_tail(')
    ref_tail = [c for c in hlo if c[0] == "all-gather" and not c[3]]
    assert [s[0] for s in tail] == [c[0] for c in ref_tail] == ["all-gather"]
    assert tail[0][2] <= 2 * ref_tail[0][2]
    assert not [s for k in (1, 2) for s in _port(port, k)
                if s[0] == "all-to-all"]


def test_hybrid_mix_reduces_no_partial_sum(runs):
    """Hymba's branch norms take the branches' outputs sequence-sharded,
    where the port's had all-reduced their f32 partial sums; the
    reference's layer has no all-reduce either."""
    ref, port = runs["hymba-1.5b"]
    assert _layer(lambda r, k: [s for s in _port(r, k)
                                if s[0] == "all-reduce"], port) == (0, 0)
    assert _layer(lambda r, k: [c for c in hlo_collectives(r[f"hlo_L{k}"])
                                if c[0] == "all-reduce"], ref)[0] == 0


# ----------------------------------------------------------------------
# The shard-local SSD and conv on plain tensors
# ----------------------------------------------------------------------
@pytest.mark.parametrize("L, Q, sizes", [
    (64, 8, (16, 16, 16, 16)),
    (60, 8, (16, 16, 16, 12)),          # a ragged last chunk
    (45, 16, (32, 13)),
    (24, 32, (24,))])                   # one shard, shorter than a chunk
def test_shard_local_ssd_equals_ssd_chunked(L, Q, sizes):
    """y and the final state of ``mamba.ssd_chunk_terms`` per shard, the
    chunk states and decays of all shards concatenated, then
    ``mamba.ssd_chunk_output`` per shard from its first chunk, as the
    dry-run's sequence-sharded SSD takes them, against
    ``mamba.ssd_chunked`` on the whole sequence, to 1e-6."""
    g = torch.Generator().manual_seed(L + Q)
    b, H, P, N = 2, 3, 4, 5
    x = torch.randn(b, L, H, P, generator=g)
    dt = torch.rand(b, L, H, generator=g)
    A = -0.5 - torch.rand(H, generator=g)
    B, C = (torch.randn(b, L, N, generator=g) for _ in range(2))
    D = torch.randn(H, generator=g)
    want_y, want_state = mamba.ssd_chunked(x, dt, A, B, C, D, chunk=Q,
                                           return_final_state=True)
    Q = min(Q, L)
    pieces = list(zip(*(torch.split(t, list(sizes), dim=1)
                        for t in (x, dt, B, C))))
    terms = [mamba.ssd_chunk_terms(xs, ds, A, Bs, Cs, Q)
             for xs, ds, Bs, Cs in pieces]
    states = torch.cat([t.states for t in terms], dim=1)
    decays = torch.cat([t.decays for t in terms], dim=1)
    ys, first = [], 0
    for (xs, *_), t in zip(pieces, terms, strict=True):
        y, state = mamba.ssd_chunk_output(xs, D, t, states, decays, first)
        ys.append(y)
        first += t.states.shape[1]
        torch.testing.assert_close(state, want_state, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat(ys, dim=1), want_y, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("sizes", [(8, 8, 8), (12, 12), (24,), (3, 21)])
def test_halo_conv_equals_causal_conv(sizes):
    """Each shard's conv after the k - 1 rows before it (zeros for the
    first), as the dry-run's halo conv takes it, concatenated, against
    ``mamba._causal_conv`` on the whole sequence; and the tail is the
    last shard's last rows."""
    g = torch.Generator().manual_seed(len(sizes))
    x = torch.randn(2, sum(sizes), 6, generator=g)
    w = torch.randn(4, 6, generator=g)
    b = torch.randn(6, generator=g)
    k = w.shape[0]
    want = mamba._causal_conv(x, w, b)
    shards = torch.split(x, list(sizes), dim=1)
    got = [mamba._causal_conv(
        s, w, b, shards[i - 1][:, -(k - 1):] if i else
        torch.zeros_like(s[:, :k - 1])) for i, s in enumerate(shards)]
    torch.testing.assert_close(torch.cat(got, dim=1), want, rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(shards[-1][:, -(k - 1):],
                       mamba._conv_tail(x, k, x.dtype))
