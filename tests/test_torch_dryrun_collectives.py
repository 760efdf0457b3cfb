"""The port's dry-run collectives held against the JAX dry-run's, on the
five ``decode_32k`` pairs on ``tiny`` (2 x 2).

The reference's dry-run (``repro.launch.dryrun.lower_and_compile``,
calibrated) runs in a subprocess with 8 forced host devices and returns
its ``calibrated`` dict and its 1- and 2-layer compiled HLO texts, whose
collectives (kind, shapes, ``op_name``) the test reads; the port's runs
in-process while it works.  The two are compared at one width: every
floating payload of either side at 4 bytes an element, as the
reference's host-compiled HLO carries them (the port's
records keep each payload's true bytes; ``dryrun.collectives_at_f32``).
For each pair:

- the calibrated total and per-layer collective bytes agree within a
  factor of 2 both ways (so Mamba2's and Hymba's per-layer bytes are no
  longer the SSM state's or decode attention's p's traffic), and
  ``outside`` is not negative;
- at each of the four sites the port issues the reference's kind on the
  reference's bytes: an all-reduce of the looked-up rows (no move of the
  vocab-sharded table), the logits gathered by the step's out sharding,
  the SSM state moved exactly where the reference moves it (never for
  Mamba2, one all-gather into Hymba's replicated cache), and for decode
  attention's ``p @ v`` over the sequence-sharded cache an all-reduce
  of the softmax max and of the partial o, never p;
- Mamba2's in-projection split on its output columns as the
  reference's is, the slices of its output and of the conv's realigned
  by collective-permutes, as the reference's are, not gathered whole;
  its per-layer bytes at most 1.1x the reference's.

Run as a script, it prints both packages' collectives for one pair on
``tiny``, at both widths, and each collective of the 1-layer run:
``python tests/test_torch_dryrun_collectives.py hymba-1.5b`` (its
``decode_32k``), or another shape, its sequence optionally cut:
``python tests/test_torch_dryrun_collectives.py mamba2-370m prefill_32k
2048``.
"""
import dataclasses
import inspect
import json
import math
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import attention, mamba  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = ("yi-6b", "phi3-mini-3.8b", "mamba2-370m", "hymba-1.5b",
         "qwen3-moe-30b-a3b")
SHAPE, MESH = "decode_32k", "tiny"

# argv: shape, its sequence cut (0: as it is), archs
_REFERENCE = r"""
import dataclasses, json, sys
from repro.configs import shapes
from repro.launch import dryrun
shape, seq = sys.argv[1], int(sys.argv[2])
if seq:
    shapes.SHAPES[shape] = dataclasses.replace(shapes.SHAPES[shape],
                                               seq_len=seq)
texts = []
costs = dryrun._costs
def keep(compiled, chips):
    texts.append(compiled.as_text())
    return costs(compiled, chips)
dryrun._costs = keep
out = {}
for arch in sys.argv[3:]:
    texts.clear()
    res = dryrun.lower_and_compile(arch, shape, %r, verbose=False)
    # lower_and_compile compiles the full step, then 1 and 2 layers
    out[arch] = {"calibrated": res["calibrated"], "hlo_L1": texts[1],
                 "hlo_L2": texts[2]}
print(json.dumps(out))
""" % MESH

_COLL = re.compile(r"= (\(.*?\)|\S+) (all-reduce|all-gather|all-to-all|"
                   r"collective-permute|reduce-scatter)(?:-start)?\(")
_ITEMSIZE = {"f32": 4, "bf16": 2, "s32": 4, "u32": 4, "f16": 2, "pred": 1}
_FLOATS = ("f32", "bf16", "f16")


def hlo_collectives(text, f32=True):
    """[(kind, [(dtype, dims)], bytes, op_name)] of a compiled HLO text,
    the bytes on one device, each floating payload at 4 bytes an element
    (``f32``) or at its own width."""
    out = []
    for line in text.splitlines():
        m = _COLL.search(line)
        if m is None:
            continue
        shapes = [(dt, [int(d) for d in dims.split(",") if d])
                  for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]",
                                             m.group(1))]
        name = re.search(r'op_name="([^"]*)"', line)
        out.append((m.group(2), shapes,
                    sum((4 if f32 and dt in _FLOATS else _ITEMSIZE[dt])
                        * math.prod(d) for dt, d in shapes),
                    name.group(1) if name else ""))
    return out


def reference_at_f32(ref, arch, f32=True):
    """The reference's calibrated collective bytes from its HLO texts
    (total, per layer, outside), extrapolated as its dry-run does."""
    per = {k: 4 * sum(c[2] for c in hlo_collectives(ref[f"hlo_L{k}"], f32))
           for k in (1, 2)}                          # 4 devices on tiny
    L = configs.get_config(arch).num_layers
    dc = per[2] - per[1]
    return per[1] + (L - 1) * dc, dc, per[1] - dc


def port_sites(sites):
    """[(kind, dims, bytes, frames)] of a port record's ``coll_sites``,
    each floating payload at 4 bytes an element."""
    out = []
    for key, (_, nbytes) in sites.items():
        head, frames = key.split(" @ ")
        kind, _, typed = head.split(" ")
        dtype = getattr(torch, typed[:typed.index("[")])
        if dtype.is_floating_point:
            nbytes = nbytes * 4 // dtype.itemsize
        dims = json.loads(typed[typed.index("["):])
        out.append((kind, dims, nbytes, frames.split(" < ")))
    return out


def _start_reference(*archs, shape=SHAPE, seq=0):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    return subprocess.Popen([sys.executable, "-c", _REFERENCE, shape,
                             str(seq), *archs],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs():
    """The reference's five runs in a subprocess while the port's five
    run here; {arch: (reference, port record)}."""
    proc = _start_reference(*PAIRS)
    try:
        port = {arch: dryrun.lower_and_compile(arch, SHAPE, MESH,
                                               verbose=False)
                for arch in PAIRS}
        out, err = proc.communicate(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    assert not torch.distributed.is_initialized()
    ref = json.loads(out.splitlines()[-1])
    return {arch: (ref[arch], port[arch]) for arch in PAIRS}


def _line_of(fn, text):
    """The file line of ``fn``'s source line that holds ``text``."""
    lines, start = inspect.getsourcelines(fn)
    return start + next(i for i, s in enumerate(lines) if text in s)


@pytest.mark.parametrize("arch", PAIRS)
def test_collective_bytes_within_2x_of_reference(runs, arch):
    ref, port = runs[arch]
    rc = ref["calibrated"]
    # the HLO read here counts what the reference's own dry-run counts
    assert reference_at_f32(ref, arch, f32=False) == (
        rc["coll_bytes"], rc["per_layer"]["coll_bytes"],
        rc["outside"]["coll_bytes"])
    r, p = reference_at_f32(ref, arch), dryrun.collectives_at_f32(port)
    for name, want, got in (("total", r[0], p["coll_bytes"]),
                            ("per layer", r[1], p["per_layer"])):
        assert 0.5 <= got / want <= 2.0, \
            f"{arch} {name}: {got:.4g} vs {want:.4g}"
    assert p["outside"] >= 0
    assert port["calibrated"]["outside"]["coll_bytes"] >= 0


@pytest.mark.parametrize("arch", PAIRS)
def test_embedding_and_logits_sites(runs, arch):
    """The looked-up rows all-reduced (the table never moves) and the
    logits gathered, each on the reference's bytes (at f32 width)."""
    ref, port = runs[arch]
    cfg = configs.get_config(arch)
    hlo = hlo_collectives(ref["hlo_L1"])
    sites = port_sites(port["coll_sites"]["L1"])
    ref_rows = [c for c in hlo if "(_take)/gather" in c[3]]
    rows = [s for s in sites if s[3][0].startswith("models/lm.py")]
    # Hymba's 32001 rows are not vocab-sharded: neither moves anything
    sharded = cfg.vocab_size % 2 == 0
    assert [c[0] for c in ref_rows] == [s[0] for s in rows] == \
        ["all-reduce"] * sharded
    assert [c[2] for c in ref_rows] == [s[2] for s in rows]
    assert not any(s[0] == "all-to-all" for k in ("L1", "L2")
                   for s in port_sites(port["coll_sites"][k]))

    ref_logits = [c for c in hlo if not c[3]
                  and c[1][0][1][-1] == cfg.vocab_size]
    logits = [s for s in sites if s[3][0].startswith("launch/dryrun.py")]
    assert {c[0] for c in ref_logits} == {s[0] for s in logits} == \
        {"all-gather"}
    assert sum(s[2] for s in logits) == sum(c[2] for c in ref_logits)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_state_moves_where_the_reference_moves_it(runs, arch):
    ref, port = runs[arch]
    cfg = configs.get_config(arch)
    tail = [cfg.ssm_head_dim, cfg.ssm_state]
    ref_state = [c for c in hlo_collectives(ref["hlo_L1"])
                 if len(c[1][0][1]) >= 4 and c[1][0][1][-2:] == tail]
    state = [s for s in port_sites(port["coll_sites"]["L1"])
             if len(s[1]) >= 4 and s[1][-2:] == tail]
    assert [c[0] for c in ref_state] == [s[0] for s in state]
    assert [c[2] for c in ref_state] == [s[2] for s in state]
    # Mamba2's cache is heads-sharded, Hymba's 25 heads are not
    assert len(state) == (arch == "hymba-1.5b")


def test_mamba2_conv_output_moves_once(runs):
    """Mamba2's in-projection is split on its output columns, as the
    reference's dot f32[64,2192] of its [1024,4384] weight is, with no
    all-reduce; each slice of its output (z, x, B, C, dt) and of the
    conv's (x, B, C) is realigned to an even shard of its own channels by
    collective-permutes, the reference's kind there, its payload at most
    the reference's (these were all-gathers of the whole output, once a
    layer each).  Its per-layer bytes are at most 1.1x the
    reference's."""
    ref, port = runs["mamba2-370m"]
    assert re.search(r"f32\[64,2192\]\{1,0\} dot\(", ref["hlo_L1"])

    def at(fn, text):
        # (kind, dims, bytes at f32 width, frames) of the sites there
        line = f"models/mamba.py:{_line_of(fn, text)}"
        return [s for s in port_sites(port["coll_sites"]["L1"])
                if s[3][0] == line]
    permutes = [c for c in hlo_collectives(ref["hlo_L1"])
                if c[0] == "collective-permute" and c[3].endswith("slice")]
    for text in ("_split_proj(", "_split_conv("):
        sites = at(mamba.mamba_decode_step, text)
        assert sites and {s[0] for s in sites} == {"collective-permute"}
    moved = sum(s[2] for text in ("_split_proj(", "_split_conv(")
                for s in at(mamba.mamba_decode_step, text))
    assert moved <= sum(c[2] for c in permutes)
    proj = _line_of(mamba.mamba_decode_step, 'dense(params["in_proj"]')
    assert not [key for key in port["coll_sites"]["L1"]
                if f"models/mamba.py:{proj}" in key]
    r = reference_at_f32(ref, "mamba2-370m")
    assert dryrun.collectives_at_f32(port)["per_layer"] <= 1.1 * r[1]


def test_decode_attention_reduces_max_and_o_not_p(runs):
    ref, port = runs["hymba-1.5b"]
    hlo = hlo_collectives(ref["hlo_L1"])
    sites = port_sites(port["coll_sites"]["L1"])
    fn = attention.decode_attention_block
    here = "models/attention.py:"
    at = {what: [s for s in sites
                 if s[3][0] == f"{here}{_line_of(fn, text)}"]
          for what, text in (("max", "torch.softmax(s"),
                             ("o", '"bhgk,bkhd->bhgd"'))}
    for what, op in (("max", "reduce_max"), ("o", "bhgk,bkhd->bhgd")):
        ref_site = [c for c in hlo if op in c[3]]
        assert [c[0] for c in ref_site] == ["all-reduce"]
        assert {s[0] for s in at[what]} == {"all-reduce"}
        assert sum(s[2] for s in at[what]) <= 2 * ref_site[0][2]
    p_bytes = 4 * 64 * 25 * 32768 // 2      # p on one device, f32
    assert all(s[2] < p_bytes / 100 for s in sites
               if s[3][0].startswith(here))


def _main(arch, shape=SHAPE, seq=0):
    proc = _start_reference(arch, shape=shape, seq=seq)
    out, err = proc.communicate(timeout=600)
    if proc.returncode:
        sys.exit(err[-3000:])
    ref = json.loads(out.splitlines()[-1])[arch]
    if seq:
        configs.SHAPES[shape] = dataclasses.replace(configs.SHAPES[shape],
                                                    seq_len=seq)
    port = dryrun.lower_and_compile(arch, shape, MESH, verbose=False)
    cal, wide = port["calibrated"], dryrun.collectives_at_f32(port)
    print(f"# {arch} {shape} {MESH}{f' cut to {seq} tokens' if seq else ''}"
          ": calibrated collective bytes (total, per layer, outside)")
    for name, row in (
            ("reference, true bytes", reference_at_f32(ref, arch, False)),
            ("reference, at f32", reference_at_f32(ref, arch)),
            ("port, true bytes", (cal["coll_bytes"],
                                  cal["per_layer"]["coll_bytes"],
                                  cal["outside"]["coll_bytes"])),
            ("port, at f32", (wide["coll_bytes"], wide["per_layer"],
                              wide["outside"]))):
        print(f"{name}: {row[0]:.0f} {row[1]:.0f} {row[2]:.0f}")
    print("\n# reference, 1-layer HLO: kind, true bytes on one device, "
          "op_name")
    for kind, shapes, nbytes, name in hlo_collectives(ref["hlo_L1"], False):
        print(f"{kind} {shapes} {nbytes} {name}")
    print("\n# port, 1-layer run: kind, true bytes on one device, count, "
          "site")
    for key, (n, nbytes) in sorted(port["coll_sites"]["L1"].items(),
                                   key=lambda kv: -kv[1][1]):
        print(f"{key.split(' @ ')[0]} {nbytes} x{n} @ "
              f"{key.split(' @ ')[1]}")


if __name__ == "__main__":
    _main(sys.argv[1] if len(sys.argv) > 1 else "yi-6b",
          *sys.argv[2:3], *map(int, sys.argv[3:4]))
