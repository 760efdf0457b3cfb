"""The training-step pairs' comparison with the JAX dry-run, shared by
``tests/test_torch_dryrun_train_collectives.py`` (the dense pairs) and
``tests/test_torch_dryrun_train_collectives_moe_ssm.py`` (the MoE, SSM,
hybrid and encoder-decoder pairs): each file runs its five ``train_4k``
pairs on ``tiny`` (2 x 2), their sequence cut to 1024 tokens, the
reference's in one subprocess (8 forced host devices) while the port's
run in-process, and holds them with the checks below.  Both sides are
read at one width, every floating payload at 4 bytes an element.  Not a
test file.
"""
import dataclasses
import json
import math
import os
import re

import torch

from test_torch_dryrun_collectives import (
    REPO, _COLL, _FLOATS, _ITEMSIZE, _line_of, reference_at_f32)
from test_torch_dryrun_prefill_collectives import (
    _at, _layer, _port, _start_reference)

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models import attention, blocks, layers

MESH, SHAPE, SEQ = "tiny", "train_4k", 1024
BAND, OUTSIDE_BAND = 1.5, 2.0


def run_pairs(archs):
    """{arch: (reference, port record)}: the reference's subprocess while
    the port's runs go here."""
    proc = _start_reference(*archs, shape=SHAPE, seq=SEQ)
    saved = configs.SHAPES[SHAPE]
    try:
        configs.SHAPES[SHAPE] = dataclasses.replace(saved, seq_len=SEQ)
        try:
            port = {arch: dryrun.lower_and_compile(arch, SHAPE, MESH,
                                                   verbose=False)
                    for arch in archs}
        finally:
            configs.SHAPES[SHAPE] = saved
        out, err = proc.communicate(timeout=400)
        assert proc.returncode == 0, err[-3000:]
        ref = json.loads(out.splitlines()[-1])
    finally:
        proc.kill()
    assert not torch.distributed.is_initialized()
    return {arch: (ref[arch], port[arch]) for arch in archs}


def hlo_sites(text):
    """[(kind, [dims], bytes at f32 width, op_name, frames)] of a compiled
    HLO text, ``frames`` the innermost source lines of the collective's
    stack (``models/attention.py:163``, from the module's ``FileNames``,
    ``FileLocations`` and ``StackFrames`` tables; a frame's parent id
    counts from 1)."""
    def table(name):
        start = text.index(f"\n{name}\n") + len(name) + 2
        return text[start:text.index("\n\n", start)].splitlines()
    files = {int(row.split()[0]): row.split('"')[1].split("/src/repro/")[-1]
             for row in table("FileNames")}
    locs, frames = {}, {}
    for row in table("FileLocations"):
        f = dict(re.findall(r"(\w+)=(\d+)", row))
        locs[int(row.split()[0])] = \
            f"{files[int(f['file_name_id'])]}:{f['line']}"
    for row in table("StackFrames"):
        f = dict(re.findall(r"(\w+)=(\d+)", row))
        frames[int(row.split()[0])] = (int(f["file_location_id"]),
                                       int(f["parent_frame_id"]) - 1)
    out = []
    for line in text.splitlines():
        m = _COLL.search(line)
        if m is None:
            continue
        shapes = [(dt, [int(d) for d in dims.split(",") if d])
                  for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]",
                                             m.group(1))]
        name = re.search(r'op_name="([^"]*)"', line)
        frame = re.search(r"stack_frame_id=(\d+)", line)
        stack, fid = [], int(frame.group(1)) if frame else 0
        while fid > 0 and len(stack) < 6:
            loc, parent = frames[fid]
            stack.append(locs[loc])
            fid = parent if parent != fid else 0
        out.append((m.group(2), [d for _, d in shapes],
                    sum((4 if dt in _FLOATS else _ITEMSIZE[dt])
                        * math.prod(d) for dt, d in shapes),
                    name.group(1) if name else "", stack))
    return out


def _reference_line(text):
    """``models/attention.py:N``, the reference's line holding ``text``."""
    path = os.path.join(REPO, "src", "repro", "models", "attention.py")
    with open(path) as f:
        n = next(i for i, row in enumerate(f, 1) if text in row)
    return f"models/attention.py:{n}"


def check_band(ref, port, arch):
    """The calibrated total and per-layer collective bytes within BAND of
    the reference's both ways, ``outside`` within OUTSIDE_BAND and not
    negative."""
    rc = ref["calibrated"]
    # the HLO read here counts what the reference's own dry-run counts
    assert reference_at_f32(ref, arch, f32=False) == (
        rc["coll_bytes"], rc["per_layer"]["coll_bytes"],
        rc["outside"]["coll_bytes"])
    r, p = reference_at_f32(ref, arch), dryrun.collectives_at_f32(port)
    for name, want, got, band in (
            ("total", r[0], p["coll_bytes"], BAND),
            ("per layer", r[1], p["per_layer"], BAND),
            ("outside", r[2], p["outside"], OUTSIDE_BAND)):
        assert 1 / band <= got / want <= band, \
            f"{arch} {name}: {got:.4g} vs {want:.4g}"
    assert port["calibrated"]["outside"]["coll_bytes"] >= 0


def check_no_logits_gather(ref, port, arch):
    """No all-gather of a logits-shaped (b, s, vocab or a vocab shard)
    tensor on either side, for a vocabulary the model axis does not
    divide: the head table's rows are split where the logits are
    constrained, as GSPMD pads and splits them."""
    V = configs.get_config(arch).vocab_size
    vocab = {V, V + 1, -(-V // 2)}

    def logits(dims):
        return len(dims) >= 3 and dims[-1] in vocab
    assert not [c for k in (1, 2) for c in hlo_sites(ref[f"hlo_L{k}"])
                if c[0] == "all-gather" and any(map(logits, c[1]))]
    assert not [s for k in (1, 2) for s in _port(port, k)
                if s[0] == "all-gather" and logits(s[1])]
    assert port["swaps"]["L1"]["_ce_chunk"] >= 1


def _activation_gathers(sites, cfg):
    """The all-gathers of a (b, S, d_model) activation of a data shard
    (128 rows), the sequence whole."""
    return [s for s in sites if s[0] == "all-gather" and len(s[1]) == 3
            and s[1][-1] == cfg.d_model and s[1][0] * s[1][1] == 128 * SEQ]


def check_v_gather(ref, port, arch):
    """x gathered over the sequence at the v projection, where the
    reference's HLO gathers it (its stack frames name ``dense(params
    ["wv"]``), at no other dense, and no more often a layer than the
    reference's activation gathers at a dot."""
    cfg = configs.get_config(arch)
    v_line = _reference_line('v = dense(params["wv"], src)')

    def ref_sites(k):
        return [(kind, dims[0], n, name, stack) for kind, dims, n, name,
                stack in hlo_sites(ref[f"hlo_L{k}"]) if len(dims) == 1]

    def ref_gathers(_, k):
        return [s for s in _activation_gathers(ref_sites(k), cfg)
                if s[3].endswith("dot_general")]
    # the reference's blocks gather x at their v projection only in the
    # forward (the loss gathers the final hidden as the port's does)
    forward = [s for s in ref_gathers(None, 1) if "transpose" not in s[3]
               and any(f.startswith("models/blocks.py") for f in s[4])]
    assert forward and all(v_line in s[4] for s in forward)

    def port_gathers(record, k):
        return _activation_gathers(_at(_port(record, k), layers.dense,
                                       'ops.dense(x, params["w"])'), cfg)
    at_v = _at(_port(port, 1), attention.project_qkv,
               'v = dense(params["wv"], src)')
    assert port_gathers(port, 1) and all(
        s in at_v for s in port_gathers(port, 1))
    n, _ = _layer(port_gathers, port)
    assert 1 <= n <= _layer(ref_gathers, None)[0]


def check_hybrid_mix(ref, port):
    """No all-to-all at ``blocks._hybrid_mix``, nor anywhere in the step,
    as the reference's layer issues none."""
    mix = blocks._hybrid_mix
    lines = range(mix.__code__.co_firstlineno,
                  _line_of(mix, "return 0.5 *") + 1)
    sites = [s for k in (1, 2) for s in _port(port, k)]
    assert not [s for s in sites if any(
        f.startswith("models/blocks.py:") and int(f.split(":")[1]) in lines
        for f in s[3])]
    assert not [s for s in sites if s[0] == "all-to-all"]
    assert _layer(lambda r, k: [c for c in hlo_sites(r[f"hlo_L{k}"])
                                if c[0] == "all-to-all"], ref)[0] == 0
