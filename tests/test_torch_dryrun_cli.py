"""The reference's two longest tiny-mesh dry-run combinations on the port,
run as subprocesses (``tests/test_torch_dryrun.py`` holds the other three;
split so that each file stays under 60 s):

- ``python -m repro_torch.launch.dryrun --arch mamba2-370m --shape
  train_4k --mesh tiny --no-calibrate`` (the ssm family's train step);
- ``seamless-m4t-large-v2 train_4k tiny`` (the encoder-decoder), through
  ``python -m repro_torch.launch.hillclimb`` with its attention and loss
  chunks widened to the 2048-token halves (``--set attn_q_chunk=2048
  --set attn_k_chunk=2048 --set ce_chunk=2048``): at its own chunks the
  eager fake run takes about 75 s, and the chunks change what is counted
  but not whether the step runs.  This also drives hillclimb's override
  mode end to end.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
OUT = os.path.join(REPO, "experiments", "dryrun_torch")


def _run(module, *args, timeout=300):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=ENV, capture_output=True, text=True,
                          timeout=timeout)


def test_tiny_mesh_ssm_train():
    r = _run("repro_torch.launch.dryrun", "--arch", "mamba2-370m",
             "--shape", "train_4k", "--mesh", "tiny", "--no-calibrate",
             "--tag", "test")
    assert r.returncode == 0, r.stderr[-3000:]
    with open(os.path.join(OUT, "mamba2-370m__train_4k__tiny__test.json")) \
            as f:
        data = json.load(f)
    assert data["chips"] == 4
    assert data["memory_analysis"]["temp_size_in_bytes"] > 0
    assert data["full_artifact"]["flops_body_once"] > 0
    assert "roofline" not in data


def test_tiny_mesh_encdec_train_through_hillclimb():
    r = _run("repro_torch.launch.hillclimb", "--arch",
             "seamless-m4t-large-v2", "--shape", "train_4k", "--mesh",
             "tiny", "--tag", "test", "--set", "attn_q_chunk=2048",
             "--set", "attn_k_chunk=2048", "--set", "ce_chunk=2048")
    assert r.returncode == 0, r.stderr[-3000:]
    with open(os.path.join(
            OUT, "seamless-m4t-large-v2__train_4k__tiny__test.json")) as f:
        data = json.load(f)
    assert data["chips"] == 4
    assert data["overrides"] == {"attn_q_chunk": 2048, "attn_k_chunk": 2048,
                                 "ce_chunk": 2048}
    assert data["roofline"]["bottleneck"] in ("compute", "memory",
                                              "collective")
    assert data["calibrated"]["per_layer"]["flops"] > 0
