"""The port's dry-run collectives on the training step held against the
JAX dry-run's, for the MoE, SSM, hybrid and encoder-decoder ``train_4k``
pairs on ``tiny`` (2 x 2), their sequence cut to 1024 tokens, with the
checks of ``tests/test_torch_dryrun_train_collectives.py`` (the dense
pairs; the shared runs and checks: ``tests/torch_dryrun_train.py``).
For each pair the calibrated total and per-layer collective bytes lie
within 1.5x of the reference's both ways, ``outside`` within 2x and not
negative (Granite-MoE's came out negative, its MoE backward all-to-all
issued in every layer but the last; Qwen3-MoE's read 0.17x).  At the
sites the training layout fixed:

- a head table the model axis does not divide (Granite-MoE's 49155 rows,
  Hymba's 32001): neither side gathers the logits (the port's backward
  gathered Hymba's bf16[256,512,16001] whole);
- the v projection of the MoE pairs takes x gathered over the sequence
  where the reference's HLO gathers it, and nowhere else;
- Hymba's hybrid layer issues no all-to-all (its branches were
  all-to-all'ed at ``blocks._hybrid_mix``, the attention's output
  batch-sharded against the mixer's sequence-sharded one), as the
  reference's layer issues none.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_dryrun_train import (  # noqa: E402
    check_band, check_hybrid_mix, check_no_logits_gather, check_v_gather,
    run_pairs)

PAIRS = ("qwen3-moe-30b-a3b", "granite-moe-3b-a800m", "mamba2-370m",
         "hymba-1.5b", "seamless-m4t-large-v2")


@pytest.fixture(scope="module")
def runs():
    return run_pairs(PAIRS)


@pytest.mark.parametrize("arch", PAIRS)
def test_collective_bytes_within_band_of_reference(runs, arch):
    check_band(*runs[arch], arch)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "hymba-1.5b"])
def test_loss_never_gathers_the_logits(runs, arch):
    check_no_logits_gather(*runs[arch], arch)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "granite-moe-3b-a800m"])
def test_v_projection_gathers_x_where_the_reference_does(runs, arch):
    check_v_gather(*runs[arch], arch)


def test_hybrid_mix_issues_no_all_to_all(runs):
    check_hybrid_mix(*runs["hymba-1.5b"])
