"""The port's dry-run collectives on the training step held against the
JAX dry-run's, for the five dense ``train_4k`` pairs on ``tiny`` (2 x 2),
their sequence cut to 1024 tokens, as
``tests/test_torch_dryrun_collectives.py`` and
``tests/test_torch_dryrun_prefill_collectives.py`` hold the decode and
prefill steps' (the other five pairs:
``tests/test_torch_dryrun_train_collectives_moe_ssm.py``; the shared runs
and checks: ``tests/torch_dryrun_train.py``).  For each pair:

- the calibrated total and per-layer collective bytes lie within a
  factor of 1.5 of the reference's both ways, and ``outside`` (the
  1-layer run less a layer) within a factor of 2, not negative.

At the sites the training layout fixed:

- the v projection takes x gathered over the sequence and its weight on
  its columns, where the reference's compiled HLO gathers x (its stack
  frames name ``dense(params["wv"]``), at no other dense, and no more
  often a layer than the reference's activation gathers;
- InternVL2's head table (92553 rows, which the model axis does not
  divide): neither side gathers the logits, in the forward or the
  backward (the port's backward gathered them whole).
"""
import pytest

torch = pytest.importorskip("torch")

from torch_dryrun_train import (  # noqa: E402
    check_band, check_no_logits_gather, check_v_gather, run_pairs)

PAIRS = ("yi-6b", "phi3-mini-3.8b", "gemma2-27b", "stablelm-12b",
         "internvl2-26b")


@pytest.fixture(scope="module")
def runs():
    return run_pairs(PAIRS)


@pytest.mark.parametrize("arch", PAIRS)
def test_collective_bytes_within_band_of_reference(runs, arch):
    check_band(*runs[arch], arch)


@pytest.mark.parametrize("arch", ["internvl2-26b"])
def test_loss_never_gathers_the_logits(runs, arch):
    check_no_logits_gather(*runs[arch], arch)


@pytest.mark.parametrize("arch", PAIRS)
def test_v_projection_gathers_x_where_the_reference_does(runs, arch):
    check_v_gather(*runs[arch], arch)
