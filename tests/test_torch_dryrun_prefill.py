"""The port's dry-run in prefill mode, one pair a family: which of the
dry-run's swapped model paths a prefill step takes.

``tests/test_torch_dryrun_collectives.py`` holds the decode steps'
collectives against the JAX dry-run.  Of the dry-run's changes for
them, a prefill step takes only the vocab-parallel embedding lookup;
the dense's immediate reduction is a decode step's alone (the step's
mode decides it).  This file runs each family's prefill (SSM, hybrid,
MoE, encoder-decoder, VLM) at ``prefill_32k``'s batch and the config's
widths, its sequence cut to 2048 tokens, on ``tiny``, and holds that.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import placeholder_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402

# one pair a family: SSM, hybrid, MoE, encoder-decoder, VLM
PREFILL_FAMILIES = ("mamba2-370m", "hymba-1.5b", "granite-moe-3b-a800m",
                    "seamless-m4t-large-v2", "internvl2-26b")


@pytest.mark.parametrize("arch", PREFILL_FAMILIES)
def test_prefill_takes_only_the_vocab_parallel_embedding(arch, monkeypatch):
    """Of the dry-run's decode-site changes a prefill step takes only the
    vocab-parallel lookup: at ``prefill_32k``'s batch and the config's
    widths, its sequence cut to 2048 tokens, on ``tiny``, every dense
    runs as a prefill's (no immediate reduction, a decode step's alone),
    and the per-layer FLOPs and collectives equal those of the lookup as
    the model writes it.  Where the table is vocab-sharded (Mamba2's,
    Seamless's) the model's lookup moves the table, an all-to-all the
    vocab-parallel one drops, which moves less outside the layers; else
    the two are equal.  Outside the layers the FLOPs are equal too, but
    for the encoder-decoder's: its decoder takes the all-reduced rows
    with no block constraint to split them again, so its first layer's
    projections run whole on each device."""
    cfg = configs.get_config(arch)
    shape = dataclasses.replace(configs.get_shape("prefill_32k"),
                                seq_len=2048)
    mesh = placeholder_mesh("tiny")
    modes = set()
    plain_dense = dryrun._plain_dense

    def dense(*args, decode):
        modes.add(decode)
        return plain_dense(*args, decode=decode)
    monkeypatch.setattr(dryrun, "_plain_dense", dense)

    def costs():
        runs = dryrun._run_depths(cfg, shape, mesh)
        return {k: (runs[k].flops, roofline.collective_bytes(runs[k].coll),
                    {key for key in runs[k].coll_sites
                     if key.startswith("all-to-all")}) for k in (1, 2)}
    got = costs()
    assert modes == {False}
    monkeypatch.setattr(dryrun, "_vocab_parallel_embed", layers.embed)
    plain = costs()

    sharded = cfg.vocab_size % 2 == 0
    assert sharded == (arch in ("mamba2-370m", "seamless-m4t-large-v2"))
    for k in (1, 2):
        assert got[k][2] <= plain[k][2]
        assert (got[k][2] != plain[k][2]) == sharded
    assert (got[1][0] > plain[1][0]) == (cfg.arch_type == "encdec")
    assert got[1][0] >= plain[1][0]
    for i in (0, 1):                                  # FLOPs, collectives
        assert got[2][i] - got[1][i] == plain[2][i] - plain[1][i]
    assert (got[1][1] < plain[1][1]) == sharded
    assert 2 * got[1][1] >= got[2][1]                # outside >= 0
