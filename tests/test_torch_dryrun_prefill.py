"""The port's dry-run in prefill mode, one pair a family: which of the
dry-run's swapped model paths a prefill step takes.

``tests/test_torch_dryrun_collectives.py`` and
``tests/test_torch_dryrun_prefill_collectives.py`` hold the steps'
collectives against the JAX dry-run.  This file runs each family's
prefill (SSM, hybrid, MoE, encoder-decoder, VLM) at ``prefill_32k``'s
batch and the config's widths, its sequence cut to 2048 tokens, on
``tiny``, and holds which swaps the step takes (``LoweredStep.compile``
counts, per swapped name, the calls that took the dry-run's own path):
the vocab-parallel lookup outside the layers; in every layer the dense's
shard-local product (a prefill's: partial sums reduced at once) and the
rmsnorm on leading dims; in a mamba mixer the shard-local chunked SSD,
the halo conv and the last shard's cache tail, once a layer each.  None
of the decode step's own (the one-hot cache write, the cache
contractions, the heads-sharded SSM update, the conv output's gather)
and no kv-head copy: each family's q heads split over the model axis
where its kv heads do.  The vocab-parallel lookup changes nothing inside
a decoder-only model's layers.
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
MIXER = {"ssd_chunked", "_causal_conv", "_conv_tail"}


@pytest.mark.parametrize("arch", PREFILL_FAMILIES)
def test_prefill_takes_only_the_vocab_parallel_embedding(arch, monkeypatch):
    """The swaps a prefill step takes, at ``prefill_32k``'s batch and the
    config's widths, its sequence cut to 2048 tokens, on ``tiny``: the
    vocab-parallel lookup once, outside the layers; the dense as a
    prefill's and the rmsnorm in every layer; the mixer's three in every
    mamba layer, once each; nothing else.  Against the lookup as the
    model writes it the per-layer FLOPs are equal, and so are the
    collectives, but for the encoder-decoder's: the model's lookup leaves
    its rows sharded on d_model, and its decoder, with no block
    constraint to lay them out again, then gathers each layer's normed x,
    which the vocab-parallel rows (all-reduced) need not.
    Where the table is vocab-sharded (Mamba2's, Seamless's) the model's
    lookup moves the table, an all-to-all the vocab-parallel one drops,
    which moves less outside the layers; else the two are equal.  Outside
    the layers the FLOPs are equal too, the encoder-decoder's included:
    its decoder takes the all-reduced rows with no block constraint to
    split them again, and its first layer's projections still run on
    their weights' shards (the dense's layout), not whole on each
    device."""
    cfg = configs.get_config(arch)
    shape = dataclasses.replace(configs.get_shape("prefill_32k"),
                                seq_len=2048)
    mesh = placeholder_mesh("tiny")
    modes = set()
    plain_dense = dryrun._plain_dense

    def dense(*args, mode):
        modes.add(mode)
        return plain_dense(*args, mode=mode)
    monkeypatch.setattr(dryrun, "_plain_dense", dense)

    def costs():
        runs = dryrun._run_depths(cfg, shape, mesh)
        return {k: (runs[k].flops, roofline.collective_bytes(runs[k].coll),
                    {key for key in runs[k].coll_sites
                     if key.startswith("all-to-all")}, runs[k].swaps)
                for k in (1, 2)}
    got = costs()
    assert modes == {"prefill"}
    mixer = MIXER if cfg.arch_type in ("ssm", "hybrid") else set()
    for k in (1, 2):
        assert set(got[k][3]) == {"embed", "_dense_call", "rmsnorm"} | mixer
        assert got[k][3]["embed"] == 1
        assert all(got[k][3][name] == k for name in mixer)
    assert got[2][3]["_dense_call"] > got[1][3]["_dense_call"]

    monkeypatch.setattr(dryrun, "_vocab_parallel_embed", layers.embed)
    plain = costs()
    assert "embed" not in plain[1][3]

    sharded = cfg.vocab_size % 2 == 0
    assert sharded == (arch in ("mamba2-370m", "seamless-m4t-large-v2"))
    for k in (1, 2):
        assert got[k][2] <= plain[k][2]
        assert (got[k][2] != plain[k][2]) == sharded
    assert got[1][0] == plain[1][0]
    assert got[2][0] - got[1][0] == plain[2][0] - plain[1][0]   # FLOPs
    layer, plain_layer = got[2][1] - got[1][1], plain[2][1] - plain[1][1]
    if cfg.arch_type == "encdec":
        assert layer < plain_layer
    else:
        assert layer == plain_layer
    assert (got[1][1] < plain[1][1]) == sharded
    assert 2 * got[1][1] >= got[2][1]                # outside >= 0
