"""The port's checkpoints (``repro_torch.checkpointing.checkpoint``) in
the reference's on-disk format, across the package boundary: a
checkpoint the port saves restores in ``repro.checkpointing.checkpoint``
and the reverse, for both kinds (``ckpt``, ``state``), with f32, bf16 and
int32 leaves, bit for bit, with equal manifests.  Then the crash-safety
contract: ``CheckpointError`` on a truncated payload and on shape drift,
``latest_step`` ignoring ``*.tmp`` strays.  Also ``lm_corpus``, the
training CLI's data, equal to the reference's element for element.

bf16 leaves travel as raw 2-byte values under the manifest dtype
``"bfloat16"``: what the reference writes through ``ml_dtypes`` and what
numpy without ``ml_dtypes`` reads back (``|V2``)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing import checkpoint as jckpt  # noqa: E402
from repro.data.synthetic import lm_corpus as jlm_corpus  # noqa: E402
from repro_torch.checkpointing import checkpoint as ckpt  # noqa: E402
from repro_torch.data.synthetic import lm_corpus  # noqa: E402


def _port_tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn((2, 3, 4), generator=gen),
                       "scale": torch.randn((2, 4), generator=gen)
                       .bfloat16()},
            "stack": [torch.randn((5,), generator=gen),
                      torch.randint(-9, 9, (3,), generator=gen,
                                    dtype=torch.int32)],
            "embed": {"table": torch.randn((7, 4), generator=gen)
                      .bfloat16()}}


def _as_jax(tree):
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return jax.tree_util.tree_map(leaf, tree,
                                  is_leaf=lambda t: isinstance(t,
                                                               torch.Tensor))


def _bits(t):
    """A leaf's raw bytes: torch bf16 through int16, jax through numpy."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes()
        return t.numpy().tobytes()
    return np.asarray(t).tobytes()


def _leaves(tree):
    return [v for _, v in sorted(ckpt._paths(tree))]


@pytest.mark.parametrize("kind", ["ckpt", "state"])
def test_port_save_restores_in_the_reference(tmp_path, kind):
    tree = _port_tree()
    meta = {"arch": "x", "clock": 1.5}
    if kind == "ckpt":
        ckpt.save(str(tmp_path), tree, step=7, metadata=meta)
        got, step = jckpt.restore(str(tmp_path), _as_jax(tree))
    else:
        ckpt.save_state(str(tmp_path), tree, 7, meta)
        got, scalars, step = jckpt.restore_state(str(tmp_path),
                                                 _as_jax(tree))
        assert scalars == meta
    assert step == 7
    assert [_bits(a) for a in _leaves(tree)] == \
        [_bits(b) for b in jax.tree_util.tree_leaves(got)]
    assert got["layers"]["scale"].dtype == jnp.bfloat16


@pytest.mark.parametrize("kind", ["ckpt", "state"])
def test_reference_save_restores_in_the_port(tmp_path, kind):
    tree = _port_tree(1)
    meta = {"arch": "y"}
    jtree = _as_jax(tree)
    if kind == "ckpt":
        jckpt.save(str(tmp_path), jtree, step=3, metadata=meta)
        got, step = ckpt.restore(str(tmp_path), tree)
    else:
        jckpt.save_state(str(tmp_path), jtree, 3, meta)
        got, scalars, step = ckpt.restore_state(str(tmp_path), tree)
        assert scalars == meta
    assert step == 3
    for a, b in zip(_leaves(tree), _leaves(got), strict=True):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)


def test_hybrid_params_round_trip_both_ways(tmp_path):
    """The hybrid block's params (the mixer's tree, as the ssm block holds
    it, beside the attention, the betas and the branch norms): reduced
    Hymba's reference init saved by the
    reference restores into the port's ``init_params`` template bit for
    bit, and the port's save of it restores in the reference."""
    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.weights import params_from_numpy
    jp = jlm.init_params(jax.random.PRNGKey(0),
                         jconfigs.get_reduced("hymba-1.5b"))
    cfg = configs.get_reduced("hymba-1.5b")
    template = lm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    jckpt.save(str(tmp_path / "ref"), jp, step=2)
    got, _ = ckpt.restore(str(tmp_path / "ref"), template)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                             "cpu")
    assert [_bits(a) for a in _leaves(got)] == \
        [_bits(b) for b in _leaves(want)]
    ckpt.save(str(tmp_path / "port"), got, step=3)
    back, step = jckpt.restore(str(tmp_path / "port"), jp)
    assert step == 3 and [_bits(a) for a in jax.tree_util.tree_leaves(
        back)] == [_bits(b) for b in jax.tree_util.tree_leaves(jp)]


def test_manifests_are_equal(tmp_path):
    tree = _port_tree(2)
    ckpt.save(str(tmp_path / "port"), tree, step=4, metadata={"m": 1})
    jckpt.save(str(tmp_path / "ref"), _as_jax(tree), step=4,
               metadata={"m": 1})
    mine = ckpt.load_manifest(str(tmp_path / "port"), 4)
    theirs = jckpt.load_manifest(str(tmp_path / "ref"), 4)
    assert mine == theirs
    assert mine["format"] == 1 and "layers/scale" in mine["keys"] \
        and mine["keys"]["stack/#1"] == {"dtype": "int32", "shape": [3]}


def test_bf16_payload_reads_as_raw_two_byte_values(tmp_path):
    """The payload holds no dtype numpy lacks: bf16 is ``|V2`` on disk,
    readable where ``ml_dtypes`` is not installed."""
    path = ckpt.save(str(tmp_path), _port_tree(), step=0)
    with np.load(path) as data:
        assert data["layers/scale"].dtype == np.dtype("V2")
        assert data["layers/w"].dtype == np.float32


def test_restore_moves_leaves_to_the_templates_dtype(tmp_path):
    tree = _port_tree(3)
    ckpt.save(str(tmp_path), tree, step=1)
    like = {k: v for k, v in tree.items()}
    like["embed"] = {"table": torch.zeros((7, 4))}     # f32 template
    got, _ = ckpt.restore(str(tmp_path), like)
    assert got["embed"]["table"].dtype == torch.float32
    assert torch.equal(got["embed"]["table"],
                       tree["embed"]["table"].float())


def test_truncated_payload_raises_checkpoint_error(tmp_path):
    path = ckpt.save(str(tmp_path), _port_tree(), step=2)
    with open(path, "rb") as f:
        head = f.read()
    with open(path, "wb") as f:
        f.write(head[: len(head) // 2])
    with pytest.raises(ckpt.CheckpointError, match="ckpt_00000002"):
        ckpt.restore(str(tmp_path), _port_tree())


def test_shape_drift_raises_checkpoint_error(tmp_path):
    ckpt.save(str(tmp_path), _port_tree(), step=2)
    like = _port_tree()
    like["stack"][0] = torch.zeros((6,))
    with pytest.raises(ckpt.CheckpointError, match="shape"):
        ckpt.restore(str(tmp_path), like)
    # a manifest that disagrees with its payload is drift too
    mpath = tmp_path / "ckpt_00000002.json"
    manifest = json.loads(mpath.read_text())
    manifest["keys"]["layers/w"]["shape"] = [2, 3, 5]
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ckpt.CheckpointError, match="drifted"):
        ckpt.restore(str(tmp_path), _port_tree())


def test_latest_step_ignores_strays(tmp_path):
    ckpt.save(str(tmp_path), _port_tree(), step=5)
    ckpt.save(str(tmp_path), _port_tree(), step=9, kind="state")
    for stray in ("ckpt_00000099.npz.tmp", "ckpt_00000050.json",
                  "ckpt_00000077.npz.bak", "notes.txt"):
        (tmp_path / stray).write_bytes(b"x")
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.latest_step(str(tmp_path), kind="state") == 9
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    assert not [f for f in os.listdir(tmp_path)
                if f.endswith(".tmp") and "99" not in f]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "missing"), _port_tree())


@pytest.mark.parametrize("num_tokens,vocab,seed", [
    (1, 512, 0), (4097, 512, 0), (2000, 32064, 3), (777, 100, 1),
    (300, 64, 2)])
def test_lm_corpus_equals_the_reference(num_tokens, vocab, seed):
    got = lm_corpus(num_tokens, vocab, seed=seed)
    want = jlm_corpus(num_tokens, vocab, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
