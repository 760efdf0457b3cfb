"""Crash-safe checkpointing to .npz (flat-key encoding), a copy of
``repro/checkpointing/checkpoint.py`` for trees of torch tensors.

The on-disk format is the reference's, so either package restores what
the other saved: a tree of dicts and lists flattens to '/'-joined key
paths (dict keys in sorted order, list index i written ``#i``) of numpy
arrays in an ``.npz`` payload, beside a JSON manifest that records every
key's dtype and shape.

Crash-safety contract:

* **Atomic writes** — payload and manifest are written to temp names and
  published with ``os.replace``, manifest first, so a reader never sees a
  truncated ``.npz`` and a visible payload always has its manifest.  A
  process killed mid-save leaves only ``*.tmp`` strays, which
  ``latest_step`` ignores.
* **Validated restores** — ``restore`` raises ``CheckpointError`` (not a
  numpy traceback) on a corrupt or partial file, a shape mismatch, or
  manifest/payload drift.
* **Two checkpoint kinds** — ``kind="ckpt"`` is the plain weight
  checkpoint; ``kind="state"`` a resumable training state (arrays plus
  JSON scalars in the manifest's metadata).

bf16 leaves are written as the 2-byte raw values (numpy dtype ``|V2``)
under the manifest dtype ``"bfloat16"``: what numpy saves for the
reference's ``ml_dtypes`` arrays, and what it reads back without
``ml_dtypes``.  ``restore`` views such a payload through the manifest's
dtype and returns ``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "load_manifest",
           "save_state", "restore_state", "CheckpointError"]

_SEP = "/"
_KINDS = ("ckpt", "state")
_BF16 = "bfloat16"


class CheckpointError(RuntimeError):
    """A checkpoint file is corrupt, partial, or inconsistent with the
    structure the caller asked to restore into."""


def _paths(tree, prefix=()):
    """(key path, leaf) pairs in the reference's order: dict keys sorted,
    list and tuple items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (f"#{i}",))
    else:
        yield _SEP.join(prefix), tree


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array written, the dtype name the manifest records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree) -> dict[str, tuple[np.ndarray, str]]:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def _check_kind(kind: str) -> str:
    if kind not in _KINDS:
        raise ValueError(f"checkpoint kind={kind!r}: choose one of {_KINDS}")
    return kind


def _payload_name(kind: str, step: int) -> str:
    return f"{kind}_{step:08d}.npz"


def _manifest_path(path: str, kind: str, step: int) -> str:
    return os.path.join(path, f"{kind}_{step:08d}.json")


def _atomic_write_bytes(final: str, write_fn) -> None:
    """Write via a sibling ``.tmp`` + ``os.replace`` so a kill mid-write
    never leaves a truncated file under the published name."""
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def save(path: str, tree, step: int = 0, metadata: dict | None = None,
         *, kind: str = "ckpt") -> str:
    """Atomically save ``tree`` as ``<kind>_<step>.npz`` plus a manifest
    (``<kind>_<step>.json``: per-key dtype and shape, ``metadata``
    verbatim), the manifest published first.  Returns the payload's
    path."""
    _check_kind(kind)
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    manifest = {
        "step": step,
        "format": 1,
        "keys": {k: {"dtype": name, "shape": list(arr.shape)}
                 for k, (arr, name) in flat.items()},
        "metadata": metadata or {},
    }
    payload = json.dumps(manifest).encode()
    _atomic_write_bytes(_manifest_path(path, kind, step),
                        lambda f: f.write(payload))
    final = os.path.join(path, _payload_name(kind, step))
    arrays = {k: arr for k, (arr, _) in flat.items()}
    _atomic_write_bytes(final, lambda f: np.savez(f, **arrays))
    return final


def latest_step(path: str, *, kind: str = "ckpt") -> int | None:
    """Largest published step, ignoring strays (``*.tmp``, manifests,
    other kinds, unrelated files)."""
    _check_kind(kind)
    if not os.path.isdir(path):
        return None
    pat = re.compile(rf"{kind}_(\d+)\.npz$")
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := pat.fullmatch(f))]
    return max(steps) if steps else None


def load_manifest(path: str, step: int, *, kind: str = "ckpt") -> dict | None:
    """The manifest for ``step``, or None for pre-manifest checkpoints."""
    _check_kind(kind)
    mpath = _manifest_path(path, kind, step)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(
            f"checkpoint manifest {mpath} is corrupt: {e}") from e
    # legacy flat format ({"step": ..., **metadata}) has no "keys" entry
    if "keys" not in manifest:
        return {"step": manifest.get("step", step), "format": 0,
                "keys": None, "metadata": manifest}
    return manifest


def _leaf_dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _BF16 if leaf.dtype == torch.bfloat16 else \
            str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _view(arr: np.ndarray, target: str) -> tuple[np.ndarray, str]:
    """A raw ``V`` payload viewed as ``target`` where it has the same
    width: (the array, its dtype name).  bf16 stays as 16-bit integers,
    since numpy without ``ml_dtypes`` has no bfloat16."""
    if target == _BF16:
        if arr.dtype.itemsize == 2:
            return arr.view(np.int16), _BF16
        return arr, str(arr.dtype)
    try:
        dt = np.dtype(target)
    except TypeError:
        return arr, str(arr.dtype)     # unknown name: the drift check reports
    if arr.dtype.itemsize == dt.itemsize:
        arr = arr.view(dt)
    return arr, str(arr.dtype)


def _restore_leaf(arr: np.ndarray, name: str, leaf):
    """``arr`` (dtype ``name``) as the template leaf's type, dtype and
    device."""
    if name == _BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(leaf, torch.Tensor):
        return t.to(device=leaf.device, dtype=leaf.dtype)
    want = np.asarray(leaf).dtype
    return (t.float() if name == _BF16 else t).numpy().astype(want)


def _unflatten(like, values, prefix=()):
    if isinstance(like, dict):
        return {k: _unflatten(v, values, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, values, prefix + (f"#{i}",))
               for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    return values[_SEP.join(prefix)]


def restore(path: str, like, step: int | None = None, *,
            kind: str = "ckpt"):
    """Restore into the structure of ``like`` (a template tree); returns
    (tree, step).

    Raises ``FileNotFoundError`` when no checkpoint exists, ``KeyError``
    when the payload lacks keys the template needs, and
    ``CheckpointError`` — with the offending file named — on a corrupt or
    truncated payload, a shape mismatch against the template, or a
    payload whose arrays drifted from the manifest's recorded dtypes.
    Leaves come back as the template leaf's dtype, on its device.
    """
    _check_kind(kind)
    if step is None:
        step = latest_step(path, kind=kind)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    fpath = os.path.join(path, _payload_name(kind, step))
    try:
        data = np.load(fpath)
        files = set(data.files)
    except FileNotFoundError:
        raise
    except (OSError, ValueError, zipfile.BadZipFile, EOFError) as e:
        raise CheckpointError(
            f"checkpoint {fpath} is corrupt or was truncated mid-write "
            f"({e}); delete it and restore an earlier step") from e
    manifest = load_manifest(path, step, kind=kind)
    keys = manifest["keys"] if manifest is not None else None
    template = dict(_paths(like))
    missing = set(template) - files
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    values = {}
    for key, leaf in template.items():
        try:
            arr = data[key]
        except (OSError, ValueError, zipfile.BadZipFile, EOFError,
                KeyError) as e:
            raise CheckpointError(
                f"checkpoint {fpath} key {key!r} is unreadable "
                f"(truncated or corrupt archive member): {e}") from e
        rec = keys.get(key) if keys is not None else None
        name = str(arr.dtype)
        if arr.dtype.kind == "V":
            # raw 2-byte values (bf16 from either package): view them
            # through the manifest's dtype, or the template's
            arr, name = _view(arr, rec["dtype"] if rec
                              else _leaf_dtype_name(leaf))
        if keys is not None:
            if rec is None:
                raise CheckpointError(
                    f"checkpoint {fpath} key {key!r} is absent from its "
                    "manifest — payload and manifest are out of sync")
            if name != rec["dtype"] or list(arr.shape) != rec["shape"]:
                raise CheckpointError(
                    f"checkpoint {fpath} key {key!r} drifted from its "
                    f"manifest: saved {name}{list(arr.shape)}, "
                    f"manifest says {rec['dtype']}{rec['shape']}")
        want_shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else tuple(np.shape(leaf))
        if tuple(arr.shape) != want_shape:
            raise CheckpointError(
                f"checkpoint {fpath} key {key!r} has shape "
                f"{tuple(arr.shape)}, template expects {want_shape}")
        values[key] = _restore_leaf(arr, name, leaf)
    return _unflatten(like, values), step


# ----------------------------------------------------------------------
# train-state checkpoints: snapshot arrays + JSON scalar state
# ----------------------------------------------------------------------
def save_state(path: str, arrays, step: int, scalars: dict) -> str:
    """Save one resumable train-state checkpoint (``kind="state"``):
    ``arrays`` a tree of tensors, ``scalars`` its JSON-able rest."""
    return save(path, arrays, step=step, metadata=scalars, kind="state")


def restore_state(path: str, like, step: int | None = None
                  ) -> tuple[Any, dict, int]:
    """Restore a train-state checkpoint: ``(arrays, scalars, step)``."""
    arrays, step = restore(path, like, step=step, kind="state")
    manifest = load_manifest(path, step, kind="state")
    scalars = manifest["metadata"] if manifest else {}
    return arrays, scalars, step
