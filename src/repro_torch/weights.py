"""Params across the package boundary, through numpy.

``params_from_numpy`` takes a tree of numpy arrays (dicts and lists) in
the reference's layout, e.g. ``jax.tree_util.tree_map(np.asarray,
repro.models.lm.init_params(key, cfg))`` for an LM ``ModelConfig``,
``... repro.models.encdec.init_encdec_params(key, cfg)`` for an
encoder-decoder one or ``... repro.models.cnn.init_cnn(key, cfg)`` for a
``CNNConfig``, and
returns the port's params with the same structure, shapes and dtypes, on
``device``.  No transposes: both packages keep dense weights (Din, Dout),
HWIO filters, tables (V, d) and layer leaves stacked on a leading L axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import cnn, encdec, lm

__all__ = ["params_from_numpy", "params_to_numpy"]


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")            # a writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _convert(tree, template, device, path):
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"params{path}: expected keys "
                             f"{sorted(template)}, got {got}")
        return {k: _convert(tree[k], template[k], device, f"{path}[{k!r}]")
                for k in template}
    if isinstance(template, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            got = len(tree) if isinstance(tree, (list, tuple)) else type(tree)
            raise ValueError(f"params{path}: expected a list of "
                             f"{len(template)}, got {got}")
        return [_convert(t, u, device, f"{path}[{i}]")
                for i, (t, u) in enumerate(zip(tree, template))]
    t = _to_torch(np.asarray(tree))
    if tuple(t.shape) != tuple(template.shape) or t.dtype != template.dtype:
        raise ValueError(f"params{path}: expected {template.dtype} "
                         f"{tuple(template.shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.to(device)


def params_from_numpy(tree, cfg, device="cuda"):
    """The port's params for ``cfg`` (an LM or encoder-decoder
    ``ModelConfig``, or a ``CNNConfig``) from a numpy tree in the
    reference's layout; raises on a
    missing key, a wrong length, a wrong shape or a wrong dtype."""
    dev = resolve_device(device)
    if isinstance(cfg, cnn.CNNConfig):
        template = cnn.init_cnn(cfg, None, device="meta")
    elif cfg.arch_type == "encdec":
        template = encdec.init_encdec_params(cfg, None, device="meta")
    else:
        template = lm.init_params(cfg, None, device="meta")
    return _convert(tree, template, dev, "")


def params_to_numpy(params):
    """The inverse: a numpy tree (float32 leaves stay float32)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()
