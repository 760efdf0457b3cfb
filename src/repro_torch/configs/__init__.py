"""Registry of the architectures the port serves: ``get_config(name)`` /
``get_reduced(name)``, as in ``repro/configs/__init__.py``.

``LONG_CONTEXT_OK`` lists the archs that run ``long_500k`` natively
(sub-quadratic or sliding-window path); the pure full-attention archs
skip that shape (``SKIPS``), and ``pairs()`` lists the rest: the 33
(arch, shape) baseline pairs the dry-run sweeps.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.core.types import ModelConfig

from .shapes import SHAPES, get_shape  # noqa: F401  (re-exported)

__all__ = ["ARCH_NAMES", "SHAPES", "LONG_CONTEXT_OK", "SKIPS", "get_config",
           "get_reduced", "get_shape", "pairs"]

_MODULES = {
    "yi-6b": "yi_6b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "gemma2-27b": "gemma2_27b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mamba2-370m": "mamba2_370m",
    "hymba-1.5b": "hymba_1_5b",
    "internvl2-26b": "internvl2_26b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "stablelm-12b": "stablelm_12b",
}

ARCH_NAMES = tuple(_MODULES)

# archs whose long_500k decode runs without a variant flag
LONG_CONTEXT_OK = ("mamba2-370m", "hymba-1.5b", "gemma2-27b")

# shape skips: pure full-attention archs skip long_500k
SKIPS: dict[tuple[str, str], str] = {
    (arch, "long_500k"): "full-attention 500k decode (no sub-quadratic path)"
    for arch in ARCH_NAMES if arch not in LONG_CONTEXT_OK
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str, variant: str = "") -> ModelConfig:
    cfg = _module(name).CONFIG
    if variant == "swa":
        # sliding-window variant for dense archs' long-context decode
        cfg = dataclasses.replace(cfg, sliding_window=4096, window_pattern=0,
                                  global_layers=())
    elif variant == "opt":
        # seq-sharded attention + banded window skipping
        cfg = dataclasses.replace(
            cfg, attn_kv_gather=True,
            attn_block_skip=cfg.sliding_window > 0)
    elif variant:
        raise ValueError(f"unknown variant {variant!r}")
    return cfg


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def pairs(include_skips: bool = False):
    """All (arch, shape) baseline pairs, minus the documented skips."""
    return [(arch, shape) for arch in ARCH_NAMES for shape in SHAPES
            if include_skips or (arch, shape) not in SKIPS]
