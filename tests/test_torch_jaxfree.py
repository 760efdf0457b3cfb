"""The PyTorch port stands alone: it never imports JAX or the ``repro``
package, at run time (subprocess guard) or in its source (AST scan)."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SCANNED = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                        REPO / "examples" /
                                        "quickstart_torch.py",
                                        REPO / "examples" /
                                        "train_bpt_cnn_torch.py",
                                        REPO / "tests" /
                                        "torch_chaos_worker.py",
                                        REPO / "tools" / "train_probe.py"]
SLICE_MODULES = (
    "repro_torch", "repro_torch.core.types", "repro_torch.core.device",
    "repro_torch.configs", "repro_torch.configs.yi_6b",
    "repro_torch.configs.phi3_mini_3_8b", "repro_torch.kernels.ref",
    "repro_torch.kernels.build", "repro_torch.kernels.dense",
    "repro_torch.kernels.ops", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.blocks",
    "repro_torch.models.lm", "repro_torch.serving",
    "repro_torch.serving.scheduler", "repro_torch.serving.engine",
    "repro_torch.launch.serve", "repro_torch.launch.profile_decode",
    "repro_torch.weights", "repro_torch.kernels.launch",
    "repro_torch.kernels.conv2d", "repro_torch.kernels.pool2d",
    "repro_torch.models.cnn", "repro_torch.core.tree",
    "repro_torch.core.bpt_trainer", "repro_torch.optim",
    "repro_torch.optim.optimizers", "repro_torch.data",
    "repro_torch.data.synthetic", "repro_torch.kernels.rmsnorm",
    "repro_torch.kernels.flash_attention", "repro_torch.configs.gemma2_27b",
    "repro_torch.core.idpa", "repro_torch.core.faults",
    "repro_torch.core.gwu", "repro_torch.core.param_server",
    "repro_torch.core.engine", "repro_torch.data.pipeline",
    "repro_torch.configs.bpt_cnn", "repro_torch.checkpointing",
    "repro_torch.checkpointing.checkpoint", "repro_torch.launch.train",
    "repro_torch.models.moe", "repro_torch.configs.qwen3_moe_30b_a3b",
    "repro_torch.configs.granite_moe_3b_a800m",
    "repro_torch.models.mamba", "repro_torch.configs.mamba2_370m",
    "repro_torch.configs.hymba_1_5b", "repro_torch.configs.shapes",
    "repro_torch.configs.internvl2_26b",
    "repro_torch.configs.seamless_m4t_large_v2",
    "repro_torch.configs.stablelm_12b", "repro_torch.models.frontends",
    "repro_torch.models.encdec", "repro_torch.launch.steps",
    "repro_torch.sanitize", "repro_torch.sanitize.harness",
    "repro_torch.core.cluster_sim", "repro_torch.launch.mesh",
    "repro_torch.launch.roofline", "repro_torch.core.dag",
    "repro_torch.core.planner", "repro_torch.core.shardlib",
    "repro_torch.launch.sharding", "repro_torch.launch.dryrun",
    "repro_torch.launch.hillclimb", "repro_torch.launch.refresh_rooflines",
)
BANNED = ("jax", "jaxlib", "repro")


def test_import_leaves_jax_and_repro_out():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {SLICE_MODULES!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in {BANNED!r})
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            bad.append("a process group")
        print(",".join(bad))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"imported: {proc.stdout.strip()}"


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0], node.lineno


@pytest.mark.parametrize("path", SCANNED,
                         ids=[str(p.relative_to(REPO)) for p in SCANNED])
def test_source_imports_no_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(root, line) for root, line in _imported_roots(tree)
           if root in BANNED]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_covers_the_slice():
    rel = {str(p.relative_to(PORT)) for p in SCANNED if PORT in p.parents}
    for mod in SLICE_MODULES[1:]:
        parts = mod.split(".")[1:]
        assert ("/".join(parts) + ".py" in rel
                or "/".join(parts) + "/__init__.py" in rel), mod
