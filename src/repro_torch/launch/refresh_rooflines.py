"""Recompute the roofline rows in ``experiments/dryrun_torch/*.json`` from
the stored calibration data (no rerun), from
``repro/launch/refresh_rooflines.py``: used when the roofline formulas or
rates change after a sweep has already run.

    python -m repro_torch.launch.refresh_rooflines [GLOB]
"""
from __future__ import annotations

import glob
import json
import sys

from repro_torch import configs
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import (OUT_DIR, _attn_score_bytes,
                                      torch_version_of)

__all__ = ["refresh"]


def refresh(path_glob: str = f"{OUT_DIR}/*.json") -> int:
    """Rewrite the roofline row of every calibrated record the glob
    matches; the number rewritten.  Refuses (``ValueError``, nothing
    written) records of more than one torch version."""
    records = {}
    for fn in sorted(glob.glob(path_glob)):
        with open(fn) as f:
            records[fn] = json.load(f)
    torch_version_of(records.values())
    n = 0
    for fn, data in records.items():
        if "calibrated" not in data:
            continue
        cfg = configs.get_config(data["arch"], data.get("variant", ""))
        shape = configs.get_shape(data["shape"])
        cal = data["calibrated"]
        rep = roofline.RooflineReport(
            arch=data["arch"], shape=data["shape"], mesh=data["mesh"],
            chips=data["chips"], hlo_flops=cal["flops"],
            hlo_bytes=cal["bytes"], coll_bytes=cal["coll_bytes"],
            coll_detail=cal.get("coll_counts_L2", {}),
            model_flops_=roofline.model_flops(cfg, shape),
            per_device_hbm=data["memory_analysis"]["temp_size_in_bytes"]
            + data["memory_analysis"]["argument_size_in_bytes"])
        row = rep.row()
        row["memory_naive_ms"] = row["memory_flash_ms"] = row["memory_ms"]
        data["attn_score_bytes_corr"] = _attn_score_bytes(cfg, shape)
        data["roofline"] = row
        with open(fn, "w") as f:
            json.dump(data, f, indent=1)
        n += 1
    return n


if __name__ == "__main__":
    glob_arg = sys.argv[1] if len(sys.argv) > 1 else f"{OUT_DIR}/*.json"
    print(f"refreshed {refresh(glob_arg)} artifacts")
