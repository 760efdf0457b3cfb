"""Print the port's dry-run sweep as a markdown table.

    PYTHONPATH=src python tools/dryrun_table.py [--meshes pod,multipod]

Reads the untagged records ``experiments/dryrun_torch/<arch>__<shape>__
<mesh>.json`` that ``python -m repro_torch.launch.dryrun --mesh both``
writes, one row per (arch, shape) pair of ``configs.pairs()`` and mesh:
the roofline row's ``flops_T``, ``coll_G``, ``hbm_per_dev_GB``,
``bottleneck`` and ``useful_frac``, and the seconds the record's two
depth runs took (``compile_s``), under a line naming the torch version
that wrote them.  A pair without a record is listed as missing after the
table; records of more than one torch version are refused (exit 1).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch import configs
from repro_torch.launch.dryrun import OUT_DIR, torch_version_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--meshes", default="pod,multipod")
    ap.add_argument("--dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    meshes = args.meshes.split(",")
    records, missing = {}, []
    for arch, shape in sorted(configs.pairs()):
        for mesh in meshes:
            fn = os.path.join(args.dir, f"{arch}__{shape}__{mesh}.json")
            if not os.path.exists(fn):
                missing.append((arch, shape, mesh))
                continue
            with open(fn) as f:
                records[arch, shape, mesh] = json.load(f)
    try:
        version = torch_version_of(records.values())
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    print(f"torch {version}")
    print("| arch | shape | " + " | ".join(
        f"{m}: flops_T, coll_G, hbm_per_dev_GB, bottleneck, useful_frac, s"
        for m in meshes) + " |")
    print("| --- | --- | " + " | ".join("---" for _ in meshes) + " |")
    for arch, shape in sorted(configs.pairs()):
        cells = []
        for mesh in meshes:
            data = records.get((arch, shape, mesh))
            if data is None:
                cells.append("missing")
                continue
            r = data["roofline"]
            cells.append(f"{r['flops_T']}, {r['coll_G']}, "
                         f"{r['hbm_per_dev_GB']}, {r['bottleneck']}, "
                         f"{r['useful_frac']}, {data['compile_s']}")
        print(f"| {arch} | {shape} | " + " | ".join(cells) + " |")
    for m in missing:
        print("missing:", *m)
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
