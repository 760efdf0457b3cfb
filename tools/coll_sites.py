"""Print the per-layer collectives of port dry-run records, site by site.

    python -m tools.coll_sites RECORD.json [OTHER.json] [--outside] [--top 20]

A record is what ``python -m repro_torch.launch.dryrun`` (or
``tools/dryrun_probe.py``) writes.  Its ``coll_sites`` count each
collective of the 1- and 2-layer runs by kind, op, dtype[shape] and call
site; a site's per-layer bytes are its 2-layer bytes less its 1-layer
bytes, its ``outside`` bytes (``--outside``) the 1-layer run's less a
layer's.  Bytes are on one device, at f32 width (every floating payload
at 4 bytes an element, as ``dryrun.collectives_at_f32`` counts them
against the reference).  For each record the tool prints the total and
its largest sites; given two records (a torch version against another,
a commit against its parent), the sites whose bytes differ, the largest
change first.
"""
from __future__ import annotations

import argparse
import json


def f32_bytes(key: str, nbytes: int) -> int:
    """A ``coll_sites`` entry's bytes with a floating payload at 4 bytes
    an element (its key: ``kind op dtype[shape] @ frames``)."""
    dtype = key.split(" ")[2].split("[")[0]
    width = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}.get(
        dtype)
    return nbytes * 4 // width if width else nbytes


def per_layer(record, outside: bool = False) -> dict:
    """{site: (count, bytes at f32 width)}: the 2-layer run's less the
    1-layer run's (``outside``: twice the 1-layer run's less the 2-layer
    run's), sites that cancel left out."""
    weights = (("L2", -1), ("L1", 2)) if outside else (("L2", 1), ("L1", -1))
    out = {}
    for run, sign in weights:
        for site, (n, nbytes) in record["coll_sites"][run].items():
            c, b = out.get(site, (0, 0))
            out[site] = (c + sign * n, b + sign * f32_bytes(site, nbytes))
    return {k: v for k, v in out.items() if v != (0, 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("records", nargs="+", help="one or two record files")
    ap.add_argument("--outside", action="store_true",
                    help="the bytes outside the layers, not a layer's")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    what = "outside the layers" if args.outside else "a layer"
    sites = []
    for fn in args.records[:2]:
        with open(fn) as f:
            record = json.load(f)
        sites.append(per_layer(record, args.outside))
        print(f"{fn}: {record['arch']} {record['shape']} {record['mesh']}, "
              f"torch {record['torch']}; {what}, one device, at f32 width: "
              f"{sum(b for _, b in sites[-1].values()) / 1e6:.3f} MB")
    if len(sites) == 1:
        rows = {k: ((0, 0), v) for k, v in sites[0].items()}
    else:
        a, b = sites
        rows = {k: (a.get(k, (0, 0)), b.get(k, (0, 0))) for k in a.keys()
                | b.keys() if a.get(k, (0, 0))[1] != b.get(k, (0, 0))[1]}
    print("count x MB: first -> second, site" if len(sites) == 2 else
          "count x MB, site")
    for k, ((ca, ba), (cb, bb)) in sorted(
            rows.items(), key=lambda kv: -abs(kv[1][1][1]
                                              - kv[1][0][1]))[:args.top]:
        first = f"{ca} x {ba / 1e6:.3f} -> " if len(sites) == 2 else ""
        print(f"  {first}{cb} x {bb / 1e6:.3f}  {k}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
