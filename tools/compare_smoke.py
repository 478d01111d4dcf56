#!/usr/bin/env python3
"""Compare two ``chip_smoke.py`` reports (the ``chip_smoke.json`` it writes).

For the main paths both reports ran — main, main-mf, main-lsq, main-gn —
prints each solver's per-system iterations and matvecs, whether they are
equal, and whether the final log p (main, main-mf; a full-precision float,
so equal only when every live step's arithmetic was) or the least-squares
iterations match, then the K3 passes and solve seconds of main-mf.  Run
on the CPU after the card runs:

    python tools/compare_smoke.py parent.json change.json

The last line is a JSON object of the comparison.
"""

from __future__ import annotations

import argparse
import json


def _runs(report, path):
    if path == "main":
        return {s: r for s, r in report["main"]["runs"].items() if s != "cholesky"}
    if path == "main_mf":
        return report["main_mf"]["runs"]
    if path == "main_lsq":
        return report["main_lsq"]["runs"]
    return {k: report["main_gn"][k] for k in ("cold", "recycled") if k in report["main_gn"]}


def compare(parent, change):
    out = {}
    for path in ("main", "main_mf", "main_lsq", "main_gn"):
        a, b = _runs(parent, path), _runs(change, path)
        for solver in sorted(set(a) & set(b)):
            ra, rb = a[solver], b[solver]
            row = {}
            for key in ("iterations", "matvecs", "logp"):
                if key in ra and key in rb:
                    row[key] = {"parent": ra[key], "change": rb[key], "equal": ra[key] == rb[key]}
            for key in ("k3_passes", "live_k3_passes", "gated_frozen_passes"):
                if key in rb:
                    row[key] = {"parent": ra.get(key), "change": rb[key]}
            if "cumulative_solve_s" in ra and "cumulative_solve_s" in rb:
                row["solve_s"] = {"parent": ra["cumulative_solve_s"][-1],
                                  "change": rb["cumulative_solve_s"][-1]}
            out[f"{path}/{solver}"] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    args = ap.parse_args(argv)
    with open(args.parent) as fh:
        parent = json.load(fh)
    with open(args.change) as fh:
        change = json.load(fh)
    out = compare(parent, change)
    for name, row in out.items():
        flags = ", ".join(f"{k} {'equal' if v['equal'] else 'DIFFER'}" for k, v in row.items()
                          if "equal" in v)
        extra = ", ".join(f"{k} {v['parent']} -> {v['change']}" for k, v in row.items()
                          if "equal" not in v)
        print(f"{name}: {flags}; {extra}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
