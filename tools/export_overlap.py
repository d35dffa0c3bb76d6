"""Phases `families` and `export` of chip_smoke.py, timed with and without the
yolov9c export process beside them, on one CUDA card.

    python tools/export_overlap.py [--out chiprun_out/export_overlap.json]

chip_smoke.py's main() starts the yolov9c export (V9Export: torch.export
tracing on the host in a process of its own, at nice 19) ahead of those two
phases, which time host-bound work. This script runs the card and build
phases, then the two phases three times: alone, beside a V9Export (then
waits for it to exit), and alone again. Every timing the two phases emit
(a key in ms or seconds; bounds, which are computed, left out) is kept from
each run, with the overlapped run's ratio to the mean of the two alone and
the two alone runs' ratio to each other (the run-to-run spread). Writes all
of it to --out and prints, as one JSON line before the last, the card's
name and power limit, the medians of both ratios, and the timings that moved
most; the last line is {"ok": true}.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMED = re.compile(r"(^|_)(ms|s|seconds)(_|$)")
PHASES = ("families", "export")


def flat(x, path: str = ""):
    """(path, number) of every timing leaf under x."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from flat(v, f"{path}/{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from flat(v, f"{path}/{i}")
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        parts = path.split("/")
        if any(TIMED.search(p) for p in parts) and not any("bound" in p for p in parts):
            yield path, float(x)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "export_overlap.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("export_overlap: needs a CUDA card", file=sys.stderr)
        return 2
    captured = []
    cs.emit = lambda phase, **kw: captured.append((phase, kw))  # the phases' long lines go to --out only
    smi = cs.phase_card()
    cs.phase_build()

    def timed_phases() -> dict:
        start = len(captured)
        cs.phase_families(smi)
        cs.phase_export(smi)
        return {f"{p}{k}": v for p, kw in captured[start:] if p in PHASES for k, v in flat(kw)}

    runs = {"alone_1": timed_phases()}
    export = cs.V9Export()
    try:
        runs["beside_export"] = timed_phases()
        export_wall = export.wait()
    finally:
        export.stop()
    runs["alone_2"] = timed_phases()

    keys = sorted(set.intersection(*(set(r) for r in runs.values())))
    table = {}
    for k in keys:
        a1, b, a2 = (runs[n][k] for n in ("alone_1", "beside_export", "alone_2"))
        alone = (a1 + a2) / 2
        table[k] = {"alone_1": a1, "beside_export": b, "alone_2": a2,
                    "ratio": b / alone if alone else None, "alone_ratio": a2 / a1 if a1 else None}
    ratios = [t["ratio"] for t in table.values() if t["ratio"]]
    spread = [t["alone_ratio"] for t in table.values() if t["alone_ratio"]]
    moved = sorted((k for k in table if table[k]["ratio"]), key=lambda k: -abs(table[k]["ratio"] - 1))[:25]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "export_wall_s": export_wall, "table": table}, indent=1))
    print(json.dumps({"card": smi, "timings": len(table), "export_wall_s": export_wall,
                      "median_ratio_beside_over_alone": statistics.median(ratios),
                      "median_ratio_alone_2_over_alone_1": statistics.median(spread),
                      "moved_most": {k: table[k] for k in moved}}))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
