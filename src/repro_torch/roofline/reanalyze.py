"""Recompute the roofline terms over saved dry-run records, with no re-trace.

    PYTHONPATH=src python -m repro_torch.roofline.reanalyze [--dir results/dryrun_torch]

The counterpart of ``repro.roofline.reanalyze``, which re-reads the saved
HLO: a port record keeps its per-device counts, so ``terms_seconds``,
``dominant``, ``useful_flop_ratio`` and ``roofline_fraction`` are
recomputed from them with the constants of ``roofline.analysis`` as they
are now, for a production-mesh record (``--mesh``) as for one device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.roofline.analysis import BF16_PEAK, terms


def reanalyze_cell(json_path: Path) -> dict:
    rec = json.loads(json_path.read_text())
    if rec.get("skipped"):
        return rec
    dev = rec["per_device"]
    chips = rec["chips"]
    t = terms(dev["flops"], dev["bytes"], dev["collective_bytes"])
    bound = max(t.values())
    ideal = (rec["model_flops"] / chips) / BF16_PEAK
    rec.update({
        "terms_seconds": t,
        "dominant": max(t, key=t.get),
        "useful_flop_ratio": (rec["model_flops"] / (dev["flops"] * chips)
                              if dev["flops"] else 0.0),
        "roofline_fraction": ideal / bound if bound > 0 else 0.0,
    })
    json_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    n = 0
    for f in sorted(Path(args.dir).glob("*.json")):
        r = reanalyze_cell(f)
        if r.get("terms_seconds"):
            t = r["terms_seconds"]
            print(f"{r['cell']:46s} comp={t['compute'] * 1e3:8.1f}ms "
                  f"mem={t['memory'] * 1e3:9.1f}ms coll={t['collective'] * 1e3:9.1f}ms "
                  f"{r['dominant'][:6]} frac={r['roofline_fraction']:.3f}")
            n += 1
    print(f"reanalyzed {n} cells")


if __name__ == "__main__":
    main()
