"""The control of a cell's comparison: the reference put in the
program's place at a lower precision (``reference/<config>.py``
``control``) must come out not correct.

    python3 wfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --records <n>

draws each seed's log as a run does, computes the control's results over
the first ``n`` stream records (a run's count at the cell's own load)
and prints, per seed, each number compared beside its limit.  Exits 1
when the control passes any seed's comparison."""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_checks(root, name, seed, records, cfg_override=None,
                   traffic_override=None):
    """``{name: (value, limit)}`` of the control on ``seed``'s log."""
    from wfbench import generator, harness
    c = harness.load_cell(root, name, cfg_override, traffic_override)
    tables, pool = harness.draw(c, seed)
    gap = generator.event_gap_usec(c.traffic)
    got = c.ref.control(c.cfg, tables, pool["key"], pool["v"], gap, records)
    return c.ref.check(c.cfg, tables, pool["key"], pool["v"], gap,
                       records, got)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--records", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    passed = 0
    for s in args.seeds.split(","):
        checks = control_checks(ROOT, args.workload, int(s), args.records)
        ok = all(v <= lim for v, lim in checks.values())
        passed += ok
        print(json.dumps({"seed": int(s), "control_correct": ok,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checks.items()}}))
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
