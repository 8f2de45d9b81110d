"""The fusion advisor on an application's graph: the command-line face
of :func:`windflow_tpu_torch.analysis.fusion.plan` (the port's twin of
the JAX package's ``tools/wf_advisor.py``, with the same JSON and exit
codes).

Usage::

    python -m windflow_tpu_torch.analysis.advisor APP_MODULE[:ATTR]
    python -m windflow_tpu_torch.analysis.advisor ... --json
    python -m windflow_tpu_torch.analysis.advisor ... --stats DUMP
    python -m windflow_tpu_torch.analysis.advisor ... --top N
    python -m windflow_tpu_torch.analysis.advisor ... --verify DUMP

The plan ranks the maximal runs of adjacent device operators one fused
hop could replace by projected boundary bytes and dispatches saved a
batch.  ``--stats DUMP`` (a ``dump_stats`` file, a postmortem
``stats.json`` or a bare ``Sweep`` section) ranks by the sweep ledger's
measured numbers; ``--verify DUMP`` (a fusion-on run's stats) compares
each chain's projection with what the fusion executor realized.  Exit
status: 0 when at least one candidate was found, 1 when none, 2 on
load failures; with ``--verify`` 0 when every fused chain realized one
dispatch a batch, 1 when one regressed or nothing executable fused.
"""

from __future__ import annotations

import argparse
import json
import sys


class _Fail(Exception):
    """A usage or load failure (exit 2)."""


def load_sweep(path: str) -> dict:
    """The ``Sweep`` section out of a stats dump, a postmortem
    stats.json or a bare sweep section file."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        raise _Fail(f"cannot read stats dump '{path}': {e}") from None
    if isinstance(obj, dict) and "per_hop" in obj:
        return obj
    sweep = (obj or {}).get("Sweep")
    if not isinstance(sweep, dict) or not sweep.get("enabled"):
        raise _Fail(f"'{path}' carries no enabled 'Sweep' section — run "
                    "the graph with Config.sweep_ledger on and dump_stats "
                    "first")
    return sweep


def render_text(p: dict) -> str:
    lines = [f"wf_advisor: graph '{p['graph']}' — "
             f"{len(p['chains'])} fusion candidate(s)"]
    for i, c in enumerate(p["chains"], 1):
        status = "chainable today (MultiPipe.chain)" if c["provable_now"] \
            else "needs whole-chain fusion"
        lines.append(f"  #{i} {' -> '.join(c['ops'])}")
        lines.append(
            f"      saves {c['dispatches_saved_per_batch']} dispatch(es) "
            f"and ~{c['projected_bytes_saved_per_batch']:.0f} boundary "
            f"bytes per batch ({c['basis']}); {status}")
        if c["tail_boundary"]:
            lines.append(f"      chain ends here: {c['tail_boundary']}")
    if not p["chains"]:
        lines.append("  (no adjacent device hops with compatible "
                     "routing/batch contracts)")
    return "\n".join(lines)


def verify(graph, sweep: dict, as_json: bool) -> int:
    """Projected against realized: each plan chain whose member prefix
    the fusion executor fused is judged by the fused hop's realized
    dispatches a batch."""
    from windflow_tpu_torch.analysis.fusion import plan
    from windflow_tpu_torch.fusion.executor import plan_segments
    p = plan(graph)
    fus = sweep.get("fusion") or {}
    realized = {tuple(c["members"]): c for c in fus.get("chains", [])}
    rows, regressed, matched = [], False, 0
    for c in p["chains"]:
        ops = tuple(c["ops"])
        hit = None
        for members, rc in realized.items():
            # the executor may fuse a PREFIX of the advisor's chain
            if members == ops[:len(members)]:
                if hit is None or len(members) > len(hit["members"]):
                    hit = rc
        row = {"plan": list(ops),
               "projected_dispatches_saved":
                   c["dispatches_saved_per_batch"],
               "projected_bytes_saved_per_batch":
                   c["projected_bytes_saved_per_batch"]}
        if hit is None:
            row["realized"] = None
        else:
            matched += 1
            dpb = hit.get("dispatches_per_batch")
            row["realized"] = {
                "fused": hit["name"],
                "dispatches_per_batch": dpb,
                "dispatches_saved_per_batch":
                    hit.get("dispatches_saved_per_batch"),
                "bytes_saved_per_batch": hit.get("bytes_saved_per_batch"),
                "donated_inputs": hit.get("donated_inputs"),
            }
            if dpb is not None and dpb > 1.05:
                row["regressed"] = True
                regressed = True
        rows.append(row)
    out = {"graph": p["graph"], "chains": rows,
           "realized_total": {
               "dispatches_saved_per_batch":
                   fus.get("dispatches_saved_per_batch"),
               "bytes_saved_per_batch": fus.get("bytes_saved_per_batch")}}
    if as_json:
        print(json.dumps(out, indent=2))
    else:
        print(f"wf_advisor --verify: graph '{p['graph']}' — "
              f"{matched}/{len(rows)} plan chain(s) realized")
        for row in rows:
            r = row["realized"]
            arrows = " -> ".join(row["plan"])
            if r is None:
                print(f"  {arrows}\n      NOT fused (projected "
                      f"{row['projected_dispatches_saved']} dispatch(es) "
                      "saved)")
                continue
            flag = "  REGRESSED" if row.get("regressed") else ""
            print(f"  {arrows}\n      fused as {r['fused']}: "
                  f"{r['dispatches_per_batch']} dispatch/batch "
                  f"(projected saving {row['projected_dispatches_saved']}"
                  f", realized {r['dispatches_saved_per_batch']}){flag}")
    if regressed:
        return 1
    return 1 if (plan_segments(graph) and not matched) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m windflow_tpu_torch.analysis.advisor",
        description="rank the fusible operator chains of an application")
    ap.add_argument("app", help="APP_MODULE or APP_MODULE:ATTR building "
                                "the PipeGraph")
    ap.add_argument("--json", action="store_true",
                    help="emit the ranked plan as JSON")
    ap.add_argument("--stats", metavar="DUMP",
                    help="stats JSON with a Sweep section: rank by "
                         "measured per-hop numbers")
    ap.add_argument("--verify", metavar="DUMP",
                    help="stats JSON from a fusion-on run: compare the "
                         "plan's projected savings with the realized ones")
    ap.add_argument("--top", type=int, default=0,
                    help="emit only the best N chains")
    args = ap.parse_args(argv)

    from windflow_tpu_torch.analysis.check import LoadError, load_graph
    from windflow_tpu_torch.analysis.fusion import plan
    try:
        g = load_graph(args.app)
        if args.verify:
            return verify(g, load_sweep(args.verify), args.json)
        sweep = load_sweep(args.stats) if args.stats else None
    except (LoadError, _Fail) as e:
        print(f"wf_advisor: FAIL: {e}", file=sys.stderr)
        return 2
    p = plan(g, sweep=sweep, top=args.top)
    if args.json:
        print(json.dumps(p, indent=2))
    else:
        print(render_text(p))
    return 0 if p["chains"] else 1


if __name__ == "__main__":
    sys.exit(main())
