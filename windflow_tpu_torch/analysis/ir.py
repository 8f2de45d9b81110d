"""The capture audit of an application's graphs: the command-line face
of :mod:`windflow_tpu_torch.analysis.ir_audit` (the port's twin of the
JAX package's ``tools/wf_ir.py``, with the same JSON and exit codes).

Usage::

    python -m windflow_tpu_torch.analysis.ir APP_MODULE[:ATTR] [MORE...]
    python -m windflow_tpu_torch.analysis.ir ... --drive 8192
    python -m windflow_tpu_torch.analysis.ir ... --json
    python -m windflow_tpu_torch.analysis.ir ... --strict

Without ``--drive`` each composed graph is audited as ``check()`` sees
it: its device functions run under ``FakeTensorMode`` over the record
specs (no device work).  ``--drive N`` gives every source whose
generator yields nothing a seeded synthetic stream of N records derived
from its record spec and RUNS the graph on its ``Config.device`` (the
card unless the application asks for the CPU), so the audit covers the
step bodies and captures the run recorded.  Recorded programs no named
graph claims are audited last, context-free, under
``"(framework programs)"``.  Inline suppressions (``# wfverify: ok
(reason)`` on the function's ``def``) are shared with wfverify and
counted.  Exit status: 0 clean, 1 error-severity findings (or any
finding under ``--strict``), 2 on load failures or with
``WF_TPU_IR_AUDIT=0``.
"""

from __future__ import annotations

import argparse
import json
import sys


def _synth_gen(record_spec: dict, n: int, seed: int = 0):
    """A zero-arg generator factory of ``n`` records matching
    ``record_spec``: monotone values for ``id``/``ts``-style lanes, ints
    in [0, 32) for everything integral, [0, 1) floats; every value a
    pure function of the record index (a checkpointed graph replays
    it)."""
    import numpy as np

    def gen():
        for i in range(n):
            h = (i + seed) * 2654435761
            rec = {}
            for j, (name, proto) in enumerate(record_spec.items()):
                dt = np.asarray(proto).dtype
                v = (h ^ (j * 0x9E3779B9)) & 0xFFFFFFFF
                if name in ("id", "ts", "timestamp"):
                    rec[name] = dt.type(i)
                elif np.issubdtype(dt, np.integer):
                    rec[name] = dt.type(v % 32)
                elif np.issubdtype(dt, np.bool_):
                    rec[name] = dt.type(i & 1)
                else:
                    rec[name] = dt.type((v % 4096) / 4096.0)
            yield rec
    return gen


def _drive(graph, n: int) -> bool:
    """Give every EMPTY source of ``graph`` a seeded synthetic stream
    (sources that yield records keep theirs) and run the graph, so its
    steps and captures are recorded.  True when it ran."""
    from windflow_tpu_torch.meta import adapt
    from windflow_tpu_torch.ops.source import Source
    subbed = live = 0
    for mp in graph._all_pipes():
        for op in mp.operators:
            if not isinstance(op, Source):
                continue
            gen_fn = getattr(op, "gen_fn", None)
            spec = getattr(op, "record_spec", None)
            if gen_fn is not None and isinstance(spec, dict) \
                    and next(iter(adapt(gen_fn, 0)(None)), None) is None:
                op.gen_fn = _synth_gen(spec, n)
                subbed += 1
            else:
                live += 1    # its own feed (frames, a device source)
    if not (subbed or live):
        return False
    from windflow_tpu_torch.analysis.diagnostics import PreflightError
    try:
        graph.run()
    except PreflightError as e:
        # the graph's own preflight (which folds this same audit's dry
        # pass) refused to start: the audit below takes the dry pass
        print(f"wf_ir: drive blocked by preflight: {e}", file=sys.stderr)
        return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m windflow_tpu_torch.analysis.ir",
        description="audit what an application's device steps run")
    ap.add_argument("apps", nargs="+",
                    help="APP_MODULE or APP_MODULE:ATTR building the "
                         "PipeGraph (several allowed)")
    ap.add_argument("--drive", type=int, default=0, metavar="N",
                    help="feed N seeded synthetic records into empty "
                         "sources and run each graph before auditing "
                         "(0 = audit composed graphs only)")
    ap.add_argument("--json", action="store_true",
                    help="emit per-app reports as one JSON object")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on warnings too")
    args = ap.parse_args(argv)

    from windflow_tpu_torch.analysis import ir_audit
    from windflow_tpu_torch.analysis.check import LoadError, load_graph

    if not ir_audit.ENABLED:
        print("wf_ir: FAIL: WF_TPU_IR_AUDIT=0 disables the recording — "
              "nothing to audit", file=sys.stderr)
        return 2

    out = {}
    total_errors = total_findings = 0
    claimed = set()
    for app in args.apps:
        try:
            g = load_graph(app)
        except LoadError as e:
            print(f"wf_ir: FAIL: {e}", file=sys.stderr)
            return 2
        if args.drive:
            _drive(g, args.drive)
        report = ir_audit.audit_graph(g)
        claimed |= report.op_names
        errors = [d for d in report.findings if d.severity == "error"]
        total_errors += len(errors)
        total_findings += len(report.findings)
        out[app] = {
            "graph": g.name,
            "errors": len(errors),
            "warnings": len(report.findings) - len(errors),
            **report.to_json(),
        }
        if not args.json:
            for d in report.findings:
                print(str(d))
            print(f"wf_ir: {app} ({g.name}): "
                  f"{len(errors)} error(s), "
                  f"{len(report.findings) - len(errors)} warning(s), "
                  f"{report.suppressed} suppressed, "
                  f"{report.programs_audited} program(s) "
                  f"({report.dry_lowered} dry-recorded, "
                  f"{len(report.pending)} pending) in "
                  f"{report.to_json()['check_ms']} ms")
    orphans = ir_audit.audit_orphans(claimed)
    if orphans.programs_audited:
        errors = [d for d in orphans.findings if d.severity == "error"]
        total_errors += len(errors)
        total_findings += len(orphans.findings)
        out["(framework programs)"] = {
            "errors": len(errors),
            "warnings": len(orphans.findings) - len(errors),
            **orphans.to_json(),
        }
        if not args.json:
            for d in orphans.findings:
                print(str(d))
            print(f"wf_ir: (framework programs): {len(errors)} error(s), "
                  f"{len(orphans.findings) - len(errors)} warning(s), "
                  f"{orphans.programs_audited} program(s)")
    if args.json:
        print(json.dumps(out, indent=2))
    if total_errors or (args.strict and total_findings):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
