"""wfverify on an application's graphs, without running them: the
command-line face of :func:`~windflow_tpu_torch.analysis.tracecheck.
verify_graph` (the port's twin of the JAX package's
``tools/wf_verify.py``, with the same JSON and exit codes).

Usage::

    python -m windflow_tpu_torch.analysis.verify APP_MODULE[:ATTR] [MORE...]
    python -m windflow_tpu_torch.analysis.verify ... --json
    python -m windflow_tpu_torch.analysis.verify ... --strict

Every live function a graph runs (device functions, combiners, key
extractors, sink callbacks, the port's own step bodies) is verified for
host reads and data-dependent shapes (WF80x, WF81x) and, when the graph
checkpoints, replay determinism (WF61x).  Inline suppressions
(``# wfverify: ok (reason)``) are honored and counted.  Exit status: 0
clean, 1 error-severity findings (or any finding under ``--strict``), 2
when an application cannot be loaded.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m windflow_tpu_torch.analysis.verify",
        description="object-level static verification of an "
                    "application's functions")
    ap.add_argument("apps", nargs="+",
                    help="APP_MODULE or APP_MODULE:ATTR building the "
                         "PipeGraph (several allowed)")
    ap.add_argument("--json", action="store_true",
                    help="emit per-app reports as one JSON object")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on warnings too")
    args = ap.parse_args(argv)

    from windflow_tpu_torch.analysis.check import LoadError, load_graph
    from windflow_tpu_torch.analysis.tracecheck import verify_graph

    out = {}
    total_errors = total_findings = 0
    for app in args.apps:
        try:
            g = load_graph(app)
        except LoadError as e:
            print(f"wf_verify: FAIL: {e}", file=sys.stderr)
            return 2
        report = verify_graph(g)
        errors = [d for d in report.diagnostics if d.severity == "error"]
        total_errors += len(errors)
        total_findings += len(report.diagnostics)
        out[app] = {
            "graph": g.name,
            "errors": len(errors),
            "warnings": len(report.diagnostics) - len(errors),
            **report.to_json(),
        }
        if not args.json:
            for d in report.diagnostics:
                print(str(d))
            print(f"wf_verify: {app} ({g.name}): "
                  f"{len(errors)} error(s), "
                  f"{len(report.diagnostics) - len(errors)} warning(s), "
                  f"{len(report.suppressed)} suppressed, "
                  f"{report.checked} callables in {report.check_ms} ms")
    if args.json:
        print(json.dumps(out, indent=2))
    if total_errors or (args.strict and total_findings):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
