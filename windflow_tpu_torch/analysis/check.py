"""Run the preflight checker on an application's graph, without running
it: the command-line face of ``PipeGraph.check()`` (the port's twin of
the JAX package's ``tools/wf_check.py``, with the same JSON).

Usage::

    python -m windflow_tpu_torch.analysis.check APP_MODULE
    python -m windflow_tpu_torch.analysis.check APP_MODULE:ATTR
    python -m windflow_tpu_torch.analysis.check ... --json
    python -m windflow_tpu_torch.analysis.check ... --strict

``ATTR`` names a PipeGraph or a zero-argument factory returning one;
without it the module is searched for a factory named one of
:data:`FACTORY_NAMES`, then for a PipeGraph instance.  Exit status: 0
clean, 1 error-severity diagnostics (or any under ``--strict``), 2 when
the application cannot be loaded.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

#: module-level names probed (in order) when no :ATTR is given
FACTORY_NAMES = ("make_graph", "build_graph", "graph", "make_app", "app")


class LoadError(Exception):
    """The application named on the command line gives no graph."""


def _as_graph(obj):
    """A PipeGraph from an attribute: the instance, or what a zero-arg
    factory returns."""
    from windflow_tpu_torch.graph.pipegraph import PipeGraph
    if isinstance(obj, PipeGraph):
        return obj
    if callable(obj):
        out = obj()
        if isinstance(out, PipeGraph):
            return out
    return None


def load_graph(spec: str):
    """``module`` or ``module:attr`` -> a composed, unstarted PipeGraph."""
    from windflow_tpu_torch.graph.pipegraph import PipeGraph
    mod_name, _, attr = spec.partition(":")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise LoadError(f"cannot import '{mod_name}': {e}") from None
    if attr:
        if not hasattr(mod, attr):
            raise LoadError(f"module '{mod_name}' has no attribute "
                            f"'{attr}'")
        g = _as_graph(getattr(mod, attr))
        if g is None:
            raise LoadError(f"'{mod_name}:{attr}' is neither a PipeGraph "
                            "nor a zero-arg factory returning one")
        return g
    for name in FACTORY_NAMES:
        if hasattr(mod, name):
            g = _as_graph(getattr(mod, name))
            if g is not None:
                return g
    for name in dir(mod):
        if isinstance(getattr(mod, name), PipeGraph):
            return getattr(mod, name)
    raise LoadError(f"no PipeGraph found in '{mod_name}' — expose one (or "
                    f"a factory named one of {FACTORY_NAMES}), or pass "
                    "'module:attr'")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m windflow_tpu_torch.analysis.check",
        description="run the preflight checker on an application's graph")
    ap.add_argument("app", help="APP_MODULE or APP_MODULE:ATTR building "
                                "the PipeGraph")
    ap.add_argument("--json", action="store_true",
                    help="emit the diagnostics as JSON")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on warnings too")
    args = ap.parse_args(argv)
    try:
        g = load_graph(args.app)
    except LoadError as e:
        print(f"wf_check: FAIL: {e}", file=sys.stderr)
        return 2
    diags = g.check()
    errors = [d for d in diags if d.severity == "error"]
    if args.json:
        print(json.dumps({
            "app": args.app,
            "graph": g.name,
            "check_ms": g._preflight_ms,
            "errors": len(errors),
            "warnings": len(diags) - len(errors),
            "diagnostics": [d.to_json() for d in diags],
        }, indent=2))
    else:
        for d in diags:
            print(str(d))
        print(f"wf_check: {g.name}: {len(errors)} error(s), "
              f"{len(diags) - len(errors)} warning(s) "
              f"in {g._preflight_ms} ms")
    if errors or (args.strict and diags):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
