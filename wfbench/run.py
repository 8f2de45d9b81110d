"""Runs one cell of the benchmark once and prints its result line.

    python3 wfbench/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  Standard output ends with one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` (and ``breakdown``
when traced), and last ``checks``: each number compared with its limit,
also the last lines on standard error.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level modules no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "windflow_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole
    (``windflow_tpu_torch`` is the program, not ``windflow_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, device="cuda", **overrides) -> int:
    """The command; ``device`` and ``overrides`` (``run_cell``'s
    ``*_override``) let the CPU tests drive a run at a small size."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the caches of a run live in the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", "wfbench", sub)
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from wfbench import harness
    bench = harness.load_bench(ROOT)
    cell = harness.cell_spec(bench, args.workload)[0]
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device == "cuda" and have < cell["chips"]:
        print(f"wfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    result, checks, info = harness.run_cell(
        ROOT, args.workload, args.seed, args.seconds, args.trace,
        device=device, t_process=T_PROCESS, **overrides)
    bad = forbidden_modules()
    if bad:
        print(f"wfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"info": info}, default=str), file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    for k, (v, lim) in checks.items():
        print(f"check {k} = {v} (limit {lim})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
