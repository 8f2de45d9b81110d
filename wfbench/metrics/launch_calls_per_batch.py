"""Host calls that put work on the card, a batch: ``cudaLaunchKernel``
(and its ``Ex`` forms), ``cudaGraphLaunch`` and ``cudaMemcpyAsync`` in the
traced window's host events, over the batches staged in it."""

NAMES = ("cudaGraphLaunch", "cudaMemcpyAsync")


def read(run):
    if not run.trace or not run.trace_batches:
        return None
    n = sum(c for name, c in run.trace["call_counts"].items()
            if name.startswith("cudaLaunchKernel") or name in NAMES)
    return n / run.trace_batches if n else None
