"""Device time a batch: the traced window's kernel time (every kernel,
copies and fills left out) over the batches staged in it."""


def read(run):
    if not run.trace or not run.trace_batches or not run.trace["kernel_s"]:
        return None
    return run.trace["kernel_s"] * 1e3 / run.trace_batches
