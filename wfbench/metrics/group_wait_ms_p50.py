"""The megastep's group-formation wait: the latency plane's
emitted→dispatched segment, p50 over the sampled batches."""

from wfbench.metrics._plane import segment_p50_ms


def read(run):
    return segment_p50_ms(run.stats, "emitted_to_dispatched")
