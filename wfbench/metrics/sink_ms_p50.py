"""Egress and the sink: the latency plane's collected→sunk segment, p50
over the sampled batches."""

from wfbench.metrics._plane import segment_p50_ms


def read(run):
    return segment_p50_ms(run.stats, "collected_to_sunk")
