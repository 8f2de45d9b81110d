"""Ingest and staging: the source's wait on its iterator (the span
``wf:source.fetch``, total ms; in the benchmark, the generator), over the
batches staged while the spans were on."""

from wfbench.metrics._spans import per_batch_ms


def read(run):
    return per_batch_ms(run.stats, ("wf:source.fetch",), "total_ms")
