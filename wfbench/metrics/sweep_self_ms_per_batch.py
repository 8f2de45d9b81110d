"""The graph and scheduler: the sweep's own host time (self ms of
``wf:sweep``: the backpressure scan, punctuation, the pool join, the
durability and reshard cadence), over the batches staged while the
spans were on."""

from wfbench.metrics._spans import per_batch_ms


def read(run):
    return per_batch_ms(run.stats, ("wf:sweep",))
