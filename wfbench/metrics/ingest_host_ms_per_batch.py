"""Ingest and staging: the host's parse (the carry and the native parse),
columns (frontier, key lane, value casts) and pack (the staging
emitter), self ms of ``wf:source.parse``, ``wf:source.columns`` and
``wf:stage.pack``, over the batches staged while the spans were on."""

from wfbench.metrics._spans import per_batch_ms


def read(run):
    return per_batch_ms(run.stats, ("wf:source.parse", "wf:source.columns",
                                    "wf:stage.pack"))
