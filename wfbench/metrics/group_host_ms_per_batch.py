"""The megastep plane's host time: the super-buffer's stacking, the
launch (copy-in, copy, replay, clones) and the emission, self ms of
``wf:megastep.stack``, ``wf:megastep.launch`` and ``wf:megastep.emit``,
over the batches staged while the spans were on."""

from wfbench.metrics._spans import per_batch_ms


def read(run):
    return per_batch_ms(run.stats, ("wf:megastep.stack",
                                    "wf:megastep.launch",
                                    "wf:megastep.emit"))
