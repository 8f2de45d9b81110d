"""The stateful step's device time a batch: the traced window's kernel
time over the batches staged in it (``device_ms_per_batch``), in a cell
where the scorer, its filter and the batch's unpack are all the card
runs."""

from wfbench.metrics import device_ms_per_batch


def read(run):
    return device_ms_per_batch.read(run)
