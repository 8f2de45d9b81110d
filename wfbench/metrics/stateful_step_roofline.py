"""The stateful step's share of its memory roofline, in percent: the
configuration's ``least_bytes`` (each lane's card and state read once,
each touched card's row read and written once, each alert written once)
at the card's published bandwidth, over ``stateful_device_ms_per_batch``
(``step_roofline``'s arithmetic)."""

from wfbench.metrics import step_roofline


def read(run):
    return step_roofline.read(run)
