"""The share of the traced window in which no operation ran on the card
(1 minus the union of the device's operation intervals over the
window), in percent."""


def read(run):
    if not run.trace or not run.trace["window_s"] or not run.trace["busy_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
