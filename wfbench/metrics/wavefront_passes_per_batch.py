"""The stateful step's wavefront depth: the passes of the device loop
(one a live rank: the hottest card's lanes in the batch) over the steps,
summed over the stateful operators (``stats()["Stateful"]``, counted on
the device); None when the program has no such counter."""


def read(run):
    ops = (run.stats.get("Stateful") or {}).values()
    batches = sum(o.get("batches", 0) for o in ops)
    if not batches:
        return None
    return sum(o.get("passes", 0) for o in ops) / batches
