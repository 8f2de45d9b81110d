"""Host-to-device bytes a tuple: the source replicas' staged bytes
(``stats()["Tenant"]``, the graph's row) over the tuples handed over."""


def read(run):
    b = run.stats.get("Tenant", {}).get("graph", {}).get("h2d_bytes")
    return b / run.tuples if b and run.tuples else None
