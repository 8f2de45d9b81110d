"""Shared by the readers of the latency plane's segments."""


def segment_p50_ms(stats: dict, segment: str):
    """The p50 of ``segment`` (``stats()["Latency_plane"]``, sampled
    batches) at the operator with the most samples of it, in ms; None
    when no batch was sampled there."""
    best = None
    for op in stats.get("Latency_plane", {}).get("per_op", {}).values():
        q = op.get("segments_usec", {}).get(segment)
        if q and q.get("count") and (best is None
                                     or q["count"] > best["count"]):
            best = q
    return None if best is None else best["p50"] / 1e3
