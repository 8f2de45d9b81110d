"""Shared by the readers of the program's host spans
(``stats()["Spans"]``: per span name its count, total and self ms, and
the batches staged while the spans were on)."""


def per_batch_ms(stats: dict, names, field: str = "self_ms"):
    """The sum of ``field`` over the spans ``names``, in ms a batch
    staged; None when the spans were off or one of them never ran."""
    sec = stats.get("Spans") or {}
    spans = sec.get("spans") or {}
    n = sec.get("batches_staged")
    if not sec.get("enabled") or not n \
            or any(name not in spans for name in names):
        return None
    return sum(spans[name][field] for name in names) / n
