"""The readers of the program's host spans (``stats()["Spans"]``), on a
synthetic run: their values, and None when the spans were off, when a
span never ran or when nothing was staged."""

import importlib
from types import SimpleNamespace

import pytest

READERS = ("source_wait_ms_per_batch", "ingest_host_ms_per_batch",
           "group_host_ms_per_batch", "sweep_self_ms_per_batch")


def _row(total, self_ms, count=10):
    return {"count": count, "total_ms": total, "self_ms": self_ms}


SPANS = {
    "wf:sweep": _row(400.0, 8.0),
    "wf:tick:ysb_events": _row(380.0, 1.0),
    "wf:source.fetch": _row(12.0, 12.0),
    "wf:source.parse": _row(90.0, 90.0),
    "wf:source.columns": _row(60.0, 60.0),
    "wf:stage.pack": _row(200.0, 30.0),
    "wf:megastep.stack": _row(20.0, 20.0),
    "wf:megastep.launch": _row(100.0, 100.0),
    "wf:megastep.emit": _row(50.0, 50.0),
}
#: each reader's value at 20 batches staged, in ms a batch
WANT = {"source_wait_ms_per_batch": 12.0 / 20,
        "ingest_host_ms_per_batch": (90.0 + 60.0 + 30.0) / 20,
        "group_host_ms_per_batch": (20.0 + 100.0 + 50.0) / 20,
        "sweep_self_ms_per_batch": 8.0 / 20}


def _run(section):
    return SimpleNamespace(stats={} if section is None
                           else {"Spans": section})


def _read(name, run):
    return importlib.import_module(f"wfbench.metrics.{name}").read(run)


@pytest.mark.parametrize("name", READERS)
def test_reads_self_ms_over_batches_staged(name):
    run = _run({"enabled": True, "batches_staged": 20, "spans": SPANS})
    assert _read(name, run) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("section", [
    None,                       # a program without spans (the parent)
    {"enabled": False},         # the spans never on
    {"enabled": True, "batches_staged": 0, "spans": SPANS},
    {"enabled": True, "batches_staged": 20, "spans": {}},
])
def test_none_when_there_is_nothing_to_read(name, section):
    assert _read(name, _run(section)) is None
