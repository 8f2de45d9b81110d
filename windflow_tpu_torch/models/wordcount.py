"""WordCount: the canonical streaming benchmark application (DSPBench
suite), on the port (the JAX package ships it as ``windflow_tpu/models/
wordcount.py``).

``Source(lines) → FlatMap(split) → keyed Reduce(count) → Sink`` — exercises
FlatMap shipping, KEYBY routing and rolling keyed state.  Every stage runs
on the host, so the graph needs no card; it still follows
``config.device`` (the card by default), as every entry point of the
port does.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import windflow_tpu_torch as wt


def build(lines: Iterable[str],
          on_count: Optional[Callable[[str, int], None]] = None,
          source_parallelism: int = 1,
          splitter_parallelism: int = 1,
          counter_parallelism: int = 2,
          batch: int = 0,
          config: Optional[wt.Config] = None) -> wt.PipeGraph:
    """Build the WordCount graph.  ``on_count(word, count)`` observes every
    updated (word, count) pair leaving the counter.  ``batch`` is the
    output batch size of the source and the splitter; 0 sends each tuple
    as its own message."""

    def split(line, shipper):
        for w in line.split():
            shipper.push(w.lower())

    def count(word, state):
        state["word"] = word
        state["n"] = state.get("n", 0) + 1

    def emit(state, ctx=None):
        if state is not None and on_count is not None:
            on_count(state["word"], state["n"])

    src = (wt.Source_Builder(lambda: iter(lines)).withName("line_source")
           .withParallelism(source_parallelism)
           .withOutputBatchSize(batch).build())
    splitter = (wt.FlatMap_Builder(split).withName("splitter")
                .withParallelism(splitter_parallelism)
                .withOutputBatchSize(batch).build())
    counter = (wt.Reduce_Builder(count, dict).withName("counter")
               .withParallelism(counter_parallelism)
               .withKeyBy(lambda w: w).build())
    sink = wt.Sink_Builder(emit).withName("count_sink").build()

    g = wt.PipeGraph("wordcount", wt.ExecutionMode.DEFAULT,
                     config=config or wt.Config())
    g.add_source(src).add(splitter).add(counter).add_sink(sink)
    return g


def run(lines: Iterable[str], **kwargs) -> Dict[str, int]:
    """Run WordCount to completion; returns the final word→count table."""
    counts: Dict[str, int] = {}
    g = build(lines, on_count=lambda w, n: counts.__setitem__(w, n), **kwargs)
    g.run()
    return counts
