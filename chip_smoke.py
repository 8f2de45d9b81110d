#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each exits nonzero on failure; none is skipped):

1. build every CUDA kernel of the port from ``windflow_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. hold each kernel against its plain torch version on the card, at the
   main paths' shapes and at the edges (exact, except the dense table's
   f32 sums of non-integer data: rtol 1e-5 and identical bits from call
   to call), and time the kernel, the plain version and the PyTorch
   calls computing the same function (a yardstick only: the port never
   calls them): device time by ``torch.profiler`` (``device_ms``), with
   the CUDA-event time of back-to-back calls printed beside it.  The
   fold is timed on two masks, ``sliding_fold[dense]`` (90% of the panes
   valid) and ``sliding_fold[main]`` (the FFAT step's own: the carried
   panes and 1-3 new ones a key); the dense table at each of the reduce
   routes' three calls, (a) compacted max, (b) compacted sum and (c)
   dense max; the grouping a second time at the time-window path's
   shape, ``grouping_rank_hist[tb]`` (run (c) of phase 4: ids of 32 keys
   × a 68-pane ring, NB = 2,177), and the fold a third time at the
   market_ticker step's shape, ``sliding_fold[ticker]`` (two f32 leaves
   of [1024, 16389] in one launch, R = 4, max, beside a masked
   ``max_pool1d`` a leaf);
   each a row of its own in the JSON line;
3. drive the main paths through ``PipeGraph.run()`` at the repo's chip
   configuration (262,144 tuples a batch, 1,024 keys), each with the
   launch counts set to 0 just before and read just after:
   * Source → MapGPU | FilterGPU → Ffat_WindowsGPU (count windows of
     1,024 sliding by 128, keyed) → Sink, 8 batches, once with the
     generic combiner and once with ``withSumCombiner()`` (one fold
     launch a step); every fired window against a numpy oracle;
   * Source → MapGPU | FilterGPU → ReduceGPU (keyed, ``withMaxKeys
     (1024)``) → Sink (columnar), every batch's records against a numpy
     oracle of that batch: (a) declared ``max``, the bounded compacted
     route, 8 batches; (b) declared ``sum``, 8 batches; (c) declared
     ``max`` with ``Config(key_compaction=False)``, the dense route, 4
     batches; (d) undeclared ``max``, the sorted route (no kernel), 4
     batches; (e) 2 batches each with keys drawn from [0, 1040) and
     [0, 1100) on routes (a) and (c): the overflow lane, then the
     full-width one; (a) keeps the out-of-range keys, (c) drops and
     counts them.
   The paths run at full width; the reduce runs are cut in depth to the
   batches above so that the whole stays far inside the time limit;
4. drive the time-window path, Source (EVENT time) → [MapGPU |
   FilterGPU] → Ffat_WindowsGPU (``withTBWindows``) → columnar Sink,
   through ``PipeGraph.run()``, 8 batches of 262,144 tuples each, every
   window record (EOS-flushed ones included) against a numpy version of
   the TB oracle (``tests/conftest.py`` ``tb_window_sums``), with no late
   tuple, evicted pane cell or suppressed window:
   * (a) YSB (``windflow_tpu/models/ad_analytics.py``, bench.py's YSB
     leg): 1,000 ads onto 100 campaigns by a seeded table on the device,
     views kept, 10 s tumbling windows keyed by campaign, tuples 305 µs
     apart; the generic combiner (the radix grouping of 6,801 (key,
     pane) ids) and ``withSumCombiner`` (the scatter placement);
   * (b) telemetry (``windflow_tpu/models/telemetry_frames.py``): 1,024
     sensors, 60 s windows sliding by 5 s, lateness 1 s, overflow policy
     drop, readings 100 µs apart jittered back by up to 0.5 s; the
     stable sort of 77,825 ids;
   * (c) 32 keys, 4 s windows sliding by 1 s, tuples 10 µs apart: the
     ring sizes to 68 panes, 2,177 ids, under the grouping kernel's
     gate; the kernel must launch on every step.
   Every run's fold goes through its SWITCH node: ``cond_select``
   launches three times a step (phase 18).

5. drive the columnar ingest path through ``PipeGraph.run()``, 16
   batches of 262,144 tuples each (bench.py ``CONFIGS["tpu"]``'s
   ``e2e_tuples``), each run against its oracle and with the launch
   counts set to 0 just before and read just after:
   * (i) bench.py's e2e leg: a seeded blob of 4,194,304 binary frames
     (96 MiB) read in 1 MiB chunks → ``FrameSource`` → MapGPU | FilterGPU
     → the keyed count windows of phase 3 → columnar Sink (``defer=4``),
     with the generic combiner and with ``withSumCombiner``; every batch
     must stage packed (16 packed batches, no record batch);
   * (ii) bench.py's YSB leg: frames of (ad, event time, event type) →
     ``FrameSource`` → FilterGPU (views) | MapGPU (ad → campaign, a
     seeded table on the device) → 10 s tumbling time windows,
     ``withSumCombiner``, EVENT time, event times over ~64 windows; 16
     packed batches, no late tuple, evicted pane or suppressed window;
   * (iii) bench.py's device-source leg: ``DeviceSource`` batches born
     on the card (the bench's lane hash, in int64) into the graph of (i),
     both combiners;
   then the declared f32 sums repeat bit for bit: a CB and a TB graph
   with ``withSumCombiner`` over random float values, each run twice,
   give the same bits and stay within rtol 1e-5 of a float64 oracle;
6. drive whole-chain fusion, keyed routing, split and merge through
   ``PipeGraph.run()`` at 262,144 tuples a batch and 16 batches, each
   run against its oracle, launch counts set to 0 just before and read
   just after:
   * (a) three graphs built with ``.add(map).add(filter)``, each run
     fused and unfused (``Config.whole_chain_fusion``) in this process:
     (i)'s columnar CB graph (both combiners), (ii)'s YSB graph and
     phase 3 (a)'s bounded compacted reduce fed by ``FrameSource``.
     Fused records equal unfused and the oracle; fused, the Map and
     Filter replicas run no step and the tail one step a batch; each
     run's tuples/s, step wall and launches are printed (information
     only);
   * (b) two ``DeviceSource``s (seeds 1, 2) merged → MapGPU →
     ``ReduceGPU`` keyed at parallelism 4, ``withMaxKeys(1024)``,
     declared max, then declared sum on integer values
     (merge_tests_gpu's shape): the per-key max / sum over all records
     equals the oracle over both streams, every replica steps, the table
     kernel launches on every replica step;
   * (c) (i)'s frames → MapGPU → split by ``key & 1`` (split_tests_gpu's
     shape): branch 0 keyed CB windows, ``withSumCombiner``, parallelism
     2 behind the device keyby (grouping and fold kernels on both
     replicas); branch 1 FilterGPU → keyed ``ReduceGPU`` sum; each
     against its oracle, the split on the mask route;
   * (d) ``FrameSource`` → ``ReduceGPU`` keyed at parallelism 2 through
     ``KeyedDeviceStageEmitter.emit_columns``: every batch stages packed
     and every output batch equals its partition's oracle;
   * (e) device placement (``place_torch``) equals the host's
     ``splitmix64_int`` mod n, n in {2, 3, 4, 7}, over the int32 edges
     and 262,144 random keys;
   * (f) the port's ``entry()`` step on the card equals it on the CPU;
7. drive the stateful operators and key compaction through
   ``PipeGraph.run()`` at 262,144 tuples a batch and 16 batches, each run
   against a numpy oracle that applies the function key by key in
   arrival order, launch counts set to 0 just before and read just
   after (``stateful_runs``):
   * (a) fraud detection (``models/fraud_detection.py``) on frames of
     (card in [0, 16384), type in [0, 8)), a seeded 8 x 8 transition
     table: FrameSource → MapGPU ``cast`` → the stateful scorer (dense
     card ids, the wavefront) → the flag filter (score < 0.05) →
     columnar Sink, fused (one segment ``cast|markov_score``) and
     unfused at K = 1 (phase 17 runs K = 8), records equal; the
     wavefront depth of each batch printed;
   * (b) the same on 16,384 distinct random int32 card ids, the scorer
     fed by the staging: with ``Config.key_compaction`` the compacted
     route (a pinned compactor of 16,384 slots, hit rate 1), without it
     the interning route; records equal;
   * (c) a running count and an integer-valued running sum by
     ``withAssociativeUpdate`` (dense keys, 16,384 slots) on a uniform
     and a Zipf s = 1.1 stream (the hottest key ~15% of a batch); both
     step walls printed;
   * (d) the unbounded compacted ``ReduceGPU`` (declared max, then sum;
     no ``withMaxKeys``: 1,024 slots, reseeded every 4 batches) on keys
     drawn Zipf s = 1.1 over 1,048,576 ids whose ranking changes at
     batch 8, against each batch's oracle; ``dense_monoid_table``
     launches every batch;
   * (e) count windows of 1,024 sliding by 128 keyed by 1,000 random
     int32 ids with ``withCompactedKeys()``, both combiners, fed by the
     FrameSource; every window against the oracle with the user keys in
     the output; the grouping (and fold) kernels launch.
8. drive the wire plane and the megastep plane through
   ``PipeGraph.run()`` at 262,144 tuples a batch and 16 batches a run
   (``megastep_runs``), each run under ``torch.profiler``'s CUDA activity
   with the launch counts set to 0 just before and read just after:
   (i)'s count windows (both combiners, the frames' own timestamps) and
   (ii)'s YSB time windows, each at ``Config.megastep_sweeps`` 1 and 8,
   wire off and on (the sources declare their record spec); a dense and
   a sorted ``ReduceGPU`` fed by the frames and 7 (c)'s associative
   running sums at K = 1 and K = 8.  Every run equals its oracle; K = 8
   equals K = 1 record for record and launches each kernel as often
   (replays counted); at K = 8 ``megasteps`` >= (16 - warm-up -
   remainder) / 8 and > 0, one ``cudaGraphLaunch`` a megastep, and the
   route's hand kernels launch inside the graph.  Printed for
   information: per-batch step wall and group wall a batch, captures and
   their time, kernel launches a group, wire and logical bytes a tuple,
   host encode a batch, tuples/s.  One more run, (i) under INGRESS time
   with the wire on at K = 8, shows that no group forms when the ts
   lane's codec changes every batch (records still equal the oracle).
   Phases 3–7 run under the new defaults: K = 8 and the wire on where a
   source declares its spec.
9. drive the durability plane through ``PipeGraph.run()`` and
   ``PipeGraph.restore()`` (``durability_runs``): each cell runs its
   graph uninterrupted, then an identical graph killed after its first
   committed epoch and restored from the checkpoint store, and the two
   outputs must be equal record for record; the kill point of each cell
   is picked from its baseline (``dur_kill``).  Kafka-fed (an
   ``InMemoryBroker`` of 1,048,576 records, 16,384 a staged batch, an
   epoch every 8 logical sweeps), on the card with K = 8 and the wire on
   by "auto":
   * (a) the six chaos families of ``durability/chaos.py`` through
     ``chaos.run_ab`` at 4,096 keys (``window_compact``: 4,096 sparse
     int32 ids, a remap slot each), killed mid-epoch and fused, every
     (a) cell at 524,288 records (cut in depth when phase 18 joined the
     script: ``window_tb`` and ``reduce``, whose output side is per
     record on the host, took 122 s and 89 s a cell at 1,048,576);
     ``window_cb`` also killed mid-sink-flush (at least one fence
     dedupe) and restored at K = 1; ``stateful`` also killed mid-window
     at K = 1 on 524,288 records (the kill counts the victim's
     per-batch steps, and at K = 8 the stateful tail folds into
     groups);
   * (b) a declared f32-sum count window over random float values
     (equal bit for bit; the grouping and fold kernels launch on the
     restored run) and the unbounded compacted ``ReduceGPU`` sum (the
     table kernel launches on the restored run), both at 1,024 keys;
   * (c) the host reduce killed at parallelism 3, restored at 2 and at
     4 (262,144 records a cell), and ``window_cb`` 2 → 3, compared key
     by key;
   * (d) the ``stateful`` family at 1,048,576 dense key slots.
   The mid-sink-flush and mid-window kills are held against their
   family's mid-epoch baseline.  Each cell prints the
   records compared, the epochs committed, the restored epoch,
   checkpoint ms (and its snapshot part, after the quiesce) and bytes an
   epoch, restore ms, the fence dedupes and the baseline's host
   tuples/s (information only).
10. drive the observability plane (``observability_runs``, 60 s budget),
   launch counts set to 0 just before each run and read just after; a
   run fails if any ``stats()`` section holds an ``"error"`` or reports
   the CPU:
   * (a) (i)'s count windows (event time, wire off, 16 batches), both
     combiners, at K = 8 and K = 1 with ``trace_sample_every=2`` and
     ``trace_device_sync_every=1``, each against the recorder-off run:
     records equal (and equal the oracle), launches equal, every trace's
     stamps ordered staged <= dispatched <= device_done <= sunk, every
     operator's health OK, one dispatch a batch on the fused hop;
     printed: staged->sunk p50/p95/p99 ms, each operator's service
     p50/p99, the Device section's allocated, peak and reserved bytes
     and ``staging.device_bytes``;
   * (b) 7 (d)'s unbounded compacted reduce (max, sum) with the shard
     sketch bound: records equal each batch's oracle,
     ``dense_monoid_table`` every batch, ``churn > 0``, the 4 hottest
     keys after the shift seated, and the Shard section's hottest key
     within the count-min bound of its true count; the hit rate printed;
   * (c) 6 (b)'s merged DeviceSources into the keyed ReduceGPU at
     parallelism 4 (max) with the device sketch in the keyby split:
     per-replica counts equal the host's splitmix64 placement, launches
     and records equal to the sketch-off run;
   * (d) a graph whose sink stops draining: ``run()`` raises
     ``WindFlowError`` naming it, ``dump_postmortem`` writes a bundle and
     ``tools/wf_doctor.py --check`` passes it (a subprocess).
11. drive the observability plane, part two (``plane_runs``, 60 s
   budget), 16 batches of 262,144 tuples a run, launch counts set to 0
   just before each run and read just after; every run's records and
   launches equal its twin with every observability plane off (f):
   * (a) the calibration probes (``windflow_tpu_torch.monitoring.
     calibrate``) write ``calibration.json``: every single-device
     constant measured, ``tools/wf_calibrate.py --check`` exits 0, and
     with it installed every constant reads ``calibrated(...)``; each
     constant printed beside ``nvidia-smi``'s name and power limit;
   * (b) (i)'s count windows (event time, wire off), both combiners, at
     K = 1 and K = 8, every batch traced and waited on, under a generous
     SLO (health OK): each trace's five segments sum to its span; at
     K = 8 ``emitted_to_dispatched`` dominates; a fresh K = 8 run under
     half of K = 8's p99 latches ``SLO_VIOLATED`` on the window naming
     that segment, and ``tools/wf_slo.py`` on its ``dump_stats`` plans
     ``set_megastep_sweeps`` with ``recommended_k < 8``;
   * (c) two tenants in one process, (i)'s declared-sum window and 7
     (d)'s compacted reduce (sum): each tenant's staged and fetched
     bytes equal its graph's totals, resident bytes in (0,
     ``torch.cuda.memory_allocated()``], attributed fraction >= 0.9,
     ``tools/wf_tenant.py --check`` passes; the reduce again under a
     budget of half its resident bytes latches ``OVER_BUDGET`` on the
     reduce, and ``wf_tenant --check`` exits 1;
   * (e) (b)'s K = 8 generic graph with ``tracing_enabled``: the
     monitoring thread samples every 50 ms through the capture into an
     in-process ``DashboardServer``, which receives NEW_APP, NEW_REPORTs
     and END_APP; its ``/metrics`` passes ``tools/wf_metrics.py
     --check``; (d) every hop's ``ratio_vs_roofline`` of that run lies in
     (0, 1.05] against the calibrated bandwidth.
12. drive the analysis plane (``analysis_runs``, 30 s budget), 10
   batches of 262,144 tuples a run:
   * (a) ``PipeGraph.check()`` over (i)'s count windows (event time,
     both combiners, K = 1 and 8), 7 (d)'s compacted reduce (its source
     declaring a record spec) and (ii)'s YSB frames graph: each returns
     ``[]`` while ``torch.cuda.memory_allocated()`` does not change, the
     kernels' launch counts do not move, a ``torch.profiler`` window
     records no CUDA kernel and ``set_sync_debug_mode("error")`` trips
     nothing; ``check_ms`` printed;
   * (b) the same graphs run with ``Config.preflight`` "error" and
     "off": equal records (the count windows also equal their oracle)
     and equal launches;
   * (c) the two-fault graph (a device map whose field comes back
     ``[2·n]``, a non-boolean filter) raises one ``PreflightError``
     naming WF101 and WF102, with allocated bytes and the staging pools
     unchanged;
   * (d) ``cuda_kernels="1"`` with a generic combiner: WF607 names the
     window, and the run launches the grouping kernel and not the fold;
     ``megastep_sweeps=8`` on a keyed fan-out to a window at parallelism
     2: WF608 names the window, and ``stats()["Megastep"]`` shows no
     group on it (records equal to (b)'s generic K = 1 run);
   * (e) with the race detector on, (i)'s generic K = 8 run raises no
     ``ConcurrencyViolation`` and its records equal (b)'s;
   * (f) ``verify_graph`` reports nothing on every graph of (a);
   * (g)-(k), the capture audit (``audit_runs``, 20 s of the phase's
     50 s), 9 batches a run: (g) (i)'s count windows (both combiners)
     and (ii)'s YSB time windows at K = 1 and K = 8, and phase 8's
     dense reduce, each equal to its oracle where it has one, audit
     clean (no WF902-WF907, nothing pending, every program recorded on
     the card, the K = 8 runs' captured bodies listed in
     ``stats()["IR_audit"]``); (h) a MapGPU reading ``.item()`` is
     WF906, and ``python -m windflow_tpu_torch.analysis.ir
     chip_smoke:audit_item_graph --drive 1 --strict`` exits 1 on it;
     (i) with the grouping wrapper swapped for its plain version the
     generic count-window step launches no grouping kernel and is
     WF907 (in (g) the same step launches it and is clean); (j) with
     only the fold wrapper swapped, the sum-combiner step still launches
     the grouping kernel and is WF907 naming the fold (gates and
     launches held per kernel); (k) ``ffat_grouping="argsort"`` keeps
     the grouping kernel on the card, audit clean, records equal to the
     oracle.
13. drive the host window engine, the persistent operators and the
   example apps (``host_window_runs``, 90 s budget), every run through
   ``PipeGraph.run()`` on the card with ``check()`` clean first, the
   launch counts set to 0 just before and read just after, every output
   against a numpy or pure-Python oracle, tuples/s printed beside the
   card's name and power limit (information only):
   * (a) ``ffat_analytics.build()``: 1,024 keys, count windows of 1,024
     by 128, 8 batches of 262,144 integer-valued records (every fired
     window, EOS partials included, exact); it launches the grouping
     kernel;
   * (b) ``market_ticker.build()``: 1,024 symbols, the app's windows of
     64 by 16, 4 batches of 262,144 ticks with Python-float prices:
     every high and low equals a numpy sliding max/min; it launches the
     grouping kernel and the fold (16,389 pane columns a step);
   * (c) ``ad_analytics.build()`` at phase 4 (a)'s YSB shape, 4 batches
     (exact counts); (d) ``telemetry_frames.build()`` at phase 4 (b)'s
     shape on FrameSource frames, 8 batches (``tb_window_sums``);
   * (e) Source → MapGPU | FilterGPU (phase 3's) → a host window → Sink,
     one batch of 262,144 tuples, 1,024 keys: ``Keyed_Windows`` (count,
     incremental; time at (d)'s windows), ``Parallel_Windows``,
     ``Paned_Windows`` (2, 2), ``MapReduce_Windows`` (2, 2) and the host
     ``Ffat_Windows``, whose records also equal ``Ffat_WindowsGPU``
     ``withSumCombiner()``'s on the same stream, record for record;
   * (f) ``spike_detection``: 1,024 devices × 64 readings with spikes
     injected, windows of 16 by 1, parallelism 2, tuple by tuple as the
     app sends them (detections equal a pure-Python oracle);
     (g) ``wordcount``: 131,072 words of a seeded 10,000-word
     vocabulary, counter parallelism 4, ``batch=1024`` (source and
     splitter; ``collections.Counter``);
   * (h) ``P_Keyed_Windows`` on (e)'s keyed count stream equals
     ``Keyed_Windows`` with every key spilled at least once, and a
     ``P_Reduce`` (fed by a host source, batches of 1,024; 65,536
     tuples, half a run) over a ``LogKV`` in a temporary directory
     reopens it after a restart and ends in the state of one run (and
     the oracle);
   * (i) with a durability epoch cadence, ``check()`` on (e)'s keyed
     count graph (fed by a replayable EVENT-time DeviceSource) names the
     host window as WF603 and nothing else;
14. drive the serving plane and the native host runtime through
   ``PipeGraph.run()`` (``serving_runs``; 45 s budget), launch counts
   and the native library's call counts (``native.call_counts``) set to
   0 just before each run and read just after; phase 1 builds the
   native library (g++) beside the kernels, and the phase fails unless
   it loaded and each run entered the native calls it needs:
   * (a) ``move_keys``: 2,097,152 frames (EVENT time, 10 µs apart) →
     ``FrameSource`` → keyed TB ``Ffat_WindowsGPU`` (4 s by 1 s, the
     generic combiner, 96 key rows, a fixed 40-pane ring: the grouping
     kernel) at parallelism 3, one ring a replica, with
     ``Config.reshard_executor`` on: two warm keys (25% each) that the
     keyed staging places on one shard over 64 background keys.  At
     least one move re-homes ring rows in place (fewer moves skipped
     than made), every window equals the TB oracle, and the K = 1 and
     K = 8 (``megastep_sweeps``) runs give the same records; then a
     ring row moved into the static carry of a captured K = 8 TB body
     replays equal to the eager steps after the same move;
   * (b) ``split_hot_key``: frames (a count lane beside the value) →
     keyed staging → a declared-sum ``ReduceGPU`` at parallelism 3, one
     key 60% of the tuples: the split engages (tuples folded at the
     staging boundary), the table kernel launches, the per-key totals
     equal the oracle;
   * (c) admission control: 524,288 records (a dominant key, then
     uniform) → an undeclared keyed ``ReduceGPU`` at parallelism 3 (no
     split applies): the admission factor falls below 1 and recovers to
     1, the per-key totals equal the oracle;
   * (d) native ingest: frames (2,097,152) and CSV (524,288) chunks →
     ``FrameSource`` → phase 5's MapGPU | FilterGPU → CB windows with
     ``withSumCombiner``, against the oracle and against the same graph
     on the numpy parsers (``WF_TPU_NO_NATIVE=1``); both parsers' ms a
     batch printed;
   * (e) ``P_Reduce`` (32,768 tuples) on the native ``LogKV``, its
     store reopened on the Python backend, and the reverse: the states
     equal the oracle; both backends' tuples/s printed;
   * (f) the tenant scheduler ingests ``tenancy.plan`` of two tenants'
     graphs, and a postmortem bundle of (a)'s graph has a
     ``reshard.json`` that ``tools/wf_doctor.py --check`` passes.

15. drive the host worker pool (``pool_runs``, 40 s budget), each run
   at 0 and 4 pool threads (``Config.host_worker_threads``) with equal
   records, tuples/s printed (information only): (a) phase 13 (e)'s
   keyed count windows behind the card stage (65,536 tuples) and (h)'s
   ``P_Reduce`` (16,384 tuples, its state against the oracle); (b)
   frames (9 batches) → phase 5's MapGPU | FilterGPU → count windows
   with ``withSumCombiner`` at K = 8 → a split by key parity into a
   Sink and a host FlatMap → host Map → Sink, under
   ``set_sync_debug_mode("warn")`` with the warnings caught by thread:
   the group is captured, the FlatMap and the direct Sink stay on the
   driver thread, the Map and its Sink are pooled, no pooled replica
   holds a device batch and no pool thread synchronises.

16. drive the mesh (``mesh_runs``, 60 s budget): logical meshes of 4
   positions on the one card (``devices=["cuda:0"] * 4``) at 1x4 and
   2x2 (data x key), 8 batches of 262,144 tuples a run, every run held
   to its numpy oracle and to the same graph with ``mesh=None``: (a)
   the main path (frames → MapGPU | FilterGPU → keyed count windows
   1,024 by 128 over 1,024 keys → columnar Sink), both combiners,
   ``grouping_rank_hist`` (and with the sum ``sliding_fold``) launched
   once a position a step, ``stats()["IR_audit"]`` clean, the key
   shards' state equal along ``data``, and every sharded step (CB, TB,
   the dense reduce under psum, pmax, pmin, the generic fold and the
   aligned ingest, the all_to_all reduce, the stateful step under both
   ingests) under ``set_sync_debug_mode("error")``; (b) the
   telemetry TB windows and phase 4 (c)'s grouping-kernel TB shape
   keyed on the mesh (the latter launching the TB grouping a position a
   step); (c) ``ReduceGPU`` on the mesh: psum, pmax, the generic fold,
   arbitrary int32 keys through ``all_to_all`` (``INT32_MAX``
   included), keys past ``withMaxKeys`` dropped and counted, a global
   reduce; (d) the associative stateful map over key-sharded dense
   state, under the aligned ingest and the data-sharded one (whose lanes
   merge across key shards with a psum); (e) key-aligned ingest on against
   off, twice each (records identical, the shard ledger's modeled
   inter-position bytes drop, WF901 clean on the aligned reduce and
   raised on the unaligned one); (f) a count-window
   checkpoint on 4 key shards restored on 2, its suffix equal to the
   uninterrupted run; (g) ``multihost.initialize()`` a no-op in one
   process, then an NCCL process group at world size 1 carrying (c)'s
   psum through ``torch.distributed``.  It prints the psum's
   inter-position rate (``calibrate.probe_ici``: positions sharing the
   card, a copy within its memory, not a link).
17. drive the stateful wavefront's device loop (``kernels/loop_cuda.py``,
   ``csrc/wavefront_loop.cu``: a CUDA graph WHILE node), 60 s budget
   (``wavefront_runs``): (a) phase 7 (a)'s fraud detection (16,384
   dense card ids, 262,144 tuples a batch, 25 batches: a warm-up batch
   and three K = 8 groups) fused and unfused at K = 1 and K = 8, the
   fused pair once more under ``torch.profiler``, every run against the
   oracle and the others, ``wavefront_loop`` launched once a batch, the
   capture audit free of WF906/WF907, every step after the first and
   every cached group replay under ``set_sync_debug_mode("error")``;
   fused K = 8 forms three groups with nothing refused (unfused, the
   plane refuses only the stateless ``cast`` tail); a
   ``cuda_kernels="0"`` twin gives the same records, its tail refused
   by name and its plain loop's host read named WF906; (b) a general
   (non-associative) running count and sum on a uniform stream at
   262,144 lanes and on 16,384-lane batches one key fills (depth 16,384,
   untraced), records and each batch's depth against numpy; (c) the
   steering kernel against its plain twin on count vectors of depth 1,
   2, 1,024, 1,025 and 16,384, pass by pass up to 1,025 and as the
   captured WHILE loop (slices, classes, pass counts), timed beside its
   plain twin.  Wall, CUDA-event span, device time and operations a
   batch, loop passes and capture ms are printed (information only).
18. drive the JAX package's two ``lax.cond``s as CUDA graph SWITCH
   nodes steered by ``cond_select`` (``kernels/cond_cuda.py``,
   ``csrc/cond_select.cu``), 45 s budget (``cond_runs``): (a) phase 4
   (a)'s YSB and (b)'s telemetry shapes on frames with a record spec
   (262,144 tuples a batch, 17 batches: a warm-up and two K = 8 groups),
   both combiners, at K = 1 and K = 8, each against the numpy TB oracle
   and the ``cuda_kernels="0"`` twin of its graph and stream (the plain
   fold route, at K = 1: records do not depend on K), the TB step
   functions after the first and the cached group replays under
   ``set_sync_debug_mode("error")``, the capture audit free of
   WF906/WF907; the fold's device body counters show passes that
   skipped it; at K = 1 the raw TB steps of the first four batches,
   built with the kernels on and off, are equal on every lane (unfired
   ones included) and their body counts equal the passes that fired
   nothing and those that fired; the YSB generic K = 1 run is traced
   (device time and operations a batch); (b) phase 7 (d)'s
   unbounded compacted reduce, max then sum, behind three batches that
   take each branch (all hit; 4,096 fresh ids, of which the free slots
   admit 512: misses within the overflow lane; every lane cold), each
   batch against its oracle and the kernels-off twin, the step after
   the first under "error", every branch's body counted, no
   WF906/WF907 with the kernels on and WF906 (the plain route's host
   read) with them off; (c) ``cond_select`` against its plain twin for
   every index of 1-, 2- and 3-body switches and out of range, timed.

Before the last line it prints its own seconds in all, the card's name
and power limit and one
JSON line with every kernel's launches, error and times; the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
package beside it, it exits nonzero and prints no result.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

#: the repo's chip configuration (bench.py CONFIGS["tpu"])
CAP, KEYS, WIN, SLIDE = 262144, 1024, 1024, 128
BATCHES = 8
#: time-window runs (EVENT time, CAP tuples a batch, BATCHES batches):
#: (a) YSB: ads, campaigns, µs between tuples, 10 s tumbling windows
YSB_ADS, YSB_CAMPAIGNS, YSB_GAP, YSB_WIN = 1000, 100, 305, (10 ** 7, 10 ** 7)
#: (b) telemetry: sensors, µs between tuples, windows, lateness, jitter
TELE_KEYS, TELE_GAP, TELE_WIN = 1024, 100, (60 * 10 ** 6, 5 * 10 ** 6)
TELE_LATENESS, TELE_JITTER = 10 ** 6, 5 * 10 ** 5
#: (c) the grouping kernel on the TB path: keys, µs between tuples,
#: windows, panes a window, and the ring the first batch sizes
TBC_KEYS, TBC_GAP, TBC_WIN, TBC_R, TBC_NP = 32, 10, (4 * 10 ** 6, 10 ** 6), \
    4, 68
#: columnar runs (phase 5): batches a run, and bytes a FrameSource chunk
COL_BATCHES, CHUNK_BYTES = 16, 1 << 20
#: phase 13's market_ticker: symbols, its count windows (64 by 16) and
#: the batches at CAP (its step's pane axis: R - 1 + CAP / 16 + 2 =
#: 16,389 columns)
TICK_SYMS, TICK_WIN, TICK_BATCHES = 1024, (64, 16), 4
#: H100 SXM memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM 32-bit rate outside the tensor cores, operations/s
OPS_PER_S = 67e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_time(fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(event):
    t = getattr(event, "self_device_time_total", None)
    return getattr(event, "self_cuda_time_total", 0.0) if t is None else t


def device_ms(fn, iters=20, attempts=3):
    """Mean device milliseconds of ``fn()``: the kernel time that
    ``torch.profiler`` records over ``iters`` calls, gaps between
    kernels left out (CUDA events over back-to-back calls measure the
    host's issue rate instead wherever a call's Python and launch
    overhead exceeds its device work).  A trace that holds no device
    record at all (the profiler now and then delivers none) is taken
    again, up to ``attempts`` traces in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = prof.key_averages()
        us = sum(_device_us(e) for e in evs if e.device_type.name == "CUDA")
        if us > 0:
            return us / iters / 1e3
        print(f"chip_smoke: torch.profiler recorded no device time "
              f"(trace {attempt} of {attempts})", file=sys.stderr)
    fail("torch.profiler recorded no device time: "
         f"{[(e.key[:40], e.device_type.name) for e in evs][:20]}")


def timings(label, **fns):
    """Device ms of each named call (``device_ms``), with the CUDA-event
    ms of back-to-back calls printed beside them."""
    dev = {k: device_ms(fn) for k, fn in fns.items()}
    ev = {k: cuda_time(fn) for k, fn in fns.items()}
    print(f"{label}: " + ", ".join(
        f"{k} {dev[k]:.5f} ms device / {ev[k]:.5f} ms events"
        for k in fns))
    return dev


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_grouping(dev):
    """Grouping kernel vs its plain version: main shape + edges, exact.
    Edges: one id for every lane (the widest match-any group), NB = 4096,
    the gate's 2^22 lanes, B not a multiple of the 2,048-lane tile."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.windows.grouping import invert_perm
    rng = np.random.default_rng(7)
    worst = 0
    # (lanes, buckets, the one id of every lane or None for random ids)
    cases = [(CAP, KEYS + 1, None), (1000, 2, None), (CAP + 77, 4096, None),
             (255, 4096, None), (257, 129, None), (CAP, KEYS + 1, 7),
             (4097, 2, 1), (4096, 4096, 4095), (1 << 22, KEYS + 1, None),
             (1 << 22, 4096, None), (4095, 4096, None), (1, 2, 0)]
    for B, NB, one in cases:
        ids = rng.integers(0, NB, B) if one is None else np.full(B, one)
        ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
        got = fc.grouping_rank_hist(ids, NB)
        torch.cuda.synchronize()
        want = fc.grouping_rank_hist_plain(ids, NB)
        for name, g, w in zip(("dest", "rank", "hist"), got, want):
            worst = max(worst, (g.long() - w.long()).abs().max().item())
            if not torch.equal(g, w):
                fail(f"grouping_rank_hist {name} differs at B={B} NB={NB} "
                     f"one={one}")
        order = invert_perm(got[0])
        if not torch.equal(order.long(), torch.sort(ids, stable=True).indices):
            fail(f"order_hist is not the stable argsort at B={B} NB={NB}")
    ids = torch.from_numpy(
        rng.integers(0, KEYS + 1, CAP).astype(np.int32)).to(dev)
    NB = KEYS + 1
    t = timings(f"grouping_rank_hist at B={CAP} NB={NB}",
                kernel=lambda: fc.grouping_rank_hist(ids, NB),
                plain=lambda: fc.grouping_rank_hist_plain(ids, NB),
                library=lambda: (torch.sort(ids, stable=True),
                                 torch.bincount(ids, minlength=NB)))
    ms, plain_ms, lib_ms = t["kernel"], t["plain"], t["library"]
    # the function's own bytes and work, whatever the design: ids in,
    # dest and rank out, hist out; one count and one rank a lane
    b_ms, b_by = bound_ms(CAP * 4 + 2 * CAP * 4 + NB * 4, 2 * CAP)
    return [{"name": "grouping_rank_hist", "route": "cuda",
             "source": "windflow_tpu_torch/csrc/grouping_rank_hist.cu",
             "replaces": "windflow_tpu/kernels/pallas_ffat.py:214",
             "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}]


def tb_grouping_ids(rng, K, NP, n):
    """The (key, pane) ids of a TB step at run (c)'s shape
    (``ffat_kernels.make_ffat_tb_step``'s ``sid``): ``key * NP + rel``
    for the lanes of ``n`` tuples ``TBC_GAP`` µs apart, panes of 1 s, the
    ring base one window span behind the batch."""
    keys = rng.integers(0, K, n)
    rel = (np.arange(n) * TBC_GAP) // TBC_WIN[1] + TBC_R
    return (keys * NP + rel).astype(np.int32)


def check_grouping_tb(dev):
    """The grouping kernel at the TB path's shape, run (c): ids int32
    [262144], NB = K*NP + 1 = 2,177; bit for bit against its plain
    version (and its order against the stable sort), timed beside it,
    its bound and ``sort(stable)`` + ``bincount``."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.windows.grouping import invert_perm
    NB = TBC_KEYS * TBC_NP + 1
    ids = torch.from_numpy(tb_grouping_ids(np.random.default_rng(17),
                                           TBC_KEYS, TBC_NP, CAP)).to(dev)
    got = fc.grouping_rank_hist(ids, NB)
    torch.cuda.synchronize()
    want = fc.grouping_rank_hist_plain(ids, NB)
    worst = 0
    for name, g, w in zip(("dest", "rank", "hist"), got, want):
        worst = max(worst, (g.long() - w.long()).abs().max().item())
        if not torch.equal(g, w):
            fail(f"grouping_rank_hist[tb] {name} differs from its plain "
                 "version")
    if not torch.equal(invert_perm(got[0]).long(),
                       torch.sort(ids, stable=True).indices):
        fail("order_hist[tb] is not the stable argsort")
    t = timings(f"grouping_rank_hist[tb] at B={CAP} NB={NB}",
                kernel=lambda: fc.grouping_rank_hist(ids, NB),
                plain=lambda: fc.grouping_rank_hist_plain(ids, NB),
                library=lambda: (torch.sort(ids, stable=True),
                                 torch.bincount(ids, minlength=NB)))
    b_ms, b_by = bound_ms(CAP * 4 + 2 * CAP * 4 + NB * 4, 2 * CAP)
    return [{"name": "grouping_rank_hist[tb]", "route": "cuda",
             "source": "windflow_tpu_torch/csrc/grouping_rank_hist.cu",
             "replaces": "windflow_tpu/kernels/pallas_ffat.py:214",
             "max_abs_err": worst, "ms": t["kernel"], "plain_ms": t["plain"],
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": t["library"]}]


def main_fold_mask(rng, K, NPP, R):
    """The FFAT step's pane mask at the fold (``ffat_kernels.py``'s
    ``full_valid``): the R-1 carried panes, then 1-3 new ones a key
    (~256 tuples a key a batch at P = 128), and no live pane for the keys
    that the filter ``(key & 7) != 7`` empties."""
    live = (R - 1) + rng.integers(1, 4, K)
    v = np.arange(NPP)[None, :] < live[:, None]
    v[(np.arange(K) & 7) == 7] = False
    return v


def fold_bits(t):
    """A fold result as int32 bits (-0.0 and 0.0 differ)."""
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def fold_err(got, want):
    """Largest difference of two fold results (equal infinities count 0)."""
    if not got.numel():
        return 0.0
    d = got.double() - want.double()
    return d.masked_fill(got.double() == want.double(), 0.0).abs().max().item()


def fold_edges(dev, rng):
    """The fold kernel against its plain version at its edges, bit for
    bit: -0.0 at column 0 of every case, all-invalid and all-valid rows,
    row pitches that are and are not a multiple of 4, R = 1, 2, 7, 8, 16,
    17, 31, 33, 512 (the register path ends at 16), N < R, K = 1, a view
    off 16-byte alignment (the shared-memory path), runs of 4 and 16
    outputs a thread, and pytrees of f32 and i32 leaves (one launch up to
    four leaves).  Returns the largest difference."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    worst = 0.0

    def same(got, want, what):
        nonlocal worst
        worst = max(worst, fold_err(got, want))
        if not torch.equal(fold_bits(got), fold_bits(want)):
            fail(f"sliding_fold differs from its plain version: {what}")

    # (K, N, R, mask: "rows" = a third of the rows all invalid, a third
    # all valid, the rest 80% valid; "main" = the FFAT step's)
    cases = [(KEYS, 2056, 8, "main"), (64, 2056, 8, "rows"),
             (33, 2057, 2, "rows"), (9, 300, 7, "rows"), (9, 300, 1, "rows"),
             (9, 300, 16, "rows"), (9, 300, 17, "main"),
             (9, 300, 31, "main"), (9, 300, 33, "rows"),
             (2, 4096 - 511, 512, "rows"), (5, 5, 8, "rows"),
             (4, 3, 33, "rows"), (1, 2057, 8, "rows"), (1, 1, 1, "rows"),
             # past the Pallas kernel's 4,096-pane block: the register
             # path (R = 4, market_ticker's pane axis) and the
             # shared-memory path (R = 33; R = 512 over 274 column tiles)
             (3, 16389, 4, "rows"), (3, 16389, 33, "rows"),
             (2, 70000, 512, "rows")]
    for K, N, R, pattern in cases:
        if pattern == "main":
            v = main_fold_mask(rng, K, N, R)
        else:
            v = rng.random((K, N)) < 0.8
            v[0::3] = False
            v[1::3] = True
        v = torch.from_numpy(v).to(dev)
        x = rng.standard_normal((K, N)) * 1000
        x[:, 0] = -0.0
        for dt in (torch.float32, torch.int32):
            xt = torch.from_numpy(x).to(dt).to(dev)
            for monoid in ("sum", "max", "min"):
                fc.reset_launch_counts()
                got = fc.sliding_fold(xt, v, R, monoid)
                if fc.launch_counts()["sliding_fold"] != 1:
                    fail("sliding_fold took more than one launch for a leaf")
                torch.cuda.synchronize()
                same(got, fc.fold_leaf_plain(xt, v, R, monoid),
                     f"{monoid} {dt} K={K} N={N} R={R} {pattern}")
    # main shape: a view 4 bytes off alignment, and every run length
    P = int(np.gcd(WIN, SLIDE))
    R = WIN // P
    NPP = (R - 1) + CAP // P + 2
    base = torch.from_numpy(rng.standard_normal((KEYS + 1, NPP))
                            .astype(np.float32)).to(dev)
    default_run = fc.FOLD_RUN
    try:
        for run in (4, 8, 16):
            fc.FOLD_RUN = run
            for pattern in ("dense", "main"):
                v = torch.from_numpy(
                    main_fold_mask(rng, KEYS, NPP, R) if pattern == "main"
                    else rng.random((KEYS, NPP)) < 0.9).to(dev)
                for x in (base[:KEYS], base[1:]):
                    for monoid in ("sum", "max", "min"):
                        same(fc.sliding_fold(x, v, R, monoid),
                             fc.fold_leaf_plain(x, v, R, monoid),
                             f"{monoid} run {run} {pattern} "
                             f"offset {x.data_ptr() % 16}")
    finally:
        fc.FOLD_RUN = default_run
    # pytrees: f32 and i32 leaves of one dict, four leaves a launch
    v = torch.from_numpy(main_fold_mask(rng, KEYS, NPP, R)).to(dev)
    for nleaves, launches in ((2, 1), (4, 1), (5, 2)):
        tree = {f"l{i}": torch.from_numpy(
            rng.integers(-1000, 1000, (KEYS, NPP))
            .astype(np.float32 if i % 2 == 0 else np.int32)).to(dev)
            for i in range(nleaves)}
        for monoid in ("sum", "max", "min"):
            fc.reset_launch_counts()
            got = fc.sliding_fold(tree, v, R, monoid)
            if fc.launch_counts()["sliding_fold"] != launches:
                fail(f"sliding_fold took {fc.launch_counts()['sliding_fold']}"
                     f" launches for {nleaves} leaves, {launches} expected")
            for k, leaf in tree.items():
                if got[k].dtype != leaf.dtype:
                    fail("sliding_fold changed a leaf's dtype")
                same(got[k], fc.fold_leaf_plain(leaf, v, R, monoid),
                     f"pytree of {nleaves} leaves, {k}, {monoid}")
    return worst


def fold_inputs(dev, rng, pattern):
    """The main-path call's inputs, f32 [1024, 2057] + bool mask, R = 8:
    ``dense`` has 90% of the panes valid, ``main`` the FFAT step's mask."""
    import torch
    P = int(np.gcd(WIN, SLIDE))
    R = WIN // P
    NPP = (R - 1) + CAP // P + 2
    if pattern == "main":
        v = main_fold_mask(rng, KEYS, NPP, R)
    else:
        v = rng.random((KEYS, NPP)) < 0.9
    x = rng.standard_normal((KEYS, NPP)).astype(np.float32)
    return (torch.from_numpy(x).to(dev), torch.from_numpy(v).to(dev), R)


def fold_bound(valid, R, leaves=1):
    """Bound of one fold call over ``leaves`` f32 leaves: the mask read
    once, each output written, and each leaf's values in the 32-byte
    sectors that hold a valid pane; one combine a level and a stitch for
    each output whose window holds a valid pane, a leaf."""
    import torch
    n = valid.numel()
    flat = torch.nn.functional.pad(valid.reshape(-1).to(torch.uint8),
                                   (0, -n % 8))
    sectors = int(flat.reshape(-1, 8).any(1).sum())
    c = torch.nn.functional.pad(valid.int().cumsum(1), (R, 0))
    live = int(((c[:, R:] - c[:, :-R]) > 0).sum())
    nops = leaves * live * (R.bit_length() - 1 + bin(R).count("1") - 1)
    return bound_ms(n + leaves * (4 * n + 32 * sectors), nops)


def ticker_fold_inputs(dev, rng):
    """The market_ticker step's fold call at CAP: its two f32 leaves
    ``{"hi": p, "lo": -p}`` over [1024, R - 1 + CAP / 16 + 2] = [1024,
    16389] panes, R = 4, a declared max; the mask of a batch of symbols
    drawn uniformly, the R - 1 carried panes then a key's new full
    panes."""
    import torch
    W, S = TICK_WIN
    P, R = int(np.gcd(W, S)), W // int(np.gcd(W, S))
    NPP = (R - 1) + CAP // P + 2
    per_key = rng.multinomial(CAP,
                              np.full(TICK_SYMS, 1.0 / TICK_SYMS))
    live = (R - 1) + per_key // P
    v = np.arange(NPP)[None, :] < live[:, None]
    p = (10.0 + rng.random((TICK_SYMS, NPP)) * 90.0).astype(np.float32)
    x = torch.from_numpy(p).to(dev)
    return {"hi": x, "lo": -x}, torch.from_numpy(v).to(dev), R


def check_fold_ticker(dev):
    """The fold kernel at market_ticker's own step shape (two f32 leaves,
    R = 4, max; one launch for both leaves) against its plain version,
    bit for bit, timed beside its bound and the PyTorch calls that
    compute the same function (a masked ``max_pool1d`` a leaf)."""
    import torch
    import torch.nn.functional as F
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    rng = np.random.default_rng(13)
    tree, valid, R = ticker_fold_inputs(dev, rng)
    fc.reset_launch_counts()
    got = fc.sliding_fold(tree, valid, R, "max")
    if fc.launch_counts()["sliding_fold"] != 1:
        fail("sliding_fold[ticker]: two leaves took more than one launch")
    torch.cuda.synchronize()
    worst = 0.0
    for k, leaf in tree.items():
        want = fc.fold_leaf_plain(leaf, valid, R, "max")
        worst = max(worst, fold_err(got[k], want))
        if not torch.equal(fold_bits(got[k]), fold_bits(want)):
            fail(f"sliding_fold[ticker] leaf {k} differs from its plain "
                 "version")

    def plain():
        return {k: fc.fold_leaf_plain(l, valid, R, "max")
                for k, l in tree.items()}

    def pool():
        return {k: F.max_pool1d(F.pad(torch.where(valid, l, -np.inf)
                                      [:, None, :], (R - 1, 0),
                                      value=-np.inf), R, stride=1)[:, 0]
                for k, l in tree.items()}
    lib = pool()
    for k in tree:
        if not torch.equal(lib[k], got[k]):
            fail(f"max_pool1d yardstick disagrees with the fold [{k}]")
    t = timings(f"sliding_fold[ticker] max, 2 f32 leaves at "
                f"{list(valid.shape)} R={R}",
                kernel=lambda: fc.sliding_fold(tree, valid, R, "max"),
                plain=plain, library=pool)
    b_ms, b_by = fold_bound(valid, R, leaves=2)
    return [{"name": "sliding_fold[ticker]", "route": "cuda",
             "source": "windflow_tpu_torch/csrc/sliding_fold.cu",
             "replaces": "windflow_tpu/kernels/pallas_ffat.py:407",
             "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": t["library"],
             "max_abs_err": worst}]


def check_fold(dev):
    """Fold kernel vs its plain version on [1024, 2057], R = 8, every
    monoid × f32/i32, bit for bit, at both rows' masks, plus the edges of
    ``fold_edges``; each row timed beside its plain version, its bound and
    ``conv1d``."""
    import torch
    import torch.nn.functional as F
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    rng = np.random.default_rng(11)
    worst = fold_edges(dev, rng)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for pattern in ("dense", "main"):
        x, valid, R = fold_inputs(dev, rng, pattern)
        xi = torch.from_numpy(rng.integers(-1 << 20, 1 << 20, tuple(x.shape))
                              .astype(np.int32)).to(dev)
        for xt in (x, xi):
            for monoid in ("sum", "max", "min"):
                got = fc.sliding_fold(xt, valid, R, monoid)
                torch.cuda.synchronize()
                want = fc.fold_leaf_plain(xt, valid, R, monoid)
                worst = max(worst, fold_err(got, want))
                if not torch.equal(fold_bits(got), fold_bits(want)):
                    fail(f"sliding_fold[{pattern}] {monoid} {xt.dtype} "
                         "differs from its plain version")
        w = torch.ones((1, 1, R), dtype=torch.float32, device=dev)

        def conv_sum(x=x, valid=valid, w=w, R=R):
            xin = torch.where(valid, x, 0.0)[:, None, :]
            return F.conv1d(F.pad(xin, (R - 1, 0)), w)
        t = timings(f"sliding_fold[{pattern}] sum at {list(x.shape)} R={R}",
                    kernel=lambda: fc.sliding_fold(x, valid, R, "sum"),
                    plain=lambda: fc.fold_leaf_plain(x, valid, R, "sum"),
                    library=conv_sum)
        if not torch.allclose(conv_sum()[:, 0],
                              fc.sliding_fold(x, valid, R, "sum"),
                              rtol=1e-5, atol=1e-5):
            fail(f"conv1d yardstick disagrees with the fold [{pattern}]")
        b_ms, b_by = fold_bound(valid, R)
        out.append({"name": f"sliding_fold[{pattern}]", "route": "cuda",
                    "source": "windflow_tpu_torch/csrc/sliding_fold.cu",
                    "replaces": "windflow_tpu/kernels/pallas_ffat.py:407",
                    "ms": t["kernel"], "plain_ms": t["plain"],
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": t["library"]})
    for r in out:
        r["max_abs_err"] = worst
    return out


def table_yardstick(row, leaves, ops, inits, S):
    """The PyTorch calls that compute the same tables as one
    ``dense_monoid_table`` call: per leaf one ``index_add_`` (sum) or
    ``scatter_reduce_`` (max/min) into an ``[S + 1]`` buffer whose last
    row takes the lanes outside ``[0, S)``.  Returns ``(run, bufs)``: the
    buffers start at the inits, and ``run()`` folds into them (max/min
    are idempotent; a repeated sum only changes the values)."""
    import torch
    idx = torch.where((row >= 0) & (row < S), row,
                      torch.full_like(row, S)).long()
    bufs, calls = [], []
    for l, op, init in zip(leaves, ops, inits):
        buf = torch.full((S + 1,) + tuple(l.shape[1:]), init, dtype=l.dtype,
                         device=l.device)
        bufs.append(buf)
        if op == "sum":
            calls.append(lambda b=buf, l=l: b.index_add_(0, idx, l))
        else:
            ix = idx.reshape((-1,) + (1,) * (l.ndim - 1)).expand(l.shape)
            calls.append(lambda b=buf, l=l, ix=ix, r="a" + op:
                         b.scatter_reduce_(0, ix, l, r, include_self=True))

    def run():
        for c in calls:
            c()
    return run, bufs


def check_table(dev):
    """Dense-table kernel vs its plain version: the reduce routes' three
    calls at the main shape (B = 262,144, S = 1,024), each timed beside
    its PyTorch yardstick and its bound; the edges of
    tests/test_pallas_kernels.py and of the kernel's design (every lane
    in one slot, S = 4096, the gate's 2^22 lanes, B not a multiple of
    the 2,048-lane tile), every op and dtype, rows outside [0, S).
    Exact, except f32 sums of non-integer data (rtol 1e-5 and the same
    bits on two calls)."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.kernels import reduce_cuda as rc
    from windflow_tpu_torch.parallel.compaction import _enc64
    rng = np.random.default_rng(13)
    I64MIN = -2 ** 63
    keys, vals = main_path_data(CAP, seed=13, key_range=KEYS + 16)
    vals = vals * np.float32(1.5) + np.float32(1.0)
    keep = (keys & 7) != 7
    ts = np.arange(CAP, dtype=np.int64) + 10 ** 15
    k_t, v_t, ts_t = (torch.from_numpy(a).to(dev) for a in (keys, vals, ts))
    hit = torch.from_numpy(keep & (keys < KEYS)).to(dev)
    row = torch.where(hit, k_t, torch.full_like(k_t, KEYS)).contiguous()
    carrier = torch.cat([_enc64(k_t)[:, None], _enc64(v_t)[:, None],
                         ts_t[:, None]], 1).contiguous()
    ok = torch.from_numpy(keep).to(dev)
    drow = torch.where(ok & (k_t < KEYS), k_t,
                       torch.full_like(k_t, KEYS)).contiguous()
    ones = torch.ones(CAP, dtype=torch.int32, device=dev)
    # the reduce routes' calls (half-integer values: every sum is exact)
    main_calls = {
        "a": ("compacted max (packed int64 carrier [B, 3])",
              (row, [carrier], ["max"], [I64MIN])),
        "b": ("compacted sum (key i32, v0 f32, ts i64 max)",
              (row, [k_t, v_t, ts_t], ["sum", "sum", "max"],
               [0, 0.0, I64MIN])),
        "c": ("dense max (key, v0, count, ts)",
              (drow, [k_t, v_t, ones, ts_t], ["max", "max", "sum", "max"],
               [-2 ** 31, float("-inf"), 0, -1])),
    }
    worst = 0
    out = []
    for tag, (name, args) in main_calls.items():
        got = rc.dense_monoid_table(*args, KEYS)
        torch.cuda.synchronize()
        want = rc.dense_monoid_table_plain(*args, KEYS)
        lib, bufs = table_yardstick(*args, KEYS)
        lib()
        for g, w, b in zip(got, want, bufs):
            worst = max(worst, (g.double() - w.double()).abs().max().item())
            if not torch.equal(g, w):
                fail(f"dense_monoid_table differs on {name}")
            if not torch.equal(g, b[:KEYS]):
                fail(f"the yardstick disagrees with the table on {name}")
        t = timings(f"dense_monoid_table ({tag}) {name} at B={CAP} S={KEYS}",
                    kernel=lambda: rc.dense_monoid_table(*args, KEYS),
                    plain=lambda: rc.dense_monoid_table_plain(*args, KEYS),
                    library=lib)
        r, leaves = args[0], args[1]
        nbytes = r.numel() * 4 + sum(
            l.numel() * l.element_size() + KEYS * (l.numel() // CAP)
            * l.element_size() for l in leaves)
        b_ms, b_by = bound_ms(nbytes, sum(l.numel() for l in leaves))
        out.append({"name": f"dense_monoid_table[{tag}]", "route": "cuda",
                    "source": "windflow_tpu_torch/csrc/dense_monoid_table.cu",
                    "replaces": "windflow_tpu/kernels/pallas_ffat.py:530",
                    "ms": t["kernel"], "plain_ms": t["plain"],
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": t["library"]})
    # (lanes, slots, the one slot of every lane or None for random rows)
    for B, S, one in ((64, 8, None), (300, 17, None), (100, 4096, None),
                      (5, 1, None), (262221, 4096, None), (CAP, KEYS, 5),
                      (4097, 4096, 4095), (1 << 22, KEYS, None),
                      (4095, 33, None)):
        r = rng.integers(-3, S + 3, B) if one is None else np.full(B, one)
        r = torch.from_numpy(r.astype(np.int32)).to(dev)
        leaves = [torch.from_numpy(a).to(dev) for a in (
            rng.integers(-2 ** 40, 2 ** 40, (B, 3)),
            rng.integers(-100, 100, B).astype(np.float32),
            rng.integers(-1000, 1000, (B, 8)).astype(np.int32),
            rng.random(B) < 0.3)]
        for op in ("sum", "max", "min"):
            inits = [fc.monoid_identity(op, l.dtype) for l in leaves]
            got = rc.dense_monoid_table(r, leaves, [op] * 4, inits, S)
            torch.cuda.synchronize()
            want = rc.dense_monoid_table_plain(r, leaves, [op] * 4, inits, S)
            for g, w in zip(got, want):
                worst = max(worst,
                            (g.double() - w.double()).abs().max().item())
                if not torch.equal(g, w):
                    fail(f"dense_monoid_table {op} differs at B={B} S={S} "
                         f"one={one}")
        # one f32-sum column of non-integer data: the same bits on two
        # calls, within rtol 1e-5 of the exact sum and of the plain
        # scatter-add (whose own f32 rounding is ~1e-5 where one slot
        # takes 262,144 lanes, so there only the exact sum)
        x = torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32)) \
            .to(dev)
        a = rc.dense_monoid_table(r, [x], ["sum"], [0.0], S)[0]
        b = rc.dense_monoid_table(r, [x], ["sum"], [0.0], S)[0]
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"dense_monoid_table f32 sum not deterministic at B={B}")
        exact = rc.dense_monoid_table_plain(r, [x.double()], ["sum"], [0.0],
                                            S)[0]
        if not torch.allclose(a.double(), exact, rtol=1e-5, atol=0):
            fail(f"dense_monoid_table f32 sum beyond rtol 1e-5 of the exact "
                 f"sum at B={B} S={S}")
        if one is None and not torch.allclose(a, rc.dense_monoid_table_plain(
                r, [x], ["sum"], [0.0], S)[0], rtol=1e-5, atol=0):
            fail(f"dense_monoid_table f32 sum beyond rtol 1e-5 at B={B}")
    for row_ in out:
        row_["max_abs_err"] = worst
    return out


def oracle(keys, vals):
    """{(key, wid): sum} over every CB window with data, partial windows
    flushed at EOS included; float64 (exact for the half-integer data)."""
    out = {}
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], vals[order].astype(np.float64)
    bounds = np.flatnonzero(np.diff(ks)) + 1
    for seg_k, seg_v in zip(np.split(ks, bounds), np.split(vs, bounds)):
        if not len(seg_k):
            continue
        cs = np.concatenate([[0.0], np.cumsum(seg_v)])
        n = len(seg_v)
        starts = np.arange(0, n, SLIDE)
        ends = np.minimum(starts + WIN, n)
        sums = cs[ends] - cs[starts]
        for w, s in enumerate(sums):
            out[(int(seg_k[0]), w)] = s
    return out


def main_path_data(n, seed=2024, key_range=KEYS):
    """``n`` records of the main path: int32 keys in [0, key_range) and
    integer-valued float32 values (every window sum is exact)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, n).astype(np.int32)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    return keys, vals


def main_path_graph(dev_name, sum_combiner, keys, vals, sink_fn):
    """The main path as a user builds it: Source → MapGPU | FilterGPU
    (chained) → Ffat_WindowsGPU (count windows, keyed) → Sink over the
    records ``keys``/``vals``.  Returns ``(graph, pipe)``; the pipe's
    operators are [source, map|filter chain, windows, sink]."""
    import windflow_tpu_torch as wf

    def gen():
        yield from ({"key": k, "v0": v} for k, v in zip(keys, vals))

    src = wf.Source_Builder(gen).withOutputBatchSize(CAP).build()
    m = wf.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build()
    f = wf.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build()
    wb = (wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
          .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
          .withMaxKeys(KEYS))
    if sum_combiner:
        wb = wb.withSumCombiner()
    snk = wf.Sink_Builder(sink_fn).build()
    g = wf.PipeGraph("chip_smoke", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    pipe = g.add_source(src)
    pipe.add(m)
    pipe.chain(f)
    pipe.add(wb.build()).add_sink(snk)
    return g, pipe


def run_main_path(dev_name, sum_combiner):
    """One PipeGraph.run() of the main path; returns (records, seconds,
    tuples)."""
    n = CAP * BATCHES
    keys, vals = main_path_data(n)
    rows = []
    g, _ = main_path_graph(dev_name, sum_combiner, keys, vals,
                           lambda t: rows.append(t) if t is not None else None)
    t0 = time.perf_counter()
    g.run()
    import torch
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    keep = (keys & 7) != 7
    want = oracle(keys[keep], vals[keep] * np.float32(1.5) + np.float32(1.0))
    got = {(r["key"], r["wid"]): r["value"] for r in rows}
    if len(got) != len(rows):
        fail("duplicate (key, wid) records")
    if set(got) != set(want):
        fail(f"fired windows differ: {len(got)} got, {len(want)} expected")
    bad = [k for k in want if got[k] != want[k]]
    if bad:
        fail(f"{len(bad)} window sums differ, e.g. {bad[0]}: "
             f"{got[bad[0]]} vs {want[bad[0]]}")
    if not all(np.isfinite(v) for v in got.values()):
        fail("non-finite window values")
    return len(rows), secs, n


def reduce_graph(dev_name, monoid, declare, key_compaction, keys, vals,
                 sink_fn):
    """The reduce path as a user builds it: Source → MapGPU | FilterGPU
    (chained) → ReduceGPU (keyed by ``key``, ``withMaxKeys(KEYS)``, the
    leafwise ``monoid`` combiner, declared when ``declare``) → columnar
    Sink.  Returns ``(graph, reduce operator)``."""
    import torch
    import windflow_tpu_torch as wf

    def gen():
        yield from ({"key": k, "v0": v} for k, v in zip(keys, vals))

    op = {"max": torch.maximum, "sum": torch.add}[monoid]
    rb = (wf.ReduceGPU_Builder(lambda a, b: {"key": op(a["key"], b["key"]),
                                             "v0": op(a["v0"], b["v0"])})
          .withKeyBy(lambda t: t["key"]).withMaxKeys(KEYS))
    if declare:
        rb = rb.withMonoidCombiner(monoid)
    red = rb.build()
    g = wf.PipeGraph("chip_smoke_reduce", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      key_compaction=key_compaction))
    pipe = g.add_source(wf.Source_Builder(gen).withOutputBatchSize(CAP)
                        .build())
    pipe.add(wf.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build())
    pipe.chain(wf.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build())
    pipe.add(red).add_sink(wf.Sink_Builder(sink_fn)
                           .withColumnarSink().build())
    return g, red


def reduce_oracle(keys, vals, monoid, max_keys=None):
    """One batch's records, ascending keys: ``(key field, v0)`` after the
    map and filter; ``max_keys`` drops keys outside [0, max_keys)."""
    v = vals * np.float32(1.5) + np.float32(1.0)
    keep = (keys & 7) != 7
    if max_keys is not None:
        keep &= (keys >= 0) & (keys < max_keys)
    uk, inv = np.unique(keys[keep], return_inverse=True)
    if monoid == "max":
        out = np.full(len(uk), -np.inf, np.float32)
        np.maximum.at(out, inv, v[keep])
        return uk.astype(np.int32), out
    sums = np.zeros(len(uk), np.float64)
    np.add.at(sums, inv, v[keep].astype(np.float64))
    counts = np.bincount(inv, minlength=len(uk))
    return (uk.astype(np.int64) * counts).astype(np.int32), \
        sums.astype(np.float32)


def run_reduce(dev_name, monoid, declare, key_compaction, batches,
               key_range=KEYS, seed=4048):
    """One PipeGraph.run() of the reduce path; every batch's records
    against the oracle.  Returns (records, seconds, tuples, stats)."""
    import torch
    n = CAP * batches
    keys, vals = main_path_data(n, seed=seed, key_range=key_range)
    got = []
    g, red = reduce_graph(dev_name, monoid, declare, key_compaction, keys,
                          vals, lambda c: got.append(c) if c is not None
                          else None)
    t0 = time.perf_counter()
    g.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    dense = declare and not key_compaction
    if len(got) != batches:
        fail(f"reduce: {len(got)} sink batches for {batches} batches")
    nrec = 0
    for i, c in enumerate(got):
        sl = slice(i * CAP, (i + 1) * CAP)
        wk, wv = reduce_oracle(keys[sl], vals[sl], monoid,
                               KEYS if dense else None)
        gk, gv = np.asarray(c.cols["key"]), np.asarray(c.cols["v0"])
        if not (np.array_equal(gk, wk) and np.array_equal(gv, wv)):
            fail(f"reduce {monoid} (declared={declare}, compaction="
                 f"{key_compaction}, keys < {key_range}) batch {i}: "
                 f"{len(gk)} records vs {len(wk)} expected, or values "
                 "differ")
        if not np.isfinite(gv).all():
            fail("non-finite reduce values")
        nrec += len(gk)
    keep = (keys & 7) != 7
    n_oor = int((keep & (keys >= KEYS)).sum())
    st = red.dump_stats()
    if dense:
        if st.get("Out_of_range_keys_dropped", 0) != n_oor:
            fail(f"dense route counted {st.get('Out_of_range_keys_dropped')}"
                 f" dropped tuples, {n_oor} expected")
    elif declare:
        if st.get("Out_of_range_keys_rerouted", 0) != n_oor:
            fail(f"compacted route rerouted "
                 f"{st.get('Out_of_range_keys_rerouted')}, {n_oor} expected")
    return nrec, secs, n, st


def tb_oracle(keys, ts, vals, win, slide):
    """numpy version of the TB oracle (tests/conftest.py
    ``tb_window_sums``): the sum of every window ``[w*slide, w*slide +
    win)`` that holds a tuple, per key, EOS-flushed windows included.
    Returns ``(codes, sums)`` sorted by ``code = key * WIDS + wid``
    (float64: exact for integer-valued data).  ``win`` is a multiple of
    ``slide`` here, so a tuple lies in windows ``ts // slide - o`` for
    ``o`` in ``[0, win / slide)``."""
    last = ts // slide
    ks, ws, vs = [], [], []
    for o in range(win // slide):
        w = last - o
        m = w >= 0
        ks.append(keys[m])
        ws.append(w[m])
        vs.append(vals[m])
    k, w = np.concatenate(ks).astype(np.int64), np.concatenate(ws)
    # the codes are dense (keys x window ids): counted in place, which
    # sums in array order as np.unique's inverse would
    code = k * tb_wids(ts, slide) + w
    size = int(code.max()) + 1
    codes = np.flatnonzero(np.bincount(code, minlength=size))
    sums = np.bincount(code, weights=np.concatenate(vs).astype(np.float64),
                       minlength=size)
    return codes, sums[codes]


def tb_wids(ts, slide):
    return int(ts.max()) // slide + 1


def check_tb_records(label, cols, keys, ts, vals, win, slide, want=None):
    """The run's window records (columnar sink batches) against
    ``tb_oracle`` (``want``: its result, computed once for runs of the
    same data), record for record; returns the record count."""
    codes, sums = tb_oracle(keys, ts, vals, win, slide) if want is None \
        else want
    if not cols:
        fail(f"TB {label}: no window records")
    k = np.concatenate([np.asarray(c.cols["key"]) for c in cols])
    w = np.concatenate([np.asarray(c.cols["wid"]) for c in cols])
    v = np.concatenate([np.asarray(c.cols["value"]) for c in cols])
    got = k.astype(np.int64) * tb_wids(ts, slide) + w
    order = np.argsort(got, kind="stable")
    if len(np.unique(got)) != len(got):
        fail(f"TB {label}: duplicate (key, wid) records")
    if not np.array_equal(got[order], codes):
        fail(f"TB {label}: {len(got)} windows fired, {len(codes)} expected,"
             " or other (key, wid)s")
    if not np.isfinite(v).all():
        fail(f"TB {label}: non-finite window values")
    bad = np.flatnonzero(v[order].astype(np.float64) != sums)
    if len(bad):
        i = bad[0]
        fail(f"TB {label}: {len(bad)} window sums differ, e.g. (key, wid) "
             f"code {codes[i]}: {v[order][i]} vs {sums[i]}")
    return len(got)


def ysb_data(n, seed=3):
    """(a): ad ids over 1,000 ads, event types uniform over {0, 1, 2},
    timestamps YSB_GAP µs apart in event-time order, and the seeded
    ad → campaign table."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, YSB_CAMPAIGNS, YSB_ADS).astype(np.int32)
    ad = rng.integers(0, YSB_ADS, n).astype(np.int32)
    etype = rng.integers(0, 3, n).astype(np.int32)
    ts = np.arange(n, dtype=np.int64) * YSB_GAP
    return table, ad, etype, ts


def ysb_graph(dev_name, sum_combiner, table, ad, etype, ts, sink_fn):
    """(a) as a user builds it (windflow_tpu/models/ad_analytics.py,
    bench.py's YSB leg): Source (EVENT time) → FilterGPU (views) |
    MapGPU (ad → campaign, a gather from the table on the device) →
    Ffat_WindowsGPU (10 s tumbling TB counts, keyed by campaign) →
    columnar Sink.  Returns ``(graph, window operator)``."""
    import torch
    import windflow_tpu_torch as wf
    dev_table = torch.from_numpy(table).to(dev_name)

    def gen():
        yield from ({"ad_id": a, "etype": e, "ts": t}
                    for a, e, t in zip(ad, etype, ts.tolist()))

    win = (wf.Ffat_WindowsGPU_Builder(lambda e: e["one"], lambda a, b: a + b)
           .withTBWindows(*YSB_WIN).withKeyBy(lambda e: e["campaign"])
           .withMaxKeys(YSB_CAMPAIGNS))
    if sum_combiner:
        win = win.withSumCombiner()
    win = win.build()
    g = wf.PipeGraph("chip_smoke_ysb", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.EVENT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    pipe = g.add_source(wf.Source_Builder(gen)
                        .withTimestampExtractor(lambda e: e["ts"])
                        .withOutputBatchSize(CAP).build())
    pipe.add(wf.FilterGPU_Builder(lambda e: e["etype"] == 1).build())
    pipe.chain(wf.MapGPU_Builder(
        lambda e: {"campaign": dev_table[e["ad_id"].long()], "one": 1})
        .build())
    pipe.add(win).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink()
                           .build())
    return g, win


def telemetry_data(n, seed=5):
    """(b): sensors uniform over TELE_KEYS, integer-valued float32
    readings, timestamps TELE_GAP µs apart in arrival order, each
    jittered back by up to TELE_JITTER (inside the lateness)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, TELE_KEYS, n).astype(np.int32)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    ts = np.maximum(np.arange(n, dtype=np.int64) * TELE_GAP
                    - rng.integers(0, TELE_JITTER + 1, n), 0)
    return keys, vals, ts


def keyed_tb_graph(dev_name, name, keys, vals, ts, max_keys, win, sink_fn,
                   lateness=0, policy="drop", normalize=False):
    """Source (EVENT time) of ``{"key", "v0", "ts"}`` records → [MapGPU
    normalize | FilterGPU drop-NaN, as windflow_tpu/models/
    telemetry_frames.py builds them] → Ffat_WindowsGPU (TB ``win``,
    keyed, generic ``a + b``) → columnar Sink.  Returns ``(graph, window
    operator)``."""
    import windflow_tpu_torch as wf

    def gen():
        yield from ({"key": k, "v0": v, "ts": t}
                    for k, v, t in zip(keys, vals, ts.tolist()))

    win_op = (wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"],
                                         lambda a, b: a + b)
              .withTBWindows(*win).withKeyBy(lambda t: t["key"])
              .withMaxKeys(max_keys).withLateness(lateness)
              .withOverflowPolicy(policy).build())
    g = wf.PipeGraph(name, wf.ExecutionMode.DEFAULT, wf.TimePolicy.EVENT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    pipe = g.add_source(wf.Source_Builder(gen)
                        .withTimestampExtractor(lambda t: t["ts"])
                        .withOutputBatchSize(CAP).build())
    if normalize:
        pipe.add(wf.MapGPU_Builder(
            lambda t: {"key": t["key"], "v0": t["v0"]}).build())
        pipe.chain(wf.FilterGPU_Builder(lambda t: t["v0"] == t["v0"])
                   .build())
    pipe.add(win_op).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink()
                              .build())
    return g, win_op


def tb_run(label, build, keys, ts, vals, win):
    """One PipeGraph.run() of a TB graph built by ``build(sink_fn)``;
    every window record against the oracle, and no late tuple, evicted
    pane cell or suppressed window.  Returns (records, seconds, NP)."""
    import torch
    cols = []
    g, op = build(lambda c: cols.append(c) if c is not None else None)
    t0 = time.perf_counter()
    g.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nrec = check_tb_records(label, cols, keys, ts, vals, *win)
    st = op.dump_stats()
    counts = [st[k] for k in ("Late_tuples_dropped", "Pane_cells_evicted",
                              "Windows_dropped_on_overflow")]
    if counts != [0, 0, 0]:
        fail(f"TB {label}: late / evicted / dropped {counts}, 0 expected")
    return nrec, secs, op.NP


def tb_runs(dev_name="cuda"):
    """Phase 4: the three time-window runs; returns their launch counts
    by label."""
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    n = CAP * BATCHES
    table, ad, etype, ts_a = ysb_data(n)
    views = etype == 1
    keys_a = table[ad[views]]
    ones = np.ones(int(views.sum()))
    tk, tv, tts = telemetry_data(n)
    rng = np.random.default_rng(6)
    ck = rng.integers(0, TBC_KEYS, n).astype(np.int32)
    cv = rng.integers(-100, 101, n).astype(np.float32)
    cts = np.arange(n, dtype=np.int64) * TBC_GAP
    runs = [
        ("(a) YSB generic", YSB_CAMPAIGNS, YSB_WIN,
         lambda f: ysb_graph(dev_name, False, table, ad, etype, ts_a, f),
         (keys_a, ts_a[views], ones)),
        ("(a) YSB withSumCombiner", YSB_CAMPAIGNS, YSB_WIN,
         lambda f: ysb_graph(dev_name, True, table, ad, etype, ts_a, f),
         (keys_a, ts_a[views], ones)),
        ("(b) telemetry", TELE_KEYS, TELE_WIN,
         lambda f: keyed_tb_graph(dev_name, "chip_smoke_telemetry", tk, tv,
                                  tts, TELE_KEYS, TELE_WIN, f,
                                  lateness=TELE_LATENESS, policy="drop",
                                  normalize=True),
         (tk, tts, tv)),
        ("(c) grouping kernel", TBC_KEYS, TBC_WIN,
         lambda f: keyed_tb_graph(dev_name, "chip_smoke_tbc", ck, cv, cts,
                                  TBC_KEYS, TBC_WIN, f),
         (ck, cts, cv)),
    ]
    out = {}
    for label, K, win, build, (keys, ts, vals) in runs:
        fc.reset_launch_counts()
        nrec, secs, NP = tb_run(label, build, keys, ts, vals, win)
        counts = fc.launch_counts()
        out[label] = counts
        print(f"phase 4: PipeGraph.run() TB {label}: ring NP {NP}, "
              f"K*NP+1 {K * NP + 1} (key, pane) ids; {nrec} windows match "
              f"the oracle, no late, evicted or dropped; {n} tuples in "
              f"{secs:.3f} s = {n / secs:.0f} tuples/s (host clock, "
              f"information only); launches {counts}")
        if label.startswith("(c)"):
            if NP != TBC_NP:
                fail(f"TB (c): ring NP {NP}, {TBC_NP} expected")
            if K * NP + 1 > fc.MAX_BUCKETS:
                fail("TB (c): (key, pane) ids beyond the kernel gate")
            if counts["grouping_rank_hist"] < BATCHES:
                fail(f"TB (c): grouping_rank_hist launched "
                     f"{counts['grouping_rank_hist']} times in {BATCHES} "
                     "steps")
        elif any(v for name, v in counts.items() if name != "cond_select"):
            # radix, scatter and stable-sort placements: no kernel
            fail(f"TB {label} launched a kernel off its path: {counts}")
        # the fold's SWITCH node: three steering launches a step
        if counts["cond_select"] < 3 * BATCHES:
            fail(f"TB {label}: cond_select launched "
                 f"{counts['cond_select']} times in {BATCHES} steps")
    return out


def frame_blob(keys, ts, vals):
    """Binary frames (LE ``int64 key, int64 ts, float64 v0``) of the
    given columns."""
    rec = np.empty(len(keys), dtype=[("k", "<i8"), ("t", "<i8"),
                                     ("v", "<f8")])
    rec["k"], rec["t"], rec["v"] = keys, ts, vals
    return rec.tobytes()


def chunked(blob, step=CHUNK_BYTES):
    """A FrameSource chunk generator over ``blob``: ``step`` bytes a
    chunk, records split across chunks."""
    def gen():
        for lo in range(0, len(blob), step):
            yield blob[lo:lo + step]
    return gen


def cb_tail(pipe, sum_combiner, sink_fn, chain=True):
    """The e2e leg's operators after its source: MapGPU ``v0*1.5+1`` |
    FilterGPU ``(key & 7) != 7`` (chained, or added as a hop of its own
    when not ``chain``) → keyed count windows → columnar Sink
    (``defer=4``)."""
    import windflow_tpu_torch as wf
    pipe.add(wf.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build())
    (pipe.chain if chain else pipe.add)(
        wf.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build())
    wb = (wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
          .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
          .withMaxKeys(KEYS))
    if sum_combiner:
        wb = wb.withSumCombiner()
    pipe.add(wb.build()).add_sink(wf.Sink_Builder(sink_fn)
                                  .withColumnarSink(defer=4).build())


def frames_cb_graph(dev_name, sum_combiner, blob, sink_fn, chain=True,
                    fuse=True, event=False, **cfg):
    """(i): FrameSource over ``blob`` → ``cb_tail``, INGRESS time as
    bench.py's e2e leg, or the frames' own timestamps when ``event``
    (``fuse``: ``Config.whole_chain_fusion``; ``cfg``: further ``Config``
    fields).  Returns ``(graph, source)``."""
    import windflow_tpu_torch as wf
    src = wf.FrameSource(chunked(blob), nv=1, fmt="frames",
                         output_batch_size=CAP,
                         record_spec={"key": np.int32(0),
                                      "v0": np.float32(0.0)})
    g = wf.PipeGraph("chip_smoke_frames", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.EVENT if event else wf.TimePolicy.INGRESS,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      whole_chain_fusion=fuse, **cfg))
    cb_tail(g.add_source(src), sum_combiner, sink_fn, chain=chain)
    return g, src


def device_batch(i, dev):
    """(iii): batch ``i`` of bench.py's device-source leg, born on the
    card: lane-derived keys and values, mixed by the batch index (the
    hash in int64, then narrowed, so it does not wrap in int32)."""
    import torch
    lane = torch.arange(CAP, dtype=torch.int64, device=dev)
    mixed = (lane * 2654435761 + i * 40503) & 0x7FFFFFFF
    return {"key": (mixed % KEYS).to(torch.int32),
            "v0": (mixed % 1024).to(torch.float32) / 1024.0}


def device_batch_numpy(n_batches):
    """The records of ``device_batch`` 0..n_batches-1, in order."""
    lane = np.arange(CAP, dtype=np.int64)
    mixed = np.concatenate([(lane * 2654435761 + i * 40503) & 0x7FFFFFFF
                            for i in range(n_batches)])
    return ((mixed % KEYS).astype(np.int32),
            (mixed % 1024).astype(np.float32) / np.float32(1024.0))


def devsrc_cb_graph(dev_name, sum_combiner, sink_fn):
    """(iii): DeviceSource → ``cb_tail``.  Returns ``(graph, source)``."""
    import torch
    import windflow_tpu_torch as wf
    dev = torch.device(dev_name)
    src = (wf.DeviceSource_Builder(lambda i: device_batch(i, dev))
           .withCapacity(CAP).withNumBatches(COL_BATCHES).build())
    g = wf.PipeGraph("chip_smoke_devsrc", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.INGRESS,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    cb_tail(g.add_source(src), sum_combiner, sink_fn)
    return g, src


def ysb_frames(n, seed=3):
    """(ii): bench.py's YSB records: ad ids over 1,000 ads as the frame
    key, event times spread over ~64 windows, event types uniform over
    {0, 1, 2} as the value; and the seeded ad → campaign table."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, YSB_CAMPAIGNS, YSB_ADS).astype(np.int32)
    ad = rng.integers(0, YSB_ADS, n)
    ts = np.arange(n, dtype=np.int64) * max(1, 64 * YSB_WIN[0] // n)
    etype = rng.integers(0, 3, n)
    return table, ad, ts, etype


def ysb_frames_graph(dev_name, table, blob, sink_fn, sum_combiner=True,
                     chain=True, fuse=True, spec=False, **cfg):
    """(ii) as bench.py builds it: FrameSource (EVENT time) → FilterGPU
    (views) | MapGPU (ad → campaign; added as a hop of its own when not
    ``chain``) → tumbling TB counts keyed by campaign → columnar Sink
    (``spec``: the source declares its record spec, so the wire plane may
    compress its edge; ``cfg``: further ``Config`` fields).  Returns
    ``(graph, source, windows)``."""
    import torch
    import windflow_tpu_torch as wf
    dev_table = torch.from_numpy(table).to(dev_name)
    src = wf.FrameSource(chunked(blob), nv=1, fmt="frames",
                         output_batch_size=CAP,
                         record_spec={"key": np.int32(0),
                                      "v0": np.float32(0.0)}
                         if spec else None)
    win = (wf.Ffat_WindowsGPU_Builder(lambda e: e["one"], lambda a, b: a + b)
           .withTBWindows(*YSB_WIN).withKeyBy(lambda e: e["campaign"])
           .withMaxKeys(YSB_CAMPAIGNS))
    if sum_combiner:
        win = win.withSumCombiner()
    win = win.build()
    g = wf.PipeGraph("chip_smoke_ysb_frames", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.EVENT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      whole_chain_fusion=fuse, **cfg))
    pipe = g.add_source(src)
    pipe.add(wf.FilterGPU_Builder(lambda e: e["v0"] == 1.0).build())
    (pipe.chain if chain else pipe.add)(wf.MapGPU_Builder(
        lambda e: {"campaign": dev_table[e["key"].long()], "one": 1})
        .build())
    pipe.add(win).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink()
                           .build())
    return g, src, win


def check_cb_columns(label, cols, keys, vals, exact=True):
    """A CB run's columnar sink batches against ``oracle`` (after the map
    and filter): the same (key, wid)s, and sums equal (``exact``) or
    within rtol 1e-5."""
    k = np.concatenate([np.asarray(c.cols["key"]) for c in cols])
    w = np.concatenate([np.asarray(c.cols["wid"]) for c in cols])
    v = np.concatenate([np.asarray(c.cols["value"]) for c in cols])
    keep = (keys & 7) != 7
    want = oracle(keys[keep], vals[keep] * np.float32(1.5) + np.float32(1.0))
    got = dict(zip(zip(k.tolist(), w.tolist()), v.tolist()))
    if len(got) != len(k):
        fail(f"{label}: duplicate (key, wid) records")
    if set(got) != set(want):
        fail(f"{label}: {len(got)} windows fired, {len(want)} expected")
    g = np.array([got[x] for x in want])
    e = np.array(list(want.values()))
    if not np.isfinite(g).all():
        fail(f"{label}: non-finite window values")
    bad = np.flatnonzero(g != e) if exact else \
        np.flatnonzero(~np.isclose(g, e, rtol=1e-5, atol=1e-3))
    if len(bad):
        fail(f"{label}: {len(bad)} window sums differ, e.g. "
             f"{list(want)[bad[0]]}: {g[bad[0]]} vs {e[bad[0]]}")
    return len(k)


def collect():
    """A columnar sink function and the list it fills."""
    out = []
    return out, (lambda c: out.append(c) if c is not None else None)


def staged_only_packed(label, src, batches):
    """The FrameSource's staging emitter staged ``batches`` packed
    batches and nothing on the record or chunk routes."""
    em = src.replicas[0].emitter
    got = (em.packed_batches, em.chunked_batches, em.record_batches)
    if got != (batches, 0, 0):
        fail(f"{label}: staged (packed, chunked, record) batches {got}, "
             f"({batches}, 0, 0) expected")


def float_sum_repeats(dev_name):
    """C2 on the card: the declared f32 sums of a CB and a TB graph over
    random float values (4 batches each), each run twice: the same bits,
    and within rtol 1e-5 of the float64 oracle."""
    import torch
    nb = 4
    rng = np.random.default_rng(41)
    n = CAP * nb
    keys = rng.integers(0, KEYS, n)
    vals = rng.standard_normal(n).astype(np.float32)
    blob = frame_blob(keys, np.arange(n), vals)
    outs = []
    for _ in range(2):
        cols, sink = collect()
        g, _ = frames_cb_graph(dev_name, True, blob, sink)
        g.run()
        torch.cuda.synchronize()
        check_cb_columns("C2 CB f32 sum", cols, keys.astype(np.int32), vals,
                         exact=False)
        outs.append(b"".join(np.asarray(c.cols[f]).tobytes()
                             for c in cols for f in ("key", "wid", "value")))
    if outs[0] != outs[1]:
        fail("C2: the CB declared f32 sum differs between two runs")
    tk = rng.integers(0, YSB_CAMPAIGNS, n)
    tts = np.arange(n, dtype=np.int64) * 152
    tv = rng.standard_normal(n).astype(np.float32)
    blob = frame_blob(tk, tts, tv)
    outs = []
    for _ in range(2):
        cols, sink = collect()
        g = keyed_frames_tb_graph(dev_name, blob, sink)
        g.run()
        torch.cuda.synchronize()
        codes, sums = tb_oracle(tk, tts, tv.astype(np.float64), *YSB_WIN)
        k = np.concatenate([np.asarray(c.cols["key"]) for c in cols])
        w = np.concatenate([np.asarray(c.cols["wid"]) for c in cols])
        v = np.concatenate([np.asarray(c.cols["value"]) for c in cols])
        got = k.astype(np.int64) * tb_wids(tts, YSB_WIN[1]) + w
        order = np.argsort(got, kind="stable")
        if not np.array_equal(got[order], codes) or not np.allclose(
                v[order], sums, rtol=1e-5, atol=1e-3):
            fail("C2: the TB declared f32 sum disagrees with its oracle")
        outs.append(k.tobytes() + w.tobytes() + v.tobytes())
    if outs[0] != outs[1]:
        fail("C2: the TB declared f32 sum differs between two runs")
    print(f"phase 5: C2 declared f32 sums repeat bit for bit: CB "
          f"{n} tuples, TB {n} tuples, within rtol 1e-5 of float64")


def keyed_frames_tb_graph(dev_name, blob, sink_fn):
    """FrameSource (EVENT time) → 10 s tumbling TB windows summing v0,
    ``withSumCombiner``, keyed by the frame key (100 keys) → columnar
    Sink.  Returns the graph."""
    import windflow_tpu_torch as wf
    g = wf.PipeGraph("chip_smoke_tb_f32", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.EVENT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    g.add_source(wf.FrameSource(chunked(blob), nv=1,
                                output_batch_size=CAP)) \
        .add(wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
             .withTBWindows(*YSB_WIN).withKeyBy(lambda t: t["key"])
             .withMaxKeys(YSB_CAMPAIGNS).withSumCombiner().build()) \
        .add_sink(wf.Sink_Builder(sink_fn).withColumnarSink().build())
    return g


def columnar_runs(dev_name="cuda"):
    """Phase 5: runs (i)-(iii) against their oracles; returns their
    launch counts by label."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    n = CAP * COL_BATCHES
    rng = np.random.default_rng(2025)
    keys = rng.integers(0, KEYS, n)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    blob_i = frame_blob(keys, np.arange(n), vals)
    keys32 = keys.astype(np.int32)
    dk, dv = device_batch_numpy(COL_BATCHES)
    table, ad, ts_y, etype = ysb_frames(n)
    blob_ii = frame_blob(ad, ts_y, etype.astype(np.float64))
    views = etype == 1
    out = {}
    for label, kind, sum_comb in (
            ("(i) frames generic", "frames", False),
            ("(i) frames sum", "frames", True),
            ("(iii) device source generic", "device", False),
            ("(iii) device source sum", "device", True),
            ("(ii) YSB frames sum", "ysb", True)):
        cols, sink = collect()
        if kind == "frames":
            g, src = frames_cb_graph(dev_name, sum_comb, blob_i, sink)
        elif kind == "device":
            g, src = devsrc_cb_graph(dev_name, sum_comb, sink)
        else:
            g, src, win = ysb_frames_graph(dev_name, table, blob_ii, sink)
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        g.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = fc.launch_counts()
        out[label] = counts
        if kind == "ysb":
            nrec = check_tb_records(label, cols, table[ad[views]],
                                    ts_y[views], np.ones(int(views.sum())),
                                    *YSB_WIN)
            st = win.dump_stats()
            bad = [st[k] for k in ("Late_tuples_dropped",
                                   "Pane_cells_evicted",
                                   "Windows_dropped_on_overflow")]
            if bad != [0, 0, 0]:
                fail(f"{label}: late / evicted / dropped {bad}")
            if any(v for name, v in counts.items()
                   if name != "cond_select") \
                    or counts["cond_select"] < 3 * COL_BATCHES:
                # K*NP+1 (key, pane) ids beyond the kernel gate: the
                # sort; the fold's SWITCH node steered three times a step
                fail(f"{label} launched a kernel off its path, or the "
                     f"fold's steering kernel too rarely: {counts}")
            extra = f"; ring NP {win.NP}"
        else:
            nrec = check_cb_columns(label, cols,
                                    keys32 if kind == "frames" else dk,
                                    vals if kind == "frames" else dv)
            need = ("grouping_rank_hist", "sliding_fold") if sum_comb \
                else ("grouping_rank_hist",)
            for name in need:
                if counts[name] <= 0:
                    fail(f"{label} never launched {name}")
            if sum_comb and counts["sliding_fold"] != COL_BATCHES:
                fail(f"{label} launched sliding_fold "
                     f"{counts['sliding_fold']} times in {COL_BATCHES} steps")
            extra = ""
        if kind != "device":
            staged_only_packed(label, src, COL_BATCHES)
            extra += f"; {COL_BATCHES} packed batches, no record batch"
        print(f"phase 5: PipeGraph.run() {label}: {nrec} windows match the "
              f"oracle; {n} tuples in {secs:.3f} s = {n / secs:.0f} "
              f"tuples/s (host clock, information only); launches "
              f"{counts}{extra}")
    float_sum_repeats(dev_name)
    return out


# ---------------------------------------------------------------------------
# phase 6: fusion, keyed routing, split and merge
# ---------------------------------------------------------------------------

def step_probe(ops):
    """Wrap each operator's per-batch step: ``{name: [steps, host
    seconds]}`` (the host clock around the call, no synchronise: the time
    to enqueue the hop's device work)."""
    probe = {}
    for op in ops:
        rec = probe.setdefault(op.name, [0, 0.0])
        orig = op._step

        def step(batch, *args, _orig=orig, _rec=rec):
            t0 = time.perf_counter()
            out = _orig(batch, *args)
            _rec[1] += time.perf_counter() - t0
            _rec[0] += 1
            return out
        op._step = step
    return probe


def frames_reduce_graph(dev_name, blob, sink_fn, fuse):
    """Phase 3 (a)'s reduce fed by FrameSource: MapGPU ``v0*1.5+1`` →
    FilterGPU ``(key & 7) != 7`` (added, not chained) → ReduceGPU keyed,
    ``withMaxKeys(1024)``, declared max (the bounded compacted route) →
    columnar Sink.  Returns ``(graph, [map, filter, reduce])``."""
    import torch
    import windflow_tpu_torch as wf
    m = wf.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build()
    f = wf.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build()
    red = (wf.ReduceGPU_Builder(
        lambda a, b: {"key": torch.maximum(a["key"], b["key"]),
                      "v0": torch.maximum(a["v0"], b["v0"])})
        .withKeyBy(lambda t: t["key"]).withMaxKeys(KEYS)
        .withMonoidCombiner("max").build())
    g = wf.PipeGraph("chip_smoke_fused_reduce", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      whole_chain_fusion=fuse))
    pipe = g.add_source(wf.FrameSource(chunked(blob), nv=1,
                                       output_batch_size=CAP))
    pipe.add(m).add(f).add(red).add_sink(
        wf.Sink_Builder(sink_fn).withColumnarSink().build())
    return g, [m, f, red]


def batch_records(cols):
    """A columnar run's output as sorted rows of (key field, value)
    arrays, one row a record."""
    k = np.concatenate([np.asarray(c.cols["key"]) for c in cols])
    v = np.concatenate([np.asarray(c.cols["v0"] if "v0" in c.cols
                                   else c.cols["value"]) for c in cols])
    extra = [np.concatenate([np.asarray(c.cols["wid"]) for c in cols])] \
        if "wid" in cols[0].cols else []
    rows = np.stack([k.astype(np.float64)] + [e.astype(np.float64)
                                              for e in extra]
                    + [v.astype(np.float64)], 1)
    return rows[np.lexsort(rows.T[::-1])]


def fusion_runs(dev_name, blob_i, keys, vals, blob_ii, table, ad, ts_y,
                views):
    """6 (a): three graphs built with ``.add(map).add(filter)``, each run
    fused and unfused in this process: records identical to each other
    and to the oracle; fused, the Map and Filter replicas run no step and
    the tail runs one step a batch.  Returns launch counts by label."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    n = CAP * COL_BATCHES
    out = {}
    for kind in ("cb generic", "cb sum", "ysb sum", "reduce max"):
        recs = {}
        for fuse in (False, True):
            cols, sink = collect()
            if kind.startswith("cb"):
                g, _ = frames_cb_graph(dev_name, kind == "cb sum", blob_i,
                                       sink, chain=False, fuse=fuse)
                ops = g.pipes[0].operators[1:4]
            elif kind == "ysb sum":
                g, _, win = ysb_frames_graph(dev_name, table, blob_ii, sink,
                                             chain=False, fuse=fuse)
                ops = g.pipes[0].operators[1:4]
            else:
                g, ops = frames_reduce_graph(dev_name, blob_i, sink, fuse)
            probe = step_probe(ops)
            fc.reset_launch_counts()
            t0 = time.perf_counter()
            g.run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = fc.launch_counts()
            label = f"6(a) {kind} {'fused' if fuse else 'unfused'}"
            out[label] = counts
            segs = [sg["name"] for sg in g._fused_segments]
            steps = {nm: st[0] for nm, st in probe.items()}
            tail = ops[2].name
            # batches the megastep plane ran in groups (Config's "auto"
            # K = 8 on the card) are tail steps too, made inside a replay
            folded = sum(e["batches"] for e in
                         g.stats()["Megastep"]["edges"])
            if fuse:
                if segs != ["|".join(op.name for op in ops)]:
                    fail(f"{label}: fused segments {segs}")
                steps[tail] += folded
                if steps != {ops[0].name: 0, ops[1].name: 0,
                             tail: COL_BATCHES}:
                    fail(f"{label}: steps {steps}, {COL_BATCHES} tail "
                         "steps and none on the members expected")
            elif segs or set(steps.values()) != {COL_BATCHES}:
                fail(f"{label}: segments {segs}, steps {steps}")
            if kind.startswith("cb"):
                nrec = check_cb_columns(label, cols, keys, vals)
            elif kind == "ysb sum":
                nrec = check_tb_records(label, cols, table[ad[views]],
                                        ts_y[views],
                                        np.ones(int(views.sum())), *YSB_WIN)
            else:
                nrec = 0
                for i, c in enumerate(cols):
                    sl = slice(i * CAP, (i + 1) * CAP)
                    wk, wv = reduce_oracle(keys[sl], vals[sl], "max")
                    if not (np.array_equal(np.asarray(c.cols["key"]), wk)
                            and np.array_equal(np.asarray(c.cols["v0"]),
                                               wv)):
                        fail(f"{label}: batch {i} differs from the oracle")
                    nrec += len(wk)
                if len(cols) != COL_BATCHES:
                    fail(f"{label}: {len(cols)} sink batches")
            if not counts["grouping_rank_hist" if kind.startswith("cb")
                          else "dense_monoid_table"] \
                    and kind != "ysb sum":
                fail(f"{label}: its kernel never launched: {counts}")
            recs[fuse] = batch_records(cols)
            wall = sum(st[1] for st in probe.values()) / max(
                1, sum(steps.values()) - folded)
            print(f"phase 6 (a): PipeGraph.run() {label}: {nrec} records "
                  f"match the oracle; segments {segs}; steps {steps}; "
                  f"{n} tuples in {secs:.3f} s = {n / secs:.0f} tuples/s; "
                  f"step wall {wall * 1e3:.3f} ms a per-batch step (host "
                  "clock around the hop's steps, no synchronise; "
                  f"{folded} batches ran in megastep groups; information "
                  f"only); launches {counts}")
        if not np.array_equal(recs[False], recs[True]):
            fail(f"6(a) {kind}: fused records differ from unfused")
    return out


def merged_source(i, dev, seed):
    """6 (b): batch ``i`` of a DeviceSource born on the card: lane- and
    seed-mixed keys in [0, KEYS), integer values in [-100, 100]."""
    import torch
    lane = torch.arange(CAP, dtype=torch.int64, device=dev)
    mixed = (lane * 2654435761 + i * 40503 + seed * 7919) & 0x7FFFFFFF
    return {"key": (mixed % KEYS).to(torch.int32),
            "v0": ((mixed >> 10) % 201 - 100).to(torch.float32),
            "n": torch.ones(CAP, dtype=torch.int32, device=dev)}


def merged_source_numpy(n_batches, seed):
    lane = np.arange(CAP, dtype=np.int64)
    mixed = np.concatenate([(lane * 2654435761 + i * 40503 + seed * 7919)
                            & 0x7FFFFFFF for i in range(n_batches)])
    return (mixed % KEYS).astype(np.int32), \
        ((mixed >> 10) % 201 - 100).astype(np.float32)


def merge_runs(dev_name):
    """6 (b): two DeviceSources (seeds 1 and 2, COL_BATCHES / 2 batches
    each) merged → MapGPU → ReduceGPU keyed at parallelism 4,
    ``withMaxKeys(1024)``, declared max and then declared sum → columnar
    Sink (merge_tests_gpu's shape)."""
    import torch
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    dev = torch.device(dev_name)
    nb = COL_BATCHES // 2
    ks, vs = zip(*(merged_source_numpy(nb, s) for s in (1, 2)))
    keys, vals = np.concatenate(ks), np.concatenate(vs)
    v2 = vals.astype(np.float64) * 2 + 1
    out = {}
    for monoid in ("max", "sum"):
        op = {"max": torch.maximum, "sum": torch.add}[monoid]
        cols, sink = collect()
        g = wf.PipeGraph("chip_smoke_merge", wf.ExecutionMode.DEFAULT,
                         config=wf.Config(device=dev_name,
                                          punctuation_interval_usec=10 ** 12))
        pipes = [g.add_source(
            wf.DeviceSource_Builder(lambda i, _s=s: merged_source(i, dev, _s))
            .withCapacity(CAP).withNumBatches(nb).withName(f"src{s}")
            .build()) for s in (1, 2)]
        merged = pipes[0].merge(pipes[1])
        merged.add(wf.MapGPU_Builder(
            lambda t: {"key": t["key"], "v0": t["v0"] * 2.0 + 1.0,
                       "n": t["n"]}).build())
        red = (wf.ReduceGPU_Builder(lambda a, b: {
            k: op(a[k], b[k]) for k in ("key", "v0", "n")})
            .withKeyBy(lambda t: t["key"]).withMaxKeys(KEYS)
            .withMonoidCombiner(monoid).withParallelism(4).build())
        merged.add(red).add_sink(wf.Sink_Builder(sink).withColumnarSink()
                                 .build())
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        g.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = fc.launch_counts()
        label = f"6(b) merge reduce {monoid}"
        out[label] = counts
        k = np.concatenate([np.asarray(c.cols["key"]) for c in cols])
        v = np.concatenate([np.asarray(c.cols["v0"]) for c in cols])
        cnt = np.concatenate([np.asarray(c.cols["n"]) for c in cols])
        if monoid == "max":
            want = np.full(KEYS, -np.inf)
            np.maximum.at(want, keys, v2)
            got = np.full(KEYS, -np.inf)
            np.maximum.at(got, k, v.astype(np.float64))
        else:
            # a declared sum sums the key field too: key = field / n
            if np.any(k % cnt):
                fail(f"{label}: key fields not multiples of the counts")
            k = k // cnt
            want = np.bincount(keys, weights=v2, minlength=KEYS)
            got = np.bincount(k, weights=v.astype(np.float64),
                              minlength=KEYS)
            if not np.array_equal(np.bincount(k, weights=cnt,
                                              minlength=KEYS),
                                  np.bincount(keys, minlength=KEYS)):
                fail(f"{label}: per-key tuple counts differ")
        if not np.array_equal(got, want):
            fail(f"{label}: per-key {monoid} differs from the oracle over "
                 f"both streams ({int((got != want).sum())} keys)")
        steps = [r.stats.device_programs_launched for r in red.replicas]
        if min(steps) <= 0:
            fail(f"{label}: a replica received no batch: {steps}")
        if counts["dense_monoid_table"] < sum(steps):
            fail(f"{label}: {counts['dense_monoid_table']} table launches "
                 f"for {sum(steps)} replica steps")
        print(f"phase 6 (b): PipeGraph.run() {label}: per-key {monoid} of "
              f"{len(k)} records over {len(cols)} batches equals the "
              f"oracle over both streams; replica steps {steps}; "
              f"{len(keys)} tuples in {secs:.3f} s = {len(keys) / secs:.0f}"
              f" tuples/s (information only); launches {counts}")
    return out


def split_run(dev_name, blob_i, keys, vals):
    """6 (c): FrameSource → MapGPU → split by ``key & 1`` (split_tests_gpu's
    shape).  Branch 0: keyed CB windows, ``withSumCombiner``, parallelism
    2 behind the device keyby; branch 1: FilterGPU → keyed ReduceGPU,
    ``withMaxKeys(1024)``, declared sum.  Each against its oracle; the
    split takes the mask route."""
    import torch
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.parallel.emitters import (DeviceKeyByEmitter,
                                                      SplittingEmitter)
    cols0, sink0 = collect()
    cols1, sink1 = collect()
    src = wf.FrameSource(chunked(blob_i), nv=1, output_batch_size=CAP)
    g = wf.PipeGraph("chip_smoke_split", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    p = g.add_source(src)
    p.add(wf.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build())
    p.split(lambda t: t["key"] & 1, 2)
    win = (wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
           .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
           .withMaxKeys(KEYS).withSumCombiner().withParallelism(2).build())
    p.select(0).add(win).add_sink(wf.Sink_Builder(sink0)
                                  .withColumnarSink().build())
    red = (wf.ReduceGPU_Builder(lambda a, b: {"key": a["key"] + b["key"],
                                              "v0": a["v0"] + b["v0"]})
           .withKeyBy(lambda t: t["key"]).withMaxKeys(KEYS)
           .withSumCombiner().build())
    p.select(1).add(wf.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7)
                    .build()).add(red) \
        .add_sink(wf.Sink_Builder(sink1).withColumnarSink().build())
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    g.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = fc.launch_counts()
    em = g.pipes[0].operators[1].replicas[0].emitter
    if not isinstance(em, SplittingEmitter) \
            or list(em._device_split.values()) != [True] \
            or not isinstance(em.branches[0], DeviceKeyByEmitter):
        fail("6(c): the split did not take the mask route into the device "
             "keyby")
    # branch 0: every CB window of the even keys (no filter on it)
    v15 = vals * np.float32(1.5) + np.float32(1.0)
    even = (keys & 1) == 0
    want = oracle(keys[even], v15[even])
    k = np.concatenate([np.asarray(c.cols["key"]) for c in cols0])
    w = np.concatenate([np.asarray(c.cols["wid"]) for c in cols0])
    v = np.concatenate([np.asarray(c.cols["value"]) for c in cols0])
    got = dict(zip(zip(k.tolist(), w.tolist()), v.tolist()))
    if len(got) != len(k) or got != want:
        fail(f"6(c) branch 0: {len(got)} windows vs {len(want)} expected, "
             "or sums differ")
    steps = [r.stats.device_programs_launched for r in win.replicas]
    if min(steps) < COL_BATCHES:
        fail(f"6(c) branch 0: replica steps {steps}")
    # branch 1: each batch's odd keys, filtered, reduced
    if len(cols1) != COL_BATCHES:
        fail(f"6(c) branch 1: {len(cols1)} sink batches")
    for i, c in enumerate(cols1):
        sl = slice(i * CAP, (i + 1) * CAP)
        odd = (keys[sl] & 1) == 1
        wk, wv = reduce_oracle(keys[sl][odd], vals[sl][odd], "sum")
        if not (np.array_equal(np.asarray(c.cols["key"]), wk)
                and np.array_equal(np.asarray(c.cols["v0"]), wv)):
            fail(f"6(c) branch 1: batch {i} differs from the oracle")
    for name in ("grouping_rank_hist", "sliding_fold", "dense_monoid_table"):
        if counts[name] <= 0:
            fail(f"6(c): {name} never launched")
    if counts["sliding_fold"] < 2 * COL_BATCHES:
        fail(f"6(c): sliding_fold launched {counts['sliding_fold']} times "
             f"for {2 * COL_BATCHES} replica steps")
    print(f"phase 6 (c): PipeGraph.run() split: branch 0 {len(k)} windows "
          f"(parallelism 2, replica steps {steps}) and branch 1 "
          f"{len(cols1)} batches match their oracles; mask split, no "
          f"record crossed to the host; {len(keys)} tuples in {secs:.3f} s "
          f"(information only); launches {counts}")
    return {"6(c) split": counts}


def keyed_staging_run(dev_name, blob_i, keys, vals):
    """6 (d): FrameSource → ReduceGPU keyed at parallelism 2 (declared
    max, ``withMaxKeys(1024)``) through
    ``KeyedDeviceStageEmitter.emit_columns``: every batch stages packed,
    and each output batch equals the oracle of the rows its partition
    staged (splitmix64 placement, CAP rows a batch)."""
    import torch
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.parallel.emitters import (
        KeyedDeviceStageEmitter, splitmix64_np)
    cols, sink = collect()
    src = wf.FrameSource(chunked(blob_i), nv=1, output_batch_size=CAP)
    red = (wf.ReduceGPU_Builder(
        lambda a, b: {"key": torch.maximum(a["key"], b["key"]),
                      "v0": torch.maximum(a["v0"], b["v0"])})
        .withKeyBy(lambda t: t["key"]).withMaxKeys(KEYS)
        .withMonoidCombiner("max").withParallelism(2).build())
    g = wf.PipeGraph("chip_smoke_keyed_staging", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    g.add_source(src).add(red).add_sink(wf.Sink_Builder(sink)
                                        .withColumnarSink().build())
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    g.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = fc.launch_counts()
    em = src.replicas[0].emitter
    if not isinstance(em, KeyedDeviceStageEmitter):
        fail("6(d): the source's edge is not the keyed staging emitter")
    dest = (splitmix64_np(keys) % np.uint64(2)).astype(np.int64)
    n_batches = sum(-(-int((dest == d).sum()) // CAP) for d in range(2))
    got = (em.packed_batches, em.chunked_batches, em.record_batches)
    if got != (n_batches, 0, 0):
        fail(f"6(d): staged (packed, chunked, record) {got}, "
             f"({n_batches}, 0, 0) expected")
    want = []
    for d in range(2):
        idx = np.flatnonzero(dest == d)
        for lo in range(0, len(idx), CAP):
            sel = idx[lo:lo + CAP]
            uk, inv = np.unique(keys[sel], return_inverse=True)
            mx = np.full(len(uk), -np.inf, np.float32)
            np.maximum.at(mx, inv, vals[sel])
            want.append((uk.tolist(), mx.tolist()))
    have = [(np.asarray(c.cols["key"]).tolist(),
             np.asarray(c.cols["v0"]).tolist()) for c in cols]
    if sorted(have) != sorted(want):
        fail(f"6(d): {len(have)} output batches vs {len(want)} expected, "
             "or records differ")
    if counts["dense_monoid_table"] < n_batches:
        fail(f"6(d): table launched {counts['dense_monoid_table']} times")
    print(f"phase 6 (d): PipeGraph.run() keyed staging: {n_batches} packed "
          f"batches over 2 partitions, every output batch equals its "
          f"oracle; {len(keys)} tuples in {secs:.3f} s (information "
          f"only); launches {counts}")
    return {"6(d) keyed staging": counts}


def placement_check(dev):
    """6 (e): ``place_torch`` on the card equals ``splitmix64_int`` on the
    host for n in {2, 3, 4, 7}, over the int32 edges and 262,144 random
    keys."""
    import torch
    from windflow_tpu_torch.parallel.emitters import (place_torch,
                                                      splitmix64_int)
    rng = np.random.default_rng(77)
    ranges = [np.arange(-2 ** 31, -2 ** 31 + 4096),
              np.arange(-4096, 4096), np.arange(2 ** 31 - 4096, 2 ** 31),
              rng.integers(-2 ** 31, 2 ** 31, CAP)]
    keys = np.concatenate(ranges).astype(np.int32)
    host = np.array([splitmix64_int(int(k)) for k in keys.tolist()],
                    dtype=np.uint64)
    lane = torch.from_numpy(keys).to(dev)
    for n in (2, 3, 4, 7):
        got = place_torch(lane, n).cpu().numpy()
        if not np.array_equal(got, (host % np.uint64(n)).astype(np.int64)):
            fail(f"6(e): device placement mod {n} differs from the host's")
    print(f"phase 6 (e): splitmix64 placement on the card equals the "
          f"host's for n in (2, 3, 4, 7) over {len(keys)} keys (int32 "
          "edges, -1 and 0, random)")


def entry_check():
    """6 (f): the port's ``entry()`` step on the card equals the same step
    on the CPU, ten steps from the zero state."""
    from windflow_tpu_torch.entry import entry
    gstep, gargs = entry(device="cuda")
    cstep, cargs = entry(device="cpu")
    gst, cst = gargs[0], cargs[0]
    fired_total = 0
    for _ in range(10):
        gst, gout, gfired, gts = gstep(gst, *gargs[1:])
        cst, cout, cfired, cts = cstep(cst, *cargs[1:])
        f = cfired.numpy()
        if not np.array_equal(gfired.cpu().numpy(), f):
            fail("6(f): entry() fired masks differ between card and CPU")
        for name in ("key", "wid", "value"):
            if not np.array_equal(gout[name].cpu().numpy()[f],
                                  cout[name].numpy()[f]):
                fail(f"6(f): entry() fired {name} differs, card vs CPU")
        if not np.array_equal(gts.cpu().numpy()[f], cts.numpy()[f]):
            fail("6(f): entry() fired timestamps differ, card vs CPU")
        fired_total += int(f.sum())
    if fired_total == 0:
        fail("6(f): entry() fired no window in ten steps")
    print(f"phase 6 (f): entry() step on the card equals the CPU's: ten "
          f"steps, {fired_total} fired windows, bit for bit")


def routing_runs(dev_name="cuda"):
    """Phase 6: every run above; returns launch counts by label."""
    import torch
    n = CAP * COL_BATCHES
    rng = np.random.default_rng(2025)
    keys = rng.integers(0, KEYS, n)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    blob_i = frame_blob(keys, np.arange(n), vals)
    table, ad, ts_y, etype = ysb_frames(n)
    blob_ii = frame_blob(ad, ts_y, etype.astype(np.float64))
    keys32 = keys.astype(np.int32)
    out = fusion_runs(dev_name, blob_i, keys32, vals, blob_ii, table, ad,
                      ts_y, etype == 1)
    out.update(merge_runs(dev_name))
    out.update(split_run(dev_name, blob_i, keys32, vals))
    out.update(keyed_staging_run(dev_name, blob_i, keys32, vals))
    placement_check(torch.device(dev_name))
    entry_check()
    return out


# ---------------------------------------------------------------------------
# phase 7: stateful operators and key compaction
# ---------------------------------------------------------------------------

#: fraud detection: cards, transaction types, flag threshold
FRAUD_CARDS, FRAUD_TYPES, FRAUD_THRESHOLD = 16384, 8, 0.05
#: (d): the key space the Zipf draws map into, the exponent, the reseed
#: cadence (batches) and the batch at which the key ranking changes
ZIPF_KEYS, ZIPF_S, KC_RESEED, KC_SHIFT = 1 << 20, 1.1, 4, 8
#: (e): distinct random int32 window keys
FFAT_IDS = 1000


def zipf_draws(rng, n, k, s=ZIPF_S):
    """``n`` ranks in [0, k) drawn with probability proportional to
    ``(rank + 1) ** -s``."""
    p = np.arange(1, k + 1, dtype=np.float64) ** -s
    return rng.choice(k, n, p=p / p.sum())


def fraud_oracle(keys, etype, table):
    """Every transaction's Markov score in arrival order: the transition
    probability from the card's previous type, 1.0 for a first one."""
    order = np.argsort(keys, kind="stable")
    sk, se = keys[order], etype[order]
    prev_s = np.r_[-1, se[:-1]]
    prev_s[np.r_[True, sk[1:] != sk[:-1]]] = -1
    prev = np.empty_like(prev_s)
    prev[order] = prev_s
    score = np.where(prev < 0, np.float32(1.0),
                     table[np.clip(prev, 0, None), etype])
    return score.astype(np.float32)


def fraud_graph(dev_name, blob, transition, sink_fn, dense=True,
                key_compaction=True, fuse=True, **cfg):
    """Fraud detection (``windflow_tpu_torch/models/fraud_detection.py``)
    on frames of (card, ts, transaction type).  ``dense``: FrameSource →
    MapGPU ``cast`` (card, type to int32) → the model's stateful scorer
    (dense card ids) → its flag filter → columnar Sink; else the scorer
    keys arbitrary card ids straight from the staging (host-fed: the
    compacted route under ``key_compaction``, else interning).  Returns
    ``(graph, scorer)``."""
    import torch
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.models.fraud_detection import scoring_ops
    fields = ({"card": "card", "etype": "etype"} if dense
              else {"card": "key", "etype": "v0"})
    scorer, flag = scoring_ops(transition, torch.device(dev_name),
                               max_cards=FRAUD_CARDS,
                               threshold=FRAUD_THRESHOLD, dense=dense,
                               **fields)
    g = wf.PipeGraph("chip_smoke_fraud", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      key_compaction=key_compaction,
                                      whole_chain_fusion=fuse, **cfg))
    pipe = g.add_source(wf.FrameSource(chunked(blob), nv=1,
                                       output_batch_size=CAP))
    if dense:
        pipe.add(wf.MapGPU_Builder(
            lambda t: {"card": t["key"].to(torch.int32),
                       "etype": t["v0"].to(torch.int32)})
            .withName("cast").build())
    pipe.add(scorer)
    pipe.chain(flag)
    pipe.add_sink(wf.Sink_Builder(sink_fn).withColumnarSink(defer=4)
                  .build())
    return g, scorer


def assoc_graph(dev_name, blob, sink_fn, **cfg):
    """(c): FrameSource → stateful MapGPU with ``withAssociativeUpdate``
    (dense keys, 16,384 slots): per key the running count and the running
    sum of v0, projected onto each record → columnar Sink.  Returns
    ``(graph, operator)``."""
    import torch
    import windflow_tpu_torch as wf
    op = (wf.MapGPU_Builder(lambda t, s: (t, s)).withName("running")
          .withKeyBy(lambda t: t["key"])
          .withInitialState({"n": np.int32(0), "sum": np.float32(0.0)})
          .withNumKeySlots(FRAUD_CARDS).withDenseKeys()
          .withAssociativeUpdate(
              lift=lambda t: {"n": torch.ones_like(t["key"]),
                              "sum": t["v0"]},
              comb=lambda a, b: {"n": a["n"] + b["n"],
                                 "sum": a["sum"] + b["sum"]},
              project=lambda t, s: {"key": t["key"], "n": s["n"],
                                    "sum": s["sum"]})
          .build())
    g = wf.PipeGraph("chip_smoke_assoc", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      **cfg))
    g.add_source(wf.FrameSource(chunked(blob), nv=1, output_batch_size=CAP)) \
        .add(op).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink(defer=4)
                          .build())
    return g, op


def kc_reduce_graph(dev_name, monoid, blob, sink_fn, **cfg):
    """(d): FrameSource → ReduceGPU keyed, the leafwise ``monoid``
    combiner declared, no ``withMaxKeys`` (the unbounded compacted route:
    a compactor of ``Config.key_compaction_slots`` = 1,024 slots, reseeded
    every ``KC_RESEED`` batches) → columnar Sink (``cfg``: further
    ``Config`` fields).  Returns ``(graph, reduce operator)``."""
    import torch
    import windflow_tpu_torch as wf
    op = {"max": torch.maximum, "sum": torch.add}[monoid]
    red = (wf.ReduceGPU_Builder(lambda a, b: {"key": op(a["key"], b["key"]),
                                              "v0": op(a["v0"], b["v0"])})
           .withKeyBy(lambda t: t["key"]).withMonoidCombiner(monoid)
           .withName("kc_reduce").build())
    g = wf.PipeGraph("chip_smoke_kc_reduce", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      key_compaction_reseed=KC_RESEED,
                                      **cfg))
    g.add_source(wf.FrameSource(chunked(blob), nv=1, output_batch_size=CAP)) \
        .add(red).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink()
                           .build())
    return g, red


def kc_ffat_graph(dev_name, sum_combiner, blob, sink_fn):
    """(e): FrameSource → keyed count windows (1,024 sliding by 128) over
    arbitrary int32 keys, ``withCompactedKeys()`` in place of
    ``withMaxKeys`` → columnar Sink.  The windows are fed by the staging
    itself: a window behind a device stage sees no host admission.
    Returns ``(graph, windows operator)``."""
    import windflow_tpu_torch as wf
    wb = (wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
          .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
          .withCompactedKeys().withName("kc_windows"))
    if sum_combiner:
        wb = wb.withSumCombiner()
    win = wb.build()
    g = wf.PipeGraph("chip_smoke_kc_ffat", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    g.add_source(wf.FrameSource(chunked(blob), nv=1, output_batch_size=CAP)) \
        .add(win).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink(defer=4)
                           .build())
    return g, win


def sync_probe(op, depth=False):
    """Wrap ``op``'s step: ``[steps, seconds, depths]`` with the host
    clock around the step between two synchronises (the step's wall on
    the card), and the wavefront depth of each step."""
    import torch
    rec = [0, 0.0, []]
    orig = op._step

    def step(batch, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(batch, *args)
        torch.cuda.synchronize()
        rec[1] += time.perf_counter() - t0
        rec[0] += 1
        if depth:
            rec[2].append(op.last_depth)
        return out
    op._step = step
    return rec


def timed_run(g):
    """``g.run()`` on the host clock, to a synchronise; with the launch
    counts reset just before and read just after."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    g.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, fc.launch_counts()


def cat_cols(cols, name):
    return np.concatenate([np.asarray(c.cols[name]) for c in cols])


def check_fraud(label, cols, keys, etype, table, score=None):
    """The flagged records, in arrival order, against the oracle (its
    scores ``score`` when the caller computed them once)."""
    if score is None:
        score = fraud_oracle(keys, etype, table)
    flag = score < np.float32(FRAUD_THRESHOLD)
    got = (cat_cols(cols, "card").astype(np.int64),
           cat_cols(cols, "etype").astype(np.int64), cat_cols(cols, "score"))
    want = (keys[flag].astype(np.int64), etype[flag].astype(np.int64),
            score[flag])
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        fail(f"{label}: {len(got[0])} flagged records, {len(want[0])} "
             "expected, or they differ")
    return len(got[0])


def running_oracle(keys, vals):
    """Per lane, in arrival order: the key's running count and running
    sum (float64; exact for the small integer values)."""
    n = len(keys)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    start = np.maximum.accumulate(np.where(
        np.r_[True, sk[1:] != sk[:-1]], np.arange(n), 0))
    cnt = np.empty(n, np.int64)
    cnt[order] = np.arange(n) - start + 1
    cs = np.cumsum(vals[order].astype(np.float64))
    run_sum = np.empty(n)
    run_sum[order] = cs - np.r_[0.0, cs][start]
    return cnt, run_sum


def batch_reduce_oracle(keys, vals, monoid):
    """One batch's records of the plain keyed reduce, ascending keys; a
    summed key field is key * count (int32 arithmetic)."""
    uk, inv = np.unique(keys, return_inverse=True)
    if monoid == "max":
        wv = np.full(len(uk), -np.inf, np.float32)
        np.maximum.at(wv, inv, vals)
        return uk, wv
    wv = np.zeros(len(uk))
    np.add.at(wv, inv, vals.astype(np.float64))
    wk = (uk.astype(np.int64) * np.bincount(inv, minlength=len(uk)))
    return wk.astype(np.int32), wv.astype(np.float32)


def fraud_data(rng, n):
    """(a)'s cards and types, (b)'s card ids and the transition table."""
    table = rng.dirichlet(np.ones(FRAUD_TYPES), FRAUD_TYPES) \
        .astype(np.float32)
    cards = rng.integers(0, FRAUD_CARDS, n)
    etype = rng.integers(0, FRAUD_TYPES, n)
    ids = rng.choice(2 ** 31 - 1, FRAUD_CARDS, replace=False)
    return table, cards, etype, ids[cards].astype(np.int32)


def zipf_shift_keys(rng, n):
    """(d)'s keys: Zipf ranks over ZIPF_KEYS ids, the rank -> id map
    changing at batch KC_SHIFT."""
    ranks = zipf_draws(rng, n, ZIPF_KEYS)
    perms = (rng.permutation(ZIPF_KEYS), rng.permutation(ZIPF_KEYS))
    return np.where(np.arange(n) < KC_SHIFT * CAP, perms[0][ranks],
                    perms[1][ranks]).astype(np.int32)


def stateful_runs(dev_name="cuda"):
    """Phase 7: (a) fraud detection with dense card ids, fused and
    unfused; (b) arbitrary card ids, compacted and interned; (c) the
    associative running count and sum on a uniform and a Zipf stream;
    (d) the unbounded compacted reduce, max and sum, on a Zipf stream
    whose ranking changes mid-run; (e) compacted window keys, both
    combiners.  Each run against its numpy oracle; returns the launch
    counts by label."""
    n = CAP * COL_BATCHES
    rng = np.random.default_rng(2026)
    out = {}

    # (a) and (b): fraud detection
    table, cards, etype, card_ids = fraud_data(rng, n)
    blob_a = frame_blob(cards, np.arange(n), etype.astype(np.float64))
    flagged = {}
    for fuse in (False, True):
        label = f"7(a) fraud dense {'fused' if fuse else 'unfused'}"
        cols, sink = collect()
        # K = 1: every batch a scorer step (phase 17 runs K = 8)
        g, scorer = fraud_graph(dev_name, blob_a, table, sink, fuse=fuse,
                                megastep_sweeps=1)
        probe = sync_probe(scorer, depth=True)
        secs, counts = timed_run(g)
        out[label] = counts
        segs = [sg["name"] for sg in g._fused_segments]
        if segs != (["cast|markov_score"] if fuse else []):
            fail(f"{label}: fused segments {segs}")
        if probe[0] != COL_BATCHES:
            fail(f"{label}: {probe[0]} scorer steps")
        nrec = check_fraud(label, cols, cards, etype, table)
        flagged[fuse] = (cat_cols(cols, "card"), cat_cols(cols, "score"))
        print(f"phase 7: PipeGraph.run() {label}: {nrec} flagged records "
              f"match the oracle; segments {segs}; {n} tuples in "
              f"{secs:.3f} s = {n / secs:.0f} tuples/s; scorer step wall "
              f"{1e3 * probe[1] / probe[0]:.3f} ms a batch (synchronised; "
              f"information only); wavefront depth a batch {probe[2]}; "
              f"launches {counts}")
    if not all(np.array_equal(a, b) for a, b in zip(flagged[False],
                                                    flagged[True])):
        fail("7(a): fused records differ from unfused")
    blob_b = frame_blob(card_ids, np.arange(n), etype.astype(np.float64))
    res = {}
    for kc in (True, False):
        label = f"7(b) fraud ids {'compacted' if kc else 'interned'}"
        cols, sink = collect()
        g, scorer = fraud_graph(dev_name, blob_b, table, sink, dense=False,
                                key_compaction=kc)
        probe = sync_probe(scorer)
        secs, counts = timed_run(g)
        out[label] = counts
        nrec = check_fraud(label, cols, card_ids, etype, table)
        comp = scorer._compactor
        if kc:
            if comp is None or not comp.active:
                fail(f"{label}: the compacted route did not run")
            s = comp.summary()
            if s["hit_rate"] != 1.0 or len(scorer._interner):
                fail(f"{label}: hit rate {s['hit_rate']}, "
                     f"{len(scorer._interner)} interned keys")
            extra = f"; compactor {s}"
        else:
            if comp is not None or len(scorer._interner) != FRAUD_CARDS:
                fail(f"{label}: the interning route did not run")
            extra = f"; {len(scorer._interner)} keys interned"
        res[kc] = (cat_cols(cols, "card"), cat_cols(cols, "score"))
        print(f"phase 7: PipeGraph.run() {label}: {nrec} flagged records "
              f"match the oracle; {n} tuples in {secs:.3f} s = "
              f"{n / secs:.0f} tuples/s; scorer step wall "
              f"{1e3 * probe[1] / probe[0]:.3f} ms a batch (synchronised; "
              f"information only); launches {counts}{extra}")
    if not all(np.array_equal(a, b) for a, b in zip(res[True], res[False])):
        fail("7(b): compacted records differ from interned")

    # (c): the associative update, uniform and Zipf
    walls = {}
    for dist in ("uniform", "zipf"):
        label = f"7(c) assoc {dist}"
        if dist == "uniform":
            keys = rng.integers(0, FRAUD_CARDS, n)
        else:
            keys = rng.permutation(FRAUD_CARDS)[
                zipf_draws(rng, n, FRAUD_CARDS)]
        vals = rng.integers(0, 4, n).astype(np.float32)
        cols, sink = collect()
        g, op = assoc_graph(dev_name, frame_blob(keys, np.arange(n), vals),
                            sink)
        probe = sync_probe(op)
        secs, counts = timed_run(g)
        out[label] = counts
        cnt, run_sum = running_oracle(keys, vals)
        if not (np.array_equal(cat_cols(cols, "key"), keys)
                and np.array_equal(cat_cols(cols, "n"), cnt)
                and np.array_equal(cat_cols(cols, "sum"), run_sum)):
            fail(f"{label}: running counts or sums differ from the oracle")
        hot = np.bincount(keys[:CAP], minlength=FRAUD_CARDS).max()
        walls[dist] = probe[1] / probe[0]
        print(f"phase 7: PipeGraph.run() {label}: {n} records match the "
              f"oracle; hottest key {hot} of the first batch's {CAP} lanes; "
              f"{n} tuples in {secs:.3f} s = {n / secs:.0f} tuples/s; step "
              f"wall {1e3 * walls[dist]:.3f} ms a batch (synchronised; "
              f"information only); launches {counts}")
    print(f"phase 7: (c) step wall zipf / uniform = "
          f"{walls['zipf'] / walls['uniform']:.2f}")

    # (d): the unbounded compacted reduce on a shifting Zipf stream
    keys = zipf_shift_keys(rng, n)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    blob_d = frame_blob(keys, np.arange(n), vals)
    for monoid in ("max", "sum"):
        label = f"7(d) compacted reduce {monoid}"
        cols, sink = collect()
        g, red = kc_reduce_graph(dev_name, monoid, blob_d, sink)
        secs, counts = timed_run(g)
        out[label] = counts
        if len(cols) != COL_BATCHES:
            fail(f"{label}: {len(cols)} sink batches")
        nrec = 0
        for i, c in enumerate(cols):
            sl = slice(i * CAP, (i + 1) * CAP)
            wk, wv = batch_reduce_oracle(keys[sl], vals[sl], monoid)
            if not (np.array_equal(np.asarray(c.cols["key"]), wk)
                    and np.array_equal(np.asarray(c.cols["v0"]), wv)):
                fail(f"{label}: batch {i} differs from the oracle")
            nrec += len(wk)
        s = red._compactor.summary()
        if red._compactor.bounded or s["batches"] != COL_BATCHES \
                or s["reseeds"] != COL_BATCHES // KC_RESEED:
            fail(f"{label}: compactor {s}")
        if counts["dense_monoid_table"] != COL_BATCHES:
            fail(f"{label}: dense_monoid_table launched "
                 f"{counts['dense_monoid_table']} times in {COL_BATCHES} "
                 "steps")
        print(f"phase 7: PipeGraph.run() {label}: {nrec} records match the "
              f"oracle batch by batch; {n} tuples in {secs:.3f} s = "
              f"{n / secs:.0f} tuples/s (information only); launches "
              f"{counts}; compactor {s}")

    # (e): compacted window keys
    ids = rng.choice(2 ** 32 - 1, FFAT_IDS, replace=False) - 2 ** 31
    keys = ids[rng.integers(0, FFAT_IDS, n)].astype(np.int32)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    blob_e = frame_blob(keys, np.arange(n), vals)
    want = oracle(keys, vals)
    for sum_comb in (False, True):
        label = f"7(e) compacted windows {'sum' if sum_comb else 'generic'}"
        cols, sink = collect()
        g, win = kc_ffat_graph(dev_name, sum_comb, blob_e, sink)
        secs, counts = timed_run(g)
        out[label] = counts
        k, w, v = (cat_cols(cols, nm) for nm in ("key", "wid", "value"))
        got = dict(zip(zip(k.tolist(), w.tolist()), v.tolist()))
        if len(got) != len(k) or got != want:
            fail(f"{label}: {len(got)} windows fired, {len(want)} expected, "
                 "or sums or keys differ")
        s = win._compactor.summary()
        if s["hit_rate"] != 1.0 or s["occupied"] != FFAT_IDS:
            fail(f"{label}: compactor {s}")
        need = ("grouping_rank_hist", "sliding_fold") if sum_comb \
            else ("grouping_rank_hist",)
        for name in need:
            if counts[name] <= 0:
                fail(f"{label} never launched {name}")
        print(f"phase 7: PipeGraph.run() {label}: {len(k)} windows match "
              f"the oracle, user keys in the output; {n} tuples in "
              f"{secs:.3f} s = {n / secs:.0f} tuples/s (information only); "
              f"launches {counts}; compactor hit rate {s['hit_rate']}")
    return out


# ---------------------------------------------------------------------------
# phase 8: the wire plane and the megastep
# ---------------------------------------------------------------------------

def frames_plain_reduce_graph(dev_name, declare, blob, sink_fn, **cfg):
    """Phase 8's reduces: FrameSource → ReduceGPU keyed by the frame key,
    per key the max of each field → columnar Sink; ``declare``: the dense
    route (``withMaxKeys(KEYS)`` + a declared max, key compaction off),
    else the sorted route.  Returns ``(graph, reduce operator)``."""
    import torch
    import windflow_tpu_torch as wf
    rb = (wf.ReduceGPU_Builder(
        lambda a, b: {"key": torch.maximum(a["key"], b["key"]),
                      "v0": torch.maximum(a["v0"], b["v0"])})
        .withKeyBy(lambda t: t["key"]))
    if declare:
        rb = rb.withMaxKeys(KEYS).withMonoidCombiner("max")
    red = rb.build()
    g = wf.PipeGraph("chip_smoke_ms_reduce", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      key_compaction=False, **cfg))
    g.add_source(wf.FrameSource(chunked(blob), nv=1, output_batch_size=CAP,
                                record_spec={"key": np.int32(0),
                                             "v0": np.float32(0.0)})) \
        .add(red).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink()
                           .build())
    return g, red


def group_probe(g, rec):
    """Wrap every megastep edge of the started graph ``g``: per group the
    wall of ``run`` between two synchronises, and apart from it the
    capture and the emission downstream (host clock)."""
    import torch
    for e in g._megastep_plane.edges:
        o_run, o_cap, o_emit = e.run, e._capture, e._emit

        def run(_e=e, _o=o_run):
            before = _e.megasteps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _o()
            torch.cuda.synchronize()
            if _e.megasteps > before:
                rec["groups"] += 1
                rec["group_s"] += time.perf_counter() - t0

        def cap(*a, _o=o_cap):
            t0 = time.perf_counter()
            out = _o(*a)
            rec["capture_s"] += time.perf_counter() - t0
            return out

        def emit(*a, _o=o_emit):
            t0 = time.perf_counter()
            _o(*a)
            rec["emit_s"] += time.perf_counter() - t0
        e.run, e._capture, e._emit = run, cap, emit


def megastep_run(label, build, k, wire, folds=True):
    """One phase-8 run of ``build(sink, megastep_sweeps=k,
    wire_compression=wire)`` -> ``(graph, tail operator)``, under
    ``torch.profiler``'s CUDA activity (to count ``cudaGraphLaunch``:
    one a megastep, besides one a replay of a standalone conditional-node
    graph, ``cond_cuda.standalone_replays``): ``(sink batches, facts)``.
    At K > 1 the run must fold groups unless ``folds`` is False; every
    batch is accounted for either way."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from windflow_tpu_torch.kernels import cond_cuda as cc
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    cols, sink = collect()
    g, op = build(sink, megastep_sweeps=k, wire_compression=wire)
    steps = sync_probe(op)
    rec = {"groups": 0, "group_s": 0.0, "capture_s": 0.0, "emit_s": 0.0}
    fc.reset_launch_counts()
    regions0 = cc.standalone_replays()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g.start()
        group_probe(g, rec)
        g.wait_end()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = fc.launch_counts()
    regions = cc.standalone_replays() - regions0
    graph_launches = sum(1 for ev in prof.events()
                         if ev.name == "cudaGraphLaunch") - regions
    st = g.stats()
    sec = st["Megastep"]
    edge = sec["edges"][0] if sec["edges"] else None
    if k == 1 and (sec["edges"] or graph_launches):
        fail(f"{label} K=1: megastep edges {sec['edges']}, "
             f"{graph_launches} graph launches")
    if k > 1:
        if edge is None:
            fail(f"{label} K={k}: no megastep edge ({sec})")
        least = (COL_BATCHES - edge["warmup_batches"]
                 - edge["fallback_batches"]) // k
        if edge["megasteps"] < (max(1, least) if folds else least) \
                or edge["batches"] + edge["warmup_batches"] \
                + edge["fallback_batches"] != COL_BATCHES:
            fail(f"{label} K={k}: {edge}")
        if graph_launches != edge["megasteps"]:
            fail(f"{label} K={k}: {graph_launches} cudaGraphLaunch for "
                 f"{edge['megasteps']} megasteps")
    ws = st["Staging"]["Wire"]
    if wire and not ws["batches"]:
        fail(f"{label}: wire on, but no batch was compressed ({ws})")
    if not wire and ws["encoders"]:
        fail(f"{label}: wire off, but {ws['encoders']} encoders attached")
    n = CAP * COL_BATCHES
    per = steps[1] / steps[0] if steps[0] else None
    grouped = (rec["group_s"] - rec["capture_s"] - rec["emit_s"]) \
        / (k * rec["groups"]) if rec["groups"] else None
    facts = {
        "tuples_per_s": n / secs, "secs": secs, "launches": counts,
        "per_batch_step_ms": None if per is None else 1e3 * per,
        "per_batch_steps": steps[0],
        "group_ms_a_batch": None if grouped is None else 1e3 * grouped,
        "capture_ms": 1e3 * rec["capture_s"],
        "megastep": edge, "graph_launches": graph_launches,
        "standalone_replays": regions,
        "wire_bytes_a_tuple": st["Bytes_H2D_total"] / n,
        "logical_bytes_a_tuple": st["Bytes_H2D_logical_total"] / n,
        "encode_ms_a_batch": ws["encode_usec"] / 1e3 / ws["batches"]
        if ws["batches"] else None,
    }
    return cols, facts


def megastep_runs(dev_name="cuda"):
    """Phase 8: (i) frames into the count windows (both combiners) and
    (ii) the YSB frames into the time windows, each at K = 1 and K = 8
    forced, wire off and on; the dense and the sorted reduce and 7 (c)'s
    associative running sums at K = 1 and K = 8; every run against its
    oracle, K = 8 record for record against K = 1.  Returns launch counts
    by label."""
    n = CAP * COL_BATCHES
    rng = np.random.default_rng(2029)
    keys = rng.integers(0, KEYS, n)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    blob_i = frame_blob(keys, np.arange(n), vals)
    keys32 = keys.astype(np.int32)
    table, ad, ts_y, etype = ysb_frames(n)
    blob_ii = frame_blob(ad, ts_y, etype.astype(np.float64))
    views = etype == 1
    akeys = rng.integers(0, FRAUD_CARDS, n)
    avals = rng.integers(0, 4, n).astype(np.float32)
    blob_a = frame_blob(akeys, np.arange(n), avals)

    def cb(sum_comb, event=True):
        def build(sink, **cfg):
            g, _ = frames_cb_graph(dev_name, sum_comb, blob_i, sink,
                                   event=event, **cfg)
            return g, g.pipes[0].operators[-2]
        return build

    def ysb(sink, **cfg):
        g, _, win = ysb_frames_graph(dev_name, table, blob_ii, sink,
                                     spec=True, **cfg)
        return g, win

    def red(declare):
        def build(sink, **cfg):
            return frames_plain_reduce_graph(dev_name, declare, blob_i,
                                             sink, **cfg)
        return build

    def assoc(sink, **cfg):
        return assoc_graph(dev_name, blob_a, sink, **cfg)

    def check_cb(label, cols):
        return check_cb_columns(label, cols, keys32, vals)

    def check_ysb(label, cols):
        return check_tb_records(label, cols, table[ad[views]], ts_y[views],
                                np.ones(int(views.sum())), *YSB_WIN)

    def check_reduce(label, cols):
        if len(cols) != COL_BATCHES:
            fail(f"{label}: {len(cols)} sink batches")
        nrec = 0
        for i, c in enumerate(cols):
            sl = slice(i * CAP, (i + 1) * CAP)
            wk, wv = batch_reduce_oracle(keys32[sl], vals[sl], "max")
            if not (np.array_equal(np.asarray(c.cols["key"]), wk)
                    and np.array_equal(np.asarray(c.cols["v0"]), wv)):
                fail(f"{label}: batch {i} differs from the oracle")
            nrec += len(wk)
        return nrec

    def check_assoc(label, cols):
        cnt, run_sum = running_oracle(akeys, avals)
        if not (np.array_equal(cat_cols(cols, "key"), akeys)
                and np.array_equal(cat_cols(cols, "n"), cnt)
                and np.array_equal(cat_cols(cols, "sum"), run_sum)):
            fail(f"{label}: running counts or sums differ from the oracle")
        return n

    # (i) under the frames' own timestamps: the count windows do not read
    # time, and the ts lane keeps one wire codec (delta2) from batch to
    # batch; INGRESS stamps (one a chunk) reseed the lane's dictionary
    # every batch, every batch then has another wire format, and no group
    # of K same-format batches forms — the run below shows it
    cases = [("8 (i) frames generic", cb(False), check_cb, (False, True),
              ("grouping_rank_hist",)),
             ("8 (i) frames sum", cb(True), check_cb, (False, True),
              ("grouping_rank_hist", "sliding_fold")),
             ("8 (ii) YSB frames sum", ysb, check_ysb, (False, True), ()),
             ("8 dense reduce", red(True), check_reduce, (False,),
              ("dense_monoid_table",)),
             ("8 sorted reduce", red(False), check_reduce, (False,), ()),
             ("8 7(c) assoc", assoc, check_assoc, (False,), ())]
    out = {}
    tag = "8 (i) frames generic INGRESS wire on K=8"
    cols, f = megastep_run(tag, cb(False, event=False), 8, True,
                           folds=False)
    nrec = check_cb(tag, cols)
    e = f["megastep"]
    print(f"phase 8: PipeGraph.run() {tag}: {nrec} records match the "
          f"oracle; megasteps {e['megasteps']}, warm-up "
          f"{e['warmup_batches']}, fallback {e['fallback_batches']} (each "
          f"batch's wire format differs from its predecessor's); "
          f"{f['tuples_per_s']:.0f} tuples/s (information only)")
    out[tag] = f["launches"]
    for label, build, check, wires, need in cases:
        for wire in wires:
            base = None
            for k in (1, 8):
                tag = f"{label} wire {'on' if wire else 'off'} K={k}"
                cols, f = megastep_run(tag, build, k, wire)
                nrec = check(tag, cols)
                recs = batch_records(cols) if check is not check_assoc \
                    else np.stack([cat_cols(cols, "key"),
                                   cat_cols(cols, "n"),
                                   cat_cols(cols, "sum")])
                counts = f["launches"]
                for name in need:
                    if counts[name] <= 0:
                        fail(f"{tag} never launched {name}")
                if k == 1:
                    base = (recs, counts)
                else:
                    if not np.array_equal(recs, base[0]):
                        fail(f"{tag}: records differ from K=1's")
                    if counts != base[1]:
                        fail(f"{tag}: kernel launches {counts}, at K=1 "
                             f"{base[1]} (replays must count)")
                    e = f["megastep"]
                    if need and e["kernel_launches_per_group"] <= 0:
                        fail(f"{tag}: no hand kernel inside the graph")
                out[tag] = counts
                e = f["megastep"] or {}
                print(f"phase 8: PipeGraph.run() {tag}: {nrec} records "
                      f"match the oracle{' and K=1' if k > 1 else ''}; "
                      f"megasteps {e.get('megasteps', 0)} "
                      f"(cudaGraphLaunch {f['graph_launches']}), warm-up "
                      f"{e.get('warmup_batches', 0)}, fallback "
                      f"{e.get('fallback_batches', 0)}, captures "
                      f"{e.get('captures', 0)} ({f['capture_ms']:.1f} ms), "
                      f"kernel launches a group "
                      f"{e.get('kernel_launches_per_group', 0)}; per-batch "
                      f"step wall {f['per_batch_step_ms']} ms over "
                      f"{f['per_batch_steps']} steps, group wall a batch "
                      f"{f['group_ms_a_batch']} ms (stack + copy + replay "
                      "+ clones, synchronised); wire "
                      f"{f['wire_bytes_a_tuple']:.3f} B/tuple against "
                      f"logical {f['logical_bytes_a_tuple']:.3f}, host "
                      f"encode {f['encode_ms_a_batch']} ms a batch; "
                      f"{n} tuples in {f['secs']:.3f} s = "
                      f"{f['tuples_per_s']:.0f} tuples/s (host clock, "
                      "under the profiler's CUDA activity; information "
                      f"only); launches {counts}")
    return out


# ---------------------------------------------------------------------------
# phase 10: the observability plane
# ---------------------------------------------------------------------------

def obs_sections_ok(label, st):
    """No ``stats()`` section of a card run holds an ``"error"`` or
    reports the CPU."""
    for name, sec in st.items():
        if isinstance(sec, dict) and "error" in sec:
            fail(f"{label}: stats()[{name!r}] failed: {sec['error']}")
    if [m["platform"] for m in st["Device"]["memory"]] != ["cuda"]:
        fail(f"{label}: the Device section reports {st['Device']['memory']}")


def trace_order_ok(label, events):
    """staged ≤ dispatched ≤ device_done ≤ sunk for every trace that
    reached the sink (each stage's first stamp), and a device_done on
    each; returns the number of such traces."""
    by = {}
    for e in events:
        by.setdefault(e["trace"], {}).setdefault(e["stage"], e["t_usec"])
    n = 0
    for tid, t in by.items():
        if "sunk" not in t:
            continue
        n += 1
        if "device_done" not in t:
            fail(f"{label}: trace {tid} has no device_done: {t}")
        seq = [t[s] for s in ("staged", "dispatched", "device_done", "sunk")
               if s in t]
        if seq != sorted(seq):
            fail(f"{label}: trace {tid}'s stamps are out of order: {t}")
    if n == 0:
        fail(f"{label}: no trace reached the sink")
    return n


def q_ms(q):
    return f"{q['p50'] / 1e3:.3f}/{q['p95'] / 1e3:.3f}/{q['p99'] / 1e3:.3f}"


def observability_runs(dev_name="cuda"):
    """Phase 10: the observability plane on the card (60 s budget).
    (a) phase 5 (i)'s graph (event time, wire off, 16 batches) at K = 8
    and K = 1, both combiners, the recorder tracing every other batch and
    waiting on each traced one, against the recorder-off run; (b) phase
    7 (d)'s compacted reduce with the shard sketch bound (churn); (c)
    phase 6 (b)'s merged DeviceSources into a keyed ReduceGPU at
    parallelism 4 with the device sketch in the keyby split, against the
    sketch-off run; (d) a seeded stall named, bundled and checked by
    ``tools/wf_doctor.py``.  Returns each run's launch counts by
    label."""
    import torch

    import windflow_tpu_torch as wf
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.parallel.emitters import splitmix64_np
    out = {}
    n = CAP * COL_BATCHES
    rng = np.random.default_rng(2025)
    keys = rng.integers(0, KEYS, n)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    blob = frame_blob(keys, np.arange(n), vals)

    from windflow_tpu_torch import staging

    # (a) latency on the main path
    for sum_comb in (False, True):
        comb = "sum" if sum_comb else "generic"
        for k in (8, 1):
            runs = {}
            for rec in (False, True):
                cols, sink = collect()
                g, _ = frames_cb_graph(
                    dev_name, sum_comb, blob, sink, event=True,
                    wire_compression=False, megastep_sweeps=k,
                    flight_recorder=rec, trace_sample_every=2,
                    trace_device_sync_every=1)
                db = staging.device_bytes.staged_bytes_total
                secs, counts = timed_run(g)
                db = staging.device_bytes.staged_bytes_total - db
                runs[rec] = (cols, counts, g, secs, db)
            label = f"10(a) cb {comb} K={k}"
            (c0, n0, _, _, _), (c1, n1, g, secs, dbytes) = \
                runs[False], runs[True]
            out[label] = n1
            nrec = check_cb_columns(label, c1, keys.astype(np.int32), vals)
            for name in ("key", "wid", "value"):
                a = np.concatenate([np.asarray(c.cols[name]) for c in c0])
                b = np.concatenate([np.asarray(c.cols[name]) for c in c1])
                if not np.array_equal(a, b):
                    fail(f"{label}: records differ from the recorder-off run")
            if n0 != n1:
                fail(f"{label}: launches {n1} with the recorder on, {n0} "
                     "off")
            st = g.stats()
            obs_sections_ok(label, st)
            ntr = trace_order_ok(label, g._recorder.events())
            bad = {o: v["state"] for o, v in st["Health"]["verdicts"].items()
                   if v["state"] != "OK"}
            if bad:
                fail(f"{label}: health verdicts {bad}")
            tail = g._fused_segments[0]["host_name"]
            hop = st["Sweep"]["per_hop"][tail]
            if hop["dispatches_per_batch"] != 1.0 \
                    or hop.get("fused_program") is None:
                fail(f"{label}: the fused hop {hop}")
            ms = st["Megastep"]["edges"]
            if k == 8 and dev_name == "cuda" \
                    and not (ms and ms[0]["megasteps"] >= 1):
                fail(f"{label}: no megastep formed: {ms}")
            lat = st["Latency"]
            e2e = lat["end_to_end_usec"]
            svc = "; ".join(
                f"{o} {q['p50'] / 1e3:.3f}/{q['p99'] / 1e3:.3f}"
                for o, q in lat["service_usec_per_operator"].items()
                if q["count"])
            # (None only off the card, where obs_sections_ok has failed)
            mem = st["Device"]["memory"][0]["stats"] or {}
            print(f"phase 10 (a): PipeGraph.run() {label}: {nrec} windows "
                  f"match the oracle and the recorder-off run; launches "
                  f"{n1} (off {n0}); {ntr} traces ordered staged <= "
                  f"dispatched <= device_done <= sunk; staged->sunk "
                  f"p50/p95/p99 {q_ms(e2e)} ms over {e2e['count']} traced "
                  f"batches; service p50/p99 ms {svc}; health OK; "
                  f"{hop['dispatches']} dispatches / {hop['batches']} "
                  f"batches on '{tail}'; allocated {mem.get('bytes_in_use')} "
                  f"peak {mem.get('peak_bytes_in_use')} reserved "
                  f"{mem.get('bytes_reserved')} bytes; staging.device_bytes "
                  f"+{dbytes} in this run; "
                  f"{n} tuples in {secs:.3f} s (host clock, information "
                  "only)")

    # (b) compactor churn with the shard sketch bound
    zrng = np.random.default_rng(77)
    zkeys = zipf_shift_keys(zrng, n)
    zvals = zrng.integers(-100, 101, n).astype(np.float32)
    zblob = frame_blob(zkeys, np.arange(n), zvals)
    post = zkeys[KC_SHIFT * CAP:]
    uk, cnt = np.unique(post, return_counts=True)
    new_top = uk[np.argsort(cnt)[::-1][:4]]
    uk_all, cnt_all = np.unique(zkeys, return_counts=True)
    for monoid in ("max", "sum"):
        label = f"10(b) compacted reduce {monoid}"
        cols, sink = collect()
        g, red = kc_reduce_graph(dev_name, monoid, zblob, sink)
        secs, counts = timed_run(g)
        out[label] = counts
        for i, c in enumerate(cols):
            sl = slice(i * CAP, (i + 1) * CAP)
            wk, wv = batch_reduce_oracle(zkeys[sl], zvals[sl], monoid)
            if not (np.array_equal(np.asarray(c.cols["key"]), wk)
                    and np.array_equal(np.asarray(c.cols["v0"]), wv)):
                fail(f"{label}: batch {i} differs from the oracle")
        if len(cols) != COL_BATCHES:
            fail(f"{label}: {len(cols)} sink batches")
        if counts["dense_monoid_table"] != COL_BATCHES:
            fail(f"{label}: dense_monoid_table launched "
                 f"{counts['dense_monoid_table']} times")
        comp = red._compactor
        s = comp.summary()
        if s["churn"] <= 0:
            fail(f"{label}: the full table never churned: {s}")
        unseated = [int(k) for k in new_top if comp.slot_of(int(k)) is None]
        if unseated:
            fail(f"{label}: new top keys not seated: {unseated}")
        st = g.stats()
        obs_sections_ok(label, st)
        load = st["Shard"]["per_op"][red.name]["load"]
        hot = load["hot_keys"][0]
        true = int(cnt_all[np.searchsorted(uk_all, hot["key"])])
        slack = 4 * n / 2048
        if not (true <= hot["est_tuples"] <= true * 1.05 + slack
                and true >= cnt_all.max() - slack):
            fail(f"{label}: hottest key {hot} against its true count "
                 f"{true} (max {int(cnt_all.max())})")
        print(f"phase 10 (b): PipeGraph.run() {label}: records match the "
              f"oracle batch by batch; dense_monoid_table {COL_BATCHES} "
              f"launches; churn {s['churn']}, reseeds {s['reseeds']}, hit "
              f"rate {s['hit_rate']} (PR 8, no sketch: 0.016); the 4 "
              f"hottest keys after the shift seated; Shard names key "
              f"{hot['key']} estimate {hot['est_tuples']} (true {true}, "
              f"basis {load['basis']}); {n} tuples in {secs:.3f} s "
              "(information only)")

    # (c) the device sketch in the keyby split
    dev = torch.device(dev_name)
    nb = COL_BATCHES // 2
    mk = np.concatenate([merged_source_numpy(nb, s)[0] for s in (1, 2)])
    want = np.bincount((splitmix64_np(mk) % np.uint64(4)).astype(np.int64),
                       minlength=4)
    runs = {}
    for sketch in (False, True):
        cols, sink = collect()
        g = wf.PipeGraph("chip_smoke_obs_merge", wf.ExecutionMode.DEFAULT,
                         config=wf.Config(device=dev_name,
                                          punctuation_interval_usec=10 ** 12,
                                          shard_ledger=sketch))
        pipes = [g.add_source(
            wf.DeviceSource_Builder(lambda i, _s=s: merged_source(i, dev, _s))
            .withCapacity(CAP).withNumBatches(nb).withName(f"src{s}")
            .build()) for s in (1, 2)]
        merged = pipes[0].merge(pipes[1])
        merged.add(wf.MapGPU_Builder(
            lambda t: {"key": t["key"], "v0": t["v0"] * 2.0 + 1.0,
                       "n": t["n"]}).build())
        red = (wf.ReduceGPU_Builder(lambda a, b: {
            k: torch.maximum(a[k], b[k]) for k in ("key", "v0", "n")})
            .withKeyBy(lambda t: t["key"]).withMaxKeys(KEYS)
            .withMonoidCombiner("max").withParallelism(4)
            .withName("merge_red").build())
        merged.add(red).add_sink(wf.Sink_Builder(sink).withColumnarSink()
                                 .build())
        secs, counts = timed_run(g)
        runs[sketch] = (counts, g, cols)
    (n0, _, c0), (n1, g, c1) = runs[False], runs[True]
    label = "10(c) merge reduce max, device sketch"
    out[label] = n1
    if n0 != n1:
        fail(f"{label}: launches {n1} with the sketch, {n0} without")
    for name in ("key", "v0", "n"):
        a = np.concatenate([np.asarray(c.cols[name]) for c in c0])
        b = np.concatenate([np.asarray(c.cols[name]) for c in c1])
        if not np.array_equal(np.sort(a), np.sort(b)):
            fail(f"{label}: records differ from the sketch-off run")
    st = g.stats()
    obs_sections_ok(label, st)
    load = st["Shard"]["per_op"]["merge_red"]["load"]
    if load["tuples"] != want.tolist() or load["total_tuples"] != len(mk):
        fail(f"{label}: per-replica counts {load['tuples']} against the "
             f"host placement {want.tolist()}")
    print(f"phase 10 (c): PipeGraph.run() {label}: per-replica counts "
          f"{load['tuples']} equal the host's splitmix64 placement of "
          f"{len(mk)} keys; launches {n1}, equal to the sketch-off run; "
          f"imbalance {load.get('imbalance_ratio')}, hot key "
          f"{load['hot_keys'][0]}")

    # (d) a seeded stall, named and bundled
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        g = wf.PipeGraph("chip_smoke_stall", wf.ExecutionMode.DEFAULT,
                         config=wf.Config(device=dev_name, log_dir=root))
        snk = wf.Sink_Builder(lambda t: None).withName("wedged_sink").build()
        g.add_source(wf.Source_Builder(
            lambda: iter({"key": np.int32(i % 8), "v": np.float32(i)}
                         for i in range(8192)))
            .withOutputBatchSize(1024).withName("src").build()) \
            .add(wf.MapGPU_Builder(lambda t: {"key": t["key"],
                                              "v": t["v"] * 2.0})
                 .withName("m").build()).add_sink(snk)
        g.start()
        snk.replicas[0].drain = lambda limit=0: False
        try:
            g.wait_end()
            fail("phase 10 (d): the wedged graph ended")
        except wf.WindFlowError as e:
            msg = str(e)
        if "root cause 'wedged_sink'" not in msg:
            fail(f"phase 10 (d): the stall error names no root cause: {msg}")
        bundle = g.dump_postmortem(os.path.join(root, "bundle"),
                                   reason="phase 10 (d)")
        doctor = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tools", "wf_doctor.py")
        r = subprocess.run([sys.executable, doctor, bundle, "--check"],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            fail(f"phase 10 (d): wf_doctor --check exited {r.returncode}: "
                 f"{r.stderr.strip()[-300:]}")
        with open(os.path.join(bundle, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["errors"]:
            fail(f"phase 10 (d): bundle sections failed: "
                 f"{manifest['errors']}")
        print(f"phase 10 (d): a wedged sink stalls the graph: "
              f"{msg[:msg.index('. Per-operator')]}; the bundle's "
              f"{len(manifest['files'])} files pass wf_doctor --check "
              f"({r.stdout.strip()})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: the observability plane, part two
# ---------------------------------------------------------------------------

#: every observability plane off: the (f) twin of each phase 11 run
PLANES_OFF = dict(flight_recorder=False, health_watchdog=False,
                  sweep_ledger=False, shard_ledger=False,
                  latency_ledger=False, tenant_ledger=False,
                  roofline_plane=False)


def smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def tool(name, *args):
    """One of the JAX package's stdlib tools (they run without jax)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        name)
    return subprocess.run([sys.executable, path, *args], capture_output=True,
                          text=True, timeout=120)


def same_cols(label, a, b, names):
    for name in names:
        if not np.array_equal(cat_cols(a, name), cat_cols(b, name)):
            fail(f"{label}: records differ from the planes-off run "
                 f"({name})")


def trace_segments_ok(label, events):
    """Each trace that reached the sink, decomposed alone by the latency
    ledger: its five segments sum exactly to its first→last span.
    Returns the traces' staged→sunk spans (µs)."""
    from windflow_tpu_torch.monitoring.latency_ledger import LatencyLedger
    from windflow_tpu_torch.monitoring.recorder import STAGE_NAMES
    by = {}
    for e in events:
        by.setdefault(e["trace"], []).append(
            (e["op"], STAGE_NAMES.index(e["stage"]), e["t_usec"],
             e["shared_k"]))
    spans = []
    for tid, evs in by.items():
        if not any(st == STAGE_NAMES.index("sunk") for _, st, _, _ in evs):
            continue
        led = LatencyLedger(recorder=None)
        led._finalize(list(evs))
        seg = sum(led.segment_totals.values())
        span = max(t for _, _, t, _ in evs) - min(t for _, _, t, _ in evs)
        if seg != led.e2e.total or seg != span:
            fail(f"{label}: trace {tid}'s segments sum to {seg} µs, its "
                 f"span is {span} µs")
        spans.append(span)
    if not spans:
        fail(f"{label}: no trace reached the sink")
    return spans


def plane_runs(dev_name="cuda"):
    """Phase 11: the observability plane, part two, on the card (60 s
    budget).  (a) the calibration probes write calibration.json, which
    ``tools/wf_calibrate.py --check`` accepts; (b) (i)'s count windows
    (event time, wire off, 16 batches, every batch traced and waited on)
    at K = 1 and K = 8, both combiners, a generous SLO: each trace's
    segments telescope, K = 8's dominant segment is the group wait, and
    an SLO under K = 8's p99 latches SLO_VIOLATED on the window, which
    ``tools/wf_slo.py`` plans to shrink; (c) two tenants in one process,
    the declared-sum window and 7 (d)'s compacted reduce: bytes equal
    each graph's totals, resident bytes within the allocator's, a budget
    under one tenant's bytes paints OVER_BUDGET, ``tools/wf_tenant.py
    --check`` gates; (d) every hop's roofline ratio in (0, 1.05] against
    the calibrated bandwidth; (e) (b)'s K = 8 graph with the monitoring
    thread (every 50 ms) and an in-process dashboard, whose ``/metrics``
    passes ``tools/wf_metrics.py --check``; (f) every run's records and
    launches equal its planes-off twin.  Returns each run's launch counts
    by label."""
    import torch

    from windflow_tpu_torch.monitoring import (DashboardServer, calibrate,
                                               calibration, monitor)
    from windflow_tpu_torch.monitoring.tenant_ledger import default_ledger
    out = {}
    smi = smi_line()
    n = CAP * COL_BATCHES
    rng = np.random.default_rng(2026)
    keys = rng.integers(0, KEYS, n)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    blob = frame_blob(keys, np.arange(n), vals)
    root = tempfile.mkdtemp(prefix="chip_smoke_planes_")
    try:
        # (a) the probes
        cal_path = os.path.join(root, "calibration.json")
        lines = []
        if calibrate.calibrate(cal_path, dev_name, log=lines.append) != 0:
            fail("phase 11 (a): calibrate failed: " + "; ".join(lines))
        with open(cal_path) as f:
            doc = json.load(f)
        want = set(calibration.MODELED_DEFAULTS) \
            - set(calibration.MESH_ONLY_KEYS)
        errs = {k: v["error"] for k, v in doc["probes"].items()
                if isinstance(v, dict) and "error" in v}
        if errs or set(doc["constants"]) != want:
            fail(f"phase 11 (a): probes gave {sorted(doc['constants'])}, "
                 f"errors {errs}")
        r = tool("wf_calibrate.py", "--check", cal_path)
        if r.returncode != 0:
            fail(f"phase 11 (a): wf_calibrate --check exited "
                 f"{r.returncode}: {r.stderr.strip()[-300:]}")
        calibration.set_default_store(calibration.load(cal_path))
        summ = calibration.provenance_summary()
        for key in want:
            prov = summ["constants"][key]["provenance"]
            if not calibration.is_calibrated(prov):
                fail(f"phase 11 (a): {key} reads {prov}")
        for key in sorted(doc["constants"]):
            print(f"phase 11 (a): calibrated {key} = {doc['constants'][key]}"
                  f" ({smi}; modeled "
                  f"{calibration.MODELED_DEFAULTS[key]})")
        print(f"phase 11 (a): {doc['device_kind']}, {doc['jax_version']}; "
              f"kernel_step launches a step "
              f"{doc['probes']['kernel_step_usec']['kernel_launches_per_step']}"
              f"; wf_calibrate --check: {r.stdout.strip()}")

        # (b) the latency plane
        base = dict(event=True, wire_compression=False,
                    trace_sample_every=1, trace_device_sync_every=1,
                    calibration=cal_path)
        off = dict(event=True, wire_compression=False, **PLANES_OFF)
        p99 = {}
        p50 = {}
        k8 = {}
        for sum_comb in (False, True):
            comb = "sum" if sum_comb else "generic"
            for k in (1, 8):
                label = f"11(b) cb {comb} K={k}"
                cols0, sink0 = collect()
                g0, _ = frames_cb_graph(dev_name, sum_comb, blob, sink0,
                                        megastep_sweeps=k, **off)
                _, n0 = timed_run(g0)
                cols, sink = collect()
                g, _ = frames_cb_graph(dev_name, sum_comb, blob, sink,
                                       megastep_sweeps=k,
                                       latency_slo_ms=1e6, **base)
                secs, n1 = timed_run(g)
                out[label] = n1
                check_cb_columns(label, cols, keys.astype(np.int32), vals)
                same_cols(label, cols0, cols, ("key", "wid", "value"))
                if n0 != n1:
                    fail(f"{label}: launches {n1}, planes off {n0}")
                g.health_tick()
                st = g.stats()
                obs_sections_ok(label, st)
                lp = st["Latency_plane"]
                spans = trace_segments_ok(label, g._recorder.events())
                tail = g._fused_segments[0]["host_name"]
                totals = lp["segments_total_usec"]
                dom = max(totals, key=totals.get)
                if k == 8:
                    if dom != "emitted_to_dispatched" or lp["per_op"][tail][
                            "dominant_segment"] != "emitted_to_dispatched":
                        fail(f"{label}: the dominant segment is {dom} "
                             f"({totals})")
                    if lp["per_op"][tail].get("megastep_k") != 8:
                        fail(f"{label}: megastep_k "
                             f"{lp['per_op'][tail].get('megastep_k')}")
                    k8[comb] = (g, tail)
                bad = {o: v["state"] for o, v in
                       st["Health"]["verdicts"].items() if v["state"] != "OK"}
                if bad or lp["slo"]["active"]:
                    fail(f"{label}: under a generous SLO health reads {bad}")
                spans.sort()
                p99[(comb, k)] = spans[min(len(spans) - 1,
                                           int(0.99 * (len(spans) - 1)
                                               + 0.999))]
                p50[(comb, k)] = spans[len(spans) // 2]
                seg = "; ".join(f"{s_} {v / 1e3:.3f}" for s_, v in
                                totals.items())
                print(f"phase 11 (b): PipeGraph.run() {label}: records "
                      f"equal the oracle and the planes-off run, launches "
                      f"{n1}; {len(spans)} traces, each one's 5 segments "
                      f"sum to its span; staged->sunk p50/p95/p99 "
                      f"{q_ms(lp['e2e_usec'])} ms (exact p99 "
                      f"{p99[(comb, k)] / 1e3:.3f} ms); segment totals ms "
                      f"{seg}; dominant {dom}; health OK; {n} tuples in "
                      f"{secs:.3f} s (information only)")
            # the tight SLO: half of K = 8's median span, which every
            # K = 8 run's p99 exceeds (its batches wait for their group);
            # half its p99 is not a bound a fresh run must break, since
            # the p99 is the first group's capture, 0.03-1.9 s a run
            label = f"11(b) cb {comb} K=8 slo"
            budget = p50[(comb, 8)] / 2e3
            cols, sink = collect()
            g, _ = frames_cb_graph(dev_name, sum_comb, blob, sink,
                                   megastep_sweeps=8, latency_slo_ms=budget,
                                   log_dir=root, **base)
            _, n1 = timed_run(g)
            out[label] = n1
            check_cb_columns(label, cols, keys.astype(np.int32), vals)
            if n1 != out[f"11(b) cb {comb} K=8"]:
                fail(f"{label}: launches {n1}")
            g.health_tick()
            st = g.stats()
            tail = g._fused_segments[0]["host_name"]
            v = st["Latency_plane"]["slo"]["verdict"]
            hv = st["Health"]["verdicts"][tail]
            if v is None or v["dominant_op"] != tail \
                    or v["dominant_segment"] != "emitted_to_dispatched" \
                    or hv["state"] != "SLO_VIOLATED":
                fail(f"{label}: budget {budget:.3f} ms: verdict {v}, "
                     f"health {hv['state']}")
            path = g.dump_stats(root)
            r = tool("wf_slo.py", "--json", "--stats", path)
            try:
                plan = json.loads(r.stdout)
            except ValueError:
                fail(f"{label}: wf_slo exited {r.returncode}: "
                     f"{r.stderr.strip()[-300:]}")
            acts = [a for o in plan["ops"] for a in o["actions"]
                    if o["op"] == tail]
            if not acts or acts[0]["kind"] != "set_megastep_sweeps" \
                    or not acts[0]["recommended_k"] < 8:
                fail(f"{label}: wf_slo planned {plan['ops']}")
            print(f"phase 11 (b): {label}: budget {budget:.3f} ms: "
                  f"SLO_VIOLATED on '{tail}': {v['message']}; wf_slo plans "
                  f"set_megastep_sweeps 8 -> {acts[0]['recommended_k']}")

        # (c) two tenants in one process; the planes-off twins first, so
        # the attributed fraction's baseline holds the tenants' staging
        zrng = np.random.default_rng(78)
        zkeys = zipf_shift_keys(zrng, n)
        zvals = zrng.integers(-100, 101, n).astype(np.float32)
        zblob = frame_blob(zkeys, np.arange(n), zvals)
        twins = {}
        for tenant in ("cb_sum", "kc_reduce"):
            cols0, sink0 = collect()
            if tenant == "cb_sum":
                g0, _ = frames_cb_graph(dev_name, True, blob, sink0, **off)
            else:
                g0, _ = kc_reduce_graph(dev_name, "sum", zblob, sink0,
                                        **PLANES_OFF)
            twins[tenant] = (cols0, timed_run(g0)[1])
        led = default_ledger()
        led.reset()
        graphs = {}
        for tenant in ("cb_sum", "kc_reduce"):
            cols, sink = collect()
            if tenant == "cb_sum":
                g, _ = frames_cb_graph(dev_name, True, blob, sink,
                                       event=True, wire_compression=False,
                                       tenant=tenant, calibration=cal_path)
                names = ("key", "wid", "value")
            else:
                g, _ = kc_reduce_graph(dev_name, "sum", zblob, sink,
                                       tenant=tenant)
                names = ("key", "v0")
            _, n1 = timed_run(g)
            cols0, n0 = twins[tenant]
            label = f"11(c) tenant {tenant}"
            out[label] = n1
            if n0 != n1:
                fail(f"{label}: launches {n1}, planes off {n0}")
            same_cols(label, cols0, cols, names)
            if tenant == "cb_sum":
                check_cb_columns(label, cols, keys.astype(np.int32), vals)
            elif n1["dense_monoid_table"] != COL_BATCHES:
                fail(f"{label}: dense_monoid_table launched "
                     f"{n1['dense_monoid_table']} times")
            graphs[tenant] = g
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        sec = led.section()
        for tenant, g in graphs.items():
            agg = sec["tenants"][tenant]
            st = g.stats()
            if agg["h2d_bytes"] != st["Bytes_H2D_total"] \
                    or agg["d2h_bytes"] != st["Bytes_D2H_total"]:
                fail(f"11(c) {tenant}: tenant bytes {agg['h2d_bytes']}/"
                     f"{agg['d2h_bytes']}, graph {st['Bytes_H2D_total']}/"
                     f"{st['Bytes_D2H_total']}")
            if not 0 < agg["resident_state_bytes"] <= allocated:
                fail(f"11(c) {tenant}: resident {agg['resident_state_bytes']}"
                     f" against {allocated} allocated")
            print(f"phase 11 (c): tenant {tenant}: staged "
                  f"{agg['h2d_bytes']} B = its graph's Bytes_H2D_total, "
                  f"fetched {agg['d2h_bytes']} B, resident "
                  f"{agg['resident_state_bytes']} B (heaviest "
                  f"{agg['heaviest_op']}) of {allocated} B allocated, "
                  f"{agg['dispatches']} dispatches")
        att = sec["attributed"]
        if att["staged_fraction"] is None or att["staged_fraction"] < 0.9:
            fail(f"phase 11 (c): attributed {att}")
        path = graphs["cb_sum"].dump_stats(root)
        r = tool("wf_tenant.py", "--check", "--stats", path)
        if r.returncode != 0:
            fail(f"phase 11 (c): wf_tenant --check within budget exited "
                 f"{r.returncode}: {r.stdout.strip()[-300:]}")
        # a budget under the reduce tenant's resident bytes
        over = sec["tenants"]["kc_reduce"]["resident_state_bytes"] // 2
        cols, sink = collect()
        g, red = kc_reduce_graph(dev_name, "sum", zblob, sink,
                                 tenant="kc_reduce_tight",
                                 hbm_budget_bytes=over)
        _, n1 = timed_run(g)
        out["11(c) tenant kc_reduce_tight"] = n1
        from windflow_tpu_torch.monitoring.tenant_ledger import ENTER_AFTER
        for _ in range(ENTER_AFTER):
            led.tick(tenant="kc_reduce_tight", force=True)
        g.health_tick()
        st = g.stats()
        bud = st["Tenant"]["tenants"]["kc_reduce_tight"]["budget"]
        vb = bud["verdict"]
        hv = st["Health"]["verdicts"].get((vb or {}).get("heaviest_op"), {})
        if vb is None or hv.get("state") != "OVER_BUDGET" \
                or vb["heaviest_op"] != red.name:
            fail(f"phase 11 (c): budget {over} B: verdict {vb}, health "
                 f"{hv}")
        path = g.dump_stats(root)
        r1 = tool("wf_tenant.py", "--check", "--stats", path)
        r2 = tool("wf_tenant.py", "--stats", path)
        if r1.returncode != 1 or "OVER BUDGET" not in r1.stdout \
                or r2.returncode != 0 or "rescale_tenant" not in r2.stdout:
            fail(f"phase 11 (c): wf_tenant gate {r1.returncode} "
                 f"{r1.stdout.strip()[-200:]} / plan {r2.returncode}")
        print(f"phase 11 (c): budget {over} B under the reduce tenant's "
              f"{over * 2} B: OVER_BUDGET on '{vb['heaviest_op']}' "
              f"(pressure {bud['pressure']}); wf_tenant --check exits 1 "
              f"over budget and 0 within; attributed fraction "
              f"{att['staged_fraction']}")

        # (d) + (e): the monitoring thread and the dashboard on (b)'s
        # K = 8 graph, the roofline ticking at its cadence
        monitor.SAMPLE_INTERVAL_SEC = 0.05
        calibration.RooflineLedger.TICK_MIN_INTERVAL_S = 0.05
        server = DashboardServer(tcp_port=0, http_port=0).start()
        try:
            label = "11(e) cb generic K=8 monitored"
            cols0, sink0 = collect()
            g0, _ = frames_cb_graph(dev_name, False, blob, sink0,
                                    megastep_sweeps=8, **off)
            _, n0 = timed_run(g0)
            cols, sink = collect()
            g, _ = frames_cb_graph(dev_name, False, blob, sink,
                                   megastep_sweeps=8, tracing_enabled=True,
                                   dashboard_host="127.0.0.1",
                                   dashboard_port=server.tcp_port,
                                   log_dir=root, **base)
            secs, n1 = timed_run(g)
            out[label] = n1
            check_cb_columns(label, cols, keys.astype(np.int32), vals)
            same_cols(label, cols0, cols, ("key", "wid", "value"))
            if n0 != n1:
                fail(f"{label}: launches {n1}, planes off {n0}")
            st = g.stats()
            ms = st["Megastep"]["edges"]
            if dev_name == "cuda" and not (ms and ms[0]["megasteps"] >= 1
                                           and ms[0]["captures"] >= 1):
                fail(f"{label}: no captured megastep: {ms}")
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                with server._lock:
                    apps = [a for a in server.apps.values()]
                if apps and all(a.ended for a in apps):
                    break
                time.sleep(0.05)
            if len(apps) != 1 or not apps[0].ended \
                    or len(apps[0].reports) < 2:
                fail(f"{label}: the dashboard saw "
                     f"{[a.summary() for a in apps]}")
            r = tool("wf_metrics.py",
                     f"http://127.0.0.1:{server.http_port}/metrics",
                     "--check")
            if r.returncode != 0:
                fail(f"{label}: wf_metrics --check exited {r.returncode}: "
                     f"{r.stderr.strip()[-300:]}")
            print(f"phase 11 (e): {label}: records equal the oracle and "
                  f"the planes-off run, launches {n1}; NEW_APP, "
                  f"{len(apps[0].reports) - 1} NEW_REPORT, END_APP; "
                  f"{ms[0]['captures']} capture(s), {ms[0]['megasteps']} "
                  f"megastep(s), none failed; GET /metrics: "
                  f"{r.stdout.strip()}; {n} tuples in {secs:.3f} s")
            rfl = st["Roofline"]
            hops = {o: h for o, h in rfl["per_hop"].items()
                    if "ratio_vs_roofline" in h}
            if not hops or not calibration.is_calibrated(
                    rfl["bandwidth_provenance"]):
                fail(f"phase 11 (d): roofline {rfl['per_hop']} at "
                     f"{rfl['bandwidth_provenance']}")
            for o, h in hops.items():
                if not 0 < h["ratio_vs_roofline"] <= 1.05:
                    fail(f"phase 11 (d): hop {o} ratio {h}")
                print(f"phase 11 (d): hop '{o}': "
                      f"{h['achieved_tuples_per_sec']} tuples/s over "
                      f"{h['samples']} samples x {h['bytes_per_tuple']} B a "
                      f"tuple ({h['bytes_per_tuple_source']}) = "
                      f"{h['achieved_bytes_per_sec']} B/s, ratio "
                      f"{h['ratio_vs_roofline']} of "
                      f"{rfl['bandwidth_bytes_per_sec']} B/s "
                      f"({rfl['bandwidth_provenance']}; {smi})")
        finally:
            server.stop()
            monitor.SAMPLE_INTERVAL_SEC = 1.0
            calibration.RooflineLedger.TICK_MIN_INTERVAL_S = 0.2
    finally:
        calibration.set_default_store(None)
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 12: the analysis plane
# ---------------------------------------------------------------------------

#: batches a phase-12 run: one warm-up, one K = 8 group, one fallback
AN_BATCHES = 10


def checked_no_device_work(label, g):
    """``g.check()`` with every device-work probe armed: allocated bytes,
    the kernels' launch counts, a ``torch.profiler`` window (no CUDA
    kernel) and ``set_sync_debug_mode("error")``.  Returns (findings,
    check ms)."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    # earlier runs' cyclic garbage first: its release would read as a
    # change of the allocated bytes
    gc.collect()
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    fc.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            diags = g.check()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if torch.cuda.memory_allocated() != alloc:
        fail(f"phase 12 (a) {label}: check() allocated "
             f"{torch.cuda.memory_allocated() - alloc} B on the card")
    if any(fc.launch_counts().values()):
        fail(f"phase 12 (a) {label}: check() launched {fc.launch_counts()}")
    if kernels:
        fail(f"phase 12 (a) {label}: check() ran CUDA kernels {kernels[:4]}")
    return diags, g._preflight_ms


def analysis_runs(dev_name="cuda"):
    """Phase 12: the analysis plane on the card (see the module
    docstring); returns the launch counts by run label."""
    import gc

    import torch
    import windflow_tpu_torch as wf
    from windflow_tpu_torch import staging
    from windflow_tpu_torch.analysis import debug_concurrency as dbg
    from windflow_tpu_torch.analysis.tracecheck import verify_graph
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    n = CAP * AN_BATCHES
    rng = np.random.default_rng(2026)
    keys = rng.integers(0, KEYS, n)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    blob = frame_blob(keys, np.arange(n), vals)
    keys32 = keys.astype(np.int32)
    table, ad, ts_y, etype = ysb_frames(n)
    blob_ii = frame_blob(ad, ts_y, etype.astype(np.float64))
    out = {}

    def kc_graph(sink, **cfg):
        g, red = kc_reduce_graph(dev_name, "max", blob, sink, **cfg)
        g._topo_operators()[0].record_spec = {"key": np.int32(0),
                                              "v0": np.float32(0.0)}
        return g

    builds = {
        "5(i) generic K=1": lambda sink, **c: frames_cb_graph(
            dev_name, False, blob, sink, event=True, megastep_sweeps=1,
            **c)[0],
        "5(i) generic K=8": lambda sink, **c: frames_cb_graph(
            dev_name, False, blob, sink, event=True, megastep_sweeps=8,
            **c)[0],
        "5(i) sum K=1": lambda sink, **c: frames_cb_graph(
            dev_name, True, blob, sink, event=True, megastep_sweeps=1,
            **c)[0],
        "5(i) sum K=8": lambda sink, **c: frames_cb_graph(
            dev_name, True, blob, sink, event=True, megastep_sweeps=8,
            **c)[0],
        "7(d) compacted reduce max": kc_graph,
        "5(ii) YSB frames": lambda sink, **c: ysb_frames_graph(
            dev_name, table, blob_ii, sink, spec=True, **c)[0],
    }

    # (a) no device work, (f) wfverify clean
    for label, build in builds.items():
        g = build(collect()[1])
        diags, ms = checked_no_device_work(label, g)
        if diags:
            fail(f"phase 12 (a) {label}: check() found "
                 f"{[str(d) for d in diags]}")
        rep = verify_graph(g)
        if rep.diagnostics:
            fail(f"phase 12 (f) {label}: wfverify found "
                 f"{[str(d) for d in rep.diagnostics]}")
        print(f"phase 12 (a) {label}: check() = [] in {ms} ms, no "
              f"allocation, launch, CUDA kernel or sync; (f) wfverify "
              f"clean over {rep.checked} callables")

    # (b) preflight on and off: equal records and launches
    base = {}
    for label, build in builds.items():
        got = {}
        for mode in ("error", "off"):
            cols, sink = collect()
            g = build(sink, preflight=mode)
            fc.reset_launch_counts()
            g.run()
            torch.cuda.synchronize()
            got[mode] = (cols, fc.launch_counts())
        (c_on, l_on), (c_off, l_off) = got["error"], got["off"]
        names = sorted(c_on[0].cols) if c_on else []
        if not c_on or len(c_on) != len(c_off):
            fail(f"phase 12 (b) {label}: {len(c_on)} vs {len(c_off)} "
                 "output batches")
        same_cols(f"phase 12 (b) {label}", c_on, c_off, names)
        if l_on != l_off:
            fail(f"phase 12 (b) {label}: launches {l_on} vs {l_off}")
        if label.startswith("5(i)"):
            check_cb_columns(f"phase 12 (b) {label}", c_on, keys32, vals)
        out[f"12(b) {label}"] = l_on
        base[label] = c_on
        print(f"phase 12 (b) {label}: preflight error = off: "
              f"{sum(len(c.cols[names[0]]) for c in c_on)} records, "
              f"launches {l_on}")

    # (c) the two-fault graph is refused before any device work
    src1 = wf.FrameSource(chunked(blob), nv=1, output_batch_size=CAP,
                          record_spec={"key": np.int32(0),
                                       "v0": np.float32(0.0)})
    src2 = wf.FrameSource(chunked(blob), nv=1, output_batch_size=CAP,
                          record_spec={"key": np.int32(0),
                                       "v0": np.float32(0.0)})
    g = wf.PipeGraph("two_faults", config=wf.Config(device=dev_name))
    g.add_source(src1).add(wf.MapGPU_Builder(
        lambda t: {"v0": torch.cat([t["v0"], t["v0"]])}).withName("m")
        .build()).add_sink(wf.Sink_Builder(lambda r: None).build())
    g.add_source(src2).add(wf.FilterGPU_Builder(lambda t: t["v0"])
                           .withName("f").build()).add_sink(
        wf.Sink_Builder(lambda r: None).build())
    gc.collect()
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    pools = staging.pools_stats()
    staged = staging.device_bytes.staged_batches_total
    try:
        g.start()
        fail("phase 12 (c): the two-fault graph started")
    except wf.PreflightError as e:
        codes = sorted(d.code for d in e.diagnostics)
        if codes != ["WF101", "WF102"]:
            fail(f"phase 12 (c): PreflightError names {codes}")
    torch.cuda.synchronize()
    touched = {
        "allocated bytes": (alloc, torch.cuda.memory_allocated()),
        "staging pools": (pools, staging.pools_stats()),
        "staged batches": (staged,
                           staging.device_bytes.staged_batches_total),
        "replicas": (0, len(g._all_replicas))}
    touched = {k: v for k, v in touched.items() if v[0] != v[1]}
    if touched:
        fail(f"phase 12 (c): the refused graph changed {touched}")
    print("phase 12 (c): the two-fault graph raised one PreflightError "
          f"naming {codes}; allocated bytes ({alloc}) and the staging "
          "pools unchanged")

    # (d) the named downgrades match the runtime
    cols, sink = collect()
    g, _ = frames_cb_graph(dev_name, False, blob, sink, event=True,
                           megastep_sweeps=1, cuda_kernels="1")
    w = g._topo_operators()[-2]
    found = [d for d in g.check() if d.code == "WF607"]
    if [d.node for d in found] != [w.name]:
        fail(f"phase 12 (d): WF607 names {[d.node for d in found]}")
    fc.reset_launch_counts()
    g.run()
    torch.cuda.synchronize()
    counts = fc.launch_counts()
    out["12(d) cuda_kernels=1 generic"] = counts
    if counts["grouping_rank_hist"] <= 0 or counts["sliding_fold"]:
        fail(f"phase 12 (d): a generic combiner's run launched {counts}")
    same_cols("phase 12 (d) forced kernels", cols,
              base["5(i) generic K=1"], ("key", "wid", "value"))
    cols, sink = collect()
    src = wf.FrameSource(chunked(blob), nv=1, output_batch_size=CAP,
                         record_spec={"key": np.int32(0),
                                      "v0": np.float32(0.0)})
    g = wf.PipeGraph("fanout", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.EVENT,
                     config=wf.Config(device=dev_name, megastep_sweeps=8,
                                      punctuation_interval_usec=10 ** 12))
    pipe = g.add_source(src)
    pipe.add(wf.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build())
    pipe.chain(wf.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build())
    pipe.add(wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"],
                                        lambda a, b: a + b)
             .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
             .withMaxKeys(KEYS).withParallelism(2).withName("w2").build()) \
        .add_sink(wf.Sink_Builder(sink).withColumnarSink().build())
    found = [d for d in g.check() if d.code == "WF608"]
    if [d.node for d in found] != ["w2"]:
        fail(f"phase 12 (d): WF608 names {[d.node for d in found]}")
    fc.reset_launch_counts()
    g.run()
    torch.cuda.synchronize()
    out["12(d) megastep=8 fan-out"] = fc.launch_counts()
    edges = g.stats()["Megastep"]["edges"]
    if edges:
        fail(f"phase 12 (d): a group formed on the fan-out: {edges}")
    nrec = check_cb_columns("phase 12 (d) fan-out", cols, keys32, vals)
    print(f"phase 12 (d): WF607 names '{w.name}' and the run launched "
          f"{counts} (grouping, no fold); WF608 names 'w2' and no group "
          f"formed ({nrec} windows equal the oracle)")

    # (e) the race detector stays quiet on a clean run
    saved = dict(staging._pools)
    staging._pools.clear()          # pools made under the flag: checked
    dbg.set_enabled(True)
    try:
        cols, sink = collect()
        g = builds["5(i) generic K=8"](sink)
        fc.reset_launch_counts()
        g.run()
        torch.cuda.synchronize()
        out["12(e) race detector"] = fc.launch_counts()
    except wf.ConcurrencyViolation as e:
        fail(f"phase 12 (e): {e}")
    finally:
        dbg.set_enabled(False)
        staging._pools.clear()
        staging._pools.update(saved)
    same_cols("phase 12 (e) race detector", cols, base["5(i) generic K=8"],
              ("key", "wid", "value"))
    print("phase 12 (e): (i)'s generic K = 8 run under the race detector: "
          "no ConcurrencyViolation, records equal the flag-off run")
    return out


#: phase 12 (g)-(k): batches of the capture-audit runs (K = 8 needs a
#: warm-up batch and one whole group)
AUDIT_BATCHES = 9
#: the WF9xx codes a clean main-path program must not show
AUDIT_CODES = ("WF902", "WF903", "WF904", "WF905", "WF906", "WF907")


def audit_item_graph():
    """Phase 12 (h)'s negative, a factory the capture audit's CLI loads
    (``python -m windflow_tpu_torch.analysis.ir chip_smoke:audit_item_graph
    --drive 1 --strict``): one batch of frames → a MapGPU whose function
    reads a sum on the host with ``.item()`` → Sink.  Preflight is off
    (it names the read WF101 first), so the step runs and the recorder
    sees it."""
    import windflow_tpu_torch as wf
    rng = np.random.default_rng(12)
    keys = rng.integers(0, KEYS, CAP)
    blob = frame_blob(keys, np.arange(CAP), rng.integers(0, 9, CAP))
    src = wf.FrameSource(chunked(blob), nv=1, output_batch_size=CAP,
                         record_spec={"key": np.int32(0),
                                      "v0": np.float32(0.0)})
    g = wf.PipeGraph("chip_smoke_item", config=wf.Config(
        device="cuda", preflight="off",
        punctuation_interval_usec=10 ** 12))
    g.add_source(src).add(wf.MapGPU_Builder(
        lambda t: {"key": t["key"],
                   "v0": t["v0"] * float(t["v0"].sum().item())})
        .withName("item_map").build()).add_sink(
        wf.Sink_Builder(lambda c: None).withColumnarSink().build())
    return g


def audit_section_ok(label, g, captures):
    """``stats()["IR_audit"]`` of a finished card run: enabled, no WF9xx
    finding and nothing pending, every program recorded on the card,
    ``captures`` of them megastep captures.  Returns the section."""
    sec = g.stats()["IR_audit"]
    if not sec.get("enabled") or "error" in sec:
        fail(f"phase 12 {label}: IR_audit section {sec}")
    bad = [f for f in sec["findings"] if f["code"] in AUDIT_CODES]
    if bad or sec["pending"]:
        fail(f"phase 12 {label}: the audit found {bad}, pending "
             f"{sec['pending']}")
    progs = sec["programs"]
    if not progs or any(p["backend"] != "cuda" for p in progs):
        fail(f"phase 12 {label}: programs {progs}")
    got = sum(1 for p in progs if p["kind"] == "capture")
    if got != captures:
        fail(f"phase 12 {label}: {got} captured bodies audited, "
             f"{captures} expected: {progs}")
    return sec


def audit_runs(dev_name="cuda"):
    """Phase 12 (g)-(k), the capture audit on the card (20 s budget):
    (g) the main-path count windows (both combiners) and the YSB time
    windows at K = 1 and K = 8 and the dense-route reduce audit clean,
    the K = 8 runs listing their captured bodies; (h) a MapGPU reading
    ``.item()`` is WF906, and the ir CLI exits 1 on it under
    ``--strict``; (i) a grouping step within its gate launches the
    kernel (no WF907), and with the grouping wrapper swapped for its
    plain version the same step is WF907; (j) the sum-combiner step with
    only the fold wrapper swapped for its plain version still launches
    the grouping kernel and is WF907 for the fold (gates and launches
    are held per kernel); (k) ``Config.ffat_grouping="argsort"`` keeps
    the grouping kernel on the card, audit clean, records unchanged.
    Returns launch counts by run label."""
    import contextlib
    import io

    import torch
    from windflow_tpu_torch.analysis import ir
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.windows import ffat_kernels
    n = CAP * AUDIT_BATCHES
    rng = np.random.default_rng(2033)
    keys = rng.integers(0, KEYS, n)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    blob = frame_blob(keys, np.arange(n), vals)
    keys32 = keys.astype(np.int32)
    table, ad, ts_y, etype = ysb_frames(n)
    blob_ii = frame_blob(ad, ts_y, etype.astype(np.float64))
    out = {}

    def run(label, g):
        fc.reset_launch_counts()
        g.run()
        torch.cuda.synchronize()
        out[f"12{label}"] = fc.launch_counts()
        return out[f"12{label}"]

    # (g) the main paths audit clean
    for comb in (False, True):
        for k in (1, 8):
            label = f"(g) CB {'sum' if comb else 'generic'} K={k}"
            cols, sink = collect()
            g, _ = frames_cb_graph(dev_name, comb, blob, sink, event=True,
                                   megastep_sweeps=k)
            counts = run(label, g)
            check_cb_columns(f"phase 12 {label}", cols, keys32, vals)
            sec = audit_section_ok(label, g, 1 if k > 1 else 0)
            launched = [p["kernel_launches"] for p in sec["programs"]]
            if not all(launched):
                fail(f"phase 12 {label}: a program launched no kernel: "
                     f"{sec['programs']}")
            print(f"phase 12 {label}: audit clean over "
                  f"{sec['programs_audited']} programs "
                  f"{[(p['name'], p['kind'], p['aten_ops'], p['kernel_launches']) for p in sec['programs']]}"
                  f"; sanctioned reads {len(sec['exempt_host_reads'])}; "
                  f"launches {counts}")
    for k in (1, 8):
        label = f"(g) YSB TB K={k}"
        cols, sink = collect()
        g, _, _ = ysb_frames_graph(dev_name, table, blob_ii, sink, spec=True,
                                   megastep_sweeps=k)
        counts = run(label, g)
        sec = audit_section_ok(label, g, 1 if k > 1 else 0)
        print(f"phase 12 {label}: audit clean over "
              f"{sec['programs_audited']} programs "
              f"{[(p['name'], p['kind'], p['aten_ops']) for p in sec['programs']]}"
              f"; sanctioned reads "
              f"{[e['reason'] for e in sec['exempt_host_reads']]}")
    label = "(g) dense reduce"
    cols, sink = collect()
    g, _ = frames_plain_reduce_graph(dev_name, True, blob, sink,
                                     megastep_sweeps=1)
    counts = run(label, g)
    if counts["dense_monoid_table"] <= 0:
        fail(f"phase 12 {label}: the table kernel never launched")
    sec = audit_section_ok(label, g, 0)
    print(f"phase 12 {label}: audit clean over {sec['programs_audited']} "
          f"program(s), launches {counts}")

    # (h) a host read in a device function is WF906; --strict exits 1
    g = audit_item_graph()
    run("(h) item", g)
    codes = [f["code"] for f in g.stats()["IR_audit"]["findings"]]
    if codes != ["WF906"]:
        fail(f"phase 12 (h): the .item() map audited {codes}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ir.main(["chip_smoke:audit_item_graph", "--drive", "1",
                      "--json", "--strict"])
    rep = json.loads(buf.getvalue())["chip_smoke:audit_item_graph"]
    if rc != 1 or [f["code"] for f in rep["findings"]] != ["WF906"]:
        fail(f"phase 12 (h): the ir CLI exited {rc} with {rep['findings']}")
    print(f"phase 12 (h): a MapGPU reading .item() is WF906 "
          f"({rep['findings'][0]['message'][:120]}...); the ir CLI exits "
          f"{rc} under --strict")

    # (i) WF907: the grouping wrapper swapped for its plain version
    saved = fc.order_hist
    fc.order_hist = lambda ids, nb: ffat_kernels.order_and_hist(ids, nb)
    try:
        cols, sink = collect()
        g, _ = frames_cb_graph(dev_name, False, blob, sink, event=True,
                               megastep_sweeps=1)
        counts = run("(i) plain grouping", g)
    finally:
        fc.order_hist = saved
    check_cb_columns("phase 12 (i)", cols, keys32, vals)
    codes = [f["code"] for f in g.stats()["IR_audit"]["findings"]]
    if counts["grouping_rank_hist"] or "WF907" not in codes:
        fail(f"phase 12 (i): launches {counts}, findings {codes}")
    print(f"phase 12 (i): within its gate the grouping step launches the "
          f"kernel (no WF907 in (g)); with the wrapper's plain version "
          f"swapped in it launches {counts['grouping_rank_hist']} and "
          f"audits {codes}")

    # (j) WF907 per kernel: on the sum-combiner step the grouping kernel
    # still launches while the fold runs its plain version
    from windflow_tpu_torch.utils.tree import tree_map
    saved = fc.sliding_fold
    fc.sliding_fold = lambda v, m, R, mo: tree_map(
        lambda leaf: fc.fold_leaf_plain(leaf, m, R, mo), v)
    try:
        cols, sink = collect()
        g, _ = frames_cb_graph(dev_name, True, blob, sink, event=True,
                               megastep_sweeps=1)
        counts = run("(j) plain fold", g)
    finally:
        fc.sliding_fold = saved
    check_cb_columns("phase 12 (j)", cols, keys32, vals)
    fnd = g.stats()["IR_audit"]["findings"]
    if counts["sliding_fold"] or counts["grouping_rank_hist"] <= 0 \
            or [f["code"] for f in fnd] != ["WF907"] \
            or "sliding_fold" not in fnd[0]["message"]:
        fail(f"phase 12 (j): launches {counts}, findings {fnd}")
    print(f"phase 12 (j): the sum step with a plain fold launches "
          f"grouping {counts['grouping_rank_hist']} / fold "
          f"{counts['sliding_fold']} and audits WF907 for the fold")

    # (k) the argsort grouping option keeps the kernel on the card
    cols, sink = collect()
    g, _ = frames_cb_graph(dev_name, True, blob, sink, event=True,
                           megastep_sweeps=1, ffat_grouping="argsort")
    counts = run("(k) argsort", g)
    check_cb_columns("phase 12 (k)", cols, keys32, vals)
    audit_section_ok("(k) argsort", g, 0)
    if counts["grouping_rank_hist"] <= 0:
        fail(f"phase 12 (k): ffat_grouping='argsort' launched {counts}")
    print(f"phase 12 (k): ffat_grouping='argsort' on the card launches "
          f"{counts}, audit clean")
    return out


# ---------------------------------------------------------------------------
# phase 13: the host window engine, the persistent operators, the apps
# ---------------------------------------------------------------------------

#: (e)-(h): tuples of the host-window runs (one batch) and of wordcount
#: (cut in depth: its counter sends one update a message, ~30 K words/s
#: on the card's host); the P_Reduce restart's tuples, a half each run
#: (its per-tuple log writes read ~20-25 K tuples/s there)
P13_N, P13_WORDS, P13_VOCAB = CAP, 1 << 17, 10000
P13_REDUCE_N = CAP // 4
#: (f): spike_detection's devices and readings a device (cut in depth:
#: the app sends one tuple a message, ~11 K readings/s on the card's host)
SPIKE_DEVICES, SPIKE_READINGS = 1024, 64
#: (h): P_Keyed_Windows' in-memory elements a key before a spill
P13_SPILL = 64
#: (g)-(h): the output batch size of the host-only stages (wordcount's
#: ``batch``, its source and splitter; P_Reduce's source and output)
P13_HOST_BATCH = 1024


def p13_cfg(dev_name, **kw):
    import windflow_tpu_torch as wt
    return wt.Config(device=dev_name, punctuation_interval_usec=10 ** 12,
                     **kw)


def p13_equal(label, rows, want):
    """``rows`` of ``(key, wid, value)`` against the oracle dict, record
    for record and exact; returns the record count."""
    got = {(k, w): v for k, w, v in rows}
    if len(got) != len(rows):
        fail(f"phase 13 {label}: duplicate (key, wid) records")
    if set(got) != set(want):
        fail(f"phase 13 {label}: {len(got)} windows fired, {len(want)} "
             "expected, or other (key, wid)s")
    bad = [k for k in want if got[k] != want[k]]
    if bad:
        fail(f"phase 13 {label}: {len(bad)} values differ, e.g. {bad[0]}: "
             f"{got[bad[0]]} vs {want[bad[0]]}")
    if not np.isfinite(np.asarray(list(got.values()), np.float64)).all():
        fail(f"phase 13 {label}: non-finite values")
    return len(rows)


def p13_run(label, g, n, out, need=(), check=True):
    """One ``PipeGraph.run()``: ``check()`` first (clean unless
    ``check`` is False), the launch counts set to 0 just before the run
    and read just after (each kernel of ``need`` must have launched),
    then the information-only rate.  Returns the seconds."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    if check:
        diags = g.check()
        if diags:
            fail(f"phase 13 {label}: check() found "
                 f"{[str(d) for d in diags]}")
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    g.run()
    if g.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = fc.launch_counts()
    out[f"13{label}"] = counts
    for k in need:
        if counts[k] <= 0:
            fail(f"phase 13 {label}: {k} never launched: {counts}")
    print(f"phase 13 {label}: {n} tuples in {secs:.3f} s = "
          f"{n / secs:.0f} tuples/s (host clock, information only); "
          f"launches {counts}")
    return secs


def ticker_oracle(sym, price, win, slide):
    """{(sym, wid): (high, low)} over every count window of each symbol's
    ticks, EOS partials included (float32 values, exact)."""
    out = {}
    order = np.argsort(sym, kind="stable")
    ss, ps = sym[order], price[order]
    bounds = np.flatnonzero(np.diff(ss)) + 1
    for seg_s, seg_p in zip(np.split(ss, bounds), np.split(ps, bounds)):
        n = len(seg_p)
        pad = (-n) % slide + win
        hi = np.pad(seg_p, (0, pad), constant_values=-np.inf)
        lo = np.pad(seg_p, (0, pad), constant_values=np.inf)
        nw = -(-n // slide)
        view_hi = np.lib.stride_tricks.sliding_window_view(hi, win)[::slide]
        view_lo = np.lib.stride_tricks.sliding_window_view(lo, win)[::slide]
        for w, (h, l) in enumerate(zip(view_hi[:nw].max(1),
                                       view_lo[:nw].min(1))):
            out[(int(seg_s[0]), w)] = (float(h), float(l))
    return out


def host_window_graph(dev_name, builder, keys, vals, ts, rows, name,
                      gpu=False, **cfg):
    """(e): Source (EVENT time) → MapGPU | FilterGPU (phase 3's map and
    filter, on the card) → the window ``builder`` built → Sink appending
    ``(key, wid, value)`` to ``rows``."""
    import windflow_tpu_torch as wt

    def gen():
        yield from ({"key": k, "v0": v, "ts": t}
                    for k, v, t in zip(keys, vals, ts.tolist()))

    def sink(r):
        if r is None:
            return
        if gpu:
            rows.append((r["key"], r["wid"], r["value"]))
        else:
            rows.append((r.key, r.wid, r.value))

    g = wt.PipeGraph(name, wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT,
                     config=p13_cfg(dev_name, **cfg))
    pipe = g.add_source(wt.Source_Builder(gen)
                        .withTimestampExtractor(lambda t: t["ts"])
                        .withOutputBatchSize(CAP)
                        .withRecordSpec({"key": np.int32(0),
                                         "v0": np.float32(0.0),
                                         "ts": np.int64(0)}).build())
    pipe.add(wt.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build())
    pipe.chain(wt.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build())
    pipe.add(builder.withName(name).build()) \
        .add_sink(wt.Sink_Builder(sink).build())
    return g


def p13_families():
    """(e)'s host window families, by label: (builder factory, count or
    time windows)."""
    import windflow_tpu_torch as wt

    def nonin(items):
        return sum(t["v0"] for t in items)

    def kx(t):
        return t["key"]
    return {
        "(e) Keyed_Windows CB incremental": (lambda: wt.Keyed_Windows_Builder(
            lambda t, acc: (0.0 if acc is None else acc) + t["v0"])
            .withCBWindows(WIN, SLIDE).withKeyBy(kx).withParallelism(2),
            "cb"),
        "(e) Keyed_Windows TB": (lambda: wt.Keyed_Windows_Builder(nonin)
                                 .withTBWindows(*TELE_WIN)
                                 .withLateness(TELE_LATENESS)
                                 .withKeyBy(kx).withParallelism(2), "tb"),
        "(e) Parallel_Windows": (lambda: wt.Parallel_Windows_Builder(nonin)
                                 .withCBWindows(WIN, SLIDE).withKeyBy(kx)
                                 .withParallelism(2), "cb"),
        "(e) Paned_Windows (2, 2)": (lambda: wt.Paned_Windows_Builder(
            nonin, lambda panes: sum(panes)).withCBWindows(WIN, SLIDE)
            .withKeyBy(kx).withParallelisms(2, 2), "cb"),
        "(e) MapReduce_Windows (2, 2)": (lambda: wt.MapReduce_Windows_Builder(
            nonin, lambda parts: sum(parts)).withCBWindows(WIN, SLIDE)
            .withKeyBy(kx).withParallelisms(2, 2), "cb"),
        "(e) Ffat_Windows CB sum": (lambda: wt.Ffat_Windows_Builder(
            lambda t: t["v0"], lambda a, b: a + b)
            .withCBWindows(WIN, SLIDE).withKeyBy(kx).withParallelism(2),
            "cb"),
    }


def spike_readings(mod):
    """tests/test_models.py's readings at SPIKE_DEVICES devices: a spike
    (3x) every 50th reading of each device."""
    import random
    rnd = random.Random(9)
    out = []
    for i in range(SPIKE_DEVICES * SPIKE_READINGS):
        base = 10.0 + rnd.random()
        if (i // SPIKE_DEVICES) % 50 == 49:
            base *= 3.0
        out.append(mod.Reading(device=i % SPIKE_DEVICES, value=base))
    return out


def spike_oracle(readings, win, threshold):
    """Every (device, wid, average) flagged: count windows of ``win``
    readings sliding by 1 (EOS partials included), summed in arrival
    order, flagged when the last reading exceeds ``threshold`` × the
    mean."""
    import functools
    import operator
    per = {}
    for r in readings:
        per.setdefault(r.device, []).append(r.value)
    out = []
    for d, vals in per.items():
        for w in range(len(vals)):
            seg = vals[w:w + win]
            # left to right from 0.0, as the window's accumulator adds
            # (the builtin sum compensates since Python 3.12)
            s = functools.reduce(operator.add, seg, 0.0)
            if abs(seg[-1]) > threshold * abs(s / len(seg)):
                out.append((d, w, s / len(seg)))
    return sorted(out)


def p13_device_source(dev_name, keys, vals, ts):
    """(i)'s replayable source: (e)'s stream as one EVENT-time
    DeviceSource batch on the card."""
    import torch
    import windflow_tpu_torch as wt
    k = torch.from_numpy(keys).to(dev_name)
    v = torch.from_numpy(vals).to(dev_name)
    t = torch.from_numpy(ts).to(dev_name)
    return (wt.DeviceSource_Builder(lambda i: {"key": k, "v0": v})
            .withCapacity(len(keys)).withNumBatches(1)
            .withTimestampFn(lambda i: t, lambda i: int(ts.max()))
            .build())


def host_window_runs(dev_name="cuda"):
    """Phase 13 (90 s budget): the apps (a)-(d) through their own
    ``build()``, the host window families behind a card stage (e),
    spike_detection (f) and wordcount (g), the persistent operators (h)
    and preflight's durability findings (i); every output against a
    numpy or pure-Python oracle.  Returns each run's launch counts."""
    import collections
    import tempfile

    import windflow_tpu_torch as wt
    from windflow_tpu_torch.models import (ad_analytics, ffat_analytics,
                                           market_ticker, spike_detection,
                                           telemetry_frames, wordcount)
    from windflow_tpu_torch.persistent import (DBHandle,
                                               P_Keyed_Windows_Builder,
                                               P_Reduce_Builder)
    out = {}
    print(f"phase 13: {smi_line()}")

    # (a) ffat_analytics: 1,024 keys, count windows of 1,024 by 128
    n = CAP * BATCHES
    keys, vals = main_path_data(n, seed=131)
    rows = []
    g = ffat_analytics.build(
        ({"k": k, "v": v} for k, v in zip(keys, vals)), rows.append,
        win_len=WIN, slide=SLIDE, max_keys=KEYS, batch=CAP,
        config=p13_cfg(dev_name))
    p13_run("(a) ffat_analytics", g, n, out, need=("grouping_rank_hist",))
    keep = (keys & 7) != 7
    want = oracle(keys[keep], vals[keep] * np.float32(1.5) + np.float32(1.0))
    nrec = p13_equal("(a)", [(r["key"], r["wid"], r["value"]) for r in rows],
                     want)
    print(f"phase 13 (a): {nrec} windows (EOS partials included) equal the "
          "oracle")

    # (b) market_ticker: 1,024 symbols, the app's windows of 64 by 16, at
    # CAP; Python-float prices, the app's documented input (float32
    # values, so the oracle's float32 max/min is exact)
    n = CAP * TICK_BATCHES
    rng = np.random.default_rng(132)
    sym = rng.integers(0, TICK_SYMS, n).astype(np.int32)
    price = (10.0 + rng.random(n) * 90.0).astype(np.float32)
    rows = []
    g = market_ticker.build(
        ({"sym": s, "price": p}
         for s, p in zip(sym.tolist(), price.tolist())),
        rows.append, win_len=TICK_WIN[0], slide=TICK_WIN[1],
        max_symbols=TICK_SYMS, batch=CAP, config=p13_cfg(dev_name))
    p13_run("(b) market_ticker", g, n, out,
            need=("grouping_rank_hist", "sliding_fold"))
    nrec = p13_equal("(b)", [(r["sym"], r["wid"], (r["high"], r["low"]))
                             for r in rows],
                     ticker_oracle(sym, price, *TICK_WIN))
    print(f"phase 13 (b): {nrec} windows' high and low equal the numpy "
          "sliding max/min")

    # (c) ad_analytics at phase 4 (a)'s YSB shape
    n = CAP * 4
    table, ad, etype, ts = ysb_data(n, seed=133)
    counts = {}
    g = ad_analytics.build(
        ({"ad_id": a, "etype": e, "ts": t}
         for a, e, t in zip(ad, etype, ts.tolist())),
        table.tolist(),
        lambda c, w, k: counts.__setitem__((c, w), k),
        win_usec=YSB_WIN[0], slide_usec=YSB_WIN[1], batch=CAP,
        config=p13_cfg(dev_name))
    p13_run("(c) ad_analytics", g, n, out)
    views = etype == 1
    code = table[ad[views]].astype(np.int64) * (1 << 20) \
        + ts[views] // YSB_WIN[1]
    u, c = np.unique(code, return_counts=True)
    want = {(int(x >> 20), int(x & ((1 << 20) - 1))): int(k)
            for x, k in zip(u, c)}
    if counts != want:
        fail(f"phase 13 (c): {len(counts)} campaign windows, {len(want)} "
             "expected, or other counts")
    print(f"phase 13 (c): {len(counts)} campaign window counts exact")

    # (d) telemetry_frames at phase 4 (b)'s shape, FrameSource frames
    n = CAP * BATCHES
    tk, tv, tts = telemetry_data(n, seed=134)
    cols = []
    g = telemetry_frames.build(
        chunked(frame_blob(tk, tts, tv)), cols.append,
        win_usec=TELE_WIN[0], slide_usec=TELE_WIN[1], max_keys=TELE_KEYS,
        batch=CAP, lateness_usec=TELE_LATENESS, overflow_policy="drop",
        config=p13_cfg(dev_name))
    p13_run("(d) telemetry_frames", g, n, out)
    nrec = check_tb_records("phase 13 (d)", [c for c in cols
                                             if c is not None],
                            tk, tts, tv, *TELE_WIN)
    print(f"phase 13 (d): {nrec} windows equal tb_window_sums")

    # (e) host window families behind a card stage, one batch
    keys, vals = main_path_data(P13_N, seed=135)
    ts = np.arange(P13_N, dtype=np.int64) * TELE_GAP
    keep = (keys & 7) != 7
    v1 = vals[keep] * np.float32(1.5) + np.float32(1.0)
    want_cb = oracle(keys[keep], v1)
    codes, sums = tb_oracle(keys[keep], ts[keep], v1, *TELE_WIN)
    wids = tb_wids(ts[keep], TELE_WIN[1])
    want_tb = {(int(c // wids), int(c % wids)): float(s)
               for c, s in zip(codes, sums)}
    host = {}
    for label, (make, kind) in p13_families().items():
        rows = []
        g = host_window_graph(dev_name, make(), keys, vals, ts, rows,
                              "w" + str(len(host)))
        p13_run(label, g, P13_N, out)
        nrec = p13_equal(label, rows, want_cb if kind == "cb" else want_tb)
        if {type(k) for k, _, _ in rows} != {int}:
            fail(f"phase 13 {label}: keys came back as "
                 f"{ {type(k).__name__ for k, _, _ in rows} }")
        host[label] = sorted(rows)
        print(f"phase 13 {label}: {nrec} windows equal the oracle")
    rows = []
    g = host_window_graph(
        dev_name, wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"],
                                             lambda a, b: a + b)
        .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
        .withMaxKeys(KEYS).withSumCombiner(), keys, vals, ts, rows,
        "wgpu", gpu=True)
    p13_run("(e) Ffat_WindowsGPU sum", g, P13_N, out,
            need=("grouping_rank_hist", "sliding_fold"))
    if sorted((k, w, float(v)) for k, w, v in rows) \
            != host["(e) Ffat_Windows CB sum"]:
        fail("phase 13 (e): the host Ffat_Windows' records differ from "
             "Ffat_WindowsGPU withSumCombiner's")
    print(f"phase 13 (e): host Ffat_Windows equals Ffat_WindowsGPU "
          f"withSumCombiner record for record ({len(rows)} windows)")

    # (f) spike_detection
    readings = spike_readings(spike_detection)
    spikes = []
    g = spike_detection.build(readings, spikes.append, win_len=16, slide=1,
                              threshold=1.5, window_parallelism=2,
                              config=p13_cfg(dev_name))
    p13_run("(f) spike_detection", g, len(readings), out)
    got = sorted((s.device, s.window_id, s.average) for s in spikes)
    want = spike_oracle(readings, 16, 1.5)
    if got != want or not got:
        fail(f"phase 13 (f): {len(got)} detections, {len(want)} expected, "
             "or other ones")
    print(f"phase 13 (f): {len(got)} detections over "
          f"{len({d for d, _, _ in got})} devices equal the oracle")

    # (g) wordcount
    rng = np.random.default_rng(137)
    vocab = [f"w{i:04d}" for i in range(P13_VOCAB)]
    draws = rng.integers(0, P13_VOCAB, P13_WORDS)
    words = [vocab[i] for i in draws.tolist()]
    lines = [" ".join(words[i:i + 16]) for i in range(0, P13_WORDS, 16)]
    counts = {}
    g = wordcount.build(lines, lambda w, k: counts.__setitem__(w, k),
                        counter_parallelism=4, batch=P13_HOST_BATCH,
                        config=p13_cfg(dev_name))
    p13_run("(g) wordcount", g, P13_WORDS, out)
    if counts != dict(collections.Counter(words)):
        fail("phase 13 (g): the counts differ from collections.Counter")
    print(f"phase 13 (g): {len(counts)} words' counts equal "
          "collections.Counter")

    # (h) the persistent operators
    root = tempfile.mkdtemp(prefix="wf_phase13_")
    rows = []
    b = (P_Keyed_Windows_Builder(lambda items: sum(t["v0"] for t in items))
         .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
         .withParallelism(2).withDBPath(os.path.join(root, "pkw"))
         .withMaxInMemoryElements(P13_SPILL))
    g = host_window_graph(dev_name, b, keys, vals, ts, rows, "pkw")
    p13_run("(h) P_Keyed_Windows", g, P13_N, out)
    if sorted(rows) != host["(e) Keyed_Windows CB incremental"]:
        fail("phase 13 (h): P_Keyed_Windows differs from Keyed_Windows")
    op = [o for o in g._operators if o.name == "pkw"][0]
    spills = {k: kd.archive._next_frag for r in op.replicas
              for k, kd in r.engine.keys.items()}
    if len(spills) != len(set(keys[keep].tolist())) \
            or min(spills.values()) < 1:
        fail(f"phase 13 (h): a key never spilled: "
             f"{sorted(spills.items(), key=lambda kv: kv[1])[:4]}")
    print(f"phase 13 (h): P_Keyed_Windows equals Keyed_Windows "
          f"({len(rows)} windows); every one of {len(spills)} keys spilled "
          f"(fragments a key {min(spills.values())}-"
          f"{max(spills.values())})")

    def reduce_graph_p(lo, hi, path, name):
        def acc(t, s):
            s["n"] = s.get("n", 0) + 1
            s["sum"] = s.get("sum", 0.0) + t["v0"]

        def gen():
            yield from ({"key": k, "v0": v}
                        for k, v in zip(rkeys[lo:hi].tolist(),
                                        v1all[lo:hi].tolist()))
        g = wt.PipeGraph(name, config=p13_cfg(dev_name))
        g.add_source(wt.Source_Builder(gen)
                     .withOutputBatchSize(P13_HOST_BATCH).build()) \
            .add(P_Reduce_Builder(acc).withKeyBy(lambda t: t["key"])
                 .withParallelism(2).withDBPath(path).withInitialState(dict)
                 .withKeepDb().withOutputBatchSize(P13_HOST_BATCH)
                 .withName("preduce").build()) \
            .add_sink(wt.Sink_Builder(lambda t: None).build())
        return g

    def db_state(path):
        st = {}
        for i in range(2):
            db = DBHandle(path, initial_state=dict, whoami=i)
            st.update({k: db.get(k) for k in db.keys()})
            db.close()
        return st
    half = P13_REDUCE_N // 2
    rkeys = keys[:P13_REDUCE_N]
    v1all = vals[:P13_REDUCE_N] * np.float32(1.5) + np.float32(1.0)
    restarted, whole = os.path.join(root, "pr_a"), os.path.join(root, "pr_b")
    p13_run("(h) P_Reduce first half", reduce_graph_p(0, half, restarted,
                                                      "pr1"), half, out)
    p13_run("(h) P_Reduce restarted",
            reduce_graph_p(half, P13_REDUCE_N, restarted, "pr2"),
            P13_REDUCE_N - half, out)
    p13_run("(h) P_Reduce one run",
            reduce_graph_p(0, P13_REDUCE_N, whole, "pr3"), P13_REDUCE_N,
            out)
    sa, sb = db_state(restarted), db_state(whole)
    cnt = np.bincount(rkeys, minlength=KEYS)
    tot = np.bincount(rkeys, weights=v1all.astype(np.float64),
                      minlength=KEYS)
    want = {int(k): {"n": int(cnt[k]), "sum": float(tot[k])}
            for k in np.flatnonzero(cnt)}
    if sa != sb or sa != want:
        fail("phase 13 (h): the restarted P_Reduce's state differs from "
             "one run's or from the oracle")
    print(f"phase 13 (h): P_Reduce reopened its LogKV after a restart and "
          f"went on: {len(sa)} keys' state equals one run's and the oracle")
    shutil.rmtree(root, ignore_errors=True)

    # (i) preflight: (e)'s keyed CB graph, replayable, with durability
    g = wt.PipeGraph("p13i", wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT,
                     config=p13_cfg(dev_name, durability=os.path.join(
                         tempfile.gettempdir(), "wf_p13i_unused"),
                         durability_epoch_sweeps=8))
    pipe = g.add_source(p13_device_source(dev_name, keys, vals, ts))
    pipe.add(wt.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build())
    pipe.chain(wt.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build())
    pipe.add(p13_families()["(e) Keyed_Windows CB incremental"][0]()
             .withName("keyed_cb").build()) \
        .add_sink(wt.Sink_Builder(lambda r: None).build())
    found = [(d.code, d.node) for d in g.check()]
    if found != [("WF603", "keyed_cb")]:
        fail(f"phase 13 (i): check() found {found}")
    print("phase 13 (i): with a durability epoch cadence check() names "
          "the host window as WF603 and nothing else; (a)-(d) and (e)'s "
          "graphs checked clean")
    return out


# ---------------------------------------------------------------------------
# phase 14: the serving plane and the native host runtime
# ---------------------------------------------------------------------------

#: (a): background keys, the window state's key rows, the fixed ring
#: (max_keys * NP + 1 = 3,841 (key, pane) ids: under the grouping
#: kernel's 4,096-bucket gate), µs between tuples, 4 s windows by 1 s
P14_BG, P14_MAXK, P14_NP, P14_GAP = 64, 96, 40, 10
P14_WIN = (4 * 10 ** 6, 10 ** 6)
#: (a), (b), (d): tuples a run (full-width batches, cut in depth)
P14_N = CAP * BATCHES
#: (b): the split run's keys and its hot key's share
P14_SPLIT_KEYS, P14_HOT_SHARE = 64, 0.6
#: (c): the admission run's records (the per-record host path, cut in
#: depth), (d): the CSV run's records (its numpy twin parses in Python),
#: (e): the P_Reduce runs' tuples (a LogKV write a tuple)
P14_ADMIT_N, P14_CSV_N, P14_KV_N = CAP * 2, CAP * 2, CAP // 8


def p14_cfg(dev_name, **kw):
    import windflow_tpu_torch as wt
    base = dict(punctuation_interval_usec=10 ** 12, reshard_executor=True,
                reshard_check_sweeps=2, reshard_trigger_ticks=2,
                reshard_ok_ticks=2)
    base.update(kw)
    return wt.Config(device=dev_name, **base)


def p14_hot_pair(n_shards=3):
    """Two warm keys above the background range that the keyed staging
    edge places on one shard (``splitmix64(int32 key) % n``)."""
    from windflow_tpu_torch.parallel.emitters import splitmix64_int
    out = [k for k in range(P14_BG, P14_MAXK)
           if splitmix64_int(k) % n_shards == 0][:2]
    if len(out) != 2:
        fail("phase 14: no colocated warm pair in the key range")
    return out


def p14_move_data():
    """(a): 25% + 25% of the tuples on the warm pair, the rest spread
    over the background keys tuple by tuple, so every shard sees tuples
    in every pane; integer values (exact f32 sums)."""
    hot = p14_hot_pair()
    i = np.arange(P14_N)
    r = i % 20
    keys = np.where(r < 5, hot[0], np.where(r < 10, hot[1], i % P14_BG))
    vals = ((i * 7) % 9).astype(np.float64)
    ts = i.astype(np.int64) * P14_GAP
    return keys.astype(np.int64), ts, vals, hot


def p14_move_graph(dev_name, blob, sink_fn, k):
    """(a): FrameSource (EVENT time) → keyed TB ``Ffat_WindowsGPU``
    (generic ``a + b``, parallelism 3: one pane ring a replica) →
    columnar Sink, the executor on; ``k`` is ``megastep_sweeps``."""
    import windflow_tpu_torch as wt
    g = wt.PipeGraph("chip_smoke_p14_move", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT,
                     config=p14_cfg(dev_name, megastep_sweeps=k,
                                    reshard_imbalance_threshold=1.6))
    win = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
           .withTBWindows(*P14_WIN).withKeyBy(lambda t: t["key"])
           .withMaxKeys(P14_MAXK).withPaneCapacity(P14_NP)
           .withParallelism(3).withName("win").build())
    src = wt.FrameSource(chunked(blob), nv=1, output_batch_size=CAP,
                         record_spec={"key": np.int32(0),
                                      "v0": np.float32(0.0)})
    g.add_source(src).add(win).add_sink(
        wt.Sink_Builder(sink_fn).withColumnarSink().build())
    return g, win


def p14_run(label, g, n, out, need=(), native_need=()):
    """One ``PipeGraph.run()``, the launch counts and the native call
    counts set to 0 just before and read just after."""
    import torch

    from windflow_tpu_torch import native
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    fc.reset_launch_counts()
    native.reset_call_counts()
    t0 = time.perf_counter()
    g.run()
    if g.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, calls = fc.launch_counts(), native.call_counts()
    out[f"14{label}"] = counts
    for k in (need if g.device.type == "cuda" else ()):
        if counts[k] <= 0:
            fail(f"phase 14 {label}: {k} never launched: {counts}")
    for k in native_need:
        if calls.get(k, 0) <= 0:
            fail(f"phase 14 {label}: the native {k} was never entered "
                 f"({calls})")
    print(f"phase 14 {label}: {n} tuples in {secs:.3f} s = "
          f"{n / secs:.0f} tuples/s (host clock, information only); "
          f"launches {counts}; native calls {calls}")
    return secs


def p14_clone(tree):
    import torch

    from windflow_tpu_torch.utils.tree import tree_map
    return tree_map(torch.clone, tree)


def moved_row_replay_check(op, x, hot, dev, cap, k=8, seed=141):
    """A TB ring-row move under a captured K-step body: two rings (source
    and destination shard) stepped to the same clock, the destination's
    held as the static carry of a ``torch.cuda.graph`` capture of ``k``
    steps of ``op``'s own step, the executor's ``_move_ffat_rows`` moving
    ``hot``'s row into it, then one replay; against the same move and the
    same ``k`` steps run eagerly on copies.  Returns ``(equal, rows
    moved, launches a replay)``.  ``op``'s ``_states`` are put back."""
    import torch

    from windflow_tpu_torch.kernels.ffat_cuda import (CountedGraph,
                                                      uncounted)
    from windflow_tpu_torch.utils.tree import tree_flatten
    from windflow_tpu_torch.windows.ffat_kernels import (agg_spec_for,
                                                         make_ffat_tb_state)
    rng = np.random.default_rng(seed)
    P = op.P
    step = op._step_fn
    saved = op._states

    def batch(i, with_hot):
        keys = rng.integers(0, op.max_keys, cap)
        if not with_hot:
            keys = np.where(keys == hot, (hot + 1) % op.max_keys, keys)
        ts = (i * cap + np.arange(cap)) * (2 * P * 2 // cap + 1)
        return ({"key": torch.from_numpy(keys.astype(np.int32)).to(dev),
                 "v0": torch.from_numpy(rng.integers(0, 9, cap)
                                        .astype(np.float32)).to(dev)},
                torch.from_numpy(ts.astype(np.int64)).to(dev),
                torch.ones(cap, dtype=torch.bool, device=dev),
                int(ts.max()) // P - 4)

    def run_eager(carry, rows):
        outs = []
        for payload, ts, valid, wm in rows:
            carry, out, fired, out_ts, _ = step(carry, payload, ts, valid,
                                                 wm)
            outs.append((out, fired, out_ts))
        return carry, outs

    w0, w1 = batch(0, True), batch(0, False)
    spec = agg_spec_for(op.lift, w0[0])
    a = make_ffat_tb_state(spec, op.max_keys, op.NP, device=dev)
    b = make_ffat_tb_state(spec, op.max_keys, op.NP, device=dev)
    a, _ = run_eager(a, [w0])
    b, _ = run_eager(b, [w1])
    rows = [batch(1 + i, True) for i in range(k)]
    # the captured body reads its rows from static inputs
    xs = {"key": torch.stack([r[0]["key"] for r in rows]),
          "v0": torch.stack([r[0]["v0"] for r in rows]),
          "ts": torch.stack([r[1] for r in rows]),
          "valid": torch.stack([r[2] for r in rows]),
          "wm": torch.tensor([r[3] for r in rows], dtype=torch.int64,
                             device=dev)}
    xs_s = p14_clone(xs)

    def body(carry, xin):
        outs = []
        for i in range(k):
            carry, out, fired, out_ts, _ = step(
                carry, {"key": xin["key"][i], "v0": xin["v0"][i]},
                xin["ts"][i], xin["valid"][i], xin["wm"][i])
            outs.append((out, fired, out_ts))
        return carry, outs

    static = p14_clone(b)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side), uncounted():
        body(p14_clone(static), xs_s)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = CountedGraph(torch.cuda.CUDAGraph())
    with graph.capture(torch.cuda.graph(graph.graph)):
        new, ys = body(static, xs_s)
        for s, nw in zip(tree_flatten(static)[0], tree_flatten(new)[0]):
            if s is not nw:
                s.copy_(nw)
    src_i, dst_i = 0, 1
    mv = [{"key": hot, "from_shard": src_i, "to_shard": dst_i,
           "est_tuples": 1}]
    try:
        before = x.rows_moved
        op._states = {src_i: p14_clone(a), dst_i: static}
        x._move_ffat_rows(op, mv)
        moved = x.rows_moved - before
        with uncounted():
            graph.replay()
        got = [tuple(p14_clone(t) for t in y) for y in ys]
        got_carry = p14_clone(static)
        op._states = {src_i: p14_clone(a), dst_i: p14_clone(b)}
        x._move_ffat_rows(op, mv)
        with uncounted():
            want_carry, want = run_eager(op._states[dst_i], rows)
        torch.cuda.synchronize()
    finally:
        op._states = saved
    eq = all(torch.equal(g_, w_) for gy, wy in zip(got, want)
             for gl, wl in zip(gy, wy)
             for g_, w_ in zip(tree_flatten(gl)[0], tree_flatten(wl)[0]))
    eq = eq and all(torch.equal(g_, w_) for g_, w_ in zip(
        tree_flatten(got_carry)[0], tree_flatten(want_carry)[0]))
    fired = sum(int(y[1].sum()) for y in got)
    return eq and fired > 0, moved, graph.launches_per_replay()


def p14_ingest_graph(dev_name, blob, fmt, sink_fn):
    """(d): FrameSource (``fmt`` chunks, EVENT time) → phase 5's
    ``cb_tail`` with ``withSumCombiner``."""
    import windflow_tpu_torch as wt
    src = wt.FrameSource(chunked(blob), nv=1, fmt=fmt,
                         output_batch_size=CAP,
                         record_spec={"key": np.int32(0),
                                      "v0": np.float32(0.0)})
    g = wt.PipeGraph("chip_smoke_p14_ingest", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT,
                     config=wt.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    cb_tail(g.add_source(src), True, sink_fn)
    return g


def p14_tenant_graph(dev_name, tenant, keys, vals, budget=0):
    """(f): one tenant's graph: Source → keyed ReduceGPU (declared max)
    → Sink under ``tenant``, with an HBM budget of ``budget`` bytes."""
    import torch

    import windflow_tpu_torch as wt

    def gen():
        yield from ({"key": k, "v0": v} for k, v in zip(keys, vals))
    g = wt.PipeGraph(f"chip_smoke_p14_{tenant}",
                     config=wt.Config(device=dev_name, tenant=tenant,
                                      hbm_budget_bytes=budget,
                                      punctuation_interval_usec=10 ** 12))
    g.add_source(wt.Source_Builder(gen).withOutputBatchSize(CAP // 16)
                 .build()) \
        .add(wt.ReduceGPU_Builder(
            lambda a, b: {"key": torch.maximum(a["key"], b["key"]),
                          "v0": torch.maximum(a["v0"], b["v0"])})
            .withKeyBy(lambda t: t["key"]).withMonoidCombiner("max")
            .withMaxKeys(KEYS).build()) \
        .add_sink(wt.Sink_Builder(lambda r: None).build())
    return g


def serving_runs(dev_name="cuda"):
    """Phase 14 (45 s budget): the reshard executor's move_keys on
    per-replica TB rings (a) at K = 1 and K = 8 and under a captured
    K-step body, split_hot_key on the columnar keyed staging (b),
    admission control (c), the native ingest (d) and KV (e), the tenant
    scheduler and the executor's postmortem section (f); every output
    against an oracle.  Returns each run's launch counts."""
    import torch

    import windflow_tpu_torch as wt
    from windflow_tpu_torch import native
    from windflow_tpu_torch.analysis import tenancy
    from windflow_tpu_torch.io import parse
    from windflow_tpu_torch.monitoring.tenant_ledger import default_ledger
    from windflow_tpu_torch.persistent import DBHandle, P_Reduce_Builder
    from windflow_tpu_torch.serving.tenant_scheduler import TenantScheduler
    out = {}
    smi = smi_line()
    print(f"phase 14: {smi}")
    if not native.is_available():
        fail(f"phase 14: the native library is not available: "
             f"{native.build_error()}")

    # (a) move_keys on per-replica TB rings, K = 1 and K = 8
    keys, ts, vals, hot = p14_move_data()
    blob = frame_blob(keys, ts, vals)
    recs = {}
    for k in (1, 8):
        cols = []
        g, win = p14_move_graph(dev_name, blob, lambda c: cols.append(c)
                                if c is not None else None, k)
        p14_run(f"(a) move_keys K={k}", g, P14_N, out,
                need=("grouping_rank_hist",),
                native_need=("parse_frames", "keyby_partition"))
        nrec = check_tb_records(f"phase 14 (a) K={k}", cols, keys, ts, vals,
                                *P14_WIN)
        st = win.dump_stats()
        if [st[c] for c in ("Late_tuples_dropped", "Pane_cells_evicted",
                            "Windows_dropped_on_overflow")] != [0, 0, 0]:
            fail(f"phase 14 (a) K={k}: late, evicted or dropped tuples")
        rs = g.stats()["Reshard"]
        if rs["keys_moved"] < 1 or rs["rows_moved"] < 1 \
                or rs["moves_skipped"] >= rs["keys_moved"]:
            fail(f"phase 14 (a) K={k}: moved {rs['keys_moved']} keys, "
                 f"{rs['rows_moved']} rows, skipped {rs['moves_skipped']}: "
                 f"{rs['timeline']}")
        if k == 1:
            pm_graph = g        # (f) writes its postmortem bundle
        recs[k] = np.sort(np.concatenate(
            [np.asarray(c.cols["key"]).astype(np.int64) * (1 << 32)
             + np.asarray(c.cols["wid"]) for c in cols]))
        ms = g.stats()["Megastep"]
        print(f"phase 14 (a) K={k}: {nrec} windows equal the oracle; "
              f"{rs['keys_moved']} key(s) moved, {rs['rows_moved']} ring "
              f"row(s) re-homed in place, {rs['moves_skipped']} skipped, "
              f"{rs['clock_reads']} ring-clock read(s), quiesce "
              f"{rs['quiesce_ms_total']} ms in all; Megastep edges "
              f"{len(ms['edges'])} (the plane forms no group on a keyed "
              "fan-out, as in the JAX package)")
        if k == 8 and dev_name == "cuda":
            ok, moved, per = moved_row_replay_check(
                win, g._reshard, hot[0], torch.device(dev_name), CAP)
            if not ok or moved != 1:
                fail("phase 14 (a): the captured K = 8 body's replay after "
                     "an in-place row move differs from the eager run")
            print(f"phase 14 (a): a ring row moved in place into a "
                  f"captured K = 8 TB body's static carry; its replay "
                  f"({per} kernel launches a replay) equals the eager "
                  "K steps after the same move, output and carry")
    if not np.array_equal(recs[1], recs[8]):
        fail("phase 14 (a): K = 8 records differ from K = 1")

    # (b) split_hot_key: columnar keyed staging → declared-sum ReduceGPU
    rng = np.random.default_rng(142)
    bkeys = np.where(rng.random(P14_N) < P14_HOT_SHARE, 3,
                     rng.integers(0, P14_SPLIT_KEYS, P14_N))
    bvals = rng.integers(0, 9, P14_N).astype(np.float64)
    rec = np.empty(P14_N, dtype=[("k", "<i8"), ("t", "<i8"),
                                 ("v", "<f8", (2,))])
    rec["k"], rec["t"] = bkeys, np.arange(P14_N) * P14_GAP
    rec["v"][:, 0], rec["v"][:, 1] = bvals, 1.0
    sums = {}

    def split_sink(c):
        if c is None:
            return
        kk = np.asarray(c.cols["key"]).astype(np.int64) \
            // np.asarray(c.cols["n"]).astype(np.int64)
        for key, v in zip(kk.tolist(), np.asarray(c.cols["v0"]).tolist()):
            sums[key] = sums.get(key, 0.0) + v
    g = wt.PipeGraph("chip_smoke_p14_split", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT,
                     config=p14_cfg(dev_name,
                                    reshard_imbalance_threshold=1.25))
    red = (wt.ReduceGPU_Builder(lambda a, b: {"key": a["key"] + b["key"],
                                              "v0": a["v0"] + b["v0"],
                                              "n": a["n"] + b["n"]})
           .withKeyBy(lambda t: t["key"]).withMonoidCombiner("sum")
           .withMaxKeys(P14_SPLIT_KEYS).withParallelism(3)
           .withName("sred").build())
    g.add_source(wt.FrameSource(chunked(rec.tobytes()), nv=2,
                                fields=["v0", "n"], output_batch_size=CAP)) \
        .add(red).add_sink(wt.Sink_Builder(split_sink).withColumnarSink()
                           .build())
    p14_run("(b) split_hot_key", g, P14_N, out,
            need=("dense_monoid_table",),
            native_need=("parse_frames", "keyby_partition"))
    rs = g.stats()["Reshard"]
    want = {k_: float(bvals[bkeys == k_].sum())
            for k_ in np.unique(bkeys).tolist()}
    if rs["splits_applied"] < 1 or rs["preagg_folds"] <= 0:
        fail(f"phase 14 (b): no split engaged: {rs['timeline']}")
    if sums != want:
        fail("phase 14 (b): the per-key totals differ from the oracle")
    print(f"phase 14 (b): split_hot_key engaged ({rs['splits_applied']} "
          f"split(s), {rs['preagg_folds']} tuples folded at the staging "
          f"boundary, {rs['keys_moved']} key(s) moved first); "
          f"{len(want)} per-key totals equal the oracle")

    # (c) admission control: no applicable plan (undeclared reduce, a
    #     dominant key in the first half, uniform after); the source
    #     pulls 1/64 of a batch a sweep, so the dominant half spans 32
    #     executor ticks
    rng = np.random.default_rng(143)
    half = P14_ADMIT_N // 2
    ckeys = np.concatenate([np.where(rng.random(half) < 0.6, 5,
                                     rng.integers(0, P14_SPLIT_KEYS, half)),
                            rng.integers(0, P14_SPLIT_KEYS,
                                         P14_ADMIT_N - half)])
    cvals = rng.integers(0, 9, P14_ADMIT_N).astype(np.float32)
    csum = {}

    def admit_sink(c):
        if c is None:
            return
        for key, v in zip(np.asarray(c.cols["key"]).tolist(),
                          np.asarray(c.cols["v0"]).tolist()):
            csum[key] = csum.get(key, 0.0) + v

    def gen():
        yield from ({"key": k, "v0": v} for k, v in
                    zip(ckeys.tolist(), cvals.tolist()))
    g = wt.PipeGraph("chip_smoke_p14_admit",
                     config=p14_cfg(dev_name, source_tick_chunk=CAP // 64,
                                    reshard_imbalance_threshold=1.25))
    g.add_source(wt.Source_Builder(gen).withOutputBatchSize(CAP).build()) \
        .add(wt.ReduceGPU_Builder(lambda a, b: {"key": a["key"],
                                                "v0": a["v0"] + b["v0"]})
             .withKeyBy(lambda t: t["key"]).withParallelism(3)
             .withName("ured").build()) \
        .add_sink(wt.Sink_Builder(admit_sink).withColumnarSink().build())
    p14_run("(c) admission", g, P14_ADMIT_N, out)
    rs = g.stats()["Reshard"]
    lows = [float(e["detail"].rsplit(" ", 1)[-1])
            for e in rs["timeline"] if e["event"] == "admission"
            and "throttled" in e["detail"]]
    if rs["admission_throttles"] < 1 or not lows or min(lows) >= 1.0:
        fail(f"phase 14 (c): admission never throttled: {rs['timeline']}")
    if rs["admission_factor"] != 1.0:
        fail(f"phase 14 (c): admission did not recover "
             f"({rs['admission_factor']})")
    want = {k_: float(cvals[ckeys == k_].astype(np.float64).sum())
            for k_ in np.unique(ckeys).tolist()}
    if csum != want:
        fail("phase 14 (c): the per-key totals differ from the oracle")
    print(f"phase 14 (c): admission throttled {rs['admission_throttles']} "
          f"time(s), down to {min(lows)}, and recovered to 1.0; "
          f"{len(want)} per-key totals equal the oracle")

    # (d) native ingest: frames and CSV through FrameSource into the CB
    #     windows, against the same graph on the numpy parsers
    keys_d, vals_d = main_path_data(P14_N, seed=144)
    ts_d = np.arange(P14_N, dtype=np.int64)
    fblob = frame_blob(keys_d, ts_d, vals_d)
    csv_keys, csv_vals = keys_d[:P14_CSV_N], vals_d[:P14_CSV_N]
    cblob = "".join(f"{k},{t},{v:g}\n" for k, t, v in zip(
        csv_keys.tolist(), ts_d[:P14_CSV_N].tolist(),
        csv_vals.tolist())).encode()
    for fmt, blob_d, n in (("frames", fblob, P14_N),
                           ("csv", cblob, P14_CSV_N)):
        res = {}
        for nat in (True, False):
            cols = []
            if not nat:
                os.environ["WF_TPU_NO_NATIVE"] = "1"
            try:
                g = p14_ingest_graph(dev_name, blob_d, fmt, lambda c:
                                     cols.append(c) if c is not None
                                     else None)
                p14_run(f"(d) {fmt} {'native' if nat else 'numpy'}", g, n,
                        out, need=("grouping_rank_hist", "sliding_fold"),
                        native_need=(f"parse_{fmt}",) if nat else ())
                if not nat and native.call_counts():
                    fail("phase 14 (d): WF_TPU_NO_NATIVE run entered the "
                         "native library")
            finally:
                os.environ.pop("WF_TPU_NO_NATIVE", None)
            res[nat] = cols
        nrec = check_cb_columns(f"phase 14 (d) {fmt}", res[True],
                                keys_d[:n], vals_d[:n])
        for name in ("key", "wid", "value"):
            if not np.array_equal(cat_cols(res[True], name),
                                  cat_cols(res[False], name)):
                fail(f"phase 14 (d) {fmt}: native records differ from the "
                     f"numpy parser's ({name})")
        chunks = list(chunked(blob_d)())
        t_parse = {}
        for nat, fn in ((True, getattr(native, f"parse_{fmt}")),
                        (False, getattr(parse, f"parse_{fmt}"))):
            t0 = time.perf_counter()
            carry = b""
            for c in chunks:
                buf = carry + c
                _, _, _, used = fn(buf, 1)
                carry = buf[used:]
            t_parse[nat] = (time.perf_counter() - t0) * 1e3 / (n / CAP)
        print(f"phase 14 (d) {fmt}: {nrec} windows equal the oracle and "
              f"the numpy parser's run; "
              f"parse {t_parse[True]:.2f} ms a batch native, "
              f"{t_parse[False]:.2f} ms numpy ({smi}; host clock, "
              "information only)")

    # (e) native KV: P_Reduce on each backend, each store reopened
    #     under the other
    root = tempfile.mkdtemp(prefix="wf_phase14_")
    ekeys = keys_d[:P14_KV_N]
    evals = vals_d[:P14_KV_N].astype(np.float64)

    def preduce(path, name):
        def acc(t, s):
            s["n"] = s.get("n", 0) + 1
            s["sum"] = s.get("sum", 0.0) + t["v0"]

        def gen():
            yield from ({"key": k, "v0": v}
                        for k, v in zip(ekeys.tolist(), evals.tolist()))
        g = wt.PipeGraph(name, config=p14_cfg(dev_name,
                                              reshard_executor=False))
        g.add_source(wt.Source_Builder(gen).withOutputBatchSize(1024)
                     .build()) \
            .add(P_Reduce_Builder(acc).withKeyBy(lambda t: t["key"])
                 .withParallelism(2).withDBPath(path).withInitialState(dict)
                 .withKeepDb().withOutputBatchSize(1024)
                 .withName("preduce").build()) \
            .add_sink(wt.Sink_Builder(lambda t: None).build())
        return g

    def db_state(path):
        st, backends = {}, set()
        for i in range(2):
            db = DBHandle(path, initial_state=dict, whoami=i)
            backends.add(type(db._kv._kv).__name__)
            st.update({k: db.get(k) for k in db.keys()})
            db.close()
        return st, backends
    cnt = np.bincount(ekeys, minlength=KEYS)
    tot = np.bincount(ekeys, weights=evals, minlength=KEYS)
    want = {int(k): {"n": int(cnt[k]), "sum": float(tot[k])}
            for k in np.flatnonzero(cnt)}
    rate = {}
    # a warm-up run first: the two timed runs both start warm
    g = preduce(os.path.join(root, "warm"), "p14e_warm")
    g.run()
    for nat in (True, False):
        path = os.path.join(root, "native" if nat else "python")
        if not nat:
            os.environ["WF_TPU_NO_NATIVE"] = "1"
        try:
            secs = p14_run(f"(e) P_Reduce {'native' if nat else 'python'}",
                           preduce(path, f"p14e{int(nat)}"), P14_KV_N, out,
                           native_need=("kv_open", "kv_put") if nat else ())
        finally:
            os.environ.pop("WF_TPU_NO_NATIVE", None)
        rate[nat] = P14_KV_N / secs
        # reopen under the other backend
        if nat:
            os.environ["WF_TPU_NO_NATIVE"] = "1"
        try:
            st, backends = db_state(path)
        finally:
            os.environ.pop("WF_TPU_NO_NATIVE", None)
        other = {"_PyKV"} if nat else {"_NativeKV"}
        if backends != other or st != want:
            fail(f"phase 14 (e): the store written on the "
                 f"{'native' if nat else 'Python'} backend reads other "
                 f"values under {backends}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 14 (e): P_Reduce states equal the oracle with each "
          f"store reopened under the other backend; {rate[True]:.0f} "
          f"tuples/s on the native LogKV, {rate[False]:.0f} on the Python "
          f"one (phase 13's P_Reduce, PERF.md: 16-26 K on the Python log; "
          f"{smi}; host clock, information only)")

    # (f) the tenant scheduler, and the executor's postmortem section
    default_ledger().reset()
    rng = np.random.default_rng(145)
    # tenant_a over a 1-byte HBM budget (its reduce's tables are
    # resident), tenant_b without one
    tg = [p14_tenant_graph(dev_name, t, rng.integers(0, KEYS, CAP // 4),
                           rng.integers(0, 9, CAP // 4).astype(np.float32),
                           budget=b)
          for t, b in (("tenant_a", 1), ("tenant_b", 0))]
    for i, g in enumerate(tg):
        p14_run(f"(f) tenant {i}", g, CAP // 4, out,
                need=("dense_monoid_table",))
    for _ in range(4):
        default_ledger().tick(tenant="tenant_a", force=True)
    sec = tg[0].stats()["Tenant"]
    plan = tenancy.plan(sec)
    sched = TenantScheduler()
    queued = sched.ingest(plan)
    tenants = {row["tenant"] for row in plan["tenants"]}
    kinds = [a["kind"] for a in sched.pending()]
    if not {"tenant_a", "tenant_b"} <= tenants:
        fail(f"phase 14 (f): the plan names {tenants}")
    if sched.section()["plans_ingested"] != 1 or len(kinds) != queued \
            or "rescale_tenant" not in kinds \
            or {a["tenant"] for a in sched.pending()} != {"tenant_a"}:
        fail(f"phase 14 (f): the scheduler queued {sched.pending()}")
    first = sched.apply_next()
    d = tempfile.mkdtemp(prefix="wf_phase14_pm_")
    bundle = pm_graph.dump_postmortem(d, reason="phase 14")
    with open(os.path.join(bundle, "reshard.json")) as f:
        rj = json.load(f)
    r = tool("wf_doctor.py", bundle, "--check")
    if r.returncode != 0 or not rj.get("enabled") \
            or rj["plans_applied"] < 1:
        fail(f"phase 14 (f): wf_doctor --check: {r.stdout} {r.stderr}")
    shutil.rmtree(d, ignore_errors=True)
    print(f"phase 14 (f): the scheduler ingested the two-tenant plan "
          f"(tenancy/1: {queued} action(s) for the over-budget tenant, "
          f"{kinds}; the first popped, {first['kind']}); the postmortem's "
          f"reshard.json ({rj['plans_applied']} plan(s), "
          f"{len(rj['timeline'])} timeline entries) passes wf_doctor "
          "--check")
    default_ledger().reset()
    return out


# ---------------------------------------------------------------------------
# phase 15: the host worker pool
# ---------------------------------------------------------------------------

#: phase 15: pool sizes each run takes, the host window's tuples (cut in
#: depth: one tuple a message at ~35-60 K tuples/s on the card's host),
#: the P_Reduce's tuples, and the count-window run's batches (a K = 8
#: group needs a warm-up batch and eight more)
POOL_THREADS = (0, 4)
P15_WINDOW_N, P15_REDUCE_N, P15_BATCHES = CAP // 4, 16384, 9


def pool_reduce_graph(dev_name, keys, vals, path, name, threads):
    """Phase 15 (a): a host source (batches of 1,024) → a keyed
    ``P_Reduce`` at parallelism 2 over a ``LogKV`` in ``path`` → Sink:
    the graph phase 13 (h) restarts, on ``threads`` pool threads."""
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.persistent import P_Reduce_Builder

    def acc(t, st):
        st["n"] = st.get("n", 0) + 1
        st["sum"] = st.get("sum", 0.0) + t["v0"]

    def gen():
        yield from ({"key": k, "v0": v}
                    for k, v in zip(keys.tolist(), vals.tolist()))
    g = wt.PipeGraph(name, config=p13_cfg(dev_name,
                                          host_worker_threads=threads))
    g.add_source(wt.Source_Builder(gen)
                 .withOutputBatchSize(P13_HOST_BATCH).build()) \
        .add(P_Reduce_Builder(acc).withKeyBy(lambda t: t["key"])
             .withParallelism(2).withDBPath(path).withInitialState(dict)
             .withKeepDb().withOutputBatchSize(P13_HOST_BATCH)
             .withName("preduce").build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).build())
    return g


def pool_cb_graph(dev_name, blob, threads, direct, chain, **cfg):
    """Phase 15 (b): frames → phase 5's MapGPU | FilterGPU → the count
    windows (``withSumCombiner``) → a split by key parity written in
    torch ops: branch 0 straight into a Sink appending to ``direct``,
    branch 1 into a host FlatMap (each window, and its negation when the
    value is positive) → a host Map → a Sink appending to ``chain``.
    Returns ``(graph, {role: operator})``."""
    import windflow_tpu_torch as wt
    src = wt.FrameSource(chunked(blob), nv=1, fmt="frames",
                         output_batch_size=CAP,
                         record_spec={"key": np.int32(0),
                                      "v0": np.float32(0.0)})
    g = wt.PipeGraph("chip_smoke_pool", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT,
                     config=wt.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      host_worker_threads=threads, **cfg))
    pipe = g.add_source(src)
    pipe.add(wt.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build())
    pipe.chain(wt.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build())
    win = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
           .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
           .withMaxKeys(KEYS).withSumCombiner().withName("w").build())
    pipe.add(win)
    pipe.split(lambda r: r["key"] & 1, 2)

    def expand(r, shipper):
        shipper.push({"key": r["key"], "wid": r["wid"], "value": r["value"]})
        if r["value"] > 0:
            shipper.push({"key": r["key"], "wid": r["wid"],
                          "value": -r["value"]})
    snk0 = wt.Sink_Builder(lambda r: direct.append(
        (int(r["key"]), int(r["wid"]), float(r["value"])))
        if r is not None else None).withName("direct_sink").build()
    fm = wt.FlatMap_Builder(expand).withName("fm").build()
    mp = wt.Map_Builder(lambda r: (int(r["key"]), int(r["wid"]),
                                   float(r["value"]))).withName("hm").build()
    snk1 = wt.Sink_Builder(lambda r: chain.append(r) if r is not None
                           else None).withName("chain_sink").build()
    pipe.select(0).add_sink(snk0)
    pipe.select(1).add(fm).add(mp).add_sink(snk1)
    return g, {"window": win, "direct_sink": snk0, "flatmap": fm,
               "host_map": mp, "chain_sink": snk1}


# ---------------------------------------------------------------------------
# phase 16: the mesh (logical positions on the one card)
# ---------------------------------------------------------------------------

#: mesh positions of phase 16, all on the one card
MESH_POS = 4


def card_mesh(dev_name, data):
    from windflow_tpu_torch.parallel import mesh as M
    dev = dev_name if ":" in dev_name else dev_name + ":0"
    return M.make_mesh(MESH_POS, data=data, devices=[dev] * MESH_POS)


def sorted_cols(cols, names):
    """A run's columnar records as one lexicographically sorted array of
    rows (for run-against-run equality)."""
    a = np.stack([cat_cols(cols, n).astype(np.float64) for n in names], 1)
    return a[np.lexsort(a.T[::-1])]


def op_named(g, cls_name):
    return next(op for op in g._operators
                if type(op).__name__ == cls_name)


def audit_clean(label, g):
    au = g.stats()["IR_audit"]
    if au["findings"]:
        fail(f"{label}: the capture audit found {au['findings']}")
    return au["programs_audited"]


def mesh_frames_tb_graph(dev_name, blob, K, win, sink_fn, lateness=0,
                         **cfg):
    """FrameSource (EVENT time) → keyed time windows (generic ``a + b``,
    drop on overflow) → columnar Sink; ``cfg``: further Config fields."""
    import windflow_tpu_torch as wf
    op = (wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
          .withTBWindows(*win).withKeyBy(lambda t: t["key"])
          .withMaxKeys(K).withLateness(lateness).build())
    g = wf.PipeGraph("chip_smoke_mesh_tb", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.EVENT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      **cfg))
    g.add_source(wf.FrameSource(chunked(blob), nv=1,
                                output_batch_size=CAP,
                                record_spec={"key": np.int32(0),
                                             "v0": np.float32(0.0)})) \
        .add(wf.MapGPU_Builder(lambda t: t).build()).add(op) \
        .add_sink(wf.Sink_Builder(sink_fn).withColumnarSink(defer=4).build())
    return g, op


def mesh_reduce_graph(dev_name, blob, sink_fn, max_keys, monoid, keyed=True,
                      **cfg):
    """FrameSource → ReduceGPU (keyed by the frame key or global; dense
    ``withMaxKeys`` or arbitrary keys; ``monoid`` "sum", "max" or None for
    the generic fold, a max over both fields) → columnar Sink."""
    import torch
    import windflow_tpu_torch as wf
    if monoid == "sum":
        b = wf.ReduceGPU_Builder(lambda a, b: {"key": a["key"] + b["key"],
                                               "v0": a["v0"] + b["v0"]})
    else:
        b = wf.ReduceGPU_Builder(
            lambda a, b: {"key": torch.maximum(a["key"], b["key"]),
                          "v0": torch.maximum(a["v0"], b["v0"])})
    if keyed:
        b = b.withKeyBy(lambda t: t["key"])
    if max_keys is not None:
        b = b.withMaxKeys(max_keys)
    if monoid is not None:
        b = b.withMonoidCombiner(monoid)
    op = b.build()
    g = wf.PipeGraph("chip_smoke_mesh_reduce", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      **cfg))
    g.add_source(wf.FrameSource(chunked(blob), nv=1,
                                output_batch_size=CAP,
                                record_spec={"key": np.int32(0),
                                             "v0": np.float32(0.0)})) \
        .add(op).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink(defer=4)
                          .build())
    return g, op


def reduce_batches_check(label, cols, keys, vals, monoid, max_keys, keyed):
    """Each sink batch of a reduce run against its input batch's oracle:
    one record a distinct in-range key (or one for a global reduce), the
    summed or maxed fields; records compared as sets."""
    if len(cols) != BATCHES:
        fail(f"{label}: {len(cols)} sink batches, {BATCHES} expected")
    nrec = 0
    for i, c in enumerate(cols):
        sl = slice(i * CAP, (i + 1) * CAP)
        k, v = keys[sl], vals[sl]
        if max_keys is not None:
            m = (k >= 0) & (k < max_keys)
            k, v = k[m], v[m]
        if not keyed:
            k = np.zeros_like(k)
        if monoid == "sum":
            wk, wv = batch_reduce_oracle(k, v, "sum")
        else:
            wk, wv = batch_reduce_oracle(k, v, "max")
        want = sorted(zip(wk.tolist(), wv.astype(np.float64).tolist()))
        got = sorted(zip(np.asarray(c.cols["key"]).tolist(),
                         np.asarray(c.cols["v0"]).astype(np.float64)
                         .tolist()))
        if not keyed:
            # the global record's key field folds too: compare values
            want = [(0, w) for _, w in want]
            got = [(0, w) for _, w in got]
        if got != want:
            fail(f"{label}: batch {i}: {len(got)} records, {len(want)} "
                 "expected, or other values")
        nrec += len(got)
    return nrec


def aligned_keys(keys, kk, dd, K):
    """``keys`` (int32, CAP of them) laid out as the key-aligned emitter
    stages them: flat block ``b`` of ``CAP / (kk * dd)`` lanes belongs to
    key column ``b % kk``, which owns ``[c * K_local, (c + 1) * K_local)``."""
    K_local = K // kk
    col = (np.arange(len(keys)) // (len(keys) // (kk * dd))) % kk
    return (col * K_local + keys % K_local).astype(np.int32)


def mesh_steps_no_host_read(dev_name, keys, vals):
    """Every sharded step on one batch of the main path at 2x2, two warm
    steps then one under ``set_sync_debug_mode("error")``: CB (both
    combiners), TB, the dense reduce under psum, pmax, pmin and the
    generic fold, its aligned ingest, the arbitrary-key all_to_all reduce,
    and the stateful step (the associative body) under the data ingest
    (its psum merge across key shards) and the aligned one."""
    import torch
    from windflow_tpu_torch.ops.gpu_stateful import _assoc_body
    from windflow_tpu_torch.parallel import mesh as M
    dev = torch.device(dev_name)
    mesh = card_mesh(dev_name, 2)
    kk, dd = mesh.shape["key"], mesh.shape["data"]
    k = torch.as_tensor(keys[:CAP], device=dev)
    v = torch.as_tensor(vals[:CAP], device=dev)
    payload = {"key": k, "v0": v}
    ak = torch.as_tensor(aligned_keys(keys[:CAP], kk, dd, KEYS), device=dev)
    aligned = {"key": ak, "v0": v}
    ts = torch.arange(CAP, dtype=torch.int64, device=dev)
    valid = torch.ones(CAP, dtype=torch.bool, device=dev)
    # count windows of 64 sliding by 16: the three steps fire windows
    R = 4
    cases = []
    for monoid in (None, "sum"):
        st = M.make_sharded_ffat_state(torch.zeros((), dtype=torch.float32),
                                       KEYS, R, mesh)
        step = M.make_sharded_ffat_step(
            mesh, CAP, KEYS, 16, R, 1, lambda t: t["v0"],
            lambda a, b: a + b, lambda t: t["key"], monoid=monoid,
            kernels=True)
        holder = [st]

        def cb(step=step, holder=holder):
            holder[0], out, fired, _ = step(holder[0], payload, ts, valid)
            return fired
        cases.append((f"CB {'sum' if monoid else 'generic'}", cb))
    tbst = [M.make_sharded_ffat_tb_state(
        torch.zeros((), dtype=torch.float32), TBC_KEYS, TBC_NP, mesh)]
    tbstep = M.make_sharded_ffat_tb_step(
        mesh, CAP, TBC_KEYS, TBC_WIN[1], TBC_R, 1, TBC_NP,
        lambda t: t["v0"], lambda a, b: a + b, lambda t: t["key"],
        drop_tainted=True, kernels=True)
    tbk = (k % TBC_KEYS).contiguous()
    tick = [0]

    def tb():
        base = tick[0] * CAP * TBC_GAP
        tick[0] += 1
        tbst[0], out, fired, _, _ = tbstep(
            tbst[0], {"key": tbk, "v0": v}, ts * TBC_GAP + base, valid,
            base // TBC_WIN[1])
        return fired
    cases.append(("TB", tb))
    folds = {"psum": ("sum", torch.add), "pmax": ("max", torch.maximum),
             "pmin": ("min", torch.minimum),
             "generic fold": (None, torch.maximum)}
    for name, (monoid, op) in folds.items():
        comb = lambda a, b, op=op: {"key": op(a["key"], b["key"]),  # noqa
                                    "v0": op(a["v0"], b["v0"])}
        red = M.make_sharded_reduce_step(mesh, CAP, KEYS, comb,
                                         lambda t: t["key"], monoid=monoid,
                                         kernels=True)
        cases.append((f"reduce {name}",
                      lambda red=red: red(payload, ts, valid)[2]))
    comb = lambda a, b: {"key": torch.maximum(a["key"], b["key"]),  # noqa
                         "v0": torch.maximum(a["v0"], b["v0"])}
    red_a = M.make_sharded_reduce_step(mesh, CAP, KEYS, comb,
                                       lambda t: t["key"], monoid="max",
                                       ingest="aligned", kernels=True)
    cases.append(("reduce aligned pmax",
                  lambda: red_a(aligned, ts, valid)[2]))
    arb = M.make_sharded_reduce_arbitrary(mesh, CAP, comb,
                                          lambda t: t["key"])
    cases.append(("reduce all_to_all", lambda: arb(payload, ts, valid)[2]))
    lift = lambda t: {"n": torch.ones_like(t["key"]), "sum": t["v0"]}  # noqa
    scomb = lambda a, b: {"n": a["n"] + b["n"],  # noqa: E731
                          "sum": a["sum"] + b["sum"]}
    project = lambda t, s: {"key": t["key"], "n": s["n"],  # noqa: E731
                            "sum": s["sum"]}
    for ingest, pl in (("data", payload), ("aligned", aligned)):
        sstep = M.make_sharded_stateful_step(
            mesh, CAP, KEYS,
            lambda cap, S: _assoc_body(lift, scomb, project, cap, S, False),
            lambda t: t["key"], True, False, ingest=ingest)
        sst = [M.shard_state({"n": torch.zeros(KEYS, dtype=torch.int32),
                              "sum": torch.zeros(KEYS)}, mesh)]

        def stateful(sstep=sstep, sst=sst, pl=pl):
            sst[0], out, ok = sstep(sst[0], pl, valid)
            return ok
        cases.append((f"stateful {ingest} ingest", stateful))
    for label, fn in cases:
        fn()
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        except RuntimeError as e:
            fail(f"phase 16 (a): the sharded {label} step synchronised: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if not bool(out.any()):
            fail(f"phase 16 (a): the sharded {label} step gave nothing")
    return [c[0] for c in cases]


def mesh_runs(dev_name="cuda"):
    """Phase 16: the mesh on the card (60 s budget); returns the launch
    counts by run label."""
    import torch
    import torch.distributed as dist
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.parallel import mesh as M
    from windflow_tpu_torch.parallel import multihost
    out = {}
    shapes = {"1x4": card_mesh(dev_name, 1), "2x2": card_mesh(dev_name, 2)}
    n = CAP * BATCHES
    keys, vals = main_path_data(n, seed=2016)
    blob = frame_blob(keys, np.arange(n), vals)

    # (a) the main path, both combiners, on no mesh, 1x4 and 2x2
    for sum_comb in (False, True):
        comb = "sum" if sum_comb else "generic"
        ref = None
        for shape in (None, "1x4", "2x2"):
            label = f"16(a) {comb} {shape or 'no mesh'}"
            cols, sink = collect()
            g, _ = frames_cb_graph(dev_name, sum_comb, blob, sink,
                                   mesh=shapes.get(shape))
            secs, counts = timed_run(g)
            out[label] = counts
            nrec = check_cb_columns(label, cols, keys, vals)
            rows = sorted_cols(cols, ("key", "wid", "value"))
            if ref is None:
                ref = rows
            elif not np.array_equal(rows, ref):
                fail(f"{label}: records differ from the run with no mesh")
            extra = ""
            if shape is not None:
                per = BATCHES * MESH_POS
                if counts["grouping_rank_hist"] != per:
                    fail(f"{label}: grouping_rank_hist launched "
                         f"{counts['grouping_rank_hist']} times, {per} "
                         f"({MESH_POS} positions x {BATCHES} steps) "
                         "expected")
                if counts["sliding_fold"] != (per if sum_comb else 0):
                    fail(f"{label}: sliding_fold launched "
                         f"{counts['sliding_fold']} times")
                win = op_named(g, "FfatWindowsGPU")
                if not win._states[0].equal_across_data():
                    fail(f"{label}: the data rows hold different state")
                progs = audit_clean(label, g)
                extra = (f"; key shards' state equal along data; audit "
                         f"clean ({progs} programs)")
            print(f"phase 16: PipeGraph.run() {label}: {nrec} windows "
                  f"match the oracle and the run with no mesh; {n} tuples "
                  f"in {secs:.3f} s = {n / secs:.0f} tuples/s (host clock, "
                  f"information only); launches {counts}{extra}")
    checked = mesh_steps_no_host_read(dev_name, keys, vals)
    print(f"phase 16 (a): the sharded {', '.join(checked)} steps make no "
          "host read (set_sync_debug_mode('error'))")

    # (b) time windows on the mesh: the telemetry stream, and phase 4
    #     (c)'s shape whose (key, pane) ids stay under the grouping gate
    tk, tv, tts = telemetry_data(n)
    rng = np.random.default_rng(16)
    ck = rng.integers(0, TBC_KEYS, n).astype(np.int32)
    cv = rng.integers(-100, 101, n).astype(np.float32)
    cts = np.arange(n, dtype=np.int64) * TBC_GAP
    for name, (bk, bts, bv), K, win, late in (
            ("telemetry", (tk, tts, tv), TELE_KEYS, TELE_WIN, TELE_LATENESS),
            ("grouping kernel", (ck, cts, cv), TBC_KEYS, TBC_WIN, 0)):
        tblob = frame_blob(bk, bts, bv)
        ref = None
        for shape in (None, "1x4"):
            label = f"16(b) TB {name} {shape or 'no mesh'}"
            cols, sink = collect()
            g, op = mesh_frames_tb_graph(dev_name, tblob, K, win, sink,
                                         lateness=late,
                                         mesh=shapes.get(shape))
            secs, counts = timed_run(g)
            out[label] = counts
            nrec = check_tb_records(label, cols, bk, bts, bv, *win)
            st = op.dump_stats()
            lost = [st[k] for k in ("Late_tuples_dropped",
                                    "Pane_cells_evicted",
                                    "Windows_dropped_on_overflow")]
            if lost != [0, 0, 0]:
                fail(f"{label}: late / evicted / dropped {lost}")
            rows = sorted_cols(cols, ("key", "wid", "value"))
            if ref is None:
                ref = rows
            elif not np.array_equal(rows, ref):
                fail(f"{label}: records differ from the run with no mesh")
            if shape is not None and name == "grouping kernel" \
                    and counts["grouping_rank_hist"] < BATCHES * MESH_POS:
                fail(f"{label}: grouping_rank_hist launched "
                     f"{counts['grouping_rank_hist']} times")
            print(f"phase 16: PipeGraph.run() {label}: ring NP {op.NP}; "
                  f"{nrec} windows match the oracle and the run with no "
                  f"mesh, no late, evicted or dropped; {secs:.3f} s; "
                  f"launches {counts}")

    # (c) the reduce on the mesh
    rk = rng.integers(0, KEYS, n).astype(np.int64)
    rv = rng.integers(-100, 101, n).astype(np.float32)
    ak = rng.choice(np.array([2 ** 31 - 1, -2 ** 31, -7, 0, 12345,
                              2 ** 30 + 3, 99, -123456], np.int64), n)
    ok = rng.integers(0, 1100, n).astype(np.int64)
    cases = [("psum", rk, "sum", KEYS, True),
             ("pmax", rk, "max", KEYS, True),
             ("generic fold", rk, None, KEYS, True),
             ("arbitrary int32 keys", ak, None, None, True),
             ("out-of-range keys", ok, "max", KEYS, True),
             ("global", rk, "sum", None, False)]
    for name, ck_, monoid, mk, keyed in cases:
        rblob = frame_blob(ck_, np.arange(n), rv)
        ref = None
        for shape in (None, "2x2"):
            label = f"16(c) reduce {name} {shape or 'no mesh'}"
            cols, sink = collect()
            # the data-sharded ingest: aligned ingest batches by column
            # fill, which moves the per-batch record cadence ((e) runs it)
            cfg = {"mesh": shapes.get(shape), "key_aligned_ingest": False}
            if shape is None and monoid is not None and mk is not None:
                # the single-device dense route: drops out-of-range keys
                # as the mesh's dense tables do
                cfg["key_compaction"] = False
            g, op = mesh_reduce_graph(dev_name, rblob, sink, mk, monoid,
                                      keyed=keyed, **cfg)
            secs, counts = timed_run(g)
            out[label] = counts
            nrec = reduce_batches_check(label, cols, ck_, rv, monoid, mk,
                                        keyed)
            rows = sorted_cols(cols, ("key", "v0"))
            if ref is None:
                ref = rows
            elif not np.array_equal(rows, ref):
                fail(f"{label}: records differ from the run with no mesh")
            extra = ""
            if name == "out-of-range keys":
                want = int(((ck_ < 0) | (ck_ >= KEYS)).sum())
                got = op.num_dropped_tuples()
                if got != want:
                    fail(f"{label}: dropped {got}, {want} expected")
                extra = f"; dropped and counted {got}"
            if name == "arbitrary int32 keys" and 2 ** 31 - 1 not in \
                    cat_cols(cols, "key").tolist():
                fail(f"{label}: INT32_MAX was dropped")
            print(f"phase 16: PipeGraph.run() {label}: {nrec} records match "
                  f"the oracle batch by batch and the run with no mesh; "
                  f"{secs:.3f} s; launches {counts}{extra}")

    # (d) the stateful map over key-sharded dense state
    sk = rng.integers(0, FRAUD_CARDS, n)
    sv = rng.integers(0, 4, n).astype(np.float32)
    sblob = frame_blob(sk, np.arange(n), sv)
    cnt, run_sum = running_oracle(sk, sv)
    want = np.stack([sk, cnt, run_sum], 1).astype(np.float64)
    want = want[np.lexsort(want.T[::-1])]
    # on 2x2 under both ingests: the aligned one, and the data-sharded one
    # whose lanes merge across key shards with a psum
    for shape, aligned in ((None, True), ("2x2", True), ("2x2", False)):
        label = f"16(d) assoc {shape or 'no mesh'}"
        if shape is not None:
            label += f" aligned {'on' if aligned else 'off'}"
        cols, sink = collect()
        g, op = assoc_graph(dev_name, sblob, sink, mesh=shapes.get(shape),
                            key_aligned_ingest=aligned)
        secs, counts = timed_run(g)
        out[label] = counts
        rows = sorted_cols(cols, ("key", "n", "sum"))
        if not np.array_equal(rows, want):
            fail(f"{label}: per-key running counts or sums differ")
        extra = ""
        if shape is not None:
            if not isinstance(op._state, M.Sharded) \
                    or not op._state.equal_across_data():
                fail(f"{label}: the slot table is not key-sharded and "
                     "equal along data")
            mode = getattr(op, "_ingest_mode", None) or "data"
            if (mode == "aligned") != aligned:
                fail(f"{label}: ingest {mode}")
            extra = f"; ingest {mode}; the slot table key-sharded"
        print(f"phase 16: PipeGraph.run() {label}: {n} records match the "
              f"oracle key by key; {secs:.3f} s; launches {counts}{extra}")

    # (e) key-aligned ingest on against off: frames straight into the
    #     keyed count windows (host-fed), and the JAX test's reduce
    #     (twice each, on, off, off, on: the host clock's drift and the
    #     first run's warm-up fall on both)
    ici, ref, secs_e = {}, None, {True: [], False: []}
    for aligned in (True, False, False, True):
        label = (f"16(e) windows aligned {'on' if aligned else 'off'} "
                 f"#{len(secs_e[aligned]) + 1}")
        cols, sink = collect()
        g = wf.PipeGraph("chip_smoke_aligned", wf.ExecutionMode.DEFAULT,
                         config=wf.Config(device=dev_name,
                                          punctuation_interval_usec=10 ** 12,
                                          mesh=shapes["2x2"],
                                          key_aligned_ingest=aligned))
        win = (wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"],
                                          lambda a, b: a + b)
               .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
               .withMaxKeys(KEYS).withName("aligned_win").build())
        g.add_source(wf.FrameSource(chunked(blob), nv=1,
                                    output_batch_size=CAP,
                                    record_spec={"key": np.int32(0),
                                                 "v0": np.float32(0.0)})) \
            .add(win).add_sink(wf.Sink_Builder(sink)
                               .withColumnarSink(defer=4).build())
        secs, counts = timed_run(g)
        out[label] = counts
        secs_e[aligned].append(secs)
        mode = getattr(win, "_ingest_mode", None)
        if (mode == "aligned") != aligned:
            fail(f"{label}: ingest {mode}")
        rows = sorted_cols(cols, ("key", "wid", "value"))
        if ref is None:
            ref = rows
        elif not np.array_equal(rows, ref):
            fail(f"{label}: records differ from the aligned run")
        ici[aligned] = g.stats()["Shard"]["per_op"]["aligned_win"]["ici"]
        print(f"phase 16: PipeGraph.run() {label}: {len(rows)} windows "
              f"equal; modeled inter-position bytes "
              f"{ici[aligned]['ici_bytes_per_tuple']} a tuple "
              f"({ici[aligned]['collective']}); {secs:.3f} s; launches "
              f"{counts}")
    if not ici[True]["ici_bytes_per_tuple"] < ici[False]["ici_bytes_per_tuple"]:
        fail("16(e): aligned ingest did not cut the modeled bytes")
    print(f"phase 16 (e): aligned on {secs_e[True]} s, off {secs_e[False]} s "
          "(host clock, information only)")
    from windflow_tpu_torch.analysis import ir_audit
    wf901 = {}
    for aligned in (True, False):
        cols, sink = collect()
        g, op = mesh_reduce_graph(
            dev_name, frame_blob(rk[:4 * CAP], np.arange(4 * CAP),
                                 rv[:4 * CAP]), sink, KEYS, "max",
            mesh=shapes["1x4"], key_aligned_ingest=aligned)
        g.run()
        rep = ir_audit.audit_graph(g, dry_lower=False)
        wf901[aligned] = [d for d in rep.findings if d.code == "WF901"]
    if wf901[True] or not wf901[False]:
        fail(f"16(e): WF901 aligned {len(wf901[True])}, unaligned "
             f"{len(wf901[False])}")
    print(f"phase 16 (e): WF901 clean on the aligned reduce, raised on the "
          f"unaligned one: {wf901[False][0].message}")

    # (f) a mesh checkpoint on 4 key shards restored on 2
    from windflow_tpu_torch.durability import chaos
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t0 = time.perf_counter()
        v = chaos.run_rescale_ab(
            "window_cb", "mid_epoch", work, shards_kill=1, shards_restore=1,
            mesh_kill=shapes["1x4"],
            mesh_restore=M.make_mesh(2, devices=[shapes["1x4"].home] * 2),
            n=4096, device=dev_name)
        if v["diff"] is not None:
            fail(f"16(f): the restored suffix differs: {v['diff']}")
        print(f"phase 16 (f): window_cb checkpointed on {v['mesh']}, "
              f"restored at epoch {v['restored_epoch']}: {v['records']} "
              f"records equal the uninterrupted run "
              f"({time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (g) the multi-process layer at one process
    multihost.initialize()
    if multihost.process_count() != 1 or dist.is_initialized():
        fail("16(g): initialize() joined a process group in one process")
    import socket
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        gmesh = multihost.make_multihost_mesh(
            devices=[shapes["1x4"].home] * MESH_POS)
        if gmesh.group is None:
            fail("16(g): the mesh did not take the process group")
        dev = torch.device(dev_name)
        payload = {"key": torch.as_tensor(rk[:CAP].astype(np.int32),
                                          device=dev),
                   "v0": torch.as_tensor(rv[:CAP], device=dev)}
        ts = torch.zeros(CAP, dtype=torch.int64, device=dev)
        valid = torch.ones(CAP, dtype=torch.bool, device=dev)
        comb = lambda a, b: {"key": a["key"] + b["key"],  # noqa: E731
                             "v0": a["v0"] + b["v0"]}
        res = {}
        for name, m in (("in-process", shapes["1x4"]), ("nccl", gmesh)):
            step = M.make_sharded_reduce_step(m, CAP, KEYS, comb,
                                              lambda t: t["key"],
                                              monoid="sum", kernels=True)
            with M.recording() as rec:
                res[name] = step(payload, ts, valid)
            torch.cuda.synchronize()
        same = all(torch.equal(a[f], b[f]) for a, b in
                   zip(res["in-process"][:1], res["nccl"][:1])
                   for f in ("key", "v0")) and all(
            torch.equal(a, b) for a, b in zip(res["in-process"][1:],
                                              res["nccl"][1:]))
        if not same:
            fail("16(g): the psum through NCCL differs from in-process")
        print(f"phase 16 (g): initialize() a no-op in one process; an NCCL "
              f"process group at world size 1 carried the psum "
              f"({len(rec)} collectives through torch.distributed), equal "
              "to the in-process one")
    finally:
        dist.destroy_process_group()

    # the inter-position rate the shard ledger's model divides by
    from windflow_tpu_torch.monitoring import calibrate
    rate, detail = calibrate.probe_ici(torch.device(dev_name), MESH_POS)
    print(f"phase 16: psum over {MESH_POS} mesh positions: {rate:.4g} B/s "
          f"({detail['measured']}; {detail['payload_bytes']} B a position)")
    return out


def pool_runs(dev_name="cuda"):
    """Phase 15, the host worker pool (40 s budget), each run at 0 and 4
    pool threads with equal records: (a) phase 13's host window (keyed
    count windows behind phase 3's card stage) and its P_Reduce; (b) the
    frames count-window graph at K = 8 with a host FlatMap and a Sink
    behind the device stage and a host-only chain after the FlatMap,
    under ``set_sync_debug_mode("warn")`` with the warnings caught by
    thread: the capture forms, the FlatMap and the direct Sink stay on
    the driver thread, the chain is pooled, no pool thread syncs.
    Returns launch counts by run label; tuples/s are information only."""
    import threading
    import warnings

    import torch
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    smi = smi_line()
    print(f"phase 15: {smi}")
    out = {}
    rng = np.random.default_rng(2015)

    # (a) the host window and P_Reduce at 0 and 4 threads
    n = P15_WINDOW_N
    keys = rng.integers(0, KEYS, n).astype(np.int32)
    vals = rng.integers(-50, 51, n).astype(np.float32)
    ts = np.arange(n, dtype=np.int64) * 10
    res = {}
    for t in POOL_THREADS:
        rows = []
        g = host_window_graph(dev_name, wt.Keyed_Windows_Builder(
            lambda r, acc: (0.0 if acc is None else acc) + r["v0"])
            .withCBWindows(WIN, SLIDE).withKeyBy(lambda r: r["key"])
            .withParallelism(2), keys, vals, ts, rows, f"p15_kw_{t}",
            host_worker_threads=t)
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        g.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[f"15(a) Keyed_Windows {t} threads"] = fc.launch_counts()
        st = g.stats()
        if (st["Host_worker_threads"], st["Thread_number"]) != (t, 1 + t):
            fail(f"phase 15 (a): stats() reports "
                 f"{st['Host_worker_threads']}, {st['Thread_number']}")
        res[t] = sorted(rows)
        print(f"phase 15 (a) Keyed_Windows behind the card stage, {t} pool "
              f"threads ({len(g._pool_replicas)} replicas pooled): "
              f"{len(rows)} windows, {n} tuples in {secs:.3f} s = "
              f"{n / secs:.0f} tuples/s (host clock, information only)")
    if res[0] != res[POOL_THREADS[-1]] or not res[0]:
        fail("phase 15 (a): the host window's records differ between 0 "
             "and 4 pool threads")
    rk = keys[:P15_REDUCE_N] % 256
    rv = vals[:P15_REDUCE_N]
    root = tempfile.mkdtemp(prefix="chip_smoke_p15_")
    states = {}
    from windflow_tpu_torch.persistent import DBHandle
    for t in POOL_THREADS:
        path = os.path.join(root, f"pr_{t}")
        g = pool_reduce_graph(dev_name, rk, rv, path, f"p15_pr_{t}", t)
        t0 = time.perf_counter()
        g.run()
        secs = time.perf_counter() - t0
        st = {}
        for i in range(2):
            db = DBHandle(path, initial_state=dict, whoami=i)
            st.update({k: db.get(k) for k in db.keys()})
            db.close()
        states[t] = st
        print(f"phase 15 (a) P_Reduce, {t} pool threads "
              f"({len(g._pool_replicas)} replicas pooled): {len(st)} keys, "
              f"{P15_REDUCE_N} tuples in {secs:.3f} s = "
              f"{P15_REDUCE_N / secs:.0f} tuples/s (host clock, "
              "information only)")
    shutil.rmtree(root, ignore_errors=True)
    cnt = np.bincount(rk, minlength=256)
    tot = np.bincount(rk, weights=rv.astype(np.float64), minlength=256)
    want = {int(k): {"n": int(cnt[k]), "sum": float(tot[k])}
            for k in np.flatnonzero(cnt)}
    if any(states[t] != want for t in POOL_THREADS):
        fail("phase 15 (a): a P_Reduce state differs from the oracle")

    # (b) the count windows at K = 8 behind the pool, syncs caught by
    #     thread
    nb = CAP * P15_BATCHES
    keys = rng.integers(0, KEYS, nb)
    vals = rng.integers(-100, 101, nb).astype(np.float32)
    blob = frame_blob(keys, np.arange(nb), vals)
    keep = (keys & 7) != 7
    want = oracle(keys[keep].astype(np.int32),
                  vals[keep] * np.float32(1.5) + np.float32(1.0))
    res = {}
    for t in POOL_THREADS:
        direct, chain = [], []
        g, ops = pool_cb_graph(dev_name, blob, t, direct, chain,
                               megastep_sweeps=8)
        seen = []
        fc.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            orig = warnings.showwarning

            def hook(message, category, *a, **kw):
                seen.append((threading.current_thread().name,
                             str(message)[:80]))
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                g.run()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode(0)
                warnings.showwarning = orig
        counts = fc.launch_counts()
        out[f"15(b) CB K=8 {t} threads"] = counts
        edge = g.stats()["Megastep"]["edges"]
        if not edge or edge[0]["captures"] < 1 or edge[0]["megasteps"] < 1:
            fail(f"phase 15 (b) {t} threads: no capture formed: {edge}")
        pooled = {r.op.name for r in g._pool_replicas}
        driver = {r.op.name for r in g._main_replicas}
        if t and (pooled != {"hm", "chain_sink"}
                  or not {"fm", "direct_sink", "w"} <= driver):
            fail(f"phase 15 (b): pooled {pooled}, driver {driver}")
        if t and any(r.inflight_device for r in g._pool_replicas):
            fail("phase 15 (b): a pooled replica held a device batch")
        off = [w for w in seen if w[0].startswith("wf-")]
        if off:
            fail(f"phase 15 (b): a pool thread synchronised: {off[:3]}")
        if {kw for kw in want if kw[0] % 2 == 0} != set(
                (k, w) for k, w, _ in direct) \
                or any(direct_v != want[(k, w)] for k, w, direct_v in direct):
            fail(f"phase 15 (b) {t} threads: the direct sink's windows "
                 "differ from the oracle")
        firsts = {}
        for k, w, v in chain:
            firsts.setdefault((k, w), v)
        if set(firsts) != {kw for kw in want if kw[0] % 2 == 1} \
                or any(firsts[kw] != want[kw] for kw in firsts):
            fail(f"phase 15 (b) {t} threads: the chain sink's windows "
                 "differ from the oracle")
        res[t] = (direct, chain)
        print(f"phase 15 (b) CB K=8, {t} pool threads (pooled "
              f"{sorted(pooled)}, driver thread {sorted(driver)}): "
              f"{len(direct)} + {len(chain)} records equal the oracle; "
              f"megasteps {edge[0]['megasteps']}, captures "
              f"{edge[0]['captures']}; {len(seen)} sync warnings, none "
              f"from a pool thread; {nb} tuples in {secs:.3f} s = "
              f"{nb / secs:.0f} tuples/s (host clock, information only); "
              f"launches {counts}")
    if res[0] != res[POOL_THREADS[-1]]:
        fail("phase 15 (b): records differ between 0 and 4 pool threads")
    print(f"phase 15 (b): records and their order equal at 0 and "
          f"{POOL_THREADS[-1]} threads")
    return out


# ---------------------------------------------------------------------------
# phase 17: the stateful wavefront as a device loop
# ---------------------------------------------------------------------------

#: (b)'s one-key batches: one key holds every lane, so the loop runs this
#: many passes a batch; (c)'s count vectors have this capacity
WAVE_HOT_CAP = 16384
#: batches a run of (b): the uniform stream's, and the one-key stream's
#: (16,384 passes each)
WAVE_BATCHES, WAVE_HOT_BATCHES = 4, 2
#: (c)'s depths (the last is the capacity)
WAVE_DEPTHS = (1, 2, 1024, 1025, WAVE_HOT_CAP)
#: (a)'s batches: a warm-up batch and three K = 8 groups (one captured,
#: two replayed from the cache)
WAVE_A_BATCHES = 1 + 3 * 8


def _strict(fn, *a):
    """``fn(*a)`` under ``set_sync_debug_mode("error")``."""
    import torch
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*a)
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def strict_steps(op, rec, depth=False):
    """Run the tail ``op``'s per-batch steps after its first (which
    places the initial state on the card) under
    ``set_sync_debug_mode("error")`` (each between two synchronises made
    outside it, for the wall; a synchronising call raises), and time the
    loop graphs' builds apart."""
    import torch
    from windflow_tpu_torch.ops import gpu_stateful as gst
    orig = op._step

    def step(batch, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        if rec["steps"]:
            out = _strict(orig, batch, *a)
            rec["strict_steps"] += 1
        else:
            out = orig(batch, *a)
        ev[1].record()
        torch.cuda.synchronize()
        if rec["steps"]:
            rec["step_s"] += time.perf_counter() - t0
            rec["event_ms"] += ev[0].elapsed_time(ev[1])
        else:
            rec["first_s"] = time.perf_counter() - t0
        rec["steps"] += 1
        if depth:
            rec["depths"].append(op.last_depth)
        return out
    op._step = step
    build = gst._ClassLoop._build

    def timed_build(self, *a):
        t0 = time.perf_counter()
        out = build(self, *a)
        rec["build_s"] += time.perf_counter() - t0
        return out
    gst._ClassLoop._build = timed_build
    rec["restore"] = lambda: setattr(gst._ClassLoop, "_build", build)


def strict_groups(g, rec):
    """Run the cached megastep group replays of the started graph ``g``
    under ``set_sync_debug_mode("error")``.  The groups' emission
    downstream, their cadence hooks and the recorder's sampled wait run
    outside the strict window, as a group's capture does; the capture is
    timed apart."""
    import torch

    def relaxed(fn):
        def call(*a):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return call

    for e in g._megastep_plane.edges:
        o_run, o_cap = e.run, e._capture
        e._emit = relaxed(e._emit)
        e._post_hooks = relaxed(e._post_hooks)
        e._stamp_device_done = relaxed(e._stamp_device_done)

        def run(_e=e, _o=o_run):
            q = _e._q
            cached = (len(q) >= _e.k and _e._group is not None
                      and _e._group_step is _e._step(q[0].capacity)
                      and _e._group_sig == _e._sig(q[0])
                      and not _e.rep.inbox and not _e.rep.done)
            before = _e.megasteps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            if cached:
                _strict(_o)
                rec["strict_groups"] += 1
            else:
                _o()
            ev[1].record()
            torch.cuda.synchronize()
            if _e.megasteps > before and cached:
                rec["groups"] += 1
                rec["group_s"] += time.perf_counter() - t0
                rec["event_ms"] += ev[0].elapsed_time(ev[1])

        def cap(*a, _o=o_cap):
            t0 = time.perf_counter()
            out = _o(*a)
            rec["capture_s"] += time.perf_counter() - t0
            return out
        e.run, e._capture = run, cap


def wave_run(label, build, k, batches=COL_BATCHES, depth=False, prof=True):
    """One phase-17 run of ``build(sink, megastep_sweeps=k)`` ->
    ``(graph, stateful tail)`` with :func:`strict_steps` and
    :func:`strict_groups` on, under ``torch.profiler``'s CUDA activity
    when ``prof``: ``(sink batches, facts)`` with the launch counts, the
    loop's passes, the wall and the CUDA-event span a steady batch (the
    steps after the first, the cached group replays) and (``prof``) the
    device time and device operations a batch of the whole run.  (b)'s
    runs go untraced: a trace of replays whose WHILE loop ran 16,384
    passes ended in an illegal address on the card, where the same runs
    untraced are clean."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.kernels import loop_cuda
    cols, sink = collect()
    g, op = build(sink, megastep_sweeps=k)
    rec = {"steps": 0, "step_s": 0.0, "groups": 0, "group_s": 0.0,
           "strict_steps": 0, "strict_groups": 0, "capture_s": 0.0,
           "build_s": 0.0, "event_ms": 0.0, "first_s": 0.0,
           "depths": []}
    dev = torch.device("cuda", torch.cuda.current_device())
    fc.reset_launch_counts()
    loop_cuda.reset_device_passes(dev)
    strict_steps(op, rec, depth=depth)
    tracer = profile(activities=[ProfilerActivity.CUDA]) if prof \
        else contextlib.nullcontext()
    try:
        with tracer:
            t0 = time.perf_counter()
            g.start()
            strict_groups(g, rec)
            g.wait_end()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        if "restore" in rec:
            rec["restore"]()
    counts = fc.launch_counts()
    dev_us = n_ops = None
    if prof:
        evs = [e for e in tracer.key_averages()
               if e.device_type.name == "CUDA"]
        dev_us = sum(_device_us(e) for e in evs)
        n_ops = sum(e.count for e in evs)
    sec = g.stats()["Megastep"]
    # steady batches: every step but the first (which places the state
    # and builds the loop graph) and every cached group's K
    steady = max(0, rec["steps"] - 1) + rec["groups"] * k
    wall = (rec["step_s"] + rec["group_s"]) / steady if steady else None
    return cols, {
        "secs": secs, "launches": counts, "megastep": sec,
        "passes": loop_cuda.device_passes(dev),
        "steps": rec["steps"], "groups": rec["groups"],
        "strict_steps": rec["strict_steps"],
        "strict_groups": rec["strict_groups"],
        "wall_ms": None if wall is None else 1e3 * wall,
        "event_ms": rec["event_ms"] / steady if steady else None,
        "first_ms": 1e3 * rec["first_s"],
        "device_ms": None if dev_us is None else dev_us / 1e3 / batches,
        "device_ops": None if n_ops is None else n_ops / batches,
        "capture_ms": 1e3 * rec["capture_s"],
        "build_ms": 1e3 * rec["build_s"], "depths": rec["depths"],
        "graph": g}


def audit_codes(g):
    """The WF9xx codes of the finished graph's capture audit."""
    return {f["code"] for f in g.stats()["IR_audit"]["findings"]}


def wave_sum_graph(dev_name, blob, cap, sink_fn, **cfg):
    """(b): FrameSource → a stateful MapGPU with a general ``fn`` (the
    wavefront; dense keys, 16,384 slots): per key the running count and
    the running sum of v0 → columnar Sink.  Returns ``(graph,
    operator)``."""
    import windflow_tpu_torch as wf

    def fn(t, s):
        new = {"n": s["n"] + 1, "sum": s["sum"] + t["v0"]}
        return {"key": t["key"], "n": new["n"], "sum": new["sum"]}, new
    op = (wf.MapGPU_Builder(fn).withName("running_wave")
          .withKeyBy(lambda t: t["key"])
          .withInitialState({"n": np.int32(0), "sum": np.float32(0.0)})
          .withNumKeySlots(FRAUD_CARDS).withDenseKeys().build())
    g = wf.PipeGraph("chip_smoke_wave", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      **cfg))
    g.add_source(wf.FrameSource(chunked(blob), nv=1, output_batch_size=cap)) \
        .add(op).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink(defer=4)
                          .build())
    return g, op


def advance_sequence(cnt, widths, plain):
    """Every cursor of one loop of the steering kernel (launched eagerly
    pass by pass, read after each) or of its plain twin (on host
    tensors): ``[reset, pass 1, ...]`` as lists."""
    import torch
    from windflow_tpu_torch.kernels import loop_cuda as L
    if plain:
        cnt = cnt.cpu()
    cur = torch.zeros(L.CUR_WORDS, dtype=torch.int64, device=cnt.device)
    step = L.advance_plain if plain else L.wavefront_advance
    step(cnt, cur, widths, True)
    out = [cur.tolist()]
    while out[-1][4]:
        step(cnt, cur, widths, False)
        out.append(cur.tolist())
    return out


def loop_log(dev, cnt, widths):
    """The loop of the steering kernel captured as a WHILE node whose
    class bodies log each pass's (base, count, width): ``(log rows of
    the live ranks, passes, ms a replay by CUDA events)``."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.kernels import loop_cuda as L
    cap = cnt.shape[0]
    cur = torch.zeros(L.CUR_WORDS, dtype=torch.int64, device=dev)
    log = torch.zeros((cap + 1, 3), dtype=torch.int64, device=dev)

    def body(width):
        row = (cur[0] - 1).clamp(min=0).reshape(1)
        w = torch.full((), width, dtype=torch.int64, device=dev)
        log.index_copy_(0, row, torch.stack([cur[2], cur[3], w])
                        .reshape(1, 3))
    for width in widths:
        body(width)            # warm-up: cur is all zeros
    g = fc.CountedGraph(torch.cuda.CUDAGraph())
    with fc.uncounted():
        with g.capture(L.side_capture(g.graph, dev)):
            log.zero_()
            L.emit_loop(cnt, cur, widths, body)
        L.reset_device_passes(dev)
        g.replay()
        torch.cuda.synchronize()
        passes = L.device_passes(dev)
        ms = cuda_time(g.replay, iters=3, warmup=1)
    d = int((cnt > 0).sum())
    return log[:d].cpu().numpy(), passes, ms


def check_advance(dev):
    """(c): the steering kernel against its plain twin, on count vectors
    of WAVE_HOT_CAP ranks at each depth of WAVE_DEPTHS: pass by pass (up
    to 1,025 passes) and as the captured WHILE loop (the offsets,
    counts and classes of every pass, the pass count); then its time a
    launch beside its plain twin's and the loop's time a pass.  Returns
    the kernel's JSON row (launches filled in by main)."""
    import torch
    from windflow_tpu_torch.kernels import loop_cuda as L
    rng = np.random.default_rng(17)
    widths = L.width_classes(FRAUD_CARDS, WAVE_HOT_CAP)
    loop_ms = {}
    for d in WAVE_DEPTHS:
        counts = np.sort(rng.integers(1, FRAUD_CARDS + 1, d))[::-1]
        counts[0] = FRAUD_CARDS
        cnt_h = np.zeros(WAVE_HOT_CAP, np.int32)
        cnt_h[:d] = counts
        cnt = torch.from_numpy(cnt_h).to(dev)
        if d <= 1025:
            if advance_sequence(cnt, widths, False) \
                    != advance_sequence(cnt, widths, True):
                fail(f"phase 17 (c): wavefront_advance differs from its "
                     f"plain twin at depth {d}")
        log, passes, ms = loop_log(dev, cnt, widths)
        off = np.r_[0, np.cumsum(counts)[:-1]]
        want = np.stack([off, counts, [widths[L.pick_class(widths, int(c))]
                                       for c in counts]], 1)
        if passes != d or not np.array_equal(log, want):
            fail(f"phase 17 (c): the WHILE loop at depth {d} made "
                 f"{passes} passes or its slices differ")
        loop_ms[d] = ms
    cnt = torch.from_numpy(np.r_[np.int32(FRAUD_CARDS), np.full(
        WAVE_HOT_CAP - 1, 7, np.int32)]).to(dev)
    cur = torch.zeros(L.CUR_WORDS, dtype=torch.int64, device=dev)
    L.wavefront_advance(cnt, cur, widths, True)

    def kernel():
        L.wavefront_advance(cnt, cur, widths, False, count=False)

    def plain():
        L.advance_plain(cnt, cur, widths, False)
    # the plain twin is host reads and copies, which a trace may hold no
    # device record of: both are timed by CUDA events over back-to-back
    # calls (the plain twin's include its synchronising reads), the
    # kernel by torch.profiler beside them
    t = {"kernel": device_ms(kernel), "kernel_events": cuda_time(kernel),
         "plain": cuda_time(plain)}
    print(f"phase 17 (c) wavefront_advance: kernel {t['kernel']:.5f} ms "
          f"device / {t['kernel_events']:.5f} ms events, plain "
          f"{t['plain']:.5f} ms events")
    # one pass: two counts read, the cursor's two words read and its six
    # written
    bound, by = bound_ms(2 * 4 + 2 * 8 + 6 * 8, 0)
    per_pass = {d: 1e3 * loop_ms[d] / d for d in WAVE_DEPTHS}
    print(f"phase 17 (c): wavefront_advance equals its plain twin pass by "
          f"pass at depths <= 1,025 and as a WHILE loop at depths "
          f"{list(WAVE_DEPTHS)} (offsets, counts, classes {widths}, pass "
          f"counts); the loop with a logging body a pass: "
          + ", ".join(f"depth {d} {per_pass[d]:.3f} us"
                      for d in WAVE_DEPTHS)
          + f" (CUDA events over a replay; {smi_line()})")
    return {"name": "wavefront_loop", "route": "cuda",
            "source": "windflow_tpu_torch/csrc/wavefront_loop.cu",
            "replaces": "windflow_tpu/ops/tpu_stateful.py:130 "
                        "(the lax.while_loop; no Pallas kernel)",
            "launches": 0, "max_abs_err": 0.0, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def wavefront_runs(dev_name="cuda"):
    """Phase 17: (a) phase 7 (a)'s fraud detection, fused and unfused,
    at K = 1 and K = 8, and its kernels-off twin; (b) a general running
    sum on a uniform stream and on batches one key fills; (c) the
    steering kernel against its plain twin.  Every run against its numpy
    oracle with the tail's steps after the first and the cached group
    replays under ``set_sync_debug_mode("error")``.  Returns (launch
    counts by label, the kernel's JSON row)."""
    import torch
    out = {}
    n = CAP * WAVE_A_BATCHES
    rng = np.random.default_rng(2026)
    table, cards, etype, _ = fraud_data(rng, n)
    blob_a = frame_blob(cards, np.arange(n), etype.astype(np.float64))
    score = fraud_oracle(cards, etype, table)
    recs = {}
    runs = [(fuse, k, False) for fuse in (False, True) for k in (1, 8)] \
        + [(True, 1, True), (True, 8, True)]
    for fuse, k, prof in runs:
        label = (f"17(a) fraud dense {'fused' if fuse else 'unfused'} "
                 f"K={k}{' traced' if prof else ''}")

        def build(sink, fuse=fuse, **cfg):
            return fraud_graph(dev_name, blob_a, table, sink, fuse=fuse,
                               **cfg)
        cols, f = wave_run(label, build, k, batches=WAVE_A_BATCHES,
                           prof=prof)
        out[label] = f["launches"]
        nrec = check_fraud(label, cols, cards, etype, table, score)
        recs[label] = (cat_cols(cols, "card"), cat_cols(cols, "score"))
        if f["launches"]["wavefront_loop"] != WAVE_A_BATCHES:
            fail(f"{label}: wavefront_loop launched "
                 f"{f['launches']['wavefront_loop']} times in "
                 f"{WAVE_A_BATCHES} batches")
        if f["strict_steps"] + f["strict_groups"] == 0:
            fail(f"{label}: no step ran under the strict sync mode")
        codes = audit_codes(f["graph"])
        if codes & {"WF906", "WF907"}:
            fail(f"{label}: the capture audit found "
                 f"{f['graph'].stats()['IR_audit']['findings']}")
        sec = f["megastep"]
        extra = ""
        if k > 1 and fuse:
            e = sec["edges"][0] if sec["edges"] else None
            if sec["refused"] or e is None \
                    or e["megasteps"] != (WAVE_A_BATCHES - 1) // k \
                    or f["strict_groups"] != e["megasteps"] - 1 \
                    or e["kernel_launches_per_group"] != k:
                fail(f"{label}: the groups of the wavefront tail did not "
                     f"form as expected ({sec}, {f['strict_groups']} "
                     "strict replays)")
            extra = (f"; {e['megasteps']} groups ({f['strict_groups']} "
                     f"cached replays under the strict mode), "
                     f"{e['warmup_batches']} warm-up, "
                     f"{e['fallback_batches']} fallback batches")
        elif k > 1:
            # unfused, the staging edge's tail is the stateless cast
            if [r["operator"] for r in sec["refused"]] != ["cast"]:
                fail(f"{label}: refusals {sec['refused']}")
            extra = f"; refused {sec['refused']}"
        traced = (f", device {f['device_ms']:.3f} ms and "
                  f"{f['device_ops']:.1f} device operations a batch over "
                  "the run (torch.profiler)") if prof else ""
        print(f"phase 17: PipeGraph.run() {label}: {nrec} flagged "
              f"records match the oracle; audit {sorted(codes)} (no "
              f"WF906/WF907); a steady batch: wall {f['wall_ms']:.3f} ms "
              f"(synchronised), CUDA-event span {f['event_ms']:.3f} ms"
              f"{traced}; {f['passes'] / WAVE_A_BATCHES:.1f} loop passes "
              f"a batch; first step {f['first_ms']:.1f} ms (loop graph "
              f"build {f['build_ms']:.1f} ms), capture "
              f"{f['capture_ms']:.1f} ms; launches {f['launches']}{extra} "
              f"(information only; {smi_line()})")
    first = recs["17(a) fraud dense unfused K=1"]
    for label, r in recs.items():
        if not all(np.array_equal(a, b) for a, b in zip(first, r)):
            fail(f"{label}: records differ from the unfused K = 1 run")
    # the kernels-off twin: the plain host loop, the tail refused by name
    label = "17(a) fraud dense fused K=8 kernels off"
    cols, sink = collect()
    g, _ = fraud_graph(dev_name, blob_a, table, sink, megastep_sweeps=8,
                       cuda_kernels="0")
    secs, counts = timed_run(g)
    out[label] = counts
    sec = g.stats()["Megastep"]
    check_fraud(label, cols, cards, etype, table, score)
    if not all(np.array_equal(a, b) for a, b in zip(
            first, (cat_cols(cols, "card"), cat_cols(cols, "score")))):
        fail(f"{label}: records differ from the kernels-on runs")
    if counts["wavefront_loop"] or sec["edges"] \
            or "cuda_kernels='0'" not in sec["refused"][0]["reason"]:
        fail(f"{label}: launches {counts}, megastep {sec}")
    # its plain loop reads the rank counts on the host: no sanctioned
    # read covers that any more
    if "WF906" not in audit_codes(g):
        fail(f"{label}: the audit did not name the plain loop's host read")
    print(f"phase 17: PipeGraph.run() {label}: records equal the kernels-"
          f"on runs; the plane refuses '{sec['refused'][0]['operator']}' "
          f"({sec['refused'][0]['reason']}); {secs:.3f} s")

    # (b) depth extremes through a general running sum
    for dist, cap, nb in (("uniform", CAP, WAVE_BATCHES),
                          ("one key a batch", WAVE_HOT_CAP,
                           WAVE_HOT_BATCHES)):
        label = f"17(b) running sum {dist}"
        if dist == "uniform":
            keys = rng.integers(0, FRAUD_CARDS, cap * nb)
        else:
            keys = np.repeat(rng.integers(0, FRAUD_CARDS, nb), cap)
        vals = rng.integers(0, 4, cap * nb).astype(np.float32)
        blob = frame_blob(keys, np.arange(cap * nb), vals)

        def build(sink, blob=blob, cap=cap, **cfg):
            return wave_sum_graph(dev_name, blob, cap, sink, **cfg)
        cols, f = wave_run(label, build, 1, batches=nb, depth=True,
                           prof=False)
        out[label] = f["launches"]
        cnt, run_sum = running_oracle(keys, vals)
        if not (np.array_equal(cat_cols(cols, "key"), keys)
                and np.array_equal(cat_cols(cols, "n"), cnt)
                and np.array_equal(cat_cols(cols, "sum"), run_sum)):
            fail(f"{label}: running counts or sums differ from the oracle")
        want = [int(np.bincount(keys[i * cap:(i + 1) * cap]).max())
                for i in range(nb)]
        if f["depths"] != want or f["passes"] != sum(want):
            fail(f"{label}: depths {f['depths']} (passes {f['passes']}), "
                 f"{want} expected")
        print(f"phase 17: PipeGraph.run() {label}: {cap * nb} records "
              f"match the oracle at {cap} lanes a batch; depth a batch "
              f"{f['depths']} (= the hottest key's lanes), "
              f"{f['passes']} passes; a batch: wall {f['wall_ms']:.3f} ms, "
              f"CUDA-event span {f['event_ms']:.3f} ms (information only;"
              f" {smi_line()})")
    torch.cuda.synchronize()
    # (c) the steering kernel against its plain twin
    row = check_advance(torch.device(dev_name, 0)
                        if dev_name == "cuda" else torch.device(dev_name))
    return out, row


# ---------------------------------------------------------------------------
# phase 18: the JAX package's lax.conds as CUDA graph conditional nodes
# ---------------------------------------------------------------------------

#: (a)'s batches a run: a warm-up batch and two K = 8 groups (one
#: captured, one replayed from the cache)
COND_BATCHES = 1 + 2 * 8
#: (a)'s raw TB step outputs held on every lane: the first batches
COND_RAW = 4
#: (b)'s prefix: an all-hit batch over this many ids (the compactor
#: admits them all), then this many fresh ids on one batch's lanes (the
#: table takes as many as it has free slots: the rest miss, within the
#: overflow lane), then a batch of fresh ids on every lane (all cold)
COND_HOT, COND_FEW = 512, 4096


def cond_tele_graph(dev_name, blob, sink_fn, sum_combiner, **cfg):
    """(a)'s telemetry: phase 4 (b)'s shape on frames with a record spec
    (FrameSource, EVENT time) → MapGPU normalize | FilterGPU drop-NaN →
    TB windows 60 s / 5 s, lateness 1 s, drop policy, keyed by sensor,
    generic or ``withSumCombiner`` → columnar Sink.  Returns ``(graph,
    window operator)``."""
    import windflow_tpu_torch as wf
    win = (wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
           .withTBWindows(*TELE_WIN).withKeyBy(lambda t: t["key"])
           .withMaxKeys(TELE_KEYS).withLateness(TELE_LATENESS)
           .withOverflowPolicy("drop"))
    win = (win.withSumCombiner() if sum_combiner else win).build()
    g = wf.PipeGraph("chip_smoke_cond_tele", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.EVENT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      **cfg))
    pipe = g.add_source(wf.FrameSource(
        chunked(blob), nv=1, output_batch_size=CAP,
        record_spec={"key": np.int32(0), "v0": np.float32(0.0)}))
    pipe.add(wf.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"]}).build())
    pipe.chain(wf.FilterGPU_Builder(lambda t: t["v0"] == t["v0"]).build())
    pipe.add(win).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink()
                           .build())
    return g, win


def strict_builds(op, builder, rec):
    """Wrap the step builder ``builder`` of ``op`` so that every call of
    a step function it returns, after the operator's first, runs under
    ``set_sync_debug_mode("error")``.  The step function is the program
    this phase changes: the operator's own host reads around it (the TB
    ring's sizing and its rebase before the first firing, the
    compactor's reseed) are sanctioned reads of ``op._step``."""
    orig = getattr(op, builder)

    def build(*a, **kw):
        fn = orig(*a, **kw)

        def step(*sa):
            if rec["calls"]:
                out = _strict(fn, *sa)
                rec["strict_steps"] += 1
            else:
                out = fn(*sa)
            rec["calls"] += 1
            return out
        return step
    setattr(op, builder, build)


def cond_rec():
    return {"calls": 0, "strict_steps": 0, "steps": 0, "groups": 0,
            "group_s": 0.0, "strict_groups": 0, "capture_s": 0.0,
            "event_ms": 0.0, "raw": []}


def tap_raw(op, rec, n):
    """Record the first ``n`` per-batch TB step inputs of ``op`` (its
    state and the batch, cloned before the step runs)."""
    import torch
    from windflow_tpu_torch.utils.tree import tree_map
    orig = op._run_step

    def run(sidx, payload, ts, valid, *args):
        if len(rec["raw"]) < n:
            rec["raw"].append((tree_map(torch.clone, op._states[sidx]),
                               tree_map(torch.clone, payload), ts.clone(),
                               valid.clone(), args))
        return orig(sidx, payload, ts, valid, *args)
    op._run_step = run


def pass_fires(out, n_adv, K, MW):
    """Windows each of a TB step's three passes fired, from its output
    window ids (a pass's first id is the previous pass's first plus what
    that pass fired)."""
    w = out["wid"].reshape(K, 3, MW)[0, :, 0].tolist()
    a1, a2 = w[1] - w[0], w[2] - w[1]
    return [a1, a2, int(n_adv) - a1 - a2]


def raw_tb_check(label, op, raw, dev):
    """The recorded batches through the TB step on both routes, built by
    the operator itself (``_build_step``) with the kernels on and off:
    every output and state lane equal (unfired lanes included: JAX's
    no_fold zeros), and the fold's body counters equal to the passes that
    fired nothing and the passes that fired.  Calls after the kernel
    step's first run under "error".  Returns the three body counts."""
    import dataclasses

    import torch
    from windflow_tpu_torch.kernels import cond_cuda as cc
    from windflow_tpu_torch.utils.tree import tree_flatten
    from windflow_tpu_torch.windows.ffat_kernels import FOLD_SITE
    # the class's builder: the instance's is wrapped by strict_builds
    build = type(op)._build_step
    kstep = build(op, op._capacity)
    cfg = op.config
    op.config = dataclasses.replace(cfg, cuda_kernels="0")
    try:
        pstep = build(op, op._capacity)
    finally:
        op.config = cfg
    MW = op.NP // op.D + 2
    cc.reset_body_counts(dev)
    fired = []
    for i, (st, payload, ts, valid, args) in enumerate(raw):
        call = (lambda f, *a: f(*a)) if i == 0 else _strict
        ko = call(kstep, st, payload, ts, valid, *args)
        po = pstep(st, payload, ts, valid, *args)
        for a, b in zip(tree_flatten(ko)[0], tree_flatten(po)[0]):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"phase 18 {label}: the kernel route's raw TB step "
                     f"differs from the plain route's at batch {i}")
        fired += pass_fires(po[1], po[4], op.max_keys, MW)
    torch.cuda.synchronize()
    counts = cc.body_counts(dev, FOLD_SITE, 2)
    want = [sum(f == 0 for f in fired), sum(f > 0 for f in fired), 0]
    if counts != want:
        fail(f"phase 18 {label}: fold body counts {counts} on the raw "
             f"steps, {want} expected from the passes' fires {fired}")
    return counts, fired


def cond_tb_run(label, build, k, kernels, prof=False, raw=0):
    """One phase-18 (a) run of ``build(sink, **cfg)`` -> ``(graph,
    window)`` at ``megastep_sweeps=k``: with the kernels on, the TB step
    functions after the first and the cached group replays under "error"
    (and, ``raw``, the first batches' step inputs recorded); under
    ``torch.profiler``'s CUDA activity when ``prof``.  Launch counts and
    the fold's body counters are set to 0 just before the run and read
    just after.  Returns ``(columns, facts)``."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile
    from windflow_tpu_torch.kernels import cond_cuda as cc
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.windows.ffat_kernels import FOLD_SITE
    cols, sink = collect()
    g, win = build(sink, megastep_sweeps=k,
                   cuda_kernels="auto" if kernels else "0")
    rec = cond_rec()
    dev = torch.device("cuda", torch.cuda.current_device())
    if kernels:
        strict_builds(win, "_build_step", rec)
        if raw:
            tap_raw(win, rec, raw)
    tracer = profile(activities=[ProfilerActivity.CUDA]) if prof \
        else contextlib.nullcontext()
    fc.reset_launch_counts()
    cc.reset_body_counts(dev)
    with tracer:
        t0 = time.perf_counter()
        g.start()
        if kernels:
            strict_groups(g, rec)
        g.wait_end()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = fc.launch_counts()
    bodies = cc.body_counts(dev, FOLD_SITE, 2)
    dev_ms = n_ops = None
    if prof:
        evs = [e for e in tracer.key_averages()
               if e.device_type.name == "CUDA"]
        dev_ms = sum(_device_us(e) for e in evs) / 1e3 / COND_BATCHES
        n_ops = sum(e.count for e in evs) / COND_BATCHES
    return cols, {"secs": secs, "launches": counts, "bodies": bodies,
                  "rec": rec, "graph": g, "win": win,
                  "megastep": g.stats()["Megastep"], "device_ms": dev_ms,
                  "device_ops": n_ops}


def same_tb_cols(label, a, b):
    """Two runs' window records equal, record for record."""
    def recs(cols):
        k, w, v = (cat_cols(cols, nm) for nm in ("key", "wid", "value"))
        order = np.lexsort((w, k))
        return k[order], w[order], v[order]
    if not all(np.array_equal(x, y) for x, y in zip(recs(a), recs(b))):
        fail(f"phase 18 {label}: records differ from the kernels-off twin")


def cond_tb_runs(dev_name):
    """(a): phase 4 (a)'s YSB and (b)'s telemetry shapes on frames, both
    combiners, K = 1 and K = 8, each against its oracle and the
    ``cuda_kernels="0"`` twin of its graph and stream; returns launch
    counts by label."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    n = CAP * COND_BATCHES
    table, ad, etype, ts_y = ysb_data(n)
    views = etype == 1
    blob_y = frame_blob(ad, ts_y, etype.astype(np.float64))
    tk, tv, tts = telemetry_data(n)
    blob_t = frame_blob(tk, tts, tv.astype(np.float64))
    fams = {
        "YSB": (YSB_WIN, (table[ad[views]], ts_y[views],
                          np.ones(int(views.sum()))),
                lambda sink, comb, **cfg: ysb_frames_graph(
                    dev_name, table, blob_y, sink, sum_combiner=comb,
                    spec=True, **cfg)[::2]),
        "telemetry": (TELE_WIN, (tk, tts, tv),
                      lambda sink, comb, **cfg: cond_tele_graph(
                          dev_name, blob_t, sink, comb, **cfg)),
    }
    out = {}
    dev = torch.device("cuda", torch.cuda.current_device())

    def checked_run(tag, make, comb, k, kernels, want, oracle_in, win,
                    prof=False, raw=0):
        cols, f = cond_tb_run(
            tag, lambda sink, **cfg: make(sink, comb, **cfg), k, kernels,
            prof=prof, raw=raw)
        nrec = check_tb_records(tag, cols, *oracle_in, *win, want=want)
        st = f["win"].dump_stats()
        bad = [st[x] for x in ("Late_tuples_dropped", "Pane_cells_evicted",
                               "Windows_dropped_on_overflow")]
        if bad != [0, 0, 0]:
            fail(f"phase 18 {tag}: late / evicted / dropped {bad}")
        out[tag] = f["launches"]
        return cols, f, nrec

    for fam, (win, oracle_in, make) in fams.items():
        want = tb_oracle(*oracle_in, *win)
        for comb in (False, True):
            name = f"18(a) {fam} {'sum' if comb else 'generic'}"
            # the kernels-off twin: the plain fold route on the same
            # graph and stream (records do not depend on K: phase 8)
            twin, off, _ = checked_run(f"{name} K=1 kernels off", make,
                                       comb, 1, False, want, oracle_in, win)
            if off["launches"]["cond_select"] or any(off["bodies"]):
                fail(f"phase 18 {name} kernels off: launches "
                     f"{off['launches']}, bodies {off['bodies']}")
            k1 = None
            for k in (1, 8):
                label = f"{name} K={k}"
                # traced: the YSB generic step, PERF.md §5's TB shape
                prof = fam == "YSB" and not comb and k == 1
                cols, f, nrec = checked_run(
                    label, make, comb, k, True, want, oracle_in, win,
                    prof=prof, raw=COND_RAW if k == 1 else 0)
                same_tb_cols(label, cols, twin)
                counts, bodies, rec = f["launches"], f["bodies"], f["rec"]
                if rec["strict_steps"] != rec["calls"] - 1 \
                        or rec["strict_steps"] == 0:
                    fail(f"phase 18 {label}: strict steps {rec}")
                if not (bodies[0] > 0 and bodies[1] > 0 and bodies[2] == 0
                        and sum(bodies) >= counts["cond_select"] > 0):
                    fail(f"phase 18 {label}: fold bodies {bodies}, "
                         f"cond_select {counts['cond_select']}")
                codes = audit_codes(f["graph"])
                if codes & {"WF906", "WF907"}:
                    fail(f"phase 18 {label}: the capture audit found "
                         f"{f['graph'].stats()['IR_audit']['findings']}")
                if k == 1:
                    if counts["cond_select"] != 3 * rec["calls"] \
                            or sum(bodies) != 3 * rec["calls"]:
                        fail(f"phase 18 {label}: cond_select "
                             f"{counts['cond_select']}, bodies {bodies} "
                             f"over {rec['calls']} step calls")
                    k1 = counts
                    raw_counts, fired = raw_tb_check(label, f["win"],
                                                     rec["raw"], dev)
                    extra = (f"; raw steps on {COND_RAW} batches equal "
                             f"the plain route's on every lane, passes "
                             f"fired {fired}, bodies (no_fold, do_fold) "
                             f"{raw_counts[:2]}")
                else:
                    e = f["megastep"]["edges"]
                    if not e or e[0]["megasteps"] != 2 \
                            or rec["strict_groups"] != 1 or counts != k1:
                        fail(f"phase 18 {label}: megastep {f['megastep']},"
                             f" {rec['strict_groups']} cached replays, "
                             f"launches {counts} against K = 1's {k1}")
                    extra = (f"; {e[0]['megasteps']} groups "
                             f"({rec['strict_groups']} cached replay under "
                             f"the strict mode), kernel launches a group "
                             f"{e[0]['kernel_launches_per_group']}")
                if prof:
                    extra += (f"; a batch over the run (torch.profiler): "
                              f"device {f['device_ms']:.3f} ms and "
                              f"{f['device_ops']:.1f} operations (PERF.md "
                              f"§5: 4.88-4.93 ms, 966 kernels; information "
                              "only)")
                print(f"phase 18: PipeGraph.run() {label}: {nrec} windows "
                      f"match the oracle and the kernels-off twin; "
                      f"{rec['strict_steps']} step calls under the strict "
                      f"mode; fold bodies (no_fold, do_fold) "
                      f"{bodies[:2]}, cond_select {counts['cond_select']}"
                      f"; audit {sorted(codes)}{extra}; {f['secs']:.3f} s, "
                      f"the twin {off['secs']:.3f} s (information only; "
                      f"{smi_line()})")
    return out


def cond_reduce_data(rng):
    """(b)'s keys: the prefix (all hit, few misses, all cold), then phase
    7 (d)'s Zipf stream of COL_BATCHES batches."""
    hot = rng.choice(1 << 30, COND_HOT, replace=False) + (1 << 30)
    fresh = np.arange(COND_FEW + CAP, dtype=np.int64) + (1 << 29)
    a = hot[rng.integers(0, COND_HOT, CAP)]
    b = hot[rng.integers(0, COND_HOT, CAP)]
    b[rng.permutation(CAP)[:COND_FEW]] = fresh[:COND_FEW]
    c = fresh[COND_FEW:]
    z = zipf_shift_keys(rng, CAP * COL_BATCHES)
    return np.concatenate([a, b, c, z]).astype(np.int32)


def cond_reduce_runs(dev_name):
    """(b): the unbounded compacted reduce, declared max then sum, on
    ``cond_reduce_data``'s stream, against each batch's oracle and its
    kernels-off twin; returns launch counts by label."""
    import torch
    from windflow_tpu_torch.kernels import cond_cuda as cc
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.parallel.compaction import (BRANCH_SITE,
                                                        overflow_cap)
    rng = np.random.default_rng(1818)
    keys = cond_reduce_data(rng)
    nb = len(keys) // CAP
    vals = rng.integers(-100, 101, len(keys)).astype(np.float32)
    blob = frame_blob(keys, np.arange(len(keys)), vals)
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for monoid in ("max", "sum"):
        label = f"18(b) compacted reduce {monoid}"
        runs = {}
        for kernels in (True, False):
            tag = label + ("" if kernels else " kernels off")
            cols, sink = collect()
            g, red = kc_reduce_graph(dev_name, monoid, blob, sink,
                                     cuda_kernels="auto" if kernels
                                     else "0")
            rec = cond_rec()
            if kernels:
                strict_builds(red, "_get_compacted_step", rec)
            fc.reset_launch_counts()
            cc.reset_body_counts(dev)
            t0 = time.perf_counter()
            g.run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = fc.launch_counts()
            bodies = cc.body_counts(dev, BRANCH_SITE, 3)
            out[tag] = counts
            if len(cols) != nb:
                fail(f"phase 18 {tag}: {len(cols)} sink batches")
            for i, c in enumerate(cols):
                sl = slice(i * CAP, (i + 1) * CAP)
                wk, wv = batch_reduce_oracle(keys[sl], vals[sl], monoid)
                if not (np.array_equal(np.asarray(c.cols["key"]), wk)
                        and np.array_equal(np.asarray(c.cols["v0"]), wv)):
                    fail(f"phase 18 {tag}: batch {i} differs from the "
                         "oracle")
            runs[kernels] = (cols, counts, bodies, rec, audit_codes(g),
                             red._compactor.summary(), secs)
        cols, counts, bodies, rec, codes, summ, secs = runs[True]
        if not all(np.array_equal(np.asarray(a.cols[nm]),
                                  np.asarray(b.cols[nm]))
                   for a, b in zip(cols, runs[False][0])
                   for nm in ("key", "v0")):
            fail(f"phase 18 {label}: records differ from the kernels-off "
                 "twin")
        if min(bodies[:3]) < 1 or bodies[3] or sum(bodies) != nb \
                or counts["cond_select"] != nb \
                or counts["dense_monoid_table"] != nb:
            fail(f"phase 18 {label}: bodies (no_miss, ovf_small, "
                 f"ovf_big, none) {bodies}, launches {counts} in {nb} "
                 "batches")
        if rec["strict_steps"] != nb - 1:
            fail(f"phase 18 {label}: {rec['strict_steps']} strict steps "
                 f"of {nb}")
        if codes & {"WF906", "WF907"}:
            fail(f"phase 18 {label}: the capture audit found {codes}")
        off = runs[False]
        if off[1]["cond_select"] or any(off[2]) or "WF906" not in off[4]:
            fail(f"phase 18 {label} kernels off: launches {off[1]}, "
                 f"bodies {off[2]}, audit {off[4]} (the plain route's "
                 "host read must be WF906)")
        print(f"phase 18: PipeGraph.run() {label}: {nb} batches match the "
              f"oracle and the kernels-off twin; bodies (no_miss, "
              f"ovf_small, ovf_big) {bodies[:3]} (overflow lane "
              f"{overflow_cap(CAP)} lanes); {rec['strict_steps']} steps "
              f"under the strict mode; audit {sorted(codes)}, kernels off "
              f"{sorted(off[4])}; compactor hit rate "
              f"{summ['hit_rate']:.3f}, full-width fallbacks "
              f"{summ['big_fallbacks']}; launches {counts}; {secs:.3f} s, "
              f"off {off[6]:.3f} s (information only; {smi_line()})")
    return out


def check_cond_select(dev):
    """(c): the steering kernel against its plain twin for every index of
    1-, 2- and 3-body switches and three out-of-range ones, as a captured
    SWITCH node whose body j writes j + 1 (each replay runs the twin's
    pick; the device counters equal the twin's); then its time a launch
    beside the twin's.  Returns the kernel's JSON row (launches filled
    in by main)."""
    import torch
    from windflow_tpu_torch.kernels import cond_cuda as cc
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.kernels import loop_cuda as L
    cc.prepare(dev)
    with fc.uncounted():
        for nb in (1, 2, 3):
            for dtype in (torch.int32, torch.int64):
                site = f"phase 18 (c) {nb} {dtype}"
                index = torch.zeros((), dtype=dtype, device=dev)
                res = torch.zeros(1, dtype=torch.int64, device=dev)
                bodies = [lambda j=j: res.fill_(j + 1) for j in range(nb)]
                g = fc.CountedGraph(torch.cuda.CUDAGraph())
                with g.capture(L.side_capture(g.graph, dev)):
                    cc.emit_switch(index, bodies, site)
                plain = torch.zeros(nb + 1, dtype=torch.int64)
                for i in list(range(nb)) + [nb, -1, 1 << 20]:
                    index.fill_(i)
                    res.zero_()
                    g.replay()
                    pick = cc.cond_select_plain(
                        torch.tensor(i, dtype=dtype), nb, plain)
                    if int(res) != (pick + 1 if pick < nb else 0):
                        fail(f"phase 18 (c): cond_select ran body "
                             f"{int(res) - 1} for index {i} of {nb} "
                             f"({dtype}), its plain twin {pick}")
                if cc.body_counts(dev, site, nb) != plain.tolist():
                    fail(f"phase 18 (c): device counts "
                         f"{cc.body_counts(dev, site, nb)}, plain "
                         f"{plain.tolist()}")
    index = torch.ones((), dtype=torch.int32, device=dev)
    counts = torch.zeros(3, dtype=torch.int64)

    def kernel():
        cc.cond_select(index, 2, site="phase 18 (c) timing", count=False)

    def plain():
        cc.cond_select_plain(index, 2, counts)
    # the plain twin is a host read: both by CUDA events over
    # back-to-back calls, the kernel by torch.profiler beside them
    t = {"kernel": device_ms(kernel), "kernel_events": cuda_time(kernel),
         "plain": cuda_time(plain)}
    print(f"phase 18 (c) cond_select: kernel {t['kernel']:.5f} ms device / "
          f"{t['kernel_events']:.5f} ms events, plain {t['plain']:.5f} ms "
          f"events; equal to its plain twin for every index of 1-, 2- and "
          f"3-body switches and out of range ({smi_line()})")
    # a launch: the index read, one counter word read and written
    bound, by = bound_ms(4 + 2 * 8, 0)
    return {"name": "cond_select", "route": "cuda",
            "source": "windflow_tpu_torch/csrc/cond_select.cu",
            "replaces": "windflow_tpu/windows/ffat_kernels.py:733, "
                        "windflow_tpu/parallel/compaction.py:465-467 "
                        "(lax.cond)",
            "launches": 0, "max_abs_err": 0.0, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def cond_runs(dev_name="cuda"):
    """Phase 18: (a) the TB step's fold as a SWITCH node, (b) the
    compacted reduce's three branches, (c) the steering kernel against
    its plain twin.  Returns (launch counts by label, the kernel's JSON
    row)."""
    import torch
    out = {}
    t0 = time.perf_counter()
    out.update(cond_tb_runs(dev_name))
    t1 = time.perf_counter()
    out.update(cond_reduce_runs(dev_name))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    row = check_cond_select(torch.device(dev_name, 0)
                            if dev_name == "cuda"
                            else torch.device(dev_name))
    print(f"phase 18: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
          f"{time.perf_counter() - t2:.1f} s")
    return out, row


# ---------------------------------------------------------------------------
# phase 9: durable state (checkpoint, kill, restore, diff)
# ---------------------------------------------------------------------------

#: records a cell, tuples a staged batch, keys, logical sweeps an epoch
DUR_N, DUR_BATCH, DUR_KEYS, DUR_EPOCH = 1 << 20, 16384, 4096, 8
#: the (b) cells' keys: the count window's K + 1 grouping ids stay under
#: the grouping kernel's 4,096-bucket gate (4,096 keys would make 4,097)
DUR_B_KEYS = 1024
#: the state-heavy cell's dense key slots
DUR_HEAVY_KEYS = 1 << 20
#: records of the K = 1 stateful mid-window cell (cut in depth for the
#: script's time limit: it still commits two epochs, and the kill lands
#: between them)
DUR_CUT_N = 1 << 19
#: records of every (a) cell (cut in depth from DUR_N for the script's
#: time limit once phase 18 joined it: the kill still lands after the
#: first committed epoch, picked from the cell's baseline)
DUR_A_N = 1 << 19
#: the host reduce's rescale cells' records (cut in depth: its
#: per-record path reads ~23,000 tuples/s on the card's host)
DUR_RESCALE_N = 1 << 18


def dur_kill(point, op_name=None):
    """The seeded kill of a cell, picked from its completed baseline so
    that it fires after the first committed epoch and before the end:
    ``mid_epoch`` halfway between the first checkpoint's sweep and the
    last sweep, ``mid_sink_flush`` in the middle checkpoint,
    ``mid_window`` halfway between the victim's batches by the first
    checkpoint and its last."""
    from windflow_tpu_torch.durability import chaos

    def pick(gb):
        plane = gb._durability
        every = gb.config.durability_epoch_sweeps
        if plane.epochs_committed < 2:
            fail(f"phase 9: the baseline committed {plane.epochs_committed} "
                 "epoch(s); a kill needs one before it and one after")
        if point == "mid_epoch":
            after = max(every + 1, (every + plane._sweeps) // 2)
            if after >= plane._sweeps:
                fail(f"phase 9: no sweep between the first checkpoint "
                     f"({every}) and the end ({plane._sweeps})")
        elif point == "mid_sink_flush":
            after = max(2, plane.epochs_committed // 2 + 1)
        else:
            # the victim's batches by the first checkpoint, estimated
            # from the sweeps (plus one), then halfway to the last
            victim = [op for op in gb._operators if op.name == op_name][0]
            total = sum(r.stats.device_programs_launched
                        for r in victim.replicas)
            first = -(-total * every // plane._sweeps) + 1
            after = (first + total) // 2
            if after <= first or after >= total:
                fail(f"phase 9: no batch of '{op_name}' between the first "
                     f"checkpoint (~{first}) and the end ({total})")
        return chaos.KillSpec(point, after=after, op_name=op_name)
    return pick


def dur_line(label, v, n, shared=None):
    """One cell's line: records compared, epochs, the restored epoch,
    checkpoint cost an epoch (all of it, and the snapshot after the
    quiesce), restore cost, dedupes, host tuples/s."""
    ep = max(1, v["epochs_committed_baseline"])
    speed = (f"baseline shared with {shared}" if shared else
             f"baseline {n} tuples in {v['baseline_seconds']:.2f} s = "
             f"{n / v['baseline_seconds']:.0f} tuples/s")
    print(f"phase 9: {label}: {v['records']} records compared, equal; "
          f"kill {v['kill']['point']} after {v['kill']['after']}; "
          f"{v['epochs_committed_baseline']} epochs committed, restored "
          f"epoch {v['restored_epoch']}; checkpoint "
          f"{v['checkpoint_ms_total'] / ep:.3f} ms an epoch (snapshot "
          f"{v['snapshot_ms_total'] / ep:.3f} ms) and "
          f"{v['checkpoint_bytes_total'] / ep:.0f} bytes (last "
          f"{v['last_checkpoint_bytes']}); restore "
          f"{v['restore_ms']:.3f} ms; dedupe_hits {v['dedupe_hits']}; "
          f"{speed}, cell {v['seconds']:.2f} s (host clock, information "
          "only)")


def dur_input(n, keys, seed=None):
    """The cells' Kafka input: ``chaos.input_log`` (integer-valued
    float32 values), or with ``seed`` random float32 values."""
    from windflow_tpu_torch.durability import chaos
    msgs = chaos.input_log(n, keys)
    if seed is not None:
        rng = np.random.default_rng(seed)
        vals = rng.standard_normal(n).astype(np.float32)
        for m, v in zip(msgs, vals):
            m.value = {"key": m.value["key"], "value": v}
    return msgs


def dur_cell_graph(ckpt, msgs, tail, ser, name, **cfg):
    """A (b) cell built from the harness's parts outside ``make_cell``:
    an ``InMemoryBroker`` holding ``msgs``, a ``KafkaSource`` with the
    record spec declared, ``tail(pipe)`` on the card, a fenced
    ``KafkaSink``.  Returns ``(factory, read)``."""
    import dataclasses

    import windflow_tpu_torch as wt
    from windflow_tpu_torch.durability import chaos
    from windflow_tpu_torch.kafka import (InMemoryBroker, KafkaSink,
                                          KafkaSource)
    broker = InMemoryBroker()
    broker.create_topic("in", 1)
    broker._topics["in"][0].log.extend(msgs)

    def deser(msg, shipper):
        if msg is None:
            return True
        if msg.value == "EOS":
            return False
        shipper.pushWithTimestamp(msg.value, msg.timestamp_usec)
        return True

    def factory():
        c = dataclasses.replace(wt.default_config, durability=ckpt,
                                durability_epoch_sweeps=DUR_EPOCH,
                                punctuation_interval_usec=10 ** 12, **cfg)
        src = KafkaSource(deser, broker, ["in"], group_id="chaos",
                          name="ksrc", output_batch_size=DUR_BATCH)
        src.record_spec = {"key": np.int64(0), "value": np.float32(0.0)}
        g = wt.PipeGraph(name, config=c)
        tail(g.add_source(src)).add_sink(KafkaSink(ser, broker,
                                                   name="ksnk"))
        return g
    return factory, lambda: chaos.read_topic(broker, "out")


def dur_b_cell(label, workdir, msgs, tail, ser, kernels, dev_name):
    """A (b) cell: baseline, kill, restore, by the harness's functions;
    the launch counts of the restored run alone are read, and each of
    ``kernels`` must have launched in it."""
    import torch

    from windflow_tpu_torch.durability import chaos
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    fb, read_b = dur_cell_graph(os.path.join(workdir, "a"), msgs, tail,
                                ser, label, device=dev_name)
    fk, read_k = dur_cell_graph(os.path.join(workdir, "b"), msgs, tail,
                                ser, label, device=dev_name)
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    gb = chaos.run_baseline(fb)
    t1 = time.perf_counter()
    base_counts = fc.launch_counts()
    spec = dur_kill("mid_epoch")(gb)
    g = fk()
    g.start()
    chaos.arm(g, spec)
    try:
        g.wait_end()
        fail(f"phase 9 {label}: the kill never fired")
    except chaos.ChaosKill:
        chaos.abandon(g)
    fc.reset_launch_counts()
    g2 = fk()
    g2.restore(g2.config.durability)
    g2.wait_end()
    torch.cuda.synchronize()
    restored = fc.launch_counts()
    t2 = time.perf_counter()
    for k in kernels:
        if restored[k] <= 0:
            fail(f"phase 9 {label}: {k} never launched on the restored "
                 "path")
    base, got = read_b(), read_k()
    diff = chaos.diff_records(base, got)
    if diff is not None:
        fail(f"phase 9 {label}: restored output differs from the "
             f"uninterrupted run: {diff}")
    db, dr = gb.stats()["Durability"], g2.stats()["Durability"]
    v = {"kill": {"point": spec.point, "after": spec.after},
         "records": sum(len(p) for p in base),
         "epochs_committed_baseline": db["epochs_committed"],
         "restored_epoch": dr["restored_epoch"],
         "checkpoint_ms_total": db["checkpoint_ms_total"],
         "snapshot_ms_total": db["snapshot_ms_total"],
         "checkpoint_bytes_total": db["checkpoint_bytes_total"],
         "last_checkpoint_bytes": db["last_checkpoint_bytes"],
         "restore_ms": dr["restore_ms"], "dedupe_hits": dr["dedupe_hits"],
         "baseline_seconds": t1 - t0, "seconds": t2 - t0}
    dur_line(label, v, len(msgs) - 1)
    print(f"phase 9: {label}: launches on the restored run {restored}")
    return base_counts, restored


def durability_runs(dev_name="cuda"):
    """Phase 9: the port's chaos families on the card through
    ``chaos.run_ab`` (a), two cells that put the fold and the table
    kernels on a restored path (b), the rescale cells (c) and one
    state-heavy cell (d); every cell's output equals its uninterrupted
    baseline, every failure fails the run.  Returns each cell's launch
    counts by label."""
    import shutil
    import tempfile

    import torch

    import windflow_tpu_torch as wt
    from windflow_tpu_torch.durability import chaos
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    out = {}
    root = tempfile.mkdtemp(prefix="wf_phase9_")
    msgs = dur_input(DUR_A_N, DUR_KEYS)
    cfg = {"device": dev_name, "n": DUR_A_N, "keys": DUR_KEYS,
           "output_batch_size": DUR_BATCH, "epoch_sweeps": DUR_EPOCH,
           "messages": msgs}

    def cell(family, tag, **kw):
        d = os.path.join(root, tag)
        args = dict(cfg, **kw)
        if family == "window_compact":
            # 4,096 sparse ids: one remap slot each
            args["key_compaction_slots"] = DUR_KEYS
        return (chaos.make_cell(family, os.path.join(d, "ck_a"),
                                out_dir=os.path.join(d, "out_a"), **args),
                chaos.make_cell(family, os.path.join(d, "ck_b"),
                                out_dir=os.path.join(d, "out_b"), **args))

    baselines = {}

    def ab(label, family, point, shared=None, **kw):
        """One cell through ``chaos.run_ab``; ``shared`` names an earlier
        cell of the family whose baseline (the same graph and stream)
        this kill is held against instead of running its own."""
        base, chal = cell(family, label.replace(" ", "_"), **kw)
        held = {}

        def factory_baseline():
            held["g"] = base["factory"]()
            return held["g"]
        prev = baselines.get(shared)
        fc.reset_launch_counts()
        v = chaos.run_ab(factory_baseline, chal["factory"],
                         dur_kill(point, chaos.VICTIM[family]
                                  if point == "mid_window" else None),
                         prev[1] if prev else base["read"], chal["read"],
                         baseline=prev[0] if prev else None)
        torch.cuda.synchronize()
        out[f"9 {label}"] = fc.launch_counts()
        if v["diff"] is not None:
            fail(f"phase 9 {label}: {v['diff']}")
        if v["restored_epoch"] is None or v["records"] <= 0:
            fail(f"phase 9 {label}: nothing restored or compared")
        if prev is None:
            baselines[label] = (held["g"], base["read"])
        dur_line(label, v, kw.get("n", cfg["n"]), shared)
        return v

    # (a) the six families killed mid-epoch, fused (K = 8, wire on)
    for family in chaos.FAMILIES:
        ab(f"(a) {family} mid_epoch", family, "mid_epoch")
    v = ab("(a) window_cb mid_sink_flush", "window_cb", "mid_sink_flush",
           shared="(a) window_cb mid_epoch")
    if not v["dedupe_hits"]:
        fail("phase 9 (a) window_cb mid_sink_flush: no dedupe hit")
    # the mid_window kill counts the victim replica's per-batch steps;
    # at K = 8 the stateful tail folds into groups (its device loop),
    # whose batches no replica step processes: this cell runs at K = 1
    # with its own baseline
    ab("(a) stateful K=1 mid_window", "stateful", "mid_window",
       megastep_sweeps=1, n=DUR_CUT_N, messages=None)
    # its own baseline: the kill is picked from K = 1's sweeps
    ab("(a) window_cb K=1 mid_epoch", "window_cb", "mid_epoch",
       megastep_sweeps=1)
    baselines.clear()
    del msgs, cfg["messages"]

    # (b) the declared f32 sum (the fold kernel) and the compacted
    # ReduceGPU sum (the table kernel behind the remap), Kafka-fed
    def f32_window(pipe):
        return pipe.add(wt.Ffat_WindowsGPU_Builder(lambda t: t["value"],
                                                   lambda a, b: a + b)
                        .withCBWindows(16, 8).withKeyBy(lambda t: t["key"])
                        .withMaxKeys(DUR_B_KEYS).withSumCombiner()
                        .withName("w").build())

    def bits(r):
        # every field's exact float value: the diff is bit for bit
        return tuple(sorted((k, float(v).hex()) for k, v in r.items()))

    from windflow_tpu_torch.kafka import KafkaSinkMessage
    b_msgs = dur_input(DUR_N, DUR_B_KEYS, seed=9)
    base_c, rest_c = dur_b_cell(
        "(b) f32 sum window", os.path.join(root, "b1"), b_msgs, f32_window,
        lambda r: KafkaSinkMessage("out", bits(r)),
        ("grouping_rank_hist", "sliding_fold"), dev_name)
    out["9 (b) f32 sum window baseline"] = base_c
    out["9 (b) f32 sum window restored"] = rest_c

    def compacted_sum(pipe):
        # the declared sum covers the key field too (key * count)
        return pipe.add(wt.ReduceGPU_Builder(
            lambda a, b: {"key": a["key"] + b["key"],
                          "value": a["value"] + b["value"]})
            .withKeyBy(lambda t: t["key"]).withSumCombiner()
            .withName("red").build())

    b_msgs = dur_input(DUR_N, DUR_B_KEYS)
    base_c, rest_c = dur_b_cell(
        "(b) compacted reduce sum", os.path.join(root, "b2"), b_msgs,
        compacted_sum, lambda r: KafkaSinkMessage("out", bits(r)),
        ("dense_monoid_table",), dev_name)
    out["9 (b) compacted reduce sum baseline"] = base_c
    out["9 (b) compacted reduce sum restored"] = rest_c
    del b_msgs

    # (c) rescale: the host reduce 3 -> 2 and 3 -> 4 (cut in depth),
    # window_cb 2 -> 3
    for family, k, r, n in (("reduce", 3, 2, DUR_RESCALE_N),
                            ("reduce", 3, 4, DUR_RESCALE_N),
                            ("window_cb", 2, 3, DUR_N)):
        label = f"(c) {family} rescale {k}->{r}"
        fc.reset_launch_counts()
        v = chaos.run_rescale_ab(
            family, "mid_epoch", os.path.join(root, f"c_{family}_{r}"),
            shards_kill=k, shards_restore=r, n=n, keys=DUR_KEYS,
            output_batch_size=DUR_BATCH, epoch_sweeps=DUR_EPOCH,
            messages=dur_input(n, DUR_KEYS), device=dev_name,
            spec=dur_kill("mid_epoch"))
        torch.cuda.synchronize()
        out[f"9 {label}"] = fc.launch_counts()
        if v["diff"] is not None:
            fail(f"phase 9 {label}: {v['diff']}")
        dur_line(label + " (per key)", v, n)

    # (d) the state-heavy cell: the stateful family at 1,048,576 slots
    h_msgs = dur_input(DUR_N, DUR_HEAVY_KEYS)
    cfg["messages"], cfg["keys"], cfg["n"] = h_msgs, DUR_HEAVY_KEYS, DUR_N
    ab("(d) stateful 1,048,576 slots mid_epoch", "stateful", "mid_epoch")
    shutil.rmtree(root, ignore_errors=True)
    return out


def main():
    t_all = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    try:
        from windflow_tpu_torch.kernels import build
        from windflow_tpu_torch.kernels import ffat_cuda as fc
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        sys.exit(2)
    if "jax" in sys.modules or "windflow_tpu" in sys.modules:
        fail("JAX or the JAX package was imported")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 1. build: the CUDA kernels, and the native host library beside them
    import threading

    from windflow_tpu_torch import native
    t0 = time.perf_counter()
    host_lib = {}

    def build_native():
        t = time.perf_counter()
        try:
            host_lib["path"] = native.build()
        except Exception as e:  # lint: broad-except-ok (reported below)
            host_lib["error"] = f"{type(e).__name__}: {e}"
        host_lib["secs"] = time.perf_counter() - t
    th = threading.Thread(target=build_native)
    th.start()
    nvcc_s = build.build_all()
    th.join()
    if "error" in host_lib or not native.is_available():
        fail(f"phase 1: the native host library did not build: "
             f"{host_lib.get('error') or native.build_error()}")
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {nvcc_s:.2f} s, {build.nvcc_runs} compilations); the "
          f"native host library in {host_lib['secs']:.2f} s "
          f"({os.path.basename(host_lib['path'])})")

    # 2. kernels against their plain versions
    rows = check_grouping(dev) + check_grouping_tb(dev) + check_fold(dev) \
        + check_fold_ticker(dev) + check_table(dev)
    print("phase 2: kernels equal their plain versions at the main-path "
          "shapes and edges")

    # 3. the main path, counts read just after each run, by run label
    run_counts = {}
    for sum_comb, need in ((False, ("grouping_rank_hist",)),
                           (True, ("grouping_rank_hist", "sliding_fold"))):
        fc.reset_launch_counts()
        nrec, secs, n = run_main_path("cuda", sum_comb)
        counts = fc.launch_counts()
        for name in need:
            if counts[name] <= 0:
                fail(f"main path ({'sum' if sum_comb else 'generic'} "
                     f"combiner) never launched {name}")
        if sum_comb and counts["sliding_fold"] != BATCHES:
            fail(f"the sum combiner's run launched sliding_fold "
                 f"{counts['sliding_fold']} times in {BATCHES} steps")
        run_counts["ffat sum" if sum_comb else "ffat generic"] = counts
        print(f"phase 3: PipeGraph.run() {'withSumCombiner' if sum_comb else 'generic combiner'}: "
              f"{nrec} windows match the oracle; {n} tuples in {secs:.3f} s "
              f"= {n / secs:.0f} tuples/s (host clock, information only); "
              f"launches {counts}")
    # the reduce path: (route, monoid, declared, key_compaction, batches,
    # key range, the kernel launched or not)
    from windflow_tpu_torch.parallel.compaction import overflow_cap
    runs = [("(a) compacted", "max", True, True, BATCHES, KEYS, True),
            ("(b) compacted sum", "sum", True, True, BATCHES, KEYS, True),
            ("(c) dense", "max", True, False, 4, KEYS, True),
            ("(d) sorted", "max", False, True, 4, KEYS, False),
            ("(e) compacted, keys < 1040", "max", True, True, 2, 1040, True),
            ("(e) compacted, keys < 1100", "max", True, True, 2, 1100, True),
            ("(e) dense, keys < 1040", "max", True, False, 2, 1040, True),
            ("(e) dense, keys < 1100", "max", True, False, 2, 1100, True)]
    for label, monoid, declare, kc, nb, kr, need in runs:
        fc.reset_launch_counts()
        nrec, secs, n, st = run_reduce("cuda", monoid, declare, kc, nb,
                                       key_range=kr)
        counts = fc.launch_counts()
        got_k = counts["dense_monoid_table"]
        if need and got_k <= 0:
            fail(f"reduce {label} never launched dense_monoid_table")
        if not need and got_k:
            fail(f"reduce {label} launched dense_monoid_table")
        run_counts[label] = counts
        extra = ""
        if "Key_compaction" in st:
            kcs = st["Key_compaction"]
            extra = (f"; rerouted {kcs['overflow_tuples']}, full-width "
                     f"fallbacks {kcs['big_fallbacks']} (overflow lane "
                     f"{overflow_cap(CAP)} lanes)")
            if kr == 1040 and (kcs["overflow_tuples"] == 0
                               or kcs["big_fallbacks"]):
                fail(f"reduce {label} did not take the overflow lane")
            if kr == 1100 and kcs["big_fallbacks"] != nb:
                fail(f"reduce {label} did not take the full-width lane")
        if "Out_of_range_keys_dropped" in st:
            extra = f"; dropped {st['Out_of_range_keys_dropped']}"
        print(f"phase 3: PipeGraph.run() reduce {label}: {nrec} records "
              f"match the oracle batch by batch; {n} tuples in {secs:.3f} s "
              f"= {n / secs:.0f} tuples/s (host clock, information only); "
              f"launches {counts}{extra}")
    # 4. the time-window runs, counts read just after each run
    run_counts.update(tb_runs())
    # 5. the columnar ingest runs, counts read just after each run
    run_counts.update(columnar_runs())
    # 6. fusion, keyed routing, split and merge, counts read just after
    #    each run
    run_counts.update(routing_runs())
    # 7. stateful operators and key compaction, counts read just after
    #    each run
    t7 = time.perf_counter()
    run_counts.update(stateful_runs())
    print(f"phase 7: {time.perf_counter() - t7:.1f} s")
    # 8. the wire plane and the megastep, counts read just after each run
    t8 = time.perf_counter()
    run_counts.update(megastep_runs())
    print(f"phase 8: {time.perf_counter() - t8:.1f} s")
    # 9. durable state: checkpoint, kill, restore and diff, counts read
    #    just after each cell
    t9 = time.perf_counter()
    run_counts.update(durability_runs())
    print(f"phase 9: {time.perf_counter() - t9:.1f} s")
    # 10. the observability plane, counts read just after each run
    t10 = time.perf_counter()
    run_counts.update(observability_runs())
    print(f"phase 10: {time.perf_counter() - t10:.1f} s")
    # 11. the observability plane, part two, counts read just after each
    #     run
    t11 = time.perf_counter()
    run_counts.update(plane_runs())
    print(f"phase 11: {time.perf_counter() - t11:.1f} s (budget 60 s)")
    # 12. the analysis plane, counts read just after each run
    t12 = time.perf_counter()
    run_counts.update(analysis_runs())
    t12g = time.perf_counter()
    run_counts.update(audit_runs())
    print(f"phase 12 (g)-(k): {time.perf_counter() - t12g:.1f} s "
          "(budget 20 s)")
    print(f"phase 12: {time.perf_counter() - t12:.1f} s (budget 50 s)")
    # 13. the host window engine, the persistent operators and the apps,
    #     counts read just after each run
    t13 = time.perf_counter()
    run_counts.update(host_window_runs())
    print(f"phase 13: {time.perf_counter() - t13:.1f} s (budget 90 s)")
    # 14. the serving plane and the native host runtime, counts read just
    #     after each run
    t14 = time.perf_counter()
    run_counts.update(serving_runs())
    print(f"phase 14: {time.perf_counter() - t14:.1f} s (budget 45 s)")
    # 15. the host worker pool, counts read just after each run
    t15 = time.perf_counter()
    run_counts.update(pool_runs())
    print(f"phase 15: {time.perf_counter() - t15:.1f} s (budget 40 s)")
    # 16. the mesh, counts read just after each run
    t16 = time.perf_counter()
    run_counts.update(mesh_runs())
    print(f"phase 16: {time.perf_counter() - t16:.1f} s (budget 60 s)")
    # 17. the stateful wavefront as a device loop, counts read just after
    #     each run
    t17 = time.perf_counter()
    counts17, wave_row = wavefront_runs()
    run_counts.update(counts17)
    print(f"phase 17: {time.perf_counter() - t17:.1f} s (budget 60 s)")
    # 18. the JAX package's lax.conds as conditional nodes, counts read
    #     just after each run
    t18 = time.perf_counter()
    counts18, cond_row = cond_runs()
    run_counts.update(counts18)
    print(f"phase 18: {time.perf_counter() - t18:.1f} s (budget 45 s)")
    if "jax" in sys.modules or "windflow_tpu" in sys.modules:
        fail("JAX or the JAX package was imported")
    # each kernel row's launches: the runs that make its calls (the
    # table's (e) runs make the calls of routes (a) and (c))
    cb_runs = ("ffat generic", "ffat sum", "(i) frames generic",
               "(i) frames sum", "(iii) device source generic",
               "(iii) device source sum", "6(a) cb generic unfused",
               "6(a) cb generic fused", "6(a) cb sum unfused",
               "6(a) cb sum fused", "6(c) split",
               "7(e) compacted windows generic",
               "7(e) compacted windows sum")
    # phase 8's runs (their K = 8 launches counted through the replays)
    ms8 = [t for t in run_counts if t.startswith("8 ")]
    cb_runs += tuple(t for t in ms8 if t.startswith("8 (i)"))
    # phase 9's window cells (at 4,096 keys the count window's 4,097
    # grouping ids are past the grouping kernel's gate: (b) launches it)
    dur9 = [t for t in run_counts if t.startswith("9 ")]
    cb_runs += tuple(t for t in dur9 if "window" in t)
    # phase 10's traced count-window runs, phase 11's count-window runs
    cb_runs += tuple(t for t in run_counts if t.startswith("10(a)"))
    cb_runs += tuple(t for t in run_counts
                     if t.startswith(("11(b)", "11(e)", "11(c) tenant cb")))
    kc11 = tuple(t for t in run_counts if t.startswith("11(c) tenant kc"))
    # phase 13's count-window runs on the card: the apps (a) and (b) and
    # (e)'s device twin; the ticker's fold calls are its own row's
    cb_runs += ("13(a) ffat_analytics", "13(e) Ffat_WindowsGPU sum")
    # phase 14's count-window runs: (d)'s ingest, native and numpy
    cb_runs += tuple(t for t in run_counts if t.startswith("14(d)"))
    # phase 16's mesh runs: the count windows of (a) and (e), the TB
    # grouping-kernel shape of (b)
    cb_runs += tuple(t for t in run_counts
                     if t.startswith(("16(a)", "16(e) windows")))
    tb16 = tuple(t for t in run_counts
                 if t.startswith("16(b) TB grouping kernel"))
    ticker = ("13(b) market_ticker",)
    runs_of = {"grouping_rank_hist": cb_runs + ticker,
               "grouping_rank_hist[tb]": ("(c) grouping kernel",
                                          "14(a) move_keys K=1",
                                          "14(a) move_keys K=8") + tb16,
               "sliding_fold[dense]": cb_runs,
               "sliding_fold[main]": cb_runs,
               "sliding_fold[ticker]": ticker,
               "dense_monoid_table[a]": ("(a) compacted",
                                         "(e) compacted, keys < 1040",
                                         "(e) compacted, keys < 1100",
                                         "6(a) reduce max unfused",
                                         "6(a) reduce max fused",
                                         "6(b) merge reduce max",
                                         "6(d) keyed staging",
                                         "7(d) compacted reduce max",
                                         "10(b) compacted reduce max",
                                         "10(c) merge reduce max, device "
                                         "sketch", "14(f) tenant 0",
                                         "14(f) tenant 1"),
               "dense_monoid_table[b]": ("(b) compacted sum",
                                         "6(b) merge reduce sum",
                                         "6(c) split",
                                         "7(d) compacted reduce sum",
                                         "10(b) compacted reduce sum",
                                         "14(b) split_hot_key")
               + tuple(t for t in dur9 if "reduce sum" in t) + kc11,
               "dense_monoid_table[c]": ("(c) dense", "(e) dense, keys < 1040",
                                         "(e) dense, keys < 1100")
               + tuple(t for t in ms8 if t.startswith("8 dense"))}
    for r in rows:
        counter = r["name"].split("[")[0]
        r["launches"] = sum(run_counts[label][counter]
                            for label in runs_of[r["name"]])
    # the wavefront's loop runs in every stateful run with the kernels on
    # (phases 7, 9 and 17): its launches are every run's
    wave_row["launches"] = sum(c.get("wavefront_loop", 0)
                               for c in run_counts.values()
                               if isinstance(c, dict))
    rows.append(wave_row)
    # the steering kernel of the TB fold and of the compacted reduce's
    # branches launches in every such run with the kernels on: its
    # launches are every run's
    cond_row["launches"] = sum(c.get("cond_select", 0)
                               for c in run_counts.values()
                               if isinstance(c, dict))
    rows.append(cond_row)

    print(f"chip_smoke: {time.perf_counter() - t_all:.1f} s in all "
          "(limit 1,200 s)")
    print(smi_line())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
