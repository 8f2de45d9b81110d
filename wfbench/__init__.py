"""The benchmark of the PyTorch/CUDA port ``windflow_tpu_torch``.

One command runs one cell once (``python3 wfbench/run.py --workload
<config>.<traffic> --seed <n> --seconds <s> --trace <0|1>``).  Everything
that belongs to one configuration, traffic mix or per-layer metric is a
file of its own that the harness finds by name:

* ``configs/<config>.json``: the deployment's sizes, source, ``reduced``
  and ``assumed``; ``configs/<config>.py``: its graph, built through the
  port's public builders, and how its sink's columns become results;
* ``reference/<config>.py``: the plain numpy reference of its results;
* ``traffic/<mix>.json``: the parameters the one generator
  (``generator.py``) reads;
* ``metrics/<metric>.py``: the reader of one per-layer metric.
"""
