"""Fusion executor: run whole operator chains as one hop (the port of
``windflow_tpu/fusion/executor.py``).

At ``PipeGraph._build`` every executable chain — a run of stateless
device stages (map / filter / chained pairs), optionally ending in one
window, reduce or dense-key stateful tail — is routed as ONE hop:

* **Prelude** — :func:`build_prelude` folds the stateless members'
  record transforms into one ``(payload, valid) -> (payload, valid)``
  function.  A window, reduce or dense-key stateful tail applies it
  ahead of its own step (``FfatWindowsGPU._build_step``, ``ReduceGPU``'s
  step builders and ``_StatefulGPUBase._get_step`` consult
  ``op._fused_prelude``), so the tail's host machinery — TB ring
  regrow and rebase, EOS flush, overflow policy — keeps working with the
  prelude inside; a ring regrow rebuilds the step with it.
* **Stateless host** — an all-stateless chain has no tail step to extend:
  :class:`FusedStatelessExec` runs the combined stages (plus the
  downstream KEYBY consumer's key extraction, when there is one) on the
  last member's replicas, through ``_GPUReplica._op_step``.
* **Graph rewiring** — ``PipeGraph._build`` wires the edge INTO a
  segment's head to the segment's last member instead, skips the
  interior edges, and marks the other members' replicas inert.  They
  stay in the graph; ``stats()`` attributes their counters from the
  fused hop (:func:`attribute_member_stats`).

In eager PyTorch a fused hop launches the members' kernels as before:
what fusion removes is the hop itself — the intermediate ``DeviceBatch``,
the device pass emitter, the inbox and collector pass, and the members'
own replica steps — so each batch's device work is one Python call
(prelude + tail step).  ``Config.whole_chain_fusion`` is the kill switch.

The shard plane (``monitoring/shard_ledger.py``) folds its key-skew
sketch into a stateless host whose chain extracts a downstream KEYBY
consumer's keys (``attach_shard_sketch``): the update runs on the card
in the same step, on the keys the chain computed.  The fused hop counts
its dispatches on its own step-registry handle (``watch``), under the
segment's name.

Not ported, as they have no torch twin: XLA input-buffer donation
(``donation_aliases_cleanly``, ``input_donation_safe``,
``enable_input_donation``; the port's steps update their state in place
already).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from windflow_tpu_torch.batch import DeviceBatch


def fused_name(members) -> str:
    """Name of a fused segment: the chained pair's ``a|b`` convention
    extended to the whole run."""
    return "|".join(op.name for op in members)


def _is_stateless(op) -> bool:
    from windflow_tpu_torch.ops.chained import chainable
    return chainable(op)


def _tail_supported(op) -> bool:
    """Chain tails that take a prelude: count and time windows over a
    declared key space, the reduce on every route, and a stateful
    operator with dense keys.  An interning stateful tail is left out
    (its distinct keys go to the host before the step, which the
    prelude's output would have to reach mid-step): the prefix fuses
    and the tail does not.  So is a compacted window (its keys are
    admitted at the host staging boundary, which a prelude would move
    behind the chain)."""
    from windflow_tpu_torch.ops.gpu_stateful import _StatefulGPUBase
    from windflow_tpu_torch.ops.reduce import ReduceGPU
    from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
    if isinstance(op, FfatWindowsGPU):
        return op.max_keys is not None
    if isinstance(op, _StatefulGPUBase):
        return bool(op.dense_keys)
    return isinstance(op, ReduceGPU)


def build_prelude(members):
    """One ``(payload, valid) -> (payload, valid)`` function applying every
    stateless member's record transform in chain order.  Returns
    ``(prelude, has_filter)``."""
    from windflow_tpu_torch.ops.chained import gpu_stages
    from windflow_tpu_torch.ops.gpu import FilterGPU
    stages = []
    for op in members:
        stages.extend(gpu_stages(op))
    has_filter = any(isinstance(st, FilterGPU) for st in stages)

    def prelude(payload, valid):
        for st in stages:
            payload, valid = st.apply(payload, valid)
        return payload, valid

    return prelude, has_filter


def prelude_out_payload(prelude: Callable, payload, valid):
    """The post-prelude payload of a one-lane slice of a batch: what a
    tail's record checks and state layouts are sized against when a
    prelude rewrites the records (the JAX package's ``prelude_out_spec``,
    which has ``jax.eval_shape``; here one lane of real device work, and
    no host read)."""
    from windflow_tpu_torch.utils.tree import tree_map
    one = tree_map(lambda a: a[:1], payload)
    return prelude(one, valid[:1])[0]


class FusedStatelessExec:
    """Executor of an all-stateless fused segment, installed on the LAST
    member (the segment host) and run by its replicas.  Batch contract of
    ``ChainedGPU``: the size is unknown after any filter; watermark,
    frontier and ts extrema relay.  With a downstream KEYBY consumer, its
    key extractor runs on the chain's output records and the keys ride
    the output batch."""

    def __init__(self, name: str, members) -> None:
        self.name = name
        self._prelude, self._has_filter = build_prelude(members)
        self._key_extractor: Optional[Callable] = None
        self._watch = None
        #: shard-plane sketch, its consumer's replica count and its
        #: device state (made at the first sketched batch)
        self._sketch = None
        self._sk_n = 1
        self._sk_state = None

    @property
    def watch(self):
        """The fused hop's handle in the step registry."""
        if self._watch is None:
            from windflow_tpu_torch.monitoring.jit_registry import \
                default_registry
            self._watch = default_registry().watch(self.name)
        return self._watch

    def set_downstream_key_extractor(self, key_fn: Callable) -> None:
        self._key_extractor = key_fn

    def attach_shard_sketch(self, sketch, n_shards: int) -> None:
        """Fold the shard sketch's update into this step (graph build):
        the keys computed for the downstream KEYBY consumer feed it, and
        ``n_shards`` (the consumer's replicas) gives the per-shard
        counts the keyby placement would."""
        self._sketch = sketch
        self._sk_n = max(1, n_shards)
        sketch.register_device_state(lambda: self._sk_state)

    def step(self, batch: DeviceBatch) -> DeviceBatch:
        payload, valid = self._prelude(batch.payload, batch.valid)
        keys = None
        if self._key_extractor is not None:
            import torch
            from windflow_tpu_torch.utils.tree import per_record
            keys = per_record(self._key_extractor, payload,
                              batch.capacity).to(torch.int32)
            if self._sketch is not None:
                from windflow_tpu_torch.monitoring.shard_ledger import (
                    device_sketch_init, device_sketch_update)
                if self._sk_state is None:
                    self._sk_state = device_sketch_init(self._sk_n,
                                                        keys.device)
                device_sketch_update(self._sk_state, keys, valid, self._sk_n)
        size = None if self._has_filter else batch.known_size
        return DeviceBatch(payload, batch.ts, valid, keys=keys,
                           watermark=batch.watermark, size=size,
                           frontier=batch.frontier, ts_max=batch.ts_max,
                           ts_min=batch.ts_min)


def plan_segments(graph) -> List[dict]:
    """Executable fused segments of a composed graph: each chain of
    :func:`~windflow_tpu_torch.fusion.chains.fusible_chains` trimmed to
    its stateless prefix plus at most one supported tail.  Segments of
    fewer than two members are dropped."""
    from windflow_tpu_torch.fusion.chains import fusible_chains
    segments = []
    for chain in fusible_chains(graph):
        run = []
        for op in chain["ops"]:
            if _is_stateless(op):
                run.append(op)
                continue
            if run and _tail_supported(op):
                run.append(op)
            break
        if len(run) < 2:
            continue
        segments.append({
            "name": fused_name(run),
            "members": run,
            "member_names": [op.name for op in run],
            "host_name": run[-1].name,
        })
    return segments


def apply_fusion(graph) -> List[dict]:
    """Install the fused segments on a graph being built (after replica
    construction, before edge wiring): mark the members, install the
    prelude or the stateless executor on each segment's host, and chain
    the members' closing functions onto it.  Returns the segments."""
    segments = plan_segments(graph)
    for seg in segments:
        members = seg["members"]
        host = members[-1]
        for m in members[:-1]:
            m._fused_into = seg["name"]
        if _is_stateless(host):
            host._fusion_exec = FusedStatelessExec(seg["name"], members)
        else:
            host._fused_prelude = build_prelude(members[:-1])[0]
        _chain_closers(members, host)
    return segments


def _chain_closers(members, host) -> None:
    """The members' closing functions run at the HOST's termination (its
    replicas are the only ones that terminate through EOS), once each."""
    from windflow_tpu_torch.ops.chained import chain_closers
    closers = [m.closing_func for m in members if m.closing_func is not None]
    if not closers or closers == [host.closing_func]:
        return
    host.closing_func = chain_closers(closers)


def attribute_member_stats(graph) -> None:
    """Counters of fused members, attributed from the fused hop: their
    replicas never step, so their inputs and outputs mirror the host
    hop's input count (survivors of an interior filter are only known
    with a device read).  Replica 0 carries the whole hop's number."""
    for seg in graph._fused_segments:
        host = seg["members"][-1]
        inputs = sum(r.stats.inputs_received for r in host.replicas)
        for m in seg["members"][:-1]:
            for i, rep in enumerate(m.replicas):
                rep.stats.inputs_received = inputs if i == 0 else 0
                rep.stats.outputs_sent = inputs if i == 0 else 0
