"""Maximal fusible chains over a composed PipeGraph (the port of
``_chain_boundary``, ``_terminal`` and ``fusible_chains`` of
``windflow_tpu/analysis/fusion.py:39-126``).

A chain is a run of adjacent device operators whose edges let one hop
replace the whole run.  An edge ``a -> b`` ends a chain at a fan-out
(split or several consumers), a fan-in (merge), a change of
parallelism, a KEYBY edge to more than one replica, or any other
routing than FORWARD; a single-replica KEYBY edge is a relay and joins.
A window, reduce or stateful operator ends a chain too: its output is a
different stream, or depends on per-key state.  The fusion advisor
(``analysis/fusion.plan``) ranks these chains by projected savings.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from windflow_tpu_torch.basic import RoutingMode


def _chain_boundary(a, b, fanout: Dict[int, int],
                    fanin: Dict[int, int]) -> Optional[str]:
    """Why the edge ``a -> b`` cannot join one fused hop; ``None`` when it
    can."""
    from windflow_tpu_torch.ops.source import Source
    if not a.is_gpu or isinstance(a, Source):
        return "upstream is not a GPU stage"
    if not b.is_gpu:
        return "downstream leaves the device (host stage / sink)"
    if fanout.get(id(a), 0) != 1:
        return "upstream fans out (split / multi-consumer)"
    if fanin.get(id(b), 0) != 1:
        return "downstream merges several inputs"
    if a.parallelism != b.parallelism:
        return "parallelism changes across the edge"
    if b.routing == RoutingMode.FORWARD:
        return None
    if b.routing == RoutingMode.KEYBY:
        if b.parallelism != 1:
            return "keyby edge re-partitions across replicas"
        if b.key_extractor is None:
            return "keyby edge without a device key extractor"
        return None     # single-replica keyby: the emitter is a relay
    return f"{b.routing.value} routing breaks the device chain"


def _terminal(op) -> bool:
    """Operators that end a chain even when linkable: their output is a
    different stream (window results, reduced batches), or it depends on
    per-key state (a stateful map or filter)."""
    from windflow_tpu_torch.ops.gpu_stateful import _StatefulGPUBase
    from windflow_tpu_torch.ops.reduce import ReduceGPU
    from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
    return isinstance(op, (ReduceGPU, FfatWindowsGPU, _StatefulGPUBase))


def edge_degrees(edges):
    """``(fanout, fanin, op_edges)`` over :meth:`PipeGraph._edges`: a
    split point fans its source out once a branch."""
    fanout: Dict[int, int] = {}
    fanin: Dict[int, int] = {}
    op_edges = []
    for edge in edges:
        if edge[0] == "op":
            _, a, b = edge
            op_edges.append((a, b))
            fanout[id(a)] = fanout.get(id(a), 0) + 1
            fanin[id(b)] = fanin.get(id(b), 0) + 1
        else:
            _, mp = edge
            src = mp.operators[-1]
            fanout[id(src)] = fanout.get(id(src), 0) \
                + len(mp.split_children)
    return fanout, fanin, op_edges


def fusible_chains(graph) -> List[dict]:
    """Maximal fusible chains of a composed (built or unbuilt) PipeGraph:
    ``[{"ops": [op, ...], "links": [kind, ...], "tail_boundary": why the
    chain ends}, ...]``, two operators or more.  A link is ``chainable``
    when ``MultiPipe.chain`` could already fuse its ends, else
    ``whole_chain`` (a window/reduce tail or a single-replica KEYBY
    relay)."""
    from windflow_tpu_torch.ops.chained import chainable
    fanout, fanin, op_edges = edge_degrees(graph._edges())
    links: Dict[int, tuple] = {}
    linked_in = set()
    for a, b in op_edges:
        if _chain_boundary(a, b, fanout, fanin) is None \
                and not _terminal(a):
            kind = ("chainable" if chainable(a) and chainable(b)
                    and b.routing == RoutingMode.FORWARD else "whole_chain")
            links[id(a)] = (b, kind)
            linked_in.add(id(b))
    chains = []
    seen = set()
    for a, _ in op_edges:
        if id(a) in seen or id(a) in linked_in or id(a) not in links:
            continue
        ops = [a]
        kinds = []
        cur = a
        while id(cur) in links:
            nxt, kind = links[id(cur)]
            ops.append(nxt)
            kinds.append(kind)
            seen.add(id(cur))
            cur = nxt
        seen.add(id(cur))
        tail = None
        for b2 in (b for x, b in op_edges if x is cur):
            tail = _chain_boundary(cur, b2, fanout, fanin) \
                or ("chain tail is a window/reduce stage"
                    if _terminal(cur) else None)
        chains.append({"ops": ops, "links": kinds, "tail_boundary": tail})
    return chains
