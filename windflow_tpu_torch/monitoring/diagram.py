"""PipeGraph diagram as graphviz DOT text (the port of ``to_dot`` in
``windflow_tpu/monitoring/diagram.py``; reference ``pipegraph.hpp:
560-576``).  Device operators are marked ``[GPU]`` and filled gold;
KEYBY edges are labelled ``KB``, BROADCAST ``BC``, split edges dashed.
The SVG rendering (``to_svg``) waits for the dashboard item."""

from __future__ import annotations

from typing import List, Tuple


def _node_id(op) -> str:
    return f"op{id(op):x}"


def _graph_nodes_edges(graph) -> Tuple[List, List]:
    ops = list(graph._operators) or graph._topo_operators()
    edges = []
    for edge in graph._edges():
        if edge[0] == "op":
            _, a, b = edge
            edges.append((a, b, b.routing.name))
        else:  # a split point: an edge to every branch head
            _, mp = edge
            src = mp.operators[-1]
            for child in mp.split_children:
                edges.append((src, child.operators[0], "SPLIT"))
    return ops, edges


def _dot_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def _label(op) -> str:
    kind = type(op).__name__
    extra = " [GPU]" if op.is_gpu else ""
    return f"{_dot_escape(op.name)}\\n{kind}{extra} ({op.parallelism})"


def to_dot(graph) -> str:
    """Graphviz DOT text of a PipeGraph (built or only composed)."""
    ops, edges = _graph_nodes_edges(graph)
    lines = [f'digraph "{_dot_escape(graph.name)}" {{',
             "  rankdir=LR;",
             '  node [shape=box, style="rounded,filled", '
             'fillcolor=lightblue, fontname=Helvetica];']
    for op in ops:
        fill = "gold" if op.is_gpu else "lightblue"
        lines.append(f'  {_node_id(op)} [label="{_label(op)}", '
                     f'fillcolor={fill}];')
    for a, b, routing in edges:
        style = ' [label="KB"]' if routing == "KEYBY" else \
                ' [label="BC"]' if routing == "BROADCAST" else \
                ' [style=dashed]' if routing == "SPLIT" else ""
        lines.append(f"  {_node_id(a)} -> {_node_id(b)}{style};")
    lines.append("}")
    return "\n".join(lines)
