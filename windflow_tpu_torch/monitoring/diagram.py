"""PipeGraph diagrams (the port of ``windflow_tpu/monitoring/
diagram.py``; reference ``pipegraph.hpp:560-576``).

``to_dot`` renders the operator DAG as graphviz DOT text: device
operators are marked ``[GPU]`` and filled gold, KEYBY edges labelled
``KB``, BROADCAST ``BC``, split edges dashed.  ``to_svg`` pipes it
through the ``dot`` binary when graphviz is installed and otherwise
draws a simple native SVG, so the monitoring thread's NEW_APP
registration always has a diagram to ship.
"""

from __future__ import annotations

import html
import shutil
import subprocess
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


def _fallback_svg(graph) -> str:
    """A minimal native SVG: operators left to right in topological order
    with straight connectors."""
    ops, edges = _graph_nodes_edges(graph)
    W, H, GAP = 150, 54, 40
    pos = {id(op): i for i, op in enumerate(ops)}
    width = len(ops) * (W + GAP) + GAP
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" '
             f'width="{width}" height="{H + 60}">']
    for a, b, _routing in edges:
        x1 = GAP + pos[id(a)] * (W + GAP) + W
        x2 = GAP + pos[id(b)] * (W + GAP)
        y = 30 + H // 2
        parts.append(f'<line x1="{x1}" y1="{y}" x2="{x2}" y2="{y}" '
                     'stroke="black" marker-end="none"/>')
    for op in ops:
        x = GAP + pos[id(op)] * (W + GAP)
        fill = "#ffd700" if op.is_gpu else "#add8e6"
        name = html.escape(op.name)
        kind = html.escape(type(op).__name__)
        parts.append(
            f'<rect x="{x}" y="30" rx="8" width="{W}" height="{H}" '
            f'fill="{fill}" stroke="black"/>'
            f'<text x="{x + W // 2}" y="52" text-anchor="middle" '
            f'font-size="12">{name}</text>'
            f'<text x="{x + W // 2}" y="70" text-anchor="middle" '
            f'font-size="10">{kind} ({op.parallelism})</text>')
    parts.append("</svg>")
    return "".join(parts)


def to_svg(graph) -> str:
    """The graph as SVG: graphviz's ``dot -Tsvg`` when it runs, else the
    native fallback."""
    dot = to_dot(graph)
    if shutil.which("dot"):
        try:
            out = subprocess.run(["dot", "-Tsvg"], input=dot.encode(),
                                 capture_output=True, timeout=10, check=True)
            return out.stdout.decode()
        except (OSError, subprocess.SubprocessError, UnicodeDecodeError):
            pass    # a broken graphviz: the fallback below
    return _fallback_svg(graph)
