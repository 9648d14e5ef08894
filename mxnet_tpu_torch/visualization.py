"""Network visualization (counterpart of ``mxnet_tpu/visualization.py``;
ref: python/mxnet/visualization.py).

`print_summary` prints a layer table with output shapes and parameter
counts; `plot_network` returns a ``graphviz.Source`` of the graph when
the graphviz package imports, else the DOT source as a string, so the
call works either way.  Both read the symbol's JSON (and
``infer_shape``'s shapes) and run nothing on a device.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape: Optional[Dict] = None, line_length: int = 120,
                  positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a Keras-style per-node summary table (ref:
    visualization.print_summary)."""
    out_shapes = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, out_s, _ = internals.infer_shape(**shape)
        out_shapes = dict(zip(internals.list_outputs(), out_s))

    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    heads = {h[0] for h in conf["heads"]}
    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(f, pos):
        line = ""
        for i, fld in enumerate(f):
            line += str(fld)
            line = line[:pos[i]]
            line += " " * (pos[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(fields, positions)
    print("=" * line_length)
    total_params = 0

    for i, node in enumerate(nodes):
        op = node["op"]
        name = node["name"]
        if op == "null" and i not in heads and not node.get("inputs"):
            # parameter/data input rows are folded into their consumer
            if not _looks_like_data(name):
                continue
        out_shape = out_shapes.get(f"{name}_output", "")
        pre = [nodes[j[0]]["name"] for j in node.get("inputs", [])]
        params = 0
        for j in node.get("inputs", []):
            inp = nodes[j[0]]
            if inp["op"] == "null" and not _looks_like_data(inp["name"]):
                s = out_shapes.get(f"{inp['name']}_output")
                if s:
                    params += int(np.prod(s))
        total_params += params
        print_row([f"{name} ({op})", str(out_shape), str(params),
                   ", ".join(pre)], positions)
        print("_" * line_length)
    print(f"Total params: {total_params}")
    print("_" * line_length)


def _looks_like_data(name: str) -> bool:
    return not name.endswith(("_weight", "_bias", "_gamma", "_beta",
                              "_moving_mean", "_moving_var", "_label"))


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Graphviz graph of the symbol (ref: visualization.plot_network).
    Returns a graphviz.Source if the package imports, else the DOT source
    string."""
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    lines = [f'digraph "{title}" {{', "  rankdir=BT;"]
    for i, node in enumerate(nodes):
        name = node["name"]
        if node["op"] == "null" and hide_weights and \
                not _looks_like_data(name):
            continue
        label = name if node["op"] == "null" else f"{node['op']}\\n{name}"
        lines.append(f'  "{name}" [label="{label}", shape=box];')
    for node in nodes:
        if node["op"] == "null":
            continue
        for j in node.get("inputs", []):
            src = nodes[j[0]]
            if src["op"] == "null" and hide_weights and \
                    not _looks_like_data(src["name"]):
                continue
            lines.append(f'  "{src["name"]}" -> "{node["name"]}";')
    lines.append("}")
    dot_src = "\n".join(lines)
    try:
        import graphviz
    except ImportError:
        return dot_src
    return graphviz.Source(dot_src)
