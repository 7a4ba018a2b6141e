"""Interactive control-flow / call-graph HTML export (capability parity:
mythril/analysis/callgraph.py:9-250 — renders the explored statespace's
nodes and edges as a vis.js network graph).

The template is self-contained: node/edge data is embedded as JSON and the
vis-network library is loaded from a CDN (the reference ships vis.js the
same way via its jinja template, analysis/templates/callgraph.html)."""

import json
import re
from typing import Dict, List

default_colors = [
    {"border": "#26996f", "background": "#2f7e5b",
     "highlight": {"border": "#fff", "background": "#28a16f"}},
    {"border": "#9e42b3", "background": "#842899",
     "highlight": {"border": "#fff", "background": "#933da6"}},
    {"border": "#b82323", "background": "#991d1d",
     "highlight": {"border": "#fff", "background": "#a61f1f"}},
    {"border": "#4753bf", "background": "#3b46a1",
     "highlight": {"border": "#fff", "background": "#424db3"}},
    {"border": "#26996f", "background": "#2f7e5b",
     "highlight": {"border": "#fff", "background": "#28a16f"}},
    {"border": "#9e42b3", "background": "#842899",
     "highlight": {"border": "#fff", "background": "#933da6"}},
    {"border": "#b82323", "background": "#991d1d",
     "highlight": {"border": "#fff", "background": "#a61f1f"}},
    {"border": "#4753bf", "background": "#3b46a1",
     "highlight": {"border": "#fff", "background": "#424db3"}},
]

phrack_color = {
    "border": "#000000", "background": "#ffffff",
    "highlight": {"border": "#000000", "background": "#ffffff"},
}

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>Call graph</title>
<script src="https://unpkg.com/vis-network/standalone/umd/vis-network.min.js"></script>
<style type="text/css">
 body {{ background: {bgcolor}; margin: 0; }}
 #network {{ width: 100vw; height: 100vh; }}
</style>
</head>
<body>
<div id="network"></div>
<script type="text/javascript">
 var nodes = new vis.DataSet({nodes});
 var edges = new vis.DataSet({edges});
 var container = document.getElementById("network");
 var data = {{ nodes: nodes, edges: edges }};
 var options = {{
   autoResize: true,
   layout: {{
     improvedLayout: true,
     hierarchical: {{
       enabled: true, levelSeparation: 450,
       nodeSpacing: 200, treeSpacing: 100, blockShifting: true,
       edgeMinimization: true, parentCentralization: false,
       direction: "LR", sortMethod: "directed",
     }},
   }},
   nodes: {{
     color: "#000000", borderWidth: 1, borderWidthSelected: 2,
     chosen: true, shape: "box", font: {{ align: "left", color: "{fontcolor}" }},
   }},
   edges: {{
     font: {{ color: "#FFFFFF", background: "none", strokeWidth: 0 }},
   }},
   physics: {{ enabled: {physics} }},
 }};
 var network = new vis.Network(container, data, options);
</script>
</body>
</html>
"""


def extract_nodes(statespace) -> List[Dict]:
    """One vis.js node per CFG basic block; label is the block's
    instruction listing (reference callgraph.py:107-163)."""
    nodes = []
    color_map: Dict[str, Dict] = {}
    for node_key in statespace.nodes:
        node = statespace.nodes[node_key]
        instructions = []
        for state in node.states:
            instruction = state.get_current_instruction()
            code = "%d %s" % (instruction["address"], instruction["opcode"])
            if instruction["opcode"].startswith("PUSH"):
                arg = instruction.get("argument", "")
                if isinstance(arg, bytes):
                    arg = "0x" + arg.hex()
                code += " " + str(arg)
            instructions.append(code)
        code_split = [
            re.sub(r"([0-9a-f]{8})[0-9a-f]+", lambda m: m.group(1) + "(...)",
                   line)
            for line in instructions
        ]
        truncated = code_split[:25]
        if len(code_split) > 25:
            truncated.append("(%d more)" % (len(code_split) - 25))
        contract_name = node.contract_name
        if contract_name not in color_map:
            color_map[contract_name] = default_colors[
                len(color_map) % len(default_colors)
            ]
        nodes.append(
            {
                "id": str(node.uid),
                "color": color_map[contract_name],
                "size": 150,
                "fullLabel": "\n".join(instructions),
                "label": "\n".join(truncated),
                "truncLabel": "\n".join(truncated),
                "isExpanded": False,
            }
        )
    return nodes


def extract_edges(statespace) -> List[Dict]:
    """One vis.js edge per CFG edge, labelled with the (simplified) branch
    condition for conditional jumps (reference callgraph.py:166-207)."""
    from ..laser.cfg import JumpType

    edges = []
    for edge in statespace.edges:
        if edge.condition is None:
            label = ""
        else:
            try:
                label = str(edge.condition.simplify())
            except Exception:
                label = str(edge.condition)
        label = re.sub(
            r"([^_])([\d]{2}\d+)",
            lambda m: m.group(1) + hex(int(m.group(2))), label
        )
        edges.append(
            {
                "from": str(edge.as_dict["from"]),
                "to": str(edge.as_dict["to"]),
                "arrows": "to",
                "label": label,
                "smooth": {"type": "cubicBezier"},
                "dashes": edge.type == JumpType.Transaction,
            }
        )
    return edges


def generate_graph(statespace, physics: bool = False,
                   phrackify: bool = False) -> str:
    """Render the statespace as a standalone HTML page
    (reference callgraph.py:210-250)."""
    nodes = extract_nodes(statespace)
    if phrackify:
        for node in nodes:
            node["color"] = phrack_color
    edges = extract_edges(statespace)
    return _TEMPLATE.format(
        nodes=json.dumps(nodes),
        edges=json.dumps(edges),
        physics="true" if physics else "false",
        bgcolor="#ffffff" if phrackify else "#232625",
        fontcolor="#000000" if phrackify else "#FFFFFF",
    )
