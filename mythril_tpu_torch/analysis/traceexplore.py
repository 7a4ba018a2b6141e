"""Serializable statespace export for trace exploration tools (capability
parity: mythril/analysis/traceexplore.py — converts the explored nodes,
edges and per-state machine states into a plain-JSON structure)."""

import json
from typing import Dict, List

from ..laser.cfg import JumpType

colors = [
    {"border": "#26996f", "background": "#2f7e5b"},
    {"border": "#9e42b3", "background": "#842899"},
    {"border": "#b82323", "background": "#991d1d"},
    {"border": "#4753bf", "background": "#3b46a1"},
]


def _serialize_stack_item(item) -> str:
    try:
        if getattr(item, "symbolic", True):
            return str(item)
        return hex(item.value)
    except Exception:
        return str(item)


def get_serializable_statespace(statespace) -> str:
    """Dump every node, its per-instruction states (pc, opcode, stack,
    gas interval) and the CFG edges as JSON text."""
    nodes: List[Dict] = []
    edges: List[Dict] = []

    color_map: Dict[str, Dict] = {}
    i = 0
    for node_key in statespace.nodes:
        node = statespace.nodes[node_key]
        if node.contract_name not in color_map:
            color_map[node.contract_name] = colors[i % len(colors)]
            i += 1

        code = ""
        states: List[Dict] = []
        for state in node.states:
            instruction = state.get_current_instruction()
            code += "%d %s\n" % (
                instruction["address"], instruction["opcode"]
            )
            states.append(
                {
                    "address": instruction["address"],
                    "opcode": instruction["opcode"],
                    "stack": [
                        _serialize_stack_item(x)
                        for x in state.mstate.stack
                    ],
                    "min_gas_used": state.mstate.min_gas_used,
                    "max_gas_used": state.mstate.max_gas_used,
                }
            )

        nodes.append(
            {
                "id": str(node.uid),
                "func": node.function_name,
                "label": "%s: %s" % (node.contract_name, node.function_name),
                "contract": node.contract_name,
                "code": code,
                "color": color_map[node.contract_name],
                "instructions": [s["opcode"] for s in states],
                "states": states,
                "constraints": [str(c) for c in node.constraints],
            }
        )

    for edge in statespace.edges:
        if edge.condition is None:
            label = ""
        else:
            try:
                label = str(edge.condition.simplify())
            except Exception:
                label = str(edge.condition)
        edges.append(
            {
                "from": str(edge.as_dict["from"]),
                "to": str(edge.as_dict["to"]),
                "arrows": "to",
                "label": label,
                "condition": label,
                "smooth": {"type": "cubicBezier"},
                "type": JumpType(edge.type).name
                if not isinstance(edge.type, str) else edge.type,
            }
        )

    return json.dumps({"nodes": nodes, "edges": edges})
