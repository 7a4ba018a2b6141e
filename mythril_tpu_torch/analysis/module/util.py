"""Hook expansion helpers (reference parity:
mythril/analysis/module/util.py:13-50)."""

import logging
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from ...support.opcodes import OPCODES
from .base import DetectionModule, EntryPoint
from .loader import ModuleLoader

log = logging.getLogger(__name__)
OP_CODE_LIST = OPCODES.keys()


def get_detection_module_hooks(
    modules: List[DetectionModule], hook_type="pre"
) -> Dict[str, List[Callable]]:
    """Expand modules' hook lists (including `PREFIX*` wildcards) into an
    opcode -> callbacks dict."""
    hook_dict = defaultdict(list)
    for module in modules:
        hooks = (
            module.pre_hooks if hook_type == "pre" else module.post_hooks
        )
        for op_code in map(lambda x: x.upper(), hooks):
            if op_code in OP_CODE_LIST:
                hook_dict[op_code].append(module.execute)
            elif op_code.endswith("*"):
                to_register = filter(
                    lambda x: x.startswith(op_code[:-1]), OP_CODE_LIST
                )
                for actual_hook in to_register:
                    hook_dict[actual_hook].append(module.execute)
            else:
                log.error(
                    "Encountered invalid hook opcode %s in module %s",
                    op_code,
                    module.name,
                )
    return dict(hook_dict)


def reset_callback_modules(module_names: Optional[List[str]] = None):
    """Clean the issue records of every callback-based module."""
    modules = ModuleLoader().get_detection_modules(
        EntryPoint.CALLBACK, module_names
    )
    for module in modules:
        module.reset_module()
