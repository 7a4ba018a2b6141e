"""Concolic branch flipping (capability parity:
mythril/concolic/concolic_execution.py:22-86 and `myth concolic`
cli.py:940-948): replay the recorded concrete transactions symbolically
under ConcolicStrategy, negate the path constraint at each requested
JUMPI address, and solve for new concrete inputs reaching the other
side."""

import logging
from copy import deepcopy
from datetime import datetime
from typing import Dict, List

from ..laser.strategy.concolic import ConcolicStrategy
from ..laser.svm import LaserEVM
from ..laser.time_handler import time_handler
from ..laser.transaction.symbolic import execute_transaction
from ..laser.transaction.transaction_models import tx_id_manager
from .concrete_data import ConcreteData
from .find_trace import concrete_execution

log = logging.getLogger(__name__)


def flip_branches(
    init_state,
    concrete_data: ConcreteData,
    jump_addresses: List[int],
    trace: List[List[int]],
) -> List[Dict]:
    """Re-run the transactions symbolically, following `trace` and
    flipping the JUMPIs at `jump_addresses`
    (reference concolic_execution.py:22-64)."""
    tx_id_manager.restart_counter()
    output_list: List[Dict] = []
    laser_evm = LaserEVM(
        execution_timeout=600, use_reachability_check=False,
        requires_statespace=False, transaction_count=10,
    )
    laser_evm.open_states = [deepcopy(init_state)]
    laser_evm.strategy = ConcolicStrategy(
        work_list=laser_evm.work_list,
        max_depth=100,
        trace=trace,
        flip_branch_addresses=[str(a) for a in jump_addresses],
    )

    time_handler.start_execution(laser_evm.execution_timeout)
    laser_evm.time = datetime.now()

    # the re-run is SYMBOLIC: calldata/caller/value are fresh symbols, so
    # every JUMPI forks; ConcolicStrategy discards states that deviate
    # from the recorded trace except at the requested flip addresses,
    # where it solves the deviating path for new concrete inputs.
    for transaction in concrete_data["steps"]:
        data = transaction.get("input", "")
        if data.startswith("0x"):
            data = data[2:]
        execute_transaction(
            laser_evm,
            callee_address=transaction.get("address", ""),
            data=data,
        )

    if isinstance(laser_evm.strategy, ConcolicStrategy):
        results = laser_evm.strategy.results
        for addr in jump_addresses:
            key = str(addr)
            if key in results:
                output_list.append(results[key])
            else:
                log.warning("Couldn't flip branch at address %s", addr)
    return output_list


def concolic_execution(
    concrete_data: ConcreteData, jump_addresses: List, solver_timeout=100000
) -> List[Dict]:
    """Entry point for `myth concolic`
    (reference concolic_execution.py:67-86)."""
    from ..support.support_args import args

    init_state, trace = concrete_execution(concrete_data)
    args.solver_timeout = solver_timeout
    output_list = flip_branches(
        init_state=init_state,
        concrete_data=concrete_data,
        jump_addresses=[int(addr) for addr in jump_addresses],
        trace=trace,
    )
    return output_list
