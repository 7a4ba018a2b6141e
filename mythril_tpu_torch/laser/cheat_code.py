"""hevm cheat-code address handling (capability parity:
mythril/laser/ethereum/cheat_code.py:23-56). The cheat address is
keccak("hevm cheat code")[12:]; calls to it are acknowledged with a success
retval so foundry-style tests don't derail symbolic execution."""

import logging

from ..support.support_utils import sha3
from .util import insert_ret_val

log = logging.getLogger(__name__)


class HevmCheatCode:
    address = int.from_bytes(sha3(b"hevm cheat code")[12:], "big")

    # selectors for the cheat functions this build recognizes (warp, roll,
    # deal, prank, ...) — currently acknowledged without state change
    def is_cheat_address(self, addr) -> bool:
        if isinstance(addr, str):
            try:
                addr = int(addr, 16)
            except ValueError:
                return False
        return addr == self.address


hevm_cheat_code = HevmCheatCode()


def handle_cheat_codes(global_state, callee_address, call_data,
                       memory_out_offset, memory_out_size):
    """Acknowledge the cheat call with a success return value."""
    insert_ret_val(global_state)
