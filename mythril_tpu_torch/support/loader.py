"""DynLoader: lazy on-chain state loading (capability parity:
mythril/support/loader.py:15-70 — read_storage, read_balance, dynld
returning a Disassembly of on-chain code, all lru_cached; consumed by
Storage.__getitem__ on concrete-slot misses and by the call helper's
callee resolution)."""

import functools
import logging
from typing import Optional

from ..disassembler.disassembly import Disassembly

log = logging.getLogger(__name__)


class DynLoader:
    """Wraps an EthJsonRpc-like client; every accessor is memoized."""

    def __init__(self, eth, active: bool = True):
        self.eth = eth
        self.active = active

    @functools.lru_cache(maxsize=4096)
    def read_storage(self, contract_address: str, index: int) -> str:
        if not self.active:
            raise ValueError("loader is disabled")
        if self.eth is None:
            raise ValueError("loader has no RPC client")
        return self.eth.eth_getStorageAt(
            contract_address, position=index, default_block="latest"
        )

    @functools.lru_cache(maxsize=4096)
    def read_balance(self, address: str) -> int:
        if not self.active:
            raise ValueError("loader is disabled")
        if self.eth is None:
            raise ValueError("loader has no RPC client")
        return self.eth.eth_getBalance(address)

    @functools.lru_cache(maxsize=256)
    def dynld(self, dependency_address: str) -> Optional[Disassembly]:
        """Disassembly of the code at `dependency_address`, or None for
        EOAs / unreachable nodes."""
        if not self.active or self.eth is None:
            return None
        log.debug("dynld %s", dependency_address)
        code = self.eth.eth_getCode(dependency_address)
        if not code or code == "0x":
            return None
        return Disassembly(code[2:])
