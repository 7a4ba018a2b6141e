"""Account and Storage models (capability parity:
mythril/laser/ethereum/state/account.py:18-228)."""

import logging
from copy import copy, deepcopy
from typing import Any, Dict, Union

from ...disassembler.disassembly import Disassembly
from ...smt import Array, BitVec, K, simplify, symbol_factory
from ...support.support_args import args

log = logging.getLogger(__name__)


class Storage:
    """Contract storage: a concrete K-array or a named symbolic array, with
    lazy on-chain loads through the dynamic loader and bookkeeping for
    report printing."""

    def __init__(self, concrete=False, address=None, dynamic_loader=None
                 ) -> None:
        if concrete and not args.unconstrained_storage:
            self._standard_storage = K(256, 256, 0)
        else:
            self._standard_storage = Array(
                f"Storage{address if address is None else address.value}",
                256,
                256,
            )
        self._printable_storage: Dict[BitVec, BitVec] = {}
        self.dynld = dynamic_loader
        self.storage_keys_loaded = set()
        self.address = address
        self.keys_get = set()
        self.keys_set = set()

    def __getitem__(self, item: BitVec) -> BitVec:
        address = self.address
        if (
            address
            and address.value != 0
            and item.symbolic is False
            and int(item.value) not in self.storage_keys_loaded
            and self.dynld
            and self.dynld.active
        ):
            try:
                value = symbol_factory.BitVecVal(
                    int(
                        self.dynld.read_storage(
                            contract_address="0x{:040X}".format(
                                address.value
                            ),
                            index=int(item.value),
                        ),
                        16,
                    ),
                    256,
                )
                self._standard_storage[item] = value
                self.storage_keys_loaded.add(int(item.value))
                self._printable_storage[item] = value
            except ValueError as e:
                log.debug("Couldn't read storage at %s: %s", item, e)
        self.keys_get.add(item)
        return simplify(self._standard_storage[item])

    def __setitem__(self, key, value: Any) -> None:
        self._printable_storage[key] = value
        self._standard_storage[key] = value
        self.keys_set.add(key)
        if key.symbolic is False:
            self.storage_keys_loaded.add(int(key.value))

    def __deepcopy__(self, memodict=dict()):
        # field-by-field via __new__: the constructor would build a
        # throwaway array facade per copy, and storage copies run once
        # per fork (hot in terminal storms). Shares the underlying
        # immutable term; per-object raw rebinding on write keeps
        # copies independent.
        storage = Storage.__new__(Storage)
        storage._standard_storage = copy(self._standard_storage)
        storage._printable_storage = copy(self._printable_storage)
        storage.dynld = self.dynld
        storage.storage_keys_loaded = copy(self.storage_keys_loaded)
        storage.address = self.address
        storage.keys_get = copy(self.keys_get)
        storage.keys_set = copy(self.keys_set)
        return storage

    @property
    def printable_storage(self) -> Dict[BitVec, BitVec]:
        return self._printable_storage


class Account:
    """An EVM account: nonce, code, storage, and a balance closure into the
    world-state's global balance array."""

    def __init__(
        self,
        address: Union[BitVec, str],
        code=None,
        contract_name=None,
        balances: Array = None,
        concrete_storage=False,
        dynamic_loader=None,
        nonce=0,
    ) -> None:
        self.nonce = nonce
        self.code = code or Disassembly("")
        self.address = (
            address
            if isinstance(address, BitVec)
            else symbol_factory.BitVecVal(int(address, 16), 256)
        )

        self.storage = Storage(
            concrete_storage,
            address=self.address,
            dynamic_loader=dynamic_loader,
        )

        self._balances = balances

        self.contract_name = contract_name or "Unknown"
        self.deleted = False

    def balance(self):
        """This account's entry in the world-state balance array (a
        method, not the reference's instance lambda — closures cannot
        be pickled by the checkpoint layer)."""
        return self._balances[self.address]

    def __str__(self) -> str:
        return str(self.as_dict)

    def serialised_code(self) -> str:
        """Hex bytecode string for report serialization."""
        code = self.code.bytecode if self.code else ""
        if isinstance(code, tuple):
            return "0x" + bytes(code).hex()
        if isinstance(code, bytes):
            return "0x" + code.hex()
        if isinstance(code, str) and not code.startswith("0x"):
            return "0x" + code
        return code

    def set_balance(self, balance: Union[int, BitVec]) -> None:
        balance = (
            symbol_factory.BitVecVal(balance, 256)
            if isinstance(balance, int)
            else balance
        )
        assert self._balances is not None
        self._balances[self.address] = balance

    def add_balance(self, balance: Union[int, BitVec]) -> None:
        balance = (
            symbol_factory.BitVecVal(balance, 256)
            if isinstance(balance, int)
            else balance
        )
        self._balances[self.address] += balance

    @property
    def as_dict(self) -> Dict:
        return {
            "nonce": self.nonce,
            "code": self.code,
            "balance": self.balance(),
            "storage": self.storage,
        }

    def __copy__(self, memodict={}):
        # field-by-field via __new__ (the constructor builds a
        # throwaway Storage); `deleted` intentionally resets to False,
        # matching the constructor-based copy this replaces
        new_account = Account.__new__(Account)
        new_account.nonce = self.nonce
        new_account.code = self.code
        new_account.address = self.address
        new_account.storage = deepcopy(self.storage)
        new_account._balances = self._balances
        new_account.contract_name = self.contract_name
        new_account.deleted = False
        return new_account
