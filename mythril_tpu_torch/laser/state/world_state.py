"""World state: accounts, global balance array, path constraints
(capability parity: mythril/laser/ethereum/state/world_state.py:17-250)."""

import logging
from copy import copy, deepcopy
from random import randrange
from typing import Any, Dict, List, Optional, Union

from ...native import keccak256
from ...smt import Array, BitVec, symbol_factory
from .account import Account
from .annotation import StateAnnotation
from .constraints import Constraints

log = logging.getLogger(__name__)


def _rlp_encode_list(items: List[bytes]) -> bytes:
    """Minimal RLP for the [address, nonce] list used in CREATE address
    derivation (role of the eth library helper the reference imports,
    world_state.py:5)."""

    def enc_item(b: bytes) -> bytes:
        if len(b) == 1 and b[0] < 0x80:
            return b
        if len(b) <= 55:
            return bytes([0x80 + len(b)]) + b
        ln = len(b).to_bytes((len(b).bit_length() + 7) // 8, "big")
        return bytes([0xB7 + len(ln)]) + ln + b

    payload = b"".join(enc_item(i) for i in items)
    if len(payload) <= 55:
        return bytes([0xC0 + len(payload)]) + payload
    ln = len(payload).to_bytes((len(payload).bit_length() + 7) // 8, "big")
    return bytes([0xF7 + len(ln)]) + ln + payload


def generate_contract_address(creator_address: int, nonce: int) -> int:
    """CREATE address: keccak(rlp([creator, nonce]))[12:]."""
    addr_bytes = creator_address.to_bytes(20, "big")
    if nonce == 0:
        nonce_bytes = b""
    else:
        nonce_bytes = nonce.to_bytes((nonce.bit_length() + 7) // 8, "big")
    digest = keccak256(_rlp_encode_list([addr_bytes, nonce_bytes]))
    return int.from_bytes(digest[12:], "big")


class WorldState:
    """The world state; tracks the transaction sequence that produced it."""

    def __init__(
        self,
        transaction_sequence=None,
        annotations: List[StateAnnotation] = None,
    ) -> None:
        self._accounts: Dict[int, Account] = {}
        self.balances = Array("balance", 256, 256)
        self.starting_balances = copy(self.balances)
        self.constraints = Constraints()
        self.node = None
        self.transaction_sequence = transaction_sequence or []
        self._annotations = annotations or []

    @property
    def accounts(self) -> Dict[int, Account]:
        return self._accounts

    def __getitem__(self, item: BitVec) -> Account:
        """Account lookup by address; unknown concrete addresses create a
        fresh account on miss (reference world_state.py:45-56)."""
        try:
            return self._accounts[item.value]
        except KeyError:
            new_account = Account(
                address=item, code=None, balances=self.balances
            )
            self._accounts[item.value] = new_account
            return new_account

    def __copy__(self) -> "WorldState":
        # field-by-field via __new__: the constructor would intern a
        # throwaway balance array per copy, and world-state copies run
        # once per fork and once per terminal materialization
        new_world_state = WorldState.__new__(WorldState)
        new_world_state._accounts = {}
        new_world_state.balances = copy(self.balances)
        new_world_state.starting_balances = copy(self.starting_balances)
        new_world_state.constraints = copy(self.constraints)
        new_world_state.node = self.node
        new_world_state.transaction_sequence = \
            self.transaction_sequence[:]
        new_world_state._annotations = [
            copy(a) for a in self._annotations
        ]
        for account in self._accounts.values():
            new_world_state.put_account(copy(account))
        return new_world_state

    def __deepcopy__(self, _) -> "WorldState":
        return self.__copy__()

    def accounts_exist_or_load(self, addr, dynamic_loader) -> Account:
        """Return the account, loading it on-chain when a dynamic loader is
        active (reference world_state.py:95-140)."""
        if isinstance(addr, str):
            addr = int(addr, 16)
        if isinstance(addr, int):
            addr_bitvec = symbol_factory.BitVecVal(addr, 256)
        elif not isinstance(addr, BitVec):
            addr_bitvec = symbol_factory.BitVecVal(int(addr, 16), 256)
        else:
            addr_bitvec = addr

        if addr_bitvec.value in self.accounts:
            return self.accounts[addr_bitvec.value]
        # Unknown account without on-chain loading: RAISE rather than
        # auto-create an empty account. Callers (extcodesize/extcodehash/
        # extcodecopy) then push a fresh symbol, so both sides of
        # Solidity's `extcodesize(target) > 0` interface-call guard stay
        # explorable (reference world_state.py:114-117 — auto-creating
        # concrete-empty code here concretely falsifies the guard and
        # hides everything behind it, e.g. asserts after interface calls).
        if dynamic_loader is None:
            raise ValueError("dynamic_loader is None")
        if dynamic_loader.active is False:
            raise ValueError("Dynamic loader is deactivated. Use a symbol.")
        if isinstance(addr, int):
            try:
                balance = dynamic_loader.read_balance(
                    "{0:#0{1}x}".format(addr, 42)
                )
                return self.create_account(
                    balance=balance,
                    address=addr_bitvec.value,
                    dynamic_loader=dynamic_loader,
                    code=dynamic_loader.dynld(addr),
                    concrete_storage=True,
                )
            except ValueError:
                log.debug("dynamic load failed for %s", addr)
        try:
            code = dynamic_loader.dynld(addr)
        except ValueError:
            code = None
        return self.create_account(
            address=addr_bitvec.value, dynamic_loader=dynamic_loader,
            code=code,
        )

    def create_account(
        self,
        balance=0,
        address=None,
        concrete_storage=False,
        dynamic_loader=None,
        creator=None,
        code=None,
        nonce=0,
    ) -> Account:
        """Create a new account; CREATE-style derivation when a creator is
        given, otherwise a fresh pseudo-random address."""
        if address is None:
            if creator is not None:
                address = generate_contract_address(
                    creator, self._accounts.get(creator, Account(
                        symbol_factory.BitVecVal(creator, 256)
                    )).nonce
                )
            else:
                address = self._generate_new_address()
        address_bitvec = (
            address
            if isinstance(address, BitVec)
            else symbol_factory.BitVecVal(address, 256)
        )
        new_account = Account(
            address=address_bitvec,
            balances=self.balances,
            dynamic_loader=dynamic_loader,
            concrete_storage=concrete_storage,
            code=code,
            nonce=nonce,
        )
        if balance:
            new_account.add_balance(symbol_factory.BitVecVal(balance, 256))
        self.put_account(new_account)
        return new_account

    def _generate_new_address(self) -> int:
        while True:
            address = randrange(2**160)
            if address not in self._accounts:
                return address

    def put_account(self, account: Account) -> None:
        self._accounts[account.address.value] = account
        account._balances = self.balances

    def annotate(self, annotation: StateAnnotation) -> None:
        self._annotations.append(annotation)

    @property
    def annotations(self) -> List[StateAnnotation]:
        return self._annotations

    def get_annotations(self, annotation_type: type) -> List[StateAnnotation]:
        return [
            annotation
            for annotation in self._annotations
            if isinstance(annotation, annotation_type)
        ]
