"""Per-call execution environment (reference parity:
mythril/laser/ethereum/state/environment.py:12-81)."""

from typing import Dict

from ...smt import BitVec, symbol_factory
from .account import Account
from .calldata import BaseCalldata


class Environment:
    """The environment of a single message call."""

    def __init__(
        self,
        active_account: Account,
        sender: BitVec,
        calldata: BaseCalldata,
        gasprice: BitVec,
        callvalue: BitVec,
        origin: BitVec,
        basefee: BitVec,
        code=None,
        static=False,
    ) -> None:
        self.active_account = active_account
        self.active_function_name = ""
        self.address = active_account.address
        self.code = active_account.code if code is None else code
        self.sender = sender
        self.calldata = calldata
        self.gasprice = gasprice
        self.origin = origin
        self.callvalue = callvalue
        self.static = static
        self.basefee = basefee
        self.block_number = symbol_factory.BitVecSym("block_number", 256)
        self.chainid = symbol_factory.BitVecSym("chain_id", 256)

    def __str__(self) -> str:
        return str(self.as_dict)

    @property
    def as_dict(self) -> Dict:
        return dict(
            active_account=self.active_account,
            sender=self.sender,
            calldata=self.calldata,
            gasprice=self.gasprice,
            callvalue=self.callvalue,
            origin=self.origin,
        )
