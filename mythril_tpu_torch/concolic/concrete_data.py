"""JSON schema types for concolic execution input (capability parity:
mythril/concolic/concrete_data.py:5-34 — the public `myth concolic`
input format: an initial world state plus a sequence of concrete
transaction steps)."""

from typing import Dict, List

try:
    from typing import TypedDict
except ImportError:  # pragma: no cover - py<3.8
    TypedDict = dict  # type: ignore[assignment,misc]


class AccountData(TypedDict):
    """One pre-state account."""

    balance: str
    code: str
    nonce: int
    storage: Dict[str, str]


class InitialState(TypedDict):
    accounts: Dict[str, AccountData]


class TransactionData(TypedDict, total=False):
    """One concrete transaction step ('' address = contract creation)."""

    address: str
    origin: str
    input: str
    value: str
    gasLimit: str
    gasPrice: str
    blockCoinbase: str
    blockDifficulty: str
    blockGasLimit: str
    blockNumber: str
    blockTime: str
    name: str


class ConcreteData(TypedDict):
    initialState: InitialState
    steps: List[TransactionData]
