from .transaction_models import (
    BaseTransaction,
    ContractCreationTransaction,
    MessageCallTransaction,
    TransactionEndSignal,
    TransactionStartSignal,
    tx_id_manager,
)
from .symbolic import (
    ACTORS,
    Actors,
    execute_contract_creation,
    execute_message_call,
)
