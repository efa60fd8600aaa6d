"""ACID multi-grain transactions (reference L11, src/Orleans.Transactions/ +
src/Orleans.Runtime/Transactions/): @transactional scopes, TransactionalState
versioned grain state, singleton TM grain running 2PC."""

from .context import TransactionInfo, ambient_txn
from .log import (
    FileTransactionLog,
    InMemoryTransactionLog,
    SqliteTransactionLog,
    TransactionLog,
)
from .manager import (
    TransactionAgent,
    TransactionManagerGrain,
    add_transactions,
    transactional,
)
from .state import TransactionalGrain, TransactionalState

__all__ = [
    "transactional", "add_transactions", "ambient_txn", "TransactionInfo",
    "TransactionAgent", "TransactionManagerGrain",
    "TransactionalGrain", "TransactionalState",
    "TransactionLog", "InMemoryTransactionLog", "FileTransactionLog",
    "SqliteTransactionLog",
]
