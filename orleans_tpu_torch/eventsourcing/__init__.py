"""Event sourcing / log-consistency (reference src/Orleans.EventSourcing/)."""

from .journaled import (
    CustomStorageAdaptor,
    JournaledGrain,
    LogStorageAdaptor,
    LogViewAdaptor,
    StateStorageAdaptor,
    log_consistency,
    replicated_journal,
)

__all__ = [
    "JournaledGrain", "log_consistency", "replicated_journal",
    "LogViewAdaptor", "LogStorageAdaptor", "StateStorageAdaptor",
    "CustomStorageAdaptor",
]
