"""Durable reminders over the virtual-bucket ring (reference L11,
src/Orleans.Runtime/ReminderService/)."""

from .service import (
    LocalReminderService,
    ReminderHandle,
    TickStatus,
    add_reminders,
)
from .table import (
    InMemoryReminderTable,
    ReminderEntry,
    ReminderTable,
    SqliteReminderTable,
)

__all__ = [
    "LocalReminderService", "ReminderHandle", "TickStatus", "add_reminders",
    "ReminderTable", "InMemoryReminderTable", "SqliteReminderTable",
    "ReminderEntry",
]
