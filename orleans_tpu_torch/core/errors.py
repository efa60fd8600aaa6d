"""Framework exception taxonomy.

Mirrors the reference's public exception surface
(Orleans' src/Orleans.Core.Abstractions/Core/ — ``OrleansException``,
``SiloUnavailableException``, ``InconsistentStateException`` in
``Core/Providers``, ``Catalog.NonExistentActivationException`` Catalog.cs:29).

The port's copy of ``orleans_tpu.core.errors``.
"""

from __future__ import annotations

__all__ = [
    "OrleansError", "SiloUnavailableError", "GrainCallTimeoutError",
    "NonExistentActivationError", "InconsistentStateError", "DeadlockError",
    "GatewayTooBusyError", "GrainOverloadedError", "RejectionError",
    "ClusterMembershipError", "ReminderError", "StreamError",
    "TransactionError", "TransactionAbortedError", "ConfigurationError",
]


class OrleansError(Exception):
    """Base for all framework errors (``OrleansException``)."""


class TransientPlacementError(OrleansError):
    """Addressing failed for a reason expected to heal shortly (e.g. a
    joining silo's type map has not arrived yet): surfaced to callers as
    a TRANSIENT rejection so the resend machinery retries, instead of a
    hard error."""


class ConfigurationError(OrleansError):
    """Invalid options rejected by a validator
    (``OrleansConfigurationException``, Core/Configuration/Validators/)."""


class SiloUnavailableError(OrleansError):
    """Target silo is dead/unreachable; outstanding calls are broken with this
    (``InsideRuntimeClient.BreakOutstandingMessagesToDeadSilo``,
    InsideRuntimeClient.cs:726)."""


class GrainCallTimeoutError(OrleansError, TimeoutError):
    """Response not received before ResponseTimeout (``CallbackData`` timeout)."""


class NonExistentActivationError(OrleansError):
    """Message addressed to an activation that no longer exists
    (``Catalog.NonExistentActivationException``, Catalog.cs:29); triggers
    re-address + retry at the caller."""

    def __init__(self, msg: str, *, is_stateless_worker: bool = False):
        super().__init__(msg)
        self.is_stateless_worker = is_stateless_worker


class InconsistentStateError(OrleansError):
    """Storage etag mismatch; the activation is deactivated and rebuilt from
    storage on next call (``InsideRuntimeClient.cs:390-402``)."""

    def __init__(self, msg: str, stored_etag: str | None = None,
                 current_etag: str | None = None):
        super().__init__(msg)
        self.stored_etag = stored_etag
        self.current_etag = current_etag


class DeadlockError(OrleansError):
    """Call-chain cycle detected (``Dispatcher.CheckDeadlock``,
    Dispatcher.cs:364-392)."""


class GatewayTooBusyError(OrleansError):
    """Gateway load shedding (``LoadSheddingOptions``)."""


class GrainOverloadedError(OrleansError):
    """Per-activation overload rejection (``ActivationData.CheckOverloaded``,
    ActivationData.cs:616 → Dispatcher.cs:433-439)."""


class RejectionError(OrleansError):
    """Generic message rejection carrying the rejection info string."""


class ClusterMembershipError(OrleansError):
    """Membership table CAS conflict / protocol violation."""


class ReminderError(OrleansError):
    pass


class StreamError(OrleansError):
    pass


class TransactionError(OrleansError):
    pass


class TransactionAbortedError(TransactionError):
    pass


class TransactionConflictError(TransactionAbortedError):
    """Wound-wait entry conflict: this transaction gave way — wounded by an
    older transaction, or timed out waiting — before running any doomed
    2PC work. Always retryable — the root @transactional scope retries with
    the transaction's original priority timestamp so it ages into the
    winner (livelock-free)."""
