"""Execution context: which activation is running, plus request baggage.

The reference pins the current scheduling context in TLS
(Orleans' src/Orleans.Core/Runtime/RuntimeContext.cs) and flows
user baggage via ``RequestContext``
(Core.Abstractions/Runtime/RequestContext.cs). asyncio's ``contextvars``
give both for free — a turn is an awaited coroutine, and context vars
propagate through awaits exactly like the reference's logical call context.

The port's copy of ``orleans_tpu.runtime.context``.
"""

from __future__ import annotations

import contextvars
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from .activation import ActivationData

# The activation whose turn is currently executing (RuntimeContext TLS).
current_activation: contextvars.ContextVar["ActivationData | None"] = (
    contextvars.ContextVar("orleans_current_activation", default=None)
)

# User baggage propagated in message headers (RequestContext).
_request_context: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "orleans_request_context", default=None
)

# RequestContext key the ambient TransactionInfo rides under (shared with
# transactions.context; the runtime needs it to piggyback callee joins on
# response headers without importing the transactions package)
TXN_KEY = "orleans.txn"


def build_call_chain(sender: "ActivationData | None") -> tuple:
    """Extend ``sender``'s running call chain with its own grain id for an
    outgoing call (deadlock/reentrancy detection,
    InsideRuntimeClient.cs:306-311); () outside any turn.  The single
    construction shared by the messaging send path, the direct-interleave
    lane, and the hot lane — chain semantics changes happen HERE once."""
    if sender is None:
        return ()
    running = sender.running[-1] if sender.running else None
    parent = running.call_chain if running is not None else ()
    return (*parent, sender.grain_id)


def current_call_chain() -> tuple:
    """:func:`build_call_chain` for the ambient activation."""
    return build_call_chain(current_activation.get())


class RequestContext:
    """Static accessors mirroring the reference API
    (``RequestContext.Get/Set/Remove``)."""

    @staticmethod
    def get(key: str, default: Any = None) -> Any:
        ctx = _request_context.get()
        return default if ctx is None else ctx.get(key, default)

    @staticmethod
    def set(key: str, value: Any) -> None:
        ctx = dict(_request_context.get() or {})
        ctx[key] = value
        _request_context.set(ctx)

    @staticmethod
    def remove(key: str) -> None:
        ctx = dict(_request_context.get() or {})
        ctx.pop(key, None)
        _request_context.set(ctx or None)

    @staticmethod
    def export() -> dict | None:
        """Snapshot for message headers (``RequestContextExtensions.Export``)."""
        ctx = _request_context.get()
        return dict(ctx) if ctx else None

    @staticmethod
    def import_(ctx: dict | None) -> None:
        _request_context.set(dict(ctx) if ctx else None)

    @staticmethod
    def clear() -> None:
        _request_context.set(None)
