"""Grain cancellation tokens: cooperative cancellation across grain calls.

Re-design of the reference's cancellation subsystem
(Orleans' src/Orleans.Core.Abstractions/Cancellation/
GrainCancellationToken.cs:17 + GrainCancellationTokenSource.cs,
Orleans.Core/Runtime/GrainCancellationTokenRuntime.cs:12, and the
activation-side registry Orleans.Runtime/Cancellation/
CancellationSourcesExtension.cs:14) on asyncio primitives:

* a :class:`GrainCancellationToken` wraps an ``asyncio.Event``; grain code
  observes it cooperatively (``token.is_cancelled`` / ``await
  token.wait()``) — cancellation never hard-kills a turn, matching the
  reference's CancellationToken semantics;
* passing a token as a call argument records the target grain on the
  token (the reference's ``_targetGrainReferences``), and in-silo calls
  share the token OBJECT (identity deep-copier), so a local cancel fires
  instantly with zero messaging;
* across the wire the token travels as ``(id, cancelled)`` and the
  receiving silo interns a twin per id (CancellationSourcesExtension's
  interner), so every activation handed the same token id observes one
  shared event;
* :meth:`GrainCancellationTokenSource.cancel` fires the local event and
  fans a ``__cancel_token__`` system call out to every recorded target
  grain — always-interleave, since the turn being cancelled is typically
  still running on the target's activation.

The port's copy of ``orleans_tpu.runtime.cancellation``.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from .silo import Silo

__all__ = ["GrainCancellationToken", "GrainCancellationTokenSource"]

CANCEL_METHOD = "__cancel_token__"


def _register_copier() -> None:
    # tokens are SHARED objects for in-silo calls (a local cancel must be
    # visible to the callee instantly): identity deep-copier, like the
    # frozen id types
    from ..core.serialization import register_copier
    register_copier(GrainCancellationToken, lambda t: t)


def _rebuild_token(token_id: str, cancelled: bool) -> "GrainCancellationToken":
    return GrainCancellationToken(token_id, cancelled)


class GrainCancellationToken:
    """Cooperative cancellation signal passed as a grain-call argument."""

    __slots__ = ("id", "_event", "_targets", "__weakref__")

    def __init__(self, token_id: str | None = None,
                 cancelled: bool = False):
        self.id = token_id or uuid.uuid4().hex
        self._event = asyncio.Event()
        if cancelled:
            self._event.set()
        # grain ids this token was passed to: (GrainId, grain class)
        # recorded at send time so cancel() can reach remote twins
        self._targets: dict = {}

    @property
    def is_cancelled(self) -> bool:
        return self._event.is_set()

    async def wait(self) -> None:
        """Suspend until the token is cancelled."""
        await self._event.wait()

    def _fire(self) -> None:
        self._event.set()

    def __reduce__(self):
        # wire form: id + state; the receiving silo interns a twin
        return (_rebuild_token, (self.id, self.is_cancelled))

    def __repr__(self) -> str:
        state = "cancelled" if self.is_cancelled else "live"
        return f"GrainCancellationToken({self.id[:8]}, {state})"


class GrainCancellationTokenSource:
    """Creator/canceller of one token (GrainCancellationTokenSource.cs)."""

    def __init__(self) -> None:
        self.token = GrainCancellationToken()

    async def cancel(self) -> None:
        """Fire the token locally and notify every remote grain the token
        was passed to (best effort, gathered; a target that cannot be
        reached will still observe the flag if the call retries there)."""
        self.token._fire()
        notifies = []
        for gid, (client, cls) in list(self.token._targets.items()):
            try:
                fut = client.send_request(
                    target_grain=gid, grain_class=cls,
                    interface_name=cls.__name__ if cls else "",
                    method_name=CANCEL_METHOD, args=(self.token.id,),
                    kwargs={}, is_always_interleave=True)
            except Exception:  # noqa: BLE001 — best effort per target: a
                continue       # raising transmit must not skip the rest
            if fut is not None:
                notifies.append(fut)
        if notifies:
            await asyncio.gather(*notifies, return_exceptions=True)

    def dispose(self) -> None:
        self.token._targets.clear()


# ---------------------------------------------------------------------------
# Silo-side interner (CancellationSourcesExtension.cs:14): one twin per
# token id, so every activation handed the same id observes one event.
# ---------------------------------------------------------------------------

_PRECANCELLED_TTL = 300.0
_PRECANCELLED_CAP = 4096


class TokenInterner:
    """Per-silo token registry.

    Live twins are held WEAKLY: whatever grain/turn holds the token keeps
    the entry alive, and an entry disappears exactly when no one can
    observe it anymore — a TTL sweep could otherwise evict a twin a
    long-running turn is still awaiting, silently losing its cancel.
    Pre-cancelled twins (a ``__cancel_token__`` that arrived before or
    without the token itself) are held STRONGLY with a TTL + cap, since
    nothing references them yet."""

    def __init__(self, silo: "Silo | None" = None) -> None:
        import weakref
        self._silo = silo
        self._twins: "weakref.WeakValueDictionary[str, GrainCancellationToken]" = \
            weakref.WeakValueDictionary()
        self._precancelled: dict[str, tuple[GrainCancellationToken, float]] = {}

    def intern(self, token: GrainCancellationToken) -> GrainCancellationToken:
        twin = self._twins.get(token.id)
        if twin is not None:
            if token.is_cancelled:
                self.fire(token.id)
            return twin
        if self._precancelled.pop(token.id, None) is not None:
            token._fire()  # cancel raced ahead of the call
        self._twins[token.id] = token
        return token

    def fire(self, token_id: str) -> bool:
        twin = self._twins.get(token_id)
        if twin is None:
            # cancel arrived before (or without) the token itself: keep a
            # pre-cancelled twin so a late-delivered call still sees it
            # (capped: cancel-first floods must not grow without bound)
            if token_id not in self._precancelled:
                now = time.monotonic()
                if len(self._precancelled) >= _PRECANCELLED_CAP:
                    self._sweep(now)
                    while len(self._precancelled) >= _PRECANCELLED_CAP:
                        # TTL freed nothing (cancel-first flood inside the
                        # window): evict oldest — the cap is a hard bound
                        oldest = min(self._precancelled,
                                     key=lambda t: self._precancelled[t][1])
                        self._precancelled.pop(oldest)
                self._precancelled[token_id] = (
                    GrainCancellationToken(token_id, cancelled=True), now)
            return False
        if twin.is_cancelled:
            return True  # already fired + cascaded
        twin._fire()
        # cascade: a remote grain may have FORWARDED this token onward —
        # its targets were recorded on our twin by register_outgoing_tokens,
        # and only this silo knows about them (the source only knows its
        # own first hops). One-way, best-effort, loop-safe: a twin that is
        # already cancelled returns above without re-cascading.
        silo = self._silo
        if silo is not None:
            for gid, (client, cls) in list(twin._targets.items()):
                try:
                    client.send_request(
                        target_grain=gid, grain_class=cls,
                        interface_name=cls.__name__ if cls else "",
                        method_name=CANCEL_METHOD, args=(token_id,),
                        kwargs={}, is_always_interleave=True,
                        is_one_way=True)
                except Exception:  # noqa: BLE001 — best-effort fan-out
                    pass
        return True

    def _sweep(self, now: float) -> None:
        for tid, (_, touched) in list(self._precancelled.items()):
            if now - touched > _PRECANCELLED_TTL:
                self._precancelled.pop(tid, None)


def register_outgoing_tokens(client, grain_id, grain_class,
                             args: tuple, kwargs: dict) -> None:
    """Send-time hook: record the call target on every token argument so
    the source's cancel() can reach its remote twin."""
    for a in args:
        if type(a) is GrainCancellationToken:
            a._targets[grain_id] = (client, grain_class)
    if kwargs:
        for a in kwargs.values():
            if type(a) is GrainCancellationToken:
                a._targets[grain_id] = (client, grain_class)


def maybe_intern_tokens(silo: "Silo", args: tuple,
                        kwargs: dict) -> tuple[tuple, dict]:
    """Receive-time hook: swap decoded token twins for the silo's interned
    instance (shared event per id). Single pass with an early exit — this
    runs on every application invoke, and the overwhelmingly common case
    is no token at all. In-proc calls pass the original object (identity
    copier), for which interning is a registration no-op."""
    first = -1
    for i, a in enumerate(args):
        if type(a) is GrainCancellationToken:
            first = i
            break
    kw_hit = False
    if kwargs:
        for v in kwargs.values():
            if type(v) is GrainCancellationToken:
                kw_hit = True
                break
    if first < 0 and not kw_hit:
        return args, kwargs
    interner = silo.cancellation_tokens
    if first >= 0:
        args = tuple(
            interner.intern(a) if type(a) is GrainCancellationToken else a
            for a in args)
    if kw_hit:
        kwargs = {
            k: interner.intern(v) if type(v) is GrainCancellationToken else v
            for k, v in kwargs.items()}
    return args, kwargs


_register_copier()
