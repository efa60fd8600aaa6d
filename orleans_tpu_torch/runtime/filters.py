"""Grain call filters: the incoming/outgoing interceptor chains.

Re-design of the reference's filter machinery —
Orleans' src/Orleans.Core/Core/GrainMethodInvoker.cs (the chain
walker: filters run in registration order, each calling
``context.Invoke()`` to proceed), wired into the invoke engine at
Orleans' src/Orleans.Runtime/Core/InsideRuntimeClient.cs:362 and
registered via SiloHostBuilderGrainCallFilterExtensions.

A filter is any async callable ``async def f(ctx)``. Inside it:

- ``await ctx.invoke()`` proceeds down the chain (ultimately calling the
  grain method / sending the request); after it returns, ``ctx.result``
  holds the outcome and may be replaced.
- returning WITHOUT calling ``ctx.invoke()`` short-circuits: the rest of
  the chain and the call itself never run; ``ctx.result`` (default None)
  is the caller-visible result.
- raising propagates to the caller as the call's failure (and unwinds
  through outer filters, which may catch and substitute a result).

Grain classes may define ``async def on_incoming_call(self, ctx)`` — it
runs as the LAST incoming filter (the reference's grain-implements-
IIncomingGrainCallFilter form, GrainMethodInvoker.cs adds the grain as
the final element of its chain).

The port's copy of ``orleans_tpu.runtime.filters``.
"""

from __future__ import annotations

from typing import Any, Awaitable, Callable, Sequence

from ..core.ids import GrainId

__all__ = [
    "GrainCallContext",
    "IncomingCallContext",
    "OutgoingCallContext",
    "run_call_chain",
]

GrainCallFilter = Callable[["GrainCallContext"], Awaitable[None]]


class GrainCallContext:
    """Shared surface of IIncoming/IOutgoingGrainCallContext: the method
    identity, mutable arguments, and the mutable result."""

    __slots__ = ("interface_name", "method_name", "args", "kwargs",
                 "result", "_chain", "_terminal", "_next")

    def __init__(self, chain: Sequence[GrainCallFilter], terminal,
                 interface_name: str, method_name: str,
                 args: tuple, kwargs: dict):
        self.interface_name = interface_name
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs
        self.result: Any = None
        self._chain = chain
        self._terminal = terminal
        self._next = 0

    async def invoke(self) -> None:
        """Proceed to the next filter (or, past the end of the chain, the
        call itself). Mirrors GrainMethodInvoker.Invoke's index walk: a
        filter calling ``invoke()`` more than once over-advances the index
        and is rejected — double-invocation would run the grain method
        twice."""
        i = self._next
        self._next = i + 1
        if i < len(self._chain):
            await self._chain[i](self)
        elif i == len(self._chain):
            self.result = await self._terminal(self)
        else:
            raise RuntimeError(
                f"grain call filter invoked ctx.invoke() more than once "
                f"for {self.interface_name}.{self.method_name}")


class IncomingCallContext(GrainCallContext):
    """Silo-side view: the target activation's instance is in hand."""

    __slots__ = ("grain", "grain_id")

    def __init__(self, chain, terminal, *, grain: Any, grain_id: GrainId,
                 interface_name: str, method_name: str,
                 args: tuple, kwargs: dict):
        super().__init__(chain, terminal, interface_name, method_name,
                         args, kwargs)
        self.grain = grain
        self.grain_id = grain_id


class OutgoingCallContext(GrainCallContext):
    """Caller-side view: only the target identity exists yet."""

    __slots__ = ("grain_class", "target_grain")

    def __init__(self, chain, terminal, *, grain_class: type,
                 target_grain: GrainId, interface_name: str,
                 method_name: str, args: tuple, kwargs: dict):
        super().__init__(chain, terminal, interface_name, method_name,
                         args, kwargs)
        self.grain_class = grain_class
        self.target_grain = target_grain


async def run_call_chain(ctx: GrainCallContext) -> Any:
    """Run the whole chain from the top and return the final result."""
    await ctx.invoke()
    return ctx.result
