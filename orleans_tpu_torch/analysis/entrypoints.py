"""Declared entry-point registry consulted at link time (phase 2).

Some functions are invoked by the runtime without any visible call
site: ``ctl_*`` control handlers are dispatched by name over the
control socket, timer/reminder callbacks fire from the activation's
scheduler, ``call_soon_threadsafe`` targets are handed to a loop as
objects, and the multiproc tier registers ring-drain callbacks with
``loop.add_reader``. Before this registry existed the fence analysis
could only report the generic "no fenced call path (entry point)" for
them; worse, a function with SOME fenced call sites that was ALSO one
of these entry points could be promoted to fence-held even though the
runtime enters it unfenced.

The registry has two halves:

* **name patterns** — zero-call-site conventions recognised purely by
  the function's (qual)name: ``ctl_*`` handlers and the
  ``receive_reminder`` reminder hook.
* **scheduling APIs** — callables handed to a loop/timer registration
  API; phase 1 records these as :class:`SchedEdge`\\ s with the API
  name, and :class:`~.summaries.Program` asks this module for the
  declared context label at link time.

Both halves declare the entry as UNFENCED (the runtime never holds the
tick fence on behalf of an entry point) with main-loop affinity unless
the scheduling edge targets a worker-kind loop (that case stays with
the worker fixpoint, not this registry).

The port's copy of ``orleans_tpu.analysis.entrypoints``.
"""

from __future__ import annotations

import fnmatch

__all__ = ["entry_label_for_name", "entry_label_for_sched",
           "NAME_PATTERNS", "SCHED_API_LABELS"]

# (glob over the LAST qualname segment, human-readable context label)
NAME_PATTERNS: tuple[tuple[str, str], ...] = (
    ("ctl_*", "ctl_* control handler (dispatched by name, unfenced)"),
    ("receive_reminder",
     "reminder callback (fired by the reminder service, unfenced)"),
)

# scheduling API name → label template; ``{caller}`` is the short name
# of the function that registered the callback
SCHED_API_LABELS: dict[str, str] = {
    "call_soon_threadsafe":
        "call_soon_threadsafe target scheduled from '{caller}'",
    "call_soon": "loop callback scheduled from '{caller}'",
    "call_at": "timer callback scheduled from '{caller}'",
    "call_later": "timer callback scheduled from '{caller}'",
    "add_reader": "ring-drain/fd-ready callback registered by '{caller}'",
    "add_writer": "fd-writable callback registered by '{caller}'",
    "register_timer": "grain timer callback registered by '{caller}'",
}


def entry_label_for_name(qualname: str) -> str | None:
    """Declared context for a zero-call-site naming convention, or
    None. Matches the last dotted segment (``Silo.ctl_dump`` →
    ``ctl_dump``)."""
    short = qualname.rsplit(".", 1)[-1]
    for pat, label in NAME_PATTERNS:
        if fnmatch.fnmatchcase(short, pat):
            return label
    return None


def entry_label_for_sched(api: str, caller_qual: str) -> str | None:
    """Declared context for the target of a scheduling-API edge, or
    None when the API does not create a runtime entry point."""
    tpl = SCHED_API_LABELS.get(api)
    if tpl is None:
        return None
    return tpl.format(caller=caller_qual.rsplit(".", 1)[-1])
