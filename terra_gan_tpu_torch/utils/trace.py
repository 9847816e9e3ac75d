"""Named ranges of the port's work on the torch profiler's clock.

``span(name)`` marks a phase for a ``torch.profiler`` session active on
the calling thread: the benchmark's traced runs, or an operator's own
session. With none active it returns one shared null context, so a
phase pays one flag read. There is no switch of its own: ranges exist
exactly while someone profiles. Every name starts with ``tg.``.

A range is host-side only. The profiler shows it on the CPU timeline,
where the launches of the kernels inside it sit on the same clock as
the kernels themselves. It is a RecordFunction outside the user scope,
so it adds no annotation to the device's timeline: a
``torch.profiler.record_function`` range would add one there, spanning
its kernels and the gaps between them, and a reader that takes the
device's events as its busy time would count that as device work.

Ranges are recorded only on the thread the profiler started on: a span
opened in a feed thread is the null context.
"""

from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A profiler range called ``name`` while a profiler is active on this
    thread, else a null context."""
    if torch.autograd._profiler_enabled():
        return _range(name)
    return _NULL
