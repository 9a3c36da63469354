"""The one gate of the port's ``torch.profiler.record_function`` spans.

`span(name)` is ``record_function(name)`` while a profiler records and
one shared no-op context otherwise: with no profiler on, a span costs a
flag check and never enters the dispatcher (an ungated
``record_function`` enters it on every call). No setting turns the
spans on; a profiler being on is the switch.

The profiler marks a span on the device from the first to the last
kernel launched while it is the innermost open span: a span whose work
all runs in spans nested in it gets no device mark, and one whose own
kernels sit at both ends of its children gets a mark over theirs too.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span while a profiler
    records, and does nothing otherwise."""
    return record_function(name) if _recording() else _OFF
