"""Structured timing records and the program's profiler spans.

Copy of ``femcy_tpu.utils.timing.Timer`` with two additions: an optional
``sync`` callable run before each section's clock is read, so a section
around asynchronous CUDA work measures the work and not its enqueue
(``FEMSystem`` passes ``torch.cuda.synchronize`` on a CUDA device); and a
profiler range around each section (``span``).  ``device_trace`` is the
twin of the JAX package's ``jax.profiler`` hook, on ``torch.profiler``.

A ``torch.profiler`` profile is the program's one tracing switch: while
one is active, ``span`` opens a named range on the profile's own clock,
beside the CUDA work CUPTI records, so each kernel can be tied to the
spans open at its launch and each idle gap of the device to the span the
host was in.  With no profile a span is one shared object that does
nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

logger = logging.getLogger("femcy_tpu_torch.timing")

#: prefix of the range of each Timer section: ``femcy.section.<name>``
SECTION = "femcy.section."


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


#: what ``span`` returns with no profile active
NO_SPAN = _NoSpan()


def span(name: str):
    """A profiler range named ``name`` while a ``torch.profiler`` profile is
    active, else ``NO_SPAN``, which records, synchronises and allocates
    nothing.  The range synchronises nothing either.

    The range is an operator-kind range (``RecordFunctionFast``), not a
    user annotation: the profiler draws an image of every user annotation
    on the device's timeline, from the first to the last kernel launched
    directly inside it, and a reader that takes device events for device
    work would count those images as busy time."""
    if not torch.autograd._profiler_enabled():
        return NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


def seconds_since(t0: float, device: torch.device) -> float:
    """``time.perf_counter()`` seconds since ``t0``, read once the work
    queued on ``device`` has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


@dataclasses.dataclass
class TimingRecord:
    name: str
    seconds: float
    first_call: bool  # True for the first call of a name (builds included)


class Timer:
    """Collects named timing records; the first call per name is flagged,
    since it pays one-time costs (kernel library build and load)."""

    def __init__(self, verbose: bool = False,
                 sync: Optional[Callable[[], None]] = None):
        self.records: List[TimingRecord] = []
        self._seen: set = set()
        self.verbose = verbose
        self._sync = sync

    @contextlib.contextmanager
    def section(self, name: str):
        """Time the block, synchronised at both ends; under a profile the
        block and its closing synchronise are also a range named
        ``SECTION + name``."""
        if self._sync is not None:
            self._sync()
        t0 = time.perf_counter()
        try:
            with span(SECTION + name):
                try:
                    yield
                finally:
                    if self._sync is not None:
                        self._sync()
        finally:
            dt = time.perf_counter() - t0
            first = name not in self._seen
            self._seen.add(name)
            self.records.append(TimingRecord(name, dt, first))
            if self.verbose:
                tag = " (first call)" if first else ""
                logger.info("%s: %.4fs%s", name, dt, tag)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """name -> {first, steady_mean, steady_min, count}."""
        by_name: Dict[str, List[TimingRecord]] = defaultdict(list)
        for r in self.records:
            by_name[r.name].append(r)
        out = {}
        for name, recs in by_name.items():
            steady = [r.seconds for r in recs if not r.first_call]
            first = next((r.seconds for r in recs if r.first_call), None)
            out[name] = {
                "first": first,
                "steady_mean": sum(steady) / len(steady) if steady else None,
                "steady_min": min(steady) if steady else None,
                "count": len(recs),
            }
        return out


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Wrap a block in a ``torch.profiler`` trace when a log dir is given.

    Records CPU activity, and CUDA activity too when a card is present,
    with the program's spans (``span``); on exit writes a Chrome trace (``trace-<pid>-<n>.json``, open it in
    Perfetto or chrome://tracing) into ``log_dir`` and yields nothing.  It
    never moves work between devices.  No-op when log_dir is None.
    """
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    n = sum(f.startswith(f"trace-{os.getpid()}-") for f in os.listdir(log_dir))
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{n}.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)
