"""Structured timing records.

Copy of ``femcy_tpu.utils.timing.Timer`` with one addition: an optional
``sync`` callable run before each section's clock is read, so a section
around asynchronous CUDA work measures the work and not its enqueue
(``FEMSystem`` passes ``torch.cuda.synchronize`` on a CUDA device).  The
profiler hook (``device_trace``) comes with the CLI slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

logger = logging.getLogger("femcy_tpu_torch.timing")


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
        if self._sync is not None:
            self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                self._sync()
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
