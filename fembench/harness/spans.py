"""The program's own spans in the traced stretch.

Under a ``torch.profiler`` profile ``femcy_tpu_torch`` opens a range named
``femcy.*`` around each step of its work (``femcy_tpu_torch.utils.timing.
span``).  This reduces a profile to, for each span name: how many spans
ran, their host seconds, the device operations launched inside them and
the device seconds of those operations.

A device operation belongs to every program span that was open on the
host at its launch: the CUDA API call that enqueued it
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cuLaunchKernel``, ...),
which the profile pairs with the operation by correlation id.  The inner
spans end without a synchronise, so an operation may run on the card
after its span has closed: it is attributed by launch, never by overlap
in time.  An operation whose launch lies in no span counts for none.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from fembench.harness import trace

#: prefix of the program's span names
PREFIX = "femcy."
#: prefix of the names of the CUDA API's calls (``cuda*`` and ``cu*``)
LAUNCH = "cu"


@dataclasses.dataclass
class SpanTotals:
    count: int = 0  # spans of this name
    host_s: float = 0.0  # their summed host seconds
    ops: int = 0  # device operations launched inside them
    device_s: float = 0.0  # those operations' summed device seconds


def attribute(events, device_type) -> Dict[str, SpanTotals]:
    """Totals of every program span name in the profile's ``events``
    (kineto events)."""
    spans: List[Tuple[int, int, str]] = []
    launched: List[Tuple[int, int]] = []  # (launch ns, correlation id)
    device: Dict[int, List[float]] = {}  # correlation id -> [seconds, ops]
    for e in events:
        name = e.name()
        if e.device_type() == device_type:
            if not _annotation(name):
                d = device.setdefault(e.correlation_id(), [0.0, 0])
                d[0] += e.duration_ns() * 1e-9
                d[1] += 1
        elif name.startswith(PREFIX):
            s = e.start_ns()
            spans.append((s, s + e.duration_ns(), name))
        elif name.startswith(LAUNCH):
            launched.append((e.start_ns(), e.correlation_id()))
    out: Dict[str, SpanTotals] = {}
    for s, t, name in spans:
        tot = out.setdefault(name, SpanTotals())
        tot.count += 1
        tot.host_s += (t - s) * 1e-9
    spans.sort()
    starts = [s for s, _, _ in spans]
    opened = 0
    active: List[Tuple[int, int, str]] = []
    for at, corr in sorted(launched):
        d = device.get(corr)
        if d is None:
            continue
        j = bisect.bisect_right(starts, at)
        active.extend(spans[opened:j])
        opened = j
        active = [sp for sp in active if sp[1] > at]
        for name in {sp[2] for sp in active}:
            out[name].device_s += d[0]
            out[name].ops += d[1]
    return out


def _annotation(name: str) -> bool:
    """Whether ``name`` is a range's: its image on the device's timeline,
    where the profiler draws one, is no operation."""
    return name == trace.WINDOW or name.startswith((trace.SECTION, PREFIX))


def of(run, name: str) -> Optional[SpanTotals]:
    """The totals of span ``name`` in a run's traced stretch, from the
    summary's ``spans`` (``attribute``'s totals); None where the run was
    not traced, its summary holds no spans (a program without them, or a
    reduction that does not fill them) or no such span ran."""
    spans = getattr(run.trace, "spans", None) if run.trace else None
    got = spans.get(name) if spans else None
    return got if got is not None and got.count else None
