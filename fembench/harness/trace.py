"""The traced stretch: ``torch.profiler`` over a bounded run of analyses,
reduced to the device's busy time (the union of its operations'
intervals), the device time of each operation by name, the device's busy
time inside each kind of the program's Timer sections, and the idle gaps
labelled by what the host was doing.  Nothing is written to disk."""

from __future__ import annotations

import bisect
import dataclasses
import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from fembench.harness import stats

#: the annotation that brackets the traced stretch in the profile
WINDOW = "fembench.traced_window"
#: the prefix of the annotation of each of the program's Timer sections
SECTION = "fembench.section:"
#: longest operation name kept in the breakdown
NAME_CHARS = 120


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # wall of the traced stretch (host clock)
    busy_s: float  # union of device operation intervals inside it
    analyses: int  # analyses the stretch ran
    #: device operation name -> (total seconds, launches)
    ops: Dict[str, Tuple[float, int]]
    #: host label -> idle seconds of the device while the host was there
    idle_by_host: Dict[str, float]
    #: Timer section name -> (sections, device busy seconds inside them)
    sections: Dict[str, Tuple[int, float]]

    def kernel(self, name: str) -> Optional[Tuple[float, int]]:
        """(seconds, launches) summed over every device operation whose
        name is ``name`` or a template / signature of it."""
        pat = re.compile(r"(^|[\s:])" + re.escape(name) + r"($|[<(])")
        total, count = 0.0, 0
        for op, (s, n) in self.ops.items():
            if pat.search(op):
                total += s
                count += n
        return (total, count) if count else None

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:10]
        idle = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {
            "device_ops": [[n[:NAME_CHARS], s] for n, (s, _) in top],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in idle],
        }


def _times(e) -> Tuple[float, float]:
    s = e.start_ns() * 1e-9
    return s, s + e.duration_ns() * 1e-9


def traced(torch, program, run: Callable[[], int]) -> TraceSummary:
    """Profile ``run`` (which returns how many analyses it ran) on the CPU
    and the card, with ``program``'s Timer sections annotated, and reduce
    the profile."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof, \
            program.labelled_sections(SECTION):
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            n = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return reduce(prof.profiler.kineto_results.events(), wall, n,
                  torch.autograd.DeviceType.CUDA)


def reduce(events, wall: float, analyses: int, device_type) -> TraceSummary:
    """Busy union, operations by name, busy time inside the annotated
    sections and labelled idle gaps of the profile's ``events`` (kineto
    events).  The annotations are taken from the host's side; their
    images on the device's timeline are no operations and are skipped."""
    lo = hi = None
    dev: List[Tuple[float, float, str]] = []
    host: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
    ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for e in events:
        s, t = _times(e)
        name = e.name()
        on_device = e.device_type() == device_type
        if name == WINDOW or name.startswith(SECTION):
            if on_device:
                continue
            if name == WINDOW:
                lo, hi = s, t
            else:
                ranges[name[len(SECTION):]].append((s, t))
        elif on_device:
            dev.append((s, t, name))
        else:
            host[e.start_thread_id()].append((s, t, name))
    if lo is None:
        raise RuntimeError(f"the profile holds no {WINDOW!r} annotation")
    dev = [(max(s, lo), min(t, hi), n) for s, t, n in dev if t > lo and s < hi]
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, t, n in dev:
        ops[n][0] += t - s
        ops[n][1] += 1
    merged = stats.merge((s, t) for s, t, _ in dev)
    busy = sum(t - s for s, t in merged)
    idle = stats.gaps(merged, lo, hi)
    main = max(host.values(), key=len) if host else []
    return TraceSummary(
        window_s=wall, busy_s=busy, analyses=analyses,
        ops={n: (v[0], int(v[1])) for n, v in ops.items()},
        idle_by_host=label_gaps(idle, main),
        sections={n: (len(r), stats.inside(merged, r))
                  for n, r in ranges.items()},
    )


def label_gaps(idle: List[Tuple[float, float]],
               host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle seconds by the innermost host operation (of the thread
    ``host``, properly nested) open at each gap's midpoint; "host code
    outside any profiled op" where none is."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    out: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for g0, g1 in sorted(idle):
        m = 0.5 * (g0 + g1)
        j = bisect.bisect_right(starts, m)
        while i < j:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        # an op that ended early below a still-open one stays until the
        # open one above it pops; skip such leftovers when labelling
        label = next((h[2] for h in reversed(stack) if h[1] >= m),
                     "host code outside any profiled op")
        out[label] += g1 - g0
    return dict(out)
