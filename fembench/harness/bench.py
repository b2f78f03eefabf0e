"""One run of one cell: read the cell, make its inputs from the seed, build
the program, warm it up, run analyses back to back for the window,
optionally trace a bounded stretch, judge the kept analyses against the
reference, and reduce the records to the cell's metrics.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in the file that names, its traffic in
``fembench/traffic/<traffic>.json``, the limits of its comparison in
``fembench/limits/<cell>.json``, and the modules of ``named``: the
configuration's mesh generator, system and reference, the mix's
procedure, and each per-layer metric's reader.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import random
import sys
import time
from typing import Dict, List, Optional

from fembench.harness import checks, meshes, named, stats, traffic

ROOT = named.ROOT
#: modules the process may not hold once the window has closed, compared
#: by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "femcy_tpu")


@dataclasses.dataclass
class Spec:
    cell: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: pathlib.Path
    procedure: object  # the mix's procedure module
    system: object  # the configuration's system module


def _json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


def load_spec(cell: str, root: pathlib.Path = ROOT) -> Spec:
    bench = _json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = work[cell]
    cfg = _json(root / {c["name"]: c for c in bench["configs"]}[w["config"]]["file"])
    mix = _json(root / "fembench" / "traffic" / f"{w['traffic']}.json")
    return Spec(
        cell=cell, chips=w["chips"], config=cfg, mix=mix,
        limits=_json(root / "fembench" / "limits" / f"{cell}.json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if cell in m.get("workloads", [cell])],
        per_layer=[m for m in bench["per_layer"] if cell in m["workloads"]],
        root=root,
        procedure=named.module("procedures", mix["procedure"], root),
        system=named.module("systems", cfg["system"], root))


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """The reader module of per-layer metric ``name``: ``metrics/<name>.py``,
    or for a name ``<base>.<tag>`` without a file of its own
    ``metrics/<base>.py``: one quantity split by the end-to-end metric it
    moves (``linear_solve_ms.host`` moves ``solve_s.host``)."""
    own = (root / "fembench" / "metrics" / f"{name}.py").is_file()
    return named.module("metrics", name if own else name.split(".")[0], root)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Analysis:
    wall_s: float
    post_s: float
    #: Timer section name -> seconds of each section the analysis ran
    spans: Dict[str, List[float]]
    cg_iters: List[int]


@dataclasses.dataclass
class Record:
    """What the metric readers read: the window's analyses, the traced
    stretch (or None), the mesh, the dtype's byte size, the card's name,
    and the torch module and device for counts made on the card."""
    analyses: List[Analysis]
    window_s: float
    trace: Optional[object]
    mesh: meshes.Mesh
    itemsize: int
    device_kind: str
    torch: object
    device: object


class Reservoir:
    """A uniform sample of at most ``k`` of the window's analyses, drawn
    from the seed; whether analysis i is kept is known before it runs."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.kept: List[Optional[dict]] = []
        self.seen = 0

    def slot(self) -> Optional[int]:
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.kept.append(None)
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None


def build(spec: Spec, device: str, mesh: Optional[meshes.Mesh] = None,
          dtype: Optional[str] = None):
    """The program on the configuration's mesh (built here unless given),
    in the configuration's dtype unless ``dtype`` says otherwise, warmed
    up on the mix's warm-up cases."""
    from fembench.harness import program as prog

    mesh = mesh if mesh is not None else meshes.build(spec.config["mesh"],
                                                      spec.root)
    prog.set_dtype(dtype or spec.config["dtype"])
    p = prog.Program(spec, mesh, device)
    for case in traffic.warmup_cases(spec.mix, spec.procedure):
        p.analysis(case, keep=False)
    p.reserve(spec.mix["sample"])
    p.sync()
    return p


@dataclasses.dataclass
class Window:
    analyses: List[Analysis]
    window_s: float
    failed: int
    samples: List[dict]  # the kept analyses' outputs, on the host
    cases: object  # the rest of the seed's stream


def window(p, spec: Spec, seed: int, seconds: float) -> Window:
    """Analyses back to back, each timed from its start to its synchronised
    end, until ``seconds`` have passed; the window closes with the
    analysis that crosses it.  A kept analysis's outputs go to the host
    once its wall has been read."""
    cases = traffic.stream(spec.mix, seed, spec.procedure)
    keep = Reservoir(spec.mix["sample"], seed)
    timer, cg_log = p.system.timer.records, p.system._cg_iters_log
    analyses: List[Analysis] = []
    failed = 0
    w0 = time.perf_counter()
    while True:
        slot = keep.slot()
        r0, c0 = len(timer), len(cg_log)
        t = time.perf_counter()
        ok, post, out = p.analysis(next(cases), keep=slot is not None)
        t1 = time.perf_counter()
        spans: Dict[str, List[float]] = {}
        for rec in timer[r0:]:
            spans.setdefault(rec.name, []).append(rec.seconds)
        analyses.append(Analysis(t1 - t, post, spans, list(cg_log[c0:])))
        failed += not ok
        if slot is not None:
            keep.kept[slot] = p.host(out, slot)
        out = None
        if t1 - w0 >= seconds:
            break
    p.sync()
    samples = [s for s in keep.kept if s is not None]
    failed += sum(not spec.procedure.ended(s) for s in samples if s["success"])
    return Window(analyses, t1 - w0, failed, samples, cases)


def compare(torch, spec: Spec, mesh: meshes.Mesh, samples: List[dict],
            device):
    """(compared numbers, their limits) of the kept analyses."""
    cfg = spec.config
    ref = named.module("reference", cfg["reference"], spec.root)
    model = ref.Model(mesh.nodes, mesh.elements, cfg["material"]["modulus"],
                      cfg["material"]["poisson_ratio"], device)
    return (checks.numbers(torch, model, samples, spec.procedure),
            checks.limits(spec.limits, spec.mix))


def run(spec: Spec, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, mesh: Optional[meshes.Mesh] = None,
        dtype: Optional[str] = None):
    """One run; returns (the result line as a dict, the traced over the
    untraced seconds an analysis or None, the window's analyses)."""
    import torch

    mix = spec.mix
    mesh = mesh if mesh is not None else meshes.build(spec.config["mesh"],
                                                      spec.root)
    p = build(spec, device, mesh, dtype)
    setup_s = time.perf_counter() - t_start
    w = window(p, spec, seed, seconds)
    on_card = p.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(p.device) if on_card else None
    kind = torch.cuda.get_device_name(p.device) if on_card else "cpu"

    summary = None
    if trace:
        from fembench.harness import trace as tr

        def stretch():
            n = mix["trace_analyses"]
            for _ in range(n):
                p.analysis(next(w.cases), keep=False)
            return n

        summary = tr.traced(torch, p, stretch)
    itemsize = torch.empty((), dtype=p.system.dtype).element_size()
    device = p.device
    p.close()

    values, lims = compare(torch, spec, mesh, w.samples, device)
    w.samples = []
    correct = w.failed == 0 and checks.judge(values, lims)

    record = Record(w.analyses, w.window_s, summary, mesh, itemsize, kind,
                    torch, device)
    if trace:
        metrics = {}
        for m in spec.per_layer:
            v = metric_reader(m["name"], spec.root).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = end_to_end(spec, record, setup_s, peak)
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": spec.chips if on_card else 0,
           "memory_peak_bytes": peak}
    overhead = None
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        overhead = (summary.window_s / summary.analyses) / stats.window_rate(
            w.window_s, len(w.analyses))
    result = {"correct": bool(correct), "attempted": len(w.analyses),
              "failed": w.failed, "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = {k: {"value": values.get(k), "limit": lims[k]}
                        for k in lims}
    return result, overhead, w.analyses


def end_to_end(spec: Spec, rec: Record, setup_s: float, peak) -> dict:
    """The cell's end-to-end metrics; ``<base>.<tag>`` is ``<base>`` in the
    cells whose runs spread so much more that they need a bound of their
    own (``solve_s.host``)."""
    walls = [a.wall_s for a in rec.analyses]
    have = {
        "solve_s": lambda: stats.window_rate(rec.window_s, len(walls)),
        "solve_p95_s": lambda: stats.percentile(walls, 95),
        "peak_mem_gib": lambda: None if peak is None else peak / 2**30,
        "setup_s": lambda: setup_s,
    }
    out = {}
    for m in spec.end_to_end:
        v = have[m["name"].split(".")[0]]()
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
