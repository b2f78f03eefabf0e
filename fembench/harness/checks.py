"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``fembench/reference/``) judges the analyses that the window
kept, a sample drawn from the seed and held on the host.  The procedure
that ran them (``fembench/procedures/``) names the numbers: its
``numbers(torch, model, sample)`` rebuilds the prescribed dofs from the
case and works out the internal force and the recovered fields again from
the mesh and material, and reads the program's outputs only to judge
them.  Each number is the worst over the sampled analyses; its limit is
in ``fembench/limits/<cell>.json``.

Every procedure compares the recovered fields with ``field_gaps``:

``strain_gap``, ``stress_gap``, ``mises_gap``
    the fields the program recovered from its displacement against the
    reference's from the same displacement, the largest difference over
    the largest reference magnitude.
"""

from __future__ import annotations

import math
from typing import Dict, List


def _rel_gap(port, ref) -> float:
    E = ref.shape[0]
    p = port.to(ref.device).reshape((E, -1) + tuple(ref.shape[1:])).double()
    return float((p - ref.unsqueeze(1)).abs().max() / ref.abs().max())


def field_gaps(model, sample, u, large: bool) -> Dict[str, float]:
    strain, stress, mises = model.recover(u, large)
    return {"strain_gap": _rel_gap(sample["strain"], strain),
            "stress_gap": _rel_gap(sample["stress"], stress),
            "mises_gap": _rel_gap(sample["mises"], mises)}


def on(torch, model, a, dtype=None):
    """``a`` as a tensor on the reference's device, float64 unless
    ``dtype`` says otherwise."""
    return torch.as_tensor(a, dtype=dtype or torch.float64,
                           device=model.device)


def numbers(torch, model, samples: List[dict], procedure) -> Dict[str, float]:
    """Each compared number, the worst over ``samples`` (NaN stays NaN)."""
    worst: Dict[str, float] = {}
    for s in samples:
        for k, v in procedure.numbers(torch, model, s).items():
            w = worst.get(k, 0.0)
            worst[k] = w if math.isnan(w) or v <= w else v
    return worst


def limits(spec: dict, mix: dict) -> Dict[str, float]:
    """Each number's limit: a number, or the name of the mix's solver
    control that states it."""
    out = {}
    for name, entry in spec.items():
        lim = entry["limit"]
        out[name] = float(mix["solver"][lim]) if isinstance(lim, str) else float(lim)
    return out


def judge(values: Dict[str, float], lims: Dict[str, float]):
    """Whether every number is within its limit; one missing or NaN
    fails."""
    return all(values.get(name, math.nan) <= lim for name, lim in lims.items())
