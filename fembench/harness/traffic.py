"""The one general generator of the benchmark's traffic.

A traffic mix is a JSON file of parameters under ``fembench/traffic/``;
its ``procedure`` names the analysis that each case runs,
``fembench/procedures/<procedure>.py``, whose ``case(mix, draw)`` makes
one case from the mix's parameters and ``draw``.  ``draw(key)`` draws the
mix's parameter ``key``: a ``[low, high]`` range (uniform), a
``{"choice": [...]}`` (one value at random each time) or a
``{"cycle": [...]}``: the listed values in an order the seed shuffles,
each used once before any is used again, so that every seed sends the
same set of sizes and only their order differs.

The same seed gives the same stream; the warm-up cases are fixed by the
mix alone (``warmup``), so set-up does the same work on every seed.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


def stream(mix: dict, seed: int, procedure) -> Iterator[dict]:
    """The endless stream of cases that ``seed`` draws from ``mix``."""
    rng = np.random.default_rng(seed)
    decks = {}

    def draw(key):
        spec = mix[key]
        if isinstance(spec, list):
            lo, hi = spec
            return float(rng.uniform(lo, hi))
        if "choice" in spec:
            return float(spec["choice"][rng.integers(len(spec["choice"]))])
        deck = decks.setdefault(key, [])
        if not deck:
            deck.extend(rng.permutation(spec["cycle"]).tolist())
        return float(deck.pop())

    while True:
        yield procedure.case(mix, draw)


def warmup_cases(mix: dict, procedure) -> List[dict]:
    """The set-up's cases: each of the mix's ``warmup`` entries gives the
    drawn parameters their values, and overrides any key of the case it
    names (a twist warm-up may end after fewer ``increments``)."""
    out = []
    for w in mix["warmup"]:
        case = procedure.case(mix, lambda key: float(w[key]))
        case.update({k: v for k, v in w.items() if k in case})
        out.append(case)
    return out
