"""Modules found by name: ``fembench/<kind>/<name>.py`` under a checkout's
root.  A later PR adds one by adding its file.

``generators/<generator>``, named by a configuration's ``mesh``
    ``build(**the entry's other keys) -> meshes.Mesh``.
``systems/<system>``, named by a configuration
    ``build(config, mix, mesh, nonlinear, device)``, the program's system,
    and ``recover(system) -> {name: tensor}``, the displacement ``u`` and
    the fields a user reads back after each analysis.
``reference/<reference>``, named by a configuration
    ``Model(nodes, elements, modulus, poisson_ratio, device)``.
``procedures/<procedure>``, named by a traffic mix
    ``NONLINEAR``; ``case(mix, draw)``, one case; ``prepare(mesh)``, what a
    run's cases share, in set-up; ``solve(program, case, keep) ->
    (success, what the check keeps besides the fields)``;
    ``ended(sample)``, whether a kept analysis ran to its planned end; and
    ``numbers(torch, model, sample)``, the compared numbers.
``metrics/<metric>``, one per per-layer metric
    ``UNIT``, ``LAYER`` and ``read(record)``, None where there is nothing
    to read.
"""

from __future__ import annotations

import importlib.util
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[2]


def module(kind: str, name: str, root: pathlib.Path = ROOT):
    """The module ``fembench/<kind>/<name>.py`` under ``root``, loaded
    afresh."""
    path = pathlib.Path(root) / "fembench" / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"fembench_{kind}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
