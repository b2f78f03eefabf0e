"""Riks arc-length continuation (femcy_tpu_torch.solvers.riks) against
femcy_tpu's, on the CPU, in float64.

A fold-free C3D4 cantilever (``meshgen.cantilever_tets``) written inline as
an Abaqus .inp with a transverse *Dsload on its free end and nlgeom, read
by both packages' ``read_inp``; both run ``riks_solve`` on a FEMSystem of
the same mesh and material with direct linear solves.  Tolerances: the
step count, each step's Newton iterations, the stiffness signs, success,
limit point and message equal; the lambda history and arc lengths within
1e-10 relative, the stiffness parameters within 1e-8; the final dof within
1e-8 relative.  The port's dof at lambda = 1 also agrees with its own
load-controlled FEMSystem.solve of the same load (newton_rel_tol 1e-8)
within 1e-6.
"""

import numpy as np
import pytest
import torch

from femcy_tpu import FEMesh as JFEMesh
from femcy_tpu import FEMSystem as JFEMSystem
from femcy_tpu import read_inp as j_read_inp
from femcy_tpu.materials import material_from_inp as j_material_from_inp
from femcy_tpu.solvers.riks import riks_solve as j_riks_solve

import femcy_tpu_torch as T
from femcy_tpu_torch.materials import material_from_inp
from femcy_tpu_torch.solvers.riks import riks_solve


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


CLAMP = ("fix, 1, 1", "fix, 2, 2", "fix, 3, 3")


def _cantilever_inp(load=0.1, boundary=CLAMP, nlgeom="YES",
                    dsload=True):
    """cantilever_tets(6, 2) as a C3D4 .inp: x=0 clamped (node set
    ``fix``), a traction ``load`` along z on the x=10 end face (a *Surface
    of per-face-number element sets), *Elastic 1000, 0.3."""
    mesh, _, _ = T.meshgen.cantilever_tets(6, 2)
    lines = ["*Heading", "riks cantilever", "*Node"]
    lines += [f"{i + 1}, " + ", ".join(repr(float(c)) for c in p)
              for i, p in enumerate(mesh.nodes)]
    lines.append("*Element, type=C3D4")
    lines += [f"{e + 1}, " + ", ".join(str(int(n) + 1) for n in conn)
              for e, conn in enumerate(mesh.elements)]
    x = mesh.nodes[:, 0]
    faces = {}
    for e, conn in enumerate(mesh.elements):
        for k, facets in enumerate(mesh.element.inp_surface_num):
            nodes = [int(conn[ln]) for f in facets for ln in f]
            if (x[nodes] > x.max() - 1e-9).all():
                faces.setdefault(k + 1, []).append(e + 1)
    lines += ["*Nset, nset=fix, instance=a",
              ", ".join(str(i + 1) for i in np.nonzero(x < 1e-9)[0])]
    for k, eles in faces.items():
        lines += [f"*Elset, elset=_x{k}, internal, instance=a",
                  ", ".join(str(e) for e in eles)]
    lines.append("*Surface, type=ELEMENT, name=xload")
    lines += [f"_x{k}, S{k}" for k in faces]
    lines += ["*Material, name=m", "*Elastic", "1000., 0.3",
              f"*Step, name=s, nlgeom={nlgeom}", "*Static",
              "1., 1., 1e-05, 1.", "*Boundary", *boundary]
    if dsload:
        lines += ["*Dsload", f"xload, TRVEC, {load}, 0., 0., 1."]
    lines.append("*End Step")
    return "\n".join(lines) + "\n"


def _read(tmp_path, text, nlgeom=True, config=None):
    """(femcy_tpu's (inp, system), the port's (inp, system) on the CPU,
    with ``config``)."""
    path = tmp_path / "cantilever.inp"
    path.write_text(text)
    ji, ti = j_read_inp(str(path)), T.read_inp(str(path))
    jsys = JFEMSystem(JFEMesh(ji.nodes, ji.elements, ji.element),
                      j_material_from_inp(ji.material_type, ji.material_params,
                                          ji.element_type), nlgeom)
    tsys = T.FEMSystem(T.FEMesh(ti.nodes, ti.elements, ti.element),
                       material_from_inp(ti.material_type, ti.material_params,
                                         ti.element_type), nlgeom,
                       config or T.SolverConfig(), device="cpu")
    return (ji, jsys), (ti, tsys)


def test_riks_report_matches_jax(tmp_path):
    (ji, jsys), (ti, tsys) = _read(tmp_path, _cantilever_inp())
    jrep = j_riks_solve(jsys, ji, lam_target=1.0, first_dlam=0.2)
    trep = riks_solve(tsys, ti, lam_target=1.0, first_dlam=0.2)
    assert trep.success and jrep.success and not trep.limit_point
    assert (trep.message, trep.limit_point, trep.lam_limit) == (
        jrep.message, jrep.limit_point, jrep.lam_limit)
    assert trep.u_limit is None and jrep.u_limit is None
    assert len(trep.steps) == len(jrep.steps) >= 3
    for ts, js in zip(trep.steps, jrep.steps):
        assert (ts.step, ts.iters) == (js.step, js.iters)
        assert np.sign(ts.stiffness) == np.sign(js.stiffness)
        assert abs(ts.stiffness - js.stiffness) <= 1e-8 * abs(js.stiffness)
        assert abs(ts.dl - js.dl) <= 1e-10 * abs(js.dl)
    assert _rel(trep.lam_history, jrep.lam_history) < 1e-10
    assert abs(trep.lam_max - jrep.lam_max) <= 1e-10 * jrep.lam_max
    assert _rel(tsys.dof.numpy(), np.asarray(jsys.dof)) < 1e-8
    # the same equilibrium as the load-controlled Newton solve at lambda 1,
    # converged as far as Riks converges
    (_, _), (ti2, newton) = _read(tmp_path, _cantilever_inp(),
                                  config=T.SolverConfig(newton_rel_tol=1e-8))
    assert newton.solve(ti2).success
    assert _rel(tsys.dof.numpy(), newton.dof.numpy()) < 1e-6


@pytest.mark.parametrize("case", ["nonhomogeneous", "no load", "linear"])
def test_riks_raises_as_jax(tmp_path, case):
    """A prescribed nonzero displacement and a model without a *Dsload
    raise femcy_tpu's ValueError; a linear system fails its assert."""
    kw = {"nonhomogeneous": dict(boundary=CLAMP + ("fix, 1, 1, 0.01",)),
          "no load": dict(dsload=False), "linear": {}}[case]
    (ji, jsys), (ti, tsys) = _read(tmp_path, _cantilever_inp(**kw),
                                   nlgeom=case != "linear")
    err = AssertionError if case == "linear" else ValueError
    with pytest.raises(err) as j_err:
        j_riks_solve(jsys, ji)
    with pytest.raises(err) as t_err:
        riks_solve(tsys, ti)
    assert str(t_err.value) == str(j_err.value)
    assert isinstance(tsys.dof, torch.Tensor)
