"""The system under test, ``femcy_tpu_torch``, driven as a user drives it.

The configuration's ``system`` (``fembench/systems/<system>.py``) builds
one system per run and recovers the fields a user reads back; the mix's
procedure (``fembench/procedures/<procedure>.py``) runs each analysis on
it.  Every analysis is the procedure's solve, then the system's stress
recovery, ended by a synchronise.  The program is imported here and in
``fembench/systems/`` alone.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

#: the program's switch between float64 and float32
DTYPE_ENV = {"float64": "1", "float32": "0"}


def set_dtype(dtype: str):
    """Make the program run in ``dtype`` (it reads this at construction)."""
    os.environ["FEMCY_TPU_X64"] = DTYPE_ENV[dtype]


class Program:
    def __init__(self, spec, mesh, device: str):
        import torch

        self.torch = torch
        self.mesh = mesh
        self.config = spec.config
        self.procedure = spec.procedure
        #: what the procedure's cases share, worked out in set-up
        self.prepared = spec.procedure.prepare(mesh)
        self.recover = spec.system.recover
        self.system = spec.system.build(spec.config, spec.mix, mesh,
                                        self.procedure.NONLINEAR, device)
        self.device = self.system.device

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def inp_model(self, dirichlet, time_incs: dict):
        """The program's model of the configuration's mesh and material
        with the Dirichlet conditions ``dirichlet``, each (node ids, dof,
        value, whether the user hook gives the value), stepped by
        ``time_incs``."""
        from femcy_tpu_torch.io.inp import DirichletBC, InpModel

        mat = self.config["material"]
        return InpModel(
            nodes=self.mesh.nodes, elements=self.mesh.elements,
            element_type=self.config["element"], node_sets={}, ele_sets={},
            face_sets={}, dirichlet_bcs=[DirichletBC(*bc) for bc in dirichlet],
            neumann_bcs=[], material_type="Elastic",
            material_params=[mat["modulus"], mat["poisson_ratio"]],
            geometric_nonlinear=self.procedure.NONLINEAR, time_incs=time_incs)

    def analysis(self, case: dict, keep: bool):
        """Run one analysis; returns (success, post-processing seconds,
        outputs or None).  With ``keep`` the outputs are what the check
        reads: the case, the recovered fields and what the procedure kept,
        the fields still on the device (``host`` copies them out)."""
        ok, kept = self.procedure.solve(self, case, keep)
        self.sync()
        t = time.perf_counter()
        fields = self.recover(self.system)
        self.sync()
        post = time.perf_counter() - t
        out: Optional[dict] = None
        if keep:
            out = dict(fields, case=case, success=ok, **kept)
        return ok, post, out

    def reserve(self, k: int):
        """Room on the host for ``k`` kept analyses' recovered fields, in
        page-locked memory on a card, so that keeping one is a short copy
        and takes none of the card's memory."""
        torch = self.torch
        pin = self.device.type == "cuda"
        fields = self.recover(self.system)
        self.slots = [{n: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
                       for n, v in fields.items()} for _ in range(k)]

    def host(self, out: dict, slot: int) -> dict:
        """``out`` with its recovered fields copied into the host room of
        ``slot`` (``reserve``); the copy is ordered on the card's stream,
        and is complete at the next synchronise."""
        room = self.slots[slot]
        return {k: room[k].copy_(v, non_blocking=True) if k in room else v
                for k, v in out.items()}

    @contextlib.contextmanager
    def labelled_sections(self, prefix: str):
        """Inside, each of the program's synchronised Timer sections is also
        a profiler range named ``prefix`` + its name, which starts after
        the section's opening synchronise and ends after its work has
        finished on the card."""
        timer = self.system.timer
        section = timer.section
        record = self.torch.profiler.record_function

        @contextlib.contextmanager
        def labelled(name):
            with section(name):
                with record(prefix + name):
                    yield
                    self.sync()

        timer.section = labelled
        try:
            yield
        finally:
            del timer.section

    def close(self):
        """Free the program's state on the card."""
        self.system = None
        if self.device.type == "cuda":
            import gc

            gc.collect()
            self.torch.cuda.empty_cache()
