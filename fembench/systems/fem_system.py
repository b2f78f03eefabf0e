"""``femcy_tpu_torch.FEMSystem``, one per run: the configuration's mesh,
element (its Abaqus keyword), material and dtype, the mix's solver
controls, nonlinear where the mix's procedure is.  ``recover`` is the stress recovery a user reads
back after each analysis: the displacement, strain, stress and Mises of
every element."""

from __future__ import annotations


def build(config: dict, mix: dict, mesh, nonlinear: bool, device: str):
    import femcy_tpu_torch as T
    from femcy_tpu_torch.elements import get_element

    mat = config["material"]
    material = getattr(T, mat["kind"])(mat["modulus"], mat["poisson_ratio"])
    fem_mesh = T.FEMesh(mesh.nodes, mesh.elements,
                        get_element(config["element"]),
                        structure=mesh.structure)
    return T.FEMSystem(fem_mesh, material, nonlinear,
                       T.SolverConfig(**mix["solver"]), device=device)


def recover(system) -> dict:
    strain, stress, mises = system.compute_strain_stress()
    return {"u": system.dof, "strain": strain, "stress": stress,
            "mises": mises}
