from femcy_tpu_torch.io.inp import DirichletBC, InpModel, NeumannBC, read_inp

__all__ = ["InpModel", "DirichletBC", "NeumannBC", "read_inp"]
