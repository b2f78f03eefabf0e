from femcy_tpu_torch.io.colormap import femcy_colormap, get_color, resolve_cmap
from femcy_tpu_torch.io.inp import (
    DirichletBC,
    InpBlockModel,
    InpModel,
    NeumannBC,
    read_inp,
    read_inp_multi,
)

__all__ = [
    "InpModel",
    "InpBlockModel",
    "DirichletBC",
    "NeumannBC",
    "read_inp",
    "read_inp_multi",
    "femcy_colormap",
    "get_color",
    "resolve_cmap",
]
