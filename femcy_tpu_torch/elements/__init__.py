from femcy_tpu_torch.elements.base import ElementType
from femcy_tpu_torch.elements.library import (
    ELEMENT_REGISTRY,
    HEX8,
    HEX20,
    QUAD4,
    QUAD8,
    TET4,
    TET10,
    TRI3,
    TRI6,
    WEDGE6,
    get_element,
)

__all__ = [
    "ElementType",
    "ELEMENT_REGISTRY",
    "get_element",
    "TRI3",
    "TRI6",
    "QUAD4",
    "QUAD8",
    "TET4",
    "TET10",
    "HEX8",
    "HEX20",
    "WEDGE6",
]
