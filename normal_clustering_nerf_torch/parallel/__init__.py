"""Training on several cards of one host: the launcher and the "rays" axis."""
from .launch import initialize_multihost, spawn  # noqa: F401
from .mesh import RaysAxis, make_mesh  # noqa: F401
