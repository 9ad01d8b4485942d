from .base import SceneData  # noqa: F401
from .synthetic import SyntheticDataset  # noqa: F401
