from .base import SceneData  # noqa: F401
from .synthetic import SyntheticDataset  # noqa: F401


def get_dataset(name: str):
    """Dataset registry (reference: datasets/__init__.py:6-8). The file
    loaders import h5py (Hypersim) and cv2 (all three) when they read."""
    if name == "hypersim":
        from .hypersim import HypersimDataset
        return HypersimDataset
    if name == "scannet_manhattan":
        from .scannet_manhattan import ScanNetManhattanDataset
        return ScanNetManhattanDataset
    if name == "replica_semnerf":
        from .replica_semnerf import ReplicaSemNerfDataset
        return ReplicaSemNerfDataset
    if name == "synthetic":
        return SyntheticDataset
    raise KeyError(name)
