"""Scene container: host numpy arrays the trainer moves to its device once
(a copy of the JAX package's `datasets/base.py:SceneData`)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class SceneData:
    """Everything the trainer needs for one split of one scene."""
    poses: np.ndarray                   # (N_img, 3, 4) c2w
    directions: np.ndarray              # (H*W, 3) camera-frame ray dirs
    rays: np.ndarray                    # (N_img, H*W, 3[+1]) rgb (+exposure)
    img_wh: Tuple[int, int]
    K: Optional[np.ndarray] = None      # (3, 3) pinhole intrinsics
    proj: Optional[tuple] = None        # Hypersim (M_ndc, M_uv, shift, scale)
    labels: Dict[str, np.ndarray] = field(default_factory=dict)
    img_ids: List[str] = field(default_factory=list)
    n_classes: int = 0
    class_metadata: Optional[dict] = None
    xyz_cam_min: Optional[np.ndarray] = None
    xyz_cam_max: Optional[np.ndarray] = None
    scale: float = 0.5

    @property
    def n_images(self) -> int:
        return self.poses.shape[0]
