"""Validation metrics of the port: its own numpy copies of the JAX
package's `metrics/` (nothing is imported from there)."""
from .metrics import NeRFMTMetricsPerIm  # noqa: F401
from .rgb import psnr, ssim  # noqa: F401
from .depth import depth_abs_err, depth_rmse  # noqa: F401
from .normals import normal_angular_error  # noqa: F401
from .semantic import confusion_matrix, miou_from_confusion  # noqa: F401
