"""msckf_stereo_c — a stereo MSCKF visual-inertial engine in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of the C++
reference ``mfkiwl/msckf_stereo_c`` (see SURVEY.md): stereo KLT feature
tracking, IMU propagation with covariance, multi-state-constraint EKF
updates, EuRoC evaluation — all as fixed-shape, jit/vmap-able programs.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .config import EUROC_CALIB, FilterConfig, FrontendConfig, StereoCalib  # noqa: F401
