"""Bundle adjustment: residuals, dense-Schur Levenberg-Marquardt.

Counterpart of metricsfm_tpu/ba (replacing the reference's Ceres
DENSE_SCHUR BundleAdjuster, SfM/src/optimizer.{h,cc}).
"""
from .problem import BAProblem  # noqa: F401
from .lm import solve_lm, LMConfig  # noqa: F401
