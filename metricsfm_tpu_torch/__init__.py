"""MetricSfM on PyTorch and CUDA.

The PyTorch port of the JAX package ``metricsfm_tpu``.  It keeps that
package's module paths and public names, so ``metricsfm_tpu/ops/ransac.py``
has its counterpart in ``metricsfm_tpu_torch/ops/ransac.py``, and it never
imports jax.

Package layout:
  ops/       tensor functions (geometry, solvers, matching, SIFT); ops/csrc
             holds the CUDA kernels, built with nvcc at first use
  ba/        bundle adjustment: residuals, dense-Schur Levenberg-Marquardt
  models/    scene data model + pipeline drivers (incremental SfM)
  parallel/  host-side sharding helpers
  io/        feature/match stores, interop exports
  utils/     EXIF, tracing, synthetic scenes
"""

import torch as _torch

# Geometry and BA need true f32 products (the JAX package sets
# jax_default_matmul_precision="highest").  TF32 keeps ~3 decimal digits:
# enough to flip DoG extrema in the SIFT pyramid convolutions and to break
# rotation algebra and normal equations.  Descriptor matching opts into
# bf16 explicitly, in its own kernel.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
