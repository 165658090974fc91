"""Tensor functions (geometry, solvers, matching, features), batched over
leading axes; csrc/ holds the CUDA kernels (built by cuda_build)."""
