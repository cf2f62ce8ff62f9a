"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

  ttl_scan  -- batched ExpectedCost(TTL) surface (CUDA C++, csrc/ttl_scan.cu)
  ref       -- the plain PyTorch version of every kernel
  ops       -- public wrappers: device placement, TTL=0 column, argmin rule

Kernels are compiled with nvcc at first use, never at import.
"""
