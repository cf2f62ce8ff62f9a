"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

  ttl_scan  -- batched ExpectedCost(TTL) surface (CUDA C++, csrc/ttl_scan.cu)
  flash_attention -- streaming softmax attention (CUDA C++,
                     csrc/flash_attention.cu)
  build     -- nvcc build and ctypes loading of the kernel sources
  ref       -- the plain PyTorch version of every kernel, and the RWKV6
               recurrence's oracle
  ops       -- public wrappers: device placement, TTL=0 column, argmin rule;
               ``rwkv6_scan``, a plain scan (no kernel)

Kernels are compiled with nvcc at first use, never at import.  Only
``rwkv6_scan`` is exported here: the reference's other exports (``ops``'
``flash_attention`` and ``ttl_scan``) would hide the modules of those names.
"""

from .ops import rwkv6_scan  # noqa: F401
