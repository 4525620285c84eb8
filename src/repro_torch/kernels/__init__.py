"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

csrc/               the CUDA sources (built by _build.py with nvcc at first use)
gf256_encode.py     GF(2^8) matmul / stream scaling on bytes (RS encode and decode)
xor_reduce.py       parity-accumulator XOR fold
ops.py              public ops with device dispatch; ref.py: plain LUT oracles
"""
