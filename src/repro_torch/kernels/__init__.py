"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

csrc/               the CUDA sources (built by _build.py with nvcc at first use)
gf256_encode.py     GF(2^8) matmul / stream scaling on bytes (RS encode and decode),
                    and the GF(2) bit-matrix product of the "MXU" RS encode
xor_reduce.py       parity-accumulator XOR fold
flash_attention.py  online-softmax attention forward, and the kernel pair that trains on it
adamw.py            AdamW's gradient norm and in-place update, fused
ops.py              public ops with device dispatch; ref.py: plain LUT oracles
"""
