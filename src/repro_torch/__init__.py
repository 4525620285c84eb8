"""repro_torch: the PyTorch + CUDA port of ``repro``.

The erasure-coded data plane (RS encode, degraded decode, streaming
TriEC) and the storage cluster that drives it, with hand-written CUDA
kernels for Hopper (``sm_90a``) in :mod:`repro_torch.kernels`.  The
package imports ``torch`` and never ``jax``, and keeps its own copy of
every pure-Python module it needs.  Entry points run on
``torch.device("cuda")`` unless the caller passes ``device="cpu"``, where
each kernel's plain PyTorch version computes the same bytes.
"""

__version__ = "1.0.0"

#: where every entry point runs unless the caller names a device
DEFAULT_DEVICE = "cuda"
