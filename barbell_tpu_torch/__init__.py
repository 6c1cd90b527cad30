"""barbell_tpu_torch — the PyTorch + CUDA port of barbell_tpu for one
NVIDIA H100.

The flagship path (``kit -k SQK-RBK114-96`` with the two-tier ends scan)
runs through this package: host planning in numpy and the native IO
library (reused from ``barbell_tpu``), the fused per-batch device call
in PyTorch, and its three hand-written Hopper kernels (``csrc/``:
Myers flank scan, window DP in three modes, barcode rank).  The JAX
package ``barbell_tpu`` is the reference it is tested against; this
package never imports jax.
"""

__version__ = "0.1.0"
