"""barbell_tpu_torch — the PyTorch + CUDA port of barbell_tpu for one
NVIDIA H100.

The kit pipeline (``kit``, the two-tier ends scan or ``--full-scan``)
and the stepwise ``annotate -> inspect -> filter -> trim`` commands run
through this package: host planning in numpy and its own native IO
library (``native/``, built into ``build/``), the fused per-batch device
call in PyTorch, and its three hand-written Hopper kernels (``csrc/``:
Myers flank scan, window DP in three modes, barcode rank).  The JAX
package ``barbell_tpu`` is the reference it is tested against; this
package imports neither jax nor ``barbell_tpu``: it holds its own copies
of the host modules it shares with the reference.
"""

__version__ = "0.1.0"

# Barcode window padding in bases, reference `src/lib.rs:10` (PADDING = 10).
PADDING = 10
