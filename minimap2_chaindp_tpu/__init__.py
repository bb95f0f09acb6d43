"""minimap2_chaindp_tpu — a GPU-accelerated long/short-read aligner.

A from-scratch rebuild of the capabilities of stormalex/minimap2_chaindp
(minimap2 v2.10 + FPGA chaining-DP offload): minimizer sketching, a
device-resident sorted-table index, a Pallas banded chaining-DP kernel, a
Pallas anti-diagonal affine-gap extension kernel, and host epilogue producing
SAM/PAF output byte-identical to the reference.
"""

__version__ = "0.1.0"
