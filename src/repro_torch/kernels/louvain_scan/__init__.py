"""ELL best-move scan kernels K1 (fused) and K2 (scan only)."""
