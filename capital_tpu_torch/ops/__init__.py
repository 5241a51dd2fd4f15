"""Local kernels: masks, the LAPACK seam, TSQR, and the hand-written Hopper kernels."""
