"""Local kernels: masks, the LAPACK seam, and the hand-written Hopper kernels."""
