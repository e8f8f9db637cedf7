"""RangeReach serving kernels: the arena layout and the fused serve."""
