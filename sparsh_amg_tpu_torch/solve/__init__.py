"""Device hierarchy, smoothers, cycles, PCG and the refinement solver."""
