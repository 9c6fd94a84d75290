"""Device layouts, the DIA and ELL kernels, BLAS-1 and the fp64 operator."""
