"""Device layouts, the DIA and ELL kernels, BLAS-1 and the fp64 operator."""


def kernel_wrappers() -> tuple:
    """Every kernel wrapper; each counts its launches in ``launches``
    (the refinement pass's fp64 finish, the loop guard of the device loop
    mode's pass graphs and the tracer's stamp included)."""
    from ..solve.graphs import loop_guard
    from ..utils.trace import trace_stamp
    from . import dia_spmv, ell_spmv
    from .block_ell import block_ell_spmv
    from .fp64 import dia_finish64
    return (*dia_spmv.WRAPPERS, *ell_spmv.WRAPPERS, block_ell_spmv,
            dia_finish64, loop_guard, trace_stamp)


def counted(fn):
    """(fn(), {wrapper name: kernel launches during fn()}): every
    wrapper's launch count set to 0 just before fn and read just after."""
    wrappers = kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    out = fn()
    return out, {w.__name__: w.launches for w in wrappers}
