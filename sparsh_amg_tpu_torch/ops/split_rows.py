"""Launch shape of the split-row kernels (``csrc/split_rows.cuh``), shared by
``ell_spmv`` and ``block_ell_spmv``.

A row of K slots is split over P = G * S threads: G lanes of a block and
S blocks of a thread-block cluster.  ``choose`` is the plain rule;
``launch_shape`` applies it with the limits of the card a tensor lies on:
its resident threads (SMs x threads per SM, from the device properties)
and the kernels' lane and cluster limits (from the kernel library).
"""
from __future__ import annotations

import functools

import torch

MIN_SLOTS = 8     # slots a thread keeps at least


def choose(n_rows: int, k: int, resident_threads: int, max_lanes: int,
           max_cluster: int) -> tuple:
    """(G, S): the lanes of a block and the blocks of a cluster that share
    each row's slots.  The split P = G * S doubles while the split rows
    still fit the card's resident threads (n_rows * P) and every thread
    keeps at least MIN_SLOTS of the K slots; lanes fill first.  Rows that
    fill the card alone (hundreds of thousands) get (1, 1), one thread per
    row with its slots summed in order."""
    p = 1
    while (p < max_lanes * max_cluster
           and n_rows * 2 * p <= resident_threads
           and k >= MIN_SLOTS * 2 * p):
        p *= 2
    g = min(p, max_lanes)
    return g, p // g


@functools.lru_cache(maxsize=None)
def _limits(index: int) -> tuple:
    from .. import _build
    props = torch.cuda.get_device_properties(index)
    lib = _build.lib()
    return (props.multi_processor_count
            * props.max_threads_per_multi_processor,
            lib.split_max_lanes(), lib.split_max_cluster())


def limits(device) -> tuple:
    """(resident threads, max lanes, max cluster) of a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no split-row kernel for device {device}")
    return _limits(torch.cuda.current_device() if device.index is None
                   else device.index)


def launch_shape(n_rows: int, k: int, device) -> tuple:
    """``choose``'s (G, S) on the given CUDA device."""
    return choose(n_rows, k, *limits(device))
