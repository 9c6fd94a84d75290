"""Launch shape of the split-row kernels (``csrc/split_rows.cuh``), shared by
``ell_spmv`` and ``block_ell_spmv``, and the lanes per row of the sliced
ELL layout.

A row of K slots is split over P = G * S threads: G lanes of a block and
S blocks of a thread-block cluster.  ``choose`` is the plain rule;
``launch_shape`` applies it with the limits of the card a tensor lies on:
its resident threads (SMs x threads per SM, from the device properties)
and the kernels' lane and cluster limits (from the kernel library).

``choose_lanes`` picks, when an ELL operator is packed, the T lanes that
share each row of a slice, the V slots a lane loads at once and the
window of rows sorted by length.  ``choose_block`` picks the block-ELL
kernel's launch: dof rows (one thread a row, or split over lanes and
cluster blocks) or node groups (W node rows a thread, T lanes a
group).
"""
from __future__ import annotations

import functools

import torch

MIN_SLOTS = 8     # slots a thread keeps at least
# an H100 SXM: 132 SMs of 2,048 resident threads, and the split-row
# kernels' 32 lanes and 8 cluster blocks at most (csrc/split_rows.cuh)
H100_LIMITS = (132 * 2048, 32, 8)
LANE_SLOTS = 16   # mean slots of a row per lane (at least) before T doubles
SHORT_ROW = 8     # rows of fewer mean slots sort in wide windows


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


def choose_lanes(n_rows: int, k: int, mean_len: float,
                 limits: tuple = H100_LIMITS) -> tuple:
    """(T, V, sigma) of the sliced ELL layout for rows of mean length
    `mean_len` and longest row k: T lanes per row, V slots per load,
    rows sorted by length within windows of sigma rows.

    Rows that ``choose`` splits over lanes and clusters on an H100
    (`limits`) take (1, 1, 1): the split-row kernel reads slices of 32
    rows and stops each row at its own length, so sorting would save no
    reads; rows in their own order keep its gathers and stores local and
    need no perm.  Otherwise T doubles, up to 32, while each lane keeps 2 *
    LANE_SLOTS slots of a mean row; V = 4 (16-byte column loads) when each
    lane keeps LANE_SLOTS, else 1; sigma = 256 / T (the rows of eight
    slices), or 4096 for rows of under SHORT_ROW slots, whose gathers are
    few and whose stored padding the wider window cuts by a few percent
    (scripts/torch_split_sweep.py --sweep on an H100, PERF.md)."""
    if choose(n_rows, k, *limits) != (1, 1):
        return 1, 1, 1
    t = 1
    while t < 32 and mean_len >= 2 * LANE_SLOTS * t:
        t *= 2
    v = 4 if mean_len >= LANE_SLOTS * t else 1
    sigma = 4096 if t == 1 and mean_len < SHORT_ROW else 256 // t
    return t, v, sigma


@functools.lru_cache(maxsize=None)
def _limits(index: int) -> tuple:
    from .. import _build
    props = torch.cuda.get_device_properties(index)
    lib = _build.lib()
    return (props.multi_processor_count
            * props.max_threads_per_multi_processor,
            lib.split_max_lanes(), lib.split_max_cluster())


def _index(device) -> int:
    """The index of a CUDA device (the current one for "cuda")."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no split-row or block kernel for device {device}")
    return torch.cuda.current_device() if device.index is None \
        else device.index


def limits(device) -> tuple:
    """(resident threads, max lanes, max cluster) of a CUDA device."""
    return _limits(_index(device))


def launch_shape(n_rows: int, k: int, device) -> tuple:
    """``choose``'s (G, S) on the given CUDA device."""
    return choose(n_rows, k, *limits(device))


BLOCK_HEAD = 16     # node slots the block kernel sums without lens
                    # (kHead, csrc/block_ell_spmv.cu)
BLOCK_WIDE = 16     # bytes of values a node-group thread loads at once
GROUP_SLOTS = 4     # node slots a node-group lane keeps at least


def choose_block(nb: int, bs: int, k: int, val_bytes: int,
                 limits: tuple = H100_LIMITS) -> tuple:
    """(W, T, G, S) of the block-ELL kernel for nb node rows of bs dofs
    and K = k node slots, values of `val_bytes`, on a card of `limits`
    (resident threads, max lanes, max cluster blocks).

    Dof rows that leave most of the card idle (under a quarter of its
    resident threads) are split: P = G * S doubles, lanes first, while
    the split rows still fit the resident threads and P < K, short rows
    included, so that a row is a few dependent loads deep.  Rows that
    fill more of the card take no split (its shared-memory reduction
    costs more than it saves there): one thread per dof row where rows
    hold at most BLOCK_HEAD slots, else node groups of W = BLOCK_WIDE /
    val_bytes nodes a thread (16-byte value loads), T lanes doubling
    while the groups' lanes fit the resident threads and each lane keeps
    GROUP_SLOTS slots (scripts/torch_split_sweep.py --sweep on the block
    cases on an H100, PERF.md)."""
    resident, max_lanes, max_cluster = limits
    rows = nb * bs
    if 4 * rows < resident:
        p = 1
        while (p < max_lanes * max_cluster and rows * 2 * p <= resident
               and p < k):
            p *= 2
        g = min(p, max_lanes)
        return 1, 1, g, p // g
    if k <= BLOCK_HEAD:
        return 1, 1, 1, 1
    w = BLOCK_WIDE // val_bytes
    groups = -(-nb // w)
    t = 1
    while (t < 32 and groups * 2 * t <= resident
           and k >= GROUP_SLOTS * 2 * t):
        t *= 2
    return w, t, 1, 1


@functools.lru_cache(maxsize=None)
def _block_shape(nb: int, bs: int, k: int, val_bytes: int,
                 index: int) -> tuple:
    return choose_block(nb, bs, k, val_bytes, _limits(index))


def block_launch_shape(nb: int, bs: int, k: int, val_bytes: int,
                       device) -> tuple:
    """``choose_block``'s (W, T, G, S) on the given CUDA device (cached;
    no host sync)."""
    return _block_shape(nb, bs, k, val_bytes, _index(device))
