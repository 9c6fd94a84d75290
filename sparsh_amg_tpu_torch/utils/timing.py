"""Op benchmarking (the port of ``sparsh_amg_tpu/utils/timing.py``): the
median time of one op, between CUDA events on the card or by ``perf_counter``
with a synchronize elsewhere.

The device-time harness of ``chip_smoke.py``, ``kernel_bench_torch.py``
and ``scripts/torch_dia_sweep.py`` lives here too: ``timed_ms`` (launches
queued behind a device sleep, so CUDA events see device time alone),
``graph_ms`` (launches back to back in one CUDA graph replay),
``l2_flush_buffer`` and the measured copy rate ``copy_bandwidth``.  This
module imports nothing of the package, so a script can load it by path
from one checkout while it times another.
"""
from __future__ import annotations

import statistics
import time

import torch

TIMED_RUNS = 25
GRAPH_LAUNCHES = 20         # launches captured in graph_ms's graph
SLEEP_CYCLES = 50_000_000   # ~30 ms of device sleep ahead of timed runs


def l2_flush_buffer(nbytes):
    """A buffer of twice the card's L2 when `nbytes` of operands would fit
    in L2 (so repeated launches would find them there), else None."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    if nbytes >= l2:
        return None
    return torch.ones(2 * l2 // 4, device="cuda")


def timed_ms(fn, queued=True, flush=None, runs=TIMED_RUNS):
    """Median of `runs` launches, each between two CUDA events.  With
    `queued`, the runs wait behind a device sleep until the host has
    queued them all, so the events see device time alone (keep runs x
    the host's time to launch fn() under the ~30 ms sleep); without it,
    each run is timed as the host launches it, Python and launch overhead
    included (the floor of a small kernel inside the solve).  `flush`: a
    buffer read (outside the events) before every run, which evicts the
    previous run's operands from L2."""
    fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    events = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.sum()
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in events)


def graph_ms(fn, launches=GRAPH_LAUNCHES, runs=TIMED_RUNS):
    """Device ms per launch of fn() replayed from a CUDA graph: `launches`
    calls captured in one graph, each replay timed between two CUDA
    events and divided by `launches`, the median over `runs` replays.
    The launches run back to back, as inside the solver's graphs, so the
    time holds no per-launch event and host gap (operands that fit in L2
    stay there between launches).  fn must be capturable: no host sync,
    its launch state built by a first call."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        samples.append(e0.elapsed_time(e1) / launches)
    del graph
    return statistics.median(samples)


def copy_bandwidth(device, runs: int = 5, reps: int = 10) -> float:
    """Measured copy rate (bytes/s, read + write) of ``y = x * a`` on the
    card: `reps` products between two CUDA events, the median over `runs`.
    x and y are each 8x the card's L2, so L2 cannot hold them and the
    rate is the device memory's."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("copy_bandwidth measures a CUDA device")
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    n = 8 * l2 // 4
    x = torch.ones(n, device=device)
    y = torch.empty_like(x)
    torch.mul(x, 1.0000001, out=y)
    torch.cuda.synchronize(device)
    samples = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            torch.mul(x, 1.0000001, out=y)
        e1.record()
        e1.synchronize()
        samples.append(e0.elapsed_time(e1) / 1e3 / reps)
    del x, y
    return 2 * n * 4 / statistics.median(samples)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def benchmark_op(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median seconds of fn(*args): between two CUDA events when fn returns
    a tensor on the card, else wall-clock with a synchronize."""
    for _ in range(warmup):
        out = fn(*args)
    cuda = [t.device for t in _tensors(out) if t.device.type == "cuda"]
    samples = []
    if cuda:
        torch.cuda.synchronize(cuda[0])
        for _ in range(iters):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(*args)
            e1.record()
            e1.synchronize()
            samples.append(e0.elapsed_time(e1) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


def speed_of_light_spmv_nnz_per_s(hbm_bw_bytes: float,
                                  bytes_per_nnz: float = 12.0) -> float:
    """Upper bound on SpMV nnz/s: memory bandwidth / bytes moved per nonzero
    (fp32 value + int32 column + amortized x/y traffic; DIA layouts drop the
    column index and approach 6-8 B/nnz)."""
    return hbm_bw_bytes / bytes_per_nnz
