"""Phase timers and op benchmarking (the port of
``sparsh_amg_tpu/utils/timing.py``): wall-clock per phase, and the median
time of one op, between CUDA events on the card or by ``perf_counter``
with a synchronize elsewhere.  The JAX package's dispatch round-trip probe
and ``resolve_loop_mode`` are left out: they choose between relay loop
modes the port does not have."""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class Timer:
    """Accumulating named phase timer."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return "\n".join(
            f"{k:>24s}: {v:9.4f}s  (x{self.counts[k]})"
            for k, v in sorted(self.times.items()))


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
