"""device_peak_gib: torch.cuda.max_memory_reserved() over the window,
after a reset just before it, on the fullest card the run used (the
harness's own, or a rank's on its card: ``harness.merge_cards``), in
GiB: what that card holds, CUDA graph pools included.  Not read off the
card."""


def read(record):
    peak = record["device_peak_bytes"]
    return peak / 2 ** 30 if peak else None
