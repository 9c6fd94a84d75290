"""device_idle_pct: the share of the window in which no pass graph ran,
100 * (1 - sum of the pass graphs' device time / window), in %.  Nothing
where no pass graph was timed."""


def read(record):
    busy = sum(sum(r.get("pass_ms", ())) for r in record["requests"]) / 1e3
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / record["window_s"])
