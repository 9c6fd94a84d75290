"""solve_roofline_pct: the least time the data-sheet memory rate of the
cards the run used, summed over them (``harness.device_of``), allows for
the bytes the window's solves need (``amgbench/work.py``: the
iterations and passes each solve reports, priced on the host
hierarchy's CSR matrices), over the pass graphs' device time (CUDA events
around each launch), in %.  Nothing where no pass graph was timed or a
card has no data-sheet rate."""


def read(record):
    work, peak = record["work"], record["peak_bytes_per_s"]
    done = [r for r in record["requests"] if r["ok"]]
    device_s = sum(sum(r["pass_ms"]) for r in done) / 1e3
    if not work or not peak or device_s <= 0:
        return None
    need = sum(r["iterations"] * work["iteration"]
               + r["passes"] * work["pass"] for r in done)
    return 100.0 * need / peak / device_s
