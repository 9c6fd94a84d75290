"""solve_p95_ms: the 95th percentile of every request's wall time in the
window (a solve() call to its return; a solve that raised counts with
the time it took), in ms; linear interpolation between order
statistics."""
import numpy as np


def read(record):
    walls = [r["wall_s"] for r in record["requests"]]
    return 1e3 * float(np.percentile(walls, 95)) if walls else None
