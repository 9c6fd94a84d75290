"""solve_ms: the window's wall time over the solves it completed, in ms."""


def read(record):
    done = [r for r in record["requests"] if r["ok"]]
    return 1e3 * record["window_s"] / len(done) if done else None
