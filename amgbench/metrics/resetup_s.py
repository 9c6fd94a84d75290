"""resetup_s: the window's wall time over the new matrices it carried
through set-up and solve, in s."""


def read(record):
    done = [r for r in record["requests"] if r["ok"]]
    return record["window_s"] / len(done) if done else None
