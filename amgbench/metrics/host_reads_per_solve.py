"""host_reads_per_solve: the host's reads of the device over the
window's solves (SolveResult.host_reads; one per pass graph in the
device loop mode) over the solves."""


def read(record):
    done = [r for r in record["requests"] if r["ok"]]
    return sum(r["host_reads"] for r in done) / len(done) if done else None
