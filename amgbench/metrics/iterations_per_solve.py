"""iterations_per_solve: the Krylov iterations of the window's solves
(SolveResult.iterations, every refinement pass's) over the solves."""


def read(record):
    done = [r for r in record["requests"] if r["ok"]]
    return sum(r["iterations"] for r in done) / len(done) if done else None
