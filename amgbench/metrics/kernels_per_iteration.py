"""kernels_per_iteration: the kernels the window's pass graphs ran (the
port's tally ``graph.kernels``: each captured graph's kernel nodes a
replay, a pass graph's step once per iteration) over the Krylov
iterations of the same solves.  Nothing where no request counts them."""


def read(record):
    done = [r for r in record["requests"]
            if r["ok"] and "graph.kernels" in r.get("tallies", {})]
    iterations = sum(r["iterations"] for r in done)
    if not iterations:
        return None
    return sum(r["tallies"]["graph.kernels"] for r in done) / iterations
