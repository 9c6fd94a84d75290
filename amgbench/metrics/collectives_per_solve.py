"""collectives_per_solve: rank 0's collectives (the tally
``dist.collectives``: halos, all-reduces and all-gathers, counted again at
each replay of a graph that captured them) over the window's solves.
Nothing where the requests do not count them."""


def read(record):
    done = [r["collectives"] for r in record["requests"]
            if r["ok"] and "collectives" in r]
    return sum(done) / len(done) if done else None
