"""freeze_s: the benchmark's span around AMGSolver(...) (the freeze and
upload), mean over the window's requests, in s.  Nothing in a cell
whose requests do not set up a matrix."""


def read(record):
    spans = [r["spans"]["freeze"] for r in record["requests"]
             if r["ok"] and "freeze" in r.get("spans", {})]
    return sum(spans) / len(spans) if spans else None
