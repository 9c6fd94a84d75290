"""warm_s: the benchmark's span around warm() (graph capture and first
launches), mean over the window's requests, in s.  Nothing in a cell
whose requests do not set up a matrix."""


def read(record):
    spans = [r["spans"]["warm"] for r in record["requests"]
             if r["ok"] and "warm" in r.get("spans", {})]
    return sum(spans) / len(spans) if spans else None
