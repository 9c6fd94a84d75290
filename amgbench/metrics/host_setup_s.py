"""host_setup_s: the benchmark's span around maybe_reorder and amg_setup
(the host set-up: setup/, _native/), mean over the window's requests,
in s.  Nothing in a cell whose requests do not set up a matrix."""


def read(record):
    spans = [r["spans"]["host_setup"] for r in record["requests"]
             if r["ok"] and "host_setup" in r.get("spans", {})]
    return sum(spans) / len(spans) if spans else None
