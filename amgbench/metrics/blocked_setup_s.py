"""blocked_setup_s: the slowest rank's blocked setup, the span
``setup.blocked`` around ``blocked_amg_setup`` in
``DistAMGSolver.from_blocked`` (its rows' coarsening with boundary
exchanges and the gathered tail's setup), in s.  Nothing in a cell whose
ranks do not run the process-local setup."""


def read(record):
    return record["setup_spans"].get("rank.blocked")
