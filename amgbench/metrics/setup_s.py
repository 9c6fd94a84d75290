"""setup_s: seconds from the start of the process's harness to the
window: imports, the problem's generation (or its cache), the port's
set-up and warm-up, the traffic's inputs and priming."""


def read(record):
    return record["setup_s"]
