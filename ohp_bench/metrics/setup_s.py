"""setup_s: seconds from the start of the run's harness module to the
first timed request (imports, the kernel library from its cache, the
content made from the seed, the warm requests at the cell's shapes)."""


def read(window: dict):
    return window["setup_s"]
