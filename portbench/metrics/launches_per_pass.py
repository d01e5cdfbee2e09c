"""Wrappers: operations on the card in one traced pass (kernels, copies,
memsets), against the op list's launches a pass."""


def read(run, cell):
    passes = run.facts.get("passes_traced")
    if run.trace is None or not passes or not run.trace.device:
        return None
    return len(run.trace.operations()) / passes
