"""Device: the share of the traced window in which nothing ran on the card,
in %."""


def read(run, cell):
    idle = run.trace.idle_share() if run.trace is not None else None
    return None if idle is None else 100.0 * idle
