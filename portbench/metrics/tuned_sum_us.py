"""Search: the set-up session's tuned latency, the sum over the network's
distinct ops of count x the best latency the runner measured (the paper's
Fig. 7 sum; ``SessionResult.tuned_latency``), in us. A measurement of
the program's own: ``CudaRunner`` times each candidate with ``CardTimer``
(``core/runner.py``), so a change to ``CardTimer`` moves this reading."""


def read(run, cell):
    session = run.facts.get("session")
    if session is None or not session.reports:
        return None
    return session.tuned_latency * 1e6
