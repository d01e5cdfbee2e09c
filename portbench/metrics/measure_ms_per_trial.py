"""Measure: the measuring thread's time on the session's batches
(``SessionResult.measure_time_s``: each batch from its start on the
measuring thread to its end, the span ``measure_scheduler.batch`` around
the runner's ``runner.measure`` spans of ``core/runner.py``: concretize,
build, first run, ``CardTimer``) over the candidates the session
reconciled (the program's counter ``tuner.trials``), in ms. The library
baselines measured after the search are no trials and are left out. Wall
time: it includes the thread's waits for the interpreter lock while the
tuning thread holds it (``portbench/spans.py`` splits it)."""

from portbench import spans


def read(run, cell):
    session = run.facts.get("session")
    trials = spans.trials()
    if session is None or not trials or session.measure_time_s <= 0:
        return None
    return 1e3 * session.measure_time_s / trials
