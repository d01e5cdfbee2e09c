"""Search: the tuning thread's time in the drivers' ``propose`` and
``reconcile`` (sampling, evolution, the cost model's update and refit;
``SessionResult.search_time_s``) over the candidates the session
reconciled (the program's counter ``tuner.trials``), in ms. Wall time: it
includes the thread's waits for the interpreter lock while the measuring
thread holds it."""

from portbench import spans


def read(run, cell):
    session = run.facts.get("session")
    search_s = getattr(session, "search_time_s", None)
    trials = spans.trials()
    if not search_s or not trials:
        return None
    return 1e3 * search_s / trials
