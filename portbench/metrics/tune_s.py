"""Search: the set-up session's length, in s, as the session times itself
(``SessionResult.wall_time_s``, ``TuningSession.tune_model`` from its start
to its result): the part of ``setup_s`` the tuner takes."""


def read(run, cell):
    session = run.facts.get("session")
    return None if session is None else session.wall_time_s
