"""Dispatch: the share of a pass's launches, weighted by count, whose
schedule ``dispatch.kernel_params`` resolved as "tuned", in %."""


def read(run, cell):
    provenance = run.facts.get("provenance")
    if not provenance:
        return None
    total = sum(count for count, _ in provenance)
    tuned = sum(count for count, prov in provenance if prov == "tuned")
    return 100.0 * tuned / total
