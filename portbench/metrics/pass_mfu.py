"""The whole pass: its operations at their dtypes' peaks (``roofline.py``)
over the traced window's length a pass, in %. The operations come from the
op list's shapes, whatever kernels run them, so this bounds what any one
kernel's roofline can claim for the pass."""

from portbench import roofline


def read(run, cell):
    passes = run.facts.get("passes_traced")
    if run.trace is None or not passes or run.trace.window_s <= 0:
        return None
    return 100.0 * passes * roofline.pass_compute_s(cell.config) \
        / run.trace.window_s
