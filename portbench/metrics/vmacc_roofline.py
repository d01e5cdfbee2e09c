"""Kernels (``csrc/vmacc.cu``): the traced passes' summed bounds of the
vmacc launches over the card time of the ``vmacc_kernel`` launches, in %."""

from portbench import roofline

KERNEL = r"\bvmacc_kernel\b"


def read(run, cell):
    passes = run.facts.get("passes_traced")
    if run.trace is None or not passes:
        return None
    spent = run.trace.device_s(KERNEL)
    bound = passes * roofline.pass_bound_s(cell.config, "vmacc")
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
