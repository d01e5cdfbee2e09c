"""Kernels (``csrc/qmatmul.cu``): the share of the traced passes'
``qmm_kernel`` card time that ran in the warp-specialised wgmma loop's
kernels (``wgmma::qmm_kernel<BN>``), in %. None where no ``qmm_kernel``
ran; 0 where every one ran the mma.sync loop."""

KERNEL = r"\bqmm_kernel\b"
WGMMA = r"\bwgmma::qmm_kernel\b"


def read(run, cell):
    if run.trace is None or not run.facts.get("passes_traced"):
        return None
    spent = run.trace.device_s(KERNEL)
    if spent <= 0:
        return None
    return 100.0 * run.trace.device_s(WGMMA) / spent
