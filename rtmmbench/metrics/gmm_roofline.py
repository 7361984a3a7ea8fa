"""kernels: the experts' grouped matmul against its roofline over the traced
run: the served calls' summed bound (``counts.kernel_bound_s``: per launch the
larger of its operations at 989 TFLOP/s and its bytes at 3.35 TB/s) over
the device time of the kernels named here, by the profiler's names, in %."""

KERNELS = ("gmm_wgmma_kernel", "gmm_sum_splits_kernel",
           "gmm_f32_kernel")


def read(run):
    if run.timeline is None:
        return None
    spent = run.timeline.kernel_s(KERNELS)
    bound = run.kernel_bound_s("gmm")
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
