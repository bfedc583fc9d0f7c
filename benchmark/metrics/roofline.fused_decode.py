"""Kernel H's share of its roofline: the least time its work needs,
``max(bytes / HBM rate, int8 ops / int8 peak + f32 ops / f32 peak)`` for
the traced window's showers (``counts/decode.py fused_decode``), over the
device time of H's launches (its LN, norm-quant and conv kernels, seven a
call) in that window. Nothing to read where no such kernel ran."""

from counts.decode import bound_s, fused_decode

H_KERNELS = ("ln_leaky_rowquant_kernel", "gn_leaky_rowquant_kernel", "conv_mma_kernel")


def read(run):
    if run.trace is None:
        return None
    h_s = run.trace.seconds(lambda n: any(k in n for k in H_KERNELS))
    if h_s <= 0:
        return None
    return 100.0 * bound_s(*fused_decode(run.trace_work))[0] / h_s
