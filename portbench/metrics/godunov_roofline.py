"""Share of their roofline that the Godunov kernels 1 and 2 reach in the
traced steps: the sum of each call's least time (roofline.bound_s of its
inputs read once and outputs written once, counted operations, published
peaks) over the sum of their device time (the vt:: kernels velpred and
mk_brick and their tie-epsilon launch absmax_boxes), in %."""

KERNELS = ("velpred_brick_kernel", "mk_brick_kernel", "absmax_boxes")


def read(run):
    t = run.trace
    if t is None or not run.godunov_bound_s:
        return None
    dev = sum(t["kernels"][k][0] for k in KERNELS if k in t["kernels"])
    if dev <= 0.0:
        return None
    return 100.0 * run.godunov_bound_s / dev
