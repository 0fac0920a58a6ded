"""Device ms a traced step spends in the smoothers' kernels: kernel 3
(gsrb_var.cu), 4 (nodal.cu), 5 (gsrb_const.cu) and 7 (gsrb_padded.cu;
its fused stages share gsrb3d.cuh's gsrb_fused_kernel with kernel 3)."""

KERNELS = ("gsrb_colour_kernel", "residual_kernel", "restrict_kernel",
           "gsrb_fused_kernel", "nodal_kernel", "nodal_fused_kernel",
           "gsrb_const_colour_kernel", "residual_const_kernel",
           "const_fused_kernel", "padded_colour_kernel")


def read(run):
    t = run.trace
    if t is None:
        return None
    found = [t["kernels"][k][0] for k in KERNELS if k in t["kernels"]]
    if not found:
        return None
    return sum(found) / t["steps"] * 1e3
