"""K2, the transpose of K1 in fft_skew's adjoint."""

from portbench import counts

WRAPPER = "dip_admm_tpu_torch.ops.kernels.shear_sum:skew_sum_planes_t"
ROLE = "projector"


def work(args, kwargs, out):
    return counts.skew(args, out, fwd=False)
