"""K1, the skew row stage of fft_skew's forward."""

from portbench import counts

WRAPPER = "dip_admm_tpu_torch.ops.kernels.shear_sum:skew_sum_planes"
ROLE = "projector"


def work(args, kwargs, out):
    return counts.skew(args, out, fwd=True)
