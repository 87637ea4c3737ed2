"""K11, the select filter sum of fft_pallas's forward."""

from portbench import counts

WRAPPER = "dip_admm_tpu_torch.ops.kernels.filter_sum:filter_sum_sel"
ROLE = "projector"


def work(args, kwargs, out):
    return counts.filter_sum(args, out)
