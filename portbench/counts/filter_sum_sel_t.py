"""K12, the transpose of K11."""

from portbench import counts

WRAPPER = "dip_admm_tpu_torch.ops.kernels.filter_sum:filter_sum_sel_t"
ROLE = "projector"


def work(args, kwargs, out):
    return counts.filter_sum(args, out)
