"""K4, the transpose of K3."""

from portbench import counts

WRAPPER = "dip_admm_tpu_torch.ops.kernels.shear_sum:eval_shear_t"
ROLE = "projector"


def work(args, kwargs, out):
    return counts.eval_tail(args, out, args[1])
