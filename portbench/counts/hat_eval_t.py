"""K18, the transpose of K17."""

from portbench import counts

WRAPPER = "dip_admm_tpu_torch.ops.kernels.hat_eval:hat_eval_t"
ROLE = "projector"


def work(args, kwargs, out):
    return counts.hat(args, out, fwd=False)
