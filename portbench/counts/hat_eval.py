"""K17, the on-the-fly hat evaluation of the fft_pallas eval tail."""

from portbench import counts

WRAPPER = "dip_admm_tpu_torch.ops.kernels.hat_eval:hat_eval"
ROLE = "projector"


def work(args, kwargs, out):
    return counts.hat(args, out, fwd=True)
