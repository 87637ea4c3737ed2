"""K3, the factored eval tail of fft_skew's and fft_shear's forward."""

from portbench import counts

WRAPPER = "dip_admm_tpu_torch.ops.kernels.shear_sum:eval_shear"
ROLE = "projector"


def work(args, kwargs, out):
    return counts.eval_tail(args, out, args[2])
