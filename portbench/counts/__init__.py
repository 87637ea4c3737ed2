"""Each kernel's work, one file a kernel wrapper of the program: the bytes
it must move (each input read once, each output written once) and the
operations its function needs, in float32 and in bfloat16, at the shapes
of one call. A file names the wrapper it counts (``WRAPPER``,
"module:function"; a name the program does not have is an error), the
layer it belongs to (``ROLE``) and gives
``work(args, kwargs, out) -> (bytes, f32_ops, bf16_ops)``. A tap product
counts the nonzero taps of its table, not the dense contraction."""


def nnz_taps(W, PB: int) -> int:
    """Nonzero taps that PB images read from the tap table ``W`` [PT,
    ...]: image p reads table set p % PT."""
    import torch

    return (PB // W.shape[0]) * int(torch.count_nonzero(W))


def skew(args, out, fwd: bool):
    """K1 and K2: the skew row stage and its transpose."""
    from portbench.roofline import nbytes

    W = args[1] if fwd else args[2]  # WtT [PT, NB, D2, Tp, nb]
    PB = args[0].shape[0]
    _, NB, _, Tp, nb = W.shape
    WZ = args[4].shape[0] if fwd else args[5].shape[1]
    F = args[2 if fwd else 3].shape[-1]
    WS = (args[0] if fwd else out[0]).shape[-1]  # the row width
    taps = 2 * nnz_taps(W, PB) * WS
    dft = 4 * PB * NB * Tp * WZ * F
    lowp = W.dtype != args[0].dtype
    f32 = 8 * PB * NB * Tp * F + (0 if lowp else taps + dft)
    bf16 = taps + dft if lowp else 0
    return nbytes(args) + nbytes(out), f32, bf16


def eval_tail(args, out, Wd):
    """K3 and K4: the factored eval tail and its transpose."""
    from portbench.roofline import nbytes

    PB = args[0].shape[0]
    _, DB, Tp, D2p, _ = Wd.shape
    F = args[-3].shape[-1]
    mm = 4 * PB * DB * Tp * F * D2p
    lowp = Wd.dtype != args[0].dtype
    f32 = 8 * PB * DB * Tp * F + 2 * nnz_taps(Wd, PB) + (0 if lowp else mm)
    return nbytes(args) + nbytes(out), f32, mm if lowp else 0



def filter_sum(args, out):
    """K11 and K12: the filter sums over the phase table H [PT, T, N, F]."""
    from portbench.roofline import nbytes

    PB = args[0].shape[0]
    _, T, N, F = args[2].shape
    return nbytes(args) + nbytes(out), 8 * PB * T * N * F, 0



def hat(args, out, fwd: bool):
    """K17/K18: the hat evaluation and its transpose; K17 reads only the
    profile taps this call's coordinates touch."""
    import torch

    from portbench.roofline import nbytes

    pc = args[1]
    PB, PT = args[0].shape[0], pc.shape[0]
    n = nbytes([a for a in args if hasattr(a, "numel")]) + nbytes(out)
    if fwd:
        g = args[0]
        Np = g.shape[-1]
        v0 = torch.floor(pc).long()
        hit = torch.zeros((PT, pc.shape[1], Np + 3), dtype=torch.bool,
                          device=pc.device)
        for k in (0, 1):
            hit.scatter_(2, (v0 + k + 1).clamp(0, Np + 2), True)
        taps = int(hit[..., 1:Np + 1].sum())
        n += (PB // PT) * taps * 4 - nbytes(g)
    return n, 13 * PB * pc[0].numel(), 0
