"""The fused Condat-Vu step (``ops/kernels/cv_step.py``) on the CPU.

``csrc/cv_step.cu`` runs only on the card, so its arithmetic is held here
through mirrors: plain torch that computes each kernel's per-pixel
expressions in the kernel's order, with its operands (a zero where the
stencil leaves the image, the clamps that keep a NaN, 1 / c by a division).
Each mirror must equal the plain step (``step_ref``, the composition the
node solver ran before the kernels) bit for bit, NaN where it is NaN. The
card compares the kernels with the plain step (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s cv_step phase). The wrapper on the CPU is the plain
step and counts nothing. The mirrors run in each dtype the kernels take
(float32, float64, bfloat16: torch rounds each op to the dtype, as the
kernels do) and with pcv's per-pixel ``s`` and ``sig``; the operands the
card path reads, and what it refuses, are checked on their own."""

import pytest
import torch

from dip_admm_tpu_torch.core import node_solver
from dip_admm_tpu_torch.ops.kernels import cv_step
from dip_admm_tpu_torch.utils import profiling


def mirror_grad(adj, x, D, bc, ux, uy, rho):
    """dip_cv_grad's pixel: (adj + rho (D x - bc)) + (((ux[i-1, j] -
    ux[i, j]) + uy[i, j-1]) - uy[i, j]), each stencil term 0.f where the
    kernel's bounds test gives it; images [P, N, N]."""
    N = ux.shape[-1]
    i = torch.arange(N)[:, None]
    j = torch.arange(N)[None, :]
    up = torch.roll(ux, 1, dims=-2)  # ux[i-1, j]; row 0 is masked
    left = torch.roll(uy, 1, dims=-1)  # uy[i, j-1]; column 0 is masked
    ta = torch.where(i > 0, up, 0.0)
    tb = torch.where(i < N - 1, ux, 0.0)
    tc = torch.where(j > 0, left, 0.0)
    te = torch.where(j < N - 1, uy, 0.0)
    ktu = ((ta - tb) + tc) - te
    return (adj + rho * (D * x - bc)) + ktu


def _clamp_min(v, lo):
    return torch.where(torch.isnan(v), v, torch.maximum(v, lo))


def mirror_update(x, y, ux, uy, s, sig, lam):
    """dip_cv_update's pixel: x+ = x - s y, xb = 2 x+ - x (and at [i+1, j]
    and [i, j+1], 0.f past the image), u + sig g, then the projection
    factor where(r > 0, 1 / clamp(|.| / clamp(r, 1e-30), 1), 0); images
    [P, N, N], the scalars [P, 1, 1] or (s, sig) [P, N, N], all in one
    dtype."""
    N, dtype = ux.shape[-1], ux.dtype
    i = torch.arange(N)[:, None]
    j = torch.arange(N)[None, :]
    xn = x - s * y
    xb = 2.0 * xn - x
    gx = torch.where(i < N - 1, torch.roll(xb, -1, dims=-2) - xb, 0.0)
    gy = torch.where(j < N - 1, torch.roll(xb, -1, dims=-1) - xb, 0.0)
    pu = ux + sig * gx
    pq = uy + sig * gy
    mag = torch.sqrt(pu * pu + pq * pq)
    one = torch.ones((), dtype=dtype)
    safe = _clamp_min(lam, torch.tensor(1e-30, dtype=dtype))
    c = _clamp_min(mag / safe, one)
    f = torch.where(lam > 0, torch.div(one, c), 0.0)
    return xn, pu * f, pq * f


def _mirror_step(x, ux, uy, adj, D, bc, rho, precond, s, sig, lam):
    """Both mirrors around ``precond``, the scalars as the kernels read
    them (in the fields' dtype, one a node or one a pixel)."""
    P, N, dtype = ux.shape[0], ux.shape[-1], ux.dtype

    def col(v):
        v = torch.as_tensor(v, dtype=dtype)
        if v.numel() == P * N * N:
            return v.reshape(P, N, N)
        return v.reshape(-1, 1, 1).expand(P, 1, 1)

    im = lambda t: t.reshape(P, N, N)  # noqa: E731
    d = mirror_grad(im(adj), im(x), im(D), im(bc), ux, uy, col(rho))
    y = precond(d.reshape(P, -1))
    xn, uxn, uyn = mirror_update(im(x), im(y), ux, uy, col(s), col(sig),
                                 col(lam))
    return xn.reshape(P, -1), uxn, uyn


_INT = {torch.float32: torch.int32, torch.float64: torch.int64,
        torch.bfloat16: torch.int16}


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    i = _INT[a.dtype]
    assert torch.equal(a[~nan].view(i), b[~nan].view(i))


def _inputs(P, N, scalars, algo, zero_radius=False, nan=None, seed=0,
            dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed + 31 * N + P)
    r = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    n = N * N
    x, adj, bc = r(P, n), r(P, n), r(P, n)
    D = torch.rand((P, n), generator=gen) * 2.0
    # duals near the ball's edge, so the projection clips some pixels
    ux, uy = 0.02 * r(P, N, N), 0.02 * r(P, N, N)
    rho = torch.rand((P,), generator=gen) + 1.0
    s = torch.rand((P,), generator=gen) * 0.3 + 0.01
    sig = torch.rand((P,), generator=gen) * 0.5 + 0.1
    lam = torch.rand((P,), generator=gen) * 0.02 + 0.01
    if zero_radius:
        lam[0] = 0.0
    if algo == "fcv":
        m_hat = torch.rand((P, N, N // 2 + 1), generator=gen) + 0.5
        precond = lambda d: node_solver._m_inv(m_hat, d, N)  # noqa: E731
    else:
        precond = lambda d: d  # noqa: E731
    if nan == "x":
        x[0, N + 2] = float("nan")
    elif nan == "ux":
        ux[-1, N // 2, 3] = float("nan")
    elif nan == "y":
        inner = precond
        precond = lambda d: inner(d).index_put_(  # noqa: E731
            (torch.tensor([0]), torch.tensor([2 * N + 5])),
            torch.tensor(float("nan")))
    if scalars == "host":
        rho, s, sig, lam = (float(v[0]) for v in (rho, s, sig, lam))
    elif scalars == "device0d":
        rho, s, sig, lam = (v[0].clone() for v in (rho, s, sig, lam))
    elif scalars == "per_pixel":  # pcv's T [P, n] and sigma [P, N, N]
        rho, lam = rho[:, None], lam[:, None, None]
        s = torch.rand((P, n), generator=gen) * 0.3 + 0.01
        sig = torch.rand((P, N, N), generator=gen) * 0.5 + 0.1
    else:  # per node, in the shapes the node solver passes
        rho, s, sig, lam = rho[:, None], s[:, None], sig[:, None, None], \
            lam[:, None, None]
    a = dict(x=x, ux=ux, uy=uy, adj_out=adj, D_vec=D, b_cons=bc, rho=rho,
             precond=precond, s=s, sig=sig, lam=lam)
    return {k: v.to(dtype) if isinstance(v, torch.Tensor) else v
            for k, v in a.items()}


def _args(a):
    return (a["x"], a["ux"], a["uy"], a["adj_out"], a["D_vec"], a["b_cons"],
            a["rho"], a["precond"], a["s"], a["sig"], a["lam"])


@pytest.mark.parametrize("nan", [None, "x", "y", "ux"])
@pytest.mark.parametrize("scalars", ["host", "device0d", "per_node",
                                     "per_pixel"])
@pytest.mark.parametrize("algo", ["cv", "fcv"])
@pytest.mark.parametrize("N", [31, 32])
@pytest.mark.parametrize("P", [1, 3])
def test_mirror_equals_the_plain_step(P, N, algo, scalars, nan):
    a = _inputs(P, N, scalars, algo, nan=nan)
    plain = cv_step.step_ref(*_args(a))
    mirrored = _mirror_step(*_args(a))
    for got, want in zip(mirrored, plain):
        _same_bits(got, want)
    if nan is not None:  # the NaN reached the step's outputs
        assert any(torch.isnan(t).any() for t in plain)


# bfloat16 has no FFT here, so no fcv; a host scalar in bfloat16 is read on
# the card as the card reads it (tests/test_torch_cuda.py).
@pytest.mark.parametrize("dtype,algo,scalars", [
    (torch.float64, algo, scalars)
    for algo in ("cv", "fcv")
    for scalars in ("host", "device0d", "per_node", "per_pixel")
] + [(torch.bfloat16, "cv", scalars)
     for scalars in ("device0d", "per_node", "per_pixel")])
@pytest.mark.parametrize("N", [31, 32])
def test_mirror_in_every_dtype(N, dtype, algo, scalars):
    a = _inputs(3, N, scalars, algo, dtype=dtype, zero_radius=True)
    plain = cv_step.step_ref(*_args(a))
    assert all(t.dtype == dtype for t in plain)
    for got, want in zip(_mirror_step(*_args(a)), plain):
        _same_bits(got, want)


@pytest.mark.parametrize("scalars", ["host", "device0d", "per_node"])
@pytest.mark.parametrize("algo", ["cv", "fcv"])
def test_mirror_at_radius_zero(algo, scalars):
    a = _inputs(3, 32, scalars, algo, zero_radius=True)
    plain = cv_step.step_ref(*_args(a))
    for got, want in zip(_mirror_step(*_args(a)), plain):
        _same_bits(got, want)
    # radius 0 projects node 0's duals to zero
    assert not plain[1][0].any() and not plain[2][0].any()
    if scalars == "per_node":  # the other nodes keep theirs
        assert plain[1][1:].any()


def test_the_stencil_reads_its_neighbours():
    """The mirror's masks hold the stencil at the image's edges: ones
    everywhere give K^T u's corner, edge and inner values."""
    P, N = 1, 5
    z = torch.zeros((P, N, N))
    ktu = mirror_grad(z, z, z, z, torch.ones((P, N, N)),
                      torch.ones((P, N, N)), 0.0)[0]
    plain = node_solver.tv.grad_adjoint(torch.ones((P, N, N)),
                                        torch.ones((P, N, N)))[0]
    _same_bits(ktu, plain)
    assert ktu[0, 0] == -2.0 and ktu[N - 1, N - 1] == 2.0
    assert ktu[2, 2] == 0.0


@pytest.mark.parametrize("scalars", ["host", "per_node"])
@pytest.mark.parametrize("algo", ["cv", "fcv"])
def test_the_cpu_wrapper_is_the_plain_step_and_counts_nothing(algo, scalars):
    a = _inputs(3, 32, scalars, algo)
    cv_step.reset_launch_counts()
    with profiling.recording() as rec:
        got = cv_step.step(*_args(a))
    for g, w in zip(got, cv_step.step_ref(*_args(a))):
        _same_bits(g, w)
    assert cv_step.launch_counts() == {"cv_step": 0}
    assert "node.fused_steps" not in rec.counts
    # the plain step copies a host radius, as it always has
    assert rec.counts.get("sync", 0) == (1 if scalars == "host" else 0)


def _fields(a, dtype=torch.float32):
    return tuple(a[k].to(dtype) for k in ("x", "ux", "uy", "adj_out", "D_vec",
                                           "b_cons"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("scalars", ["host", "device0d", "per_node",
                                     "per_pixel"])
def test_the_kernels_operands(scalars, dtype):
    """rho, s, sig and lam as the card path hands them to the kernels:
    host values as they are (the radius in the fields' dtype; a 0-d CPU
    tensor is one), tensors in the fields' dtype, flat, with their
    stride."""
    P, N = 3, 32
    a = _inputs(P, N, scalars, "cv", dtype=dtype)
    x = a["x"]
    assert cv_step._check_step(*_fields(a, dtype)) == (
        P, N, cv_step.DTYPES[dtype])
    ops = {k: cv_step._operand(k, a[k], x, k in ("s", "sig"))
           for k in ("rho", "s", "sig", "lam")}
    want = {"host": [0] * 4, "device0d": [0] * 4, "per_node": [1] * 4,
            "per_pixel": [1, 2, 2, 1]}[scalars]
    assert [ops[k][2] for k in ("rho", "s", "sig", "lam")] == want
    for k, (t, v, _) in ops.items():
        if scalars in ("host", "device0d"):  # 0-d tensors here: the CPU's
            assert t is None
            want_v = float(a[k])
            if k == "lam" and dtype == torch.bfloat16:
                want_v = torch.tensor(want_v, dtype=dtype).item()
            assert v == want_v
        else:
            assert t.dtype == dtype and t.is_contiguous() and t.dim() == 1
            assert torch.equal(t, a[k].reshape(-1))


def test_a_cpu_scalar_tensor_is_a_host_value():
    x = torch.zeros((2, 16), dtype=torch.bfloat16)
    t, v, stride = cv_step._operand("rho", torch.tensor(0.3,
                                    dtype=torch.float64), x, False)
    assert t is None and stride == 0 and v == 0.3
    # the radius goes in the fields' dtype, as project_l2_ball casts it
    t, v, _ = cv_step._operand("lam", torch.tensor(0.3), x, False)
    assert t is None and v == torch.tensor(0.3, dtype=torch.bfloat16).item()


@pytest.mark.parametrize("case", ["float16", "wider_field", "narrower_dual",
                                  "pixel_rho", "pixel_lam", "wide_s",
                                  "s_float64", "sig_float64"])
def test_the_card_path_refuses_what_it_cannot_mirror(case):
    """Another dtype, a field wider than the state (which would promote the
    plain step's result), duals in another dtype than x, a per-pixel rho or
    radius, an operand of no node shape, or a wider operand with
    dimensions raise."""
    P, N = 3, 32
    a = _inputs(P, N, "per_node", "cv")
    fields = list(_fields(a))
    x = fields[0]
    with pytest.raises(ValueError, match="cv_step"):
        if case == "float16":
            cv_step._check_step(*_fields(a, torch.float16))
        elif case == "wider_field":
            fields[3] = fields[3].double()
            cv_step._check_step(*fields)
        elif case == "narrower_dual":
            fields[1] = fields[1].bfloat16()
            cv_step._check_step(*fields)
        elif case == "pixel_rho":
            cv_step._operand("rho", torch.rand((P, N * N)), x, False)
        elif case == "pixel_lam":
            cv_step._operand("lam", torch.rand((P, N, N)), x, False)
        elif case == "wide_s":
            cv_step._operand("s", torch.rand((P, 2)), x, True)
        elif case == "s_float64":
            cv_step._operand("s", a["s"].double(), x, True)
        else:
            cv_step._operand("sig", a["sig"].double(), x, True)


def test_a_radius_in_another_dtype_is_cast():
    """``tv.project_l2_ball`` casts the radius to the fields' dtype, so the
    card path does too, where another operand would be refused."""
    a = _inputs(3, 32, "per_node", "cv")
    t, _, stride = cv_step._operand("lam", a["lam"].double(), a["x"], False)
    assert stride == 1 and t.dtype == torch.float32
    assert torch.equal(t, a["lam"].reshape(-1))


@pytest.mark.parametrize("scalars", ["device0d", "per_node", "per_pixel"])
def test_a_narrower_input_is_widened(scalars):
    """adj_out, D_vec, b_cons and the operands in bfloat16 beside a float32
    state: the plain step widens each exactly where it first meets a
    float32 tensor, so the mirror of the float32 step on the widened values
    gives its bits, and the card path takes them (widened by ``.to``)."""
    P, N = 3, 32
    a = _inputs(P, N, scalars, "cv")
    mixed = dict(a)
    for k in ("adj_out", "D_vec", "b_cons", "rho", "s", "sig"):
        mixed[k] = a[k].to(torch.bfloat16)
    widened = {k: v.float() if isinstance(v, torch.Tensor) else v
               for k, v in mixed.items()}
    plain = cv_step.step_ref(*_args(mixed))
    assert all(t.dtype == torch.float32 for t in plain)
    for got, want in zip(_mirror_step(*_args(widened)), plain):
        _same_bits(got, want)
    fields = [mixed[k] for k in ("x", "ux", "uy", "adj_out", "D_vec",
                                 "b_cons")]
    assert cv_step._check_step(*fields) == (P, N, 0)
    for k in ("rho", "s", "sig"):
        t, _, _ = cv_step._operand(k, mixed[k], a["x"], k != "rho")
        if t is not None:
            assert t.dtype == torch.float32
            assert torch.equal(t, widened[k].reshape(-1))
