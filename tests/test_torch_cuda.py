"""The port's CUDA kernels on the card, against their plain versions.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU host without them. There, skip ``tests/conftest.py`` (it sets up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test needs a CUDA device and the CUDA toolkit, and skips without
them. Tolerance: 2e-3 of the output's max with bf16 tables (the sums run in
another order, so a bf16 rounding of an intermediate can land on the other
side), 1e-5 with f32 tables and for the consensus kernel K5 (the same
elementwise f32 ops, and its per-pair sums taken in another order), and
1e-5 for the grouped filter-sum kernels K13/K14 with either table type (a
bf16 table is upcast exactly; only the order of the f32 sums differs); two
K5 calls, and two K13/K14 calls, on the same inputs must agree bit for
bit, and K13/K14 on a node slice of the images give the whole batch's
rows bit for bit. The select filter-sum kernels K11/K12 are held to 1e-5
with either table type (a bf16 table is upcast exactly; the sums run in another order,
and the plain forward blends both planes by sel where the kernel reads the
selected one, an f32 rounding per term), and the hat kernels K17/K18 to
1e-5 (f32 throughout, other sum order). The shear kernels K7/K8 are held
to 1e-5 with f32 tables and 2e-3 with bf16 tables (K8 rounds S to bf16
from an f32 value whose last bit may differ), the tiled filter-sums
K15/K16 to 1e-5 with either (products exact, other sum order). K6 (K2's
kernel on one shard's row blocks at the full row width), K9/K10 (K7/K8 on
gathered slot spectra) and K5's sharded form are held to their plain
versions as K2, K7/K8 and K5 are. Two calls of each must agree bit for
bit."""

import pytest
import torch

from dip_admm_tpu_torch.config import GeometryConfig
from dip_admm_tpu_torch.ops import radon, radon_fan, radon_fft
from dip_admm_tpu_torch.ops.kernels import consensus as cons
from dip_admm_tpu_torch.ops.kernels import filter_mxu as fm
from dip_admm_tpu_torch.ops.kernels import filter_sum as fs
from dip_admm_tpu_torch.ops.kernels import hat_eval as he
from dip_admm_tpu_torch.ops.kernels import shear_sum as ss
from dip_admm_tpu_torch.parallel import mesh

pytestmark = pytest.mark.cuda
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tables(dtype, dev, N=48, P=3, angles_total=45, nb=16, det_pixels=None):
    geo = GeometryConfig(N=N, num_nodes=P, angles_total=angles_total,
                         det_pixels=det_pixels)
    a, v, _ = radon.node_angles(geo)
    t = radon_fft.precompute_shear(
        geo, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev), dtype, nb=nb)
    return geo, t


def _cases(t, dev, P=None):
    """Each kernel's (wrapper, plain version, arguments) on the tables ``t``
    with P images (default: one per table set)."""
    sh = t["shared"]
    PT, NB, D2, Tp, nb = t["WtT"].shape
    P = PT if P is None else P
    N, F = NB * nb, t["SEre"].shape[-1]
    D = t["Wd"].shape[1] * t["Wd"].shape[-1]
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.randn((P, N, N), generator=gen, device=dev)
    rows2 = torch.stack([img, img.transpose(1, 2)], dim=1).contiguous()
    g = torch.randn((P, Tp, F), generator=gen, device=dev)
    g2 = torch.randn((P, Tp, F), generator=gen, device=dev)
    ob = torch.randn((P, Tp, D), generator=gen, device=dev)
    return {
        "skew_sum_planes": (ss.skew_sum_planes, ss.skew_sum_planes_ref, (
            rows2, t["WtT"], t["SEre"], t["SEim"], sh["Dre"], sh["Dim"],
            t["plane"])),
        "skew_sum_planes_t": (ss.skew_sum_planes_t, ss.skew_sum_planes_t_ref, (
            g, g2, t["WtT"], t["SEre"], t["SEim"], sh["DreT"], sh["DimT"],
            t["plane"])),
        "eval_shear": (ss.eval_shear, ss.eval_shear_ref, (
            g, g2, t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"],
            sh["PhiDim"])),
        "eval_shear_t": (ss.eval_shear_t, ss.eval_shear_t_ref, (
            ob, t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"], sh["PhiDim"])),
    }


@pytest.mark.parametrize("name", ["skew_sum_planes", "skew_sum_planes_t",
                                  "eval_shear", "eval_shear_t"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(name, dtype):
    dev = _device()
    _, t = _tables(dtype, dev)
    kern, ref, args = _cases(t, dev)[name]
    before = kern.launches
    got, want = kern(*args), ref(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.device.type == "cuda"
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= RTOL[dtype] * scale, name


def _assert_close(got, want, rtol):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.device.type == "cuda"
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= rtol * scale


@pytest.mark.parametrize("name", ["skew_sum_planes", "skew_sum_planes_t",
                                  "eval_shear", "eval_shear_t"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_shared_table_matches_plain(name, dtype):
    """Three images against one shared table set (PT = 1), as the fan-beam
    path runs them."""
    dev = _device()
    geo = GeometryConfig(N=48, num_nodes=3, angles_total=96, fan_beam=True)
    a, v, _ = radon.node_angles(geo)
    t = radon_fan.precompute_fan_skew(
        geo, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev), dtype, nb=16)["shared"]["par"]
    assert t["WtT"].shape[0] == 1
    kern, ref, args = _cases(t, dev, P=3)[name]
    before = kern.launches
    got, want = kern(*args), ref(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _assert_close(got, want, RTOL[dtype])


def _pitched(x):
    return fs.pitched_zeros(x.shape, x.dtype, x.device).copy_(x)


def _grouped_inputs(dev, dtype, PB, PT, TB, tt, N, F, seed=3):
    """Tables of PT sets, slot spectra and cotangents of PB images, all in
    pitched storage (``fs.pitched_zeros``), as K13/K14 read them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    Tp = TB * tt
    H = [_pitched(torch.randn((PT, Tp, N, F), generator=gen, device=dev)
                  .to(dtype)) for _ in range(2)]
    r = [_pitched(torch.randn((PB, TB, N, F), generator=gen, device=dev))
         for _ in range(2)]
    g = [_pitched(torch.randn((PB, Tp, F), generator=gen, device=dev))
         for _ in range(2)]
    return H, r, g


# (PB, PT, TB, tt, N, F): the fan 256^2/8 grouped shapes (8 images against
# one table set) whole and at a smaller N, the 512^2/8 ones (tt = 32, one
# set an image) at a smaller N and F, tiles that divide neither N nor F,
# one table set per image, a slot block that is not a multiple of a
# thread's slots, two images a set, and odd and even F (pitches 520, 136,
# 72, 72).
GROUPED_SHAPES = [(8, 1, 6, 8, 256, 513), (8, 1, 6, 8, 64, 129),
                  (8, 8, 6, 32, 64, 129), (3, 1, 2, 12, 45, 70),
                  (4, 4, 3, 16, 40, 65), (4, 2, 3, 6, 40, 65)]


@pytest.mark.parametrize("shape", GROUPED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_kernels_match_plain_and_repeat(shape, dtype):
    """K13/K14 on pitched inputs against their plain versions (1e-5), a
    second call bit for bit, K14's output pitched with zero pad columns,
    and a node slice (the last half of the images, as a mesh rank holds
    them) equal to the whole batch's rows bit for bit."""
    dev = _device()
    PB, PT, TB, tt, N, F = shape
    (hr, hi), (rr, ri), (gr, gi) = _grouped_inputs(dev, dtype, *shape)
    before = fs.launch_counts()
    # A mesh rank's images, and the table sets they read: its own where
    # each image has one, else all (the images start on a multiple of PT).
    half = slice(PB // 2, PB) if PT in (1, PB) else slice(PT, PB)
    hs = half if PT == PB else slice(None)
    for kern, ref, args, part in (
            (fs.filter_sum_grouped, fs.filter_sum_grouped_ref,
             (rr, ri, hr, hi), (rr[half], ri[half], hr[hs], hi[hs])),
            (fs.filter_sum_grouped_t, fs.filter_sum_grouped_t_ref,
             (gr, gi, hr, hi, TB), (gr[half], gi[half], hr[hs], hi[hs], TB))):
        got, again, want = kern(*args), kern(*args), ref(*args)
        sliced = kern(*part)
        torch.cuda.synchronize()
        _assert_close(got, want, 1e-5)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert all(torch.equal(a, b[half]) for a, b in zip(sliced, got))
    pitch = -(-F // fs.PITCH) * fs.PITCH
    for out in got:  # K14's
        assert out.stride(-2) == pitch
        pad = out.as_strided((*out.shape[:-1], pitch), out.stride())[..., F:]
        assert torch.equal(pad, torch.zeros_like(pad))
    assert fs.launch_counts() == {
        **before, "filter_sum_grouped": before["filter_sum_grouped"] + 3,
        "filter_sum_grouped_t": before["filter_sum_grouped_t"] + 3}


def test_grouped_wrappers_reject_bad_inputs():
    dev = _device()
    (hr, hi), (rr, ri), (gr, gi) = _grouped_inputs(dev, torch.bfloat16, 4, 2,
                                                   2, 8, 32, 33)
    with pytest.raises(TypeError):
        fs.filter_sum_grouped(rr.double(), ri, hr, hi)  # spectra f32
    with pytest.raises(TypeError):
        fs.filter_sum_grouped(rr, ri, hr, hi.float())  # one table dtype
    with pytest.raises(TypeError):
        fs.filter_sum_grouped(rr, ri, hr.half(), hi.half())  # f32 or bf16
    with pytest.raises(ValueError):
        fs.filter_sum_grouped(rr[:3], ri[:3], hr, hi)  # 3 images, 2 sets
    with pytest.raises(ValueError):
        fs.filter_sum_grouped(rr[:, :, :16], ri, hr, hi)
    with pytest.raises(ValueError):
        fs.filter_sum_grouped_t(gr, gi, hr, hi, 3)  # Tp = 16 not a multiple
    with pytest.raises(ValueError):
        fs.filter_sum_grouped_t(gr.transpose(1, 2), gi, hr, hi, 2)
    with pytest.raises(ValueError):
        fs.filter_sum_grouped_t(gr, gi.cpu(), hr, hi, 2)  # device


def test_grouped_wrappers_reject_rows_they_cannot_stream():
    """A dense table whose F is not a multiple of 8, a misaligned pitch, a
    view that starts 2 bytes off 16, and dense odd-F spectra and
    cotangents each raise ValueError, with no launch; nothing is copied to
    make them fit."""
    dev = _device()
    (hr, hi), (rr, ri), (gr, gi) = _grouped_inputs(dev, torch.bfloat16, 4, 2,
                                                   2, 8, 32, 33)
    PT, Tp, N, F = hr.shape
    odd = torch.zeros((PT, Tp, N, 36), dtype=hr.dtype, device=dev)[..., :F]
    n40 = PT * Tp * N * 40
    shifted = torch.zeros(n40 + 8, dtype=hr.dtype, device=dev)[1:1 + n40]
    shifted = shifted.view(PT, Tp, N, 40)[..., :F]  # pitch 40, start 2 B off
    cases = {
        "dense odd F": (hr.contiguous(), hi.contiguous()),
        "misaligned pitch": (odd, odd),
        "shifted start": (shifted, hi),
    }
    before = fs.launch_counts()
    for what, (a, b) in cases.items():
        with pytest.raises(ValueError):
            fs.filter_sum_grouped(rr, ri, a, b)
        with pytest.raises(ValueError):
            fs.filter_sum_grouped_t(gr, gi, a, b, 2)
    with pytest.raises(ValueError):  # the spectra and cotangents too
        fs.filter_sum_grouped(rr.contiguous(), ri.contiguous(), hr, hi)
    with pytest.raises(ValueError):
        fs.filter_sum_grouped_t(gr.contiguous(), gi.contiguous(), hr, hi, 2)
    assert fs.launch_counts() == before


@pytest.mark.parametrize("fan", [False, True], ids=["parallel", "fan"])
def test_grouped_operators_on_a_node_slice_match_plain(fan):
    """fft_grouped through K13/K14 on the card, with f32 tables: the
    adjoint identity, and the operators on a mesh rank's node slice of the
    tables (``mesh.slice_tables``; the fan path keeps its shared set whole)
    against the plain path on the CPU on the same tables."""
    dev = _device()
    geo = GeometryConfig(N=48, num_nodes=4, angles_total=48, fan_beam=fan)
    a, v, _ = radon.node_angles(geo)
    at = torch.as_tensor(a, dtype=torch.float32, device=dev)
    vt = torch.as_tensor(v, device=dev)
    if fan:
        t = radon_fan.precompute_fan_grouped(geo, at, vt)
        fwd = radon_fan.project_nodes_fan_grouped
        adj = radon_fan.backproject_nodes_fan_grouped
    else:
        t = radon_fft.precompute_grouped(geo, at, vt)
        fwd, adj = (radon_fft.project_nodes_grouped,
                    radon_fft.backproject_nodes_grouped)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((4, geo.N, geo.N), generator=gen)
    y = torch.randn((4, a.shape[1], geo.n_det), generator=gen)
    before = fs.launch_counts()
    Ax, Aty = fwd(geo, x.to(dev), t), adj(geo, y.to(dev), t)
    assert fs.launch_counts() == {
        **before, "filter_sum_grouped": before["filter_sum_grouped"] + 1,
        "filter_sum_grouped_t": before["filter_sum_grouped_t"] + 1}
    lhs = float(torch.sum(Ax.double() * y.to(dev).double()))
    rhs = float(torch.sum(x.to(dev).double() * Aty.double()))
    rel = abs(lhs - rhs) / float(torch.linalg.norm(Ax) * torch.linalg.norm(y))
    assert rel <= 1e-5, rel
    ts = mesh.slice_tables(t, 4, slice(2, 4))

    def cpu(tree):
        return {k: cpu(u) if isinstance(u, dict) else u.cpu()
                for k, u in tree.items()}

    got = (fwd(geo, x[2:].to(dev), ts), adj(geo, y[2:].to(dev), ts))
    want = (fwd(geo, x[2:], cpu(ts)), adj(geo, y[2:], cpu(ts)))
    for a_, b_ in zip(got, want):
        _assert_close(a_, b_.to(dev), 1e-5)
    for a_, b_ in zip(got, (Ax[2:], Aty[2:])):
        _assert_close(a_, b_, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_skew_t_leaves_unread_plane_zero(dtype, monkeypatch):
    """Every angle block on plane 0, so no angle block reads plane 1, and
    the kernels' output and scratch allocated filled with NaN (the wrapper
    allocates with torch.empty): plane 1 comes out zero and plane 0 holds
    to the plain version, so the kernels write every element they read or
    return."""
    dev = _device()
    _, t = _tables(dtype, dev)
    kern, ref, args = _cases(t, dev)["skew_sum_planes_t"]
    args = (*args[:-1], torch.zeros_like(args[-1]))
    want = ref(*args)
    empty = torch.empty

    def nan_empty(*a, **k):
        out = empty(*a, **k)
        return out.fill_(float("nan")) if out.is_floating_point() else out

    monkeypatch.setattr(torch, "empty", nan_empty)
    got = kern(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 1], torch.zeros_like(got[:, 1]))
    scale = float(want[:, 0].abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= RTOL[dtype] * scale


def test_adjoint_identity_through_kernels():
    dev = _device()
    geo, t = _tables(torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((3, geo.N, geo.N), generator=gen, device=dev)
    y = torch.randn((3, max(geo.angles_per_node()), geo.N), generator=gen,
                    device=dev)
    Ax = radon_fft.project_nodes_skew(geo, x, t)
    Aty = radon_fft.backproject_nodes_skew(geo, y, t)
    lhs = float(torch.sum(Ax.double() * y.double()))
    rhs = float(torch.sum(x.double() * Aty.double()))
    rel = abs(lhs - rhs) / float(torch.linalg.norm(Ax) * torch.linalg.norm(y))
    assert rel <= 1e-5, rel


def test_wrappers_reject_bad_inputs():
    dev = _device()
    _, t = _tables(torch.bfloat16, dev)
    kern, _, args = _cases(t, dev)["skew_sum_planes"]
    rows2, rest = args[0], args[1:]
    with pytest.raises(TypeError):
        kern(rows2.double(), *rest)  # rows must be float32
    with pytest.raises(ValueError):
        kern(rows2.transpose(2, 3), *rest)  # not contiguous
    with pytest.raises(ValueError):
        kern(rows2, rest[0], rest[1][:, :1].contiguous(), *rest[2:])  # SE shape
    with pytest.raises(TypeError):
        kern(rows2, *rest[:-1], rest[-1].long())  # plane must be int32
    with pytest.raises(ValueError):
        kern(rows2, *[a.cpu() if a is rest[0] else a for a in rest])  # device


def _consensus_inputs(dev, n, P=8):
    gen = torch.Generator(device=dev).manual_seed(2)
    a, y, z = (torch.randn((P, P, n), generator=gen, device=dev)
               for _ in range(3))
    adjm = (torch.rand((P, P), generator=gen, device=dev) > 0.4).float()
    w = torch.rand((P, n), generator=gen, device=dev) + 0.1
    return a, y, z, adjm, w


@pytest.mark.parametrize("n", [3000, 65536])  # 3000: not a multiple of TILE
@pytest.mark.parametrize("fusion", ["midpoint", "weighted"])
def test_consensus_matches_plain_and_is_deterministic(fusion, n):
    dev = _device()
    args = _consensus_inputs(dev, n)
    before = cons.consensus_update.launches
    got = cons.consensus_update(*args, fusion=fusion)
    again = cons.consensus_update(*args, fusion=fusion)
    want = cons.consensus_update_ref(*args, fusion=fusion)
    torch.cuda.synchronize()
    assert cons.consensus_update.launches == before + 2
    for g, g2, w in zip(got, again, want):
        assert g.shape == w.shape and g.device.type == "cuda"
        assert torch.equal(g, g2)
        scale = float(w.abs().max())
        assert scale > 0
        assert float((g - w).abs().max()) <= 1e-5 * scale


def test_consensus_rejects_bad_inputs():
    """Each bad input raises on a first call, and again on a call after a
    good signature was accepted (the checks are memoized by signature)."""
    dev = _device()
    a, y, z, adjm, w = _consensus_inputs(dev, 512)
    bad = (
        (TypeError, (a.double(), y, z, adjm)),
        (ValueError, (a.transpose(0, 1), y, z, adjm)),  # not contiguous
        (ValueError, (a, y[:, :, :256].contiguous(), z, adjm)),
        (ValueError, (a, y, z, adjm, w[:, :256].contiguous(), "weighted")),
        (ValueError, (a, y, z, adjm.cpu())),  # device
    )
    for _ in range(2):
        for err, args in bad:
            with pytest.raises(err):
                cons.consensus_update(*args)
        cons.consensus_update(a, y, z, adjm, w, "weighted")
        cons.consensus_update(a, y, z, adjm)


def _offset(x):
    """``x``'s values in a contiguous view that starts 4 bytes past a 16-byte
    boundary (the kernels' scalar path)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def _device_launches(fn) -> int:
    """The device launches of one call of ``fn`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


# (n, offset view): odd n = 63^2, a 4-byte offset view at n % 4 == 0 (both
# on the scalar path), and the 16-byte path.
K5_LAYOUTS = [(3969, False), (4096, True), (4096, False)]


@pytest.mark.parametrize("layout", K5_LAYOUTS,
                         ids=["odd-n", "offset-view", "aligned"])
@pytest.mark.parametrize("fusion", ["midpoint", "weighted"])
def test_consensus_both_forms_one_launch_bitwise(fusion, layout):
    """K5 in both forms on an adjacency that is not symmetric: one device
    launch a call, bit for bit on a repeat, z' and y' equal to the plain
    version's bit for bit (the partials at 1e-5), the sharded form's z', y'
    equal to the single-device call's block; the counters as before."""
    dev = _device()
    n, off = layout
    a, y, z, adjm, w = _consensus_inputs(dev, n)
    assert not torch.equal(adjm, adjm.T)
    if off:
        a, y, z, w = map(_offset, (a, y, z, w))
    rows = slice(4, 8)
    a_t = a.transpose(0, 1)[rows].contiguous()
    forms = {
        "single": ((a, y, z, adjm, w, fusion), {}),
        "sharded": ((a[rows], y[rows], z[rows], adjm[rows].contiguous()),
                    dict(fusion=fusion, a_t=_offset(a_t) if off else a_t,
                         w_own=w[rows], w_all=w)),
    }
    before = cons.launch_counts()
    outs = {}
    for form, (args, kw) in forms.items():
        got = cons.consensus_update(*args, **kw)
        again = cons.consensus_update(*args, **kw)
        want = cons.consensus_update_ref(*args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(g, g2) for g, g2 in zip(got, again)), form
        assert all(torch.equal(g, r) for g, r in zip(got[:2], want[:2])), form
        _assert_close(got[2:], want[2:], 1e-5)
        assert _device_launches(
            lambda: cons.consensus_update(*args, **kw)) == 1, form
        outs[form] = got
    for g, full in zip(outs["sharded"][:2], outs["single"][:2]):
        assert torch.equal(g, full[rows])
    after = cons.launch_counts()
    assert after["consensus_update"] == before["consensus_update"] + 4
    assert (after["consensus_update_sharded"]
            == before["consensus_update_sharded"] + 4)


@pytest.mark.parametrize("layout", [(3969, False), (4096, False)],
                         ids=["odd-n", "aligned"])
@pytest.mark.parametrize("fusion", ["midpoint", "weighted"])
def test_consensus_batch_is_one_launch_equal_to_its_lanes(fusion, layout):
    """K5 over a [3, 8, 8, n] batch: one device launch (the batch on the
    grid's z axis), each lane bit for bit the unbatched call on it, z' and
    y' equal to the plain version's (the partials at 1e-5), B = 1 equal to
    the unbatched call; a batch with a_t (the sharded form) is refused."""
    dev = _device()
    n, _ = layout
    gen = torch.Generator(device=dev).manual_seed(9)
    a, y, z = (torch.randn((3, 8, 8, n), generator=gen, device=dev)
               for _ in range(3))
    _, _, _, adjm, w = _consensus_inputs(dev, n)
    before = cons.consensus_update.launches
    got = cons.consensus_update(a, y, z, adjm, w, fusion)
    want = cons.consensus_update_ref(a, y, z, adjm, w, fusion)
    torch.cuda.synchronize()
    assert cons.consensus_update.launches == before + 1
    assert [tuple(g.shape) for g in got] == [(3, 8, 8, n)] * 2 + [(3, 8,
                                                                   8)] * 2
    assert all(torch.equal(g, r) for g, r in zip(got[:2], want[:2]))
    _assert_close(got[2:], want[2:], 1e-5)
    for s in range(3):
        lane = cons.consensus_update(a[s], y[s], z[s], adjm, w, fusion)
        assert all(torch.equal(g[s], v) for g, v in zip(got, lane))
    one = cons.consensus_update(a[:1], y[:1], z[:1], adjm, w, fusion)
    assert all(torch.equal(g[0], v[0]) for g, v in zip(one, got))
    assert _device_launches(
        lambda: cons.consensus_update(a, y, z, adjm, w, fusion)) == 1
    with pytest.raises(ValueError):
        cons.consensus_update(a, y, z, adjm, w, fusion, a_t=a,
                              w_own=w, w_all=w)


def test_consensus_clusters_fit_the_card():
    _device()
    for sharded in (False, True):
        for weighted in (False, True):
            assert cons.max_active_clusters(sharded, weighted) >= 1


def _sel_inputs(dev, dtype, PB, PT, T, N, F, seed=5):
    """Tables of PT sets (set 0 all plane 0, set 1 all plane 1, the rest
    mixed), spectra and cotangents of PB images, all in pitched storage
    (``fs.pitched_zeros``), as K11/K12 read them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    H = [_pitched(torch.randn((PT, T, N, F), generator=gen, device=dev)
                  .to(dtype)) for _ in range(2)]
    sel = (torch.rand((PT, T, 1), generator=gen, device=dev) > 0.5).float()
    sel[0] = 0.0
    if PT > 1:
        sel[1] = 1.0
    r = [_pitched(torch.randn((PB, 2, N, F), generator=gen, device=dev))
         for _ in range(2)]
    g = [_pitched(torch.randn((PB, T, F), generator=gen, device=dev))
         for _ in range(2)]
    return H, sel, r, g


# (PB, PT, T, N, F): the 512^2/8 shapes at a smaller N and F, tiles that
# divide neither T, N nor F, and three images per table set; F = 129, 70, 65
# and 33 are padded to pitches of 136, 72, 72 and 40.
SEL_SHAPES = [(8, 8, 192, 64, 129), (3, 3, 13, 45, 70), (6, 2, 16, 40, 65)]


@pytest.mark.parametrize("shape", SEL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sel_kernels_match_plain_and_repeat(shape, dtype):
    dev = _device()
    PB, PT, T, N, F = shape
    (hr, hi), sel, (rr, ri), (gr, gi) = _sel_inputs(dev, dtype, *shape)
    before = fs.launch_counts()
    for kern, ref, args in (
            (fs.filter_sum_sel, fs.filter_sum_sel_ref, (rr, ri, hr, hi, sel)),
            (fs.filter_sum_sel_t, fs.filter_sum_sel_t_ref,
             (gr, gi, hr, hi, sel))):
        got, again, want = kern(*args), kern(*args), ref(*args)
        torch.cuda.synchronize()
        _assert_close(got, want, 1e-5)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert fs.launch_counts() == {
        **before, "filter_sum_sel": before["filter_sum_sel"] + 2,
        "filter_sum_sel_t": before["filter_sum_sel_t"] + 2}


def test_sel_t_writes_zero_to_a_plane_no_angle_selects():
    dev = _device()
    (hr, hi), sel, _, (gr, gi) = _sel_inputs(dev, torch.bfloat16, 4, 2, 24,
                                             32, 65)
    rre, rim = fs.filter_sum_sel_t(gr, gi, hr, hi, sel)
    torch.cuda.synchronize()
    for p in range(4):  # table set 0 reads plane 0 only, set 1 plane 1 only
        unread = 1 - p % 2
        for out in (rre, rim):
            assert torch.equal(out[p, unread], torch.zeros_like(out[p, 0]))
            assert float(out[p, 1 - unread].abs().max()) > 0
    # The output is pitched, its pad columns written as zeros.
    for out in (rre, rim):
        assert out.stride(-2) == 72
        pad = out.as_strided((*out.shape[:-1], 72), out.stride())[..., 65:]
        assert torch.equal(pad, torch.zeros_like(pad))


def test_sel_wrappers_reject_bad_inputs():
    dev = _device()
    (hr, hi), sel, (rr, ri), (gr, gi) = _sel_inputs(dev, torch.bfloat16, 4,
                                                    2, 8, 32, 33)
    with pytest.raises(TypeError):
        fs.filter_sum_sel(rr.double(), ri, hr, hi, sel)  # spectra f32
    with pytest.raises(TypeError):
        fs.filter_sum_sel(rr, ri, hr, hi.float(), sel)  # one table dtype
    with pytest.raises(ValueError):
        fs.filter_sum_sel(rr[:3], ri[:3], hr, hi, sel)  # 3 images, 2 sets
    with pytest.raises(ValueError):
        fs.filter_sum_sel(rr, ri, hr, hi, sel[:, :4].contiguous())
    with pytest.raises(ValueError):
        fs.filter_sum_sel_t(gr.transpose(1, 2), gi, hr, hi, sel)
    with pytest.raises(ValueError):
        fs.filter_sum_sel_t(gr, gi.cpu(), hr, hi, sel)  # device


def test_sel_wrappers_reject_rows_they_cannot_stream():
    """A misaligned pitch, a non-unit last stride, a contiguous table
    whose F is not a multiple of 8 and storage that ends before the last
    row's padding each raise ValueError, with no launch; nothing is copied
    to make them fit."""
    dev = _device()
    (hr, hi), sel, (rr, ri), (gr, gi) = _sel_inputs(dev, torch.bfloat16, 4,
                                                    2, 8, 32, 33)
    PT, T, N, F = hr.shape
    odd = torch.zeros((PT, T, N, 36), dtype=hr.dtype, device=dev)[..., :F]
    flipped = torch.zeros((PT, T, F, N), dtype=hr.dtype,
                          device=dev).transpose(-1, -2)
    n40 = PT * T * N * 40
    shifted = torch.zeros(n40 + 8, dtype=hr.dtype, device=dev)[1:1 + n40]
    shifted = shifted.view(PT, T, N, 40)[..., :F]  # pitch 40, start 2 B off
    short = torch.zeros(n40 - 40 + F, dtype=hr.dtype, device=dev)
    short = short.as_strided((PT, T, N, F), (T * N * 40, N * 40, 40, 1))
    cases = {
        "storage ends before the last row's padding": (short, short),
        "misaligned pitch": (odd, odd),
        "non-unit last stride": (flipped, flipped),
        "contiguous odd F": (hr.contiguous(), hi.contiguous()),
        "shifted start": (shifted, hi),
    }
    before = fs.launch_counts()
    for what, (a, b) in cases.items():
        with pytest.raises(ValueError):
            fs.filter_sum_sel(rr, ri, a, b, sel)
        with pytest.raises(ValueError):
            fs.filter_sum_sel_t(gr, gi, a, b, sel)
    with pytest.raises(ValueError):  # the spectra and cotangents too
        fs.filter_sum_sel(rr.contiguous(), ri.contiguous(), hr, hi, sel)
    with pytest.raises(ValueError):
        fs.filter_sum_sel_t(gr.contiguous(), gi.contiguous(), hr, hi, sel)
    assert fs.launch_counts() == before


def _hat_inputs(dev, PB, PT, T, D, Np, seed=6):
    """Coordinates that rise along d, fall along d (every other row) and, in
    row 1 of each set, jump about (not monotone); a third of the taps fall
    outside [0, Np)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pc = torch.rand((PT, T, D), generator=gen, device=dev) * (Np + 5) - 3
    pc = torch.sort(pc, dim=-1).values
    pc[:, ::2] = pc[:, ::2].flip(-1)
    pc[:, 1] = pc[:, 1, torch.randperm(D, generator=gen, device=dev)]
    s = torch.rand((PT, T, 1), generator=gen, device=dev) + 0.5
    g = torch.randn((PB, T, Np), generator=gen, device=dev)
    ob = torch.randn((PB, T, D), generator=gen, device=dev)
    return pc.contiguous(), s, g, ob


# (PB, PT, T, D, Np): the 512^2/8 shapes, odd sizes, three images per set.
HAT_SHAPES = [(8, 8, 192, 512, 2048), (3, 3, 7, 45, 97), (6, 2, 16, 40, 128)]


@pytest.mark.parametrize("shape", HAT_SHAPES)
def test_hat_kernels_match_plain_and_repeat(shape):
    dev = _device()
    PB, PT, T, D, Np = shape
    pc, s, g, ob = _hat_inputs(dev, *shape)
    before = he.launch_counts()
    for kern, ref, args in ((he.hat_eval, he.hat_eval_ref, (g, pc, s)),
                            (he.hat_eval_t, he.hat_eval_t_ref,
                             (ob, pc, s, Np))):
        got, again, want = kern(*args), kern(*args), ref(*args)
        torch.cuda.synchronize()
        _assert_close(got, want, 1e-5)
        assert torch.equal(got, again)
    assert he.launch_counts() == {k: c + 2 for k, c in before.items()}


def test_hat_wrappers_reject_bad_inputs():
    """Each bad input raises on a first call, and again on a call after a
    good signature was accepted (the checks are memoized by signature)."""
    dev = _device()
    pc, s, g, ob = _hat_inputs(dev, 4, 2, 8, 32, 64)
    bad = (
        (TypeError, he.hat_eval, (g.double(), pc, s)),
        (ValueError, he.hat_eval, (g[:3].contiguous(), pc, s)),  # 3 of 2 sets
        (ValueError, he.hat_eval, (g, pc, s[:, :4].contiguous())),
        (ValueError, he.hat_eval_t, (ob.transpose(1, 2), pc, s, 64)),
        (ValueError, he.hat_eval_t, (ob, pc.cpu(), s, 64)),  # device
    )
    for _ in range(2):
        for err, kern, args in bad:
            with pytest.raises(err):
                kern(*args)
        he.hat_eval(g, pc, s)
        he.hat_eval_t(ob, pc, s, 64)


def _hat_formula(g, pc, s):
    """K17's arithmetic in torch, as its first design computed it: v0 =
    floor(pc), the taps v0 and v0 + 1 inside [0, Np) in that order with
    hat(x, v) = max(0, 1 - |x - v|) in f32 (a NaN coordinate adds
    nothing), the second tap's product added in one fused multiply-add
    (the product exact in f64, one rounding of the sum), s after the sum."""
    PB, T, Np = g.shape
    x = pc.repeat(PB // pc.shape[0], 1, 1)
    fl = torch.floor(x)
    ok = (fl >= -1) & (fl < Np)
    v0 = torch.where(ok, fl, torch.zeros_like(fl))
    acc = torch.zeros_like(x)
    for k in (0, 1):
        v = v0 + k
        live = ok & (v >= 0) & (v < Np)
        h = torch.clamp(1.0 - torch.abs(x - v), min=0.0)
        gv = torch.gather(g, 2, v.long().clamp(0, Np - 1))
        new = (h.double() * gv.double() + acc.double()).float()
        acc = torch.where(live, new, acc)
    return s.repeat(PB // pc.shape[0], 1, 1) * acc


@pytest.mark.parametrize("shape", [(6, 2, 16, 45, 128), (8, 8, 192, 509, 2048),
                                   (8, 8, 192, 512, 2048)])
def test_hat_eval_equals_its_formula_bit_for_bit(shape):
    """K17 (four detectors a thread, a scalar tail at D % 4 != 0) with
    coordinates below 0, above Np - 1 and NaN equals its first design's
    formula evaluated in torch, bit for bit."""
    dev = _device()
    PB, PT, T, D, Np = shape
    pc, s, g, _ = _hat_inputs(dev, *shape)
    pc[:, 2, 5::11] = float("nan")
    pc[:, 3] = pc[:, 3] + Np
    got = he.hat_eval(g, pc, s)
    torch.cuda.synchronize()
    assert torch.equal(got, _hat_formula(g, pc, s))


def test_pallas_adjoint_identity_through_kernels(monkeypatch):
    """fft_pallas through K11/K12 and, with the threshold at 0, K17/K18."""
    dev = _device()
    geo = GeometryConfig(N=48, num_nodes=3, angles_total=45)
    a, v, _ = radon.node_angles(geo)
    t = radon_fft.precompute_merged_nodes(
        geo, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev), pitched=True)
    monkeypatch.setattr(radon_fft, "_HAT_MAX_BYTES", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((3, geo.N, geo.N), generator=gen, device=dev)
    y = torch.randn((3, max(geo.angles_per_node()), geo.N), generator=gen,
                    device=dev)
    before = {**fs.launch_counts(), **he.launch_counts()}
    Ax = radon_fft.project_nodes_merged(geo, x, t)
    Aty = radon_fft.backproject_nodes_merged(geo, y, t)
    assert {**fs.launch_counts(), **he.launch_counts()} == {
        **before, **{k: before[k] + 1 for k in (
            "filter_sum_sel", "filter_sum_sel_t", "hat_eval", "hat_eval_t")}}
    lhs = float(torch.sum(Ax.double() * y.double()))
    rhs = float(torch.sum(x.double() * Aty.double()))
    rel = abs(lhs - rhs) / float(torch.linalg.norm(Ax) * torch.linalg.norm(y))
    assert rel <= 1e-5, rel


def test_pallas_on_a_node_slice_matches_plain():
    """fft_pallas through K11/K12 on a mesh rank's node slice of pitched
    tables (``mesh.slice_tables``, as ``--mesh`` runs it), against the
    plain path on the CPU on the same tables."""
    dev = _device()
    geo = GeometryConfig(N=48, num_nodes=4, angles_total=48)
    a, v, _ = radon.node_angles(geo)
    t = mesh.slice_tables(radon_fft.precompute_merged_nodes(
        geo, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev), pitched=True), 4, slice(2, 4))
    t_cpu = {k: x.cpu() for k, x in t.items()}
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((2, geo.N, geo.N), generator=gen)
    y = torch.randn((2, max(geo.angles_per_node()), geo.N), generator=gen)
    before = fs.launch_counts()
    got = (radon_fft.project_nodes_merged(geo, x.to(dev), t),
           radon_fft.backproject_nodes_merged(geo, y.to(dev), t))
    assert fs.launch_counts() == {
        **before, "filter_sum_sel": before["filter_sum_sel"] + 1,
        "filter_sum_sel_t": before["filter_sum_sel_t"] + 1}
    want = (radon_fft.project_nodes_merged(geo, x, t_cpu),
            radon_fft.backproject_nodes_merged(geo, y, t_cpu))
    for a_, b_ in zip(got, want):
        _assert_close(a_, b_.to(dev), 1e-5)


@pytest.fixture(scope="module")
def pallas_512():
    """The 512^2/8 fft_pallas tables (bf16 H, pitched), as the loader
    builds them for that problem."""
    dev = _device()
    geo = GeometryConfig(N=512, num_nodes=8)
    a, v, _ = radon.node_angles(geo)
    return geo, radon_fft.precompute_merged_nodes(
        geo, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev), torch.bfloat16, pitched=True)


def _exact_dft(N, Np, dev):
    """``radon_fft._dft_mats``' four matrices in float64 with exact phases
    (v f reduced mod Np in integers; ``_dft_mats`` rounds the phases to
    float32, up to 1.5e-4 off at Np = 2048): Ere/Eim [N, Fd], Cre/Cim
    [Fd, Np]."""
    Fd = Np // 2 + 1
    f = torch.arange(Fd, dtype=torch.int64, device=dev)

    def cos_sin(a, b):
        ang = (2.0 * torch.pi / Np) * ((a[:, None] * b[None, :]) % Np).double()
        return torch.cos(ang), torch.sin(ang)

    cos1, sin1 = cos_sin(torch.arange(N, dtype=torch.int64, device=dev), f)
    cos2, sin2 = cos_sin(f, torch.arange(Np, dtype=torch.int64, device=dev))
    c = torch.full((Fd, 1), 2.0, dtype=torch.float64, device=dev)
    c[0] = c[-1] = 1.0
    return cos1, -sin1, c * cos2 / Np, -c * sin2 / Np


@pytest.mark.parametrize("helper", ["plane_spectra", "plane_spectra_t",
                                    "eval_tail", "eval_tail_t"])
def test_pallas_fft_helpers_match_dense_dft_at_512(helper, pallas_512):
    """The fft_pallas row DFTs and irfft tail as cuFFT transforms at the
    512^2/8 shapes (Np = 2048, F = 1025 in rows pitched to 1032) against
    dense products with the exact DFT matrices in float64, to 1e-5 of the
    output's max; the tails' hat stage is K17/K18 on both sides. The
    spectra and the cotangents come out pitched, pad columns exactly 0."""
    geo, t = pallas_512
    dev = t["p"].device
    Np = t["Cre"].shape[-1]
    Ere, Eim, Cre, Cim = _exact_dft(geo.N, Np, dev)
    F = Cre.shape[0]
    PB, T, D = t["p"].shape
    s = t["s"].unsqueeze(-1)
    gen = torch.Generator(device=dev).manual_seed(11)

    def pitched(shape):
        return fs.pitched_zeros(shape, torch.float32, dev).copy_(
            torch.randn(shape, generator=gen, device=dev))

    if helper == "plane_spectra":
        x = torch.randn((PB, geo.N, geo.N), generator=gen, device=dev)
        got = radon_fft._plane_spectra(x, t)
        rows2 = torch.stack([x, x.transpose(1, 2)], dim=1).double()
        want = (rows2 @ Ere, rows2 @ Eim)
    elif helper == "plane_spectra_t":
        r = [pitched((PB, 2, geo.N, F)) for _ in range(2)]
        got = radon_fft._plane_spectra_t(*r, t, torch.float32)
        rows2 = r[0].double() @ Ere.T + r[1].double() @ Eim.T
        want = rows2[:, 0] + rows2[:, 1].transpose(1, 2)
    elif helper == "eval_tail":
        g = [pitched((PB, T, F)) for _ in range(2)]
        got = radon_fft._eval_tail(*g, t, torch.float32)
        want = he.hat_eval((g[0].double() @ Cre + g[1].double() @ Cim)
                           .float(), t["p"], s)
    else:
        y = torch.randn((PB, T, D), generator=gen, device=dev)
        got = radon_fft._eval_tail_t(y, t)
        g_bar = he.hat_eval_t(y, t["p"], s, Np).double()
        want = (g_bar @ Cre.T, g_bar @ Cim.T)
    want = tuple(w.float() for w in want) if isinstance(want, tuple) \
        else want.float()
    _assert_close(got, want, 1e-5)
    if helper in ("plane_spectra", "eval_tail_t"):
        for x in got:
            assert fs._check_pitched("test", helper, x) == 1032
            pad = fs.padded(x)[..., F:]
            assert pad.shape[-1] == 1032 - F
            assert torch.equal(pad, torch.zeros_like(pad))


def _shear_cases(dtype, dev, plane=None):
    """K7 and K8 (wrapper, plain version, arguments) on the "shear" tables
    at N = 48 (16-row blocks: NB = 3), P = 3; ``plane`` replaces the
    tables' plane of every angle block."""
    geo = GeometryConfig(N=48, num_nodes=3, angles_total=45)
    a, v, _ = radon.node_angles(geo)
    t = radon_fft.precompute_shear(
        geo, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev), dtype, nb=16, layout="shear")
    sh = t["shared"]
    P, NB, Tp, D2, nb = t["Wt"].shape
    F = t["SEre"].shape[-1]
    gen = torch.Generator(device=dev).manual_seed(8)
    r = [torch.randn((P, 2, NB * nb, F), generator=gen, device=dev)
         for _ in range(2)]
    g = [torch.randn((P, Tp, F), generator=gen, device=dev)
         for _ in range(2)]
    pl = t["plane"] if plane is None else plane
    tabs = (t["Wt"], t["SEre"], t["SEim"], sh["Phire"], sh["Phiim"], pl)
    return {
        "shear_sum_planes": (ss.shear_sum_planes, ss.shear_sum_planes_ref,
                             (*r, *tabs)),
        "shear_sum_planes_t": (ss.shear_sum_planes_t,
                               ss.shear_sum_planes_t_ref, (*g, *tabs)),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shear_kernels_match_plain_and_repeat(dtype):
    dev = _device()
    cases = _shear_cases(dtype, dev)
    before = ss.launch_counts()
    for name, (kern, ref, args) in cases.items():
        got, again, want = kern(*args), kern(*args), ref(*args)
        torch.cuda.synchronize()
        _assert_close(got, want, RTOL[dtype])
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
    assert ss.launch_counts() == {
        **before, "shear_sum_planes": before["shear_sum_planes"] + 2,
        "shear_sum_planes_t": before["shear_sum_planes_t"] + 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shear_t_writes_zero_to_a_plane_no_block_reads(dtype):
    dev = _device()
    plane = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    plane[1] = 1  # node 1 reads plane 1 only, nodes 0 and 2 plane 0 only
    for name, (kern, ref, args) in _shear_cases(dtype, dev, plane).items():
        got, want = kern(*args), ref(*args)
        torch.cuda.synchronize()
        _assert_close(got, want, RTOL[dtype])
        if name == "shear_sum_planes_t":
            for out in got:
                for p in range(3):
                    unread = 1 - int(plane[p, 0])
                    assert torch.equal(out[p, unread],
                                       torch.zeros_like(out[p, 0]))


def _mxu_inputs(dev, dtype, PB, PT, TB, tt, N, F, seed=9):
    """Tiled random tables of PT sets (slot order with slack slots, F padded
    to a multiple of 128), spectra and cotangents of PB images."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    Tp, Fpad, tn = TB * tt, -(-F // 128) * 128, fm.pick_tn(N)
    src = torch.full((PT, Tp), -1, dtype=torch.int32, device=dev)
    for i in range(PT):
        slots = torch.randperm(Tp, generator=gen, device=dev)[:Tp - 2]
        src[i, slots] = torch.arange(Tp - 2, dtype=torch.int32, device=dev)
    H = [fm.tile_table(torch.randn((PT, Tp - 2, N, F), generator=gen,
                                   device=dev).to(dtype), src, Fpad, tn)
         for _ in range(2)]
    r = [torch.randn((PB, TB, N, Fpad), generator=gen, device=dev)
         for _ in range(2)]
    g = [torch.randn((PB, Tp, Fpad), generator=gen, device=dev)
         for _ in range(2)]
    return H, r, g


# (PB, PT, TB, tt, N, F): the 256^2/8 shapes at a smaller N, a slot chunk
# that is not a multiple of the kernel's 4 slots with rows that do not fill
# a row tile, and three images per table set.
MXU_SHAPES = [(8, 8, 3, 32, 64, 513), (3, 3, 2, 10, 40, 130),
              (6, 2, 1, 8, 24, 65)]


@pytest.mark.parametrize("shape", MXU_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mxu_kernels_match_plain_and_repeat(shape, dtype):
    dev = _device()
    PB, PT, TB, tt, N, F = shape
    (hr, hi), (rr, ri), (gr, gi) = _mxu_inputs(dev, dtype, *shape)
    before = fm.launch_counts()
    for kern, ref, args in (
            (fm.filter_sum_mxu, fm.filter_sum_mxu_ref, (rr, ri, hr, hi)),
            (fm.filter_sum_mxu_t, fm.filter_sum_mxu_t_ref,
             (gr, gi, hr, hi, TB))):
        got, again, want = kern(*args), kern(*args), ref(*args)
        torch.cuda.synchronize()
        _assert_close(got, want, 1e-5)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert fm.launch_counts() == {k: c + 2 for k, c in before.items()}


def test_mxu_wrappers_reject_bad_inputs():
    dev = _device()
    (hr, hi), (rr, ri), (gr, gi) = _mxu_inputs(dev, torch.bfloat16, 4, 2, 2,
                                               8, 32, 65)
    with pytest.raises(TypeError):
        fm.filter_sum_mxu(rr.double(), ri, hr, hi)  # spectra f32
    with pytest.raises(TypeError):
        fm.filter_sum_mxu(rr, ri, hr, hi.float())  # one table dtype
    with pytest.raises(ValueError):
        fm.filter_sum_mxu(rr[:3].contiguous(), ri[:3].contiguous(), hr,
                          hi)  # 3 images, 2 table sets
    with pytest.raises(ValueError):
        fm.filter_sum_mxu(rr[..., :64].contiguous(), ri, hr, hi)  # Fpad
    with pytest.raises(ValueError):
        fm.filter_sum_mxu_t(gr, gi, hr, hi, 3)  # Tp = 16 not a multiple
    with pytest.raises(ValueError):
        fm.filter_sum_mxu_t(gr, gi.cpu(), hr, hi, 2)  # device
    misaligned = torch.empty(gr.numel() + 1, device=dev)[1:].view(gr.shape)
    with pytest.raises(ValueError):  # not 16-byte aligned
        fm.filter_sum_mxu_t(misaligned, gi, hr, hi, 2)


@pytest.mark.parametrize("mode", ["fft_shear", "fft_mxu"])
def test_adjoint_identity_through_new_modes(mode):
    """fft_shear through K7/K8 and K3/K4, fft_mxu through K15/K16, with f32
    tables."""
    dev = _device()
    geo = GeometryConfig(N=48, num_nodes=3, angles_total=45)
    a, v, _ = radon.node_angles(geo)
    at = torch.as_tensor(a, dtype=torch.float32, device=dev)
    vt = torch.as_tensor(v, device=dev)
    if mode == "fft_shear":
        t = radon_fft.precompute_shear(geo, at, vt, nb=16, layout="shear")
        fwd, adj = (radon_fft.project_nodes_shear,
                    radon_fft.backproject_nodes_shear)
        kernels = ("shear_sum_planes", "shear_sum_planes_t", "eval_shear",
                   "eval_shear_t")
    else:
        t = radon_fft.precompute_merged_mxu(geo, at, vt)
        fwd, adj = radon_fft.project_nodes_mxu, radon_fft.backproject_nodes_mxu
        kernels = ("filter_sum_mxu", "filter_sum_mxu_t")
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((3, geo.N, geo.N), generator=gen, device=dev)
    y = torch.randn((3, max(geo.angles_per_node()), geo.N), generator=gen,
                    device=dev)
    before = {**ss.launch_counts(), **fm.launch_counts()}
    Ax, Aty = fwd(geo, x, t), adj(geo, y, t)
    after = {**ss.launch_counts(), **fm.launch_counts()}
    assert after == {**before, **{k: before[k] + 1 for k in kernels}}
    lhs = float(torch.sum(Ax.double() * y.double()))
    rhs = float(torch.sum(x.double() * Aty.double()))
    rel = abs(lhs - rhs) / float(torch.linalg.norm(Ax) * torch.linalg.norm(y))
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("name", ["small-f32", "small-bf16",
                                  "fan-tt8-PT1-PB3", "bench-256"])
def test_skew_t_rows_matches_plain_repeats_and_tiles_k2(name):
    """K6 on each one-block row shard at the full row width (three shards
    of the small tables, two of an 8-slot fan table set and of the bench
    tables): against its plain version, bit for bit on a second call, and
    the shards' outputs concatenated along the rows equal K2's, bit for bit
    (each row block keeps K2's order of angle blocks)."""
    dev = _device()
    args = _k2_case(name, dev)
    g, g2, WtT, SEre, SEim, DreT, DimT, plane = args
    NB, nb = WtT.shape[1], WtT.shape[-1]
    assert NB == (3 if name.startswith("small") else 2)
    whole = ss.skew_sum_planes_t(*args)
    parts = []
    before = ss.skew_sum_planes_t_rows.launches
    for s in range(NB):
        loc = [v[:, s:s + 1].contiguous() for v in (WtT, SEre, SEim)]
        sargs = (g, g2, *loc, DreT, DimT, plane, NB * nb)
        got, again = (ss.skew_sum_planes_t_rows(*sargs),
                      ss.skew_sum_planes_t_rows(*sargs))
        want = ss.skew_sum_planes_t_rows_ref(*sargs)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_close(got, want, RTOL[WtT.dtype])
        parts.append(got)
    assert ss.skew_sum_planes_t_rows.launches == before + 2 * NB
    assert torch.equal(torch.cat(parts, dim=2), whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shear_slot_kernels_match_plain_repeat_and_k7_k8(dtype):
    """K9/K10 against their plain versions, bit for bit on a second call;
    K9 on the planes gathered one-hot is K7 bit for bit, and K10 summed
    back over the one-hot is K8 (the RTOL of K7/K8)."""
    dev = _device()
    cases = _shear_cases(dtype, dev)
    _, k7_args = cases["shear_sum_planes"][1:]
    _, k8_args = cases["shear_sum_planes_t"][1:]
    r2, tabs, plane = k7_args[:2], k7_args[2:7], k7_args[7]
    g = k8_args[:2]
    P, TB = plane.shape
    pidx = torch.arange(P, device=dev)[:, None]
    r_s = [v[pidx, plane.long()].contiguous() for v in r2]
    before = (ss.shear_sum.launches, ss.shear_sum_t.launches)
    for kern, ref, args in ((ss.shear_sum, ss.shear_sum_ref, (*r_s, *tabs)),
                            (ss.shear_sum_t, ss.shear_sum_t_ref,
                             (*g, *tabs, TB))):
        got, again, want = kern(*args), kern(*args), ref(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        _assert_close(got, want, RTOL[dtype])
    assert (ss.shear_sum.launches, ss.shear_sum_t.launches) == (
        before[0] + 2, before[1] + 2)
    for a, b in zip(ss.shear_sum(*r_s, *tabs),
                    ss.shear_sum_planes(*k7_args)):
        assert torch.equal(a, b)
    onehot = torch.nn.functional.one_hot(plane.long(), 2).float()
    _assert_close(tuple(torch.einsum("ptnf,pto->ponf", a, onehot)
                        for a in ss.shear_sum_t(*g, *tabs, TB)),
                  ss.shear_sum_planes_t(*k8_args), RTOL[dtype])


def _shear_tables(dev, N, P, angles_total, nb, dtype=torch.bfloat16):
    geo = GeometryConfig(N=N, num_nodes=P, angles_total=angles_total)
    a, v, _ = radon.node_angles(geo)
    return geo, radon_fft.precompute_shear(
        geo, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev), dtype, nb=nb, layout="shear")


def _shear_case(name, dev):
    """K7's and K8's arguments for the card cases of the bf16 tensor-core
    kernels: three images on one shared table set (PT = 1) of the small
    tables, the 256^2/8 bench tables (nb = 128, tt = 48, F = 513) and the
    512^2/8 ones (NB = 4, F = 1025)."""
    if name == "PT1":
        cases = _shear_cases(torch.bfloat16, dev)
        k7, k8 = cases["shear_sum_planes"][2], cases["shear_sum_planes_t"][2]
        tabs = [v[:1].contiguous() for v in k7[2:5]]
        one = (*tabs, *k7[5:7], k7[7][:1].contiguous())
        return (*k7[:2], *one), (*k8[:2], *one)
    N, P, T = (256, 8, 768) if name == "bench-256" else (512, 8, 1536)
    _, t = _shear_tables(dev, N, P, T, 128)
    assert t["Wt"].shape[-1] == 128
    assert t["Wt"].shape[2] // t["plane"].shape[1] == 48
    NB, Tp, F = t["Wt"].shape[1], t["Wt"].shape[2], t["SEre"].shape[-1]
    assert F == 2 * N + 1 and NB == N // 128
    gen = torch.Generator(device=dev).manual_seed(15)
    r = [torch.randn((P, 2, N, F), generator=gen, device=dev)
         for _ in range(2)]
    g = [torch.randn((P, Tp, F), generator=gen, device=dev)
         for _ in range(2)]
    tabs = (t["Wt"], t["SEre"], t["SEim"], t["shared"]["Phire"],
            t["shared"]["Phiim"], t["plane"])
    return (*r, *tabs), (*g, *tabs)


@pytest.mark.parametrize("name", ["PT1", "bench-256", "p512"])
def test_shear_kernels_match_plain_repeat_and_gather(name):
    """K7-K10 with bf16 tables (the tensor-core kernels over the marked tap
    tiles) against their plain versions and bit for bit on a second call,
    on one shared table set, at 256^2/8 and on the 512^2/8 tables (the
    small shapes with either table type: the tests above); K9 on the planes
    gathered one-hot equals K7 bit for bit, and K10 summed back over the
    one-hot holds to K8."""
    dev = _device()
    k7_args, k8_args = _shear_case(name, dev)
    rtol = RTOL[k7_args[2].dtype]
    plane = k7_args[7]
    TB = plane.shape[1]
    P = k7_args[0].shape[0]
    pidx = torch.arange(P, device=dev)[:, None]
    pl = plane.repeat(P // plane.shape[0], 1).long()
    r_s = [v[pidx, pl].contiguous() for v in k7_args[:2]]
    cases = ((ss.shear_sum_planes, ss.shear_sum_planes_ref, k7_args),
             (ss.shear_sum_planes_t, ss.shear_sum_planes_t_ref, k8_args),
             (ss.shear_sum, ss.shear_sum_ref, (*r_s, *k7_args[2:7])),
             (ss.shear_sum_t, ss.shear_sum_t_ref,
              (*k8_args[:7], TB)))
    outs = []
    for kern, ref, args in cases:
        before = kern.launches
        got, again = kern(*args), kern(*args)
        torch.cuda.synchronize()
        assert kern.launches == before + 2
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want = ref(*args)
        _assert_close(got, want, rtol)
        del want, again
        outs.append(got)
    assert all(torch.equal(a, b) for a, b in zip(outs[2], outs[0]))
    onehot = torch.nn.functional.one_hot(pl, 2).float()
    _assert_close(tuple(torch.einsum("ptnf,pto->ponf", a, onehot)
                        for a in outs[3]), outs[1], rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shear_t_leaves_unread_plane_zero(dtype, monkeypatch):
    """Every angle block on plane 0, and the kernels' outputs allocated
    filled with NaN (the wrappers allocate with torch.empty): K8's plane 1
    comes out zero and plane 0 holds to the plain version, so the kernel
    writes every element it returns."""
    dev = _device()
    kern, ref, args = _shear_cases(dtype, dev)["shear_sum_planes_t"]
    args = (*args[:-1], torch.zeros_like(args[-1]))
    want = ref(*args)
    empty = torch.empty

    def nan_empty(*a, **k):
        out = empty(*a, **k)
        return out.fill_(float("nan")) if out.is_floating_point() else out

    monkeypatch.setattr(torch, "empty", nan_empty)
    got = kern(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a[:, 1], torch.zeros_like(a[:, 1]))
    _assert_close(got, want, RTOL[dtype])


def _real_slots(Wt):
    """[PT, Tp] slots with a nonzero tap in every row block."""
    return (Wt != 0).flatten(3).any(dim=3).all(dim=1)


def test_shear_nan_patterns_match_plain():
    """K7 and K8 run MMAs only on the marked tap tiles. A NaN spectrum
    element still reaches every real slot's g at its frequency (K7), and a
    NaN in a real slot's cotangent every row of its plane at its frequency
    (K8), as the plain versions' dense products carry them (on real slots:
    the dense product also writes NaN to all-zero slack slots)."""
    dev = _device()
    cases = _shear_cases(torch.bfloat16, dev)
    k7_args, k8_args = (cases[k][2] for k in ("shear_sum_planes",
                                               "shear_sum_planes_t"))
    Wt, plane = k7_args[2], k7_args[7]
    real = _real_slots(Wt)  # [P, Tp]
    r = k7_args[0].clone()
    r[1, int(plane[1, 0]), 5, 3] = float("nan")
    got = ss.shear_sum_planes(r, *k7_args[1:])
    want = ss.shear_sum_planes_ref(r, *k7_args[1:])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert bool(torch.isnan(b[real]).any())
        assert torch.equal(torch.isnan(a[real]), torch.isnan(b[real]))
    slot = int(torch.nonzero(real[1])[0])
    g = k8_args[0].clone()
    g[1, slot, 3] = float("nan")
    got = ss.shear_sum_planes_t(g, *k8_args[1:])
    want = ss.shear_sum_planes_t_ref(g, *k8_args[1:])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert bool(torch.isnan(b).any())
        assert torch.equal(torch.isnan(a), torch.isnan(b))


def test_shear_projector_nan_patterns_match_plain():
    """A NaN pixel through ``project_nodes_shear`` and a NaN sinogram entry
    through ``backproject_nodes_shear`` (bf16 tables, K7/K8 over the marked
    tiles) give the NaN pattern of the plain path on the CPU."""
    dev = _device()
    geo, t = _shear_tables(dev, 48, 3, 45, 16)

    def to_cpu(v):
        return {k: to_cpu(x) for k, x in v.items()} if isinstance(
            v, dict) else v.cpu()

    tc = to_cpu(t)
    gen = torch.Generator(device=dev).manual_seed(16)
    img = torch.randn((3, 48, 48), generator=gen, device=dev)
    img[1, 16, 24] = float("nan")
    sino = torch.randn((3, max(geo.angles_per_node()), geo.n_det),
                       generator=gen, device=dev)
    sino[2, 4, 7] = float("nan")
    for fn, x in ((radon_fft.project_nodes_shear, img),
                  (radon_fft.backproject_nodes_shear, sino)):
        got = fn(geo, x, t)
        want = fn(geo, x.cpu(), tc)
        torch.cuda.synchronize()
        assert bool(torch.isnan(want).any())
        assert torch.equal(torch.isnan(got).cpu(), torch.isnan(want))


def test_shear_wrappers_reject_bad_inputs():
    dev = _device()
    cases = _shear_cases(torch.bfloat16, dev)
    r, ri, Wt, SEre, SEim, phr, phi, plane = cases["shear_sum_planes"][2]
    with pytest.raises(TypeError):
        ss.shear_sum_planes(r.double(), ri, Wt, SEre, SEim, phr, phi, plane)
    with pytest.raises(TypeError):
        ss.shear_sum_planes(r, ri, Wt, SEre, SEim, phr.to(torch.bfloat16), phi,
                            plane)  # Phi must be f32
    with pytest.raises(TypeError):
        ss.shear_sum_planes(r, ri, Wt, SEre, SEim, phr, phi, plane.long())
    with pytest.raises(ValueError):
        ss.shear_sum_planes(r, ri, Wt, SEre[:, :1].contiguous(), SEim, phr,
                            phi, plane)
    with pytest.raises(ValueError):
        ss.shear_sum_planes(r[:2].contiguous(), ri, Wt, SEre, SEim, phr, phi,
                            plane)
    # the bf16 kernels take D2 % 16 == 0 and a 16-byte aligned Wt
    D2 = Wt.shape[3]
    with pytest.raises(ValueError):
        ss.shear_sum_planes(r, ri, Wt[..., :D2 - 8, :].contiguous(), SEre,
                            SEim, phr[:D2 - 8].contiguous(),
                            phi[:D2 - 8].contiguous(), plane)
    odd = torch.empty(Wt.numel() + 4, dtype=Wt.dtype,
                      device=dev)[4:].view_as(Wt)
    odd.copy_(Wt)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    g, gi = cases["shear_sum_planes_t"][2][:2]
    with pytest.raises(ValueError):
        ss.shear_sum_planes_t(g, gi, odd, SEre, SEim, phr, phi, plane)


@pytest.mark.parametrize("fusion", ["midpoint", "weighted"])
def test_consensus_sharded_matches_plain_and_repeats(fusion):
    """K5's sharded form on node block 1 of 2 and pixel block 1 of 2 (3000
    of 6000 pixels: not a multiple of TILE), with the explicit a_t and
    weights, against its plain version and bit for bit on a second call;
    its z and y equal the single-device kernel's on the same block."""
    dev = _device()
    a, y, z, adjm, w = _consensus_inputs(dev, 6000)
    rows, cols = slice(4, 8), slice(3000, 6000)
    blk = [v[rows][..., cols].contiguous()
           for v in (a, y, z, a.transpose(0, 1))]
    kw = dict(fusion=fusion, a_t=blk[3], w_own=w[rows, cols].contiguous(),
              w_all=w[:, cols].contiguous())
    args = (*blk[:3], adjm[rows].contiguous())
    before = cons.consensus_update.sharded_launches
    got, again = (cons.consensus_update(*args, **kw),
                  cons.consensus_update(*args, **kw))
    want = cons.consensus_update_ref(*args, **kw)
    whole = cons.consensus_update(a, y, z, adjm, w, fusion)
    torch.cuda.synchronize()
    assert cons.consensus_update.sharded_launches == before + 2
    assert all(torch.equal(g1, g2) for g1, g2 in zip(got, again))
    _assert_close(got, want, 1e-5)
    for g1, full in zip(got[:2], whole[:2]):
        assert torch.equal(g1, full[rows][..., cols])


def _skew_synthetic(dev, PB, PT, NB, nb, TB, tt, seed=11):
    """K1's arguments with bf16 tables of PT sets built as the loader
    builds them (two adjacent taps per (row block, slot, row), phases of
    unit modulus, the DFT-back D), for PB images."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    N, Tp = NB * nb, TB * tt
    D2 = -(-(nb + 2) // 16) * 16
    WZ = -(-(N + D2 - 1) // 128) * 128
    F = N // 2 + 1
    d0 = torch.randint(0, D2 - 1, (PT, NB, 1, Tp, nb), generator=gen,
                       device=dev)
    fr = torch.rand((PT, NB, 1, Tp, nb), generator=gen, device=dev)
    d = torch.arange(D2, device=dev)[:, None, None]
    W = (d0 == d) * (1.0 - fr) + (d0 + 1 == d) * fr  # [PT, NB, D2, Tp, nb]
    ph = torch.rand((PT, NB, Tp, F), generator=gen, device=dev) * 6.2831855
    ang = (3.14159265 / N) * torch.outer(
        torch.arange(WZ, device=dev) - (D2 - 1.0),
        torch.arange(F, device=dev, dtype=torch.float32))
    rows2 = torch.randn((PB, 2, N, N), generator=gen, device=dev)
    plane = torch.randint(0, 2, (PT, TB), generator=gen, device=dev)
    return (rows2, W.to(torch.bfloat16).contiguous(), torch.cos(ph),
            torch.sin(ph), torch.cos(ang).to(torch.bfloat16),
            (-torch.sin(ang)).to(torch.bfloat16), plane.to(torch.int32))


def _k1_case(name, dev):
    """K1's arguments for the card cases of the bf16 tensor-core kernel
    (and the f32 CUDA-core one)."""
    if name in ("small-f32", "small-bf16"):
        dtype = torch.float32 if name == "small-f32" else torch.bfloat16
        return _cases(_tables(dtype, dev)[1], dev)["skew_sum_planes"][2]
    if name == "fan-tt8-PT1-PB3":
        return _skew_synthetic(dev, 3, 1, 2, 16, 6, 8)
    if name == "row-shard-NB1":
        return _skew_synthetic(dev, 2, 2, 1, 16, 2, 48)
    # the 256^2/8 bench tables: nb = 128, tt = 48
    _, t = _tables(torch.bfloat16, dev, N=256, P=8, angles_total=768,
                   nb=128)
    assert t["WtT"].shape[-1] == 128
    assert t["WtT"].shape[3] // t["plane"].shape[1] == 48
    return _cases(t, dev)["skew_sum_planes"][2]


K1_CASES = ["small-f32", "small-bf16", "fan-tt8-PT1-PB3", "row-shard-NB1",
            "bench-256"]


@pytest.mark.parametrize("name", K1_CASES)
def test_skew_fwd_matches_plain_and_repeats(name):
    """K1 against its plain version (RTOL of its table type) and bit for
    bit on a second call: the f32 CUDA-core kernel, and the bf16
    tensor-core kernel at the small shapes, a fan table (8-slot blocks, one
    table set for three images), a one-block row shard and the bench
    shapes."""
    dev = _device()
    args = _k1_case(name, dev)
    before = ss.skew_sum_planes.launches
    got, again = ss.skew_sum_planes(*args), ss.skew_sum_planes(*args)
    want = ss.skew_sum_planes_ref(*args)
    torch.cuda.synchronize()
    assert ss.skew_sum_planes.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_close(got, want, RTOL[args[1].dtype])


@pytest.mark.parametrize("name", ["small-bf16", "bench-256"])
def test_skew_fwd_row_shards_sum_to_all_rows_bit_for_bit(name):
    """K1 on each of two row shards (its rows, its row block of the
    tables), the outputs summed as the pixel axis sums them, equals K1 on
    all rows bit for bit: each row block's term is formed whole and added
    in ascending b."""
    dev = _device()
    rows2, WtT, SEre, SEim, Dre, Dim, plane = _k1_case(name, dev)
    NB, nb = WtT.shape[1], WtT.shape[-1]
    if name == "small-bf16":  # three row blocks: shards of 2 and 1
        cuts = [(0, 2), (2, 3)]
    else:
        assert NB == 2
        cuts = [(0, 1), (1, 2)]
    whole = ss.skew_sum_planes(rows2, WtT, SEre, SEim, Dre, Dim, plane)
    parts = []
    for b0, b1 in cuts:
        loc = [v[:, b0:b1].contiguous() for v in (WtT, SEre, SEim)]
        parts.append(ss.skew_sum_planes(
            rows2[:, :, b0 * nb:b1 * nb].contiguous(), *loc, Dre, Dim, plane))
    torch.cuda.synchronize()
    for i in range(2):
        assert torch.equal(parts[0][i] + parts[1][i], whole[i])


@pytest.mark.parametrize("integer", [False, True], ids=["real", "integer"])
def test_hat_t_rows_of_every_kind_repeat(integer):
    """K18 against its plain version (1e-5) and bit for bit on a second
    call, on rising, falling and non-monotone rows with a third of the
    coordinates outside [0, Np), real- or integer-valued, two images per
    geometry set (PB = 2 PT)."""
    dev = _device()
    pc, s, _, ob = _hat_inputs(dev, 8, 4, 16, 64, 256, seed=12)
    if integer:
        pc = torch.round(pc)
    before = he.hat_eval_t.launches
    got, again = he.hat_eval_t(ob, pc, s, 256), he.hat_eval_t(ob, pc, s, 256)
    want = he.hat_eval_t_ref(ob, pc, s, 256)
    torch.cuda.synchronize()
    assert he.hat_eval_t.launches == before + 2
    assert torch.equal(got, again)
    _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("N,nb", [(48, 16), (128, 64)])
def test_skew_projector_nan_pixel_pattern_matches_plain(N, nb):
    """K1 runs MMAs only on the tap tiles that hold a nonzero. A NaN pixel
    must still reach every real slot as the plain version's dense product
    carries it: the projector's output (real slots only) through the
    kernels has the plain path's NaN pattern (the same tables on the CPU)."""
    dev = _device()
    geo, t = _tables(torch.bfloat16, dev, N=N, P=3,
                     angles_total=45 if N == 48 else 180, nb=nb)
    gen = torch.Generator(device=dev).manual_seed(13)
    img = torch.randn((3, N, N), generator=gen, device=dev)
    img[1, N // 3, N // 2] = float("nan")

    def to_cpu(v):
        return {k: to_cpu(x) for k, x in v.items()} if isinstance(
            v, dict) else v.cpu()

    got = radon_fft.project_nodes_skew(geo, img, t)
    want = radon_fft.project_nodes_skew(geo, img.cpu(), to_cpu(t))
    torch.cuda.synchronize()
    assert bool(torch.isnan(want).any())
    assert torch.equal(torch.isnan(got).cpu(), torch.isnan(want))


def _k2_case(name, dev):
    """K2's arguments for the card cases of the bf16 tensor-core kernels
    (and the f32 CUDA-core ones): K1's tables, the DFT-forward matrices
    D*T = D*.T and the slot spectra of the same images."""
    if name in ("small-f32", "small-bf16"):
        dtype = torch.float32 if name == "small-f32" else torch.bfloat16
        return _cases(_tables(dtype, dev)[1], dev)["skew_sum_planes_t"][2]
    if name == "bench-256":
        _, t = _tables(torch.bfloat16, dev, N=256, P=8, angles_total=768,
                       nb=128)
        return _cases(t, dev)["skew_sum_planes_t"][2]
    rows2, WtT, SEre, SEim, Dre, Dim, plane = _k1_case(name, dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    g = [torch.randn((rows2.shape[0], WtT.shape[3], SEre.shape[-1]),
                     generator=gen, device=dev) for _ in range(2)]
    return (*g, WtT, SEre, SEim, Dre.T.contiguous(), Dim.T.contiguous(),
            plane)


@pytest.mark.parametrize("name", K1_CASES)
def test_skew_t_matches_plain_and_repeats(name):
    """K2 against its plain version (RTOL of its table type) and bit for
    bit on a second call: the f32 CUDA-core kernels, and the bf16
    tensor-core kernels at the small shapes, a fan table (8-slot blocks, one
    table set for three images), a one-block row shard and the bench
    shapes."""
    dev = _device()
    args = _k2_case(name, dev)
    before = ss.skew_sum_planes_t.launches
    got, again = ss.skew_sum_planes_t(*args), ss.skew_sum_planes_t(*args)
    want = ss.skew_sum_planes_t_ref(*args)
    torch.cuda.synchronize()
    assert ss.skew_sum_planes_t.launches == before + 2
    assert torch.equal(got, again)
    _assert_close(got, want, RTOL[args[2].dtype])


@pytest.mark.parametrize("N,nb", [(48, 16), (128, 64)])
def test_skew_t_nan_slot_pattern_matches_plain(N, nb):
    """K2 runs MMAs only on the tap tiles that hold a nonzero. A NaN in one
    real slot of the spectra (a slot with a nonzero tap on every row) must
    still reach every row and column of its plane, as the plain version's
    dense product carries it: the kernels' output has the plain version's
    NaN pattern."""
    dev = _device()
    _, t = _tables(torch.bfloat16, dev, N=N, P=3,
                   angles_total=45 if N == 48 else 180, nb=nb)
    g, g2, WtT, *rest = _cases(t, dev)["skew_sum_planes_t"][2]
    pt = 1 % WtT.shape[0]
    real = (WtT[pt] != 0).any(dim=1).all(dim=2).all(dim=0)  # [Tp]
    slot = int(torch.nonzero(real)[0])
    g = g.clone()
    g[1, slot, 3] = float("nan")
    got = ss.skew_sum_planes_t(g, g2, WtT, *rest)
    want = ss.skew_sum_planes_t_ref(g, g2, WtT, *rest)
    torch.cuda.synchronize()
    assert bool(torch.isnan(want).any())
    assert torch.equal(torch.isnan(got), torch.isnan(want))


def _eval_case(name, dev):
    """(tables, image count) of K3/K4's card cases: the small tables with
    either table type, detector blocks whose width db is no multiple of 8
    (N = 45: db = 45, element loads and six lanes padded to eight) or above
    128 (N = 300: db = 300, three d chunks), three and four detector blocks
    of 128 (a detector of 384 or 512 cells: the R stage's pairs of detector
    blocks, the last one half full with three), a fan table (three images
    on one shared set) and the 256^2/8 bench tables."""
    if name in ("small-f32", "small-bf16"):
        dtype = torch.float32 if name == "small-f32" else torch.bfloat16
        return _tables(dtype, dev)[1], 3
    if name in ("db45", "db300"):
        N = int(name[2:])
        _, t = _tables(torch.bfloat16, dev, N=N, P=3, angles_total=45)
        assert t["Wd"].shape[-1] == N
        return t, 3
    if name in ("DB3", "DB4"):
        DB = int(name[2:])
        _, t = _tables(torch.bfloat16, dev, N=64, det_pixels=128 * DB)
        assert t["Wd"].shape[1] == DB and t["Wd"].shape[-1] == 128
        return t, 3
    if name == "fan-PT1":
        geo = GeometryConfig(N=64, num_nodes=3, angles_total=192,
                             fan_beam=True)
        a, v, _ = radon.node_angles(geo)
        t = radon_fan.precompute_fan_skew(
            geo, torch.as_tensor(a, dtype=torch.float32, device=dev),
            torch.as_tensor(v, device=dev), torch.bfloat16,
            nb=16)["shared"]["par"]
        assert t["Wd"].shape[0] == 1
        return t, 3
    _, t = _tables(torch.bfloat16, dev, N=256, P=8, angles_total=768,
                   nb=128)
    assert t["Wd"].shape[-1] == 128 and t["Wd"].shape[3] % 16 == 0
    return t, 8


EVAL_CASES = ["small-f32", "small-bf16", "db45", "db300", "DB3", "DB4",
              "fan-PT1", "bench-256"]


@pytest.mark.parametrize("name", EVAL_CASES)
@pytest.mark.parametrize("kernel", ["eval_shear", "eval_shear_t"])
def test_eval_matches_plain_repeats_and_slices(kernel, name):
    """K3/K4 against their plain versions (RTOL of the table type), bit for
    bit on a second call, and on a node block (the last half of the images
    and, where each image has its own, their table sets: a 2 x 2 mesh
    rank's P_loc = 4 at the bench shapes) against the plain version and
    equal to the whole batch's rows bit for bit."""
    dev = _device()
    t, P = _eval_case(name, dev)
    kern, ref, args = _cases(t, dev, P=P)[kernel]
    before = kern.launches
    got, again = kern(*args), kern(*args)
    want = ref(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dtype = t["Wd"].dtype
    _assert_close(got, want, RTOL[dtype])
    blk = slice(P // 2, P)
    nimg = 2 if kernel == "eval_shear" else 1
    loc = [a[blk].contiguous() for a in args[:nimg]]
    for a in args[nimg:]:
        shared = a.dim() == 2 or a.shape[0] != P
        loc.append(a if shared else a[blk].contiguous())
    part = kern(*loc)
    part = part if isinstance(part, tuple) else (part,)
    _assert_close(part, ref(*loc), RTOL[dtype])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b[blk]) for a, b in zip(part, got))


@pytest.mark.parametrize("kernel", ["eval_shear", "eval_shear_t"])
def test_eval_nan_slot_pattern_matches_plain(kernel):
    """The Wd passes read the dense Wd: a NaN in one slot row of the
    spectra (K3) or of the cotangent (K4), in a real slot and in a padded
    slot whose Wd rows are all zero, reaches what the plain version's dense
    einsum carries it to, so the kernels' output has its NaN pattern."""
    dev = _device()
    t, P = _eval_case("small-bf16", dev)
    kern, ref, args = _cases(t, dev, P=P)[kernel]
    Wd = t["Wd"]
    empty = (Wd[1] == 0).flatten(2).all(dim=2).all(dim=0)  # [Tp]
    slots = [int(torch.nonzero(~empty)[0])]
    if bool(empty.any()):
        slots.append(int(torch.nonzero(empty)[0]))
    x = args[0].clone()
    for s in slots:
        x[1, s, 3] = float("nan")
    args = (x, *args[1:])
    got, want = kern(*args), ref(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert bool(torch.isnan(b).any())
        assert torch.equal(torch.isnan(a), torch.isnan(b))


def test_eval_wrappers_reject_bad_inputs():
    dev = _device()
    _, t = _tables(torch.bfloat16, dev)
    kern, _, args = _cases(t, dev)["eval_shear"]
    g, g2, Wd, TEre, TEim, phr, phi = args
    with pytest.raises(TypeError):
        kern(g, g2, Wd, TEre, TEim, phr.to(torch.bfloat16), phi)  # PhiD f32
    with pytest.raises(TypeError):
        kern(g, g2, Wd, TEre.to(torch.bfloat16), TEim, phr, phi)  # TE f32
    with pytest.raises(ValueError):
        kern(g, g2, Wd, TEre[:, :, :1].contiguous(), TEim, phr, phi)  # shape
    with pytest.raises(ValueError):
        kern(g, g2, Wd, TEre, TEim, phr.cpu(), phi)  # device
    kern_t, _, args_t = _cases(t, dev)["eval_shear_t"]
    ob = args_t[0]
    with pytest.raises(ValueError):
        kern_t(ob.transpose(1, 2).contiguous().transpose(1, 2), *args_t[1:])
    with pytest.raises(ValueError):
        kern_t(ob[:2].contiguous(), *args_t[1:])  # 2 images, 3 table sets
    odd = torch.empty(ob.numel() + 1, device=dev)[1:].view_as(ob)
    odd.copy_(ob)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError):
        kern_t(odd, *args_t[1:])  # the Wd stream reads ob in 16-byte loads


# The fused Condat-Vu step (csrc/cv_step.cu): the same bits as the plain
# step, NaN where it is NaN, in float32, float64 and bfloat16 and with pcv's
# per-pixel s and sig; the inputs keep their values.
_CV_INT = {torch.float32: torch.int32, torch.float64: torch.int64,
           torch.bfloat16: torch.int16}


def _cv_inputs(dev, P, N, scalars, algo, nan=None, offset=False,
               dtype=torch.float32):
    from dip_admm_tpu_torch.core import node_solver

    gen = torch.Generator(device=dev).manual_seed(P * 131 + N)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    n = N * N
    f = [r(P, n), r(P, n), r(P, n), r(P, n).abs(), 0.02 * r(P, N, N),
         0.02 * r(P, N, N)]
    f = [t.to(dtype) for t in f]
    if offset:  # a view one element past a 16-byte boundary: the ragged path
        f[0] = torch.empty(P * n + 1, device=dev, dtype=dtype)[1:].view(
            P, n).copy_(f[0])
    x, adj, bc, D, ux, uy = f
    if nan == "x":
        x[0, N + 2] = float("nan")
    elif nan == "ux":
        ux[-1, N // 2, 3] = float("nan")
    per = [torch.rand((P,), generator=gen, device=dev) * k + c
           for k, c in ((1.0, 1.0), (0.3, 0.01), (0.5, 0.1), (0.02, 0.01))]
    per[3][0] = 0.0  # node 0's radius 0
    if scalars == "host":
        rho, s, sig, lam = (float(v[1 % P]) for v in per)
    elif scalars == "device0d":
        rho, s, sig, lam = (v[0].clone().to(dtype) for v in per)
    elif scalars == "per_pixel":  # pcv's T [P, n] and sigma [P, N, N]
        rho, lam = per[0][:, None].to(dtype), per[3][:, None, None].to(dtype)
        s = (torch.rand((P, n), generator=gen, device=dev) * 0.3
             + 0.01).to(dtype)
        sig = (torch.rand((P, N, N), generator=gen, device=dev) * 0.5
               + 0.1).to(dtype)
    else:
        rho, s, sig, lam = (per[0][:, None], per[1][:, None],
                            per[2][:, None, None], per[3][:, None, None])
        rho, s, sig, lam = (v.to(dtype) for v in (rho, s, sig, lam))
    if algo == "fcv":
        m_hat = (torch.rand((P, N, N // 2 + 1), generator=gen, device=dev)
                 + .5).to(dtype)
        precond = lambda d: node_solver._m_inv(m_hat, d, N)  # noqa: E731
    else:
        precond = lambda d: d  # noqa: E731
    return (x, ux, uy, adj, D, bc, rho, precond, s, sig, lam)


def _cv_check(args):
    from dip_admm_tpu_torch.ops.kernels import cv_step

    before = [a.clone() for a in args[:6]]
    want = cv_step.step_ref(*args)
    n0 = cv_step.step.launches
    got = cv_step.step(*args)
    torch.cuda.synchronize()
    assert cv_step.step.launches == n0 + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        nan_a = torch.isnan(a)
        assert torch.equal(nan_a, torch.isnan(b))
        i = _CV_INT[a.dtype]
        assert torch.equal(a[~nan_a].view(i), b[~nan_a].view(i))
    for a, b in zip(args[:6], before):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("nan", [None, "x", "ux"])
@pytest.mark.parametrize("scalars", ["host", "device0d", "per_node",
                                     "per_pixel"])
@pytest.mark.parametrize("algo", ["cv", "fcv"])
@pytest.mark.parametrize("P,N,offset", [(3, 32, False), (1, 31, False),
                                        (3, 64, True), (2, 256, False)])
def test_cv_step_kernels_equal_the_plain_step(P, N, offset, algo, scalars,
                                              nan):
    _cv_check(_cv_inputs(_device(), P, N, scalars, algo, nan, offset))


# float64 with and without its FFT metric; bfloat16 has no cuFFT, so cv.
@pytest.mark.parametrize("dtype,algo", [
    (torch.float64, "cv"), (torch.float64, "fcv"), (torch.bfloat16, "cv")])
@pytest.mark.parametrize("scalars", ["host", "device0d", "per_node",
                                     "per_pixel"])
@pytest.mark.parametrize("P,N,offset", [(3, 32, False), (1, 31, False),
                                        (3, 64, True), (2, 256, False)])
def test_cv_step_kernels_in_every_dtype(P, N, offset, scalars, dtype, algo):
    for nan in (None, "x"):
        _cv_check(_cv_inputs(_device(), P, N, scalars, algo, nan, offset,
                             dtype))


@pytest.mark.parametrize("scalars", ["host", "device0d", "per_node",
                                     "per_pixel"])
def test_cv_step_widens_narrower_inputs_as_torch_does(scalars):
    """A float32 state beside bfloat16 adj_out, D_vec, b_cons and operands
    (the dense bfloat16 problem's D_vec and b_cons): the plain step's
    bits."""
    x, ux, uy, adj, D, bc, rho, precond, s, sig, lam = _cv_inputs(
        _device(), 3, 64, scalars, "cv")
    bf = lambda v: (v.bfloat16()  # noqa: E731
                    if isinstance(v, torch.Tensor) else v)
    _cv_check((x, ux, uy, bf(adj), bf(D), bf(bc), bf(rho), precond, bf(s),
               bf(sig), bf(lam)))


@pytest.mark.parametrize("case", ["float16", "pixel_rho", "s_float64",
                                  "narrower_dual"])
def test_cv_step_refuses_on_the_card_what_it_cannot_mirror(case):
    from dip_admm_tpu_torch.ops.kernels import cv_step

    dev = _device()
    x, ux, uy, adj, D, bc, rho, precond, s, sig, lam = _cv_inputs(
        dev, 2, 32, "per_node", "cv")
    if case == "float16":
        x, ux, uy, adj, D, bc = (t.half() for t in (x, ux, uy, adj, D, bc))
    elif case == "pixel_rho":
        rho = torch.rand_like(x)
    elif case == "narrower_dual":
        ux = ux.bfloat16()
    else:
        s = s.double()
    n0 = cv_step.step.launches
    with pytest.raises(ValueError, match="cv_step"):
        cv_step.step(x, ux, uy, adj, D, bc, rho, precond, s, sig, lam)
    assert cv_step.step.launches == n0
