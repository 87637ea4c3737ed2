"""The hat-evaluation kernels K17/K18 of the PyTorch port against the JAX
package, on the CPU: their plain versions against the JAX Pallas kernels
``hat_eval``/``hat_eval_t`` in interpret mode on numpy-seeded inputs (taps
inside and outside [0, Np), one geometry set per image and three images per
set), and the projectors' eval tail through its kernel branch, which no CPU
test reaches at its real threshold (1.5e9 bytes of hat weights): with
``_HAT_MAX_BYTES`` monkeypatched to 0 the port's tail runs the kernels'
plain versions and is held to the JAX package's materialized tail and to
its ``hat_eval`` in interpret mode.

Tolerance: 1e-5 of the output's max (every weight and product is f32 on
both sides; only the order of the sums differs, and the TPU forward kernel
scales each v tile's partial sum before adding it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dip_admm_tpu.ops import radon_fft as jfft
from dip_admm_tpu.ops.pallas import hat_eval as jhe
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.ops import radon as tradon
from dip_admm_tpu_torch.ops import radon_fft as tfft
from dip_admm_tpu_torch.ops.kernels import hat_eval as the

torch.set_num_threads(2)

RTOL = 1e-5
T, D, NP = 8, 16, 64


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _geometry(PT, seed=0):
    """pc [PT, T, D] sorted along d (as the projectors' coordinates are), a
    third of each row below 0 or above Np - 1, and s [PT, T, 1]."""
    rng = np.random.default_rng(seed)
    pc = np.sort(rng.uniform(-3.0, NP + 2.0, (PT, T, D)), axis=-1)
    pc[:, ::2] = pc[:, ::2, ::-1]  # every other row falls along d
    s = rng.uniform(0.5, 1.5, (PT, T, 1))
    return pc.astype(np.float32), s.astype(np.float32)


def _jax_batched(fn, x, PB, PT):
    """fn over PB images against PT geometry sets, as the JAX package runs
    it: directly when PB = PT, else vmapped over PB // PT groups."""
    if PB == PT:
        return np.asarray(fn(x))
    out = jax.vmap(fn)(x.reshape((PB // PT, PT) + x.shape[1:]))
    return np.asarray(out).reshape((PB,) + out.shape[2:])


BATCHES = [(2, 2), (6, 2)]


@pytest.mark.parametrize("batch", BATCHES, ids=["PB2PT2", "PB6PT2"])
def test_hat_eval_matches_jax(batch):
    PB, PT = batch
    pc, s = _geometry(PT)
    g = np.random.default_rng(1).standard_normal((PB, T, NP)).astype(
        np.float32)
    want = _jax_batched(
        lambda a: jhe.hat_eval(a, jnp.asarray(pc), jnp.asarray(s)),
        jnp.asarray(g), PB, PT)
    got = the.hat_eval(torch.as_tensor(g), torch.as_tensor(pc),
                       torch.as_tensor(s))
    assert got.shape == (PB, T, D)
    _close(got, want)
    if PB == PT:
        _close(got, jhe.hat_eval_reference(jnp.asarray(g), jnp.asarray(pc),
                                           jnp.asarray(s)))


@pytest.mark.parametrize("batch", BATCHES, ids=["PB2PT2", "PB6PT2"])
def test_hat_eval_t_matches_jax(batch):
    PB, PT = batch
    pc, s = _geometry(PT)
    ob = np.random.default_rng(2).standard_normal((PB, T, D)).astype(
        np.float32)
    want = _jax_batched(
        lambda a: jhe.hat_eval_t(a, jnp.asarray(pc), jnp.asarray(s),
                                 jnp.zeros((NP,))),
        jnp.asarray(ob), PB, PT)
    got = the.hat_eval_t(torch.as_tensor(ob), torch.as_tensor(pc),
                         torch.as_tensor(s), NP)
    assert got.shape == (PB, T, NP)
    _close(got, want)


def test_hat_pair_is_a_transpose():
    pc, s = _geometry(2, seed=3)
    gen = torch.Generator().manual_seed(4)
    g = torch.randn((6, T, NP), generator=gen, dtype=torch.float64)
    ob = torch.randn((6, T, D), generator=gen, dtype=torch.float64)
    pct, st = torch.as_tensor(pc), torch.as_tensor(s)
    lhs = float((the.hat_eval(g.float(), pct, st).double() * ob).sum())
    rhs = float((g * the.hat_eval_t(ob.float(), pct, st, NP).double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_hat_cpu_path_counts_no_launch():
    pc, s = _geometry(1)
    pct, st = torch.as_tensor(pc), torch.as_tensor(s)
    the.reset_launch_counts()
    the.hat_eval(torch.zeros((2, T, NP)), pct, st)
    the.hat_eval_t(torch.zeros((2, T, D)), pct, st, NP)
    assert the.launch_counts() == {"hat_eval": 0, "hat_eval_t": 0}


def test_hat_rejects_a_geometry_batch_that_does_not_divide():
    pc, s = _geometry(2)
    with pytest.raises(ValueError):  # 3 images, 2 geometry sets
        the.hat_eval(torch.zeros((3, T, NP)), torch.as_tensor(pc),
                     torch.as_tensor(s))


# ---------------------------------------------------------------------------
# The eval tail's kernel branch
# ---------------------------------------------------------------------------


def _tables(N=32, P=3, angles_total=30):
    geo = tcfg.GeometryConfig(N=N, num_nodes=P, angles_total=angles_total)
    a, v, _ = tradon.node_angles(geo)
    tt = tfft.precompute_merged_nodes(
        geo, torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v))
    # The JAX tail reads p, s and the irfft matrices: give it the port's.
    tj = {k: jnp.asarray(tt[k].numpy()) for k in ("p", "s", "Cre", "Cim")}
    return geo, tt, tj


def _spectra(tt, seed=0):
    P, T_, _ = tt["p"].shape
    F = tt["Cre"].shape[1]
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, P, T_, F)).astype(np.float32)


@pytest.fixture
def kernel_branch(monkeypatch):
    """The eval tail as it runs past the threshold."""
    monkeypatch.setattr(tfft, "_HAT_MAX_BYTES", 0)


def test_tail_threshold_rule():
    _, tt, _ = _tables()
    assert not tfft._hat_on_the_fly(tt)  # 3 * 10 * 32 * 128 * 4 bytes


def test_eval_tail_kernel_branch_matches_jax(kernel_branch):
    _, tt, tj = _tables()
    assert tfft._hat_on_the_fly(tt)
    g = _spectra(tt)
    got = tfft._eval_tail(torch.as_tensor(g[0]), torch.as_tensor(g[1]), tt,
                          torch.float32)
    # JAX's tail at this size takes its materialized branch ...
    want = jfft._eval_tail(jnp.asarray(g[0]), jnp.asarray(g[1]), tj,
                           jnp.float32)
    _close(got, want)
    # ... and its kernel, on the same profile, gives the same.
    prof = jfft._ein32("ptf,pfv->ptv", jnp.asarray(g[0]), tj["Cre"]) \
        + jfft._ein32("ptf,pfv->ptv", jnp.asarray(g[1]), tj["Cim"])
    _close(got, jhe.hat_eval(prof, tj["p"], tj["s"][..., None]))


def test_eval_tail_t_kernel_branch_matches_jax(kernel_branch):
    _, tt, tj = _tables()
    P, T_, D_ = tt["p"].shape
    ob = np.random.default_rng(1).standard_normal((P, T_, D_)).astype(
        np.float32)
    got = tfft._eval_tail_t(torch.as_tensor(ob), tt)
    want = jfft._eval_tail_t(jnp.asarray(ob), tj)
    for a, w in zip(got, want):
        _close(a, w)


@pytest.mark.parametrize("mode", ["merged", "grouped"])
def test_operators_through_kernel_branch_match_materialized(mode,
                                                            monkeypatch):
    """The fft_pallas and fft_grouped pairs give the same operator through
    either tail."""
    geo, _, _ = _tables()
    a, v, _ = tradon.node_angles(geo)
    at, vt = torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v)
    pre = (tfft.precompute_merged_nodes if mode == "merged"
           else tfft.precompute_grouped)
    t = pre(geo, at, vt)
    fwd = getattr(tfft, f"project_nodes_{mode}")
    adj = getattr(tfft, f"backproject_nodes_{mode}")
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((3, 32, 32)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((3, 10, 32)).astype(np.float32))
    want = fwd(geo, x, t), adj(geo, y, t)
    monkeypatch.setattr(tfft, "_HAT_MAX_BYTES", 0)
    got = fwd(geo, x, t), adj(geo, y, t)
    for g_, w in zip(got, want):
        _close(g_, w.numpy())


# ---------------------------------------------------------------------------
# The algebra of K18's kernel (boundary tables), mirrored in numpy and held
# to the JAX package's kernel in interpret mode.


def _boundary_ranges(x, Np):
    """K18's ranges of one row x [D] (f32): for a monotone row the boundary
    tables lo, hi [Np] (boundary d in [0, D], between detectors d - 1 and
    d, writes lo[v] = d for the v with x[d-1] <= v - 1 < x[d] on a rising
    row, and likewise hi, over the row's span [vs, ve) only), else None.
    Returns (lo, hi, vs, ve)."""
    D = x.shape[0]
    rising = bool(np.all(x[1:] >= x[:-1]))
    if not (rising or np.all(x[1:] <= x[:-1])):
        return None, None, 0, Np
    c = np.clip(x, -4.0, Np + 4.0)
    mn, mx = (c[0], c[-1]) if rising else (c[-1], c[0])
    vs, ve = max(0, int(np.floor(mn)) - 1), min(Np, int(np.ceil(mx)) + 2)
    lo = np.full(Np, -1)
    hi = np.full(Np, -1)
    for d in range(D + 1):
        a, e = (c[d - 1] if d > 0 else None), (c[d] if d < D else None)
        if rising:
            l0 = vs if a is None else int(np.ceil(a)) + 1
            l1 = ve if e is None else int(np.ceil(e)) + 1
            h0 = vs if a is None else int(np.floor(a))
            h1 = ve if e is None else int(np.floor(e))
        else:
            l0 = vs if e is None else int(np.floor(e))
            l1 = ve if a is None else int(np.floor(a))
            h0 = vs if e is None else int(np.ceil(e)) + 1
            h1 = ve if a is None else int(np.ceil(a)) + 1
        for v in range(max(l0, vs), min(l1, ve)):
            assert lo[v] == -1  # each v is written by one boundary
            lo[v] = d
        for v in range(max(h0, vs), min(h1, ve)):
            assert hi[v] == -1
            hi[v] = d
    assert (lo[vs:ve] >= 0).all() and (hi[vs:ve] >= 0).all()
    return lo, hi, vs, ve


def _k18_mirror(ob, pc, s, Np):
    """K18 as its kernel computes it: each v of a row sums the terms
    w = 1 - |pc - v| > 0 of its boundary-table range (every d on a row that
    is not monotone) in ascending d, in f32; zero outside the row's span.
    A row holding a NaN coordinate is NaN at every v."""
    PT, T, D = pc.shape
    PB = ob.shape[0]
    out = np.zeros((PB, T, Np), np.float32)
    for p in range(PB):
        for t in range(T):
            x = pc[p % PT, t]
            y = (s[p % PT, t, 0] * ob[p, t]).astype(np.float32)
            if np.isnan(x).any():
                out[p, t] = np.nan
                continue
            lo, hi, vs, ve = _boundary_ranges(x, Np)
            for v in range(vs, ve):
                d0, d1 = (0, D) if lo is None else (lo[v], hi[v])
                acc = np.float32(0.0)
                for d in range(d0, d1):
                    w = np.float32(1.0) - np.abs(x[d] - np.float32(v))
                    if w > 0:
                        acc = np.float32(acc + w * y[d])
                out[p, t, v] = acc
    return out


def _rows_of_every_kind(PT, integer, seed=9):
    """pc [PT, T, D]: rising, falling and (row 1) not monotone rows, a third
    of each below 0 or above Np - 1; integer-valued when ``integer``."""
    pc, s = _geometry(PT, seed)
    rng = np.random.default_rng(seed + 1)
    pc[:, 1] = pc[:, 1, rng.permutation(D)]
    if integer:
        pc = np.round(pc)
    return pc.astype(np.float32), s


@pytest.mark.parametrize("integer", [False, True], ids=["real", "integer"])
@pytest.mark.parametrize("batch", BATCHES, ids=["PB2PT2", "PB6PT2"])
def test_k18_boundary_tables_match_jax(batch, integer):
    """The mirror of K18's boundary-table kernel against JAX's
    interpret-mode ``hat_eval_t`` (1e-5 of the output's max: f32 on both
    sides, other sum order), and its ranges against the binary searches of
    the first CUDA design (first d with pc > v - 1, first with
    pc >= v + 1 on a rising row), which it replaces term for term."""
    PB, PT = batch
    pc, s = _rows_of_every_kind(PT, integer)
    ob = np.random.default_rng(3).standard_normal((PB, T, D)).astype(
        np.float32)
    want = _jax_batched(
        lambda a: jhe.hat_eval_t(a, jnp.asarray(pc), jnp.asarray(s),
                                 jnp.zeros((NP,))),
        jnp.asarray(ob), PB, PT)
    _close(_k18_mirror(ob, pc, s, NP), want)
    kinds = set()
    for x in pc.reshape(-1, D):
        lo, hi, vs, ve = _boundary_ranges(x, NP)
        if lo is None:
            kinds.add("other")
            continue
        rising = bool(np.all(x[1:] >= x[:-1]))
        kinds.add("rising" if rising else "falling")
        for v in range(vs, ve):
            fv = np.float32(v)
            first = (x > fv - 1, x >= fv + 1) if rising else (x < fv + 1,
                                                              x <= fv - 1)
            a, b = (int(np.argmax(q)) if q.any() else D for q in first)
            assert (lo[v], hi[v]) == (a, b), (v, lo[v], hi[v], a, b)
    assert kinds == {"rising", "falling", "other"}


@pytest.mark.parametrize("batch", BATCHES, ids=["PB2PT2", "PB6PT2"])
def test_k18_mirror_nan_rows_match_jax(batch):
    """A NaN coordinate in a row: JAX's ``hat_eval_t`` in interpret mode is
    NaN at every v of that row (each v takes a NaN term), and so is the
    mirror of K18; the other rows hold to JAX at 1e-5 of the max."""
    PB, PT = batch
    pc, s = _rows_of_every_kind(PT, False)
    pc[:, 2, 5] = np.nan
    pc[0, 4, 0] = np.nan
    ob = np.random.default_rng(3).standard_normal((PB, T, D)).astype(
        np.float32)
    want = _jax_batched(
        lambda a: jhe.hat_eval_t(a, jnp.asarray(pc), jnp.asarray(s),
                                 jnp.zeros((NP,))),
        jnp.asarray(ob), PB, PT)
    got = _k18_mirror(ob, pc, s, NP)
    rows = np.tile(np.isnan(pc).any(-1), (PB // PT, 1))  # [PB, T]
    assert np.isnan(want[rows]).all() and np.isnan(got[rows]).all()
    assert not np.isnan(want[~rows]).any() and not np.isnan(got[~rows]).any()
    _close(got[~rows], want[~rows])


def _k17_mirror(g, pc, s):
    """numpy mirror of the card kernel K17 (``csrc/hat_eval.cu``): one
    thread for four consecutive detectors of one (p, t) row, the last four
    of a row ragged where D % 4 != 0; each detector takes v0 = floor(pc),
    the taps v0 and v0 + 1 inside [0, Np) in that order with the hat in
    f32, and s after the sum. A NaN coordinate gives NaN."""
    PB, T, Np = g.shape
    PT, _, D = pc.shape
    out = np.full((PB, T, D), np.nan, np.float32)
    rows = np.arange(T)
    for p in range(PB):
        q = p % PT
        for quad in range(-(-D // 4)):
            for d in range(4 * quad, min(4 * quad + 4, D)):
                x = pc[q, :, d]
                fl = np.floor(x)
                ok = (fl >= -1) & (fl < Np)
                v0 = np.where(ok, fl, 0).astype(np.int64)
                acc = np.zeros(T, np.float32)
                for k in (0, 1):
                    v = v0 + k
                    live = ok & (v >= 0) & (v < Np)
                    h = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(
                        x - v.astype(np.float32)))
                    acc = np.where(live, acc + h * g[p, rows,
                                                     np.clip(v, 0, Np - 1)],
                                   acc)
                out[p, :, d] = s[q, :, 0] * np.where(np.isnan(x), x, acc)
    return out


@pytest.mark.parametrize("batch", BATCHES, ids=["PB2PT2", "PB6PT2"])
def test_k17_four_detector_mirror_matches_jax(batch):
    """The mirror at D = 30 (a ragged last four), with coordinates below 0,
    above Np - 1 and NaN, against JAX's ``hat_eval`` in interpret mode at
    1e-5 of the output max. At a NaN coordinate JAX's kernel gives NaN (its
    hat is max(0, NaN)), and so do the card kernel and the mirror."""
    PB, PT = batch
    Dr = 30
    rng = np.random.default_rng(9)
    pc = np.sort(rng.uniform(-3.0, NP + 2.0, (PT, T, Dr)), axis=-1)
    pc[:, ::2] = pc[:, ::2, ::-1]
    pc[:, 1, 3::7] = np.nan
    pc = pc.astype(np.float32)
    assert (pc < 0).any() and (pc > NP - 1).any()
    s = rng.uniform(0.5, 1.5, (PT, T, 1)).astype(np.float32)
    g = rng.standard_normal((PB, T, NP)).astype(np.float32)
    got = _k17_mirror(g, pc, s)
    want = _jax_batched(
        lambda a: jhe.hat_eval(a, jnp.asarray(pc), jnp.asarray(s)),
        jnp.asarray(g), PB, PT)
    nan = np.isnan(np.tile(pc, (PB // PT, 1, 1)))
    assert np.isnan(want[nan]).all() and np.isnan(got[nan]).all()
    assert not np.isnan(got[~nan]).any()
    scale = np.abs(want[~nan]).max()
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=0,
                               atol=RTOL * scale)
