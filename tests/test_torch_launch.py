"""The launch path of every kernel wrapper (``ops/kernels/_launch.py``) on
the CPU: the checks of every wrapper (K1-K18 and the fused Condat-Vu step)
behind ``_launch.Checked`` raise on a bad input exactly as on a first call
(same type, same message) after a good signature was cached, a signature
that differs from a cached one only in its strides is checked afresh, and
only a signature whose checks passed is kept; a tensor whose address fails
a wrapper's alignment test raises though its metadata was cached; every
bound entry names a C entry of its library, and only ``_launch.py`` loads a
library. Wrong-device inputs are ``meta`` tensors beside CPU ones."""

import ast
import pathlib

import pytest
import torch

from dip_admm_tpu_torch.ops.kernels import _build, _launch
from dip_admm_tpu_torch.ops.kernels import consensus as cons
from dip_admm_tpu_torch.ops.kernels import cv_step as cv
from dip_admm_tpu_torch.ops.kernels import filter_mxu as fm
from dip_admm_tpu_torch.ops.kernels import filter_sum as fs
from dip_admm_tpu_torch.ops.kernels import hat_eval as he
from dip_admm_tpu_torch.ops.kernels import shear_sum as ss

P, N = 4, 64
PT, T, D, NP = 2, 6, 12, 32


def _cons_args():
    gen = torch.Generator().manual_seed(0)
    a, y, z = (torch.randn((P, P, N), generator=gen) for _ in range(3))
    adjm = torch.ones((P, P))
    w = torch.rand((P, N), generator=gen) + 0.1
    return [a, y, z, adjm, w, "weighted", None, None, None]


def _hat_args():
    gen = torch.Generator().manual_seed(1)
    g = torch.randn((2 * PT, T, NP), generator=gen)
    pc = torch.rand((PT, T, D), generator=gen) * NP
    s = torch.rand((PT, T, 1), generator=gen)
    return [g, pc, s]


def _cv_args():
    gen = torch.Generator().manual_seed(2)
    x, adj, D, bc = (torch.randn((P, N * N), generator=gen) for _ in range(4))
    ux, uy = (torch.randn((P, N, N), generator=gen) for _ in range(2))
    return [x, ux, uy, adj, D, bc]


# The projector kernels' arguments: an image batch of PB over a table batch
# of PT, NB row blocks of nb rows, Tp angles in TB blocks, F frequencies.
PB, NB, nb, Tp, TB, F = 4, 2, 2, 4, 2, 5


def _z(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def _plane():
    return torch.zeros((PT, TB), dtype=torch.int32)


def _skew_fwd_args():  # K1: WS + D2 - 1 <= WZ
    return [_z(PB, 2, NB * nb, 4), _z(PT, NB, 3, Tp, nb), _z(PT, NB, Tp, F),
            _z(PT, NB, Tp, F), _z(8, F), _z(8, F), _plane()]


def _skew_t_args(name, WS):  # K2 at WS = NB * nb, K6 wider
    return lambda: [name, _z(PB, Tp, F), _z(PB, Tp, F), _z(PT, NB, 3, Tp, nb),
                    _z(PT, NB, Tp, F), _z(PT, NB, Tp, F), _z(F, 8), _z(F, 8),
                    _plane(), WS]


def _eval_args(fwd):  # K3 (gre, gim) or K4 (ob); D2p = 16, DB = 2, db = 3
    def args():
        images = ([_z(PB, Tp, F), _z(PB, Tp, F)] if fwd else
                  [_z(PB, Tp, 2 * 3)])
        return ["eval_shear" if fwd else "eval_shear_t",
                _z(PT, 2, Tp, 16, 3), _z(PT, 2, Tp, F), _z(PT, 2, Tp, F),
                _z(16, F), _z(16, F), *images]
    return args


# The image-side pair of K7-K14 by name, as each wrapper names it.
NAMES = {
    "shear_sum_planes": ("rre2", "rim2"), "shear_sum": ("rre_s", "rim_s"),
    "filter_sum_sel": ("rre2", "rim2"), "filter_sum_grouped": ("rre_s",
                                                               "rim_s"),
    **{k: ("gre_b", "gim_b") for k in ("shear_sum_planes_t", "shear_sum_t",
                                       "filter_sum_sel_t",
                                       "filter_sum_grouped_t")},
}


def _shear_args(name, bf16=False):  # K7-K10; bf16 tables: D2 = 16, nb = 8
    fwd = name in ("shear_sum_planes", "shear_sum")
    planes = name.startswith("shear_sum_planes")
    D2, n = (16, 8) if bf16 else (3, nb)
    rows = (PB, 2 if planes else TB, NB * n, F)
    tables = torch.bfloat16 if bf16 else torch.float32

    def args():
        a, b = (_z(*(rows if fwd else (PB, Tp, F))) for _ in range(2))
        return [name, fwd, NAMES[name], a, b,
                _z(PT, NB, Tp, D2, n, dtype=tables), _z(PT, NB, Tp, F),
                _z(PT, NB, Tp, F), _z(D2, F), _z(D2, F),
                _plane() if planes else None, None if planes else TB]
    return args


def _pitched(*shape):
    return fs.pitched_zeros(shape, torch.float32, "cpu")


def _streams_args(name):  # K11-K14: pitched rows, N = 3
    fwd = not name.endswith("_t")
    sel = "_sel" in name
    blocks = 2 if sel else TB
    names = NAMES[name] + (("Hre", "Him") if sel else ("Hre_g", "Him_g"))

    def args():
        a, b = (_pitched(*((PB, blocks, 3, F) if fwd else (PB, Tp, F)))
                for _ in range(2))
        return [name, fwd, names, a, b, _pitched(PT, Tp, 3, F),
                _pitched(PT, Tp, 3, F), _z(PT, Tp, 1) if sel else None,
                blocks]
    return args


def _mxu_args(fwd):  # K15/K16: one tile of 128 frequencies, N = NB
    def args():
        a, b = (_z(*((PB, TB, NB, 128) if fwd else (PB, Tp, 128)))
                for _ in range(2))
        return ["filter_sum_mxu" if fwd else "filter_sum_mxu_t", fwd,
                ("rre", "rim") if fwd else ("gre_b", "gim_b"), a, b,
                _z(PT, 1, NB, Tp, 128), _z(PT, 1, NB, Tp, 128), TB]
    return args


def _restrided(x):
    """``x``'s values in a tensor of the same shape whose strides differ
    (the last two dims swapped in memory): not contiguous."""
    return x.transpose(-1, -2).contiguous().transpose(-1, -2)


# (check, good arguments, index of the argument to replace, bad value)
CASES = {
    "k5-dtype": (cons._check_update, _cons_args, 0,
                 lambda x: x.double()),
    "k5-noncontiguous": (cons._check_update, _cons_args, 0,
                         lambda x: x.transpose(0, 1)),
    "k5-shape": (cons._check_update, _cons_args, 1,
                 lambda x: x[:, :, :N // 2].contiguous()),
    "k5-weights-shape": (cons._check_update, _cons_args, 4,
                         lambda x: x[:, :N // 2].contiguous()),
    "k5-device": (cons._check_update, _cons_args, 3,
                  lambda x: x.to("meta")),
    "k5-stride-changed": (cons._check_update, _cons_args, 2, _restrided),
    "k17-dtype": (he._check_fwd, _hat_args, 0, lambda x: x.double()),
    "k17-batch": (he._check_fwd, _hat_args, 0, lambda x: x[:3].contiguous()),
    "k17-s-shape": (he._check_fwd, _hat_args, 2,
                    lambda x: x[:, :4].contiguous()),
    "k17-device": (he._check_fwd, _hat_args, 1, lambda x: x.to("meta")),
    "k17-stride-changed": (he._check_fwd, _hat_args, 0, _restrided),
    "cv-step-shape": (cv._check_step, _cv_args, 1,
                      lambda x: x[:, :N // 2].contiguous()),
    "cv-step-device": (cv._check_step, _cv_args, 4, lambda x: x.to("meta")),
    "cv-step-noncontiguous": (cv._check_step, _cv_args, 2,
                              lambda x: x.transpose(1, 2)),
}

# The projector kernels' checks: (check, good arguments, index of an
# image-side tensor, of a second tensor, of a table), each case of CASES on
# one of them.
PROJECTOR_CHECKS = {
    "k1": (ss._check_skew_fwd, _skew_fwd_args, 0, 5, 1),
    "k2": (ss._check_skew_t, _skew_t_args("skew_sum_planes_t", NB * nb), 1,
           2, 3),
    "k6": (ss._check_skew_t, _skew_t_args("skew_sum_planes_t_rows", 6), 1,
           2, 3),
    "k3": (ss._check_eval, _eval_args(True), 6, 7, 1),
    "k4": (ss._check_eval, _eval_args(False), 6, 3, 1),
    "k7": (ss._check_shear, _shear_args("shear_sum_planes"), 3, 4, 5),
    "k8": (ss._check_shear, _shear_args("shear_sum_planes_t"), 3, 4, 5),
    "k9": (ss._check_shear, _shear_args("shear_sum"), 3, 4, 5),
    "k10": (ss._check_shear, _shear_args("shear_sum_t"), 3, 4, 5),
    "k11": (fs._check_streams, _streams_args("filter_sum_sel"), 3, 4, 5),
    "k12": (fs._check_streams, _streams_args("filter_sum_sel_t"), 3, 4, 5),
    "k13": (fs._check_streams, _streams_args("filter_sum_grouped"), 3, 4, 5),
    "k14": (fs._check_streams, _streams_args("filter_sum_grouped_t"), 3, 4,
            5),
    "k15": (fm._check_tiled, _mxu_args(True), 3, 4, 5),
    "k16": (fm._check_tiled, _mxu_args(False), 3, 4, 5),
}
for _k, (_c, _good, _a, _b, _t) in PROJECTOR_CHECKS.items():
    CASES[f"{_k}-dtype"] = (_c, _good, _a, lambda x: x.double())
    CASES[f"{_k}-shape"] = (_c, _good, _b, lambda x: x[:-1])
    CASES[f"{_k}-noncontiguous"] = (_c, _good, _a, _restrided)
    CASES[f"{_k}-device"] = (_c, _good, _t, lambda x: x.to("meta"))


def _raised(fn, *args):
    with pytest.raises((TypeError, ValueError)) as e:
        fn(*args)
    return type(e.value), str(e.value)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_bad_input_raises_the_same_before_and_after_a_cached_one(case):
    check, good, k, bad = CASES[case]
    args = good()
    worse = list(args)
    worse[k] = bad(args[k])
    first = _raised(_launch.Checked(check), *worse)
    memo = _launch.Checked(check)
    ok = memo(*args)
    assert len(memo) == 1 and memo(*args) == ok
    assert _raised(memo, *worse) == first
    assert _raised(memo, *worse) == first  # never cached
    assert len(memo) == 1


def test_a_cached_signature_returns_the_checks_result_without_them():
    calls = []

    def check(*args):
        calls.append(1)
        return cons._check_update(*args)

    memo = _launch.Checked(check)
    args = _cons_args()
    assert memo(*args) == (P, P, N)
    fresh = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
    assert memo(*fresh) == (P, P, N)  # other tensors, same metadata
    assert len(calls) == 1
    fresh[5] = "midpoint"  # another argument: checked afresh
    assert memo(*fresh) == (P, P, N) and len(calls) == 2


def test_the_memo_is_bounded(monkeypatch):
    monkeypatch.setattr(_launch, "MEMO_LIMIT", 3)
    memo = _launch.Checked(lambda x: x.shape[0])
    for n in range(1, 8):
        assert memo(torch.zeros(n)) == n
        assert len(memo) <= 3




def _misaligned(x):
    """A tensor with ``x``'s shape, strides, dtype and device (its
    signature) that starts 4 bytes past ``x``'s alignment."""
    off = 4 // x.element_size()
    buf = torch.zeros(x.untyped_storage().nbytes() // x.element_size() + 16,
                      dtype=x.dtype)
    return buf.as_strided(x.shape, x.stride(), x.storage_offset() + off)


# (a wrapper's Checked, its good arguments, the index of the tensor whose
# address it tests)
ALIGNED = {
    "k3-Wd": (ss._eval_checks, _eval_args(True), 1),
    "k4-Wd": (ss._eval_checks, _eval_args(False), 1),
    "k7-bf16-Wt": (ss._shear_checks, _shear_args("shear_sum_planes", True),
                   5),
    "k11-rows": (fs._checks, _streams_args("filter_sum_sel"), 3),
    "k12-rows": (fs._checks, _streams_args("filter_sum_sel_t"), 3),
    "k15-table": (fm._checks, _mxu_args(True), 5),
}


@pytest.mark.parametrize("case", sorted(ALIGNED))
def test_a_misaligned_tensor_raises_after_its_signature_was_cached(
        case, monkeypatch):
    # K7's bf16 checks query the library for the scratch's size.
    monkeypatch.setattr(ss._SHEAR_SCRATCH, "_c", lambda *args: 64)
    memo, good, k = ALIGNED[case]
    args = good()
    ok = memo(*args)
    bad = list(args)
    bad[k] = _misaligned(args[k])
    assert bad[k].data_ptr() % 16 == 4 and args[k].data_ptr() % 16 == 0
    assert list(map(_launch._meta, bad)) == list(map(_launch._meta, args))
    for _ in range(2):
        with pytest.raises(ValueError, match="16-byte aligned"):
            memo(*bad)
        assert memo(*args) == ok


KERNELS = pathlib.Path(_launch.__file__).parent
WRAPPER_MODULES = (cons, cv, fm, fs, he, ss)


@pytest.mark.parametrize("module", WRAPPER_MODULES,
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_the_bound_entries_are_the_c_entries_of_the_library(module):
    library = module.__name__.rsplit(".", 1)[1]
    fns = {v.fn for v in vars(module).values()
           if isinstance(v, _launch.Entry) and v.library == library}
    assert fns == set(_build.SIGNATURES[library])
    assert all(v.library == library for v in vars(module).values()
               if isinstance(v, _launch.Entry))


@pytest.mark.parametrize("path", sorted(KERNELS.glob("*.py")),
                         ids=lambda p: p.name)
def test_only_the_launch_path_loads_a_library(path):
    """``_build.load`` is called in ``_launch.py`` alone, which imports no
    wrapper module; no module takes a private name from a wrapper
    module."""
    src = path.read_text()
    assert ("_build.load(" in src) == (path.name == "_launch.py")
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import) and path.name == "_launch.py":
            assert [a.name for a in node.names] == ["torch"]
        if not isinstance(node, ast.ImportFrom) or not (
                node.module or "").startswith("dip_admm_tpu_torch.ops"):
            continue
        source = node.module.rsplit(".", 1)[1]
        names = [a.name for a in node.names]
        if path.name == "_launch.py":
            assert (node.module, names) == ("dip_admm_tpu_torch.ops.kernels",
                                            ["_build"])
        elif source not in ("kernels", "_launch"):
            assert not [n for n in names if n.startswith("_")], node.module
