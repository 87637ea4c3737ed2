"""The lean launch path's memoized checks (``ops/kernels/_launch.py``) on the
CPU: the checks of K5 and K17 behind ``_launch.Checked`` raise on a bad
input exactly as on a first call (same type, same message) after a good
signature was cached, a signature that differs from a cached one only in
its strides is checked afresh, and only a signature whose checks passed is
kept. Wrong-device inputs are ``meta`` tensors beside CPU ones."""

import pytest
import torch

from dip_admm_tpu_torch.ops.kernels import _launch
from dip_admm_tpu_torch.ops.kernels import consensus as cons
from dip_admm_tpu_torch.ops.kernels import hat_eval as he

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
}


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


