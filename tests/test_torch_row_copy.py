"""The host-side checks of K13's and K11's wrappers (`append_rows.check_args`,
`concat_rows.check_parts`), on CPU tensors: what a launch would be given,
and every refusal the wrappers make before one, with its exception. The
wrappers apply them to CUDA tensors only; the kernels themselves run on
the card (chip_smoke.py phases 2e and 15). Tolerance: none, these are
exact shapes, counts and exception types."""

import pytest
import torch

from datafusion_parallelism_tpu_torch.kernels import append_rows as k13
from datafusion_parallelism_tpu_torch.kernels import concat_rows as k11


def _append_args(w=3, f=2, acc_cap=64, cap=16):
    return {"acc": torch.zeros((w, acc_cap), dtype=torch.int32),
            "acc_f64": torch.zeros((f, acc_cap), dtype=torch.float64),
            "acc_rows": torch.tensor(5, dtype=torch.int32),
            "words": torch.zeros((w, cap), dtype=torch.int32),
            "f64": torch.zeros((f, cap), dtype=torch.float64),
            "num_rows": torch.tensor(7, dtype=torch.int32)}


def test_append_rows_checks_pass_well_formed_arguments():
    assert k13.check_args(**_append_args()) == (3, 2, 64, 16, -1)
    assert k13.check_args(**_append_args(f=0, cap=0)) == (3, 0, 64, 0, -1)


@pytest.mark.parametrize("name, bad, error", [
    ("acc", torch.zeros((3, 64), dtype=torch.int64), TypeError),
    ("acc", torch.zeros(64, dtype=torch.int32), ValueError),
    ("acc_f64", torch.zeros((2, 63), dtype=torch.float64), ValueError),
    ("acc_f64", torch.zeros((2, 64), dtype=torch.float32), TypeError),
    ("acc_f64", torch.zeros((64, 2), dtype=torch.float64).t(), ValueError),
    ("acc_rows", torch.tensor([5], dtype=torch.int32), ValueError),
    ("acc_rows", torch.tensor(5, dtype=torch.int64), TypeError),
    ("words", torch.zeros((4, 16), dtype=torch.int32), ValueError),
    ("words", torch.zeros((16, 3), dtype=torch.int32).t(), ValueError),
    ("f64", torch.zeros((1, 16), dtype=torch.float64), ValueError),
    ("f64", torch.zeros((2, 17), dtype=torch.float64), ValueError),
    ("num_rows", torch.tensor(7, dtype=torch.int64), TypeError),
], ids=["acc int64", "acc 1-D", "acc_f64 short", "acc_f64 float32", "acc_f64 not contiguous",
        "acc_rows 1-D", "acc_rows int64", "words W", "words not contiguous", "f64 F",
        "f64 cap", "num_rows int64"])
def test_append_rows_checks_refuse(name, bad, error):
    args = _append_args()
    args[name] = bad
    with pytest.raises(error):
        k13.check_args(**args)


def _part(w=3, f=1, cap=10, n=4):
    return (torch.zeros((w, cap), dtype=torch.int32), torch.zeros((f, cap), dtype=torch.float64),
            torch.tensor(n, dtype=torch.int32))


def test_concat_rows_checks_pass_well_formed_parts():
    parts = [_part(cap=10), _part(cap=1), _part(cap=4097, n=0)]
    w, f, total_cap, spec, index = k11.check_parts(parts)
    assert (w, f, total_cap, index) == (3, 1, 4108, -1)
    m = k11.MAX_PARTS
    assert len(spec) == 1 + 4 * m and spec[0] == 3
    assert list(spec[1:1 + m]) == [p[0].data_ptr() for p in parts] + [0] * (m - 3)
    assert list(spec[1 + m:1 + 2 * m]) == [p[1].data_ptr() for p in parts] + [0] * (m - 3)
    assert list(spec[1 + 2 * m:1 + 3 * m]) == [10, 1, 4097] + [0] * (m - 3)
    assert list(spec[1 + 3 * m:]) == [p[2].data_ptr() for p in parts] + [0] * (m - 3)
    assert k11.check_parts([_part()] * k11.MAX_PARTS)[2] == 10 * k11.MAX_PARTS
    assert k11.check_parts([_part(f=0)])[:3] == (3, 0, 10)


def _bad_parts(case):
    p = _part()
    if case == "no parts":
        return []
    if case == "9 parts":
        return [p] * (k11.MAX_PARTS + 1)
    if case == "W differs":
        return [p, _part(w=4)]
    if case == "F differs":
        return [p, _part(f=2)]
    if case == "words int64":
        return [p, (p[0].long(), p[1], p[2])]
    if case == "float64 as float32":
        return [p, (p[0], p[1].float(), p[2])]
    if case == "num_rows 1-D":
        return [p, (p[0], p[1], p[2].reshape(1))]
    if case == "num_rows int64":
        return [p, (p[0], p[1], p[2].long())]
    if case == "words 1-D":
        return [p, (p[0][0], p[1], p[2])]
    if case == "words not contiguous":
        return [p, (torch.zeros((10, 3), dtype=torch.int32).t(), p[1], p[2])]
    if case == "cap differs between words and float64":
        return [p, (p[0], torch.zeros((1, 11), dtype=torch.float64), p[2])]
    # capacity 2^31 without memory: matrices of no rows
    empty = (torch.zeros((0, 1 << 30), dtype=torch.int32),
             torch.zeros((0, 1 << 30), dtype=torch.float64), p[2])
    return [empty, empty]


@pytest.mark.parametrize("case, error", [
    ("no parts", ValueError), ("9 parts", ValueError), ("W differs", ValueError),
    ("F differs", ValueError), ("words int64", TypeError), ("float64 as float32", TypeError),
    ("num_rows 1-D", ValueError), ("num_rows int64", TypeError), ("words 1-D", ValueError),
    ("words not contiguous", ValueError), ("cap differs between words and float64", ValueError),
    ("capacity 2^31", ValueError)])
def test_concat_rows_checks_refuse(case, error):
    with pytest.raises(error):
        k11.check_parts(_bad_parts(case))
