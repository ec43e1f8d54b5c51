"""Shared comparison for the PyTorch port's parity tests (tests/test_torch_*.py).

The port's tests feed one numpy input, made from a seed or parsed from
tests/data, to a JAX function and to its port on the CPU, and compare the
outputs with :func:`assert_parity`.  The tests below check that the
comparison fails where it must.
"""

import numpy as np
import pytest
import torch

#: The port's entry points run on "cuda" unless told otherwise; its CPU
#: tests name the CPU explicitly.
DEVICE = "cpu"


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_parity(ref, out, atol, name=""):
    """Bool arrays bitwise; float arrays with identical NaN patterns and
    ``|ref - out| <= atol`` elsewhere; shapes equal."""
    r, o = as_numpy(ref), as_numpy(out)
    assert r.shape == o.shape, (name, r.shape, o.shape)
    if r.dtype == bool or o.dtype == bool:
        assert r.dtype == o.dtype, (name, r.dtype, o.dtype)
        np.testing.assert_array_equal(r, o, err_msg=name)
        return
    np.testing.assert_array_equal(np.isnan(r), np.isnan(o), err_msg=f"{name}: NaN pattern")
    ok = ~np.isnan(r)
    np.testing.assert_allclose(o[ok], r[ok], rtol=0, atol=atol, err_msg=name)


def _ref():
    return np.array([[0.0, 1.0], [np.nan, -2.5]], np.float32)


@pytest.mark.parametrize("case", ["value", "nan_pattern", "shape", "mask", "mask_dtype"])
def test_assert_parity_rejects(case):
    ref, out = _ref(), torch.from_numpy(_ref())
    if case == "value":
        out[0, 1] += 2e-5
    elif case == "nan_pattern":
        out[1, 0] = 0.0
    elif case == "shape":
        out = out[:1]
    elif case == "mask":
        ref, out = np.array([True, False]), torch.tensor([True, True])
    else:
        ref, out = np.array([True, False]), torch.tensor([1, 0])
    with pytest.raises(AssertionError):
        assert_parity(ref, out, 1e-5, case)


def test_assert_parity_accepts_within_tolerance():
    out = torch.from_numpy(_ref())
    out[0, 1] += 5e-6
    assert_parity(_ref(), out, 1e-5)
    assert_parity(np.array([True, False]), torch.tensor([True, False]), 0)
