"""The port's host assignment solver, ``ops/native.py::lsap_solve`` (the
JAX package's ``native/lsap.cpp``, copied into the port's native library),
against ``scipy.optimize.linear_sum_assignment`` and against K5's plain
version, on square and rectangular seeded costs (no ties: the solvers
break ties differently)."""
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from polyphonicformer_torch.ops import native
from polyphonicformer_torch.ops.cuda.lsa import solve_lsa_plain


@pytest.mark.parametrize("rows,cols", [(1, 1), (7, 7), (12, 12), (5, 13), (24, 100), (64, 100)])
def test_lsap_matches_scipy_and_k5(rows, cols):
    rng = np.random.RandomState(rows * 1000 + cols)
    for _ in range(3):
        cost = (rng.randn(rows, cols) * 2).astype(np.float32)
        got = native.lsap_solve(cost)
        r, c = linear_sum_assignment(cost)
        assert got.dtype == np.int32 and got.shape == (rows,)
        np.testing.assert_array_equal(r, np.arange(rows))
        np.testing.assert_array_equal(got, c)
        k5 = solve_lsa_plain(torch.from_numpy(cost)[None], torch.ones((1, rows), dtype=torch.bool))
        np.testing.assert_array_equal(got, k5[0].numpy())


def test_lsap_transposed_input_and_errors():
    cost = np.random.RandomState(0).randn(9, 4).astype(np.float32).T  # a strided view
    np.testing.assert_array_equal(native.lsap_solve(cost), linear_sum_assignment(cost)[1])
    for bad in (np.zeros((3, 2), np.float32), np.zeros((0, 4), np.float32),
                np.zeros((2, 2, 2), np.float32)):
        with pytest.raises(ValueError):
            native.lsap_solve(bad)
