"""Comparisons for the port's parity tests, scaled to the values compared.

The factors of these tests are tril(randn) + n I, so a solve's X is
about B / n and an inverse's entries are about 1/n on the diagonal and
1/n^2 below it.  An absolute tolerance taken from tests of O(1) values
would pass a solve that skipped its trailing updates, or an inverse that
kept only its diagonal; these helpers scale it to what is compared.
"""

import numpy as np


def _f64(a):
    if hasattr(a, "detach"):                      # a torch tensor
        a = a.detach().double().cpu().numpy()
    return np.asarray(a, np.float64)


def assert_close(got, want, tol):
    """|got - want| <= tol * (|want| + max|want|), elementwise."""
    got, want = _f64(got), _f64(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def assert_inverse_close(got, want, tol):
    """``assert_close``, and the strictly lower parts within ``tol`` of
    their own largest entry: the off-diagonal levels of an inverse are
    orders of magnitude below its diagonal."""
    got, want = _f64(got), _f64(want)
    assert_close(got, want, tol)
    lower = np.abs(np.tril(want, -1)).max(initial=0.0)
    if lower > 0:
        err = np.abs(np.tril(got - want, -1)).max()
        assert err <= tol * lower, (f"strictly lower part off by "
                                    f"{err / lower:.3g} of its max > {tol}")
