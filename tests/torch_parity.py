"""Comparisons for the port's parity tests, scaled to the values compared.

The factors of these tests are tril(randn) + n I, so a solve's X is
about B / n and an inverse's entries are about 1/n on the diagonal and
1/n^2 below it.  An absolute tolerance taken from tests of O(1) values
would pass a solve that skipped its trailing updates, or an inverse that
kept only its diagonal; these helpers scale it to what is compared.
``FairQueuePair`` drives the two packages' serving queues alike.
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


class FairQueuePair:
    """A port ``FairQueue`` and a reference ``FairQueue`` driven alike.
    Every ``pack`` returns the port's wave after asserting that the
    reference packed the same requests with the same virtual-finish
    stamps and deadlines, and left the same virtual clocks."""

    def __init__(self, *args, **kw):
        from repro.core import serving as jserving
        from repro_torch.core import serving
        self.fqs = (serving.FairQueue(*args, **kw),
                    jserving.FairQueue(*args, **kw))
        self._reqs = (serving._Request, jserving._Request)

    def push(self, seq, tenant="t", width=1, deadline=None, **kw):
        for fq, R in zip(self.fqs, self._reqs):
            fq.push(R(seq=seq, b=None, width=width, tenant=tenant, key=0,
                      gen=0, order=32, future=None, deadline=deadline),
                    **kw)

    def pack(self) -> list:
        waves = [fq.pack() for fq in self.fqs]
        assert [(r.seq, r.vtag, r.deadline) for r in waves[0]] \
            == [(r.seq, r.vtag, r.deadline) for r in waves[1]]
        assert (self.fqs[0]._vclock, self.fqs[0]._vt) \
            == (self.fqs[1]._vclock, self.fqs[1]._vt)
        return waves[0]

    def set_weight(self, tenant, w):
        for fq in self.fqs:
            fq.set_weight(tenant, w)

    def pop_if(self, pred) -> list:
        hits = [fq.pop_if(pred) for fq in self.fqs]
        assert [r.seq for r in hits[0]] == [r.seq for r in hits[1]]
        return hits[0]

    def __len__(self):
        assert len(self.fqs[0]) == len(self.fqs[1])
        return len(self.fqs[0])
