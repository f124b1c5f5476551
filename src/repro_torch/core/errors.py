"""The unified serving-error hierarchy (DESIGN.md Sec. 15).

Every typed failure the serving tier can hand a client derives from
one base, :class:`ServingError`, so a client that wants "anything the
serving tier sheds or strands" catches ONE type:

* :class:`Overloaded` — depth-based admission control: the target
  slot's bounded queue is full, the request was shed at submit.
* :class:`DeadlineUnmeetable` — SLO-aware admission control: the
  queue-wait estimate says the request cannot finish inside its
  ``slo_ms`` even if admitted, so it is shed up front.  A subclass of
  :class:`Overloaded` (both are load shedding).
* :class:`StrandedRequestError` — evict-under-flight: the request's
  slot was turned over between submit and pack, so serving it would
  hit the slot's NEW occupant; the request fails instead.

:class:`Overloaded` remains a ``RuntimeError`` and
:class:`StrandedRequestError` a ``ValueError``, so handlers that catch
those stdlib types keep working.  The same classes as
``repro.core.errors``, kept verbatim so both packages raise the same
shapes of error.
"""

from __future__ import annotations


class ServingError(Exception):
    """Base of every typed serving-tier failure (shed / strand).  The
    concrete subclasses keep their historical stdlib bases
    (``RuntimeError`` / ``ValueError``) so pre-hierarchy handlers keep
    catching them."""


class Overloaded(ServingError, RuntimeError):
    """Typed admission-control rejection: the target slot's bounded
    queue is full, so the request was SHED at submit time — never
    enqueued, never served."""


class DeadlineUnmeetable(Overloaded):
    """SLO-aware admission rejection: the queue-wait estimate says
    ``arrival + wait_estimate`` cannot meet ``slo_ms``, so serving the
    request would only burn capacity on a guaranteed SLO violation."""


class StrandedRequestError(ServingError, ValueError):
    """A queued request's factor slot was evicted (or turned over to a
    new occupant) after the request was accepted: serving it would
    silently solve against the WRONG factor, so it fails instead."""
