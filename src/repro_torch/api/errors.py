"""Build-time validation errors for the experiment facade (a copy of the
reference's ``api/errors.py``).

Every mis-specification surfaces before anything allocates, as a
:class:`SpecError` whose message names the offending field, the offending
value, and the fix.
"""
from __future__ import annotations


class SpecError(ValueError):
    """A spec string or :class:`~repro_torch.api.ExperimentSpec` field is
    invalid; the message says which one and how to fix it."""


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a part of the reference this slice of the port leaves
    out; ``item`` names its entry in ROADMAP.md."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet -- ROADMAP.md {item}"
    )
