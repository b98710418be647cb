"""Verification errors (reference src/verifier.rs:176-192, src/lib.rs:19-38)."""

from __future__ import annotations


class VerificationError(Exception):
    """Raised by verifiers on any proof defect.  `kind` mirrors the
    reference's VerificationError variants."""

    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        self.detail = detail
        super().__init__(f"{kind}: {detail}" if detail else kind)


def ensure(cond: bool, kind: str, detail: str = "") -> None:
    """ensure! — check-or-raise with context (reference src/lib.rs:19-31)."""
    if not cond:
        raise VerificationError(kind, detail)
