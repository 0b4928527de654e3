"""The plain reference of the milksad deployment: a seed's key."""

from portbench.reference.mt import milksad_key


def keys(seed: int) -> list:
    """The keys a forward scan derives from ``seed``, slot by slot."""
    return [milksad_key(seed)]


def audit_key(seed: int) -> bytes:
    """The key an audit finds ``seed`` for."""
    return milksad_key(seed)
