"""The plain reference of the numeric brainwallet deployment: a number's
three keys, SHA-256 of its decimal string, of its 8 bytes big-endian and
of its 8 bytes little-endian."""

import hashlib


def keys(seed: int) -> list:
    """The keys a forward scan derives from ``seed``, slot by slot."""
    return [hashlib.sha256(str(seed).encode()).digest(),
            hashlib.sha256(seed.to_bytes(8, "big")).digest(),
            hashlib.sha256(seed.to_bytes(8, "little")).digest()]
