"""The plain reference of the b1000 MT19937-64 deployment: a seed's key
stream and the cascade it would match."""

from portbench.reference.mt import mask_target, mt64_keys


def cascade_of(seed: int, widths) -> list:
    """The cascade (bits, masked key) that ``seed``'s stream holds, key j
    under width j."""
    return [(bits, mask_target(k, bits)) for bits, k in zip(widths, mt64_keys(seed, len(widths)))]


def matches(seed: int, cascade) -> bool:
    """Whether ``seed``'s stream holds ``cascade``."""
    return cascade_of(seed, [bits for bits, _ in cascade]) == [tuple(t) for t in cascade]


def puzzle_cascade(cfg: dict) -> list:
    """The configuration's cascade: each solved key under its width's mask."""
    return [(bits, mask_target(int(key, 16).to_bytes(32, "big"), bits))
            for bits, key in cfg["cascade"]]
