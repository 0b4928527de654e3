"""Transform registry: the reference's ``name:variant:endian`` grammar.

The port's copy of ``vuke_tpu/transforms/registry.py::parse_transform``:
every name and alias it accepts, and every error message it raises, word
for word.  A spec bundles the display name that a hit prints
(``Transform: ...``), the numeric transform (a seed lattice) and, where
the JAX package gives one, the string transform (wordlist, stdin and file
sources, ``single``): direct, direct:str, sha256, double_sha256, md5 and
sha256_chain; the wallet transforms (armory, multibit, electrum[:change],
bitimage) are ``wallets.py``'s, as ``vuke_tpu/transforms/registry.py:69-80``
builds them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

from ..cores import lcg as lcg_core, sha256_chain as chain_core
from . import numeric, strings

_XS_ALIASES = {
    "64": "xorshift64", "xorshift64": "xorshift64",
    "128": "xorshift128", "xorshift128": "xorshift128",
    "128plus": "xorshift128+", "128+": "xorshift128+", "plus": "xorshift128+",
    "xorshift128+": "xorshift128+",
    "xoroshiro": "xoroshiro128**", "starstar": "xoroshiro128**",
    "xoroshiro128**": "xoroshiro128**", "xoroshiro128starstar": "xoroshiro128**",
}

_CHAIN_NAMES = {
    "iterated": "iterated",
    "indexed": "indexed:be",
    "counter": "counter",
}


@dataclass(frozen=True)
class TransformSpec:
    name: str                                      # display name (Transform::name)
    numeric: Optional[numeric.NumericTransform]    # device lattice path
    string: Optional[strings.StringTransform] = None   # string sources


@functools.lru_cache(maxsize=None)
def parse_transform(s: str) -> TransformSpec:
    """Parse a ``--transform`` value; repeated parses return the same spec."""
    sl = s.lower()
    if sl == "direct":
        return TransformSpec("direct", numeric.DIRECT, strings.make_string_direct())
    if sl in ("direct:be", "direct:le", "direct:str"):
        nt = {"be": numeric.DIRECT_BE, "le": numeric.DIRECT_LE,
              "str": numeric.DIRECT_STR}[sl.split(":")[1]]
        st = strings.make_string_direct() if sl.endswith(":str") else None
        return TransformSpec("direct", nt, st)
    if sl in ("sha256", "double_sha256", "md5"):
        nt = {"sha256": numeric.SHA256, "double_sha256": numeric.DOUBLE_SHA256,
              "md5": numeric.MD5}[sl]
        return TransformSpec(sl, nt, strings.make_string_hash(sl))
    if sl == "milksad":
        return TransformSpec("milksad", numeric.MILKSAD)
    if sl == "mt64":
        return TransformSpec("mt64", numeric.MT64)
    if sl == "armory":
        from . import wallets
        return wallets.armory_spec()
    if sl == "multibit":
        from . import wallets
        return wallets.multibit_spec()
    if sl in ("electrum", "electrum:change"):
        from . import wallets
        return wallets.electrum_spec(for_change=sl.endswith(":change"))
    if sl == "bitimage" or sl.startswith("bitimage:"):
        from . import wallets
        return wallets.bitimage_spec()
    if sl == "lcg" or sl.startswith("lcg:"):
        variant, endian = _parse_lcg(sl)
        vs = [variant] if variant else None
        return TransformSpec("lcg", numeric.make_lcg(vs, endian == "be"))
    if sl == "xorshift" or sl.startswith("xorshift:"):
        return TransformSpec("xorshift", numeric.make_xorshift(_parse_xorshift(sl)))
    if sl == "sha256_chain" or sl.startswith("sha256_chain:"):
        variant, depth = _parse_chain(sl)
        name = f"sha256_chain:{variant}" if variant else "sha256_chain"
        return TransformSpec(name, numeric.make_sha256_chain(variant, depth),
                             strings.make_string_sha256_chain(variant, depth))
    raise ValueError(
        f"Unknown transform: {s}. Valid: direct, sha256, double_sha256, md5, "
        f"milksad, mt64, armory, multibit, electrum[:change], "
        f"lcg[:variant][:endian], xorshift[:variant], sha256_chain[:variant], bitimage"
    )


def _parse_lcg(s: str):
    """lcg | lcg:le | lcg:variant | lcg:variant:endian."""
    parts = s.rstrip(":").split(":")
    if parts == ["lcg"]:
        return None, "be"
    if len(parts) == 2:
        v = parts[1]
        if v in ("be", "big"):
            return None, "be"
        if v in ("le", "little"):
            return None, "le"
        if v in lcg_core.VARIANTS_BY_NAME:
            return lcg_core.VARIANTS_BY_NAME[v], "be"
        raise ValueError(
            f"Invalid LCG variant or endian: '{v}'. Valid variants: glibc, "
            f"minstd, msvc, borland. Valid endian: be, le")
    if len(parts) == 3:
        v, e = parts[1], parts[2]
        if v not in lcg_core.VARIANTS_BY_NAME:
            raise ValueError(f"Invalid LCG variant: '{v}'. Valid: glibc, minstd, msvc, borland")
        if e in ("be", "big"):
            endian = "be"
        elif e in ("le", "little"):
            endian = "le"
        else:
            raise ValueError(f"Invalid endian: '{e}'. Valid: be, le")
        return lcg_core.VARIANTS_BY_NAME[v], endian
    raise ValueError("Invalid LCG format. Use: lcg, lcg:variant, lcg:endian, lcg:variant:endian")


def _parse_xorshift(s: str):
    parts = s.rstrip(":").split(":")
    if parts == ["xorshift"]:
        return None
    if len(parts) == 2 and parts[1] in _XS_ALIASES:
        return _XS_ALIASES[parts[1]]
    raise ValueError(
        f"Invalid xorshift variant: '{':'.join(parts[1:])}'. "
        f"Valid: 64, 128, 128plus, xoroshiro")


def _parse_chain(s: str):
    parts = s.rstrip(":").split(":")
    if parts == ["sha256_chain"]:
        return None, chain_core.DEFAULT_CHAIN_DEPTH
    if len(parts) == 2:
        v = parts[1]
        if v in _CHAIN_NAMES:
            return _CHAIN_NAMES[v], chain_core.DEFAULT_CHAIN_DEPTH
        raise ValueError(f"Invalid SHA256 chain variant: '{v}'. Valid: iterated, indexed, counter")
    if len(parts) == 3 and parts[1] == "indexed":
        if parts[2] in ("be", "big"):
            return "indexed:be", chain_core.DEFAULT_CHAIN_DEPTH
        if parts[2] in ("le", "little"):
            return "indexed:le", chain_core.DEFAULT_CHAIN_DEPTH
        raise ValueError(f"Invalid endian: '{parts[2]}'. Valid: be, le")
    raise ValueError(
        f"Invalid SHA256 chain format: '{s}'. Valid: sha256_chain, "
        f"sha256_chain:iterated, sha256_chain:indexed[:be|:le], sha256_chain:counter")
