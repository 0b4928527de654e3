"""Transforms: the registry (``registry.parse_transform``) and the numeric,
string and wallet transforms it hands out (``numeric.py``, ``strings.py``,
``wallets.py``)."""

from .registry import TransformSpec, parse_transform  # noqa: F401
