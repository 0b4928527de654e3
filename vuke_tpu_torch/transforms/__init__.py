"""Transforms: the registry (``registry.parse_transform``) and the numeric
transforms it hands out (``numeric.py``)."""

from .registry import NotPortedError, TransformSpec, parse_transform  # noqa: F401
