"""Durable progress of a sweep (``checkpoint.py``)."""
