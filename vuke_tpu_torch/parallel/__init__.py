"""Durable progress of a sweep (``checkpoint.py``) and runs across
processes and cards (``multihost.py``, ``mesh.py``, ``dryrun.py``)."""
