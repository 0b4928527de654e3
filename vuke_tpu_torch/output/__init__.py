"""Output handlers, the port's copy of ``vuke_tpu/output/``: ``key``,
``key_fast``, ``hit``, ``flush`` and ``close`` on the console or a file
(``ConsoleOutput``) and a fan-out (``MultiOutput``); ``key_columns`` takes
a block of generate records.  ``storage.StorageOutput`` is the Parquet
one."""

from .console import ConsoleOutput  # noqa: F401
from .multi import MultiOutput  # noqa: F401
