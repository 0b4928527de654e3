"""Storage stack: Parquet backend, SQL query, cloud sync, Iceberg catalog.

The port's copy of ``vuke_tpu/storage/``, with the same schema and layout:
the flat 19-column Arrow schema, Hive partitioning
``transform=X/date=Y/chunk_NNNN.parquet`` and rotation at record and byte
thresholds.  ``pyarrow``, ``requests``, ``duckdb`` and ``pyiceberg`` are
imported inside the functions that use them, so every module here imports
without them.
"""

from .output import StorageOutput, StorageSummary  # noqa: F401
from .parquet_backend import ParquetBackend  # noqa: F401
from .records import ResultRecord, result_schema  # noqa: F401
