"""SQL query over stored Parquet results.

The port's copy of ``vuke_tpu/storage/query.py``: a ``results`` view over
``<dir>/**/*.parquet`` with Hive partitioning, and the table, JSON and CSV
output byte for byte.  DuckDB when it can be imported; otherwise an
in-memory SQLite database loaded through ``pyarrow.dataset`` (the same view
name, a standard SQL subset).  A missing or empty directory gives empty
results.  ``duckdb`` and ``pyarrow`` are imported inside the functions that
use them.
"""

from __future__ import annotations

import datetime as _dt
import glob
import json
import os
from typing import List, Sequence, Tuple


def _duckdb():
    """The duckdb module, or None where it is not installed."""
    try:
        import duckdb  # type: ignore
    except ImportError:
        return None
    return duckdb


class QueryExecutor:
    def __init__(self, directory: str):
        self.directory = str(directory)
        self._connect()

    def _connect(self):
        self._files = sorted(
            glob.glob(os.path.join(self.directory, "**", "*.parquet"), recursive=True))
        duckdb = _duckdb()
        self._duck = duckdb is not None
        if self._duck:
            self._con = duckdb.connect()
            pattern = os.path.join(self.directory, "**", "*.parquet")
            if self._files:
                self._con.execute(
                    "CREATE VIEW results AS SELECT * FROM "
                    f"read_parquet('{pattern}', hive_partitioning=true)")
            else:
                self._con = None
        else:
            self._con = self._build_sqlite()

    def refresh(self):
        """Re-scan the directory and rebuild the view."""
        self._connect()

    def has_data(self) -> bool:
        return bool(self._files)

    def discovered_files(self) -> List[str]:
        return list(self._files)

    # -- sqlite fallback ----------------------------------------------------

    def _build_sqlite(self):
        import sqlite3

        import pyarrow as pa
        import pyarrow.dataset as pads

        con = sqlite3.connect(":memory:")
        if not self._files:
            con.execute("CREATE TABLE results (source TEXT)")
            con.execute("DELETE FROM results")
            return con
        ds = pads.dataset(self.directory, format="parquet", partitioning="hive")
        table = ds.to_table()
        cols = table.column_names
        defs = []
        for name, typ in zip(cols, table.schema.types):
            if pa.types.is_integer(typ):
                t = "INTEGER"
            elif pa.types.is_floating(typ):
                t = "REAL"
            elif pa.types.is_binary(typ) or pa.types.is_fixed_size_binary(typ):
                t = "BLOB"
            else:
                t = "TEXT"
            defs.append(f'"{name}" {t}')
        con.execute(f"CREATE TABLE results ({', '.join(defs)})")
        # the rows column by column, each timestamp as its ISO text
        columns = []
        for name, typ in zip(cols, table.schema.types):
            if pa.types.is_timestamp(typ) and typ.unit != "ns":
                columns.append(_isoformat_column(table.column(name)))
                continue
            values = table.column(name).to_pylist()
            if pa.types.is_timestamp(typ):
                values = [v.isoformat() if isinstance(v, _dt.datetime) else v for v in values]
            columns.append(values)
        placeholders = ",".join("?" * len(cols))
        con.executemany(f"INSERT INTO results VALUES ({placeholders})", zip(*columns))
        con.commit()
        return con

    # -- public API ---------------------------------------------------------

    def query(self, sql: str) -> Tuple[List[tuple], List[str]]:
        """Returns (rows, column_names)."""
        if self._con is None:
            return [], []
        if self._duck:
            res = self._con.execute(sql)
            cols = [d[0] for d in res.description]
            return res.fetchall(), cols
        cur = self._con.execute(sql)
        cols = [d[0] for d in cur.description] if cur.description else []
        return cur.fetchall(), cols

    def scalar(self, sql: str):
        rows, _ = self.query(sql)
        return rows[0][0] if rows and rows[0] else None

    def schema_text(self) -> str:
        from .records import result_schema
        return (format_schema(result_schema())
                + "\nPartitions: transform (identity), date (identity)"
                + f"\nFiles: {len(self._files)}")


def _isoformat_column(column) -> list:
    """``datetime.isoformat()`` of each value of a timestamp column of
    seconds, milliseconds or microseconds, as its ``to_pylist()`` values
    would give them, without making a datetime of each through pyarrow
    (slow for a zoned column)."""
    import pyarrow as pa

    unit = {"s": 1, "ms": 10 ** 3, "us": 10 ** 6}[column.type.unit]
    epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc if column.type.tz else None)
    out = []
    for v in column.cast(pa.int64()).to_pylist():
        if v is None:
            out.append(None)
        else:
            whole, frac = divmod(v, unit)
            out.append((epoch + _dt.timedelta(seconds=whole,
                                              microseconds=frac * 10 ** 6 // unit)).isoformat())
    return out


OUTPUT_FORMATS = ("table", "json", "csv")

# table cells longer than this are truncated with "..."
_TABLE_CELL_MAX = 60


def parse_output_format(s: str) -> str:
    """Case-insensitive table|json|csv."""
    fmt = s.lower()
    if fmt not in OUTPUT_FORMATS:
        raise ValueError(
            f"Unknown format '{s}'. Valid formats: table, json, csv")
    return fmt


def _rfc3339(v: _dt.datetime) -> str:
    if v.tzinfo is None:
        v = v.replace(tzinfo=_dt.timezone.utc)
    return v.isoformat()


def _fmt_value(v) -> str:
    """CSV/table cell rendering: None -> empty,
    binary -> hex, timestamps -> RFC3339."""
    if v is None:
        return ""
    if isinstance(v, (bytes, bytearray)):
        return v.hex()
    if isinstance(v, _dt.datetime):
        return _rfc3339(v)
    return str(v)


def _json_value(v):
    """JSON value conversion: binary -> hex
    string, timestamps -> quoted RFC3339, non-finite floats -> null."""
    if isinstance(v, (bytes, bytearray)):
        return v.hex()
    if isinstance(v, _dt.datetime):
        return _rfc3339(v)
    if isinstance(v, float) and not (v == v and abs(v) != float("inf")):
        return None
    return v


def format_results(rows: Sequence[tuple], columns: Sequence[str], fmt: str) -> str:
    """table / json / csv formatting."""
    fmt = parse_output_format(fmt)
    if fmt == "json":
        out = [dict(zip(columns, [_json_value(v) for v in row])) for row in rows]
        return json.dumps(out, indent=2, default=str)
    if fmt == "csv":
        import io
        import csv as _csv
        if not rows:
            return ""  # header-less empty output
        buf = io.StringIO()
        w = _csv.writer(buf, lineterminator="\n")
        w.writerow(columns)
        for row in rows:
            w.writerow([_fmt_value(v) for v in row])
        return buf.getvalue().rstrip("\n")
    # table
    if not columns:
        return "(no results)"

    def cell(v) -> str:
        s = _fmt_value(v)
        if len(s) > _TABLE_CELL_MAX:
            s = s[:_TABLE_CELL_MAX] + "..."
        return s

    widths = [len(c) for c in columns]
    srows = [[cell(v) for v in row] for row in rows]
    for row in srows:
        for i, v in enumerate(row):
            widths[i] = max(widths[i], len(v))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep,
           "|" + "|".join(f" {c:<{w}} " for c, w in zip(columns, widths)) + "|",
           sep]
    for row in srows:
        out.append("|" + "|".join(f" {v:<{w}} " for v, w in zip(row, widths)) + "|")
    out.append(sep)
    out.append(f"{len(rows)} row(s)")
    return "\n".join(out)


def format_schema(fields) -> str:
    """Schema display: header + Column / Type /
    Nullable table.  ``fields`` is any iterable of objects with .name,
    .type and .nullable (pyarrow fields or records.Field)."""
    fields = list(fields)
    rows = [(f.name, str(f.type), "Yes" if f.nullable else "No")
            for f in fields]
    body = format_results(rows, ["Column", "Type", "Nullable"], "table")
    body = body.rsplit("\n", 1)[0]  # drop the "N row(s)" footer
    return f"Schema: results ({len(fields)} columns)\n{body}"
