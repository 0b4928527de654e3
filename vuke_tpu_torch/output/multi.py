"""Output fan-out, the port's copy of ``vuke_tpu/output/multi.py``, with
``key_columns`` (a block of generate records: each output takes it as
columns, lines or one ``key`` a record) and ``lines``."""

from __future__ import annotations

from ..cores.records import emit_block, needs_records


class MultiOutput:
    def __init__(self, outputs):
        self.outputs = list(outputs)

    def key(self, source, transform, derived):
        for o in self.outputs:
            o.key(source, transform, derived)

    def key_fast(self, source, transform, key, p2pkh_compressed, deriver=None):
        for o in self.outputs:
            if hasattr(o, "key_fast"):
                o.key_fast(source, transform, key, p2pkh_compressed, deriver=deriver)
            else:
                assert deriver is not None
                o.key(source, transform, deriver.derive(key))

    @property
    def needs_records(self) -> bool:
        return any(needs_records(o) for o in self.outputs)

    def key_columns(self, block):
        for o in self.outputs:
            emit_block(o, block)

    def lines(self, text: str):
        for o in self.outputs:
            o.lines(text)

    def hit(self, source, transform, derived, match_info):
        for o in self.outputs:
            o.hit(source, transform, derived, match_info)

    def flush(self):
        for o in self.outputs:
            o.flush()

    def close(self):
        for o in self.outputs:
            if hasattr(o, "close"):
                o.close()
