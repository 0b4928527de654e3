"""Output fan-out, the port's copy of ``vuke_tpu/output/multi.py``."""

from __future__ import annotations


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
