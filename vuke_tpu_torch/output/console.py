"""Console output, the port's copy of ``vuke_tpu/output/console.py``.

The compact line ``source,transform,privkey_hex,p2pkh_compressed``, the
verbose block and the hit banner, byte for byte as the JAX package writes
them.  ``lines`` writes many compact lines formatted beforehand (the
generate driver's hot path, ``pipeline.format_lines``).
"""

from __future__ import annotations

import sys
import threading

from ..derive import DerivedKey
from ..matcher import MatchInfo


class ConsoleOutput:
    def __init__(self, stream=None, verbose: bool = False):
        self._stream = stream if stream is not None else sys.stdout
        self.verbose = verbose
        self._lock = threading.Lock()
        self._close_on_flush = False

    @property
    def needs_records(self) -> bool:
        """Whether generate hands this output whole records rather than
        compact lines (``cores/records.emit_block``): in verbose mode."""
        return self.verbose

    @classmethod
    def to_file(cls, path, verbose: bool = False) -> "ConsoleOutput":
        out = cls(open(path, "w"), verbose)
        out._close_on_flush = True
        return out

    def key(self, source: str, transform: str, derived: DerivedKey):
        with self._lock:
            w = self._stream
            if self.verbose:
                w.write("---\n")
                w.write(f"source: {source}\n")
                w.write(f"transform: {transform}\n")
                w.write(f"private_key: {derived.private_key_hex}\n")
                w.write(f"wif_compressed: {derived.wif_compressed}\n")
                w.write(f"wif_uncompressed: {derived.wif_uncompressed}\n")
                w.write(f"p2pkh_compressed: {derived.p2pkh_compressed}\n")
                w.write(f"p2pkh_uncompressed: {derived.p2pkh_uncompressed}\n")
                w.write(f"p2wpkh: {derived.p2wpkh}\n")
            else:
                w.write(f"{source},{transform},{derived.private_key_hex},"
                        f"{derived.p2pkh_compressed}\n")

    def key_fast(self, source: str, transform: str, key: bytes,
                 p2pkh_compressed: str, deriver=None):
        """The compact line without a host derive; verbose mode derives."""
        if self.verbose:
            assert deriver is not None
            self.key(source, transform, deriver.derive(key))
            return
        with self._lock:
            self._stream.write(f"{source},{transform},{key.hex()},{p2pkh_compressed}\n")

    def lines(self, text: str):
        """Compact lines formatted beforehand, each ending in a newline
        (not in verbose mode, whose blocks need a host derive)."""
        assert not self.verbose
        with self._lock:
            self._stream.write(text)

    def hit(self, source: str, transform: str, derived: DerivedKey, match_info: MatchInfo):
        with self._lock:
            w = self._stream
            w.write("\n========== HIT ==========\n")
            w.write(f"Source: {source}\n")
            w.write(f"Transform: {transform}\n")
            w.write(f"Matched: {match_info.address} ({match_info.address_type.as_str()})\n")
            w.write("---\n")
            w.write(f"Private Key: {derived.private_key_hex}\n")
            w.write(f"WIF (compressed): {derived.wif_compressed}\n")
            w.write(f"WIF (uncompressed): {derived.wif_uncompressed}\n")
            w.write("---\n")
            w.write(f"P2PKH (compressed): {derived.p2pkh_compressed}\n")
            w.write(f"P2PKH (uncompressed): {derived.p2pkh_uncompressed}\n")
            w.write(f"P2WPKH: {derived.p2wpkh}\n")
            w.write("=========================\n")

    def flush(self):
        with self._lock:
            if getattr(self._stream, "closed", False):
                return
            self._stream.flush()

    def close(self):
        """Release the file handle (nothing for stdout); ``flush`` stays
        safe mid-run."""
        with self._lock:
            if self._close_on_flush and not getattr(self._stream, "closed", False):
                self._stream.close()
