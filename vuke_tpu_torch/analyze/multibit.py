"""The MultiBit HD analyzer: one mnemonic (``--mnemonic``) or a file of
candidates (``--mnemonic-file``, the dictionary attack) against a key at
m/0'/0/i, i below the derivation depth.

The port of ``vuke_tpu/analyze/multibit.py``, its statuses and detail
strings byte for byte.  The file's candidates go in chunks of 4096 through
``wallets/multibit.multibit_hd_keys_batch``: on the card (``config.device``)
its two PBKDF2 stretches are two W1 launches a chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .analyzers import AnalysisConfig, AnalysisResult, AnalysisStatus

CHUNK = 4096


def _truncate_mnemonic(m: str) -> str:
    words = m.split()
    if len(words) <= 6:
        return m
    return " ".join(words[:3]) + " ... " + " ".join(words[-3:])


@dataclass
class MultibitAnalyzer:
    mnemonic: Optional[str] = None
    mnemonic_file: Optional[str] = None
    passphrase: str = ""
    derivation_depth: int = 20
    name: str = "multibit-hd"
    supports_mask: bool = False

    @property
    def is_brute_force(self) -> bool:
        return self.mnemonic_file is not None

    def _check_mnemonic(self, key: bytes, mnemonic: str) -> Optional[int]:
        from ..wallets.multibit import multibit_hd_keys
        try:
            keys = multibit_hd_keys(mnemonic, self.passphrase, self.derivation_depth)
        except ValueError:
            return None
        for i, k in enumerate(keys):
            if k == key:
                return i
        return None

    def analyze(self, key: bytes, config: AnalysisConfig, progress=None) -> AnalysisResult:
        if self.mnemonic:
            idx = self._check_mnemonic(key, self.mnemonic)
            if idx is not None:
                pp = "<empty>" if not self.passphrase else "<set>"
                return AnalysisResult(
                    self.name, AnalysisStatus.CONFIRMED,
                    f'mnemonic="{_truncate_mnemonic(self.mnemonic)}", '
                    f"path=m/0'/0/{idx}, passphrase=\"{pp}\"")
            return AnalysisResult(
                self.name, AnalysisStatus.NOT_FOUND,
                f"mnemonic does not produce this key "
                f"(checked {self.derivation_depth} derivations)")
        if self.mnemonic_file:
            try:
                with open(self.mnemonic_file) as f:
                    lines = f.readlines()
            except OSError as e:
                return AnalysisResult(self.name, AnalysisStatus.UNKNOWN,
                                      f"Failed to open mnemonic file: {e}")
            from ..wallets.multibit import multibit_hd_keys_batch
            candidates = [(no, line.strip()) for no, line in enumerate(lines, 1)
                          if line.strip() and not line.strip().startswith("#")]
            line_of = {m: no for no, m in candidates}
            for ofs in range(0, len(candidates), CHUNK):
                chunk = [m for _, m in candidates[ofs:ofs + CHUNK]]
                for m, keys in multibit_hd_keys_batch(chunk, self.passphrase,
                                                      self.derivation_depth,
                                                      device=config.device):
                    for i, k in enumerate(keys):
                        if k == key:
                            return AnalysisResult(
                                self.name, AnalysisStatus.CONFIRMED,
                                f'mnemonic="{_truncate_mnemonic(m)}", '
                                f"path=m/0'/0/{i}, line={line_of[m]}")
                if progress is not None:
                    progress.advance(len(chunk))
            return AnalysisResult(
                self.name, AnalysisStatus.NOT_FOUND,
                f"no mnemonic in file produces this key "
                f"({len(lines)} lines checked)")
        return AnalysisResult(
            self.name, AnalysisStatus.UNKNOWN,
            "requires --mnemonic or --mnemonic-file")
