"""The controls: the program with one of the guarantees its configuration
states broken in the way a later change might be tempted to break it.
Each has to make a run come out not correct; none runs in the benchmark's
own runs (``python3 -m portbench.control`` runs them, and the tests at a
small size).  A control is a function of the cell that patches the
program underneath; the one for a cell is the one for its driver.
"""

from __future__ import annotations


def _bits(n: int) -> int:
    """As many bits as ``n`` seeds need: a compare that keeps no more lets
    about two other seeds pass by chance."""
    return max(2, (n - 1).bit_length())


def scan_compressed_only(cell):
    """A scan that matches the compressed hash160 alone, skipping the
    uncompressed pool's lookup (half of the matcher's work)."""
    from vuke_tpu_torch import matcher

    def lookup(self, frag_c, frag_u):
        comp, _ = self.on(frag_c[0].device)
        return matcher._member(comp, matcher.pack_fragments(*frag_c))

    matcher.TargetPools.lookup = lookup


def analyze_truncated(cell):
    """An audit that compares the low bits of the key alone, as many as the
    space has seeds (the program's own mask path), in place of all 256."""
    from vuke_tpu_torch.analyze import analyzers

    lo, hi = cell.config["seed_space"]
    bits = _bits(hi - lo)
    init = analyzers.AnalysisConfig.__init__

    def config(self, *a, **k):
        init(self, *a, **k)
        self.mask_bits = bits

    analyzers.AnalysisConfig.__init__ = config


def cascade_truncated(cell):
    """A cascade sweep that holds the first key alone, under as many bits as
    a job has seeds, in place of every key under its full width."""
    from vuke_tpu_torch.analyze import sweeps

    bits = _bits(cell.traffic["job_seeds"])
    init = sweeps.SweepProgram.__init__

    def program(self, family, compare, mask=None, cascade=None, *a, **k):
        if cascade:
            first = cascade[0][1] & ((1 << bits) - 1) | (1 << (bits - 1))
            cascade = [(bits, first)]
        init(self, family, compare, mask, cascade, *a, **k)

    sweeps.SweepProgram.__init__ = program


BY_DRIVER = {"scan": "scan_compressed_only", "analyze": "analyze_truncated",
             "dsweep": "cascade_truncated"}
