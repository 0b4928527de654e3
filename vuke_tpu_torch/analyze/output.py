"""Analysis results as text and as hand-rolled JSON: the port's copy of
``vuke_tpu/analyze/output.py``, byte for byte the same output (the
reference's ``analyze/output.rs:3-77``)."""

from __future__ import annotations

from .analyzers import AnalysisResult, KeyMetadata


def format_results(metadata: KeyMetadata, results) -> str:
    out = []
    out.append(f"Private Key: {metadata.hex}")
    out.append(f"Bit Length:  {metadata.bit_length}")
    out.append(f"Hamming Weight: {metadata.hamming_weight}")
    out.append("---")
    out.append("Analysis:")
    for r in results:
        details = r.details or ""
        detail_part = f"({details})" if details else ""
        out.append(f"  {r.status.symbol()} {r.analyzer}: "
                   f"{r.status.as_str().upper()} {detail_part}")
    return "\n".join(out) + "\n"


def _escape_json(s: str) -> str:
    out = []
    for c in s:
        if c == "\\":
            out.append("\\\\")
        elif c == '"':
            out.append('\\"')
        elif c == "\n":
            out.append("\\n")
        elif c == "\r":
            out.append("\\r")
        elif c == "\t":
            out.append("\\t")
        elif ord(c) < 0x20:
            out.append(f"\\u{ord(c):04x}")
        else:
            out.append(c)
    return "".join(out)


def format_results_json(metadata: KeyMetadata, results) -> str:
    rows = []
    for r in results:
        details = (f', "details": "{_escape_json(r.details)}"' if r.details else "")
        rows.append(f'    {{"analyzer": "{r.analyzer}", '
                    f'"status": "{r.status.as_str()}"{details}}}')
    body = ",\n".join(rows)
    return (
        "{\n"
        f'  "private_key": "{metadata.hex}",\n'
        f'  "bit_length": {metadata.bit_length},\n'
        f'  "hamming_weight": {metadata.hamming_weight},\n'
        f'  "leading_zeros": {metadata.leading_zeros},\n'
        '  "results": [\n'
        f"{body}\n"
        "  ]\n"
        "}"
    )
