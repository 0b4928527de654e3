"""The PTX carry chains of vuke_tpu_torch/csrc/secp256k1.cuh, run on the CPU.

There is no CUDA compiler here, so this file reads the asm text of
``fe_mul``, ``fe_sqr``, ``fe_add`` and ``fe_sub`` out of the header (string
literals and the ``VK_PTX_*`` macros they name), runs it under a small
interpreter of the PTX instructions it uses, and holds each result against
Python integers mod p: a weak residue, below 2^256.  The interpreter
refuses an unknown opcode, an undeclared or unwritten register, and a
carry consumed where no ``.cc`` instruction of the same block set one.  On
the card, ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the
compiled library to the same operands through ``vk_fe_selftest``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from vuke_tpu_torch.ecc import ref

P = ref.P
M32 = 0xFFFFFFFF
HEADER = Path(__file__).resolve().parent.parent / "vuke_tpu_torch" / "csrc" / "secp256k1.cuh"

# Adversarial operands: the card's self-test's (the edges of the weak range
# and of p, single full limbs, values whose products carry out of the top limb).
EDGE = list(chip_smoke.FIELD_EDGE)


def _macros(text: str) -> dict:
    """``#define VK_PTX_NAME`` bodies: their string literals, concatenated."""
    out = {}
    for m in re.finditer(r"#define (VK_PTX_\w+) \\\n((?:.*\\\n)*.*\n)", text):
        body = re.sub(r"/\*.*?\*/", "", m.group(2))
        out[m.group(1)] = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', body))
    return out


def _asm(name: str):
    """(PTX text, operand names in order) of the asm statement in ``name``."""
    text = HEADER.read_text()
    macros = _macros(text)
    body = text[text.index(f"void {name}("):]
    body = body[body.index("asm volatile("):body.index(");")]
    template, outs, ins = body[len("asm volatile("):].split("\n        :")
    template = re.sub(r"//.*", "", template)
    ptx = "".join(macros.get(tok[0], "") or tok[1]
                  for tok in re.findall(r'(VK_PTX_\w+)|"((?:[^"\\]|\\.)*)"', template))
    names = re.findall(r"VK_FE_OUT\((\w+)\)", outs) + re.findall(r"VK_FE_IN\((\w+)\)", ins)
    return ptx.replace("\\n", "\n").replace("\\t", "\t"), names


def _parse(ptx: str):
    """PTX text -> (declared register names, [(opcode, dst, srcs)])."""
    regs, prog = set(), []
    for stmt in ptx.replace("{", ";").replace("}", ";").split(";"):
        s = stmt.strip()
        if not s:
            continue
        if s.startswith(".reg"):
            for decl in s.split(None, 2)[2].split(","):
                m = re.fullmatch(r"(\w+)<(\d+)>", decl.strip())
                if m:
                    regs.update(f"{m.group(1)}{i}" for i in range(int(m.group(2))))
                else:
                    regs.add(decl.strip())
            continue
        op, args = s.split(None, 1)
        args = [a.strip() for a in args.split(",")]
        prog.append((op, args[0], args[1:]))
    return regs, prog


OPS = {"mov.b32", "mul.lo.u32", "mul.hi.u32", "mad.lo.u32", "mad.lo.cc.u32", "mad.hi.cc.u32",
       "madc.lo.cc.u32", "madc.hi.cc.u32", "madc.lo.u32", "madc.hi.u32", "add.cc.u32",
       "addc.cc.u32", "addc.u32", "sub.cc.u32", "subc.cc.u32", "subc.u32", "and.b32",
       "shl.b32", "shf.l.clamp.b32"}


def _run(regs, prog, operands: dict) -> dict:
    """Execute ``prog`` with ``operands`` {index: u32}; returns the written
    output operands {index: u32}."""
    val, out, cf = {}, {}, None

    def get(a):
        if a.startswith("%"):
            return operands[int(a[1:])]
        if a.isdigit():
            return int(a)
        assert a in regs, f"undeclared register {a}"
        assert a in val, f"register {a} read before it is written"
        return val[a]

    for op, dst, srcs in prog:
        assert op in OPS, f"opcode {op} is not one the interpreter knows"
        x = [get(s) for s in srcs]
        carry_in = op.startswith(("addc", "subc", "madc"))
        if carry_in:
            assert cf is not None, f"{op} {dst}: no carry flag set in this block"
        c = cf if carry_in else 0
        sets_cc = ".cc." in op
        if op == "mov.b32":
            r = x[0]
        elif op.startswith(("mul", "mad")):
            prod = x[0] * x[1]
            half = prod & M32 if ".lo." in op else prod >> 32
            r = half + (x[2] if op.startswith("mad") else 0) + c
        elif op.startswith("add"):
            r = x[0] + x[1] + c
        elif op.startswith("sub"):
            r = x[0] - x[1] - c
        elif op == "and.b32":
            r = x[0] & x[1]
        elif op == "shl.b32":
            r = x[0] << x[1]
        else:                                   # shf.l.clamp.b32 d, lo, hi, n
            r = ((x[1] << 32 | x[0]) << min(x[2], 32)) >> 32
        if sets_cc:
            cf = int(r < 0) if op.startswith("sub") else r >> 32
        r &= M32
        if dst.startswith("%"):
            out[int(dst[1:])] = r
        else:
            assert dst in regs, f"undeclared register {dst}"
            val[dst] = r
    return out


@pytest.fixture(scope="module")
def programs():
    return {name: (_parse(_asm(name)[0]), _asm(name)[1])
            for name in ("fe_mul", "fe_sqr", "fe_add", "fe_sub")}


def _apply(programs, name, *args) -> int:
    (regs, prog), names = programs[name]
    assert names[0] == "r" and len(names) == 1 + len(args)
    operands = {8 * (k + 1) + j: (v >> (32 * j)) & M32
                for k, v in enumerate(args) for j in range(8)}
    out = _run(regs, prog, operands)
    assert sorted(out) == list(range(8)), "the block must write all 8 output limbs"
    return sum(out[j] << (32 * j) for j in range(8))


def _pairs():
    rng = np.random.default_rng(7)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(48)]
    return [(a, b) for a in EDGE for b in EDGE] + list(zip(rand, reversed(rand)))


@pytest.mark.parametrize("name,want", [
    ("fe_mul", lambda a, b: a * b),
    ("fe_add", lambda a, b: a + b),
    ("fe_sub", lambda a, b: a - b),
])
def test_ptx_binary_op_matches_bignum(programs, name, want):
    for a, b in _pairs():
        got = _apply(programs, name, a, b)
        assert got < 1 << 256 and got % P == want(a, b) % P, (name, hex(a), hex(b), hex(got))


def test_ptx_sqr_matches_bignum(programs):
    rng = np.random.default_rng(8)
    vals = EDGE + [int.from_bytes(rng.bytes(32), "little") for _ in range(200)]
    for a in vals:
        got = _apply(programs, "fe_sqr", a)
        assert got < 1 << 256 and got % P == a * a % P, (hex(a), hex(got))


def test_ptx_product_folds_at_the_carry_edges(programs):
    """Operands whose 512-bit product has a full top limb, so that the
    first fold carries c >= 2^32 (the t[15] overflow) and the second fold
    carries out of 2^256 (the double fold)."""
    top = (1 << 256) - 1
    cases = [(top, top), (top, top - 1), (top - (1 << 32), top), (P - 1, top), (P, P + 1)]
    for a, b in cases:
        assert (a * b) >> 480 == M32            # t[15] is all ones
        got = _apply(programs, "fe_mul", a, b)
        assert got < 1 << 256 and got % P == a * b % P
    # sums and differences at the weak range's edges fold twice
    for a, b in [(top, top), (top, 1 << 255), (0, top), (1, top), (0, (1 << 32) + 978)]:
        assert _apply(programs, "fe_add", a, b) % P == (a + b) % P
        assert _apply(programs, "fe_sub", a, b) % P == (a - b) % P


def test_ptx_squaring_takes_36_products(programs):
    """The product takes 64 32x32-bit products (a low and a high half
    each), the squaring 36: 28 cross products once and 8 squares."""
    def multiplies(name):
        (_, prog), _ = programs[name]
        return sum(1 for op, _, srcs in prog if op.startswith(("mul", "mad"))
                   and not any(s.isdigit() for s in srcs))

    assert multiplies("fe_mul") == 2 * 64
    assert multiplies("fe_sqr") == 2 * 36
