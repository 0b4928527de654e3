"""The wallet kernels' plain versions and wrappers against hashlib and the
JAX package on the CPU: SHA-512 (``cores/sha512.py``) against hashlib and
``vuke_tpu/cores/sha512.compress_unrolled``; W1's plain version
(``wallets/pbkdf2_device.pbkdf2_sha512_plain``) at 2 and 7 iterations
against ``hashlib.pbkdf2_hmac`` and the JAX ``pbkdf2_hmac_sha512_batch``,
keys across the 128-byte edge and salts to 107 bytes; the port's batch at
2048 (hashlib on the CPU) against the JAX one and the BIP39 Trezor vector;
W2's plain version (``wallets/electrum.stretch_plain``) at 1, 2 and 17
rounds against a hashlib loop at every block edge of the seed length; the
port's stretch at 99,999 rounds against the JAX ``stretch_keys_device``.

The plain versions run SHA-512 and SHA-256 in int64 torch ops, a few
hundred launches a compression: 2048 PBKDF2 iterations or 99,999 stretch
rounds would take hours that way, so they run here at a few; the kernels
run the full counts on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 9).  Every comparison is exact.
"""

import hashlib

import numpy as np
import pytest
import torch

from vuke_tpu._lazy import numpy_backend
from vuke_tpu.cores import sha512 as jsha512
from vuke_tpu.wallets import electrum as jelectrum
from vuke_tpu.wallets import pbkdf2_device as jpbkdf2
from vuke_tpu_torch.cores import sha512
from vuke_tpu_torch.wallets import electrum, pbkdf2_device as pbkdf2

RNG = np.random.default_rng(9)
KEYS = [b"", b"p", bytes(RNG.bytes(127)), bytes(RNG.bytes(128)), bytes(RNG.bytes(129)),
        bytes(RNG.bytes(330))]
SALTS = [b"mnemonic", b"mnemonicTREZOR", bytes(RNG.bytes(107))]


def _block_words(msg: bytes) -> list:
    """One-block SHA-512 padding of ``msg`` (at most 111 bytes) as 16 pairs."""
    blk = msg + b"\x80" + b"\x00" * (111 - len(msg)) + (len(msg) * 8).to_bytes(16, "big")
    return [sha512.split(int.from_bytes(blk[8 * i:8 * i + 8], "big")) for i in range(16)]


def _digest(state) -> bytes:
    return b"".join(((int(h) << 32) | int(l)).to_bytes(8, "big") for h, l in state)


@pytest.mark.parametrize("n", [0, 1, 55, 111])
def test_sha512_compress_matches_hashlib_and_jax(n):
    """The plain compression on ints and on int64 tensors of 3 lanes, and
    the JAX ``compress_unrolled`` (eager numpy) on the same block."""
    msg = bytes(RNG.bytes(n))
    words = _block_words(msg)
    assert _digest(sha512.compress(sha512.iv(), words)) == hashlib.sha512(msg).digest()
    lanes = [(torch.tensor([h] * 3), torch.tensor([l] * 3)) for h, l in words]
    got = sha512.compress(sha512.iv(), lanes)
    assert _digest((h[2], l[2]) for h, l in got) == hashlib.sha512(msg).digest()
    with numpy_backend():
        jw = [(np.array([h], dtype=np.uint32), np.array([l], dtype=np.uint32)) for h, l in words]
        want = jsha512.compress_unrolled(jsha512.iv_state(jw[0][0]), jw)
    assert _digest((h[0], l[0]) for h, l in want) == hashlib.sha512(msg).digest()


def _w1_bytes(out: torch.Tensor) -> list:
    raw = np.ascontiguousarray(out.view(torch.int32).numpy().view(np.uint32).T)
    return [r.astype(">u4").tobytes() for r in raw]


@pytest.mark.parametrize("iterations", [2, 7])
@pytest.mark.parametrize("salt", SALTS, ids=["8", "14", "107"])
def test_w1_plain_matches_hashlib_and_jax(iterations, salt):
    """Keys of 0, 1, 127, 128, 129 and 330 bytes (the last two pre-hashed),
    salts up to the 107-byte edge."""
    got = _w1_bytes(pbkdf2.pbkdf2_sha512(pbkdf2.key_blocks(KEYS), pbkdf2._salt_block_words(salt),
                                         iterations))
    assert got == [hashlib.pbkdf2_hmac("sha512", k, salt, iterations, 64) for k in KEYS]
    with numpy_backend():
        assert got == jpbkdf2.pbkdf2_hmac_sha512_batch(KEYS, salt, iterations)
    assert pbkdf2._salt_block_words(salt) == [int(a) for pair in
                                              jpbkdf2._salt_block_words(salt) for a in pair]


def test_salt_past_the_block_edge_is_refused_as_the_jax_package_does():
    for fn in (pbkdf2._salt_block_words, jpbkdf2._salt_block_words):
        with pytest.raises(AssertionError, match="salt too long for the single-block"):
            fn(b"s" * 108)
    with pytest.raises(AssertionError, match="salt too long"):
        pbkdf2.pbkdf2_hmac_sha512_batch([b"x"], b"s" * 108)


def test_batch_at_2048_matches_jax_and_the_trezor_vector():
    """The port's batch on the CPU (hashlib) against the JAX one (its XLA
    program on the CPU) and ``tests/test_sha512.py``'s BIP39 vector."""
    mnemonic = b"legal winner thank year wave sausage worth useful legal winner thank yellow"
    pws = [mnemonic, b"", b"k" * 129]
    got = pbkdf2.pbkdf2_hmac_sha512_batch(pws, b"mnemonicTREZOR")
    assert got == jpbkdf2.pbkdf2_hmac_sha512_batch(pws, b"mnemonicTREZOR")
    assert got[0].hex() == (
        "2e8905819b8723fe2c1d161860e5ee1830318dbf49a83bd451cfb8440c28bd6f"
        "a457fe1296106559a3c80937a1c1069be3a3a5bd381ee6260e8d9739fce1f607")
    assert pbkdf2.pbkdf2_hmac_sha512_batch([], b"mnemonic") == []
    assert not pbkdf2.device_available() and not pbkdf2.device_available("cpu")


def _host_stretch(seed: bytes, rounds: int) -> bytes:
    x = hashlib.sha256(seed + seed).digest()
    for _ in range(rounds):
        x = hashlib.sha256(x + seed).digest()
    return x


def _x0(seeds) -> torch.Tensor:
    raw = b"".join(hashlib.sha256(s + s).digest() for s in seeds)
    w = np.frombuffer(raw, dtype=">u4").astype(np.uint32).reshape(len(seeds), 8)
    return torch.from_numpy(np.ascontiguousarray(w.T).view(np.int32)).view(torch.uint32)


@pytest.mark.parametrize("length", [1, 10, 23, 24, 32, 87, 88, 150])
def test_w2_plain_matches_hashlib(length):
    """One block up to 23 bytes, two up to 87, three beyond; 32 bytes (two
    blocks, the second padding alone)."""
    seeds = [bytes(RNG.integers(48, 103, length).astype(np.uint8)) for _ in range(3)]
    for rounds in (1, 2, 17):
        out = electrum.stretch(_x0(seeds), electrum.seed_words(seeds), length, rounds)
        assert electrum._words_bytes(out) == [_host_stretch(s, rounds) for s in seeds]


def test_stretch_at_99999_matches_jax():
    """4 seeds of one length: the port's stretch on the CPU (hashlib)
    against the JAX ``stretch_keys_device`` (its XLA loop on the CPU), and
    the official Electrum seed's master public key through the plain
    derive (K3 -> K4's plain versions)."""
    seeds = [b"acb740e454c3134901d7c8f16497cc1c", b"0123456789abcdef0123456789abcdef",
             b"ffffffffffffffffffffffffffffffff", b"00000000000000000000000000000001"]
    got = electrum.stretch_keys_device(seeds)
    assert got == jelectrum.stretch_keys_device(seeds)
    mpk = electrum.master_pubkeys_device(got[:1] + [bytes(32)])
    assert mpk[0].hex() == ("e9d4b7866dd1e91c862aebf62a49548c7dbf7bcc6e4b7b8c9da820c7737968df"
                            "9c09d5a3e271dc814a29981f81b3faaf2737b551ef5dcc6189cf0f8252c442b3")
    assert mpk[1] is None
    with pytest.raises(AssertionError, match="uniform seed length required"):
        electrum.stretch_keys_device([b"ab", b"abc"])


def test_wrappers_check_their_arguments():
    with pytest.raises(ValueError):
        pbkdf2.pbkdf2_sha512(pbkdf2.key_blocks([b"x"]), [0] * 31, 2)
    with pytest.raises(ValueError):
        pbkdf2.pbkdf2_sha512(pbkdf2.key_blocks([b"x"]), [0] * 32, 0)
    with pytest.raises(ValueError):
        electrum.stretch(_x0([b"ab"]), electrum.seed_words([b"ab"]), 5, 1)
    with pytest.raises(TypeError):
        pbkdf2.pbkdf2_sha512(torch.zeros((32, 1), dtype=torch.int64), [0] * 32, 2)
