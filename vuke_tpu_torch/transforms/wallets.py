"""The wallet transforms: Electrum, MultiBit HD, Armory and Bitimage.

The port of ``vuke_tpu/transforms/wallets.py``: string (and, for bitimage,
file-blob) transforms over the host wallet code, whose keys then go to the
card's derive and match like any other transform's.  Slots and labels are
the JAX package's:
  electrum: "truncated_seed[chain/i]";
  multibit: "truncated_mnemonic[m/0'/0/i]";
  armory:   the input string (two slots for a numeric seed);
  bitimage: "label[path]" or "label:passphrase[path]".
Electrum seeds of one length, ``device_stretch_threshold`` or more of them
in a batch, stretch through W2 on the card and take their master public
keys from K3 -> K4 (``wallets/electrum.py``); fewer stretch with hashlib.
Armory's numeric path is host-only (``NumericTransform.host``).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .numeric import NumericTransform
from .registry import TransformSpec
from .strings import StringTransform

HEX = frozenset("0123456789abcdefABCDEF")


def _key_row(out: np.ndarray, valid: np.ndarray, i: int, j: int, key: bytes):
    out[i, j] = np.frombuffer(key, dtype=">u4")
    valid[i, j] = True


def electrum_spec(for_change: bool = False, derivation_count: int = 20,
                  device_stretch_threshold: int = 32) -> TransformSpec:
    from ..wallets import electrum as ew

    chain = "1" if for_change else "0"
    name = "electrum:change" if for_change else "electrum"
    slots = tuple(f"[{chain}/{i}]" for i in range(derivation_count))
    last = {}

    def derivers(strings, device):
        """A deriver per hex seed (None otherwise); the seeds of a length
        with ``device_stretch_threshold`` or more in the batch stretch
        together through W2 on a CUDA ``device``."""
        out = [None] * len(strings)
        by_len = {}
        for i, s in enumerate(strings):
            if s and all(c in HEX for c in s):
                by_len.setdefault(len(s), []).append(i)
        dev = torch.device("cpu") if device is None else torch.device(device)
        for idxs in by_len.values():
            if len(idxs) >= device_stretch_threshold and dev.type == "cuda":
                stretched = ew.stretch_keys_device([strings[i].encode() for i in idxs], dev)
                pubkeys = ew.master_pubkeys_device(stretched, dev)
                for i, st, pk in zip(idxs, stretched, pubkeys):
                    if pk is not None:
                        out[i] = ew.ElectrumDeriver(st, for_change, pubkey_bytes=pk)
            else:
                for i in idxs:
                    try:
                        out[i] = ew.ElectrumDeriver.from_hex_seed(strings[i], for_change)
                    except ew.ElectrumError:
                        pass
        return out

    def fn(strings, device=None):
        out = np.zeros((len(strings), derivation_count, 8), dtype=np.uint32)
        valid = np.zeros((len(strings), derivation_count), dtype=bool)
        for i, d in enumerate(derivers(strings, device)):
            if d is not None:
                for j, key in enumerate(d.derive_keys(derivation_count)):
                    _key_row(out, valid, i, j, key)
        last["valid"] = valid
        return out

    st = StringTransform(name, slots, fn, valid_fn=lambda strings: last["valid"],
                         label_fn=ew.truncate_seed)
    return TransformSpec(name, None, st)


def multibit_spec(derivation_count: int = 20) -> TransformSpec:
    from ..wallets.multibit import MultibitBugDeriver, MultibitError, truncate_mnemonic
    slots = tuple(f"[m/0'/0/{i}]" for i in range(derivation_count))
    last = {}

    def fn(strings, device=None):
        out = np.zeros((len(strings), derivation_count, 8), dtype=np.uint32)
        valid = np.zeros((len(strings), derivation_count), dtype=bool)
        for i, s in enumerate(strings):
            try:
                d = MultibitBugDeriver(s, "")
            except MultibitError:
                continue
            for j, key in enumerate(d.derive_keys(derivation_count)):
                _key_row(out, valid, i, j, key)
        last["valid"] = valid
        return out

    st = StringTransform("multibit", slots, fn, valid_fn=lambda strings: last["valid"],
                         label_fn=truncate_mnemonic)
    return TransformSpec("multibit", None, st)


def armory_spec() -> TransformSpec:
    """One slot for a string (the key of SHA256(string)); two for a numeric
    seed v, the keys of SHA256(str(v)) and of v as 32 BE bytes, computed on
    the host (4 EC multiplications a key)."""
    from ..wallets.armory import armory_key
    last = {}

    def string_fn(strings, device=None):
        out = np.zeros((len(strings), 1, 8), dtype=np.uint32)
        valid = np.zeros((len(strings), 1), dtype=bool)
        for i, s in enumerate(strings):
            key = armory_key(hashlib.sha256(s.encode()).digest())
            if key is not None:
                _key_row(out, valid, i, 0, key)
        last["valid"] = valid
        return out

    def host_fn(seeds):
        keys = np.zeros((len(seeds), 2, 8), dtype=np.uint32)
        valid = np.zeros((len(seeds), 2), dtype=bool)
        for i, v in enumerate(seeds):
            for j, root in enumerate((hashlib.sha256(str(v).encode()).digest(),
                                      v.to_bytes(32, "big"))):
                key = armory_key(root)
                if key is not None:
                    _key_row(keys, valid, i, j, key)
        return keys, valid

    st = StringTransform("armory", ("",), string_fn, valid_fn=lambda strings: last["valid"])
    return TransformSpec("armory", NumericTransform("armory", ("", ""), host=host_fn), st)


def bitimage_spec(path: str = "m/84'/0'/0'/0/0", passphrase: str = "",
                  passphrase_wordlist=None, derive_count: int = 1) -> TransformSpec:
    from ..wallets.bitimage import BitimageDeriver, increment_path_index

    passphrases = [passphrase]
    if passphrase_wordlist:
        with open(passphrase_wordlist) as f:
            passphrases = [w.strip() for w in f if w.strip()]
    paths = [path]
    for _ in range(derive_count - 1):
        paths.append(increment_path_index(paths[-1]))
    slots = tuple(f"[{p}]" if not pp else f":{pp}[{p}]" for pp in passphrases for p in paths)
    last = {}

    def blob_fn(blobs, device=None):
        """(data, label) blobs -> (N, S, 8) keys."""
        out = np.zeros((len(blobs), len(slots), 8), dtype=np.uint32)
        valid = np.zeros((len(blobs), len(slots)), dtype=bool)
        for i, (data, _label) in enumerate(blobs):
            s = 0
            for pp in passphrases:
                d = BitimageDeriver(data, pp)
                for p in paths:
                    try:
                        _key_row(out, valid, i, s, d.derive_path(p))
                    except ValueError:
                        pass
                    s += 1
        last["valid"] = valid
        return out

    def fn(strings, device=None):
        # a string is taken as the file's bytes
        return blob_fn([(s.encode(), s) for s in strings], device)

    st = StringTransform("bitimage", slots, fn, valid_fn=lambda strings: last["valid"],
                         blob_fn=blob_fn)
    return TransformSpec("bitimage", None, st)
