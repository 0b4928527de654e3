"""Wallet derivations: BIP39 and BIP32, Electrum, MultiBit HD, Armory and
Bitimage (the port's copies of ``vuke_tpu/wallets/``).  Host code, apart
from two kernels: PBKDF2-HMAC-SHA512 (W1, ``pbkdf2_device.py``) and
Electrum's key stretch (W2, ``electrum.stretch_keys_device``)."""
