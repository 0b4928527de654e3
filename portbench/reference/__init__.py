"""The plain reference: secp256k1 on Python integers, hashlib and a
written-out RIPEMD-160, Base58Check and bech32, MT19937 and MT19937-64.
It imports nothing of the program under test."""
