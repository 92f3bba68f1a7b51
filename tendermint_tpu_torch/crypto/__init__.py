"""Host crypto: Ed25519 and secp256k1 keys and signatures, and the hashes
behind addresses and Merkle roots."""

from tendermint_tpu_torch.crypto.hashing import ripemd160, sha256
from tendermint_tpu_torch.crypto.keys import (
    PrivKeyEd25519,
    PubKeyEd25519,
    SignatureEd25519,
    gen_priv_key_ed25519,
)

__all__ = [
    "ripemd160",
    "sha256",
    "PrivKeyEd25519",
    "PubKeyEd25519",
    "SignatureEd25519",
    "gen_priv_key_ed25519",
]
