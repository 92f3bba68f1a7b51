"""Host crypto: Ed25519 and secp256k1 keys and signatures, and the hashes
behind addresses and Merkle roots."""
