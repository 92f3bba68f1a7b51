"""Host crypto: Ed25519 keys, signatures and the hashes behind addresses
and Merkle roots."""
