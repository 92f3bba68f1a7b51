"""Simple Merkle roots (tmlibs/merkle equivalent)."""
