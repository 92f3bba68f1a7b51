"""Thread-safe bit array (reference: tmlibs/common BitArray, used for vote
bitmaps at types/vote_set.go:54 and part-set tracking at types/part_set.go).

Backed by a Python int (arbitrary precision) rather than []uint64 words —
the operations the consensus gossip needs (or/and/sub, pick-random-set-bit,
copy) are O(words) either way and Python ints vectorize them in C.
"""

from __future__ import annotations

import random
import threading


class BitArray:
    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative bit count")
        self._bits = bits
        self._elems = 0  # little-endian bitmask
        self._mtx = threading.Lock()

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_int(cls, bits: int, mask: int) -> "BitArray":
        ba = cls(bits)
        ba._elems = mask & ((1 << bits) - 1)
        return ba

    @classmethod
    def from_indices(cls, bits: int, indices) -> "BitArray":
        ba = cls(bits)
        for i in indices:
            ba.set_index(i, True)
        return ba

    # -- accessors ---------------------------------------------------------

    @property
    def size(self) -> int:
        return self._bits

    def get_index(self, i: int) -> bool:
        with self._mtx:
            if i >= self._bits or i < 0:
                return False
            return bool((self._elems >> i) & 1)

    def set_index(self, i: int, v: bool) -> bool:
        with self._mtx:
            if i >= self._bits or i < 0:
                return False
            if v:
                self._elems |= 1 << i
            else:
                self._elems &= ~(1 << i)
            return True

    def copy(self) -> "BitArray":
        with self._mtx:
            return BitArray.from_int(self._bits, self._elems)

    def update(self, other: "BitArray") -> None:
        """Replace this array's bits with other's (tmlibs BitArray.Update,
        used by ApplyVoteSetBitsMessage's replace semantics)."""
        mask = other.as_int()
        with self._mtx:
            self._elems = mask & ((1 << self._bits) - 1)

    def as_int(self) -> int:
        with self._mtx:
            return self._elems

    # -- set algebra (used by gossip to compute "parts the peer lacks",
    #    consensus/reactor.go:428) ----------------------------------------

    def or_(self, other: "BitArray") -> "BitArray":
        bits = max(self._bits, other._bits)
        return BitArray.from_int(bits, self.as_int() | other.as_int())

    def and_(self, other: "BitArray") -> "BitArray":
        bits = min(self._bits, other._bits)
        return BitArray.from_int(bits, self.as_int() & other.as_int())

    def not_(self) -> "BitArray":
        with self._mtx:
            return BitArray.from_int(self._bits, ~self._elems & ((1 << self._bits) - 1))

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (beyond other's size, self wins)."""
        with self._mtx:
            bits, elems = self._bits, self._elems
        o = other.as_int() & ((1 << min(bits, other.size)) - 1)
        return BitArray.from_int(bits, elems & ~o)

    def is_empty(self) -> bool:
        return self.as_int() == 0

    def is_full(self) -> bool:
        with self._mtx:
            return self._elems == (1 << self._bits) - 1 and self._bits > 0

    def num_true_bits(self) -> int:
        return bin(self.as_int()).count("1")

    def pick_random(self) -> tuple[int, bool]:
        """Pick a uniformly random set bit; (index, ok). Used by the gossip
        routines to pick a random needed part/vote (consensus/reactor.go:919)."""
        elems = self.as_int()
        if elems == 0:
            return 0, False
        set_bits = [i for i in range(self._bits) if (elems >> i) & 1]
        return random.choice(set_bits), True

    def indices(self) -> list[int]:
        elems = self.as_int()
        return [i for i in range(self._bits) if (elems >> i) & 1]

    def __eq__(self, other) -> bool:
        if not isinstance(other, BitArray):
            return NotImplemented
        return self._bits == other._bits and self.as_int() == other.as_int()

    def __repr__(self) -> str:
        bits = "".join("x" if self.get_index(i) else "_" for i in range(min(self._bits, 64)))
        return f"BA{{{self._bits}:{bits}}}"

    def to_json(self):
        return {"bits": self._bits, "elems": f"{self.as_int():x}"}

    @classmethod
    def from_json(cls, obj) -> "BitArray":
        return cls.from_int(obj["bits"], int(obj["elems"] or "0", 16))
