"""CRC-32C (Castagnoli, poly 0x1EDC6F41 reflected 0x82F63B78) — the WAL
record checksum (reference: consensus/wal.go frames every record with
crc32c before length; the Castagnoli polynomial has hardware support and
strictly better burst-error detection than CRC-32/ISO, which is why both
Tendermint and every LSM WAL picked it).

The container ships `google_crc32c` (native, ~4 GB/s) — preferred.  The
fallback keeps the FORMAT identical (same polynomial, same init/xorout) on
hosts without it: a table a byte at a time for short buffers, and for
long ones (a state-sync chunk of 64 KiB) segments run side by side in
numpy and folded, several times the byte loop's rate.  The self-check below
pins both paths to the canonical check value so a wrong polynomial can
never silently frame records.
"""

from __future__ import annotations

_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _TABLE.append(_c)

# buffers from this length on take the segmented path below
SEGMENT_MIN = 4096
_SHIFTS: dict[int, tuple] = {}


def _register(crc: int, data) -> int:
    """The CRC register after `data`, byte at a time from `crc`."""
    t = _TABLE
    for b in data:
        crc = t[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def _shift_tables(n: int) -> tuple:
    """The register's map over n zero bytes, which is linear, as four
    256-entry tables (one a register byte), cached a length."""
    tabs = _SHIFTS.get(n)
    if tabs is None:
        zeros = bytes(n)
        cols = [_register(1 << j, zeros) for j in range(32)]
        tabs = []
        for k in range(4):
            tab = [0] * 256
            for v in range(1, 256):
                low = v & -v
                tab[v] = tab[v ^ low] ^ cols[8 * k + low.bit_length() - 1]
            tabs.append(tab)
        tabs = tuple(tabs)
        _SHIFTS[n] = tabs
    return tabs


def crc32c_fallback(data: bytes) -> int:
    """CRC-32C without the native wheel. A short buffer runs the table a
    byte at a time; a long one is cut into equal segments whose registers
    numpy runs side by side from zero, then folded in order (the register
    after a segment is the shifted register before it XOR the segment's
    own), and the remainder runs a byte at a time: the same value, at
    several times the byte loop's rate on a 64 KiB chunk."""
    n = len(data)
    if n < SEGMENT_MIN:
        return _register(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    import numpy as np

    seg = 1 << max(5, (n // 8).bit_length() // 2)
    count = n // seg
    cols = np.frombuffer(data, dtype=np.uint8, count=count * seg).reshape(count, seg).T.copy()
    table = np.array(_TABLE, dtype=np.uint32)
    regs = np.zeros(count, dtype=np.uint32)
    for col in cols:
        regs = table[(regs ^ col) & 0xFF] ^ (regs >> 8)
    a0, a1, a2, a3 = _shift_tables(seg)
    crc = 0xFFFFFFFF
    for r in regs.tolist():
        crc = a0[crc & 0xFF] ^ a1[(crc >> 8) & 0xFF] ^ a2[(crc >> 16) & 0xFF] ^ a3[crc >> 24] ^ r
    return _register(crc, memoryview(data)[count * seg:]) ^ 0xFFFFFFFF


try:  # native path (baked into the image)
    import google_crc32c as _native

    def crc32c(data: bytes) -> int:
        return _native.value(data)

    IMPL = "google_crc32c"
except ImportError:  # pragma: no cover - exercised only without the wheel
    crc32c = crc32c_fallback
    IMPL = "pure-python"

# canonical CRC-32C check value (RFC 3720 appendix / every test vector
# table): a wrong polynomial here would mean every framed record fails
# its own checksum on a correct reader — refuse to import instead.
# A real raise, not assert: python -O must not strip the pin.
if crc32c(b"123456789") != 0xE3069283:
    raise RuntimeError(f"CRC-32C self-check failed ({IMPL})")
