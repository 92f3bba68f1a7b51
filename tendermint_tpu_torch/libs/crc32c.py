"""CRC-32C (Castagnoli, poly 0x1EDC6F41 reflected 0x82F63B78) — the WAL
record checksum (reference: consensus/wal.go frames every record with
crc32c before length; the Castagnoli polynomial has hardware support and
strictly better burst-error detection than CRC-32/ISO, which is why both
Tendermint and every LSM WAL picked it).

The container ships `google_crc32c` (native, ~4 GB/s) — preferred.  The
pure-Python table fallback keeps the FORMAT identical (same polynomial,
same init/xorout) on hosts without it; it is byte-at-a-time (~2 MB/s) and
only the repair scan over a large WAL would notice.  The self-check below
pins both paths to the canonical check value so a wrong polynomial can
never silently frame records.
"""

from __future__ import annotations

try:  # native path (baked into the image)
    import google_crc32c as _native

    def crc32c(data: bytes) -> int:
        return _native.value(data)

    IMPL = "google_crc32c"
except ImportError:  # pragma: no cover - exercised only without the wheel
    _TABLE = []
    for _n in range(256):
        _c = _n
        for _ in range(8):
            _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
        _TABLE.append(_c)

    def crc32c(data: bytes) -> int:
        crc = 0xFFFFFFFF
        for b in data:
            crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF

    IMPL = "pure-python"

# canonical CRC-32C check value (RFC 3720 appendix / every test vector
# table): a wrong polynomial here would mean every framed record fails
# its own checksum on a correct reader — refuse to import instead.
# A real raise, not assert: python -O must not strip the pin.
if crc32c(b"123456789") != 0xE3069283:
    raise RuntimeError(f"CRC-32C self-check failed ({IMPL})")
