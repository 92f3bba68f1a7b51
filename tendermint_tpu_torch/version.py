"""Version constants (reference: version/version.go:3-18)."""

MAJ = "0"
MIN = "1"
FIX = "0"

__version__ = f"{MAJ}.{MIN}.{FIX}"
VERSION = __version__

# p2p wire-protocol compatibility version: peers must match on MAJ.MIN
# (reference gates on Version major via NodeInfo.CompatibleWith,
# p2p/types.go:36-44).
PROTOCOL_VERSION = f"{MAJ}.{MIN}"
