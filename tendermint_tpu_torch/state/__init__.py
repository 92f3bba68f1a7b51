"""State execution's crash-injection points (`state.fail`). `State` and
`apply_block` come with a later slice of the port."""

from tendermint_tpu_torch.state.fail import (
    EXIT_CODE,
    fail_point,
    pipeline_point,
    reset,
    rotate_point,
    wal_write,
)

__all__ = [
    "EXIT_CODE",
    "fail_point",
    "pipeline_point",
    "reset",
    "rotate_point",
    "wal_write",
]
