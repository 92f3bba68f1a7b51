"""Chain state and block execution (`State`, `apply_block`) and their
crash-injection points (`state.fail`)."""

from tendermint_tpu_torch.state.fail import (
    EXIT_CODE,
    fail_point,
    pipeline_point,
    reset,
    rotate_point,
    wal_write,
)
from tendermint_tpu_torch.state.state import ABCIResponses, State
from tendermint_tpu_torch.state.execution import (
    apply_block,
    exec_commit_block,
    validate_block,
)

__all__ = [
    "State",
    "ABCIResponses",
    "apply_block",
    "exec_commit_block",
    "validate_block",
    "EXIT_CODE",
    "fail_point",
    "pipeline_point",
    "reset",
    "rotate_point",
    "wal_write",
]
