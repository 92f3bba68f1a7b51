from tendermint_tpu_torch.rpc.core.pipe import RPCContext
from tendermint_tpu_torch.rpc.core.routes import build_routes

__all__ = ["RPCContext", "build_routes"]
