from tendermint_tpu_torch.node.node import Node, default_new_node

__all__ = ["Node", "default_new_node"]
