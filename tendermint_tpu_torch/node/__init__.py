"""The node package: for now only `health`; the node itself comes later."""
