"""NilApp: accepts everything, stores nothing (abci nilapp; reference
proxy/client.go:75)."""

from tendermint_tpu_torch.abci.types import Application


class NilApp(Application):
    pass
