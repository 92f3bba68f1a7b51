"""Mock RPC client for tests (reference: rpc/client/mock/client.go).

Implements the same `call(method, **params)` + attribute-sugar surface as
rpc/client.HTTPClient / LocalClient, with:

- canned responses per method — a value, a callable(**params), or an
  Exception instance (raised);
- a recorded `calls` list (reference mock.Call) so tests assert exactly
  what the unit under test requested;
- an optional passthrough client for methods without a canned response
  (the reference's mock-with-real-ABCI composition).

Stubs that model richer behavior (a whole chain) stay where they are;
one-method stubbing uses this.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class MockClientError(Exception):
    pass


@dataclass
class Call:
    method: str
    params: dict
    response: object = None
    error: BaseException | None = None


@dataclass
class MockClient:
    """responses: method name -> canned value | callable(**params) |
    Exception. `client`: optional real client consulted for methods with
    no canned entry (else MockClientError)."""

    responses: dict = field(default_factory=dict)
    client: object = None
    calls: list = field(default_factory=list)

    def expect(self, method: str, response) -> "MockClient":
        """Chainable: mock.expect("status", {...}).expect("tx", boom)."""
        self.responses[method] = response
        return self

    def call(self, method: str, **params):
        rec = Call(method=method, params=dict(params))
        self.calls.append(rec)
        try:
            if method in self.responses:
                r = self.responses[method]
                if isinstance(r, BaseException):
                    raise r
                if callable(r):
                    r = r(**params)
            elif self.client is not None:
                r = self.client.call(method, **params)
            else:
                raise MockClientError(f"no canned response for {method!r}")
        except BaseException as exc:
            rec.error = exc
            raise
        rec.response = r
        return r

    def calls_for(self, method: str) -> list[Call]:
        return [c for c in self.calls if c.method == method]

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda **params: self.call(name, **params)
