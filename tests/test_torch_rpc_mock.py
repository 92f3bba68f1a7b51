"""The port's mock RPC client (tendermint_tpu_torch/rpc/mock.py; reference
rpc/client/mock/client.go), on the cases of tests/test_rpc_mock.py, and
beside them one canned chain driving both packages' MockClient and
LightClient to the same verdicts and the same recorded calls."""

from __future__ import annotations

import pytest

from tendermint_tpu_torch.rpc.mock import Call, MockClient, MockClientError


def test_canned_values_and_recording():
    mc = MockClient().expect("status", {"latest_block_height": 7})
    assert mc.status() == {"latest_block_height": 7}
    assert mc.call("status") == {"latest_block_height": 7}
    assert len(mc.calls_for("status")) == 2
    assert mc.calls_for("status")[0].response["latest_block_height"] == 7
    assert isinstance(mc.calls[0], Call)


def test_callable_exception_and_unknown():
    boom = RuntimeError("node down")
    mc = MockClient(responses={
        "block": lambda height: {"height": height * 2},
        "tx": boom,
    })
    assert mc.block(height=21) == {"height": 42}
    assert mc.calls_for("block")[0].params == {"height": 21}
    with pytest.raises(RuntimeError, match="node down"):
        mc.tx(hash="ab")
    assert mc.calls_for("tx")[0].error is boom
    with pytest.raises(MockClientError, match="no canned response"):
        mc.genesis()


def test_passthrough_composes_with_real_client():
    class Real:
        def call(self, method, **params):
            return {"from": "real", "method": method, **params}

    mc = MockClient(responses={"status": {"from": "mock"}}, client=Real())
    assert mc.status() == {"from": "mock"}
    assert mc.validators(height=3) == {
        "from": "real", "method": "validators", "height": 3,
    }


def test_drives_the_light_client():
    """Interface-fit proof: the light client runs against MockClient with
    callable canned responses (replacing an ad-hoc stub)."""
    from tendermint_tpu_torch.rpc.light import LightClient
    from tests.test_torch_light import CHAIN, _chain_with_change

    stub, old_set = _chain_with_change(old_signs_transition=True)
    mc = MockClient(responses={
        "commit": lambda height: stub.commit(height),
        "validators": lambda height=0: stub.validators(height),
    })
    lc = LightClient(mc, CHAIN, old_set.copy())
    lc.advance(3)
    assert lc.height == 3
    assert [c.method for c in mc.calls][:2] == ["commit", "commit"]


# -- against the JAX package ----------------------------------------------------


@pytest.mark.parametrize("old_signs_transition", [True, False])
def test_same_canned_chain_same_verdicts_in_both_packages(old_signs_transition):
    """One canned chain (heights 1-2 under {v1}, a set change at 3 that the
    old set signs or an attacker's set that it does not) served through
    each package's MockClient to its LightClient: the same trusted height,
    the same refusal message, and the same recorded calls and responses."""
    from tendermint_tpu.rpc.light import LightClient as JLightClient
    from tendermint_tpu.rpc.light import LightClientError as JLightClientError
    from tendermint_tpu.rpc.mock import MockClient as JMockClient
    from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet
    from tendermint_tpu_torch.rpc.light import LightClient, LightClientError
    from tests.test_torch_light import CHAIN, _chain_with_change

    stub, old_set = _chain_with_change(old_signs_transition=old_signs_transition)
    trusted_json = old_set.to_json()

    def run(mock_cls, light_cls, err_cls, trusted):
        mc = mock_cls(responses={
            "commit": lambda height: stub.commit(height),
            "validators": lambda height=0: stub.validators(height),
        })
        lc = light_cls(mc, CHAIN, trusted)
        try:
            lc.advance(3)
            verdict = "accepted"
        except err_cls as exc:
            verdict = f"refused: {exc}"
        calls = [(c.method, c.params, c.response, c.error) for c in mc.calls]
        return verdict, lc.height, lc.validators.hash(), calls

    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    port = run(MockClient, LightClient, LightClientError, ValidatorSet.from_json(trusted_json))
    jax = run(JMockClient, JLightClient, JLightClientError, JValidatorSet.from_json(trusted_json))
    assert port == jax
    if old_signs_transition:
        assert port[0] == "accepted" and port[1] == 3
    else:
        assert port[0].startswith("refused") and port[1] == 2
