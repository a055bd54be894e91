"""Prover service (E5 replacement).

Where the reference posts requests to the closed Succinct platform
(`SuccinctClient.submit_platform_request`, upstream bin/vectorx.rs:
122-130) which runs the circuit binaries, this service registers this
repo's own circuit pipelines as the gateway's provers: every
request_call is fulfilled by actually executing header_range / rotate
against the chain data source.

Port of `vectorx_tpu.services.prover_service`: the header_range provers
run on the `device` the caller names; the succinct mode waits for its
circuits (ROADMAP A-5).
"""

from __future__ import annotations

import functools

from vectorx_tpu_torch.circuits import (DummyHeaderRange, DummyRotate,
                                        HeaderRangeCircuit, RotateCircuit)
from vectorx_tpu_torch.circuits.zk_header_range import (prove_header_range_zk,
                                                        verify_header_range_zk)
from vectorx_tpu_torch.services.contract import MockGateway
from vectorx_tpu_torch.stark.prover import StarkConfig


def make_gateway(fetcher, max_authority_set_size: int = 300,
                 max_num_headers: int = 256,
                 max_header_size: int = 35840,
                 header_range_function_id: bytes = b"\x01" * 32,
                 rotate_function_id: bytes = b"\x02" * 32,
                 dummy: bool = False, zk: bool = False,
                 stark_config=None, *, device=None) -> MockGateway:
    """Gateway whose provers run the real (or dummy) circuit pipelines.

    The header_range circuit and its proofs run on `device`, which every
    mode but `dummy=True` needs; nothing picks one.  Rotate runs
    `RotateCircuit.run` (host signature and byte checks) in both modes.

    With `zk=True` the header_range prover returns `(output, ZK proof)`
    and the gateway VERIFIES the proof before the contract callback — the
    reference's `verifiedCall` trust boundary
    (upstream contracts/src/VectorX.sol:259-262).  Tampering the
    prover output makes the fulfillment revert.

    `zk="succinct"` (one machine proof per function) needs the succinct
    circuits, which the port does not have yet (ROADMAP A-5): it raises
    here rather than serve another mode."""
    if zk == "succinct":
        raise NotImplementedError(
            'make_gateway(zk="succinct") needs the succinct header_range '
            'and rotate circuits, not ported yet (ROADMAP A-5)')
    if device is None and (zk or not dummy):
        raise ValueError("make_gateway needs a device for its provers")
    gw = MockGateway()
    if dummy:
        rt = DummyRotate()
        hr_run = DummyHeaderRange(max_num_headers).run
    else:
        hr = HeaderRangeCircuit(
            max_authority_set_size=max_authority_set_size,
            max_header_size=max_header_size,
            max_num_headers=max_num_headers)
        rt = RotateCircuit(max_authority_set_size=max_authority_set_size,
                           max_header_size=max_header_size)
        hr_run = functools.partial(hr.run, device=device)
    if zk:
        cfg = stark_config or StarkConfig()

        def hr_prove(inp):
            zkp = prove_header_range_zk(
                fetcher, inp, tree_size=max_num_headers,
                max_authorities=max_authority_set_size, config=cfg,
                device=device)
            return zkp.output_bytes, zkp

        def hr_verify(inp, output, zkp) -> bool:
            if zkp is None or getattr(zkp, "input_bytes", None) != inp or \
                    getattr(zkp, "output_bytes", None) != output:
                return False
            try:
                return verify_header_range_zk(zkp, tree_size=max_num_headers,
                                              config=cfg, device=device)
            except Exception:
                return False

        gw.register_prover(header_range_function_id, hr_prove, hr_verify)
    else:
        gw.register_prover(header_range_function_id,
                           lambda inp: hr_run(inp, fetcher))
    gw.register_prover(rotate_function_id, lambda inp: rt.run(inp, fetcher))
    return gw
