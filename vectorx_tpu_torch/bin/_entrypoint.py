"""Shared circuit-entrypoint CLI: ``build`` / ``prove input.json``.

Mirrors the plonky2x/rustx entrypoint contract the platform drives
(reference succinct.json proveCommand; rustx `Program::entrypoint`):
`prove` reads {"data": {"input": "0x..."}} from the input JSON and writes
{"type": ..., "data": {"output": "0x...", ...}} to output.json.

`prove-zk` (header_range/rotate entrypoints) runs the succinct pipeline
instead: ONE machine proof, pickled next to output.json, its output hex
recorded the same way — the platform-side analogue of proving the real
circuit binary rather than the dummy program.

Port of `vectorx_tpu.bin._entrypoint`.  Each entrypoint's `make_run(config)`
returns the function that maps input bytes and a fetcher to output bytes,
and its `succinct_prover(fetcher, input_bytes, config)` returns the
succinct proof; the circuits that use a device take it from
`config.device` (`VECTORX_DEVICE`, "cuda" unless the caller asks for the
CPU).
"""

from __future__ import annotations

import json
import logging
import pickle
import sys
from pathlib import Path

from vectorx_tpu_torch.config import Config, make_fetcher, require_device


def run_entrypoint(name: str, make_run, proof_type: str,
                   succinct_prover=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = sys.argv[1:]
    cmds = ("build", "prove") + (("prove-zk",) if succinct_prover else ())
    if not args or args[0] not in cmds:
        print(f"usage: python -m vectorx_tpu_torch.bin.{name} "
              f"{'|'.join(cmds)} <input.json>")
        sys.exit(2)
    config = Config.from_env()
    if args[0] == "build":
        # No circuit binary to serialize: the pipeline runs eagerly in
        # torch at prove time; record the entrypoint manifest instead.
        Path("build").mkdir(exist_ok=True)
        Path(f"build/{name}.json").write_text(json.dumps(
            {"name": name, "framework": "vectorx-tpu-torch",
             "type": proof_type}))
        print(f"built manifest build/{name}.json")
        return
    # a missing device ends the process before any work
    if args[0] == "prove-zk":
        require_device(config)
    else:
        run = make_run(config)
    input_path = args[1] if len(args) > 1 else "input.json"
    req = json.loads(Path(input_path).read_text())
    input_hex = req["data"]["input"].removeprefix("0x")
    fetcher = make_fetcher(config)
    if args[0] == "prove-zk":
        proof = succinct_prover(fetcher, bytes.fromhex(input_hex), config)
        output = proof.output_bytes
        Path(f"{name}.proof.pkl").write_bytes(pickle.dumps(proof))
        result = {"type": "machine_stark",
                  "data": {"input": "0x" + input_hex,
                           "output": "0x" + output.hex(),
                           "proof_file": f"{name}.proof.pkl"}}
    else:
        output = run(bytes.fromhex(input_hex), fetcher)
        result = {"type": proof_type,
                  "data": {"input": "0x" + input_hex,
                           "output": "0x" + output.hex()}}
    Path("output.json").write_text(json.dumps(result))
    print(json.dumps(result))
