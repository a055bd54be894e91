"""Shared circuit-entrypoint CLI: ``build`` / ``prove input.json``.

Mirrors the plonky2x/rustx entrypoint contract the platform drives
(reference succinct.json proveCommand; rustx `Program::entrypoint`):
`prove` reads {"data": {"input": "0x..."}} from the input JSON and writes
{"type": ..., "data": {"output": "0x...", ...}} to output.json.

Port of `vectorx_tpu.bin._entrypoint`.  Each entrypoint's `make_run(config)`
returns the function that maps input bytes and a fetcher to output bytes;
the circuits that use a device take it from `config.device`
(`VECTORX_DEVICE`, "cuda" unless the caller asks for the CPU).  The
reference's `prove-zk` command runs the succinct circuits, which the port
does not have yet (ROADMAP A-5), so it is not offered.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

from vectorx_tpu_torch.config import Config, make_fetcher


def run_entrypoint(name: str, make_run, proof_type: str) -> None:
    logging.basicConfig(level=logging.INFO)
    args = sys.argv[1:]
    if not args or args[0] not in ("build", "prove"):
        print(f"usage: python -m vectorx_tpu_torch.bin.{name} "
              f"build|prove <input.json>")
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
    run = make_run(config)
    input_path = args[1] if len(args) > 1 else "input.json"
    req = json.loads(Path(input_path).read_text())
    input_hex = req["data"]["input"].removeprefix("0x")
    output = run(bytes.fromhex(input_hex), make_fetcher(config))
    result = {"type": proof_type,
              "data": {"input": "0x" + input_hex,
                       "output": "0x" + output.hex()}}
    Path("output.json").write_text(json.dumps(result))
    print(json.dumps(result))
