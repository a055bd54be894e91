#!/usr/bin/env python3
"""Prove and verify the whole in-ZK GRANDPA justification of a block signed
by all of a 300-authority set, on one CUDA card, at the products'
`FriConfig()`:

    python3 scripts/zk_justification_300.py [--authorities 300] [--out f]

(`--device cpu --authorities 1` rehearses it on the host in minutes.)

`circuits.zk_justification.prove_justification_zk` proves the chained
SHA-256 commitment to the 300 keys, the SHA-512 challenge chunks and the
ed25519 ladder chunks (each past the streaming bound, so `prove` streams
it); `verify_justification_zk` must accept the proof and reject it with
one signature's S replaced by (S + 1) mod L and with the first ladder
proof's first FRI final coefficient changed.  Prints one JSON line (and
writes it to `--out`): the chunk counts, the seconds of the whole prove
and verify, each component proof's seconds (its root span, `stark.prove`
or `stark.prove_streamed`, with its rows and width), and the card's peak
memory.  Exits 1 when a verdict is wrong.
"""

import argparse
import copy
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402


def components(records) -> list:
    """(name, rows, width, seconds) of every root span: one a proof or
    verification of a component."""
    return [{"span": r.name, "rows": r.counts.get("rows"),
             "width": r.counts.get("width"), "s": round(r.ns / 1e9, 4)}
            for r in records if r.parent is None]


def main(argv=None) -> int:
    from vectorx_tpu_torch import tracing
    from vectorx_tpu_torch.circuits.zk_justification import (
        prove_justification_zk, verify_justification_zk)
    from vectorx_tpu_torch.curves.ed25519 import L
    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.io.fixtures import FixtureChain
    from vectorx_tpu_torch.stark.prover import StarkConfig

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--authorities", type=int, default=300)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    n = args.authorities
    chain = FixtureChain(seed=19, num_blocks=8, epoch_length=9,
                         authorities_per_era=lambda era: n,
                         sign_fraction=1.0)
    block = 5
    j = chain.get_justification(block)
    set_hash = chain.compute_authority_set_hash(block - 1)
    cfg = StarkConfig()
    out = {"device": torch.cuda.get_device_name(0) if on_card else "cpu",
           "authorities": n, "signers": sum(j.validator_signed)}
    if on_card:
        try:
            out["power_limit"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            out["power_limit"] = "not read"

    def peak_gib() -> float | None:
        if not on_card:
            return None
        return round(torch.cuda.max_memory_allocated() / (1 << 30), 4)

    def reset_peak() -> None:
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def check(zk) -> tuple[bool, float]:
        t = time.perf_counter()
        ok = verify_justification_zk(zk, block, j.block_hash,
                                     j.authority_set_id, set_hash, cfg,
                                     device=dev)
        return ok, time.perf_counter() - t

    tracer = tracing.install(tracing.Tracer())
    try:
        reset_peak()
        t = time.perf_counter()
        zk = prove_justification_zk(j, set_hash, cfg, device=dev)
        out["prove_s"] = round(time.perf_counter() - t, 3)
        out["peak_prove_gib"] = peak_gib()
        proved = len(tracer.records)
        out["sha512_chunk_sizes"] = zk.sha_chunk_sizes
        out["ladder_chunk_sizes"] = zk.ladder_chunk_sizes
        out["commitment_chunk_sizes"] = zk.commitment_proof.chunk_sizes
        out["prove_components"] = components(tracer.records)
        print(json.dumps(out), flush=True)
        reset_peak()
        ok, out["verify_s"] = check(zk)
        out["accepted"] = ok
        out["peak_verify_gib"] = peak_gib()
        out["verify_components"] = components(tracer.records[proved:])
    finally:
        tracing.uninstall()

    forged = copy.copy(zk)
    forged.signatures = list(zk.signatures)
    sig = forged.signatures[0]
    s = (int.from_bytes(sig[32:], "little") + 1) % L
    forged.signatures[0] = sig[:32] + s.to_bytes(32, "little")
    bad, out["forged_s_verify_s"] = check(forged)
    out["forged_s_rejected"] = not bad

    tampered = copy.copy(zk)
    tampered.ladder_proofs = list(zk.ladder_proofs)
    first = copy.deepcopy(zk.ladder_proofs[0])
    c0, c1 = first.fri_proof.final_coeffs[0]
    first.fri_proof.final_coeffs[0] = ((c0 + 1) % gl.P, c1)
    tampered.ladder_proofs[0] = first
    bad, out["tampered_fri_verify_s"] = check(tampered)
    out["tampered_fri_rejected"] = not bad

    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if (out["accepted"] and out["forged_s_rejected"]
                 and out["tampered_fri_rejected"]) else 1


if __name__ == "__main__":
    sys.exit(main())
