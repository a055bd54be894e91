#!/usr/bin/env python3
"""Run some of `chip_smoke.py`'s paths alone on one CUDA card, one after
another, with nothing else on the card: their times without the other
proving processes of the whole script beside them.

    python3 scripts/chip_paths_alone.py 6,15,fpmul_cpu,tree,chain,17,18

6: phase 6 (ladder and MSM), its CPU side run here first; 15: phase 15
(`FpMulAir`); fpmul_cpu: the `FpMulAir(9)` proof on the CPU against the
one phase 15 wrote; tree / chain: phase 16's SHA-256 tree / hash chain;
17: phase 17 (its two rank processes, the NCCL probe and the dry run);
18: phase 18 (the standalone FRI at 2^23 points).
Each step ends with a line of its seconds; a failed check raises.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


class CpuSide:
    """The host-check process's phase 6 results, computed here."""

    def result(self):
        batch = cs.ed25519_batch()
        return {f"ed25519_{m}": cs.ed25519_verify(batch, batch[2], "cpu", m)
                for m in ("ladder", "msm")}


def main(steps) -> None:
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.ntt import cuda_ntt
    from vectorx_tpu_torch.stark import StarkConfig, prove

    if not torch.cuda.is_available():
        raise SystemExit("chip_paths_alone: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)      # the card's context, before any stats
    cuda_ntt.load()
    out = tempfile.mkdtemp()
    os.environ["VECTORX_VK_CACHE"] = os.path.join(out, "vk")
    card, cfg = cs.card_line(), StarkConfig(fri=FriConfig())
    for step in steps:
        t0 = time.perf_counter()
        if step == "6":
            cs.phase_ed25519(dev, card, CpuSide())
        elif step == "15":
            cs.phase_fpmul(dev, card, cfg, out)
        elif step == "fpmul_cpu":
            air, small = cs.fpmul_identity_statement()
            text = cs.proof_text(prove(air, air.build_trace(), small,
                                       device="cpu"))
            with open(os.path.join(out, "fpmul_FpMulAir9.json")) as f:
                if f.read() != text:
                    raise AssertionError("FpMulAir(9): card != CPU")
            cs.log(f"FpMulAir(9) proof JSON on the card == the CPU's "
                   f"({len(text)} bytes)")
        elif step == "tree":
            cs.phase_sha_tree(dev, card, cfg, out)
        elif step == "chain":
            cs.phase_hash_chain(dev, card, cfg, out)
        elif step == "17":
            cs.phase_sharded(dev, card, out)
        elif step == "18":
            cs.phase_fri(dev, card)
        else:
            raise SystemExit(f"unknown step {step!r}")
        cs.log(f"== {step}: {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1].split(","))
