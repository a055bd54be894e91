"""The control of the check that decides `correct`: the reference put in
the program's place with one guarantee of the configuration broken, which
the check has to refuse.

    python3 prover_bench/control.py --workload <name> --seeds <n>[,<n>...]

For each seed it proves statement 0 of the cell twice with the plain
reference: once at the configuration's FriConfig (what the check compares
against), once with one query fewer (the control: the soundness the
configuration states, 28 queries at rate 1/8 and 16 bits of grinding,
cut by a query, the step that would tempt a change that wants a faster
proof).  It prints, one JSON line a seed, the numbers the check compares
for the control's outputs, and whether the program's verifier at the
stated configuration rejects the control's proof.  The benchmark's own
runs do not run it.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def control_fri(fri: dict) -> dict:
    return dict(fri, num_queries=fri["num_queries"] - 1)


def readings(root: str, spec: dict, workload: str, seed: int,
             device) -> dict:
    from prover_bench import harness

    _cell, config, traffic = harness.cell_parts(root, spec, workload)
    st = harness.statements_module(traffic["kind"]).Statements(
        config, traffic, seed, device)
    inp = st.inputs(0)
    t0 = time.perf_counter()
    truth = st.reference(inp)
    control = st.reference(inp, control_fri(config["fri"]))
    numbers = st.compare(control, truth)
    return {"seed": seed, "workload": workload, "control": numbers,
            "limits": st.checks,
            "control_rejected": not st.verify(inp, control),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    import shutil
    import tempfile

    root = sys.path[0]
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    vk = tempfile.mkdtemp(prefix="prover_bench_vk_")
    os.environ["VECTORX_VK_CACHE"] = vk
    try:
        for s in args.seeds.split(","):
            print(json.dumps(readings(root, spec, args.workload, int(s),
                                      "cuda")), flush=True)
    finally:
        shutil.rmtree(vk, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
