"""CLI entry points — equivalents of the reference's 11 binaries
(upstream Cargo.toml:12-58).  Run as ``python -m vectorx_tpu_torch.bin.<name>``:

operator, indexer, events, genesis, fill_block_range — services;
header_range_256, header_range_512, rotate,
dummy_header_range_256, dummy_header_range_512, dummy_rotate —
circuit entrypoints with the ``build`` / ``prove input.json`` contract
(reference succinct.json; ours is prover.json).

Port of `vectorx_tpu.bin`.  The header_range entrypoints and the operator
prove on `VECTORX_DEVICE` ("cuda" unless the caller asks for the CPU); a
CUDA device the process cannot see ends it with a non-zero exit.
"""
