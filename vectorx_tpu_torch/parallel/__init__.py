"""Multi-process proving on `torch.distributed`: the process group and its
collectives (`mesh`), the sharded four-step NTT, the sharded prover step and
prove, the checkpointed header_range scheduler and the communication model.
Port of `vectorx_tpu.parallel`."""
