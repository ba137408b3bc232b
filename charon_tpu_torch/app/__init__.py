"""charon_tpu_torch.app — node assembly.

`node.Node` wires one distributed-validator node's core workflow; a test
or `chip_smoke.py` boots n of them in one process (reference:
app/simnet_test.go:57-197 runs a 3-node cluster in one process).  A copy
of the part of the JAX package's app package that the in-process cluster
needs; lifecycle, monitoring, tracing and the run command come with later
slices.
"""
