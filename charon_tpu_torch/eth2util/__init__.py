"""eth2util — the Ethereum consensus-layer primitives the duty workflow
signs: SSZ hash-tree-roots (`ssz`), the phase0/altair spec containers
(`spec`) and the signing domains and signing root (`signing`); beside
them the beacon-API codecs and clients, keystores, deposits, the network
registry and the synthetic-proposer wrapper.

Copies of the JAX package's modules of the same names (the port imports
nothing of that package).
"""
