"""eth2util — the Ethereum consensus-layer primitives the duty workflow
signs: SSZ hash-tree-roots (`ssz`), the phase0/altair spec containers
(`spec`) and the signing domains and signing root (`signing`).

Copies of the JAX package's modules of the same names (the port imports
nothing of that package); its network registry, keystores, deposits and
beacon clients come with a later slice.
"""
