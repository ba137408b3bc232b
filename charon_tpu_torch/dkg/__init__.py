"""charon_tpu_torch.dkg — distributed key generation ceremony.

Mirrors the reference's dkg package (reference: dkg/): a ceremony runner
(`ceremony.run_dkg`) that takes a cluster Definition, connects the
operators over the p2p mesh, runs a keygen algorithm, signs/exchanges/
aggregates the lock-hash and deposit-data signatures, and writes
keystores + cluster-lock.json + deposit-data.json.

Keygen algorithms:
- `keycast`   trusted-dealer split (reference: dkg/keycast.go:34-233)
- `pedersen`  2-round Feldman/Pedersen DKG, one instance per validator
  run in parallel over shared transport rounds — the reference's FROST
  DKG shape (reference: dkg/frost.go:33-125)

A copy of the JAX package's dkg package, on this package's tbls, cluster,
eth2util and p2p modules: the same protocol IDs and JSON payloads, so
operators of both packages share one ceremony.  The ceremony's batched
verifies and combines run on the card through `tbls.dispatch`; the
Feldman round-2 math is host code, as in the JAX package.
"""

from .keygen import KeygenResult, keycast_deal, pedersen_round1, pedersen_round2

__all__ = ["KeygenResult", "keycast_deal", "pedersen_round1",
           "pedersen_round2"]
