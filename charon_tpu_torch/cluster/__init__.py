"""charon_tpu_torch.cluster — cluster definition / lock file formats.

Mirrors the reference's cluster package (reference: cluster/): the
Definition (operator intent, signed) and the Lock (definition + the
distributed validators' public keys and pubshares + BLS aggregate
signature over the lock hash).  Hashes are SSZ tree roots over the
eth2util.ssz schema (reference: cluster/ssz.go), so lock hashing is
deterministic and versioned.  A copy of the JAX package's cluster
package: a lock written by either package loads in the other.
"""

from .definition import (Definition, DistValidator, Lock, Operator,
                         definition_hash, lock_hash)

__all__ = ["Definition", "DistValidator", "Lock", "Operator",
           "definition_hash", "lock_hash"]
