"""charon_tpu_torch.p2p — authenticated-encrypted TCP mesh between cluster
nodes.

The reference's cluster transport is libp2p TCP + discv5 UDP + circuit
relays (reference: p2p/).  This re-design keeps what makes that layer
work — a full n² direct mesh, protocol-ID routing, the
`send`/`register_handler` abstraction that lets every protocol be unit-
tested in memory — on asyncio TCP with per-node Ed25519 identities, a
signed-ephemeral X25519 handshake and ChaCha20-Poly1305 frames (see
transport.py for the threat model).  Discovery is static peer addressing
from the cluster lock.

The JAX package's p2p package, with its primitives from the standard
library and numpy (`ed25519.py`, `aead.py`) in place of `cryptography`.
"""

from .identity import NodeIdentity, enr_parse, verify as verify_sig
from .transport import Peer, TCPMesh, new_test_identities

__all__ = ["Peer", "TCPMesh", "NodeIdentity", "enr_parse", "verify_sig",
           "new_test_identities"]
