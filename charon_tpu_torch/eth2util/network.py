"""Network registry: fork versions ↔ named networks.

Mirrors reference eth2util/network.go:66-119 (ForkVersionToNetwork /
NetworkToForkVersion / validNetworks).

A copy of the JAX package's eth2util/network.py.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Network:
    name: str
    fork_version: bytes
    chain_id: int


NETWORKS = {
    n.name: n
    for n in (
        Network("mainnet", bytes.fromhex("00000000"), 1),
        Network("goerli", bytes.fromhex("00001020"), 5),
        Network("prater", bytes.fromhex("00001020"), 5),
        Network("gnosis", bytes.fromhex("00000064"), 100),
        Network("sepolia", bytes.fromhex("90000069"), 11155111),
        Network("ropsten", bytes.fromhex("80000069"), 3),
        Network("kiln", bytes.fromhex("70000069"), 1337802),
    )
}


def fork_version_to_network(fork_version: bytes) -> str:
    for n in NETWORKS.values():
        if n.fork_version == fork_version:
            return n.name
    return "simnet"


def network_to_fork_version(name: str) -> bytes:
    if name in NETWORKS:
        return NETWORKS[name].fork_version
    if name == "simnet":
        return bytes.fromhex("00000000")
    raise ValueError(f"unknown network {name!r}")


def fork_version_to_chain_id(fork_version: bytes) -> int:
    for n in NETWORKS.values():
        if n.fork_version == fork_version:
            return n.chain_id
    return 1  # simnet defaults to mainnet chain id
