"""charon-tpu CLI of the port — run / create {cluster,enr} / enr / version.

Mirrors reference cmd/cmd.go:45-76 (cobra command tree) with argparse.
Flag values default from CHARON_TPU_<FLAG> environment variables, matching
the reference's env > flag precedence (cmd/cmd.go:78-136 viper binding).

The JAX package's cmd.py for these commands, with its flag names.  `run`
serves the validator API to VCs at ``--validator-api-address`` (default
127.0.0.1:3600), and takes ``--simnet-duties`` (the duty mix the
scheduler fetches and the ``--simnet-validator-mock`` VCs sign; a flow
marked ``:vc`` is left to the VCs on the validator API).  Its
verifies and combines run on the card; ``--tbls-scheme insecure-test``
is the only way to the CPU, and with the ``bls`` scheme on a machine
without a card ``run`` exits non-zero naming the missing device.  `dkg`, `sign`,
`combine` and `create dkg` wait for the DKG slice.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import time


def _env(flag: str, default=None):
    return os.environ.get("CHARON_TPU_" + flag.upper().replace("-", "_"),
                          default)


def _addr(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return host or "127.0.0.1", int(port)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="charon-tpu",
                                description="distributed validator "
                                            "middleware on an NVIDIA card")
    sub = p.add_subparsers(dest="cmd", required=True)

    # -- run ----------------------------------------------------------------
    runp = sub.add_parser("run", help="run the charon-tpu DV middleware")
    runp.add_argument("--lock-file", default=_env("lock-file",
                                                  ".charon/cluster-lock.json"))
    runp.add_argument("--identity-key-file",
                      default=_env("identity-key-file",
                                   ".charon/charon-enr-private-key"))
    runp.add_argument("--beacon-node-endpoints",
                      default=_env("beacon-node-endpoints", ""),
                      help="comma-separated beacon-API base URLs")
    runp.add_argument("--validator-api-address",
                      default=_env("validator-api-address", "127.0.0.1:3600"))
    runp.add_argument("--monitoring-address",
                      default=_env("monitoring-address", "127.0.0.1:3620"))
    runp.add_argument("--builder-api", action="store_true",
                      default=_env("builder-api") == "true")
    runp.add_argument("--no-verify", action="store_true",
                      default=_env("no-verify") == "true")
    runp.add_argument("--simnet-validator-mock", action="store_true",
                      default=_env("simnet-validator-mock") == "true")
    runp.add_argument("--simnet-beacon-mock", action="store_true",
                      default=_env("simnet-beacon-mock") == "true",
                      help="run an in-process HTTP beacon mock "
                           "(1s slots) instead of a real BN")
    runp.add_argument("--keystore-dir", default=_env("keystore-dir", ""))
    runp.add_argument("--simnet-duties", default=_env("simnet-duties", ""),
                      help="comma-separated duty flows the scheduler "
                           "fetches and the validator mock signs (attester, "
                           "proposer, sync_message, sync_contribution; "
                           "default all); a flow marked :vc (attester:vc) "
                           "is left to the VCs on --validator-api-address")
    runp.add_argument("--feature-enable", action="append", default=[])
    runp.add_argument("--feature-disable", action="append", default=[])
    runp.add_argument("--tbls-scheme", default=_env("tbls-scheme", "bls"),
                      choices=["bls", "insecure-test"],
                      help="insecure-test is for smoke/compose testing only")

    # -- create {cluster,enr} -----------------------------------------------
    createp = sub.add_parser("create", help="create cluster artifacts")
    csub = createp.add_subparsers(dest="create_cmd", required=True)

    cc = csub.add_parser("cluster",
                         help="create a full local cluster (keys + lock)")
    cc.add_argument("--name", default="charon-tpu-cluster")
    cc.add_argument("--nodes", type=int, default=4)
    cc.add_argument("--threshold", type=int, default=0,
                    help="default ceil(2n/3)")
    cc.add_argument("--num-validators", type=int, default=1)
    cc.add_argument("--fork-version", default="0x00000000")
    cc.add_argument("--cluster-dir", default="./cluster")
    cc.add_argument("--base-port", type=int, default=16000)
    cc.add_argument("--tbls-scheme", default="bls",
                    choices=["bls", "insecure-test"])

    ce = csub.add_parser("enr", help="create a new identity key + ENR")
    ce.add_argument("--data-dir", default=".charon")
    ce.add_argument("--host", default="127.0.0.1")
    ce.add_argument("--port", type=int, default=0)

    # -- enr / version ------------------------------------------------------
    enrp = sub.add_parser("enr", help="print this node's ENR record")
    enrp.add_argument("--identity-key-file",
                      default=_env("identity-key-file",
                                   ".charon/charon-enr-private-key"))
    enrp.add_argument("--host", default="")
    enrp.add_argument("--port", type=int, default=0)

    sub.add_parser("version", help="print version")

    args = p.parse_args(argv)
    return {
        "run": _cmd_run,
        "create": _cmd_create,
        "enr": _cmd_enr,
        "version": _cmd_version,
    }[args.cmd](args)


# ---------------------------------------------------------------------------
# command implementations
# ---------------------------------------------------------------------------

def _cmd_run(args) -> int:
    import logging
    import signal

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    t0 = time.perf_counter()
    from .app.run import App, RunConfig
    from .tbls import api as tbls
    from .tbls import dispatch

    if args.tbls_scheme != "bls":
        tbls.set_scheme(args.tbls_scheme)
    import_s = time.perf_counter() - t0

    async def main() -> None:
        bmock_server = None
        urls = [u for u in args.beacon_node_endpoints.split(",") if u]
        if args.simnet_beacon_mock:
            from .cluster.definition import load_json, lock_from_json
            from .core.types import pubkey_from_bytes
            from .testutil.beaconmock import BeaconMock
            from .testutil.beaconmock_http import BeaconMockServer

            lock = lock_from_json(load_json(args.lock_file), verify=False)
            bmock = BeaconMock(slot_duration=1.0, slots_per_epoch=16)
            for v in lock.validators:
                bmock.add_validator(pubkey_from_bytes(v.public_key))
            bmock_server = BeaconMockServer(bmock)
            await bmock_server.start()
            urls = [bmock_server.addr]
        if not urls:
            print("error: --beacon-node-endpoints required", file=sys.stderr)
            raise SystemExit(2)

        vapi_host, vapi_port = _addr(args.validator_api_address)
        mon_host, mon_port = _addr(args.monitoring_address)
        cfg = RunConfig(
            lock_file=args.lock_file,
            identity_key_file=args.identity_key_file,
            beacon_urls=urls,
            vapi_host=vapi_host, vapi_port=vapi_port,
            monitoring_host=mon_host, monitoring_port=mon_port,
            builder_api=args.builder_api,
            no_verify_lock=args.no_verify,
            simnet_vmock=args.simnet_validator_mock,
            keystore_dir=args.keystore_dir or os.path.join(
                os.path.dirname(args.lock_file), "validator_keys"),
            features_enabled=args.feature_enable,
            features_disabled=args.feature_disable,
            simnet_duties=tuple(d for d in args.simnet_duties.split(",")
                                if d),
        )
        app = App(cfg)
        app.boot_seconds["import"] = import_s
        loop = asyncio.get_running_loop()
        stopping: list = []

        def on_signal(signum, frame) -> None:
            # the first SIGINT / SIGTERM stops the App; any later one is
            # ignored.  A process-level handler, not the loop's, which
            # would be gone once the loop closes
            if not stopping:
                stopping.append(signum)
                loop.call_soon_threadsafe(app.stop)

        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, on_signal)
        try:
            await app.run()
        finally:
            if bmock_server is not None:
                await bmock_server.stop()

    try:
        asyncio.run(main())
    finally:
        pipe = dispatch.current_pipeline()
        if pipe is not None:
            pipe.shutdown()
        # the interpreter's exit resets Python-level handlers to the
        # default, which a second SIGTERM would die by: ignore it
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, signal.SIG_IGN)
    return 0


def _cmd_create(args) -> int:
    if args.create_cmd == "cluster":
        return _create_cluster(args)
    if args.create_cmd == "enr":
        return _create_enr(args)
    return 2


def _create_cluster(args) -> int:
    """Local trusted-dealer cluster creation — keys, lock, keystores for
    every node (reference: cmd/createcluster.go)."""
    import math

    from .cluster.definition import (Definition, DistValidator, Lock,
                                     Operator, lock_hash, lock_to_json,
                                     save_json, sign_operator)
    from .eth2util import deposit as deposit_mod
    from .eth2util import keystore
    from .eth2util.spec import DepositData
    from .p2p import identity as ident
    from .tbls import api as tbls

    if args.tbls_scheme != "bls":
        tbls.set_scheme(args.tbls_scheme)
    n = args.nodes
    threshold = args.threshold or math.ceil(n * 2 / 3)
    fork = bytes.fromhex(args.fork_version[2:])

    identities = [ident.NodeIdentity.generate() for _ in range(n)]
    operators = tuple(
        Operator(address=f"op{i}",
                 enr=nid.enr("127.0.0.1", args.base_port + i))
        for i, nid in enumerate(identities))
    definition = Definition(name=args.name, operators=operators,
                            threshold=threshold,
                            num_validators=args.num_validators,
                            fork_version=fork)
    # every operator signs the config terms + their ENR with the identity
    # key pinned in that ENR (reference: cluster EIP-712 signatures)
    for i, nid in enumerate(identities):
        definition = sign_operator(definition, i, nid)

    tsses, shares_by_val = [], []
    for _ in range(args.num_validators):
        tss, shares = tbls.generate_tss(threshold, n)
        tsses.append(tss)
        shares_by_val.append(shares)
    validators = tuple(
        DistValidator(
            public_key=tss.group_pubkey,
            public_shares=tuple(tss.public_share(i + 1) for i in range(n)))
        for tss in tsses)

    # lock signature: per-validator group signature over the lock hash
    msg = lock_hash(Lock(definition=definition, validators=validators))
    group_sigs, deposits = [], []
    creds = deposit_mod.withdrawal_credentials(b"\x00" * 20)
    for tss, shares in zip(tsses, shares_by_val):
        group_sk = tbls.combine_shares(shares)
        group_sigs.append(tbls.sign(group_sk, msg))
        droot = deposit_mod.deposit_signing_root(
            tss.group_pubkey, creds, fork)
        deposits.append(DepositData(
            pubkey=tss.group_pubkey, withdrawal_credentials=creds,
            amount=deposit_mod.DEPOSIT_AMOUNT_GWEI,
            signature=tbls.sign(group_sk, droot)))
    lock = Lock(definition=definition, validators=validators,
                signature_aggregate=b"".join(group_sigs))

    for i in range(n):
        node_dir = os.path.join(args.cluster_dir, f"node{i}")
        os.makedirs(node_dir, exist_ok=True)
        with open(os.path.join(node_dir, "charon-enr-private-key"),
                  "w") as f:
            f.write(identities[i].to_bytes().hex())
        save_json(os.path.join(node_dir, "cluster-lock.json"),
                  lock_to_json(lock))
        keystore.store_keys(
            [shares[i + 1] for shares in shares_by_val],
            os.path.join(node_dir, "validator_keys"))
        deposit_mod.save_deposit_data(
            os.path.join(node_dir, "deposit-data.json"), deposits, fork)
    print(f"created {n}-node cluster (threshold {threshold}, "
          f"{args.num_validators} validators) in {args.cluster_dir}")
    print(f"lock hash: 0x{lock.lock_hash.hex()}")
    return 0


def _create_enr(args) -> int:
    from .p2p import identity as ident

    os.makedirs(args.data_dir, exist_ok=True)
    path = os.path.join(args.data_dir, "charon-enr-private-key")
    if os.path.exists(path):
        print(f"error: {path} already exists", file=sys.stderr)
        return 1
    nid = ident.NodeIdentity.generate()
    with open(path, "w") as f:
        f.write(nid.to_bytes().hex())
    print(nid.enr(args.host, args.port))
    return 0


def _cmd_enr(args) -> int:
    from .p2p import identity as ident

    with open(args.identity_key_file) as f:
        nid = ident.NodeIdentity.from_bytes(bytes.fromhex(f.read().strip()))
    print(nid.enr(args.host, args.port))
    return 0


def _cmd_version(args) -> int:
    from .app.run import VERSION

    print(VERSION)
    return 0


if __name__ == "__main__":
    sys.exit(main())
