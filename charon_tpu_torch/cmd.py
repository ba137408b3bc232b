"""charon-tpu CLI of the port — run / dkg / create {cluster,enr,dkg} /
sign / combine / enr / version.

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
without a card ``run`` exits non-zero naming the missing device.  `dkg`
likewise: its lock and deposit verifies and combines run on the card, and
with the ``bls`` scheme and no card it exits non-zero before it dials a
peer.  `create dkg` writes the definition, each operator `sign`s its
entry, and `combine` recombines ≥ t nodes' keystores into the group
secrets, checked against the lock's group keys.
"""

from __future__ import annotations

import argparse
import asyncio
import json
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

    # -- dkg ----------------------------------------------------------------
    dkgp = sub.add_parser("dkg", help="participate in a DKG ceremony")
    dkgp.add_argument("--definition-file",
                      default=_env("definition-file",
                                   ".charon/cluster-definition.json"))
    dkgp.add_argument("--identity-key-file",
                      default=_env("identity-key-file",
                                   ".charon/charon-enr-private-key"))
    dkgp.add_argument("--output-dir", default=_env("output-dir", ".charon"))
    dkgp.add_argument("--algorithm", default=_env("algorithm", None))
    dkgp.add_argument("--no-verify", action="store_true",
                      default=_env("no-verify") == "true",
                      help="skip operator signature verification on the "
                           "definition")

    # -- create {cluster,enr,dkg} -------------------------------------------
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

    cd = csub.add_parser("dkg", help="create a cluster definition for DKG")
    cd.add_argument("--name", default="charon-tpu-cluster")
    cd.add_argument("--operator-enrs", required=True,
                    help="comma-separated operator ENR records")
    cd.add_argument("--threshold", type=int, default=0)
    cd.add_argument("--num-validators", type=int, default=1)
    cd.add_argument("--fork-version", default="0x00000000")
    cd.add_argument("--dkg-algorithm", default="default")
    cd.add_argument("--output-file", default="cluster-definition.json")

    # -- sign ---------------------------------------------------------------
    signp = sub.add_parser(
        "sign",
        help="sign your operator entry in a cluster definition "
             "(each operator runs this before the DKG)")
    signp.add_argument("--definition-file",
                       default=_env("definition-file",
                                    "cluster-definition.json"))
    signp.add_argument("--identity-key-file",
                       default=_env("identity-key-file",
                                    ".charon/charon-enr-private-key"))

    # -- combine ------------------------------------------------------------
    comb = sub.add_parser(
        "combine",
        help="recombine threshold key shares into the group secret "
             "(reference: testutil/combine)")
    comb.add_argument("--cluster-dir", required=True,
                      help="dir with node*/validator_keys keystores")
    comb.add_argument("--output-dir", default="./combined")
    comb.add_argument("--tbls-scheme", default="bls",
                      choices=["bls", "insecure-test"])

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
        "dkg": _cmd_dkg,
        "create": _cmd_create,
        "sign": _cmd_sign,
        "combine": _cmd_combine,
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


def _cmd_dkg(args) -> int:
    from .cluster.definition import (definition_from_json, load_json,
                                     verify_definition_signatures)
    from .dkg.ceremony import run_dkg
    from .ops import launch_count
    from .p2p import identity as ident
    from .p2p.transport import TCPMesh, mesh_params_from_definition
    from .tbls import api as tbls
    from .tbls import dispatch

    if tbls.scheme_name() == "bls":
        # the ceremony's verifies and combines need the card's backend:
        # with no card, stop here rather than after the keygen rounds
        try:
            tbls.backend_name()
        except RuntimeError as exc:
            print(f"error: dkg: {exc}", file=sys.stderr)
            return 1

    async def main() -> None:
        definition = definition_from_json(load_json(args.definition_file))
        if not args.no_verify:
            # Default-ON: a stripped/unsigned definition is an ERROR, not a
            # silent skip — otherwise a MITM bypasses verification by
            # deleting signatures.  --no-verify is the only opt-out.
            verify_definition_signatures(definition)
        # async-ok: boot-time one-shot read, before the mesh starts
        with open(args.identity_key_file) as f:
            identity = ident.NodeIdentity.from_bytes(
                bytes.fromhex(f.read().strip()))
        peers, pubs = mesh_params_from_definition(definition)
        index = next(i for i, pub in pubs.items()
                     if pub == identity.pubkey)
        mesh = TCPMesh(index, peers, identity, pubs)
        await mesh.start()
        try:
            lock = await run_dkg(definition, mesh, index, args.output_dir,
                                 algorithm=args.algorithm)
            print(f"dkg complete: lock hash 0x{lock.lock_hash.hex()}")
            # the ceremony's device work in this process (nothing under
            # the insecure-test scheme)
            print("dkg: kernel launches " + json.dumps(
                {k: n for k, n in launch_count.process_launches().items()
                 if n}))
        finally:
            await mesh.stop()

    try:
        asyncio.run(main())
    finally:
        pipe = dispatch.current_pipeline()
        if pipe is not None:
            pipe.shutdown()
    return 0


def _cmd_create(args) -> int:
    if args.create_cmd == "cluster":
        return _create_cluster(args)
    if args.create_cmd == "enr":
        return _create_enr(args)
    if args.create_cmd == "dkg":
        return _create_dkg(args)
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


def _create_dkg(args) -> int:
    import math

    from .cluster.definition import (Definition, Operator,
                                     definition_to_json, save_json)

    enrs = [e.strip() for e in args.operator_enrs.split(",") if e.strip()]
    threshold = args.threshold or math.ceil(len(enrs) * 2 / 3)
    definition = Definition(
        name=args.name,
        operators=tuple(Operator(address=f"op{i}", enr=enr)
                        for i, enr in enumerate(enrs)),
        threshold=threshold,
        num_validators=args.num_validators,
        fork_version=bytes.fromhex(args.fork_version[2:]),
        dkg_algorithm=args.dkg_algorithm)
    save_json(args.output_file, definition_to_json(definition))
    print(f"wrote {args.output_file}")
    return 0


def _cmd_sign(args) -> int:
    """Sign this operator's entry in a shared cluster definition — the
    distributed-flow counterpart of create-cluster's local signing: each
    operator runs `sign` on the definition file, then operators exchange /
    merge the signed file before `dkg` (which verifies default-on)."""
    from .cluster.definition import (definition_from_json,
                                     definition_to_json, load_json,
                                     save_json, sign_operator)
    from .p2p import identity as ident

    definition = definition_from_json(load_json(args.definition_file))
    with open(args.identity_key_file) as f:
        nid = ident.NodeIdentity.from_bytes(bytes.fromhex(f.read().strip()))
    op_index = None
    for i, op in enumerate(definition.operators):
        pub, _, _ = ident.enr_parse(op.enr)
        if pub == nid.pubkey:
            op_index = i
            break
    if op_index is None:
        print("error: identity key does not match any operator ENR",
              file=sys.stderr)
        return 1
    definition = sign_operator(definition, op_index, nid)
    save_json(args.definition_file, definition_to_json(definition))
    print(f"signed operator {op_index} in {args.definition_file}")
    return 0


def _cmd_combine(args) -> int:
    """Recombine per-node share keystores into group secrets — the escape
    hatch for leaving a cluster (reference: testutil/combine/main.go).
    Requires ≥ threshold node directories' keystores.  The lock is
    verified on load, on the card under the bls scheme."""
    import glob

    from .cluster.definition import load_json, lock_from_json
    from .eth2util import keystore
    from .tbls import api as tbls

    if args.tbls_scheme != "bls":
        tbls.set_scheme(args.tbls_scheme)
    node_dirs = sorted(glob.glob(os.path.join(args.cluster_dir, "node*")))
    if not node_dirs:
        print("error: no node*/ dirs found", file=sys.stderr)
        return 1
    lock = lock_from_json(
        load_json(os.path.join(node_dirs[0], "cluster-lock.json")))
    threshold = lock.definition.threshold

    # share_idx (1-based) is the operator index + 1; collect per validator
    shares_by_val: dict[int, dict[int, bytes]] = {
        v: {} for v in range(len(lock.validators))}
    for d in node_dirs:
        idx = int(os.path.basename(d).removeprefix("node")) + 1
        ks_dir = os.path.join(d, "validator_keys")
        if not os.path.isdir(ks_dir):
            continue
        for v, sk in enumerate(keystore.load_keys(ks_dir)):
            shares_by_val[v][idx] = sk
    os.makedirs(args.output_dir, exist_ok=True)
    secrets_out = []
    for v, dv in enumerate(lock.validators):
        shares = shares_by_val[v]
        if len(shares) < threshold:
            print(f"error: validator {v}: {len(shares)} shares < "
                  f"threshold {threshold}", file=sys.stderr)
            return 1
        take = dict(list(shares.items())[:threshold])
        group_sk = tbls.combine_shares(take)
        if tbls.privkey_to_pubkey(group_sk) != dv.public_key:
            print(f"error: validator {v}: recombined secret does not match "
                  "the lock's group pubkey", file=sys.stderr)
            return 1
        secrets_out.append(group_sk)
    keystore.store_keys(secrets_out, args.output_dir)
    print(f"recombined {len(secrets_out)} validator secrets "
          f"into {args.output_dir}")
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
