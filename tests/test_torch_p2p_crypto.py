"""The port's standard-library primitives against `cryptography`, byte for
byte and verdict for verdict: Ed25519 (`p2p/ed25519.py`), X25519 and
ChaCha20-Poly1305 (`p2p/aead.py`), AES-128-CTR (`eth2util/aes.py`), on
hypothesis-drawn inputs and on crafted edge cases (S ≥ L, non-canonical
R and A, small-order keys, wrong lengths, all-zero shared secrets,
forged tags); and the port's `NodeIdentity` against the JAX package's.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cryptography.exceptions import InvalidSignature, InvalidTag
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey, Ed25519PublicKey)
from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey, X25519PublicKey)
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

from charon_tpu.p2p import identity as jident
from charon_tpu_torch.eth2util import aes
from charon_tpu_torch.p2p import aead, ed25519
from charon_tpu_torch.p2p import identity as ident

FEW = settings(max_examples=12, deadline=None)
P, L = ed25519.P, ed25519.L


def ref_verify(pub: bytes, sig: bytes, msg: bytes) -> bool:
    try:
        Ed25519PublicKey.from_public_bytes(pub).verify(sig, msg)
        return True
    except (InvalidSignature, ValueError):
        return False


def ref_x25519(k: bytes, u: bytes):
    try:
        return X25519PrivateKey.from_private_bytes(k).exchange(
            X25519PublicKey.from_public_bytes(u))
    except ValueError:
        return None


def port_x25519(k: bytes, u: bytes):
    try:
        return aead.x25519(k, u)
    except ValueError:
        return None


@FEW
@given(seed=st.binary(min_size=32, max_size=32), msg=st.binary(max_size=300))
def test_ed25519_keys_and_signatures_equal_cryptography(seed, msg):
    key = Ed25519PrivateKey.from_private_bytes(seed)
    pub = key.public_key().public_bytes_raw()
    sig = key.sign(msg)
    assert ed25519.public_key(seed) == pub
    assert ed25519.sign(seed, msg) == sig
    assert ed25519.verify(pub, sig, msg)
    assert not ed25519.verify(pub, sig, msg + b"\x00")
    bad = bytearray(sig)
    bad[5] ^= 1
    assert not ed25519.verify(pub, bytes(bad), msg)


#: y of the order-8 points (±), with 1 (the identity), p − 1 (order 2) and
#: 0 (order 4)
_SMALL_Y = (1, P - 1, 0,
            2707385501144840649318225287225658788936804267575313519463743609750303402022)


def _edge_cases():
    seed = bytes(range(32))
    msg = b"edge"
    pub = ed25519.public_key(seed)
    sig = ed25519.sign(seed, msg)
    s = int.from_bytes(sig[32:], "little")
    r = int.from_bytes(sig[:32], "little")
    yield "valid", pub, sig, msg
    yield "S + L", pub, sig[:32] + (s + L).to_bytes(32, "little"), msg
    yield "S = L", pub, sig[:32] + L.to_bytes(32, "little"), msg
    yield "R sign flipped", pub, (r ^ 1 << 255).to_bytes(32, "little") \
        + sig[32:], msg
    yield "R + p (non-canonical)", (1).to_bytes(32, "little"), \
        (1 + P).to_bytes(32, "little") + bytes(32), msg
    yield "short signature", pub, sig[:63], msg
    yield "long signature", pub, sig + b"\x00", msg
    yield "short key", pub[:31], sig, msg
    yield "key off the curve", (2).to_bytes(32, "little"), sig, msg
    ident_r = (1).to_bytes(32, "little")
    for y in _SMALL_Y + (P - _SMALL_Y[-1],):
        for sign in (0, 1):
            a = (y | sign << 255).to_bytes(32, "little")
            for rr in (ident_r, a):
                for ss in (0, 1):
                    yield (f"small-order key y={y % 997} sign={sign} "
                           f"S={ss}", a, rr + ss.to_bytes(32, "little"), msg)
    for y in range(19):  # y + p: non-canonical encodings of small y
        for sign in (0, 1):
            a = ((y + P) | sign << 255).to_bytes(32, "little")
            for rr in (ident_r, a):
                yield f"non-canonical key y={y}+p sign={sign}", a, \
                    rr + bytes(32), msg


@pytest.mark.parametrize("case", list(_edge_cases()), ids=lambda c: c[0])
def test_ed25519_edge_cases_accept_and_reject_as_cryptography(case):
    _, pub, sig, msg = case
    assert ed25519.verify(pub, sig, msg) == ref_verify(pub, sig, msg)


def test_ed25519_edge_cases_include_accepted_small_order_keys():
    """The sweep is not all rejections: cryptography accepts some
    small-order and non-canonical keys, and so does the port."""
    accepted = [c[0] for c in _edge_cases() if ref_verify(*c[1:])]
    assert "valid" in accepted and len(accepted) > 1


@FEW
@given(k=st.binary(min_size=32, max_size=32),
       u=st.binary(min_size=32, max_size=32))
def test_x25519_equals_cryptography(k, u):
    assert aead.x25519_public(k) == X25519PrivateKey.from_private_bytes(
        k).public_key().public_bytes_raw()
    assert port_x25519(k, u) == ref_x25519(k, u)


@pytest.mark.parametrize("u", [0, 1, P - 1, P, P + 1, 2**255 - 1,
                               325606250916557431795983626356110631294008115727848805560023387167927233504],
                         ids=["0", "1", "p-1", "p", "p+1", "2^255-1",
                              "order-8"])
def test_x25519_small_order_points_raise_as_cryptography(u):
    """All-zero shared secrets raise in both, so a handshake with a
    small-order ephemeral fails on either side."""
    k = bytes(range(1, 33))
    ub = u.to_bytes(32, "little")
    assert port_x25519(k, ub) == ref_x25519(k, ub)
    if ref_x25519(k, ub) is None:
        with pytest.raises(ValueError):
            aead.x25519(k, ub)


def test_x25519_rejects_wrong_lengths():
    with pytest.raises(ValueError):
        aead.x25519(bytes(31), bytes(32))
    with pytest.raises(ValueError):
        aead.x25519(bytes(32), bytes(33))


@FEW
@given(key=st.binary(min_size=32, max_size=32),
       nonce=st.binary(min_size=12, max_size=12),
       data=st.binary(max_size=700), ad=st.binary(max_size=40))
def test_chacha20_poly1305_equals_cryptography(key, nonce, data, ad):
    ct = ChaCha20Poly1305(key).encrypt(nonce, data, ad or None)
    port = aead.ChaCha20Poly1305(key)
    assert port.encrypt(nonce, data, ad or None) == ct
    assert port.decrypt(nonce, ct, ad or None) == data


@pytest.mark.parametrize("size", [0, 1, 63, 64, 65, 1024, 65536])
def test_chacha20_poly1305_frames_and_forgeries(size):
    key, nonce = bytes(range(32)), bytes(4) + (7).to_bytes(8, "big")
    data = bytes((i * 31 + 7) % 256 for i in range(size))
    ref = ChaCha20Poly1305(key)
    port = aead.ChaCha20Poly1305(key)
    ct = ref.encrypt(nonce, data, None)
    assert port.encrypt(nonce, data, None) == ct
    assert port.decrypt(nonce, ct, None) == data
    for i in (0, len(ct) - 1, len(ct) // 2):
        bad = bytearray(ct)
        bad[i] ^= 0x80
        with pytest.raises(InvalidTag):
            ref.decrypt(nonce, bytes(bad), None)
        with pytest.raises(aead.InvalidTag):
            port.decrypt(nonce, bytes(bad), None)
    with pytest.raises(aead.InvalidTag):
        port.decrypt(nonce, ct[:15], None)
    with pytest.raises(aead.InvalidTag):
        port.decrypt(bytes(4) + (8).to_bytes(8, "big"), ct, None)


def test_chacha20_block_of_rfc8439():
    """RFC 8439 §2.3.2's test vector."""
    key = bytes(range(32))
    nonce = bytes.fromhex("000000090000004a00000000")
    want = bytes.fromhex(
        "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
        "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")
    assert aead.chacha20_blocks(key, 1, nonce, 1) == want


@FEW
@given(key=st.binary(min_size=16, max_size=16),
       iv=st.binary(min_size=16, max_size=16), data=st.binary(max_size=100))
def test_aes128_ctr_equals_cryptography(key, iv, data):
    enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    assert aes.ctr(key, iv, data) == enc.update(data) + enc.finalize()


def test_aes128_fips197_vector_and_counter_wrap():
    """FIPS-197 Appendix C.1, and a counter that wraps past 2¹²⁸ − 1."""
    rk = aes.expand_key(bytes(range(16)))
    assert aes.encrypt_block(rk, bytes.fromhex(
        "00112233445566778899aabbccddeeff")).hex() == \
        "69c4e0d86a7b0430d8cdb78070b4c55a"
    key, iv, data = bytes(16), b"\xff" * 16, bytes(range(48))
    enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    assert aes.ctr(key, iv, data) == enc.update(data) + enc.finalize()


def test_aes_sbox_is_derived_and_a_permutation():
    assert aes.SBOX[0] == 0x63 and aes.SBOX[0x53] == 0xED
    assert sorted(aes.SBOX) == list(range(256))


@pytest.mark.parametrize("seed", [b"", b"node-0", b"test-cluster\x03"])
def test_node_identity_equals_the_jax_package(seed):
    mine, theirs = ident.NodeIdentity.generate(seed), \
        jident.NodeIdentity.generate(seed)
    assert mine.pubkey == theirs.pubkey
    assert mine.to_bytes() == theirs.to_bytes()
    assert mine.enr() == theirs.enr()
    assert mine.enr("10.0.0.1", 3610) == theirs.enr("10.0.0.1", 3610)
    for data in (b"", b"init" + bytes(96), b"x" * 1000):
        assert mine.sign(data) == theirs.sign(data)
        assert jident.verify(mine.pubkey, mine.sign(data), data)
        assert ident.verify(theirs.pubkey, theirs.sign(data), data)
    assert ident.enr_parse(mine.enr("h", 1)) == jident.enr_parse(
        theirs.enr("h", 1))
    back = ident.NodeIdentity.from_bytes(mine.to_bytes())
    assert back.pubkey == mine.pubkey
