"""The port's Noise XX against the JAX package's.

- tests/test_noise.py's cases pointed at `spacedrive_tpu_torch.p2p.noise`:
  the spec invariants, the negative cases, the cacophony corpus where it
  is present (it skips, as JAX's does, when the corpus is absent), the
  pinned transcript and the straight-line derivation;
- under pinned keys, each handshake message, the handshake hash and the
  first transport record are JAX's bytes;
- mixed XX handshakes, JAX initiator with port responder and the
  reverse, at the state machine and over TCP on 127.0.0.1 through each
  package's `transport`, with a transcript equal to either package's
  own.
"""

import asyncio
import hashlib
import hmac
import json
import os
from pathlib import Path

import pytest

pytest.importorskip(
    "cryptography",
    reason="Noise tests need the real X25519/ChaCha primitives",
)
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

import spacedrive_tpu.p2p.identity as JI
import spacedrive_tpu.p2p.noise as JN
import spacedrive_tpu.p2p.transport as JT
import spacedrive_tpu_torch.p2p.identity as PI
import spacedrive_tpu_torch.p2p.noise as PN
import spacedrive_tpu_torch.p2p.transport as PT
from spacedrive_tpu_torch.p2p import noise
from spacedrive_tpu_torch.p2p.identity import Identity
from spacedrive_tpu_torch.p2p.noise import (
    CipherState,
    HandshakeState,
    NoiseError,
    _hkdf,
)

VECTORS = Path(__file__).parent / "data" / "noise_vectors.json"


def _pair(prologue=b"pro"):
    i = HandshakeState(True, X25519PrivateKey.generate(), prologue=prologue)
    r = HandshakeState(False, X25519PrivateKey.generate(), prologue=prologue)
    return i, r


def _run_xx(i, r, payloads=(b"", b"", b"")):
    m1 = i.write_message(payloads[0])
    r.read_message(m1)
    m2 = r.write_message(payloads[1])
    i.read_message(m2)
    m3 = i.write_message(payloads[2])
    r.read_message(m3)
    return m1, m2, m3


# --- spec invariants --------------------------------------------------------


def test_xx_message_sizes_match_spec():
    # XX with empty payloads: msg1 = e (32, payload in the clear, no key
    # yet); msg2 = e(32) + enc(s)(48) + enc(payload)(16);
    # msg3 = enc(s)(48) + enc(payload)(16).  Spec §7.5.
    i, r = _pair()
    m1, m2, m3 = _run_xx(i, r)
    assert (len(m1), len(m2), len(m3)) == (32, 96, 64)


def test_xx_agreement_and_transport():
    i, r = _pair()
    _run_xx(i, r, (b"", b"hello-resp", b"hello-init"))
    assert i.handshake_hash == r.handshake_hash  # channel binding §11.2
    si, ri = i.split()
    sr, rr = r.split()
    # initiator→responder direction
    ct = si.encrypt_with_ad(b"", b"data going right")
    assert sr.decrypt_with_ad(b"", ct) == b"data going right"
    # responder→initiator direction
    ct = rr.encrypt_with_ad(b"", b"data going left")
    assert ri.decrypt_with_ad(b"", ct) == b"data going left"


def test_payloads_delivered_encrypted():
    i, r = _pair()
    payload = b"secret-identity-payload"
    m1 = i.write_message(b"")
    r.read_message(m1)
    m2 = r.write_message(payload)
    assert payload not in m2  # msg2 payload is AEAD-protected
    assert i.read_message(m2) == payload


def test_hkdf_matches_direct_hmac_composition():
    ck, ikm = os.urandom(32), os.urandom(32)
    temp = hmac.new(ck, ikm, hashlib.sha256).digest()
    o1 = hmac.new(temp, b"\x01", hashlib.sha256).digest()
    o2 = hmac.new(temp, o1 + b"\x02", hashlib.sha256).digest()
    assert _hkdf(ck, ikm, 2) == (o1, o2)


def test_cipherstate_counter_nonces():
    k = os.urandom(32)
    a, b = CipherState(k), CipherState(k)
    cts = [a.encrypt_with_ad(b"", b"x") for _ in range(3)]
    assert len({bytes(c) for c in cts}) == 3  # distinct nonces
    for ct in cts:
        assert b.decrypt_with_ad(b"", ct) == b"x"
    # failed decrypt must NOT advance the nonce (spec §5.1)
    with pytest.raises(NoiseError):
        b.decrypt_with_ad(b"", b"\x00" * 17)
    ct = a.encrypt_with_ad(b"", b"y")
    assert b.decrypt_with_ad(b"", ct) == b"y"


def test_prologue_mismatch_fails():
    i = HandshakeState(True, X25519PrivateKey.generate(), prologue=b"A")
    r = HandshakeState(False, X25519PrivateKey.generate(), prologue=b"B")
    m1 = i.write_message(b"")
    r.read_message(m1)  # msg1 has no AEAD yet; divergence surfaces at msg2
    m2 = r.write_message(b"")
    with pytest.raises(NoiseError):
        i.read_message(m2)


# --- negative cases (the round-3 ask: replay, swap, truncation) -------------


def test_replayed_final_message_rejected():
    # Record a full session, then replay the initiator's messages at a
    # fresh responder: msg3 is keyed by the NEW responder ephemeral via
    # ee/es, so the replay cannot decrypt.
    i, r = _pair()
    m1, m2, m3 = _run_xx(i, r)
    fresh = HandshakeState(False, X25519PrivateKey.generate(), prologue=b"pro")
    fresh.read_message(m1)
    fresh.write_message(b"")
    with pytest.raises(NoiseError):
        fresh.read_message(m3)


def test_identity_payload_swap_rejected():
    ident, other = Identity(), Identity()
    static_pub = os.urandom(32)
    payload = noise.identity_payload(ident, static_pub)
    assert noise.verify_identity_payload(payload, static_pub) == \
        ident.to_remote_identity()
    # splice another identity's public key over a valid signature
    forged = other.to_remote_identity().to_bytes() + payload[32:]
    with pytest.raises(NoiseError):
        noise.verify_identity_payload(forged, static_pub)
    # rebind the same payload to a different static key
    with pytest.raises(NoiseError):
        noise.verify_identity_payload(payload, os.urandom(32))


def test_malformed_remote_ephemeral_rejected():
    # An all-zero X25519 point (and any low-order point cryptography
    # rejects) must surface as NoiseError from the responder's msg2
    # write, not leak a ValueError through the transport layer.
    r = HandshakeState(False, X25519PrivateKey.generate(), prologue=b"pro")
    r.read_message(b"\x00" * 32)  # msg1: attacker-controlled e, no AEAD yet
    with pytest.raises(NoiseError):
        r.write_message(b"")  # ee DH hits the zero shared secret


def test_truncated_message_rejected():
    i, r = _pair()
    m1 = i.write_message(b"")
    r.read_message(m1)
    m2 = r.write_message(b"payload")
    with pytest.raises(NoiseError):
        i.read_message(m2[: len(m2) - 10])


def test_tampered_message_rejected():
    i, r = _pair()
    m1 = i.write_message(b"")
    r.read_message(m1)
    m2 = bytearray(r.write_message(b""))
    m2[40] ^= 0xFF  # inside enc(s)
    with pytest.raises(NoiseError):
        i.read_message(bytes(m2))


def test_out_of_order_calls_rejected():
    i, r = _pair()
    with pytest.raises(NoiseError):
        i.read_message(b"\x00" * 32)  # initiator writes first
    m1 = i.write_message(b"")
    with pytest.raises(NoiseError):
        i.write_message(b"")  # not initiator's turn
    r.read_message(m1)
    with pytest.raises(NoiseError):
        r.read_message(m1)  # responder's turn to write


def test_split_requires_finished():
    i, _ = _pair()
    with pytest.raises(NoiseError):
        i.split()
    with pytest.raises(NoiseError):
        _ = i.handshake_hash


# --- published vector corpus (cacophony format), when available -------------


@pytest.mark.skipif(not VECTORS.exists(), reason="vector corpus not bundled")
def test_cacophony_vectors():
    """Replays every Noise_XX_25519_ChaChaPoly_SHA256 vector from a
    standard cacophony/snow `vectors.json` dropped at
    tests/data/noise_vectors.json (not bundled: no network egress in
    this environment)."""
    data = json.loads(VECTORS.read_text())
    ran = 0
    for vec in data.get("vectors", []):
        name = vec.get("protocol_name") or vec.get("name")
        if name != "Noise_XX_25519_ChaChaPoly_SHA256":
            continue
        i = HandshakeState(
            True,
            X25519PrivateKey.from_private_bytes(bytes.fromhex(vec["init_static"]))
            if "init_static" in vec
            else X25519PrivateKey.generate(),
            prologue=bytes.fromhex(vec.get("init_prologue", "")),
            e=X25519PrivateKey.from_private_bytes(
                bytes.fromhex(vec["init_ephemeral"])
            ),
        )
        r = HandshakeState(
            False,
            X25519PrivateKey.from_private_bytes(bytes.fromhex(vec["resp_static"])),
            prologue=bytes.fromhex(vec.get("resp_prologue", "")),
            e=X25519PrivateKey.from_private_bytes(
                bytes.fromhex(vec["resp_ephemeral"])
            ),
        )
        states = [(i, r), (r, i), (i, r)]
        for idx, msg in enumerate(vec["messages"][:3]):
            w, rd = states[idx]
            ct = w.write_message(bytes.fromhex(msg["payload"]))
            assert ct.hex() == msg["ciphertext"], f"message {idx}"
            rd.read_message(ct)
        if "handshake_hash" in vec:
            assert i.handshake_hash.hex() == vec["handshake_hash"]
        # transport-phase messages exercise Split() key order and the
        # directional counter nonces; senders keep alternating (msg3 is
        # the responder, msg4 the initiator, …)
        c_i2r, c_r2i = i.split()
        for idx, msg in enumerate(vec["messages"][3:], start=3):
            sender = c_r2i if idx % 2 else c_i2r
            ct = sender.encrypt_with_ad(b"", bytes.fromhex(msg["payload"]))
            assert ct.hex() == msg["ciphertext"], f"transport message {idx}"
        ran += 1
    assert ran > 0, "no XX/25519/ChaChaPoly/SHA256 vectors in corpus"


# --- transcript pinning + independent cross-implementation ----------------
#
# The published cacophony/snow vector corpus cannot be vendored (zero
# egress), so two defenses stand in until it can (VERDICT r4 #6):
# 1. a PINNED full-handshake transcript from fixed keys — any silent
#    KDF/ordering/nonce regression in our implementation trips it;
# 2. an INDEPENDENT straight-line XX implementation below (written
#    from spec §5/§7.5 with none of the production code's structure)
#    must produce byte-identical messages — a deviation that is
#    self-consistent inside the state machine still has to agree with
#    a second from-spec derivation.

_PIN_M1 = "0faa684ed28867b97f4a6a2dee5df8ce974e76b7018e3f22a1c4cf2678570f20"
_PIN_M2 = (
    "ff2ee45601ec1b67310c7790404585ae697331eee1c1f8cf2419731c1fff3e6b"
    "5cda1c2d8029877d73fad62823946ccd0c5da35c129100f43d33a59cf19ea8fc"
    "aded90742efc635ff7e5865f706b2b6a8ff44261f2e570acb78f5db7abfff065"
    "74d3d59310fb18ac4f875475"
)
_PIN_M3 = (
    "f4e4988e97bdcbf0f799d02dd2242624bda72d200e97e322c4f723213896a31e"
    "6addf0834abd1e778afc4aa0bf69452e926339ba70fe4c74f8559dabbce2604b"
    "c5f9ea2ebcdbe3f5408f5e15"
)
_PIN_HH = "c339ecf420ac4b9337f4dd1c083cf2837eeda9794c9f9eca609516d9c830b8d5"
_PIN_T1 = ("412fcad3f556a5e5258dacc7b3507a2fe4ccd8f3264efeb5a55f27d1"
           "acc7f451124bcbbde14b")


def _fixed_key(byte: int):
    return X25519PrivateKey.from_private_bytes(bytes([byte]) * 32)


def test_transcript_pinned():
    """Fixed statics/ephemerals → the full XX transcript, handshake
    hash, and first transport record are pinned byte-for-byte."""
    i = HandshakeState(True, _fixed_key(0x11), prologue=b"sdx-pin",
                       e=_fixed_key(0x22))
    r = HandshakeState(False, _fixed_key(0x33), prologue=b"sdx-pin",
                       e=_fixed_key(0x44))
    m1 = i.write_message(b"")
    r.read_message(m1)
    m2 = r.write_message(b"resp-payload")
    i.read_message(m2)
    m3 = i.write_message(b"init-payload")
    r.read_message(m3)
    assert m1.hex() == _PIN_M1
    assert m2.hex() == _PIN_M2
    assert m3.hex() == _PIN_M3
    hh = i.handshake_hash
    hh = hh() if callable(hh) else hh
    assert hh.hex() == _PIN_HH
    ci_send, _ci_recv = i.split()
    assert ci_send.encrypt_with_ad(
        b"", b"first-transport-record").hex() == _PIN_T1


def test_independent_straightline_xx_agrees():
    """A second, structurally unrelated XX derivation (straight-line
    code, its own HKDF/cipher plumbing) reproduces the same pinned
    transcript from the same fixed keys."""
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

    name = b"Noise_XX_25519_ChaChaPoly_SHA256"
    h = name + b"\x00" * (32 - len(name)) if len(name) <= 32 \
        else hashlib.sha256(name).digest()
    ck = h

    def mix_hash(h, data):
        return hashlib.sha256(h + data).digest()

    def hkdf2(ck, ikm):
        tk = hmac.new(ck, ikm, hashlib.sha256).digest()
        o1 = hmac.new(tk, b"\x01", hashlib.sha256).digest()
        o2 = hmac.new(tk, o1 + b"\x02", hashlib.sha256).digest()
        return o1, o2

    def pub(priv):
        from cryptography.hazmat.primitives.serialization import (
            Encoding, PublicFormat,
        )
        return priv.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)

    def dh(priv, pub_raw):
        from cryptography.hazmat.primitives.asymmetric.x25519 import (
            X25519PublicKey,
        )
        return priv.exchange(X25519PublicKey.from_public_bytes(pub_raw))

    def enc(k, n, ad, pt):
        nonce = b"\x00\x00\x00\x00" + n.to_bytes(8, "little")
        return ChaCha20Poly1305(k).encrypt(nonce, pt, ad)

    si, ei = _fixed_key(0x11), _fixed_key(0x22)
    sr, er = _fixed_key(0x33), _fixed_key(0x44)
    h = mix_hash(h, b"sdx-pin")  # prologue

    # -> e   (no key yet: payload in the clear)
    h = mix_hash(h, pub(ei))
    m1 = pub(ei) + b""
    h = mix_hash(h, b"")
    assert m1.hex() == _PIN_M1

    # <- e, ee, s, es  + enc(payload)
    h = mix_hash(h, pub(er))
    ck, k = hkdf2(ck, dh(er, pub(ei)))          # ee (responder side)
    n = 0
    c_s = enc(k, n, h, pub(sr)); n += 1
    h = mix_hash(h, c_s)
    ck, k = hkdf2(ck, dh(sr, pub(ei)))          # es (responder: DH(s, re))
    n = 0
    c_p = enc(k, n, h, b"resp-payload")
    h = mix_hash(h, c_p)
    m2 = pub(er) + c_s + c_p
    assert m2.hex() == _PIN_M2

    # -> s, se  + enc(payload)
    n = 1
    c_s2 = enc(k, n, h, pub(si))
    h = mix_hash(h, c_s2)
    ck, k = hkdf2(ck, dh(si, pub(er)))          # se (initiator: DH(s, re))
    n = 0
    c_p2 = enc(k, n, h, b"init-payload")
    h = mix_hash(h, c_p2)
    m3 = c_s2 + c_p2
    assert m3.hex() == _PIN_M3
    assert h.hex() == _PIN_HH

    # split: k1 (initiator→responder), first transport record
    tk = hmac.new(ck, b"", hashlib.sha256).digest()
    k1 = hmac.new(tk, b"\x01", hashlib.sha256).digest()
    assert enc(k1, 0, b"", b"first-transport-record").hex() == _PIN_T1


# --- the port against the JAX package ----------------------------------------

NOISE = {"jax": JN, "port": PN}
TRANSPORT = {"jax": (JT, JI), "port": (PT, PI)}
MIXED = [("jax", "port"), ("port", "jax")]


def _seeded_run(mod, seed: int):
    """One XX run of `mod` from seeded keys, payloads and prologue: its
    three messages, handshake hash and two transport records each way."""
    rng = __import__("random").Random(seed)
    key = lambda: X25519PrivateKey.from_private_bytes(rng.randbytes(32))  # noqa: E731
    prologue = rng.randbytes(rng.randrange(0, 40))
    payloads = [rng.randbytes(rng.randrange(0, 200)) for _ in range(3)]
    i = mod.HandshakeState(True, key(), prologue=prologue, e=key())
    r = mod.HandshakeState(False, key(), prologue=prologue, e=key())
    out = list(_run_xx(i, r, payloads))
    out.append(i.handshake_hash)
    c_i2r, c_r2i = i.split()
    for n in range(2):
        out.append(c_i2r.encrypt_with_ad(b"", b"right %d" % n))
        out.append(c_r2i.encrypt_with_ad(b"ad", b"left %d" % n))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_messages_equal_jax_under_pinned_keys(seed):
    assert _seeded_run(PN, seed) == _seeded_run(JN, seed)


def test_identity_payload_equals_jax_and_verifies_across():
    seed = bytes(range(32))
    static_pub = hashlib.sha256(b"static").digest()
    jp = JN.identity_payload(JI.Identity.from_bytes(seed), static_pub)
    pp = PN.identity_payload(PI.Identity.from_bytes(seed), static_pub)
    assert pp == jp
    assert PN.verify_identity_payload(jp, static_pub).to_bytes() == jp[:32]
    assert JN.verify_identity_payload(pp, static_pub).to_bytes() == pp[:32]


@pytest.mark.parametrize("init,resp", MIXED)
def test_mixed_xx_handshake(init, resp):
    i = NOISE[init].HandshakeState(True, X25519PrivateKey.generate(), prologue=b"mix")
    r = NOISE[resp].HandshakeState(False, X25519PrivateKey.generate(), prologue=b"mix")
    _run_xx(i, r, (b"", b"from-resp", b"from-init"))
    assert i.handshake_hash == r.handshake_hash
    si, ri = i.split()
    sr, rr = r.split()
    assert sr.decrypt_with_ad(b"", si.encrypt_with_ad(b"", b"right")) == b"right"
    assert ri.decrypt_with_ad(b"", rr.encrypt_with_ad(b"", b"left")) == b"left"


class _Wire:
    """One direction of an in-memory byte pipe: the writer facade the
    handshakes write to records every byte and feeds the peer's
    StreamReader."""

    def __init__(self):
        self.reader = asyncio.StreamReader()
        self.sent = bytearray()

    def write(self, data):
        self.sent += data
        self.reader.feed_data(data)

    async def drain(self):
        pass

    def close(self):
        self.reader.feed_eof()

    async def wait_closed(self):
        pass

    def get_extra_info(self, name, default=None):
        return default


@pytest.fixture
def pin_x25519(monkeypatch):
    """Each call (re)starts a pin: `X25519PrivateKey.generate` (each
    package's statics and ephemerals) returns 0x01.., 0x02.., ... in
    call order."""
    def pin():
        seq = iter(range(1, 256))
        monkeypatch.setattr(X25519PrivateKey, "generate", staticmethod(
            lambda: X25519PrivateKey.from_private_bytes(bytes([next(seq)]) * 32)))

    return pin


def _transcript(client: str, server: str) -> tuple[bytes, bytes]:
    """Both directions' bytes of a `_client_handshake` of `client`
    against a `_server_handshake` of `server` and one record each way."""
    (ct, ci), (st, si) = TRANSPORT[client], TRANSPORT[server]
    c_id = ci.Identity.from_bytes(b"\x05" * 32)
    s_id = si.Identity.from_bytes(b"\x06" * 32)

    async def run():
        c2s, s2c = _Wire(), _Wire()
        expect = ci.RemoteIdentity(s_id.to_remote_identity().to_bytes())
        cs, ss = await asyncio.gather(
            ct._client_handshake(s2c.reader, c2s, c_id, expect),
            st._server_handshake(c2s.reader, s2c, s_id))
        assert ss.remote_identity.to_bytes() == c_id.to_remote_identity().to_bytes()
        await cs.write(b"hello from the client")
        assert await ss.read_exact(21) == b"hello from the client"
        await ss.write(b"x" * (ct.MAX_RECORD + 7))  # two records
        assert await cs.read_exact(ct.MAX_RECORD + 7) == b"x" * (ct.MAX_RECORD + 7)
        return bytes(c2s.sent), bytes(s2c.sent)

    return asyncio.run(asyncio.wait_for(run(), 30))


@pytest.mark.parametrize("client,server", [("port", "port"), *MIXED])
def test_transport_transcript_equals_jax(pin_x25519, client, server):
    pin_x25519()
    got = _transcript(client, server)
    pin_x25519()
    assert got == _transcript("jax", "jax")


@pytest.mark.parametrize("client,server", MIXED)
def test_mixed_transport_over_tcp(client, server):
    (ct, ci), (st, si) = TRANSPORT[client], TRANSPORT[server]

    async def run():
        c_id, s_id = ci.Identity(), si.Identity()
        got = []

        async def on_stream(stream):
            got.append(stream.remote_identity.to_bytes())
            data = await stream.read_exact(3 * st.MAX_RECORD + 5)
            await stream.write(hashlib.sha256(data).digest())

        listener = await st.listen(s_id, on_stream, host="127.0.0.1")
        try:
            stream = await ct.connect(
                ("127.0.0.1", listener.port), c_id,
                expect=ci.RemoteIdentity(s_id.to_remote_identity().to_bytes()))
            payload = os.urandom(3 * ct.MAX_RECORD + 5)
            await stream.write(payload)
            assert await stream.read_exact(32) == hashlib.sha256(payload).digest()
            assert got == [c_id.to_remote_identity().to_bytes()]
            await stream.close()
            # a wrong expectation fails the handshake on the client
            with pytest.raises(ct.HandshakeError):
                await ct.connect(("127.0.0.1", listener.port), c_id,
                                 expect=ci.Identity().to_remote_identity())
        finally:
            await listener.close()

    asyncio.run(asyncio.wait_for(run(), 30))
