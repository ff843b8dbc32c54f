"""The port's crypto stack against the JAX package's.

- tests/test_crypto.py's cases pointed at the port: XChaCha20-Poly1305
  and HChaCha20 (RFC vectors), the STREAM construction (roundtrip,
  tamper, AAD, truncation) for both AEADs, Argon2id and Balloon-BLAKE3,
  header keyslots and sections, whole files and the header swap, the key
  manager, and the encrypt/decrypt jobs through a port Node on "cpu";
- under one pinned `secrets.token_bytes` (and `uuid.uuid4`): headers,
  ciphertexts, Balloon keys and keystores are JAX's bytes, for both
  AEADs and both key hashes;
- a file encrypted by either package decrypts in the other, and a
  keystore written by either loads and mounts in the other;
- the jobs on a watched location: the encrypted copies reach the library
  through the watcher, and a decrypted copy gets its original's cas_id
  and object back.
"""

import asyncio
import io
import itertools
import os
import secrets
import time
import uuid

import pytest

import spacedrive_tpu.crypto as J
import spacedrive_tpu_torch.crypto as P
from spacedrive_tpu_torch.crypto import (
    Algorithm,
    CryptoError,
    FileHeader,
    HashingAlgorithm,
    KeyManager,
    StreamDecryption,
    StreamEncryption,
    XChaCha20Poly1305,
    balloon_blake3,
    decrypt_file,
    encrypt_file,
    generate_salt,
    hchacha20,
)

LIGHT_ARGON = (1024, 1, 1)  # KiB, iterations, lanes — test-speed params
LIGHT_BALLOON = (16, 1)
ALGOS = [Algorithm.XCHACHA20_POLY1305, Algorithm.AES_256_GCM]


# --- tests/test_crypto.py's cases -------------------------------------------


def test_hchacha20_rfc_vector():
    # draft-irtf-cfrg-xchacha-03 §2.2.1 input; cross-validated by the A.3
    # AEAD vector below
    key = bytes.fromhex(
        "000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f"
    )
    nonce = bytes.fromhex("000000090000004a0000000031415927")
    out = hchacha20(key, nonce)
    assert out[:16].hex() == "82413b4227b27bfed30e42508a877d73"
    assert out.hex() == (
        "82413b4227b27bfed30e42508a877d73a0f9e4d58a74a853c12ec41326d3ecdc"
    )


def test_xchacha20poly1305_rfc_vector():
    # draft-irtf-cfrg-xchacha-03 A.3 AEAD vector
    plaintext = (
        b"Ladies and Gentlemen of the class of '99: If I could offer you "
        b"only one tip for the future, sunscreen would be it."
    )
    aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    key = bytes.fromhex(
        "808182838485868788898a8b8c8d8e8f909192939495969798999a9b9c9d9e9f"
    )
    nonce = bytes.fromhex("404142434445464748494a4b4c4d4e4f5051525354555657")
    ct = XChaCha20Poly1305(key).encrypt(nonce, plaintext, aad)
    assert ct[-16:].hex() == "c0875924c1c7987947deafd8780acf49"
    assert XChaCha20Poly1305(key).decrypt(nonce, ct, aad) == plaintext
    assert J.XChaCha20Poly1305(key).encrypt(nonce, plaintext, aad) == ct
    with pytest.raises(Exception):
        XChaCha20Poly1305(key).decrypt(nonce, ct[:-1] + b"\x00", aad)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_stream_roundtrip_and_tamper(algorithm):
    key = os.urandom(32)
    nonce = algorithm.generate_nonce()
    data = os.urandom(3 * 1024 * 1024 + 12345)  # spans 4 blocks
    src, dst = io.BytesIO(data), io.BytesIO()
    StreamEncryption(key, nonce, algorithm).encrypt_streams(src, dst, aad=b"hdr")
    ct = dst.getvalue()
    assert len(ct) == len(data) + 4 * 16  # one tag per block

    out = io.BytesIO()
    StreamDecryption(key, nonce, algorithm).decrypt_streams(
        io.BytesIO(ct), out, aad=b"hdr"
    )
    assert out.getvalue() == data
    # JAX's construction writes the same ciphertext
    jdst = io.BytesIO()
    J.StreamEncryption(key, nonce, J.Algorithm(int(algorithm))).encrypt_streams(
        io.BytesIO(data), jdst, aad=b"hdr")
    assert jdst.getvalue() == ct

    # flipping one bit in any block fails
    bad = bytearray(ct)
    bad[2 * 1024 * 1024] ^= 1
    with pytest.raises(CryptoError):
        StreamDecryption(key, nonce, algorithm).decrypt_streams(
            io.BytesIO(bytes(bad)), io.BytesIO(), aad=b"hdr"
        )
    # wrong AAD fails (header binding)
    with pytest.raises(CryptoError):
        StreamDecryption(key, nonce, algorithm).decrypt_streams(
            io.BytesIO(ct), io.BytesIO(), aad=b"other"
        )
    # truncating the last block fails (last-flag binding)
    with pytest.raises(CryptoError):
        StreamDecryption(key, nonce, algorithm).decrypt_streams(
            io.BytesIO(ct[: 1024 * 1024 + 16]), io.BytesIO(), aad=b"hdr"
        )


def test_argon2id_and_balloon_deterministic():
    salt = generate_salt()
    a = HashingAlgorithm(HashingAlgorithm.ARGON2ID)
    k1 = a.hash_password(b"password", salt, _test_overrides=LIGHT_ARGON)
    k2 = a.hash_password(b"password", salt, _test_overrides=LIGHT_ARGON)
    assert k1 == k2 and len(k1) == 32
    assert a.hash_password(b"other", salt, _test_overrides=LIGHT_ARGON) != k1

    b = HashingAlgorithm(HashingAlgorithm.BALLOON_BLAKE3)
    b1 = b.hash_password(b"password", salt, _test_overrides=LIGHT_BALLOON)
    assert b1 == b.hash_password(b"password", salt, _test_overrides=LIGHT_BALLOON)
    assert len(b1) == 32 and b1 != k1
    assert balloon_blake3(b"pw", salt, space_cost=16, time_cost=1) != balloon_blake3(
        b"pw", b"\x00" * 16, space_cost=16, time_cost=1
    )
    # the same keys as JAX's for both algorithms
    assert k1 == J.HashingAlgorithm(J.HashingAlgorithm.ARGON2ID).hash_password(
        b"password", salt, _test_overrides=LIGHT_ARGON)
    assert b1 == J.HashingAlgorithm(J.HashingAlgorithm.BALLOON_BLAKE3).hash_password(
        b"password", salt, _test_overrides=LIGHT_BALLOON)
    assert balloon_blake3(b"pw", salt, space_cost=64, time_cost=2) == J.balloon_blake3(
        b"pw", salt, space_cost=64, time_cost=2)


def test_balloon_without_the_host_hasher_raises_crypto_error(monkeypatch):
    """Like JAX's, Balloon hashing refuses (CryptoError) when the host C
    hasher cannot be built; there is no pure-Python fallback."""
    from spacedrive_tpu_torch.crypto import hashing
    from spacedrive_tpu_torch.native.build import NativeBuildError

    def no_compiler(data, out_len=32):
        raise NativeBuildError("no C compiler")

    monkeypatch.setattr(hashing, "blake3_digest", no_compiler)
    with pytest.raises(CryptoError, match="native blake3 unavailable"):
        balloon_blake3(b"pw", b"\x00" * 16, space_cost=4, time_cost=1)


def test_header_two_keyslots_and_sections(tmp_path):
    master = os.urandom(32)
    algo = Algorithm.XCHACHA20_POLY1305
    header = FileHeader(algorithm=algo, nonce=algo.generate_nonce())
    h = HashingAlgorithm(HashingAlgorithm.ARGON2ID)
    header.add_keyslot(master, b"first", h, _test_overrides=LIGHT_ARGON)
    header.add_keyslot(master, b"second", h, _test_overrides=LIGHT_ARGON)
    with pytest.raises(CryptoError):
        header.add_keyslot(master, b"third", h, _test_overrides=LIGHT_ARGON)
    header.set_metadata(master, {"name": "secret", "kind": 5})
    header.set_preview_media(master, b"RIFFwebp-bytes")

    raw = header.to_bytes()
    back, raw2 = FileHeader.from_reader(io.BytesIO(raw))
    assert raw2 == raw
    # either password unlocks
    for pw in (b"first", b"second"):
        assert back.decrypt_master_key(pw, _test_overrides=LIGHT_ARGON) == master
    with pytest.raises(CryptoError):
        back.decrypt_master_key(b"wrong", _test_overrides=LIGHT_ARGON)
    assert back.get_metadata(master) == {"name": "secret", "kind": 5}
    assert back.get_preview_media(master) == b"RIFFwebp-bytes"
    # JAX reads the same header: keyslots, metadata, preview
    jback, _ = J.FileHeader.from_reader(io.BytesIO(raw))
    assert jback.decrypt_master_key(b"second", _test_overrides=LIGHT_ARGON) == master
    assert jback.get_metadata(master) == {"name": "secret", "kind": 5}
    assert jback.get_preview_media(master) == b"RIFFwebp-bytes"


def test_encrypt_decrypt_file_and_header_swap(tmp_path):
    src = tmp_path / "plain.bin"
    data = os.urandom(2 * 1024 * 1024 + 77)
    src.write_bytes(data)
    enc = tmp_path / "plain.bin.sdenc"
    encrypt_file(
        str(src), str(enc), b"hunter2",
        metadata={"name": "plain"}, _test_overrides=LIGHT_ARGON,
    )
    out = tmp_path / "out.bin"
    meta = decrypt_file(str(enc), str(out), b"hunter2", _test_overrides=LIGHT_ARGON)
    assert out.read_bytes() == data
    assert meta == {"name": "plain"}
    with pytest.raises(CryptoError):
        decrypt_file(str(enc), str(out), b"wrong", _test_overrides=LIGHT_ARGON)

    # header from file A must not decrypt body of file B (AAD binding)
    src2 = tmp_path / "other.bin"
    src2.write_bytes(os.urandom(4096))
    enc2 = tmp_path / "other.bin.sdenc"
    encrypt_file(str(src2), str(enc2), b"hunter2", _test_overrides=LIGHT_ARGON)
    hdr_a = enc.read_bytes()
    with open(enc, "rb") as f:
        FileHeader.from_reader(f)
        body_a = f.read()
    hdr_b_raw = enc2.read_bytes()[: len(hdr_a) - len(body_a)]
    frank = tmp_path / "frank.sdenc"
    frank.write_bytes(hdr_b_raw + body_a)
    with pytest.raises(CryptoError):
        decrypt_file(str(frank), str(out), b"hunter2", _test_overrides=LIGHT_ARGON)


def test_key_manager_roundtrip(tmp_path):
    ks_path = str(tmp_path / "keystore.bin")
    km = KeyManager(ks_path, _test_overrides=LIGHT_ARGON)
    with pytest.raises(CryptoError):
        km.add_key(b"k" * 32)  # locked
    km.set_master_password(b"master-pw")
    kid = km.add_key(b"k" * 32, automount=True)
    km.mount(kid)
    assert km.get_key(kid) == b"k" * 32
    km.unmount(kid)
    with pytest.raises(CryptoError):
        km.get_key(kid)

    # reload from disk: stored key survives, automount works
    km2 = KeyManager(ks_path, _test_overrides=LIGHT_ARGON)
    km2.set_master_password(b"master-pw")
    assert km2.automount() == 1
    assert km2.get_key(kid) == b"k" * 32
    # wrong master password can't mount
    km3 = KeyManager(ks_path, _test_overrides=LIGHT_ARGON)
    km3.set_master_password(b"nope")
    with pytest.raises(CryptoError):
        km3.mount(kid)
    km2.lock()
    assert not km2.unlocked and km2.mounted_uuids() == []


# --- the same bytes as JAX's under pinned randomness ------------------------


def _pin(monkeypatch) -> None:
    """`secrets.token_bytes` and `uuid.uuid4` from one counter."""
    counter = itertools.count(1)

    def token_bytes(n=32):
        k = next(counter)
        return bytes((k * 31 + i * 7) & 0xFF for i in range(n))

    monkeypatch.setattr(secrets, "token_bytes", token_bytes)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))


@pytest.mark.parametrize("hashing,overrides", [
    ("Argon2id", LIGHT_ARGON), ("BalloonBlake3", LIGHT_BALLOON)])
@pytest.mark.parametrize("algorithm", ALGOS)
def test_files_and_headers_are_jax_bytes(tmp_path, monkeypatch, algorithm, hashing, overrides):
    data = os.urandom(1024 * 1024 + 4097)  # two blocks
    src = tmp_path / "plain.bin"
    src.write_bytes(data)
    out = {}
    for name, mod in (("jax", J), ("port", P)):
        with monkeypatch.context() as mp:
            _pin(mp)
            dst = tmp_path / f"{name}.sdenc"
            mod.encrypt_file(
                str(src), str(dst), b"pw", algorithm=mod.Algorithm(int(algorithm)),
                hashing=mod.HashingAlgorithm(hashing),
                metadata={"name": "plain", "cas_id": "0123456789abcdef", "n": 3},
                preview_media=b"RIFF....WEBP", _test_overrides=overrides)
            out[name] = dst.read_bytes()
    assert out["port"] == out["jax"]
    with open(tmp_path / "port.sdenc", "rb") as f:
        header, raw = FileHeader.from_reader(f)
    assert header.to_bytes() == raw and header.algorithm == algorithm


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_file_either_package_encrypts_decrypts_in_the_other(tmp_path, writer):
    src, dst = (J, P) if writer == "jax" else (P, J)
    data = os.urandom(3 * 1024 * 1024 + 1)
    plain = tmp_path / "plain.bin"
    plain.write_bytes(data)
    enc = tmp_path / "plain.bin.sdenc"
    src.encrypt_file(str(plain), str(enc), b"tr0ub4dor", metadata={"name": "plain"},
                     _test_overrides=LIGHT_ARGON)
    back = tmp_path / "back.bin"
    meta = dst.decrypt_file(str(enc), str(back), b"tr0ub4dor", _test_overrides=LIGHT_ARGON)
    assert back.read_bytes() == data and meta == {"name": "plain"}
    with pytest.raises(Exception):
        dst.decrypt_file(str(enc), str(back), b"wrong", _test_overrides=LIGHT_ARGON)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_keystore_either_package_writes_loads_in_the_other(tmp_path, monkeypatch, writer):
    src, dst = (J, P) if writer == "jax" else (P, J)
    path = str(tmp_path / "keys.keystore")
    km = src.KeyManager(path, _test_overrides=LIGHT_ARGON)
    km.set_master_password(b"master-pw")
    kids = [km.add_key(bytes([i]) * 32, automount=bool(i % 2)) for i in range(3)]
    other = dst.KeyManager(path, _test_overrides=LIGHT_ARGON)
    assert sorted(other.stored) == sorted(kids)
    other.set_master_password(b"master-pw")
    assert other.automount() == 1
    for i, kid in enumerate(kids):
        other.mount(kid)
        assert other.get_key(kid) == bytes([i]) * 32
    # the same keystore bytes from the same keys under pinned randomness
    stores = {}
    for name, mod in (("jax", J), ("port", P)):
        with monkeypatch.context() as mp:
            _pin(mp)
            p = str(tmp_path / f"{name}.pinned")
            m = mod.KeyManager(p, _test_overrides=LIGHT_ARGON)
            m.set_master_password(b"master-pw")
            for i in range(3):
                m.add_key(bytes([i]) * 32, automount=bool(i % 2))
            with open(p, "rb") as f:
                stores[name] = f.read()
    assert stores["port"] == stores["jax"]


# --- the jobs ---------------------------------------------------------------


def test_encrypt_decrypt_jobs(tmp_path):
    """tests/test_crypto.py's job case through a port Node on "cpu"."""

    async def run():
        from spacedrive_tpu_torch.jobs.manager import JobBuilder
        from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
        from spacedrive_tpu_torch.node.node import Node
        from spacedrive_tpu_torch.object.fs.encrypt import FileDecryptorJob, FileEncryptorJob

        corpus = tmp_path / "corpus"
        corpus.mkdir()
        payload = os.urandom(300_000)
        (corpus / "secret.bin").write_bytes(payload)
        node = Node(str(tmp_path / "node"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            lib = await node.create_library("vault")
            loc = LocationCreateArgs(path=str(corpus)).create(lib)
            await scan_location(lib, loc, node.jobs, backend="cpu")
            await node.jobs.wait_idle()
            fp = lib.db.find_one("file_path", name="secret")
            await JobBuilder(
                FileEncryptorJob(
                    {
                        "location_id": loc["id"],
                        "file_path_ids": [fp["id"]],
                        "password": "tr0ub4dor",
                        "erase_original": True,
                        "_test_overrides": list(LIGHT_ARGON),
                    }
                )
            ).spawn(node.jobs, lib)
            await node.jobs.wait_idle()
            assert not (corpus / "secret.bin").exists()
            enc_path = corpus / "secret.bin.sdenc"
            assert enc_path.exists()
            with open(enc_path, "rb") as f:
                header, _ = FileHeader.from_reader(f)
            assert len(header.keyslots) == 1

            # rescan picks up the .sdenc file; decrypt it back
            await scan_location(lib, loc, node.jobs, backend="cpu")
            await node.jobs.wait_idle()
            enc_fp = lib.db.find_one("file_path", name="secret.bin")
            assert enc_fp is not None and enc_fp["extension"] == "sdenc"
            await JobBuilder(
                FileDecryptorJob(
                    {
                        "location_id": loc["id"],
                        "file_path_ids": [enc_fp["id"]],
                        "password": "tr0ub4dor",
                        "_test_overrides": list(LIGHT_ARGON),
                    }
                )
            ).spawn(node.jobs, lib)
            await node.jobs.wait_idle()
            assert (corpus / "secret.bin").read_bytes() == payload
            # the jobs' reports
            names = {r["name"]: r["status"] for r in lib.db.find("job")}
            assert names.get("file_encryptor") == names.get("file_decryptor") == 2
        finally:
            await node.shutdown()

    asyncio.run(run())


async def _until(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        await asyncio.sleep(0.05)
    raise TimeoutError(f"{what} never held within {timeout} s")


def test_jobs_on_a_watched_location_reach_the_library(tmp_path):
    """Through the router on a watched location: the encryptor's copies
    get rows and cas_ids through the watcher; moved into a sibling
    directory (`files.cutFiles`) and decrypted there, each plaintext
    gets its original's cas_id and object, and the object count holds."""

    async def run():
        from spacedrive_tpu_torch.jobs.manager import JobBuilder
        from spacedrive_tpu_torch.node.node import Node
        from spacedrive_tpu_torch.object.fs.encrypt import FileDecryptorJob, FileEncryptorJob

        corpus = tmp_path / "corpus"
        (corpus / "dec").mkdir(parents=True)
        files = {"big.bin": os.urandom(150_000), "small.txt": b"s" * 900,
                 "mid.dat": os.urandom(40_000)}
        for name, data in files.items():
            (corpus / name).write_bytes(data)
        node = Node(str(tmp_path / "node"), device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            r = node.router
            lib_info = await r.exec(node, "library.create", {"name": "vault"})
            lid = lib_info["uuid"]
            lib = node.libraries.libraries[uuid.UUID(lid)]
            loc_id = await r.exec(node, "locations.create", {"path": str(corpus)},
                                  library_id=lid)
            await node.jobs.wait_idle()
            db = lib.db
            orig = {f"{row['name']}.{row['extension']}": row
                    for row in db.find("file_path", location_id=loc_id, is_dir=0)
                    if row["name"] != ".spacedrive"}  # the location's marker
            assert set(orig) == set(files) and all(r_["cas_id"] for r_ in orig.values())
            objects = db.count("object")
            mgr = node.location_manager
            mgr.debounce, mgr.debounce_max = 0.05, 0.2
            await JobBuilder(FileEncryptorJob({
                "location_id": loc_id, "file_path_ids": [r_["id"] for r_ in orig.values()],
                "password": "pw", "_test_overrides": list(LIGHT_ARGON)})).spawn(node.jobs, lib)

            def enc_rows():
                return [x for x in db.find("file_path", location_id=loc_id, extension="sdenc")
                        if x["cas_id"]]

            await _until(lambda: len(enc_rows()) == len(files), "the .sdenc rows")
            await node.jobs.wait_idle()
            await r.exec(node, "files.cutFiles", {
                "source_location_id": loc_id, "target_location_id": loc_id,
                "sources_file_path_ids": [x["id"] for x in enc_rows()],
                "target_relative_path": "/dec"}, library_id=lid)
            await _until(lambda: {x["materialized_path"] for x in enc_rows()} == {"/dec/"},
                         "the moved .sdenc rows")
            await node.jobs.wait_idle()
            await JobBuilder(FileDecryptorJob({
                "location_id": loc_id, "file_path_ids": [x["id"] for x in enc_rows()],
                "password": "pw", "_test_overrides": list(LIGHT_ARGON)})).spawn(node.jobs, lib)

            def decrypted():
                return {f"{x['name']}.{x['extension']}": x
                        for x in db.find("file_path", location_id=loc_id,
                                         materialized_path="/dec/", is_dir=0)
                        if x["extension"] != "sdenc" and x["cas_id"]}

            await _until(lambda: len(decrypted()) == len(files), "the decrypted rows")
            await node.jobs.wait_idle()
            for name, row in decrypted().items():
                assert (corpus / "dec" / name).read_bytes() == files[name]
                assert row["cas_id"] == orig[name]["cas_id"]
                assert row["object_id"] == orig[name]["object_id"]
            # the .sdenc copies are objects of their own; the plaintexts add none
            assert db.count("object") == objects + len(files)
            bad = [(j["name"], j["status"]) for j in db.find("job") if j["status"] != 2]
            assert not bad
        finally:
            await node.shutdown()

    asyncio.run(run())
