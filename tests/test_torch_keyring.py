"""The port's OS keyring (Secret Service via libsecret) against the JAX
package's: tests/test_keyring.py's three cases pointed at the port, on
the same stub libsecret compiled from source in-test (g++), and an
entry either package stores read by the other (same schema, attributes
and hex transport).

Parity: ref:crates/crypto/src/keys/keyring/mod.rs:44-45.
"""

import os
import subprocess

import pytest

from spacedrive_tpu.crypto.keyring import LibsecretKeyring as JaxKeyring
from spacedrive_tpu_torch.crypto.keyring import (
    KeyringError,
    LibsecretKeyring,
    default_keyring,
)

LIGHT_ARGON = (1024, 1, 1)  # KiB, iterations, lanes — test-speed params

_STUB_C = r"""
// Minimal libsecret ABI stub: stores service\taccount\tsecret lines in
// the file named by $SD_STUB_STORE.
#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <map>

struct SecretSchemaAttribute { const char *name; int type; };
struct SecretSchema {
  const char *name; int flags; SecretSchemaAttribute attributes[32];
  int reserved; void *r1,*r2,*r3,*r4,*r5,*r6,*r7;
};

static std::map<std::string, std::string> load() {
  std::map<std::string, std::string> m;
  FILE *f = fopen(getenv("SD_STUB_STORE"), "r");
  if (!f) return m;
  char line[4096];
  while (fgets(line, sizeof line, f)) {
    std::string s(line);
    if (!s.empty() && s.back() == '\n') s.pop_back();
    auto t = s.rfind('\t');
    if (t != std::string::npos) m[s.substr(0, t)] = s.substr(t + 1);
  }
  fclose(f);
  return m;
}

static void save(const std::map<std::string, std::string> &m) {
  FILE *f = fopen(getenv("SD_STUB_STORE"), "w");
  if (!f) return;
  for (auto &kv : m) fprintf(f, "%s\t%s\n", kv.first.c_str(), kv.second.c_str());
  fclose(f);
}

static std::string attr_key(const SecretSchema *s, va_list ap) {
  // attributes arrive as (name, value) char* pairs, NULL-terminated —
  // validate names against the schema like libsecret does
  std::string svc, acct;
  while (const char *name = va_arg(ap, const char *)) {
    const char *val = va_arg(ap, const char *);
    bool known = false;
    for (int i = 0; i < 32 && s->attributes[i].name; i++)
      if (!strcmp(s->attributes[i].name, name)) known = true;
    if (!known) abort();  // schema violation = binding bug
    if (!strcmp(name, "service")) svc = val;
    if (!strcmp(name, "account")) acct = val;
  }
  return svc + "\x1f" + acct;
}

extern "C" {
int secret_password_store_sync(const SecretSchema *schema,
    const char *collection, const char *label, const char *password,
    void *cancellable, void **error, ...) {
  (void)collection; (void)label; (void)cancellable; (void)error;
  va_list ap; va_start(ap, error);
  std::string key = attr_key(schema, ap);
  va_end(ap);
  auto m = load();
  m[key] = password;
  save(m);
  return 1;
}

char *secret_password_lookup_sync(const SecretSchema *schema,
    void *cancellable, void **error, ...) {
  (void)cancellable; (void)error;
  va_list ap; va_start(ap, error);
  std::string key = attr_key(schema, ap);
  va_end(ap);
  auto m = load();
  auto it = m.find(key);
  if (it == m.end()) return nullptr;
  return strdup(it->second.c_str());
}

int secret_password_clear_sync(const SecretSchema *schema,
    void *cancellable, void **error, ...) {
  (void)cancellable; (void)error;
  va_list ap; va_start(ap, error);
  std::string key = attr_key(schema, ap);
  va_end(ap);
  auto m = load();
  int hit = m.erase(key) ? 1 : 0;
  save(m);
  return hit;
}

void secret_password_free(char *p) { free(p); }
}
"""


@pytest.fixture(scope="module")
def stub_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("libsecret-stub")
    src = d / "stub.cc"
    src.write_text(_STUB_C)
    so = d / "libsecret-stub.so"
    subprocess.run(
        ["g++", "-shared", "-fPIC", "-O1", "-o", str(so), str(src)],
        check=True, capture_output=True,
    )
    return str(so)


def test_keyring_roundtrip_through_libsecret_abi(stub_lib, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("SD_STUB_STORE", str(tmp_path / "store.txt"))
    kr = LibsecretKeyring(lib_path=stub_lib)
    secret = os.urandom(32)
    assert kr.get("spacedrive-tpu", "master") is None
    kr.set("spacedrive-tpu", "master", secret)
    assert kr.get("spacedrive-tpu", "master") == secret
    # distinct accounts are distinct entries
    kr.set("spacedrive-tpu", "other", b"\x00\xff")
    assert kr.get("spacedrive-tpu", "other") == b"\x00\xff"
    assert kr.get("spacedrive-tpu", "master") == secret
    assert kr.delete("spacedrive-tpu", "master") is True
    assert kr.get("spacedrive-tpu", "master") is None
    assert kr.delete("spacedrive-tpu", "master") is False


def test_key_manager_remembers_master_via_keyring(stub_lib, tmp_path,
                                                  monkeypatch):
    from spacedrive_tpu_torch.crypto import KeyManager

    monkeypatch.setenv("SD_STUB_STORE", str(tmp_path / "store.txt"))
    kr = LibsecretKeyring(lib_path=stub_lib)
    ks = str(tmp_path / "keys.bin")

    km = KeyManager(ks, _test_overrides=LIGHT_ARGON)
    km.set_master_password(b"hunter2-but-long")
    kid = km.add_key(b"A" * 32)
    km.remember_master(kr)

    # fresh session: unlock straight from the OS keyring
    km2 = KeyManager(ks, _test_overrides=LIGHT_ARGON)
    assert not km2.unlocked
    assert km2.unlock_from_keyring(kr) is True
    km2.mount(kid)
    assert km2.get_key(kid) == b"A" * 32

    # forget → next session must prompt again
    assert km2.forget_master(kr) is True
    km3 = KeyManager(ks, _test_overrides=LIGHT_ARGON)
    assert km3.unlock_from_keyring(kr) is False


def test_default_keyring_absent_on_headless_host():
    # a host without libsecret: callers get None and keep the encrypted
    # file keystore (documented fallback); a missing library raises
    import ctypes.util

    if ctypes.util.find_library("secret-1") is None:
        assert default_keyring() is None
        with pytest.raises(KeyringError):
            LibsecretKeyring()
    else:  # pragma: no cover - desktop host
        assert default_keyring() is not None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_entry_either_package_stores_reads_in_the_other(stub_lib, tmp_path,
                                                           monkeypatch, writer):
    monkeypatch.setenv("SD_STUB_STORE", str(tmp_path / "store.txt"))
    port, jax = LibsecretKeyring(lib_path=stub_lib), JaxKeyring(lib_path=stub_lib)
    src, dst = (jax, port) if writer == "jax" else (port, jax)
    secret = bytes(range(32))
    src.set("spacedrive-tpu", "master", secret)
    assert dst.get("spacedrive-tpu", "master") == secret
    assert dst.delete("spacedrive-tpu", "master") is True
    assert src.get("spacedrive-tpu", "master") is None
