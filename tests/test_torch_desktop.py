"""Port twins of tests/test_desktop.py: the port's managed desktop host
(`spacedrive_tpu_torch/desktop.py`) — lifecycle, single instance, deep
links, XDG registration — all headless, its Node on the CPU, the
explorer fetched by aiohttp's client from the port's API (a mixed case:
it skips without `aiohttp`); plus the `desktop` command.

Parity: ref:apps/desktop/src-tauri/src/main.rs — the Tauri shell's
single-instance plugin, deep-link routing into the running core, and
background lifecycle. The UI half is the system browser (no webkit2gtk
in this image; documented in desktop.py), so these tests drive the
host exactly the way the OS would: spawn, probe the HTTP UI, forward a
deep link from a "second launch", quit over the control plane.
"""

import asyncio
import json
import os

import pytest

from spacedrive_tpu_torch import cli
from spacedrive_tpu_torch.desktop import (
    DesktopHost, control_request, register_xdg, run_or_forward,
)


def _factory(data_dir):
    def make():
        from spacedrive_tpu_torch.node.node import Node

        node = Node(data_dir, device="cpu", with_labeler=False)
        node.config.config.p2p.enabled = False
        return node

    return make


def test_desktop_lifecycle_single_instance_deep_link(tmp_path):
    data_dir = str(tmp_path / "sdx")

    aiohttp = pytest.importorskip("aiohttp")

    async def run():
        opened: list[str] = []
        host = DesktopHost(
            data_dir, open_browser=True, opener=lambda u: opened.append(u),
            node_factory=_factory(data_dir),
        )
        runner = asyncio.create_task(host.run(open_path=None))
        for _ in range(100):
            if host.api_port is not None and host._ctrl_server is not None:
                break
            await asyncio.sleep(0.05)
        assert host.api_port, "API never came up"
        # the launcher opened the explorer UI exactly once
        assert opened and opened[0].startswith(
            f"http://127.0.0.1:{host.api_port}/")
        # the UI actually serves (what the browser would load)
        async with aiohttp.ClientSession() as s:
            async with s.get(opened[0]) as resp:
                assert resp.status == 200
                assert "explorer" in (await resp.text()).lower()
        # state file for outside tooling
        state = json.load(open(os.path.join(data_dir, "desktop.json")))
        assert state["port"] == host.api_port

        # SECOND LAUNCH with a deep link: must not start a second core —
        # it forwards to us and exits 0
        deep = str(tmp_path / "deep")
        os.makedirs(deep)
        rc = await run_or_forward(
            data_dir, open_path=deep, open_browser=False,
            node_factory=lambda: (_ for _ in ()).throw(
                AssertionError("second instance must not build a node")),
        )
        assert rc == 0
        assert len(host.opened_urls) == 2
        assert "ephemeral" in host.opened_urls[1]
        assert "deep" in host.opened_urls[1]
        assert len(opened) == 2  # forwarded open reached OUR browser hook

        # control-plane quit → run() unwinds and releases everything
        resp = await control_request(data_dir, {"cmd": "quit"})
        assert resp["ok"] and resp["pid"] == os.getpid()
        await asyncio.wait_for(runner, 30)
        assert not os.path.exists(os.path.join(data_dir, "desktop.sock"))
        assert not os.path.exists(os.path.join(data_dir, "desktop.json"))

        # lock is free again: a fresh instance can start
        host2 = DesktopHost(data_dir, open_browser=False,
                            node_factory=_factory(data_dir))
        assert host2.try_lock()
        host2._unlock()

    asyncio.run(asyncio.wait_for(run(), 120))


def test_desktop_quit_without_instance(tmp_path):
    async def run():
        rc = await run_or_forward(str(tmp_path / "none"), quit_running=True)
        assert rc == 1

    asyncio.run(run())


def test_register_xdg_writes_desktop_entry(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "share"))
    path = register_xdg(exec_line="/usr/bin/sdx")
    assert path == str(tmp_path / "share" / "applications" / "sdx.desktop")
    body = open(path).read()
    assert "Exec=/usr/bin/sdx desktop --open-path %u" in body
    assert "MimeType=inode/directory;x-scheme-handler/sdx;" in body
    assert "Type=Application" in body


def test_parse_open_arg_forms():
    from spacedrive_tpu.desktop import parse_open_arg as jparse
    from spacedrive_tpu_torch.desktop import parse_open_arg

    assert parse_open_arg("/plain/path") == "/plain/path"
    assert parse_open_arg("file:///with%20space/dir") == "/with space/dir"
    assert parse_open_arg("sdx://open/home/u/pics") == "/home/u/pics"
    assert parse_open_arg("sdx://home/u/pics") == "/home/u/pics"
    assert parse_open_arg("sdx://open") == "/"
    for raw in ("/plain/path", "file:///with%20space/dir", "sdx://open/home/u/pics",
                "sdx://home/u/pics", "sdx://open", "file://", "sdx://open/a%2Fb"):
        assert parse_open_arg(raw) == jparse(raw), raw


def test_cli_desktop_register_and_quit(tmp_path, monkeypatch, capsys):
    """`desktop --register` writes this package's launcher entry;
    `desktop --quit` without an instance exits 1."""
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "share"))
    assert cli.main(["desktop", "--data-dir", str(tmp_path / "d"), "--register"]) == 0
    path = str(tmp_path / "share" / "applications" / "sdx.desktop")
    assert capsys.readouterr().out.strip() == f"registered {path}"
    assert " -m spacedrive_tpu_torch desktop --open-path %u" in open(path).read()
    assert cli.main(["desktop", "--data-dir", str(tmp_path / "d"), "--quit"]) == 1
