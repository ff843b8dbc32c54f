"""`sdx desktop` — the managed desktop host.

Parity: the reference's desktop app is a Tauri shell
(ref:apps/desktop/src-tauri/src/main.rs) whose jobs are lifecycle, not
UI: run exactly one core per data dir (tauri-plugin-single-instance),
open the frontend in a webview, route `sd://` deep links and file
arguments into the running instance, keep the node alive in the
background, and integrate with the OS launcher. This image has no
webkit2gtk, so the UI half rides the system browser (the explorer web
app IS the interface); everything else is implemented natively here:

- **single instance**: an fcntl lock on `<data_dir>/desktop.lock`.
  A second `sdx desktop` forwards its request (open/focus/quit) to
  the first over the control socket and exits — the lock dies with
  the process, so no stale-pid heuristics.
- **lifecycle**: start the Node + HTTP API, open the explorer in the
  default browser (xdg-open/$BROWSER), run until SIGINT/SIGTERM or a
  control-socket `quit` — closing the browser tab does NOT stop the
  node (tray-style background mode, same as the reference's tray).
- **deep links**: `sdx desktop --open-path /some/dir` targets the
  running instance (or starts one) and opens the explorer on that
  path via the ephemeral-browse route.
- **OS integration**: `sdx desktop --register` writes an XDG
  .desktop entry (file-manager "Open with sdx" + `sdx:` URL scheme)
  under $XDG_DATA_HOME — the `xdg-open`-facing half of Tauri's
  bundler role.

The control plane is a unix socket inside the data dir (filesystem
permissions = same trust boundary as the database itself), one JSON
line per request: {"cmd": "ping"|"open"|"quit", "path": ...?}.

Counterpart of `spacedrive_tpu/desktop.py`. The managed Node runs on the
card (``device="cuda"``) unless the caller asks for "cpu"; the XDG
entry launches this package (``python -m spacedrive_tpu_torch``).
"""

from __future__ import annotations

import asyncio
import errno
import fcntl
import json
import os
import shutil
import signal
import subprocess
import sys
import urllib.parse
from typing import Any, Callable

LOCK_NAME = "desktop.lock"
SOCK_NAME = "desktop.sock"
STATE_NAME = "desktop.json"


class DesktopError(Exception):
    pass


def _explorer_url(port: int, path: str | None = None) -> str:
    url = f"http://127.0.0.1:{port}/"
    if path:
        url += "#/ephemeral?path=" + urllib.parse.quote(path)
    return url


def open_in_browser(url: str) -> bool:
    """Best-effort: $BROWSER, xdg-open, python -m webbrowser."""
    for cmd in filter(None, [os.environ.get("BROWSER"),
                             shutil.which("xdg-open")]):
        try:
            subprocess.Popen(
                [cmd, url], stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                start_new_session=True,
            )
            return True
        except OSError:
            continue
    try:
        import webbrowser

        return webbrowser.open(url)
    except Exception:  # noqa: BLE001 - headless hosts have no browser
        return False


async def control_request(data_dir: str, msg: dict[str, Any],
                          timeout: float = 5.0) -> dict[str, Any]:
    """One JSON request to a running desktop host's control socket."""
    sock = os.path.join(data_dir, SOCK_NAME)
    reader, writer = await asyncio.wait_for(
        asyncio.open_unix_connection(sock), timeout)
    try:
        writer.write(json.dumps(msg).encode() + b"\n")
        await writer.drain()
        line = await asyncio.wait_for(reader.readline(), timeout)
        return json.loads(line)
    finally:
        writer.close()


class DesktopHost:
    """One managed core per data dir + the OS-facing glue."""

    def __init__(self, data_dir: str, *, host: str = "127.0.0.1",
                 port: int = 0, open_browser: bool = True,
                 opener: Callable[[str], bool] = open_in_browser,
                 node_factory: Callable[[], Any] | None = None,
                 device: str = "cuda"):
        self.data_dir = os.path.abspath(os.path.expanduser(data_dir))
        self.host = host
        self.port = port
        self.open_browser = open_browser
        self.opener = opener
        self._node_factory = node_factory
        self.device = device
        self.node: Any = None
        self.api_port: int | None = None
        self._lock_fd: int | None = None
        self._ctrl_server: asyncio.AbstractServer | None = None
        self._quit = asyncio.Event()
        self.opened_urls: list[str] = []  # observability (and tests)

    # --- single instance ------------------------------------------------

    def try_lock(self) -> bool:
        """True if we are THE instance for this data dir."""
        os.makedirs(self.data_dir, exist_ok=True)
        fd = os.open(os.path.join(self.data_dir, LOCK_NAME),
                     os.O_CREAT | os.O_RDWR, 0o600)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            os.close(fd)
            if e.errno in (errno.EAGAIN, errno.EACCES):
                return False
            raise
        os.ftruncate(fd, 0)
        os.write(fd, str(os.getpid()).encode())
        self._lock_fd = fd
        return True

    def _unlock(self) -> None:
        if self._lock_fd is not None:
            try:
                fcntl.flock(self._lock_fd, fcntl.LOCK_UN)
            finally:
                os.close(self._lock_fd)
                self._lock_fd = None

    # --- control socket -------------------------------------------------

    async def _serve_control(self) -> None:
        sock = os.path.join(self.data_dir, SOCK_NAME)
        try:
            os.unlink(sock)
        except FileNotFoundError:
            pass
        self._ctrl_server = await asyncio.start_unix_server(
            self._on_control, sock)
        os.chmod(sock, 0o600)

    async def _on_control(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), 5.0)
            msg = json.loads(line or b"{}")
        except Exception:  # noqa: BLE001 - hostile/broken client
            writer.close()
            return
        cmd = msg.get("cmd")
        resp: dict[str, Any] = {"ok": True, "port": self.api_port,
                                "pid": os.getpid()}
        if cmd == "open":
            url = _explorer_url(self.api_port or 0, msg.get("path"))
            self.opened_urls.append(url)
            if self.open_browser:
                self.opener(url)
            resp["url"] = url
        elif cmd == "quit":
            self._quit.set()
        elif cmd != "ping":
            resp = {"ok": False, "error": f"unknown cmd {cmd!r}"}
        try:
            writer.write(json.dumps(resp).encode() + b"\n")
            await writer.drain()
        except (ConnectionError, OSError):
            pass
        writer.close()

    # --- lifecycle -------------------------------------------------------

    def _make_node(self) -> Any:
        if self._node_factory is not None:
            return self._node_factory()
        from .node.node import Node

        return Node(self.data_dir, device=self.device)

    async def start(self) -> int:
        """Start core + API + control plane; returns the API port.
        A lock already held by THIS host (run_or_forward's probe) is
        kept — releasing and re-acquiring would open a race window for
        a concurrent launch to steal the instance."""
        if self._lock_fd is None and not self.try_lock():
            raise DesktopError("another sdx desktop owns this data dir")
        self.node = self._make_node()
        await self.node.start()
        self.api_port = await self.node.start_api(self.host, self.port)
        await self._serve_control()
        with open(os.path.join(self.data_dir, STATE_NAME), "w") as f:
            json.dump({"pid": os.getpid(), "port": self.api_port}, f)
        return self.api_port

    async def run(self, open_path: str | None = None) -> None:
        """start() + open the UI + serve until quit/signal."""
        await self.start()
        url = _explorer_url(self.api_port or 0, open_path)
        self.opened_urls.append(url)
        if self.open_browser:
            self.opener(url)
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self._quit.set)
            except (NotImplementedError, RuntimeError):
                pass
        try:
            await self._quit.wait()
        finally:
            await self.shutdown()

    async def shutdown(self) -> None:
        if self._ctrl_server is not None:
            self._ctrl_server.close()
            await self._ctrl_server.wait_closed()
            self._ctrl_server = None
        if self.node is not None:
            await self.node.shutdown()
            self.node = None
        for name in (SOCK_NAME, STATE_NAME):
            try:
                os.unlink(os.path.join(self.data_dir, name))
            except FileNotFoundError:
                pass
        self._unlock()


async def run_or_forward(data_dir: str, *, open_path: str | None = None,
                         quit_running: bool = False,
                         host: str = "127.0.0.1", port: int = 0,
                         open_browser: bool = True,
                         node_factory: Callable[[], Any] | None = None,
                         device: str = "cuda",
                         ) -> int:
    """The `sdx desktop` entry: become the instance, or forward to it.

    Returns a process exit code. Forwarded commands (second instance,
    --quit) return after the running host acknowledges.
    """
    if open_path:
        open_path = parse_open_arg(open_path)
    probe = DesktopHost(data_dir, host=host, port=port,
                        open_browser=open_browser,
                        node_factory=node_factory, device=device)
    if quit_running:
        try:
            await control_request(data_dir, {"cmd": "quit"})
            print("sdx desktop: quit sent")
            return 0
        except (OSError, asyncio.TimeoutError):
            print("sdx desktop: no running instance", file=sys.stderr)
            return 1
    if not probe.try_lock():
        # single instance: hand our request to the owner
        try:
            resp = await control_request(
                data_dir, {"cmd": "open", "path": open_path})
        except (OSError, asyncio.TimeoutError) as e:
            print(f"sdx desktop: instance lock held but control socket "
                  f"unreachable: {e}", file=sys.stderr)
            return 1
        print(f"sdx desktop: forwarded to running instance "
              f"(pid {resp.get('pid')}, {resp.get('url')})")
        return 0
    # keep holding the lock into run() — releasing here would let a
    # concurrent launch win the re-acquire and crash this process
    print(f"sdx desktop: starting core for {probe.data_dir}")
    await probe.run(open_path)
    return 0


# --- XDG registration ------------------------------------------------------

DESKTOP_ENTRY = """[Desktop Entry]
Type=Application
Name=Spacedrive TPU
Comment=TPU-native file explorer
Exec={exec_line} desktop --open-path %u
Terminal=false
Categories=System;FileTools;FileManager;
MimeType=inode/directory;x-scheme-handler/sdx;
"""


def parse_open_arg(raw: str) -> str:
    """Normalize what the OS hands the %u field code: a plain path, a
    file:// URI, or an sdx://open/<path> deep link — all become a
    filesystem path for the ephemeral route."""
    if raw.startswith("sdx://"):
        parsed = urllib.parse.urlparse(raw)
        path = urllib.parse.unquote(parsed.path or "")
        if parsed.netloc and parsed.netloc != "open":
            # sdx://<abs-path-first-seg>/... (no recognised verb)
            path = "/" + parsed.netloc + path
        return path or "/"
    if raw.startswith("file://"):
        return urllib.parse.unquote(urllib.parse.urlparse(raw).path) or "/"
    return raw


def register_xdg(exec_line: str | None = None) -> str:
    """Write the XDG application entry (launcher + "Open with" + sdx:
    scheme). Honors $XDG_DATA_HOME; returns the written path."""
    exec_line = exec_line or f"{sys.executable} -m spacedrive_tpu_torch"
    base = os.environ.get("XDG_DATA_HOME",
                          os.path.expanduser("~/.local/share"))
    apps = os.path.join(base, "applications")
    os.makedirs(apps, exist_ok=True)
    path = os.path.join(apps, "sdx.desktop")
    with open(path, "w") as f:
        f.write(DESKTOP_ENTRY.format(exec_line=exec_line))
    # refresh the desktop database so "Open with" menus pick it up
    upd = shutil.which("update-desktop-database")
    if upd:
        subprocess.run([upd, apps], check=False,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return path
