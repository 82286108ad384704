"""Persistent aria2 download daemon driven over its JSON-RPC interface.

The reference keeps one aria2c daemon alive for the whole dataset download
and enqueues every tar through RPC so retries/segmenting/integrity checks
happen server-side (reference omnidata_tools/dataset/download.py:129-140:
``ensure_aria2_server`` spawns ``aria2c --enable-rpc`` and wraps it in
aria2p; ``download_tar`` calls ``add_uri(uris, {'out','dir','checksum'})``
and polls). aria2p isn't available offline, so this module speaks the
aria2 JSON-RPC protocol (https://aria2.github.io/manual — ``aria2.addUri``
/ ``aria2.tellStatus``) directly with urllib. Behavior kept:

- one daemon per process, spawned lazily, SIGINT'd at exit;
- ``-c`` resume, ``--auto-file-renaming=false``, ``-s/-j/-x`` fan-out;
- server-side md5 verification via the ``checksum`` download option;
- callers fall back to plain urllib when aria2c isn't installed.

The port's copy of ``omnidata_tpu.data.aria2_rpc``, without three of its
faults: a daemon found dead is respawned (there, every later call fell back
to urllib); the daemon listens on a free ephemeral port with a per-process
``--rpc-secret`` (there, fixed port 6800 and no secret: concurrent
downloaders raced for the port and any local user could drive it); and each
finished or failed download's result is purged with
``aria2.removeDownloadResult`` (there, they piled up in the daemon).
"""
from __future__ import annotations

import atexit
import json
import os
import secrets
import shutil
import signal
import socket
import subprocess
import time
import urllib.request

__all__ = ["Aria2RPC", "ensure_daemon"]


class Aria2RPC:
    """Minimal JSON-RPC client for one aria2 daemon."""

    def __init__(self, host: str = "localhost", port: int = 6800,
                 secret: str = ""):
        self.url = f"http://{host}:{port}/jsonrpc"
        self.secret = secret
        self._id = 0

    def call(self, method: str, *params):
        """POST one aria2 JSON-RPC request; returns the ``result`` field."""
        if self.secret:  # token goes first, per the aria2 RPC auth scheme
            params = (f"token:{self.secret}",) + params
        self._id += 1
        body = json.dumps({"jsonrpc": "2.0", "id": str(self._id),
                           "method": method, "params": list(params)})
        req = urllib.request.Request(
            self.url, body.encode(), {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            reply = json.loads(r.read())
        if "error" in reply:
            raise IOError(f"aria2 rpc {method}: {reply['error']}")
        return reply["result"]

    def alive(self) -> bool:
        try:
            self.call("aria2.getVersion")
            return True
        except Exception:  # noqa: BLE001 — any failure means "not usable"
            return False

    def download(self, url: str, dest: str, checksum: str | None = None,
                 poll_s: float = 0.25, timeout_s: float = 24 * 3600) -> None:
        """Enqueue ``url`` -> ``dest`` and block until the daemon finishes.

        ``checksum`` (md5 hex) is verified by the daemon itself
        (reference download.py:158: ``options['checksum'] = f"md5={...}"``).
        Raises IOError on daemon-reported error or timeout.
        """
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        opts = {"out": os.path.basename(dest),
                "dir": os.path.abspath(os.path.dirname(dest) or "."),
                "auto-file-renaming": "false", "check-integrity": "true"}
        if checksum:
            opts["checksum"] = f"md5={checksum}"
        gid = self.call("aria2.addUri", [url], opts)
        deadline = time.monotonic() + timeout_s
        while True:
            st = self.call("aria2.tellStatus", gid,
                           ["status", "errorMessage", "totalLength",
                            "completedLength"])
            if st["status"] in ("complete", "error", "removed"):
                self.call("aria2.removeDownloadResult", gid)
            if st["status"] == "complete":
                return
            if st["status"] in ("error", "removed"):
                raise IOError(f"aria2 download failed for {url}: "
                              f"{st.get('errorMessage', st['status'])}")
            if time.monotonic() > deadline:
                raise IOError(f"aria2 download timed out for {url}")
            time.sleep(poll_s)


_DAEMON: Aria2RPC | None = None
_PROC: subprocess.Popen | None = None
_SECRET = secrets.token_hex(16)  # this process's RPC token


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        os.kill(proc.pid, signal.SIGINT)


def ensure_daemon(connections_total: int = 8,
                  connections_per_server: int | None = None,
                  port: int | None = None,
                  secret: str | None = None) -> Aria2RPC | None:
    """Spawn (once per process, again if it died) a background ``aria2c
    --enable-rpc`` daemon on ``port`` (default: a free ephemeral one) with
    ``--rpc-secret`` ``secret`` (default: this process's random token).

    Returns a connected client, or None when aria2c isn't installed /
    refuses to start — callers then fall back to urllib. The daemon gets
    SIGINT at interpreter exit (reference download.py:140 atexit.register).
    """
    global _DAEMON, _PROC
    if _DAEMON is not None:
        if _DAEMON.alive():
            return _DAEMON
        _DAEMON = None  # died: respawn below
        if _PROC is not None:
            _stop(_PROC)
            _PROC = None
    if not shutil.which("aria2c"):
        return None
    n = connections_total
    x = min(connections_per_server if connections_per_server else n, 16)
    port = _free_port() if port is None else port
    secret = _SECRET if secret is None else secret
    proc = subprocess.Popen(
        ["aria2c", "--enable-rpc", f"--rpc-listen-port={port}",
         "--disable-ipv6", "-c", "--auto-file-renaming=false",
         f"-s{n}", f"-j{n}", f"-x{x}", "-q", f"--rpc-secret={secret}"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    atexit.register(_stop, proc)
    client = Aria2RPC(port=port, secret=secret)
    for _ in range(40):  # ~4 s for the RPC socket to come up
        if client.alive():
            _DAEMON, _PROC = client, proc
            return client
        if proc.poll() is not None:
            return None
        time.sleep(0.1)
    _stop(proc)
    return None
