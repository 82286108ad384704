"""The port's starter-dataset downloader (``omnidata_tpu_torch.data.
{download, aria2_rpc}``) against the JAX package's, on the inputs of
tests/test_data_augment.py:178-338, and one test for each fault of the
JAX package's that ADVICE.md lists and the port leaves out (each fails on
a literal copy of the JAX modules):

- after a failed attempt the partial tar and its .aria2 file are removed,
  so the retry fetches afresh (download.py:292);
- a daemon found dead is respawned (aria2_rpc.py:96);
- the daemon listens on a free ephemeral port with a per-process
  --rpc-secret (aria2_rpc.py:113);
- each finished or failed download's result is purged with
  aria2.removeDownloadResult (aria2_rpc.py:87).

Nothing is downloaded: sources are file:// URLs and the daemons are fakes
on localhost (an in-process JSON-RPC server, or a fake ``aria2c`` script on
PATH that serves aria2's RPC).
"""
import contextlib
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tarfile
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest
import torch

import omnidata_tpu.data.download as jdl
import omnidata_tpu_torch.data.aria2_rpc as rpc
import omnidata_tpu_torch.data.download as tdl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def test_url_parsers_and_filters_match_jax():
    url = ("https://x.test/omnidata/omnidata_tars/depth_euclidean/blendedMVS/"
           "depth_euclidean-blendedMVS-000000.tar")
    for mod in (tdl, jdl):
        m = mod.OmnidataMetadata("https://x.test/omnidata/", ".tar").parse(url)
        assert (m.component_name, m.domain, m.model_name, m.fname) == (
            "blendedMVS", "depth_euclidean", "000000",
            "depth_euclidean__blendedMVS__000000.tar")
        with pytest.raises(ValueError):
            mod.OmnidataMetadata("https://x.test/omnidata/", ".tar").parse(
                "https://x.test/omnidata/omnidata_tars/depth/blendedMVS/normal-blendedMVS-0.tar")
        tk = mod.TaskonomyMetadata("https://x.test/taskonomy/")
        m2 = tk.parse("https://x.test/taskonomy/adairsville_class_object.tar")
        assert (m2.component_name, m2.model_name, m2.domain) == (
            "taskonomy", "adairsville", "class_object")
        assert tk.parse("https://x.test/taskonomy/a_fragments.tar").tar_structure == (
            "domain", "model_name")
    models = [tdl.ZippedModel("replica", "rgb", f"m{i}", f"u{i}") for i in range(10)]
    models.append(tdl.ZippedModel("taskonomy", "normal", "t0", "u"))
    jmodels = [jdl.ZippedModel(*(getattr(m, f) for f in ("component_name", "domain",
                                                         "model_name", "url")))
               for m in models]
    for args in ((["rgb"], "all", "all", ["replica"]), (["all"], "all", "all",
                                                         ["replica", "taskonomy"]),
                 (["rgb"], "debug", "all", ["replica"], None, {"replica": {"debug": ["m3"]}})):
        got = [m.model_name for m in tdl.filter_models(models, *args)]
        assert got == [m.model_name for m in jdl.filter_models(jmodels, *args)]
    assert len(tdl.filter_models(models, ["rgb"], "all", "all", ["replica"])[1::3]) == 3


def _tar(tmp_path, model="frl0"):
    src = tmp_path / "stage" / "rgb" / "replica" / model
    src.mkdir(parents=True)
    (src / "point_0_view_0_domain_rgb.png").write_bytes(b"fakepng")
    tar_path = tmp_path / f"rgb__replica__{model}.tar"
    with tarfile.open(tar_path, "w") as tf:
        tf.add(tmp_path / "stage" / "rgb", arcname="rgb")
    return tar_path


@pytest.mark.parametrize("mod", [tdl, jdl], ids=["port", "jax"])
def test_process_model_roundtrip(tmp_path, mod):
    """tests/test_data_augment.py:203 on both packages: extract, skip what is
    extracted, fail a bad checksum."""
    tar_path = _tar(tmp_path)
    model = mod.ZippedModel("replica", "rgb", "frl0", f"file://{tar_path}",
                            checksum=mod.md5sum(str(tar_path)))
    dest, dest_c = tmp_path / "out", tmp_path / "tars"
    assert mod.process_model(model, str(dest), str(dest_c))
    assert (dest / "rgb" / "replica" / "frl0" / "point_0_view_0_domain_rgb.png").exists()
    assert mod.process_model(model, str(dest), str(dest_c))
    bad = mod.ZippedModel("replica", "rgb", "frl1", f"file://{tar_path}", checksum="0" * 32)
    errors = []
    assert not mod.process_model(bad, str(dest), str(dest_c), max_tries=1, errors=errors)
    assert errors


def test_retry_removes_the_failed_tar_and_its_aria2_file(tmp_path, monkeypatch):
    """ADVICE.md download.py:292: the first fetch leaves a corrupt tar and a
    .aria2 control file and fails; the retry must fetch afresh. (The JAX
    package keeps the tar when a checksum is known: its retry then fails
    the md5 check, and two attempts are spent.)"""
    tar_path = _tar(tmp_path)
    good = tar_path.read_bytes()
    calls = []

    def flaky_download(url, dest, use_aria2=False, connections=8, checksum=None):
        calls.append(os.path.exists(dest) or os.path.exists(dest + ".aria2"))
        with open(dest, "wb") as fh:
            fh.write(good if len(calls) > 1 else good[:100])
        if len(calls) == 1:
            open(dest + ".aria2", "wb").close()
            raise IOError("connection reset")

    monkeypatch.setattr(tdl, "download_file", flaky_download)
    model = tdl.ZippedModel("replica", "rgb", "frl0", "http://x.test/frl0.tar",
                            checksum=tdl.md5sum(str(tar_path)))
    dest_c = tmp_path / "tars"
    dest_c.mkdir()
    assert tdl.process_model(model, str(tmp_path / "out"), str(dest_c), max_tries=2)
    assert calls == [False, False]  # the retry found neither file
    assert os.listdir(dest_c) == []


def _fake_rpc_server(jobs, methods):
    """In-process aria2 JSON-RPC: serves file:// URIs, checks the md5 option
    as aria2's --check-integrity does, records every method and its
    params."""
    class FakeAria2(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            method, params = req["method"], req.get("params", [])
            methods.append((method, params))
            result = None
            if method == "aria2.getVersion":
                result = {"version": "fake"}
            elif method == "aria2.addUri":
                (uri,), opts = params[0], params[1]
                gid = f"g{sum(m == 'aria2.addUri' for m, _ in methods) - 1}"
                dest = os.path.join(opts["dir"], opts["out"])
                with urllib.request.urlopen(uri) as r, open(dest, "wb") as fh:
                    shutil.copyfileobj(r, fh)
                got = "md5=" + hashlib.md5(open(dest, "rb").read()).hexdigest()
                want = opts.get("checksum", "")
                jobs[gid] = ({"status": "error", "errorMessage": "checksum mismatch"}
                             if want and want != got else {"status": "complete"})
                result = gid
            elif method == "aria2.tellStatus":
                result = jobs[params[0]]
            elif method == "aria2.removeDownloadResult":
                result = "OK" if jobs.pop(params[0], None) else None
            body = json.dumps({"jsonrpc": "2.0", "id": req["id"], "result": result}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = HTTPServer(("localhost", 0), FakeAria2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_aria2_client_against_fake_daemon_purges_results(tmp_path):
    """tests/test_data_augment.py:232, plus ADVICE.md aria2_rpc.py:87: after
    a complete and after a failed download the client removes the gid's
    result, so the daemon keeps none."""
    jobs, methods = {}, []
    srv = _fake_rpc_server(jobs, methods)
    try:
        client = rpc.Aria2RPC(port=srv.server_address[1])
        assert client.alive()
        src = tmp_path / "payload.bin"
        src.write_bytes(b"tar bytes here")
        dest = tmp_path / "fetched" / "payload.bin"
        client.download(f"file://{src}", str(dest), checksum=tdl.md5sum(str(src)))
        assert dest.read_bytes() == b"tar bytes here"
        with pytest.raises(IOError, match="checksum"):
            client.download(f"file://{src}", str(tmp_path / "bad.bin"), checksum="0" * 32)
    finally:
        srv.shutdown()
    removed = [p[0] for m, p in methods if m == "aria2.removeDownloadResult"]
    assert removed == ["g0", "g1"] and jobs == {}


def test_download_file_routes_through_rpc_daemon(tmp_path, monkeypatch):
    """tests/test_data_augment.py:307: use_aria2 prefers the daemon and
    hands it the md5."""
    calls = []

    class FakeClient:
        def download(self, url, dest, checksum=None, **kw):
            calls.append((url, dest, checksum))
            open(dest, "wb").write(b"via-rpc")

    monkeypatch.setattr(rpc, "ensure_daemon", lambda **kw: FakeClient())
    dest = tmp_path / "d" / "f.tar"
    tdl.download_file("http://x.test/f.tar", str(dest), use_aria2=True, checksum="a" * 32)
    assert calls == [("http://x.test/f.tar", str(dest), "a" * 32)]
    assert dest.read_bytes() == b"via-rpc"


def test_ensure_daemon_absent(monkeypatch):
    """tests/test_data_augment.py:328: without aria2c there is no daemon."""
    monkeypatch.setattr(rpc, "_DAEMON", None)
    monkeypatch.setattr(rpc.shutil, "which", lambda _: None)
    assert rpc.ensure_daemon() is None


FAKE_ARIA2C = r'''#!{python}
"""A fake aria2c: serves aria2.getVersion on --rpc-listen-port, requires the
--rpc-secret token, and appends its argv to {log}."""
import json
import os
import sys
from http.server import BaseHTTPRequestHandler, HTTPServer

args = sys.argv[1:]
opt = dict(a[2:].split("=", 1) for a in args if a.startswith("--") and "=" in a)
with open({log!r}, "a") as fh:
    fh.write(json.dumps([os.getpid(), args]) + "\n")
token = "token:" + opt.get("rpc-secret", "")


class H(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        params = req.get("params", [])
        if "rpc-secret" in opt and (not params or params[0] != token):
            reply = {{"error": {{"code": 1, "message": "Unauthorized"}}}}
        else:
            reply = {{"result": {{"version": "fake"}}}}
        reply.update(jsonrpc="2.0", id=req["id"])
        body = json.dumps(reply).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


try:
    HTTPServer(("localhost", int(opt["rpc-listen-port"])), H).serve_forever()
except KeyboardInterrupt:
    pass
'''


@pytest.fixture()
def fake_aria2c(tmp_path, monkeypatch):
    """A fake aria2c first on PATH; -> the file its argv lines land in.
    Stops the daemon ensure_daemon spawned."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "aria2c_argv.jsonl"
    exe = bin_dir / "aria2c"
    exe.write_text(FAKE_ARIA2C.format(python=sys.executable, log=str(log)))
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(rpc, "_DAEMON", None)
    monkeypatch.setattr(rpc, "_PROC", None, raising=False)
    yield log
    for pid, _ in _spawned(log):
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGTERM)


def _spawned(log):
    """(pid, argv) of each fake daemon started."""
    return [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []


def _argv_lines(log):
    return [argv for _, argv in _spawned(log)]


def _kill(pid):
    os.kill(pid, signal.SIGTERM)
    for _ in range(100):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, os.WNOHANG)
        time.sleep(0.05)


def test_daemon_takes_an_ephemeral_port_and_a_secret(fake_aria2c):
    """ADVICE.md aria2_rpc.py:113: not the fixed port 6800 and not without
    a secret; the client carries this process's token, and a call without
    it is refused."""
    client = rpc.ensure_daemon()
    assert client is not None and client.alive()
    (argv,) = _argv_lines(fake_aria2c)
    port = int(next(a.split("=")[1] for a in argv if a.startswith("--rpc-listen-port=")))
    assert port != 6800 and f":{port}/" in client.url
    assert f"--rpc-secret={rpc._SECRET}" in argv and len(rpc._SECRET) >= 32
    assert client.secret == rpc._SECRET
    assert not rpc.Aria2RPC(port=port).alive()  # no token: refused
    assert rpc.ensure_daemon() is client  # alive: reused, not respawned
    assert len(_argv_lines(fake_aria2c)) == 1


def test_dead_daemon_is_respawned(fake_aria2c):
    """ADVICE.md aria2_rpc.py:96: a cached daemon that stopped answering is
    replaced by a new one (the JAX package returns None for the rest of
    the process, so every download falls back to urllib)."""
    first = rpc.ensure_daemon()
    assert first is not None
    _kill(_spawned(fake_aria2c)[0][0])
    assert not first.alive()
    second = rpc.ensure_daemon()
    assert second is not None and second is not first and second.alive()
    assert len(_argv_lines(fake_aria2c)) == 2


def _served_dataset(tmp_path):
    """A file:// starter-dataset server: links.txt and md5sum.txt over two
    replica tars -> base URL."""
    base = tmp_path / "server"
    urls, sums = [], []
    for name in ("frl0", "apt1"):
        tar_path = _tar(tmp_path / name, name)
        rel = f"omnidata_tars/rgb/replica/rgb-replica-{name}.tar"
        (base / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(tar_path, base / rel)
        urls.append(f"file://{base}/{rel}")
        sums.append(f"{tdl.md5sum(str(base / rel))}  {rel}")
    (base / "links.txt").write_text("\n".join(urls) + "\n")
    (base / "md5sum.txt").write_text("\n".join(sums) + "\n")
    return f"file://{base}"


def test_main_downloads_from_a_local_server(tmp_path, monkeypatch):
    """``main(argv)`` end to end on a file:// server (DEFAULT_SERVERS
    pointed at it): the licence click-through, the subset ladder derived
    from the listing, md5 checks, extraction; and the same models as the
    JAX package's download() with --subset all."""
    base = _served_dataset(tmp_path)
    monkeypatch.setattr(tdl, "DEFAULT_SERVERS",
                        [lambda: tdl.OmnidataMetadata(base + "/", ".tar")])
    dest = tmp_path / "dest"
    argv = ["rgb", "--components", "replica", "--subset", "all", "--split", "all",
            "--dest", str(dest), "--dest_compressed", str(tmp_path / "tars"),
            "--agree_all", "--name", "A B", "--email", "a@b.org"]
    tdl.main(argv)
    assert sorted(os.listdir(dest / "rgb" / "replica")) == ["apt1", "frl0"]
    jdest = tmp_path / "jdest"
    done = jdl.download(["rgb"], "all", "all", ["replica"], str(jdest),
                        str(tmp_path / "jtars"), agree_all=True, name="A B",
                        email="a@b.org",
                        metadata_list=[jdl.OmnidataMetadata(base + "/", ".tar")])
    assert sorted(os.path.basename(d) for d in done) == ["apt1", "frl0"]
    # --subset debug derives the ladder by component_name from the listing
    done = tdl.download(["rgb"], "debug", "all", ["replica"], str(tmp_path / "d2"),
                        str(tmp_path / "t2"), agree_all=True, name="A B",
                        email="a@b.org",
                        metadata_list=[tdl.OmnidataMetadata(base + "/", ".tar")])
    assert 1 <= len(done) <= 2
    with pytest.raises(ValueError, match="--agree_all"):
        tdl.download(["rgb"], agree_all=True, metadata_list=[])


def test_module_runs_as_a_script():
    out = subprocess.run([sys.executable, "-m", "omnidata_tpu_torch.data.download",
                          "--help"], cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0 and "--use_aria2" in out.stdout
