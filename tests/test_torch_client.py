"""The reference SDK batteries against the port: `tests/test_client.py`
(the sync and async clients and the click CLI, over HTTP against the port's
server in a thread) and `tests/test_api_oop.py` (the port's server as a
subprocess, `python -m nextplaid_tpu_torch.api.server --device cpu`, driven
by the port's SDK and stopped with SIGTERM), each loaded by `port_battery`
with its imports of `nextplaid_tpu` pointed at `nextplaid_tpu_torch`.

Adapted: test_client.py takes its server thread from tests/test_torch_api.py
(the port's, on the CPU); test_api_oop.py starts the server with
`--device cpu` where the JAX package's takes `--platform cpu`. Left out:
test_compose_files_are_valid_yaml (the JAX package's Docker packaging).
"""

import signal
import subprocess
import sys
import time

import requests

from tests.test_torch_api import port_battery

_client = port_battery(
    "test_client",
    ("from tests.test_api import ServerThread, make_docs",
     "from tests.test_torch_api import ServerThread, make_docs"),
)
_oop = port_battery("test_api_oop", ('"--platform", "cpu",', '"--device", "cpu",'))

server = _client.server
client = _client.client
oop_server = _oop.oop_server

CLIENT_TESTS = tuple(n for n in dir(_client) if n.startswith("test_"))
OOP_TESTS = ("test_oop_sdk_battery", "test_oop_graceful_shutdown")
for _name in CLIENT_TESTS + OOP_TESTS:
    globals()[_name] = getattr(_client if _name in CLIENT_TESTS else _oop, _name)


def test_battery_lists_every_reference_test():
    assert len(CLIENT_TESTS) == 6
    assert {n for n in dir(_oop) if n.startswith("test_")} == set(OOP_TESTS) | {
        "test_compose_files_are_valid_yaml"
    }


def test_server_exits_zero_on_sigterm(tmp_path):
    """The port's server answers over HTTP, then SIGTERM ends it with
    status 0 within 10 s (aiohttp's graceful shutdown)."""
    from nextplaid_tpu_torch.client import NextPlaidClient

    port = _oop._free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "nextplaid_tpu_torch.api.server", "--host", "127.0.0.1",
         "--port", str(port), "--index-dir", str(tmp_path), "--device", "cpu"],
        cwd=_oop.REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                if requests.get(url + "/health", timeout=2).status_code == 200:
                    break
            except requests.ConnectionError:
                time.sleep(0.2)
        health = NextPlaidClient(url).health()
        assert health["status"] == "ok" and health["index_dir"] == str(tmp_path)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0, proc.stdout.read().decode(errors="replace")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()


def test_cli_serve_passes_the_device(monkeypatch):
    """`next-plaid serve --device cpu` starts the port's server on the CPU."""
    from click.testing import CliRunner

    from nextplaid_tpu_torch.api import server
    from nextplaid_tpu_torch.client.cli import cli

    seen = []
    monkeypatch.setattr(server, "main", lambda argv: seen.append(argv))
    result = CliRunner().invoke(cli, ["serve", "--index-dir", "idx", "--port", "9",
                                      "--device", "cpu"], obj={})
    assert result.exit_code == 0, result.output
    assert seen == [["--host", "0.0.0.0", "--port", "9", "--index-dir", "idx",
                     "--batch-size", "32", "--device", "cpu"]]
