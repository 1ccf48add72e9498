"""The port's CUDA image (docker/Dockerfile.cuda) and compose overlay
(docker-compose.cuda.yml), read through tests/torch_deploy_spec.py, the
reader chip_smoke.py's replay of the image on a card uses too. No docker
runs here: the tests hold what the files say against the port.

- The COPY set holds the port and its native source, not the JAX package;
  in a copy of that set, laid out as the image's WORKDIR, the native
  library's source is found and the kernels build under the copy.
- pip installs no jax, flax or optax, and every third-party package the
  port imports (collected with `ast`, the standard library aside).
- Every flag of the ENTRYPOINT and of docker-compose.yml's `command` parses
  through the port server's `build_parser()`; every variable of the base
  compose `environment` is read somewhere in the port.
- The overlay builds docker/Dockerfile.cuda's stage, reserves an NVIDIA GPU
  and sets no JAX_PLATFORMS.
- The build step, run on the CPU in a copy of the COPY set, raises "nvcc
  not found" (there is no fallback to a build without the kernels), and
  the import check imports the server without jax.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from nextplaid_tpu_torch.api.server import build_parser
from tests import torch_deploy_spec as D

PORT = D.ROOT / "nextplaid_tpu_torch"


@pytest.fixture(scope="module")
def image():
    return D.read_image()


@pytest.fixture(scope="module")
def app(image, tmp_path_factory):
    """A copy of the image's COPY set, laid out as its WORKDIR."""
    dst = tmp_path_factory.mktemp("image") / "app"
    D.copy_image_files(dst, image=image)
    return dst


def _run_in(app, argv, image, **env):
    """An image step in `app` with the image's environment (and `env`)."""
    r = D.replay(image, argv, app, {**os.environ, **env}, sys.executable)
    return subprocess.run(r.argv, cwd=r.cwd, env=r.env, capture_output=True, text=True,
                          timeout=300)


def test_copy_set_is_the_port(image, app):
    assert image.workdir == "/app" and image.env["PYTHONPATH"] == "/app"
    assert set(image.copy_set) == {"pyproject.toml", "nextplaid_tpu_torch", "native"}
    assert sorted(p.name for p in app.iterdir()) == ["native", "nextplaid_tpu_torch",
                                                     "pyproject.toml"]
    assert (app / "native" / "nextplaid_host.cpp").is_file()
    assert not list(app.rglob("__pycache__"))


def test_copy_finds_its_sources_and_build_dir(image, app):
    probe = ("import json; from nextplaid_tpu_torch.ops import maxsim_kernel as mk; "
             "from nextplaid_tpu_torch.storage import native; "
             "print(json.dumps([str(native.SOURCE), native.SOURCE.is_file(), "
             "str(mk.BUILD_DIR), str(native.BUILD_DIR), str(mk.SOURCE)]))")
    out = _run_in(app, ["python", "-c", probe], image)
    assert out.returncode == 0, out.stderr
    source, exists, build, native_build, kernel = json.loads(out.stdout.splitlines()[-1])
    assert exists and Path(source) == app / "native" / "nextplaid_host.cpp"
    assert Path(build) == Path(native_build) == app / "build" / "nextplaid_tpu_torch"
    assert Path(kernel).is_relative_to(app)


def _installed(image):
    """The distribution names the image's pip installs name."""
    return {re.split(r"[\[=<>!~]", p)[0].lower().replace("-", "_") for p in image.pip_packages}


def test_pip_installs_no_jax(image):
    names = _installed(image)
    assert not names & {"jax", "jaxlib", "flax", "optax"}, names
    # The project itself is never installed: its dependencies are JAX's.
    assert not {"/app", "/app/", "."} & set(image.pip_packages)


def _third_party_imports():
    found = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                mods = [node.module]
            else:
                continue
            found.update(m.split(".")[0] for m in mods)
    return {m for m in found if m not in sys.stdlib_module_names and m != "nextplaid_tpu_torch"}


def test_image_installs_every_import(image):
    imports = _third_party_imports()
    assert {"torch", "numpy", "aiohttp", "pydantic"} <= imports
    assert "jax" not in imports and "nextplaid_tpu" not in imports
    missing = imports - _installed(image)
    assert not missing, f"imported by the port, not installed by the image: {missing}"


def test_server_argv_parses(image):
    service = D.compose_service({})
    argv = D.server_argv(image, service)
    assert argv[:3] == ["python", "-m", "nextplaid_tpu_torch.api.server"]
    flags = [a for a in argv[3:] if a.startswith("--")]
    assert flags == ["--host", "--port", "--index-dir", "--model", "--batch-size",
                     "--query-length", "--document-length"]
    known = {opt for action in build_parser()._actions for opt in action.option_strings}
    assert set(flags) <= known
    args = build_parser().parse_args(argv[3:])
    assert (args.host, args.port, args.index_dir) == ("0.0.0.0", D.CONTAINER_PORT, "/data/indices")
    assert (args.model, args.batch_size, args.query_length, args.document_length) == (
        "/models/answerai-colbert-small-v1", 32, 48, 300)
    assert args.device is None  # the default, cuda: no silent CPU
    assert build_parser().parse_args(
        D.server_argv(image, D.compose_service({"MODEL": "/m", "ENCODE_BATCH_SIZE": "8"}))[3:]
    ).batch_size == 8


def test_compose_environment_is_read_by_the_port():
    env = D.compose_service({})["environment"]
    sources = "\n".join(p.read_text() for p in PORT.rglob("*.py"))
    assert set(env) >= {"NEXT_PLAID_SERVE_MODE", "NEXT_PLAID_PIN_DTYPE", "MODEL_POOL_SIZE"}
    unread = [k for k in env if f'"{k}"' not in sources]
    assert not unread, f"set by docker-compose.yml, read nowhere in the port: {unread}"
    assert (env["NEXT_PLAID_SERVE_MODE"], env["NEXT_PLAID_PIN_DTYPE"]) == ("auto", "auto")


def test_overlay_reserves_an_nvidia_gpu(image):
    over = D.load_compose(D.OVERLAY)["services"][D.SERVICE]
    assert over["build"] == {"dockerfile": "docker/Dockerfile.cuda", "target": "runtime-cuda"}
    assert over["build"]["target"] in image.targets
    devices = over["deploy"]["resources"]["reservations"]["devices"]
    assert any(d["driver"] == "nvidia" and "gpu" in d["capabilities"] for d in devices)
    service = D.compose_service({})
    assert "JAX_PLATFORMS" not in service["environment"] and "JAX_PLATFORMS" not in image.env
    assert "JAX_PLATFORMS" not in D.OVERLAY.read_text()
    # The base file's command, volumes and healthcheck stay in force.
    base = D.load_compose(D.COMPOSE)["services"][D.SERVICE]
    for key in ("command", "volumes", "healthcheck", "environment"):
        assert key not in over and key in base
    assert service["deploy"]["resources"]["limits"] == base["deploy"]["resources"]["limits"]


def test_compose_service_lays_the_overlay_over_the_base():
    """The overlay's build over the base's, the base's volumes and
    environment with the caller's variables substituted."""
    service = D.compose_service({"NEXT_PLAID_DATA": "/srv/idx", "NEXT_PLAID_SERVE_MODE": "grid_only"})
    assert service["build"] == {"context": ".", "dockerfile": "docker/Dockerfile.cuda",
                                "target": "runtime-cuda"}
    assert service["volumes"][0] == "/srv/idx:/data/indices"
    assert service["environment"]["NEXT_PLAID_SERVE_MODE"] == "grid_only"
    assert yaml.safe_load(D.COMPOSE.read_text())["services"][D.SERVICE]["ports"] == ["8080:8080"]


def test_build_step_stops_at_nvcc(image, app):
    out = _run_in(app, image.build_step, image, CUDA_HOME=str(app / "no-cuda"),
                  PATH=os.pathsep.join(p for p in os.environ["PATH"].split(os.pathsep)
                                       if not (Path(p) / "nvcc").exists()))
    assert out.returncode != 0
    assert "nvcc not found" in out.stderr, out.stderr[-2000:]
    assert not (app / "build" / "nextplaid_tpu_torch").exists() or not list(
        (app / "build" / "nextplaid_tpu_torch").glob("maxsim_*.so"))


def test_import_check_passes_without_jax(image, app):
    out = _run_in(app, image.import_check, image)
    assert out.returncode == 0, out.stderr[-2000:]
