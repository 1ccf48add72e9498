"""The CUDA image's steps, read out of docker/Dockerfile.cuda and the compose
files, and the same steps replayed without docker.

tests/test_torch_deploy.py (on the CPU) and chip_smoke.py (on a card) both
read the image through this module, so the replay on the card runs the steps
that ship: the COPY set, the build step's command, the import check, the
server's argv (the ENTRYPOINT, then the base compose file's `command` with
`${VAR:-default}` expanded) and the environment (the image's ENV, then the
compose `environment`), with docker-compose.cuda.yml laid over
docker-compose.yml as `docker compose -f docker-compose.yml -f
docker-compose.cuda.yml` lays it.

The replay maps what docker maps: the image's WORKDIR to a directory that
holds only the COPY set, each volume's container path to its host path, the
container's port to a host port; `python` in the image's commands is the
interpreter that runs the replay.
"""

from __future__ import annotations

import json
import os
import re
import shlex
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import yaml

ROOT = Path(__file__).resolve().parents[1]
DOCKERFILE = ROOT / "docker" / "Dockerfile.cuda"
COMPOSE = ROOT / "docker-compose.yml"
OVERLAY = ROOT / "docker-compose.cuda.yml"
SERVICE = "nextplaid-tpu-api"
CONTAINER_PORT = 8080
# The build step is the RUN that compiles; the import check the RUN that
# imports the server.
BUILD_MARK = "build_served"
CHECK_MARK = "nextplaid_tpu_torch.api.server"


@dataclass
class Image:
    """What docker/Dockerfile.cuda does, instruction by instruction."""

    workdir: str
    env: Dict[str, str]  # ENV, in order, `$VAR` left unexpanded
    copies: List[Tuple[str, str]]  # (source in the checkout, destination)
    runs: List[str]  # RUN commands, continuation lines joined as docker joins them
    entrypoint: List[str]
    targets: List[str]  # stage names (FROM ... AS name)

    @property
    def copy_set(self) -> List[str]:
        """The checkout paths the image holds."""
        return [src for src, _ in self.copies]

    @property
    def pip_packages(self) -> List[str]:
        """Every requirement a `pip install` of a RUN names (options and
        their values left out)."""
        out = []
        for run in self.runs:
            lexer = shlex.shlex(run, posix=True, punctuation_chars=True)
            lexer.whitespace_split = True
            commands, words = [], []
            for token in lexer:
                if token in ("&&", ";", "||", "|"):
                    commands.append(words)
                    words = []
                else:
                    words.append(token)
            for words in commands + [words]:
                if words[:2] != ["pip", "install"]:
                    continue
                skip = False
                for w in words[2:]:
                    if skip:
                        skip = False
                    elif w in ("--index-url", "--extra-index-url", "-f", "--find-links", "-r"):
                        skip = True
                    elif not w.startswith("-"):
                        out.append(w)
        return out

    def _run_with(self, mark: str) -> List[str]:
        found = [r for r in self.runs if mark in r and r.startswith("python ")]
        if len(found) != 1:
            raise ValueError(f"{DOCKERFILE.name}: {len(found)} python RUN steps name {mark!r}")
        return shlex.split(found[0])

    @property
    def build_step(self) -> List[str]:
        """argv of the step that compiles the kernels and the native host
        library."""
        return self._run_with(BUILD_MARK)

    @property
    def import_check(self) -> List[str]:
        """argv of the step that imports the server and refuses jax."""
        return self._run_with(CHECK_MARK)


def read_image(path: Path = DOCKERFILE) -> Image:
    """Parse the Dockerfile's instructions: comments dropped, continuation
    lines joined as docker joins them."""
    logical, cur = [], ""
    for line in path.read_text().splitlines():
        if not cur and (not line.strip() or line.lstrip().startswith("#")):
            continue
        if line.endswith("\\"):
            cur += line[:-1]
            continue
        logical.append(cur + line)
        cur = ""
    image = Image(workdir="/", env={}, copies=[], runs=[], entrypoint=[], targets=[])
    for text in logical:
        instr, _, args = text.strip().partition(" ")
        instr, args = instr.upper(), args.strip()
        if instr == "FROM":
            words = args.split()
            if len(words) == 3 and words[1].upper() == "AS":
                image.targets.append(words[2])
        elif instr == "WORKDIR":
            image.workdir = args
        elif instr == "ENV":
            for word in shlex.split(args):
                key, _, value = word.partition("=")
                image.env[key] = value
        elif instr == "COPY":
            *srcs, dest = shlex.split(args)
            for src in srcs:
                src = src.rstrip("/")
                target = dest + src if dest.endswith("/") else dest
                image.copies.append((src, target))
        elif instr == "RUN":
            image.runs.append(args)
        elif instr == "ENTRYPOINT":
            image.entrypoint = json.loads(args)
    return image


def interpolate(value, env: Mapping[str, str]):
    """Compose's `${VAR:-default}` and `${VAR}`, in every string of
    `value`."""
    if isinstance(value, dict):
        return {k: interpolate(v, env) for k, v in value.items()}
    if isinstance(value, list):
        return [interpolate(v, env) for v in value]
    if not isinstance(value, str):
        return value
    return re.sub(r"\$\{(\w+)(?::-([^}]*))?\}",
                  lambda m: env.get(m.group(1)) or (m.group(2) or ""), value)


def _env_dict(entries) -> Dict[str, str]:
    if isinstance(entries, dict):
        return {k: "" if v is None else str(v) for k, v in entries.items()}
    return dict(e.split("=", 1) if "=" in e else (e, "") for e in entries or [])


def _merge(base, over):
    """docker compose's merge of one service: mappings key by key,
    `environment` by variable; any other value replaced."""
    out = dict(base)
    for key, value in over.items():
        if key == "environment":
            out[key] = {**_env_dict(base.get(key)), **_env_dict(value)}
        elif isinstance(value, dict) and isinstance(base.get(key), dict):
            out[key] = _merge(base[key], value)
        else:
            out[key] = value
    return out


def load_compose(path: Path) -> dict:
    return yaml.safe_load(path.read_text())


def compose_service(env: Mapping[str, str]) -> dict:
    """The service as `docker compose -f docker-compose.yml -f
    docker-compose.cuda.yml` runs it, with the variables of `env` (the
    caller's shell) substituted."""
    service: dict = {}
    for path in (COMPOSE, OVERLAY):
        service = _merge(service, interpolate(load_compose(path)["services"][SERVICE], env))
    service["environment"] = _env_dict(service.get("environment"))
    return service


def server_argv(image: Image, service: dict) -> List[str]:
    """The container's command line: ENTRYPOINT, then the compose `command`."""
    return list(image.entrypoint) + [str(c) for c in service.get("command", [])]


def copy_image_files(dst: Path, image: Optional[Image] = None) -> List[str]:
    """What the image's COPY instructions put under its WORKDIR, put under
    `dst` (bytecode caches left out). Returns the relative paths copied."""
    image = image or read_image()
    copied = []
    for src, target in image.copies:
        rel_target = os.path.relpath(target, image.workdir)
        if rel_target.startswith(".."):
            raise ValueError(f"COPY {src} {target} lies outside WORKDIR {image.workdir}")
        source = ROOT / src
        if source.is_file():
            (dst / rel_target).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(source, dst / rel_target)
            copied.append(rel_target)
            continue
        for dirpath, dirs, files in os.walk(source):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for name in sorted(files):
                rel = Path(rel_target) / Path(dirpath).relative_to(source) / name
                (dst / rel).parent.mkdir(parents=True, exist_ok=True)
                shutil.copy2(os.path.join(dirpath, name), dst / rel)
                copied.append(str(rel))
    return copied


@dataclass
class Replay:
    """A process as the image would start it, on this machine."""

    argv: List[str]
    env: Dict[str, str]
    cwd: str


def replay(image: Image, argv: List[str], app_dir: Path, host_env: Mapping[str, str],
           python: str, service: Optional[dict] = None, port: Optional[int] = None) -> Replay:
    """`argv` (an image step, or the server's argv with `service` and its
    environment) run in `app_dir` as the image runs it in its WORKDIR: the
    environment is `host_env` without PYTHONPATH, then the image's ENV, then
    the service's `environment`; the WORKDIR and each of the service's
    volumes are mapped to their host paths, `--port` to `port`, `python` to
    `python`."""
    mounts = [(image.workdir, str(app_dir))]
    for volume in (service or {}).get("volumes", []):
        host, target = volume.split(":")[:2]
        mounts.append((target, os.path.expanduser(host)))
    mounts.sort(key=lambda m: -len(m[0]))

    def to_host(s: str) -> str:
        for container, host in mounts:
            if s == container or s.startswith(container.rstrip("/") + "/"):
                return host + s[len(container):]
        return s

    env = {k: v for k, v in host_env.items() if k != "PYTHONPATH"}
    for key, value in image.env.items():
        value = re.sub(r"\$\{?(\w+)\}?", lambda m: env.get(m.group(1), ""), value)
        env[key] = ":".join(to_host(p) for p in value.split(":"))
    for key, value in (service or {}).get("environment", {}).items():
        env[key] = to_host(value)
    out = [python if argv[0] == "python" else argv[0]]
    for i, word in enumerate(argv[1:], 1):
        if port is not None and argv[i - 1] == "--port" and word == str(CONTAINER_PORT):
            word = str(port)
        out.append(to_host(word))
    return Replay(argv=out, env=env, cwd=str(app_dir))
