"""Persistent per-user cgrep configuration.

Reference: colgrep/src/config.rs (Config struct, TOML at the XDG config dir)
and colgrep/src/commands/config.rs (cmd_set_model / cmd_config). Same field
names for the fields that are meaningful here; ONNX/CUDA session knobs
(parallel_sessions, fp32, coreml_cache_dir, intra-op threads) have no
equivalent here — the forward runs on the device `--device` names — and are
intentionally absent.

Stored as TOML (read via stdlib tomllib; written by a minimal serializer —
every field is a scalar or a list of strings, so no external TOML writer is
needed).
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

DEFAULT_POOL_FACTOR = 2  # reference config.rs:18
DEFAULT_HYBRID_ALPHA = 0.75


def config_dir() -> Path:
    env = os.environ.get("CGREP_CONFIG_DIR")
    if env:
        return Path(env)
    xdg = os.environ.get("XDG_CONFIG_HOME")
    base = Path(xdg) if xdg else Path.home() / ".config"
    return base / "cgrep"


def config_path() -> Path:
    return config_dir() / "config.toml"


@dataclass
class CgrepConfig:
    """Mirror of reference Config (colgrep/src/config.rs:110-184 subset)."""

    default_model: Optional[str] = None
    default_k: Optional[int] = None  # top_k when -k not given
    pool_factor: Optional[int] = None  # token pooling at index time
    batch_size: Optional[int] = None  # encoder batch size
    verbose: Optional[bool] = None
    relative_paths: Optional[bool] = None  # display paths relative to root
    hybrid_search: Optional[bool] = None  # semantic+BM25 fusion (default on)
    hybrid_alpha: Optional[float] = None
    extra_ignore: List[str] = field(default_factory=list)
    force_include: List[str] = field(default_factory=list)

    # ------------------------------------------------------------------
    @classmethod
    def load(cls) -> "CgrepConfig":
        p = config_path()
        if not p.exists():
            return cls()
        try:
            data = tomllib.loads(p.read_text())
        except (OSError, tomllib.TOMLDecodeError):
            return cls()
        known = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in data.items():
            if k in known:
                kwargs[k] = v
        try:
            return cls(**kwargs)
        except TypeError:
            return cls()

    def save(self) -> Path:
        p = config_path()
        p.parent.mkdir(parents=True, exist_ok=True)
        lines = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None or v == []:
                continue
            lines.append(f"{f.name} = {_toml_value(v)}")
        tmp = p.with_suffix(".tmp")
        tmp.write_text("\n".join(lines) + ("\n" if lines else ""))
        tmp.replace(p)
        return p

    # ------------------------------------------------------------------
    def set_value(self, key: str, raw: str) -> None:
        """Parse RAW per the field's type and assign (settings --set)."""
        f = self._field(key)
        if f.name in ("extra_ignore", "force_include"):
            vals = [s for s in (x.strip() for x in raw.split(",")) if s]
            setattr(self, f.name, vals)
            return
        if f.name in ("default_k", "pool_factor", "batch_size"):
            setattr(self, f.name, int(raw))
            return
        if f.name == "hybrid_alpha":
            v = float(raw)
            if not 0.0 <= v <= 1.0:
                raise ValueError("hybrid_alpha must be in [0, 1]")
            setattr(self, f.name, v)
            return
        if f.name in ("verbose", "relative_paths", "hybrid_search"):
            low = raw.strip().lower()
            if low in ("true", "1", "yes", "on"):
                setattr(self, f.name, True)
            elif low in ("false", "0", "no", "off"):
                setattr(self, f.name, False)
            else:
                raise ValueError(f"expected a boolean, got {raw!r}")
            return
        setattr(self, f.name, raw)  # default_model (string)

    def unset(self, key: str) -> None:
        f = self._field(key)
        setattr(
            self, f.name, [] if f.name in ("extra_ignore", "force_include")
            else None,
        )

    def _field(self, key: str) -> dataclasses.Field:
        for f in dataclasses.fields(self):
            if f.name == key:
                return f
        valid = ", ".join(f.name for f in dataclasses.fields(self))
        raise KeyError(f"unknown setting {key!r} (valid: {valid})")

    def as_display_dict(self) -> dict:
        return {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)
        }


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    s = str(v).replace("\\", "\\\\").replace('"', '\\"')
    return f'"{s}"'
