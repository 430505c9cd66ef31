"""Reflection-based config system: dataclasses <-> argparse <-> persisted
(a copy of fovsplat/utils/config.py).

Counterpart of the reference's ParamGroup machinery
(fov3dgs/arguments/__init__.py:19-113): class attributes become CLI flags,
and every run persists its full config (`cfg_args`) which later invocations
merge with CLI overrides (get_combined_args) — except persisted as JSON
instead of eval()'able python repr. from_dict ignores keys the class
does not have, so a config the JAX package wrote loads here with its
Pallas-only fields dropped; it ignores `backend` too (IGNORED), whose
JAX default "xla" would put the port on its slow oracle route.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, get_type_hints


def add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str = "",
                       defaults: Any | None = None) -> None:
    """Add one flag per field of dataclass `cls` (bools become store_true /
    --no-X pairs; nested dataclasses are flattened with a prefix)."""
    inst = defaults if defaults is not None else cls()
    hints = get_type_hints(cls)
    for f in dataclasses.fields(cls):
        flag = f"{prefix}{f.name.replace('_', '-')}"
        dest = f"{prefix}{f.name}"
        val = getattr(inst, f.name)
        typ = hints.get(f.name, type(val))
        if dataclasses.is_dataclass(val):
            add_dataclass_args(parser, type(val), prefix=f"{flag}.",
                               defaults=val)
            continue
        if typ is bool or isinstance(val, bool):
            parser.add_argument(f"--{flag}", dest=dest, action="store_true",
                                default=None)
            parser.add_argument(f"--no-{flag}", dest=dest,
                                action="store_false", default=None)
        elif isinstance(val, (int, float, str)):
            parser.add_argument(f"--{flag}", dest=dest, type=type(val),
                                default=None)
        # tuples/None fields are config-file-only.


def apply_args(cfg, args_ns: argparse.Namespace, prefix: str = ""):
    """Return a copy of dataclass `cfg` with non-None CLI values applied."""
    updates = {}
    for f in dataclasses.fields(cfg):
        flag = f"{prefix}{f.name.replace('_', '-')}"
        dest = f"{prefix}{f.name}"
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            updates[f.name] = apply_args(val, args_ns, prefix=f"{flag}.")
            continue
        cli = vars(args_ns).get(dest)
        if cli is not None:
            updates[f.name] = cli
    return dataclasses.replace(cfg, **updates)


def to_dict(cfg) -> dict:
    def conv(v):
        if dataclasses.is_dataclass(v):
            return {f.name: conv(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        if isinstance(v, tuple):
            return list(v)
        return v
    return conv(cfg)


IGNORED = ("backend",)   # RasterizeConfig.backend keeps the port's default


def from_dict(cls, d: dict):
    kw = {}
    inst = cls()
    for f in dataclasses.fields(cls):
        if f.name not in d or f.name in IGNORED:
            continue
        cur = getattr(inst, f.name)
        if dataclasses.is_dataclass(cur):
            kw[f.name] = from_dict(type(cur), d[f.name])
        elif isinstance(cur, tuple):
            kw[f.name] = tuple(d[f.name])
        else:
            kw[f.name] = d[f.name]
    return dataclasses.replace(inst, **kw)


def save_config(path: str, cfg) -> None:
    """Persist the run config (the reference's cfg_args, as JSON)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"class": type(cfg).__name__, "config": to_dict(cfg)}, f,
                  indent=2)


def load_config(path: str, cls):
    with open(path) as f:
        d = json.load(f)
    return from_dict(cls, d["config"])


def combined_config(cls, model_dir: str, args_ns: argparse.Namespace,
                    name: str = "cfg_args.json"):
    """get_combined_args semantics: persisted config overridden by any CLI
    values the user actually passed (arguments/__init__.py:93-113)."""
    path = os.path.join(model_dir, name)
    cfg = load_config(path, cls) if os.path.exists(path) else cls()
    return apply_args(cfg, args_ns)
