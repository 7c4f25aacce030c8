"""Config system (port of hydrainfer_tpu/config.py, a copy: that module
imports no JAX, and the port imports nothing of the JAX package).

YAML + dataclass composition with CLI dotted overrides. Every component
keeps its typed XxxConfig dataclass; this module materializes a nested
dataclass tree from YAML/dict (resolving `include:` at any level) and
applies `a.b.c=value` overrides with coercion from the field annotation.
Unknown keys raise. The presets under config/ are read as they are.
"""
import dataclasses
import os
import typing
from typing import Any, List, Optional, Sequence

import yaml


def deep_merge(base: dict, overlay: dict) -> dict:
    """Recursive dict merge: overlay wins; nested dicts merge, everything
    else (including lists) replaces."""
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def resolve_includes(data, base_dir: str, _stack: tuple = ()):
    """Resolve `include: path | [paths]` keys at ANY dict level (the
    reference's Hydra defaults-list equivalent, reference: config/ tree —
    cluster presets composing node presets). Included files merge in order,
    the including dict's own keys win; paths are relative to the including
    file. Cycles raise."""
    if isinstance(data, list):
        return [resolve_includes(v, base_dir, _stack) for v in data]
    if not isinstance(data, dict):
        return data
    includes = data.pop("include", None)
    merged: dict = {}
    if includes:
        if isinstance(includes, str):
            includes = [includes]
        for inc in includes:
            path = os.path.normpath(os.path.join(base_dir, inc))
            if path in _stack:
                raise ValueError(f"config include cycle at {path}")
            with open(path) as f:
                sub = yaml.safe_load(f) or {}
            sub = resolve_includes(sub, os.path.dirname(path),
                                   _stack + (path,))
            merged = deep_merge(merged, sub)
    own = {k: resolve_includes(v, base_dir, _stack) for k, v in data.items()}
    return deep_merge(merged, own)


def _coerce(value: str, target_type):
    origin = typing.get_origin(target_type)
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(target_type) if a is not type(None)]
        if len(args) == 1:
            return _coerce(value, args[0])
        return yaml.safe_load(value)
    if target_type is bool:
        return str(value).lower() in ("1", "true", "yes", "on")
    if target_type in (int, float, str):
        return target_type(value)
    parsed = yaml.safe_load(value)
    # `cluster.nodes=[{node_type: P}, ...]`-style overrides: materialize
    # dataclass elements / nested dataclasses from the parsed YAML value.
    origin = typing.get_origin(target_type)
    if origin in (list, List) and isinstance(parsed, list):
        (elem_type,) = typing.get_args(target_type) or (Any,)
        if dataclasses.is_dataclass(elem_type):
            return [build_dataclass(elem_type, v) if isinstance(v, dict) else v
                    for v in parsed]
    if dataclasses.is_dataclass(target_type) and isinstance(parsed, dict):
        return build_dataclass(target_type, parsed)
    return parsed


def build_dataclass(cls, data: dict):
    """Recursively instantiate dataclass `cls` from a plain dict."""
    if data is None:
        return cls()
    assert dataclasses.is_dataclass(cls), f"{cls} is not a dataclass"
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        ftype = hints.get(f.name, f.type)
        origin = typing.get_origin(ftype)
        if origin is typing.Union:  # Optional[SomeConfig]
            args = [a for a in typing.get_args(ftype) if a is not type(None)]
            if len(args) == 1:
                ftype = args[0]
                origin = typing.get_origin(ftype)
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[f.name] = build_dataclass(ftype, value)
        elif origin in (list, List) and isinstance(value, list):
            (elem_type,) = typing.get_args(ftype) or (Any,)
            if dataclasses.is_dataclass(elem_type):
                kwargs[f.name] = [build_dataclass(elem_type, v) if isinstance(v, dict) else v
                                  for v in value]
            else:
                kwargs[f.name] = value
        else:
            kwargs[f.name] = value
    unknown = set(data) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    return cls(**kwargs)


def apply_override(cfg, dotted_key: str, value: str) -> None:
    """Set cfg.a.b.c = value with type coercion from the field annotation."""
    parts = dotted_key.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    hints = typing.get_type_hints(type(obj))
    ftype = hints.get(leaf, str)
    if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
        setattr(obj, leaf, build_dataclass(ftype, value))
    else:
        setattr(obj, leaf, _coerce(value, ftype) if isinstance(value, str) else value)


def load_config(cls, yaml_path: Optional[str] = None,
                overrides: Sequence[str] = ()):
    """YAML file (optional) + `key.path=value` overrides → dataclass tree."""
    data = {}
    if yaml_path:
        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        data = resolve_includes(data, os.path.dirname(os.path.abspath(yaml_path)))
    cfg = build_dataclass(cls, data)
    for ov in overrides:
        assert "=" in ov, f"override must be key=value, got {ov!r}"
        key, _, value = ov.partition("=")
        apply_override(cfg, key.strip(), value.strip())
    return cfg
