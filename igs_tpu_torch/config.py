"""Config system: YAML + ``extends`` + ${...} interpolation + CLI dotlist.

Counterpart of ``igs_tpu/config.py``, a dependency-free reimplementation
of the reference's OmegaConf usage (igs/utils/config.py:1-75): the
three-section ExperimentConfig (opt/data/system), the custom resolvers
(gt0, mul, shsdim, …), ``extends`` chaining and ``a.b.c=value``
overrides, so the reference's YAML configs load unmodified. PyYAML is
imported only where a YAML text is read or written: a caller that builds
the sections as dicts (``train_agm.run``) needs none.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_RESOLVERS = {
    "calc_exp_lr_decay_rate": lambda factor, n: float(factor) ** (1.0 / float(n)),
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "idiv": lambda a, b: a // b,
    "basename": os.path.basename,
    "rmspace": lambda s, sub: s.replace(" ", sub),
    "tuple2": lambda s: [float(s), float(s)],
    "gt0": lambda s: s > 0,
    "not": lambda s: not s,
    "shsdim": lambda sh_degree: (int(sh_degree) + 1) ** 2 * 3,
}

_INTERP = re.compile(r"\$\{([^${}]+)\}")
_SCI_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _yaml():
    import yaml

    return yaml


def _get_path(cfg: Dict, dotted: str):
    cur = cfg
    for part in dotted.split("."):
        cur = cur[int(part)] if isinstance(cur, list) else cur[part]
    return cur


def _parse_scalar(s: str) -> Any:
    v = _yaml().safe_load(s)
    # YAML 1.1 reads "5e-4" (no dot) as a string; numeric-looking scalars
    # become floats so reference configs like "lr: 4e-4" load as numbers
    if isinstance(v, str) and _SCI_FLOAT.match(v):
        return float(v)
    return v


def _resolve_value(val: Any, root: Dict, depth=0) -> Any:
    if depth > 20:
        raise ValueError("interpolation recursion limit")
    if not isinstance(val, str):
        return val
    if _SCI_FLOAT.match(val):
        return float(val)
    m = _INTERP.fullmatch(val.strip())
    if m:
        return _resolve_expr(m.group(1), root, depth)

    # interpolation inside a longer string; a nested form such as
    # ``${gt0:${opt.x}}`` reaches here too: after each substitution pass,
    # a remainder that is one interpolation resolves natively (a resolver
    # result must not turn into the string "False")
    def sub(match):
        return str(_resolve_expr(match.group(1), root, depth))

    out = _INTERP.sub(sub, val)
    while _INTERP.search(out):
        m = _INTERP.fullmatch(out.strip())
        if m:
            return _resolve_expr(m.group(1), root, depth)
        out = _INTERP.sub(sub, out)
    return out


def _resolve_expr(expr: str, root: Dict, depth: int) -> Any:
    if ":" in expr:
        name, argstr = expr.split(":", 1)
        if name in _RESOLVERS:
            args = [
                _resolve_value(a.strip(), root, depth + 1)
                if a.strip().startswith("${")
                else _parse_scalar(a.strip())
                for a in argstr.split(",")
            ]
            return _RESOLVERS[name](*args)
    return _resolve_value(_get_path(root, expr), root, depth + 1)


def _resolve_tree(node: Any, root: Dict) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_tree(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_tree(v, root) for v in node]
    return _resolve_value(node, root)


def merge(base: Any, override: Any) -> Any:
    if isinstance(base, dict) and isinstance(override, dict):
        out = dict(base)
        for k, v in override.items():
            out[k] = merge(out.get(k), v) if k in out else v
        return out
    return override


def apply_dotlist(cfg: Dict, dotlist: List[str]) -> Dict:
    """``a.b.c=value`` overrides, in place; items without ``=`` are
    skipped."""
    for item in dotlist:
        if "=" not in item:
            continue
        key, val = item.split("=", 1)
        parts = key.strip().split(".")
        cur = cfg
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _parse_scalar(val)
    return cfg


@dataclass
class ExperimentConfig:
    """The reference's three sections (igs/utils/config.py:34-38)."""

    n_gpus: int = 1
    opt: Dict[str, Any] = field(default_factory=dict)
    data: Dict[str, Any] = field(default_factory=dict)
    system: Dict[str, Any] = field(default_factory=dict)

    def __getitem__(self, k):
        return getattr(self, k)


def config_from_dict(cfg: Dict[str, Any]) -> ExperimentConfig:
    """Resolve the interpolations of a merged config dict and keep its
    known sections."""
    cfg = _resolve_tree(cfg, cfg)
    known = {k: v for k, v in cfg.items()
             if k in ("n_gpus", "opt", "data", "system")}
    return ExperimentConfig(**known)


def load_config(*yamls: str, cli_args: Optional[List[str]] = None,
                from_string: bool = False, **kwargs) -> ExperimentConfig:
    """YAML files (or texts with ``from_string``) merged in order, each
    after the file it ``extends``; then the dotlist and ``kwargs``."""
    yaml = _yaml()
    confs = []
    for y in yamls:
        if from_string:
            conf = yaml.safe_load(y)
        else:
            with open(y) as f:
                conf = yaml.safe_load(f)
        conf = conf or {}
        extends = conf.pop("extends", None)
        if extends:
            if not os.path.exists(extends):
                raise FileNotFoundError(f"File {extends} does not exist.")
            with open(extends) as f:
                confs.append(yaml.safe_load(f))
        confs.append(conf)
    cfg: Dict[str, Any] = {}
    for c in confs:
        cfg = merge(cfg, c)
    if cli_args:
        cfg = apply_dotlist(cfg, cli_args)
    return config_from_dict(merge(cfg, kwargs))


def dump_config(path: str, config: ExperimentConfig) -> None:
    with open(path, "w") as f:
        _yaml().safe_dump({"n_gpus": config.n_gpus, "opt": config.opt,
                           "data": config.data, "system": config.system}, f)
