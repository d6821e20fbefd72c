"""YAML config files for the example scripts (JAX counterpart: examples/_config.py).

The keys of a config file override the argparse defaults; explicit CLI
flags still win over the file; keys may use `-` or `_`; a key that names
no option exits. The committed configs (examples/configs/*.yaml) are flat,
so this module reads them itself and needs no YAML package: one
`key: value` a line, `#` comments, values that are scalars (integers,
floats, true/false, null, plain or quoted strings) or flow lists of them
(`[0.4, -0.6]`). Anything else (nesting, block lists, multi-line values)
raises.

    from examples_torch import _config
    p = argparse.ArgumentParser()
    p.add_argument("--n-poses", type=int, default=64)
    args = _config.parse_with_config(p, argv)

    python examples_torch/pose_graph_synthetic.py --config examples/configs/pose_graph/pose_graph_synthetic.yaml
"""

from __future__ import annotations

import argparse
import re

_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_-]*)\s*:(?:\s+(.*))?$")
_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")
_SPECIAL = {".inf": float("inf"), "+.inf": float("inf"), "-.inf": float("-inf"), ".nan": float("nan")}
_BOOL = {"true": True, "True": True, "TRUE": True, "false": False, "False": False, "FALSE": False,
         "yes": True, "Yes": True, "no": False, "No": False, "on": True, "On": True, "off": False, "Off": False}


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (a `#` inside quotes stays)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _scalar(text: str, where: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if not text or text[0] in "[]{}&*!|>%@`" or text.startswith("- ") or ": " in text:
        raise ValueError(f"{where}: unsupported YAML value {text!r}")
    if text in ("null", "Null", "NULL", "~"):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if text.lower() in _SPECIAL:
        return _SPECIAL[text.lower()]
    return text


def _value(text: str, where: str):
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]") or "[" in text[1:] or "{" in text:
            raise ValueError(f"{where}: unsupported YAML list {text!r}")
        inner = text[1:-1].strip()
        return [] if not inner else [_scalar(x, where) for x in inner.split(",")]
    return _scalar(text, where)


def load_flat_yaml(path) -> dict:
    """{key: value} of a flat YAML file (see the module docstring)."""
    out = {}
    with open(path) as f:
        for n, raw in enumerate(f, 1):
            line = _strip_comment(raw.rstrip("\n")).rstrip()
            if not line.strip() or line.strip() in ("---", "..."):
                continue
            where = f"{path}:{n}"
            m = _KEY.match(line)
            if m is None or not (m.group(2) or "").strip():
                raise ValueError(f"{where}: not a flat `key: value` line: {raw.rstrip()!r}")
            if m.group(1) in out:
                raise ValueError(f"{where}: key {m.group(1)!r} repeated")
            out[m.group(1)] = _value(m.group(2), where)
    return out


def parse_with_config(parser: argparse.ArgumentParser, argv=None):
    """parser.parse_args(argv) with a --config file whose keys (dashes or
    underscores) override the defaults; explicit flags still win. An
    unknown key exits."""
    parser.add_argument("--config", default=None,
                        help="YAML file whose keys (dashes or underscores) override the defaults; "
                             "explicit CLI flags still win")
    pre, _ = parser.parse_known_args(argv)
    if pre.config:
        cfg = load_flat_yaml(pre.config)
        known = {a.dest for a in parser._actions}
        overrides = {}
        for k, v in cfg.items():
            dest = k.replace("-", "_")
            if dest not in known:
                raise SystemExit(f"config key {k!r} does not match any option (known: {sorted(known)})")
            overrides[dest] = v
        parser.set_defaults(**overrides)
    return parser.parse_args(argv)
