"""YAML config loading with ``${var}`` interpolation.

The port's own copy of ``fdbm_tpu/config.py``. The port depends on no YAML
package, so it reads the subset of YAML that the repo's configs use: block
mappings nested by indentation, ``#`` comments, plain and quoted scalars and
flow lists and flow mappings of scalars, with scalars typed as PyYAML's ``safe_load`` (YAML
1.1) types them. Anything else raises ``ValueError``. Top-level keys may
reference one another with ``${key}``, resolved like OmegaConf
interpolation.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_INTERP = re.compile(r"\$\{([^}]+)\}")

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _scalar(text: str) -> Any:
    """A YAML scalar, typed as PyYAML's safe_load types it."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        return body.replace("''", "'") if s[0] == "'" else bytes(
            body, "utf-8").decode("unicode_escape")
    if s.startswith("[") and s.endswith("]"):
        return [_scalar(p) for p in _flow_items(s)]
    if s.startswith("{") and s.endswith("}"):
        return dict(_flow_pair(p) for p in _flow_items(s))
    if s.startswith(("{", "&", "*", "!", "|", ">")):
        raise ValueError(f"unsupported YAML value: {text!r}")
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s in _TRUE
    if _INT.match(s):
        t = s.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    return s


def _flow_items(s: str) -> List[str]:
    """The comma-separated items of a flow list or mapping of scalars."""
    inner = s[1:-1].strip()
    if any(ch in inner for ch in "[]{}"):
        raise ValueError(f"unsupported YAML value (nested flow collection): {s!r}")
    return [p for p in inner.split(",") if p.strip()] if inner else []


def _flow_pair(item: str) -> Tuple[Any, Any]:
    """``key: value`` of a flow mapping; a bare key maps to None."""
    item = item.strip()
    if item.endswith(":"):
        return _scalar(item[:-1]), None
    key, sep, value = item.partition(": ")
    return (_scalar(key), _scalar(value)) if sep else (_scalar(item), None)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> Dict[str, Any]:
    """Parse the block-mapping subset of YAML described in the module note."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"tabs in YAML indentation: {raw!r}")
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))

    def block(i: int, indent: int) -> Tuple[Dict[str, Any], int]:
        out: Dict[str, Any] = {}
        while i < len(lines):
            ind, body = lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"unexpected indentation at {body!r}")
            key, sep, rest = body.partition(":")
            if not sep or (rest and not rest.startswith(" ")):
                raise ValueError(f"unsupported YAML line: {body!r}")
            key = key.strip()
            i += 1
            if rest.strip():
                out[key] = _scalar(rest)
            elif i < len(lines) and lines[i][0] > indent:
                out[key], i = block(i, lines[i][0])
            else:
                out[key] = None
        return out, i

    cfg, _ = block(0, lines[0][0] if lines else 0)
    return cfg


def _resolve(value: Any, root: Dict[str, Any], depth: int = 0) -> Any:
    if depth > 16:
        raise ValueError("Config interpolation too deep (cycle?)")
    if isinstance(value, str):
        def sub(m):
            key = m.group(1)
            cur: Any = root
            for part in key.split("."):
                if not isinstance(cur, dict) or part not in cur:
                    raise KeyError(f"Interpolation key '{key}' not found")
                cur = cur[part]
            return str(_resolve(cur, root, depth + 1))

        return _INTERP.sub(sub, value)
    if isinstance(value, dict):
        return {k: _resolve(v, root, depth + 1) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve(v, root, depth + 1) for v in value]
    return value


def load_config(path: str, overrides: Dict[str, Any] | None = None) -> Dict[str, Any]:
    """Load YAML, apply overrides, resolve ${...} interpolation."""
    with open(path) as f:
        cfg = parse_yaml(f.read())
    if overrides:
        cfg.update({k: v for k, v in overrides.items() if v is not None})
    return _resolve(cfg, cfg)


def parse_cli_overrides(args) -> Dict[str, Any]:
    """key=value CLI overrides with YAML-typed values."""
    out: Dict[str, Any] = {}
    for a in args:
        if "=" not in a:
            raise ValueError(f"Override '{a}' must be key=value")
        k, v = a.split("=", 1)
        parsed = _scalar(v)
        if isinstance(parsed, str):
            # YAML 1.1 needs '5.0e-4' for floats; accept bare '5e-4' too.
            try:
                parsed = int(parsed)
            except ValueError:
                try:
                    parsed = float(parsed)
                except ValueError:
                    pass
        out[k] = parsed
    return out
