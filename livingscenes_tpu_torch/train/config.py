"""Hierarchical YAML configs: `inherit_from` chains, dotted overrides, the
run directory.

Counterpart of livingscenes_tpu/train/config.py. The port carries its own
reader for the subset of YAML that configs/*.yaml use (PyYAML is not a
dependency): block mappings nested by indentation, `#` comments, plain,
single- and double-quoted scalars, flow lists `[a, b, "c"]` of scalars, and
empty values (null). Plain scalars resolve as PyYAML's safe loader resolves
them (YAML 1.1): null, the boolean words, decimal integers, floats with a
dot or `.inf` / `.nan`; anything else is a string. What the subset lacks
(block sequences, flow mappings, anchors, multi-line scalars, tabs, octal
or sexagesimal numbers, ...) raises ValueError rather than reading
differently.
"""
from __future__ import annotations

import copy
import math
import os
import re
import shutil
from typing import Any, Dict, List, Optional

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# other YAML 1.1 int and float forms: refused, not read as strings
_OTHER_NUMBER = re.compile(r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
                           r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")


def _plain(text: str):
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    m = _INF.match(text)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    if _OTHER_NUMBER.match(text):
        raise ValueError(f"number form outside the supported subset: {text!r}")
    if text[0] in "[]{}&*!|>%@`,?'\"" or text.startswith("- ") or ": " in text:
        raise ValueError(f"unsupported YAML scalar: {text!r}")
    return text


def _quoted(text: str) -> str:
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise ValueError(f"unterminated quoted scalar: {text!r}")
    body = text[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise ValueError(f"bad single-quoted scalar: {text!r}")
        return body.replace("''", "'")
    out, i = [], 0
    escapes = {'"': '"', "\\": "\\", "n": "\n", "t": "\t", "/": "/"}
    while i < len(body):
        ch = body[i]
        if ch == '"':
            raise ValueError(f"bad double-quoted scalar: {text!r}")
        if ch == "\\":
            if i + 1 >= len(body) or body[i + 1] not in escapes:
                raise ValueError(f"unsupported escape in {text!r}")
            out.append(escapes[body[i + 1]])
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _split_flow(body: str) -> List[str]:
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch in "[]{}":
            raise ValueError(f"nested flow collections are not supported: [{body}]")
        elif ch == ",":
            items.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if quote:
        raise ValueError(f"unterminated quote in [{body}]")
    items.append(cur.strip())
    if items == [""]:
        return []
    if "" in items:
        raise ValueError(f"empty entry in flow list [{body}]")
    return items


def parse_scalar(text: str):
    """One value of the subset: a flow list, a quoted or a plain scalar."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated flow list: {text!r}")
        return [parse_scalar(item) for item in _split_flow(text[1:-1])]
    if text[:1] in ("'", '"'):
        return _quoted(text)
    return _plain(text)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def parse_yaml(text: str):
    """The document of `text` (the subset above): a dict, or None when the
    document is empty."""
    rows = []
    for number, raw in enumerate(text.splitlines(), 1):
        if raw.strip() in ("---", "..."):
            raise ValueError(f"line {number}: document markers are not supported")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith("\t") or "\t" in line[:len(line) - len(body)]:
            raise ValueError(f"line {number}: tabs in indentation")
        if body.startswith("- ") or body == "-":
            raise ValueError(f"line {number}: block sequences are not supported")
        key, sep, value = body.partition(":")
        if not sep or (value and not value.startswith(" ")):
            raise ValueError(f"line {number}: expected 'key: value': {raw!r}")
        key = key.strip()
        if not key or key[0] in "'\"[{&*!?" or " #" in key:
            raise ValueError(f"line {number}: unsupported key {key!r}")
        rows.append((len(line) - len(body), key, value.strip(), number))
    if not rows:
        return None
    out, pos = _mapping(rows, 0, rows[0][0])
    if pos != len(rows):
        raise ValueError(f"line {rows[pos][3]}: bad indentation")
    return out


def _mapping(rows, pos: int, indent: int):
    out: Dict[str, Any] = {}
    while pos < len(rows) and rows[pos][0] == indent:
        _, key, value, number = rows[pos]
        if key in out:
            raise ValueError(f"line {number}: duplicate key {key!r}")
        pos += 1
        if value:
            out[key] = parse_scalar(value)
        elif pos < len(rows) and rows[pos][0] > indent:
            out[key], pos = _mapping(rows, pos, rows[pos][0])
        else:
            out[key] = None
    if pos < len(rows) and rows[pos][0] > indent:
        raise ValueError(f"line {rows[pos][3]}: bad indentation")
    return out, pos


def _scalar_text(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "e" in text and "." not in text.split("e")[0]:
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        return text
    if isinstance(v, str):
        try:
            plain = _plain(v) if v else None
        except ValueError:
            plain = None
        if v and plain == v and v == v.strip():
            return v
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar_text(x) for x in v) + "]"
    raise TypeError(f"cannot write {type(v).__name__} to the config subset")


def dump_yaml(cfg: Dict, indent: int = 0) -> str:
    """`cfg` as text that parse_yaml reads back equal."""
    lines = []
    for k, v in cfg.items():
        pad = " " * indent
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{k}:")
            lines.append(dump_yaml(v, indent + 2))
        else:
            lines.append(f"{pad}{k}: {_scalar_text(v) if v != {} else 'null'}")
    return "\n".join(line for line in lines if line)


def update_recursive(dst: Dict, src: Dict) -> Dict:
    """Deep-merge src into dst."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            update_recursive(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def load_config(path: str) -> Dict:
    """Load a config file, resolving its `inherit_from` chain (relative to
    the file's directory)."""
    with open(path) as f:
        cfg = parse_yaml(f.read()) or {}
    inherit = cfg.pop("inherit_from", None)
    if inherit:
        if not os.path.isabs(inherit):
            inherit = os.path.join(os.path.dirname(path), inherit)
        return update_recursive(load_config(inherit), cfg)
    return cfg


def apply_overrides(cfg: Dict, overrides: List[str]) -> Dict:
    """Apply 'a.b.c=value' overrides; each value is read as a YAML scalar
    or flow list."""
    for ov in overrides:
        key, sep, raw = ov.partition("=")
        if not sep or not key:
            raise ValueError(f"override {ov!r} is not 'a.b.c=value'")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_scalar(raw)
    return cfg


def cfg_with_default(cfg: Dict, key_list: List[str], default: Any) -> Any:
    """Nested get with a default."""
    node = cfg
    for k in key_list:
        if isinstance(node, dict) and k in node:
            node = node[k]
        else:
            return default
    return node


def prepare_log_dir(cfg: Dict, config_path: Optional[str] = None) -> str:
    """Create the run directory (an existing non-empty one is moved to
    <dir>_bck<i>) and back up the resolved config and the config file."""
    log_dir = cfg_with_default(cfg, ["logging", "log_dir"], "log/run")
    if os.path.exists(log_dir) and os.listdir(log_dir):
        i = 1
        while os.path.exists(f"{log_dir}_bck{i}"):
            i += 1
        shutil.move(log_dir, f"{log_dir}_bck{i}")
    backup = os.path.join(log_dir, "files_backup")
    os.makedirs(backup, exist_ok=True)
    with open(os.path.join(backup, "resolved_config.yaml"), "w") as f:
        f.write(dump_yaml(cfg) + "\n")
    if config_path and os.path.exists(config_path):
        shutil.copy(config_path, backup)
    return log_dir
