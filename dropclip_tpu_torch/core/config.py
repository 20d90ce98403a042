"""Config system: YAML with flattened top-level sections + CLI overrides.

Port of ``dropclip_tpu/core/config.py``. The card's machine has no PyYAML,
so ``_parse_yaml`` reads the YAML subset the repo's ``configs/*.yaml``
use, resolving scalars as PyYAML's ``safe_load`` does (YAML 1.1):

- block mappings nested by indentation, ``key: value`` lines;
- block sequences (``- item``) and one-line flow sequences (``[4, 4, 2]``);
- plain, single- and double-quoted scalars; ``#`` comments;
- null (empty, ``~``, ``null``), YAML 1.1 booleans (``True``, ``yes``,
  ``off`` ...), decimal/hex/octal/binary ints, floats (``1e-05`` needs the
  exponent sign, as in PyYAML; ``.inf``, ``.nan``).

Anchors, tags, multi-line scalars and flow mappings are not supported
and raise ``ValueError``.
"""

from __future__ import annotations

import copy
import math
import re
from ast import literal_eval
from typing import Any, Dict, List, Optional, Tuple

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                        |[-+]?0[0-7_]+
                        |[-+]?(?:0|[1-9][0-9_]*)
                        |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                          |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                          |[-+]?\.(?:inf|Inf|INF)
                          |\.(?:nan|NaN|NAN))$""", re.X)


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    t = t.lstrip("+-")
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if len(t) > 1 and t[0] == "0":
        return sign * int(t, 8)
    return sign * int(t)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    if t.endswith(".inf"):
        return -math.inf if t[0] == "-" else math.inf
    if t == ".nan":
        return math.nan
    return float(t)


def _scalar(text: str) -> Any:
    """Resolve one scalar token (comment already stripped)."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        return literal_eval(text)  # double quotes: python-compatible escapes
    if text[:1] in ("&", "*", "!", "|", ">", "{"):
        raise ValueError(f"unsupported YAML construct: {text!r}")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_RE.match(text):
        return _int(text)
    if _FLOAT_RE.match(text):
        return _float(text)
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts a line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " :[,-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _value(text: str) -> Any:
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"multi-line flow sequence: {text!r}")
        inner = text[1:-1].strip()
        return [_scalar(t) for t in inner.split(",")] if inner else []
    return _scalar(text)


def _split_key(text: str) -> Tuple[str, str]:
    m = re.match(r"^([^:#'\"]+?|'[^']*'|\"[^\"]*\"):(?:\s+(.*)|$)", text)
    if not m:
        raise ValueError(f"not a mapping line: {text!r}")
    key = m.group(1).strip()
    if key[:1] in "'\"":
        key = key[1:-1]
    return key, (m.group(2) or "")


def _parse_block(lines: List[Tuple[int, str]], start: int, indent: int
                 ) -> Tuple[Any, int]:
    """Parse the block whose lines sit at exactly ``indent``; returns
    (value, index of the first line after it)."""
    if lines[start][1].startswith("- ") or lines[start][1] == "-":
        out_list: List[Any] = []
        i = start
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            item = lines[i][1][1:].strip()
            i += 1
            if item:
                out_list.append(_value(item))
            elif i < len(lines) and lines[i][0] > indent:
                val, i = _parse_block(lines, i, lines[i][0])
                out_list.append(val)
            else:
                out_list.append(None)
        return out_list, i
    out: Dict[str, Any] = {}
    i = start
    while i < len(lines) and lines[i][0] == indent:
        key, rest = _split_key(lines[i][1])
        i += 1
        if rest.strip():
            out[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("- "))):
            out[key], i = _parse_block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def _parse_yaml(text: str) -> Any:
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        body = _strip_comment(raw)
        if body.strip() in ("", "---"):
            continue
        lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    value, end = _parse_block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"bad indentation near {lines[end][1]!r}")
    return value


class CfgNode(dict):
    """A dict subclass exposing keys as attributes; missing keys read None."""

    def __init__(self, init_dict: Optional[Dict[str, Any]] = None):
        super().__init__({} if init_dict is None else init_dict)
        for k, v in self.items():
            if isinstance(v, dict):
                self[k] = CfgNode(v)

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        if name.startswith("__"):
            raise AttributeError(name)
        return None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "CfgNode":
        return CfgNode(copy.deepcopy(dict(self)))


def load_yaml(path: str) -> Any:
    """The file's YAML document as python objects (``yaml.safe_load``
    semantics on the supported subset)."""
    with open(path, "r") as f:
        return _parse_yaml(f.read())


def load_cfg(cfg_path: str) -> CfgNode:
    """Load a YAML config and flatten top-level sections into one namespace."""
    doc = load_yaml(cfg_path)
    cfg: Dict[str, Any] = {}
    for section, body in (doc or {}).items():
        if isinstance(body, dict):
            cfg.update(body)
        else:
            cfg[section] = body
    return CfgNode(cfg)


load_cfg_from_cfg_file = load_cfg


def _decode_value(value: Any) -> Any:
    if not isinstance(value, str):
        return value
    try:
        return literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(replacement: Any, original: Any, key: str) -> Any:
    """Coerce ``replacement`` to the type of ``original`` where sensible."""
    if original is None or isinstance(replacement, type(original)):
        return replacement
    casts = [(tuple, list), (list, tuple), (int, float), (float, int),
             (str, type(None))]
    for from_type, to_type in casts:
        if isinstance(replacement, from_type) and isinstance(original, to_type):
            return to_type(replacement) if to_type is not type(None) \
                else replacement
    if isinstance(original, bool) and isinstance(replacement, (int, str)):
        if isinstance(replacement, str) and replacement.lower() in (
                "true", "false"):
            return replacement.lower() == "true"
        return bool(replacement)
    if isinstance(original, str):
        return str(replacement)
    raise ValueError(
        f"Type mismatch ({type(original)} vs {type(replacement)}) for key "
        f"{key}: {original} vs {replacement}")


def merge_cfg_from_list(cfg: CfgNode, cfg_list: List[str]) -> CfgNode:
    """Merge ``key value ...`` pairs into a copy of ``cfg``."""
    if len(cfg_list) % 2:
        raise ValueError(f"overrides must come in pairs, got {cfg_list}")
    new_cfg = cfg.clone()
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        subkey = full_key.split(".")[-1]
        value = _decode_value(v)
        if subkey in cfg:
            value = _coerce(value, cfg[subkey], subkey)
        new_cfg[subkey] = value
    return new_cfg
