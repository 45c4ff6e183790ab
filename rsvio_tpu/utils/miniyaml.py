"""Parser for the subset of YAML the shipped configs use.

Supported: the `%YAML` directive, one `---` document marker, block mappings
nested by indentation, `#` comments, plain and quoted scalars, and flow
lists of scalars that may span lines. Scalars resolve as PyYAML's
`safe_load` resolves them (YAML 1.1): `true`/`on`/`yes` are booleans, `~`
and `null` are None, and a float needs a dot, so `1e4` and `1.0e5` stay
strings (config._fill coerces them by the field's type). Anything else
(block sequences, flow mappings, anchors, tags, block scalars, tabs in
indentation, octal/hex/sexagesimal numbers, duplicate keys) raises
ValueError with the source and line.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_FLOAT = re.compile(r"""^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?
                         |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                         |[-+]?\.(?:inf|Inf|INF)
                         |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_OTHER_NUMBER = re.compile(
    r"^[-+]?(?:0[0-7_]+|0x|0b|[0-9][0-9_]*(?::[0-5]?[0-9])+)")
_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-]*$")
_BOOL = {w: v for v, words in ((True, ("yes", "true", "on")),
                               (False, ("no", "false", "off")))
         for word in words for w in (word, word.capitalize(), word.upper())}
_NULL = ("~", "null", "Null", "NULL")
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"


def _strip_comment(line: str) -> Tuple[str, int]:
    """Drop a `#` comment outside quotes; return (text, net bracket depth)."""
    quote, depth = None, 0
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip(), depth
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
    return line.rstrip(), depth


def _scalar(text: str, where: str) -> Any:
    if text == "" or text in _NULL:
        return None
    if text[0] in "'\"":
        q = text[0]
        if len(text) < 2 or text[-1] != q:
            raise ValueError(f"{where}: unterminated quoted scalar {text!r}")
        body = text[1:-1]
        if q == "'":
            return body.replace("''", "'")
        if "\\" in body:
            raise ValueError(f"{where}: escapes in double quotes are not "
                             "supported")
        return body
    if text[0] in _INDICATORS and not (text[0] == "-" and text[1:2] not in
                                       ("", " ")):
        raise ValueError(f"{where}: unsupported YAML syntax {text!r}")
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        return float(t.replace(".inf", "inf").replace(".nan", "nan"))
    if _OTHER_NUMBER.match(text):
        raise ValueError(f"{where}: unsupported number form {text!r}")
    if ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: a mapping is not allowed here: {text!r}")
    return text


def _flow_list(text: str, where: str) -> List[Any]:
    if not text.endswith("]"):
        raise ValueError(f"{where}: text after a flow list: {text!r}")
    body = text[1:-1]
    if any(c in body for c in "[]{}"):
        raise ValueError(f"{where}: nested flow collections are not "
                         "supported")
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == ",":
            items.append(cur.strip())
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur.strip())
    if any(item == "" for item in items):
        raise ValueError(f"{where}: empty item in a flow list")
    return [_scalar(item, where) for item in items]


def _logical_lines(text: str, source: str) -> List[Tuple[int, str, str]]:
    """(indent, content, where) per logical line; flow lists spanning
    several physical lines are joined."""
    out: List[Tuple[int, str, str]] = []
    marker = False
    depth = 0
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{n}"
        line, d = _strip_comment(raw)
        if depth > 0:
            indent, content, first = out[-1]
            out[-1] = (indent, content + " " + line.strip(), first)
            depth += d
            continue
        stripped = line.lstrip(" \t")
        if not stripped:
            continue
        if "\t" in line[:len(line) - len(stripped)]:
            raise ValueError(f"{where}: tab in indentation")
        if not out and not marker and stripped.startswith("%YAML"):
            continue
        if not out and not marker and stripped == "---":
            marker = True
            continue
        if stripped.startswith(("%", "---", "...")):
            raise ValueError(f"{where}: unsupported YAML directive or "
                             f"document marker {stripped!r}")
        out.append((len(line) - len(stripped), stripped, where))
        depth = d
        if depth < 0:
            raise ValueError(f"{where}: unbalanced ']'")
    if depth > 0:
        raise ValueError(f"{out[-1][2]}: unterminated flow list")
    return out


def _mapping(lines, i: int, indent: int) -> Tuple[dict, int]:
    result: dict = {}
    while i < len(lines):
        ind, content, where = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"{where}: unexpected indentation")
        m = re.match(r"^([^:'\"]*?)\s*:(?:\s+(.*))?$", content)
        if m is None:
            raise ValueError(
                f"{where}: expected 'key: value', got {content!r}")
        key, value = m.group(1), (m.group(2) or "").strip()
        if not _KEY.match(key) or key in _BOOL or key in _NULL:
            raise ValueError(f"{where}: unsupported mapping key {key!r}")
        if key in result:
            raise ValueError(f"{where}: duplicate key {key!r}")
        i += 1
        if value:
            result[key] = (_flow_list(value, where) if value.startswith("[")
                           else _scalar(value, where))
        elif i < len(lines) and lines[i][0] > indent:
            result[key], i = _mapping(lines, i, lines[i][0])
        else:
            result[key] = None
    return result, i


def loads(text: str, source: str = "<string>") -> dict:
    """Parse config text; an empty document gives {}."""
    lines = _logical_lines(text, source)
    if not lines:
        return {}
    data, i = _mapping(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"{lines[i][2]}: indentation does not match any "
                         "enclosing mapping")
    return data
