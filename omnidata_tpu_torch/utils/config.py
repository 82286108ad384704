"""A reader for the subset of YAML that the trainers' configs use, giving
what ``yaml.safe_load`` gives for it, so that the trainers need no PyYAML;
and ``dumps``, a writer of that subset (what ``loads`` reads back equals
the dict written).

The subset: block mappings nested by indentation (spaces only), comments
(a whole line, or after a space), and scalars resolved as YAML 1.1 resolves
them in PyYAML: ``null``/``~``/empty, ``true``/``false``, decimal integers,
floats with a dot (``1.0e-5``; note that ``1e-5`` has no dot and is a
string there too), plain strings and single- or double-quoted strings.
Anything else (sequences, flow collections, anchors, tags, block scalars,
octal/hex/base-60 numbers, ``yes``/``no``/``on``/``off``, ``.inf``,
``.nan``, tabs, several documents) raises ``ValueError`` naming the line.
"""
from __future__ import annotations

import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE"}
_FALSE = {"false", "False", "FALSE"}
_UNSUPPORTED_WORDS = {"yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON",
                      "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
# what PyYAML would read as another type or a structure: refused
_OTHER_NUMBER = re.compile(r"[-+]?0[0-7_]+$|[-+]?0x|[-+]?0b|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+"
                           r"|[-+]?\.(?:inf|Inf|INF)$|\.(?:nan|NaN|NAN)$")
_INDICATORS = set("-?:,[]{}#&*!|>%@`")
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r",
            "0": "\0", " ": " "}


class _Line:
    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _strip_comment(s: str) -> str:
    """Drop a trailing comment outside quotes."""
    quote, i = None, 0
    while i < len(s):
        c = s[i]
        if quote == "'" and s.startswith("''", i):
            i += 1  # an escaped single quote
        elif quote == '"' and c == "\\":
            i += 1  # an escaped character
        elif quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or s[i - 1] in " :"):
            quote = c
        elif c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
        i += 1
    return s.rstrip()


def _quoted(s: str, no: int) -> str:
    q = s[0]
    if len(s) < 2 or s[-1] != q:
        raise ValueError(f"line {no}: unterminated quoted string {s!r}")
    body = s[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise ValueError(f"line {no}: stray quote in {s!r}")
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c == '"':
            raise ValueError(f"line {no}: stray quote in {s!r}")
        if c == "\\":
            if i + 1 >= len(body) or body[i + 1] not in _ESCAPES:
                raise ValueError(f"line {no}: unsupported escape in {s!r}")
            out.append(_ESCAPES[body[i + 1]])
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def scalar(s: str, no: int = 0):
    """One scalar as PyYAML's safe loader resolves it (within the subset)."""
    if s[:1] in ("'", '"'):
        return _quoted(s, no)
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if s in _UNSUPPORTED_WORDS or _OTHER_NUMBER.match(s):
        raise ValueError(f"line {no}: {s!r} is outside the supported YAML subset "
                         "(quote it to make it a string)")
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if s[0] in _INDICATORS or ": " in s or s.endswith(":") or " #" in s:
        raise ValueError(f"line {no}: {s!r} is outside the supported YAML subset")
    return s


def _split_key(line: _Line):
    text = line.text
    if text.startswith(("'", '"')):
        end = text.find(text[0], 1)
        while text[0] == "'" and end != -1 and text[end + 1:end + 2] == "'":
            end = text.find("'", end + 2)
        if end == -1 or text[end + 1:end + 2] != ":":
            raise ValueError(f"line {line.no}: expected 'key: value', got {text!r}")
        key, rest = _quoted(text[:end + 1], line.no), text[end + 2:]
    else:
        m = re.match(r"([^:]*?):(?: |$)", text)
        if m is None:
            raise ValueError(f"line {line.no}: expected 'key: value', got {text!r}")
        key, rest = scalar(m.group(1), line.no), text[m.end():]
        if not isinstance(key, str):
            raise ValueError(f"line {line.no}: key {m.group(1)!r} is not a string")
    return key, rest.strip()


def _mapping(lines: list, pos: int, indent: int):
    out = {}
    while pos < len(lines) and lines[pos].indent >= indent:
        line = lines[pos]
        if line.indent != indent:
            raise ValueError(f"line {line.no}: unexpected indentation")
        key, rest = _split_key(line)
        pos += 1
        if rest:
            out[key] = scalar(rest, line.no)
        elif pos < len(lines) and lines[pos].indent > indent:
            out[key], pos = _mapping(lines, pos, lines[pos].indent)
        else:
            out[key] = None
    return out, pos


def loads(text: str):
    """The YAML text -> a dict (None for an empty document)."""
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.rstrip("\r")
        if "\t" in body[:len(body) - len(body.lstrip(" \t"))]:
            raise ValueError(f"line {no}: tab in indentation")
        stripped = _strip_comment(body.lstrip(" "))
        if not stripped:
            continue
        if stripped.startswith(("---", "...", "- ", "%")) or stripped == "-":
            raise ValueError(f"line {no}: {stripped!r} is outside the supported "
                             "YAML subset (block mappings of scalars)")
        lines.append(_Line(no, len(body) - len(body.lstrip(" ")), stripped))
    if not lines:
        return None
    out, pos = _mapping(lines, 0, lines[0].indent)
    if pos != len(lines):
        raise ValueError(f"line {lines[pos].no}: unexpected indentation")
    return out


def load_file(path: str):
    with open(path) as fh:
        return loads(fh.read())


_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.-]*$")


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            raise ValueError(f"{v!r} is outside the supported YAML subset")
        text = repr(v).lower()
        if "." not in text and "e" in text:  # 1e-05 would read back as a string
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise ValueError(f"{type(v).__name__} {v!r} is outside the supported YAML subset")


def _plain(s: str) -> bool:
    """s written unquoted reads back as s."""
    try:
        return scalar(s) == s
    except ValueError:
        return False


def dumps(cfg: dict, indent: int = 0) -> str:
    """A dict of scalars and non-empty nested dicts (string keys) -> YAML
    text in the subset ``loads`` reads, keys in the dict's order; anything
    else (lists, empty dicts, inf, nan) raises ValueError."""
    lines = []
    for k, v in cfg.items():
        if not isinstance(k, str):
            raise ValueError(f"key {k!r} is not a string")
        key = k if _PLAIN_KEY.match(k) and _plain(k) else _dump_scalar(k)
        if isinstance(v, dict):
            if not v:
                raise ValueError(f"{k}: an empty mapping is outside the supported "
                                 "YAML subset")
            lines.append(" " * indent + f"{key}:")
            lines.append(dumps(v, indent + 2).rstrip("\n"))
        else:
            lines.append(" " * indent + f"{key}: {_dump_scalar(v)}")
    return "\n".join(lines) + "\n"
