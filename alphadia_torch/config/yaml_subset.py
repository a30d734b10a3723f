"""The config's YAML subset (no yaml package on the card machine): an
emitter, and a reader for the YAML that users hand to ``--config``.

The emitter writes nested mappings and lists of str / int / float / bool /
None in block style, keys in their order. A string is written plain where
YAML 1.1 reads it back as that string, else double-quoted with JSON escapes
(which YAML's double-quoted style shares); floats always carry a dot or an
exponent YAML resolves as a float.

The reader takes block mappings and block lists (a list item may hold a
mapping or a list), flow lists of scalars (``[a, 'b', 1]``), empty flow
collections (``[]``, ``{}``), plain, single- and double-quoted scalars and
comments, and resolves plain scalars as PyYAML's ``safe_load`` does (YAML
1.1: ``yes`` / ``on`` / ``true`` ... booleans, ``~`` / ``null``, octal,
hex, binary and ``_``-separated ints, floats only with a dot, ``.inf``,
``.nan``). Anything else (anchors, aliases, tags, block scalars, flow
mappings, nested flow lists, multi-line scalars, timestamps, sexagesimal
numbers, documents markers, tabs in indentation) raises ``ConfigError``
naming the line: the reader does not guess.
"""

from __future__ import annotations

import json
import math
import re

from alphadia_torch.exceptions import ConfigError

_PLAIN = re.compile(r"[A-Za-z_][A-Za-z0-9_./@;\-]*")
# what a YAML stream may not hold raw (outside its printable set) or reads
# as a line break inside a quoted scalar: written as \u escapes
_NON_PRINTABLE = re.compile("[^\t\n\r\x20-\x7e\xa0-\u2027\u202a-\ud7ff\ue000-\ufffd\U00010000-\U0010ffff]")
# words YAML 1.1 resolves to booleans or null
_RESERVED = {"y", "yes", "n", "no", "true", "false", "on", "off", "null", "~"}


def _scalar(v) -> str:
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
        mantissa, _, exponent = text.partition("e")
        if exponent and "." not in mantissa:
            text = f"{mantissa}.0e{exponent}"
        return text
    if isinstance(v, str):
        if _PLAIN.fullmatch(v) and v.lower() not in _RESERVED:
            return v
        return _NON_PRINTABLE.sub(lambda m: f"\\u{ord(m.group()):04x}", json.dumps(v, ensure_ascii=False))
    raise TypeError(f"no YAML scalar for {type(v).__name__}")


def _lines(node, indent: int) -> list[str]:
    pad = " " * indent
    out = []
    items = node.items() if isinstance(node, dict) else ((None, v) for v in node)
    for key, value in items:
        lead = f"{pad}{_scalar(str(key))}:" if isinstance(node, dict) else f"{pad}-"
        if isinstance(value, (dict, list)) and value:
            inner = _lines(value, indent + 2)
            if isinstance(node, dict):
                out.append(lead)
                out += inner
            else:
                out.append(f"{lead} {inner[0][indent + 2:]}")
                out += inner[1:]
        elif isinstance(value, (dict, list)):
            out.append(f"{lead} {'{}' if isinstance(value, dict) else '[]'}")
        else:
            out.append(f"{lead} {_scalar(value)}")
    return out


def dump(data: dict) -> str:
    """The mapping as a YAML document."""
    return "\n".join(_lines(data, 0)) + "\n" if data else "{}\n"


# PyYAML's implicit resolvers (YAML 1.1)
_BOOL = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF")
_NULL = re.compile(r"~|null|Null|NULL|")
_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
)
# what safe_load resolves to types outside the subset
_OUTSIDE = re.compile(
    r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?|<<|=|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt ].*)?"
)
_JSON_ESCAPES = set('"\\/bfnrtu')


def _fail(lineno: int, what: str):
    raise ConfigError(f"YAML line {lineno}: {what} is outside the subset this reader takes")


def _resolve_plain(text: str, lineno: int):
    if _OUTSIDE.fullmatch(text):
        _fail(lineno, f"the plain scalar {text!r} (a timestamp, sexagesimal number or merge key)")
    if _BOOL.fullmatch(text):
        return text.lower() in ("yes", "true", "on")
    if _NULL.fullmatch(text):
        return None
    if _INT.fullmatch(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.fullmatch(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * float(v)
    return text


def _quoted(text: str, lineno: int) -> str:
    """A single- or double-quoted scalar spanning ``text`` exactly."""
    if text[0] == "'":
        body = text[1:-1]
        if len(text) < 2 or text[-1] != "'" or "'" in body.replace("''", ""):
            _fail(lineno, f"the quoted scalar {text}")
        return body.replace("''", "'")
    body = text[1:-1]
    i = 0
    while i < len(body):
        if body[i] == "\\":
            if i + 1 >= len(body) or body[i + 1] not in _JSON_ESCAPES:
                _fail(lineno, f"the escape in {text} (only JSON's escapes are read)")
            i += 2
            continue
        if body[i] == '"':
            _fail(lineno, f"the quoted scalar {text}")
        i += 1
    if len(text) < 2 or text[-1] != '"':
        _fail(lineno, f"the quoted scalar {text}")
    try:
        return json.loads(text)
    except ValueError:
        _fail(lineno, f"the quoted scalar {text}")


def _scan_quoted(text: str, start: int, lineno: int) -> int:
    """The index just past the quoted scalar that opens at ``start``."""
    q = text[start]
    i = start + 1
    while i < len(text):
        c = text[i]
        if q == '"' and c == "\\":
            i += 2
            continue
        if c == q:
            if q == "'" and i + 1 < len(text) and text[i + 1] == "'":
                i += 2
                continue
            return i + 1
        i += 1
    _fail(lineno, "a quoted scalar that does not close on its line (multi-line scalars)")


def _strip_comment(text: str, lineno: int) -> str:
    i = 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " [,:-"):
            i = _scan_quoted(text, i, lineno)
            continue
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _scalar_value(text: str, lineno: int, flow: bool = False):
    if not text:
        return None
    if text[0] in "'\"":
        return _quoted(text, lineno)
    if text[0] in "&*!|>%@`{}[]" or text.startswith(("- ", "? ", ": ")) or text in ("-", "?", ":"):
        _fail(lineno, f"the value {text!r}")
    if ": " in text or text.endswith(":") or (flow and any(c in text for c in ",[]{}")):
        _fail(lineno, f"the value {text!r}")
    return _resolve_plain(text, lineno)


def _flow_list(text: str, lineno: int) -> list:
    body = text[1:-1].strip()
    if not text.endswith("]"):
        _fail(lineno, f"the flow collection {text!r}")
    items, i, start = [], 0, 0
    parts = []
    while i <= len(body):
        if i == len(body) or body[i] == ",":
            parts.append(body[start:i].strip())
            start = i + 1
            i += 1
            continue
        if body[i] in "'\"" and body[start:i].strip() == "":
            i = _scan_quoted(body, i, lineno)
            continue
        i += 1
    if parts and parts[-1] == "" and len(parts) > 1:
        parts.pop()  # a trailing comma
    for p in parts:
        if p == "" and parts != [""]:
            _fail(lineno, f"the flow list {text!r}")
        if p:
            items.append(_scalar_value(p, lineno, flow=True))
    return items


def _value(text: str, lineno: int):
    if text == "[]":
        return []
    if text == "{}":
        return {}
    if text.startswith("["):
        return _flow_list(text, lineno)
    return _scalar_value(text, lineno)


def _split_key(text: str, lineno: int):
    """(key, rest) of a mapping entry ``key: rest`` / ``key:``, or None."""
    if text[0] in "'\"":
        end = _scan_quoted(text, 0, lineno)
        if text[end:end + 1] == ":" and (end + 1 == len(text) or text[end + 1] == " "):
            return _quoted(text[:end], lineno), text[end + 1:].strip()
        return None
    m = re.search(r":( |$)", text)
    if m is None:
        return None
    key = text[: m.start()].strip()
    if not key or key[0] in "&*!|>%@`{}[]?":
        _fail(lineno, f"the key {key!r}")
    return _resolve_plain(key, lineno), text[m.end():].strip()


def _content_lines(text: str) -> list[tuple[int, int, str]]:
    """(line number, indent, content) of each content line; a block list
    item's dash and its content become lines of their own (the content
    two columns further in), so that the parser sees only blocks."""
    out = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        stripped = raw.lstrip(" ")
        if stripped.startswith("\t") or (stripped and "\t" in raw[: len(raw) - len(stripped)]):
            _fail(lineno, "a tab in the indentation")
        content = _strip_comment(stripped, lineno)
        if not content:
            continue
        if content.startswith(("---", "...", "%")) and (len(content) == 3 or content[3:4] in (" ", "")):
            _fail(lineno, "a document marker or directive")
        indent = len(raw) - len(stripped)
        while content == "-" or content.startswith("- "):
            out.append((lineno, indent, "-"))
            rest = content[1:]
            indent += 1 + len(rest) - len(rest.lstrip(" "))
            content = rest.strip()
            if not content:
                break
        if content:
            out.append((lineno, indent, content))
    return out


class _Parser:
    def __init__(self, text: str):
        self.lines = _content_lines(text)
        self.i = 0

    def block(self, indent: int):
        """The node whose lines start at the current line, at ``indent``."""
        lineno, ind, content = self.lines[self.i]
        if ind != indent:
            _fail(lineno, "this indentation")
        if content == "-":
            return self.sequence(indent)
        if _split_key(content, lineno) is not None:
            return self.mapping(indent)
        self.i += 1
        if self.i < len(self.lines) and self.lines[self.i][1] > indent:
            _fail(self.lines[self.i][0], "a multi-line scalar")
        return _value(content, lineno)

    def nested(self, parent_indent: int, lineno: int, allow_same_indent_list: bool = False):
        """The node below a ``key:`` or ``-`` with nothing after it."""
        if self.i < len(self.lines):
            _, ind, content = self.lines[self.i]
            if ind > parent_indent or (allow_same_indent_list and ind == parent_indent and content == "-"):
                return self.block(ind)
        return None

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            lineno, ind, content = self.lines[self.i]
            if ind < indent or (ind == indent and content != "-"):
                break  # a list may sit at its key's indent: a key ends it
            if ind > indent:
                _fail(lineno, "this line (a list item expected)")
            self.i += 1
            out.append(self.nested(indent, lineno))
        return out

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            lineno, ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                _fail(lineno, "this indentation")
            entry = _split_key(content, lineno)
            if entry is None:
                _fail(lineno, f"the line {content!r} (a mapping entry expected)")
            key, rest = entry
            self.i += 1
            out[key] = _value(rest, lineno) if rest else self.nested(indent, lineno, allow_same_indent_list=True)
        return out


def load(text: str):
    """The document's value (None for an empty one)."""
    parser = _Parser(text)
    if not parser.lines:
        return None
    value = parser.block(parser.lines[0][1])
    if parser.i < len(parser.lines):
        _fail(parser.lines[parser.i][0], "this line (after the document's top node)")
    return value
