"""A YAML emitter for the config's own subset (no yaml package on the card
machine): nested mappings and lists of str / int / float / bool / None, in
block style, keys in their order. A string is written plain where YAML 1.1
reads it back as that string, else double-quoted with JSON escapes (which
YAML's double-quoted style shares); floats always carry a dot or an
exponent YAML resolves as a float."""

from __future__ import annotations

import json
import math
import re

_PLAIN = re.compile(r"[A-Za-z_][A-Za-z0-9_./@;\-]*")
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
        return json.dumps(v, ensure_ascii=False)
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
