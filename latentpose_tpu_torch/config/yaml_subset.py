"""A reader for the subset of YAML that ``configs/*.yaml`` uses, equal to
``yaml.safe_load`` on it value for value, types included, without importing
yaml (the card's path must not).

The subset: one top-level block mapping of ``key: value`` lines, comments
(``#`` at a line's start or after a blank), plain scalars, single- and
double-quoted strings, and flow sequences (``[0]``, ``['a', b]``) on one
line.  Anything else (indented lines, block sequences, flow mappings,
anchors, tags, multi-line scalars, timestamps) raises ``ValueError`` rather
than being read differently from PyYAML.

Plain scalars resolve as PyYAML's YAML 1.1 resolver resolves them: so
``3e-2`` is the string ``'3e-2'`` (a float needs a dot, and an exponent a
sign), ``0.6e-2`` the float 0.006, ``True``/``true``/``on``/``yes`` True,
``010`` the octal 8, ``1:30`` the sexagesimal 90, ``~`` and an empty value
None.
"""

from __future__ import annotations

import re

# PyYAML's implicit resolvers (resolver.py), in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TRUE = ("yes", "true", "on")

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text, cast):
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _int(text):
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    text = text.lstrip("+-")
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text):
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    text = text.lstrip("+-")
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def resolve_plain(text):
    """A plain scalar as PyYAML's SafeLoader constructs it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _TIMESTAMP.match(text):
        raise ValueError(f"timestamp {text!r}: outside the YAML subset read "
                         "here")
    return text


def _single(line, i):
    """The single-quoted scalar opening at ``line[i]``; (value, end)."""
    out, i = [], i + 1
    while i < len(line):
        if line[i] == "'":
            if line[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(line[i])
        i += 1
    raise ValueError(f"unterminated quote: {line!r}")


def _double(line, i):
    """The double-quoted scalar opening at ``line[i]``; (value, end)."""
    out, i = [], i + 1
    while i < len(line):
        ch = line[i]
        if ch == '"':
            return "".join(out), i + 1
        if ch == "\\":
            code = line[i + 1:i + 2]
            if code in _ESCAPES:
                out.append(_ESCAPES[code])
                i += 2
            elif code in _HEX:
                digits = line[i + 2:i + 2 + _HEX[code]]
                out.append(chr(int(digits, 16)))
                i += 2 + _HEX[code]
            else:
                raise ValueError(f"escape \\{code} in {line!r}")
            continue
        out.append(ch)
        i += 1
    raise ValueError(f"unterminated quote: {line!r}")


def _flow_sequence(line, i):
    """The flow sequence opening at ``line[i]``; (list, end)."""
    items, i = [], i + 1
    while True:
        while i < len(line) and line[i] in " \t":
            i += 1
        if i >= len(line):
            raise ValueError(f"flow sequence not closed on its line: {line!r}")
        if line[i] == "]":
            return items, i + 1
        if line[i] == "'":
            value, i = _single(line, i)
        elif line[i] == '"':
            value, i = _double(line, i)
        elif line[i] == "[":
            value, i = _flow_sequence(line, i)
        elif line[i] in "{&*!|>%@`,":
            raise ValueError(f"outside the YAML subset read here: {line!r}")
        else:
            end = i
            while end < len(line) and line[end] not in ",]" \
                    and line[end:end + 2] != " #":
                end += 1
            value, i = resolve_plain(line[i:end].strip()), end
        items.append(value)
        while i < len(line) and line[i] in " \t":
            i += 1
        if line[i:i + 1] == ",":
            i += 1
        elif line[i:i + 1] != "]":
            raise ValueError(f"expected ',' or ']' in {line!r}")


def _rest_is_comment(line, i, end):
    rest = line[end:]
    if rest.strip() and not re.match(r"[ \t]+#", rest):
        raise ValueError(f"text after the value at column {i}: {line!r}")


def _value(line, i):
    while i < len(line) and line[i] in " \t":
        i += 1
    if i == len(line) or line[i] == "#":
        return None
    opener = line[i]
    if opener in "'\"[":
        value, end = {"'": _single, '"': _double,
                      "[": _flow_sequence}[opener](line, i)
        _rest_is_comment(line, i, end)
        return value
    if opener in "{&*!|>%@`-?" and (opener != "-" or line[i + 1:i + 2]
                                     in ("", " ")):
        raise ValueError(f"outside the YAML subset read here: {line!r}")
    text = re.split(r"[ \t]#", line[i:], maxsplit=1)[0].rstrip()
    if re.search(r":(?:[ \t]|$)", text):
        raise ValueError(f"a mapping inside a plain value: {line!r}")
    return resolve_plain(text)


def safe_load(text: str):
    """The mapping that ``yaml.safe_load(text)`` returns for ``text`` in the
    subset (None for a document of comments only)."""
    out = None
    for number, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped in ("---", "...") or line[0] in " \t-?":
            raise ValueError(f"line {number}: outside the YAML subset read "
                             f"here (one top-level mapping): {line!r}")
        match = re.match(r"([^'\"#\[\]{}][^#]*?)[ \t]*:(?:[ \t]|$)", line)
        if not match:
            raise ValueError(f"line {number}: no 'key: value': {line!r}")
        if out is None:
            out = {}
        out[resolve_plain(match.group(1))] = _value(line, match.end())
    return out
