"""A reader for the subset of YAML the project's configs use, without PyYAML.

The card's machine has no PyYAML, so the port reads its config files with
this module. It gives what ``yaml.safe_load`` gives on:

  * block mappings nested by indentation, and ``- item`` block sequences
    (indented under their key or level with it, items that are scalars,
    mappings or sequences);
  * flow sequences of scalars on one line (``remat_stages: [enc1, dec1]``);
  * plain, single-quoted and double-quoted scalars (a ``#`` inside quotes
    is text); full-line and trailing comments;
  * an empty value, read as None;
  * YAML 1.1 typing of plain scalars as safe_load resolves them: null
    (``~``, ``null``, empty), bool (``true``/``yes``/``on`` and their
    negatives in three cases), int (decimal, ``0b``, ``0x``, octal,
    base 60, ``_`` separators) and float (which needs a ``.``: ``2e-4``
    stays a string, ``2.0e-4`` is a float; ``.inf``, ``.nan``).

Everything else raises ValueError with its line number rather than be
read some other way: anchors and aliases, tags, block scalars (``|``,
``>``), flow mappings, multi-line scalars, complex keys, merge keys,
timestamps, directives and more than one document.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, List, NamedTuple, Optional, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_COMMENT = re.compile(r"[ \t]#")
_VALUE_COLON = re.compile(r":(?:[ \t]|$)")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line(NamedTuple):
    no: int      # 1-based line number in the file
    indent: int  # leading spaces
    text: str    # the rest, trailing whitespace removed


def _error(no: int, msg: str) -> ValueError:
    return ValueError(f"yaml_lite: line {no}: {msg}")


def _sexagesimal(value: str, cast):
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _resolve(text: str, no: int) -> Any:
    """A plain scalar typed as yaml.safe_load types it."""
    if text == "" or _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text) or _INT.match(text):
        is_float = _FLOAT.match(text) is not None
        value = text.replace("_", "")
        value = value.lower() if is_float else value
        sign = -1 if value[0] == "-" else 1
        value = value[1:] if value[0] in "+-" else value
        if is_float:
            if value == ".inf":
                return sign * float("inf")
            if value == ".nan":
                return float("nan")
            return sign * (_sexagesimal(value, float) if ":" in value else float(value))
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        return sign * (_sexagesimal(value, int) if ":" in value else int(value))
    if text == "<<":
        raise _error(no, "merge keys (<<) are outside the subset")
    if text == "=" or _TIMESTAMP.match(text):
        raise _error(no, f"{text!r} resolves to a YAML type outside the subset")
    return text


def _quoted(text: str, no: int) -> Tuple[str, int]:
    """The quoted scalar that text starts with, and the index after it."""
    quote, out, i = text[0], [], 1
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and ch == '"':
            return "".join(out), i + 1
        if quote == '"' and ch == "\\":
            esc = text[i + 1 : i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            width = _HEX_ESCAPES.get(esc)
            digits = text[i + 2 : i + 2 + width] if width else ""
            if not width or not re.fullmatch(r"[0-9a-fA-F]+", digits) or len(digits) != width:
                raise _error(no, f"unknown escape \\{esc} in a double-quoted scalar")
            out.append(chr(int(digits, 16)))
            i += 2 + width
            continue
        out.append(ch)
        i += 1
    raise _error(no, "unterminated quoted scalar (multi-line scalars are outside the subset)")


def _rest_is_comment(rest: str, no: int) -> None:
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise _error(no, f"unexpected text after a scalar: {rest!r}")


def _check_plain_start(text: str, no: int, what: str) -> None:
    c = text[0]
    if c == "{":
        raise _error(no, "flow mappings are outside the subset")
    if c in "|>":
        raise _error(no, "block scalars (| and >) are outside the subset")
    if c in "&*":
        raise _error(no, "anchors and aliases are outside the subset")
    if c == "!":
        raise _error(no, "tags are outside the subset")
    if c in "%@`,]}" or (c in "?:-" and (len(text) == 1 or text[1] in " \t")):
        raise _error(no, f"{what} cannot start with {c!r} here")


def _flow_sequence(text: str, no: int) -> List[Any]:
    """A one-line flow sequence of scalars, ``[a, 'b', 3]``."""
    items: List[Any] = []
    i = 1
    while True:
        i = _skip_blanks(text, i, no)
        if text[i] == "]":  # [] or a trailing comma, as safe_load takes them
            _rest_is_comment(text[i + 1 :], no)
            return items
        if text[i] in "'\"":
            value, used = _quoted(text[i:], no)
            i += used
        else:
            end = i
            while end < len(text) and text[end] not in ",]":
                end += 1
            item = text[i:end].strip()
            if not item:
                raise _error(no, "empty entry in a flow sequence")
            if item[0] == "[":
                raise _error(no, "nested flow sequences are outside the subset")
            _check_plain_start(item, no, "a flow sequence entry")
            if _COMMENT.search(item) or _VALUE_COLON.search(item) or "{" in item or "[" in item:
                raise _error(no, f"flow entry {item!r} is outside the subset")
            value, i = _resolve(item, no), end
        items.append(value)
        i = _skip_blanks(text, i, no)
        if text[i] == "]":
            _rest_is_comment(text[i + 1 :], no)
            return items
        if text[i] != ",":
            raise _error(no, "expected ',' or ']' in a flow sequence")
        i += 1


def _skip_blanks(text: str, i: int, no: int) -> int:
    while i < len(text) and text[i] in " \t":
        i += 1
    if i >= len(text):
        raise _error(no, "unterminated flow sequence (multi-line ones are outside the subset)")
    return i


def _scalar(text: str, no: int) -> Any:
    """The value a line's remaining text holds: a scalar or a flow sequence."""
    text = text.strip()
    if not text or text[0] == "#":
        return None
    if text[0] in "'\"":
        value, end = _quoted(text, no)
        _rest_is_comment(text[end:], no)
        return value
    if text[0] == "[":
        return _flow_sequence(text, no)
    _check_plain_start(text, no, "a plain scalar")
    comment = _COMMENT.search(text)
    if comment:
        text = text[: comment.start()].rstrip()
    if _VALUE_COLON.search(text):
        raise _error(no, f"{text!r}: a mapping value is not allowed here")
    return _resolve(text, no)


def _is_entry(text: str) -> bool:
    return text == "-" or (text[0] == "-" and text[1] in " \t")


def _key(text: str, no: int) -> Optional[Tuple[Any, str]]:
    """(key, the text after ``key:``) if the line is a mapping entry, else None."""
    if text[0] in "'\"":
        key, end = _quoted(text, no)
        rest = text[end:].lstrip(" \t")
        if rest[:1] == ":" and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:]
        return None
    colon = _VALUE_COLON.search(text)
    comment = _COMMENT.search(text)
    if text[0] == "#" or not colon or (comment and comment.start() < colon.start()):
        return None
    key_text = text[: colon.start()].rstrip()
    if not key_text:
        raise _error(no, "a mapping entry with an empty key")
    if key_text[0] == "[":
        raise _error(no, "flow sequences as keys are outside the subset")
    _check_plain_start(key_text, no, "a key")
    return _resolve(key_text, no), text[colon.start() + 1 :]


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.i = 0

    def _peek(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def node(self, indent: int) -> Any:
        """The block node whose first line is the current one, at ``indent``."""
        line = self.lines[self.i]
        if _is_entry(line.text):
            return self.sequence(indent)
        if _key(line.text, line.no) is not None:
            return self.mapping(indent)
        self.i += 1
        return self._end_scalar(_scalar(line.text, line.no), indent)

    def _end_scalar(self, value: Any, indent: int) -> Any:
        nxt = self._peek()
        if nxt is not None and nxt.indent > indent:
            raise _error(nxt.no, "unexpected indentation (multi-line scalars are outside the subset)")
        return value

    def _value(self, rest: str, indent: int, indentless_ok: bool) -> Any:
        """The value after ``key:`` or ``-`` on a line at ``indent``."""
        rest = rest.strip()
        if not rest or rest[0] == "#":
            nxt = self._peek()
            if nxt is not None and nxt.indent > indent:
                return self.node(nxt.indent)
            if indentless_ok and nxt is not None and nxt.indent == indent and _is_entry(nxt.text):
                return self.sequence(indent)
            return None
        return self._end_scalar(_scalar(rest, self.lines[self.i - 1].no), indent)

    def mapping(self, indent: int) -> dict:
        out = {}
        while (line := self._peek()) is not None and line.indent >= indent:
            if line.indent > indent:
                raise _error(line.no, "unexpected indentation")
            entry = _key(line.text, line.no)
            if entry is None:
                raise _error(line.no, f"expected 'key: value' in a mapping, got {line.text!r}")
            self.i += 1
            out[entry[0]] = self._value(entry[1], indent, indentless_ok=True)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while (line := self._peek()) is not None and line.indent == indent and _is_entry(line.text):
            content = line.text[1:].lstrip(" \t")
            if content and content[0] != "#" and (_is_entry(content) or _key(content, line.no)):
                # a compact nested node: read it as if it started at its own column
                column = indent + len(line.text) - len(content)
                self.lines[self.i] = _Line(line.no, column, content)
                out.append(self.node(column))
            else:
                self.i += 1
                out.append(self._value(content, indent, indentless_ok=False))
        nxt = self._peek()
        if nxt is not None and nxt.indent > indent:
            raise _error(nxt.no, "unexpected indentation")
        return out


def _lines(text: str) -> List[_Line]:
    out: List[_Line] = []
    for no, raw in enumerate(text.lstrip("\ufeff").splitlines(), start=1):
        body = raw.rstrip()
        stripped = body.lstrip(" ")
        if not stripped or stripped[0] == "#":
            continue
        if "\t" in body:
            raise _error(no, "tabs are outside the subset")
        indent = len(body) - len(stripped)
        if indent == 0 and (stripped.startswith(("---", "...")) and
                            (len(stripped) == 3 or stripped[3] in " \t")):
            if stripped == "---" and not out:
                continue  # one leading document start marker
            raise _error(no, "document markers (more than one document) are outside the subset")
        out.append(_Line(no, indent, stripped))
    return out


def loads(text: str) -> Any:
    """The document in ``text``, as yaml.safe_load reads it; None if empty."""
    lines = _lines(text)
    if not lines:
        return None
    parser = _Parser(lines)
    doc = parser.node(lines[0].indent)
    if parser.i < len(lines):
        raise _error(lines[parser.i].no, "unexpected content after the document's root node")
    return doc


def load(path: str | Path) -> Any:
    """The document in the file at ``path``."""
    return loads(Path(path).read_text(encoding="utf-8"))
