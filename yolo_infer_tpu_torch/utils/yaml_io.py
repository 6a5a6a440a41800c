"""A reader and a writer for the YAML that configs and dataset files use.

The JAX package reads and writes YAML with PyYAML (`yaml.safe_load`,
`yaml.safe_dump`). The port must not depend on it, so it keeps its own
reader for the subset that the repo's `configs/` and YOLO (ultralytics)
dataset files are written in, giving what `yaml.safe_load` gives:

  - block mappings and block sequences by indentation (a sequence may sit at
    its key's indentation; `- key: value` opens a mapping in a sequence);
  - flow sequences `[a, b]` and flow mappings `{a: 1}`, nested, over one or
    more lines;
  - plain scalars resolved by YAML 1.1's rules as PyYAML applies them
    (`true`/`yes`/`on`..., `null`/`~`/empty, decimal, octal, hex and binary
    ints, floats with a dot, `.inf`, `.nan`), single- and double-quoted
    scalars (with their escapes), keys included;
  - comments, a leading `---` and a trailing `...`.

Anything else raises `YAMLSubsetError` (a `ValueError`) rather than
returning a guess: block scalars (`|`, `>`), anchors, aliases and tags,
complex keys, multi-line plain or quoted scalars, timestamps, sexagesimal
numbers, merge keys, tabs in indentation and more than one document.

`dump` writes block style (flow style only for empty collections), quoting
any string that would read back as another type; `yaml.safe_load` and
`safe_load` both read it back equal.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, List, Optional, Tuple, Union


class YAMLSubsetError(ValueError):
    """The text is not YAML, or not in the subset this reader accepts."""


# PyYAML's implicit resolvers (YAML 1.1), as `yaml.resolver.Resolver` has them
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9][0-9]?"
                        r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}

# characters that may not start a plain scalar (`-`, `?`, `:` may, before a non-space)
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b", "f": "\x0c",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
            "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def resolve_plain(text: str) -> Any:
    """A plain scalar's value as PyYAML's SafeLoader resolves and constructs it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if _INT.match(text):
        v = text.replace("_", "")
        if ":" in v:
            raise YAMLSubsetError(f"sexagesimal integer {text!r} is outside the supported YAML subset")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if ":" in v:
            raise YAMLSubsetError(f"sexagesimal float {text!r} is outside the supported YAML subset")
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise YAMLSubsetError(f"timestamp {text!r} is outside the supported YAML subset")
    if text in ("<<", "="):
        raise YAMLSubsetError(f"{text!r} (merge or value key) is outside the supported YAML subset")
    return text


# ---------------------------------------------------------------------------
# Scalars and flow collections on one logical line
# ---------------------------------------------------------------------------

class _Cursor:
    """A position in one logical line of text (flow collections may join lines)."""

    def __init__(self, text: str, where: str):
        self.text, self.pos, self.where = text, 0, where

    def error(self, msg: str) -> YAMLSubsetError:
        return YAMLSubsetError(f"{self.where}: {msg}")

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_space(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1


def _single_quoted(cur: _Cursor) -> str:
    out = []
    cur.pos += 1
    text = cur.text
    while True:
        j = text.find("'", cur.pos)
        if j < 0:
            raise cur.error("an unterminated or multi-line single-quoted scalar")
        out.append(text[cur.pos: j])
        if text[j + 1: j + 2] == "'":
            out.append("'")
            cur.pos = j + 2
        else:
            cur.pos = j + 1
            return "".join(out)


def _double_quoted(cur: _Cursor) -> str:
    out = []
    cur.pos += 1
    text = cur.text
    while cur.pos < len(text):
        ch = text[cur.pos]
        if ch == '"':
            cur.pos += 1
            return "".join(out)
        if ch == "\\":
            esc = text[cur.pos + 1: cur.pos + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                cur.pos += 2
            elif esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                digits = text[cur.pos + 2: cur.pos + 2 + n]
                if len(digits) != n or not all(c in "0123456789abcdefABCDEF" for c in digits):
                    raise cur.error(f"a bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                cur.pos += 2 + n
            else:
                raise cur.error(f"an unknown or line-joining escape \\{esc!s}")
        else:
            out.append(ch)
            cur.pos += 1
    raise cur.error("an unterminated or multi-line double-quoted scalar")


def _plain(cur: _Cursor, flow: bool) -> str:
    """A plain scalar up to a comment, a `: ` (or `:` before a flow
    terminator) and, in flow context, a `,`, `[`, `]`, `{` or `}`."""
    text = cur.text
    start = cur.pos
    first = text[start: start + 1]
    nxt = text[start + 1: start + 2]
    if first in _INDICATORS and not (first in "-?:" and nxt not in ("", " ", "\t")
                                     and not (flow and nxt in ",[]{}")):
        raise cur.error(f"a scalar starting with {first!r} (an indicator: block scalar, anchor, alias, tag, "
                        "complex key or reserved) is outside the supported YAML subset")
    i = start
    while i < len(text):
        ch = text[i]
        if ch == "#" and i > start and text[i - 1] in " \t":
            break
        if ch == ":" and (i + 1 == len(text) or text[i + 1] in " \t" or (flow and text[i + 1] in ",[]{}")):
            break
        if flow and ch in ",[]{}":
            break
        i += 1
    cur.pos = i
    return text[start:i].rstrip(" \t")


def _scalar(cur: _Cursor, flow: bool) -> Any:
    """The value of the scalar at the cursor."""
    ch = cur.peek()
    if ch == "'":
        return _single_quoted(cur)
    if ch == '"':
        return _double_quoted(cur)
    return resolve_plain(_plain(cur, flow))


def _flow(cur: _Cursor) -> Any:
    """A flow sequence or mapping at the cursor."""
    opener = cur.peek()
    closer = "]" if opener == "[" else "}"
    cur.pos += 1
    out: Any = [] if opener == "[" else {}
    while True:
        cur.skip_space()
        if cur.peek() == closer:
            cur.pos += 1
            return out
        if cur.peek() in ("[", "{"):
            key = _flow(cur)
        elif cur.peek() in ("", ",", "]", "}"):
            raise cur.error(f"an empty entry in a flow collection near {cur.text[cur.pos:cur.pos + 20]!r}")
        else:
            key = _scalar(cur, flow=True)
        cur.skip_space()
        if opener == "{":
            if cur.peek() != ":":
                raise cur.error("a flow mapping entry without `: ` is outside the supported YAML subset")
            if isinstance(key, (list, dict)):
                raise cur.error("a collection as a mapping key is outside the supported YAML subset")
            cur.pos += 1
            cur.skip_space()
            if cur.peek() in (",", "}"):
                value = None
            elif cur.peek() in ("[", "{"):
                value = _flow(cur)
            else:
                value = _scalar(cur, flow=True)
            out[key] = value
        else:
            if cur.peek() == ":":
                raise cur.error("a mapping inside a flow sequence is outside the supported YAML subset")
            out.append(key)
        cur.skip_space()
        ch = cur.peek()
        if ch == ",":
            cur.pos += 1
        elif ch != closer:
            raise cur.error(f"expected ',' or {closer!r} in a flow collection, found {ch!r}")


def _value(text: str, where: str) -> Any:
    """The inline value after `key:` or `- ` (a flow collection or a scalar),
    with nothing after it but a comment."""
    cur = _Cursor(text, where)
    cur.skip_space()
    if cur.peek() in ("[", "{"):
        value = _flow(cur)
    else:
        value = _scalar(cur, flow=False)
    cur.skip_space()
    rest = cur.text[cur.pos:]
    if rest and not rest.startswith("#"):
        if rest.startswith(":"):
            raise cur.error("a mapping value on the line of another key (`a: b: c`)")
        raise cur.error(f"unexpected text {rest[:30]!r} after a value")
    return value


# ---------------------------------------------------------------------------
# Block structure
# ---------------------------------------------------------------------------

class _Line:
    __slots__ = ("indent", "text", "num")

    def __init__(self, indent: int, text: str, num: int):
        self.indent, self.text, self.num = indent, text, num


def _brackets_open(text: str) -> int:
    """How many flow brackets `text` leaves open (outside quotes and comments)."""
    depth, i, quote = 0, 0, None
    while i < len(text):
        ch = text[i]
        if quote:
            if ch == quote:
                if quote == "'" and text[i + 1: i + 2] == "'":
                    i += 1
                else:
                    quote = None
            elif quote == '"' and ch == "\\":
                i += 1
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            break
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        i += 1
    return depth


def _lines(text: str) -> List[_Line]:
    out: List[_Line] = []
    raw = text.split("\n")
    seen_start = False
    i = 0
    while i < len(raw):
        line = raw[i].rstrip("\r")
        num = i + 1
        i += 1
        body = line.lstrip(" ")
        if not body.strip() or body.startswith("#"):
            continue
        if body.startswith("\t") or (line[: len(line) - len(body)].count("\t")):
            raise YAMLSubsetError(f"line {num}: a tab in the indentation")
        if line.startswith("%"):
            raise YAMLSubsetError(f"line {num}: directives are outside the supported YAML subset")
        if line.rstrip() in ("---", "...") or line.startswith("--- "):
            if line.rstrip() == "---" and not seen_start and not out:
                seen_start = True
                continue
            if line.rstrip() == "...":
                if any(r.strip() and not r.lstrip().startswith("#") for r in raw[i:]):
                    raise YAMLSubsetError(f"line {num}: more than one document")
                break
            raise YAMLSubsetError(f"line {num}: more than one document, or content after `---`")
        body = body.rstrip()
        # a flow collection left open continues on the following lines
        while _brackets_open(body) > 0 and i < len(raw):
            nxt = raw[i].rstrip("\r").strip()
            i += 1
            if nxt and not nxt.startswith("#"):
                body = f"{body} {nxt}"
        out.append(_Line(len(line) - len(line.lstrip(" ")), body, num))
    return out


def _key_split(line: _Line) -> Optional[Tuple[Any, str]]:
    """(key, rest) when `line` is a `key: value` entry, else None."""
    cur = _Cursor(line.text, f"line {line.num}")
    ch = cur.peek()
    if ch in ("[", "{"):
        return None
    if ch == "?" and cur.text[1:2] in ("", " "):
        raise cur.error("complex mapping keys (`? `) are outside the supported YAML subset")
    if ch in ("'", '"'):
        key = _scalar(cur, flow=False)
        cur.skip_space()
        if cur.peek() != ":":
            return None
    else:
        save = cur.pos
        text = _plain(cur, flow=False) if ch not in _INDICATORS or ch in "-?:" else None
        if text is None or cur.peek() != ":":
            cur.pos = save
            return None
        key = resolve_plain(text)
    rest = cur.text[cur.pos + 1:]
    if rest and rest[0] not in " \t":
        return None
    return key, rest.strip()


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.i = 0

    def error(self, line: _Line, msg: str) -> YAMLSubsetError:
        return YAMLSubsetError(f"line {line.num}: {msg}")

    def block(self, indent: int) -> Any:
        """The node whose first line is `self.lines[self.i]`, at `indent`."""
        line = self.lines[self.i]
        if line.text == "-" or line.text.startswith("- "):
            return self.sequence(line.indent)
        if _key_split(line) is not None:
            return self.mapping(line.indent)
        self.i += 1
        value = _value(line.text, f"line {line.num}")
        if self.i < len(self.lines) and self.lines[self.i].indent > indent:
            raise self.error(self.lines[self.i], "a multi-line plain scalar is outside the supported YAML subset")
        return value

    def nested(self, parent_indent: int, allow_same_indent_sequence: bool) -> Any:
        """The value of a `key:` or `-` with nothing after it: a deeper block,
        a sequence at the key's own indent, or null."""
        if self.i < len(self.lines):
            nxt = self.lines[self.i]
            if nxt.indent > parent_indent:
                return self.block(nxt.indent)
            if (allow_same_indent_sequence and nxt.indent == parent_indent
                    and (nxt.text == "-" or nxt.text.startswith("- "))):
                return self.sequence(parent_indent)
        return None

    def sequence(self, indent: int) -> List[Any]:
        out = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent != indent or not (line.text == "-" or line.text.startswith("- ")):
                if line.indent > indent:
                    raise self.error(line, "bad indentation in a sequence")
                break
            rest = line.text[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                self.i += 1
                out.append(self.nested(indent, allow_same_indent_sequence=False))
                continue
            # `- key: value` or `- - x`: the item is a block at the column of its content
            col = indent + len(line.text) - len(rest)
            self.lines[self.i] = _Line(col, rest, line.num)
            out.append(self.block(col))
        return out

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent != indent:
                if line.indent > indent:
                    raise self.error(line, "bad indentation in a mapping")
                break
            split = _key_split(line)
            if split is None:
                if line.text == "-" or line.text.startswith("- "):
                    raise self.error(line, "a sequence entry where a mapping key was expected")
                raise self.error(line, f"expected `key: value`, found {line.text[:40]!r}")
            key, rest = split
            if isinstance(key, (list, dict)):
                raise self.error(line, "a collection as a mapping key is outside the supported YAML subset")
            self.i += 1
            if not rest or rest.startswith("#"):
                out[key] = self.nested(indent, allow_same_indent_sequence=True)
            else:
                out[key] = _value(rest, f"line {line.num}")
                if self.i < len(self.lines) and self.lines[self.i].indent > indent:
                    raise self.error(self.lines[self.i],
                                     "a multi-line plain scalar is outside the supported YAML subset")
        return out


def safe_load(text: Union[str, bytes]) -> Any:
    """Parse YAML text in the supported subset: what `yaml.safe_load` returns for it."""
    if isinstance(text, bytes):
        text = text.decode("utf-8-sig")
    text = text.lstrip("\ufeff")
    lines = _lines(text)
    if not lines:
        return None
    parser = _Parser(lines)
    value = parser.block(lines[0].indent)
    if parser.i < len(lines):
        raise parser.error(lines[parser.i], "text after the end of the document (bad indentation?)")
    return value


def load(path: Union[str, Path]) -> Any:
    """`safe_load` of a file."""
    return safe_load(Path(path).read_text(encoding="utf-8"))


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"^[A-Za-z0-9_./()+$^=~][A-Za-z0-9_ ./()+$^=~\-]*$")


def _quote(s: str) -> str:
    out = ['"']
    for ch in s:
        o = ord(ch)
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif 0x20 <= o < 0x7F:
            out.append(ch)
        elif o <= 0xFF:
            out.append(f"\\x{o:02x}")
        elif o <= 0xFFFF:
            out.append(f"\\u{o:04x}")
        else:
            out.append(f"\\U{o:08x}")
    out.append('"')
    return "".join(out)


def _scalar_text(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        r = repr(value)
        if "." not in r and "e" in r:  # as PyYAML's representer: 1e-05 -> 1.0e-05
            r = r.replace("e", ".0e")
        elif "." not in r:
            r += ".0"
        return r
    if isinstance(value, str):
        plain = bool(_PLAIN_SAFE.match(value)) and not value.endswith(" ")
        if plain:
            try:
                plain = resolve_plain(value) == value
            except YAMLSubsetError:
                plain = False
        return value if plain else _quote(value)
    raise TypeError(f"cannot write {type(value).__name__} as YAML")


def _normalise(value: Any) -> Any:
    """numpy scalars to Python, tuples to lists, paths to strings."""
    if hasattr(value, "item") and type(value).__module__ == "numpy" and getattr(value, "ndim", 1) == 0:
        return value.item()
    if isinstance(value, tuple):
        return list(value)
    if isinstance(value, Path):
        return str(value)
    return value


def _emit(value: Any, indent: int, out: List[str]) -> None:
    """Append the lines of a non-empty collection at `indent`."""
    pad = " " * indent
    if isinstance(value, dict):
        for k, v in value.items():
            v = _normalise(v)
            key = _scalar_text(_normalise(k))
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{key}:")
                _emit(v, indent + 2, out)
            else:
                out.append(f"{pad}{key}: {_inline(v)}")
    else:
        for v in value:
            v = _normalise(v)
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}-")
                _emit(v, indent + 2, out)
            else:
                out.append(f"{pad}- {_inline(v)}")


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _scalar_text(value)


def dump(value: Any) -> str:
    """YAML text of `value` (dicts, lists, str, int, float, bool, None) in block style."""
    value = _normalise(value)
    if isinstance(value, (dict, list)) and value:
        out: List[str] = []
        _emit(value, 0, out)
        return "\n".join(out) + "\n"
    return _inline(value) + "\n"


def save(value: Any, path: Union[str, Path]) -> Path:
    """Write `dump(value)` to `path` (parents made)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(dump(value), encoding="utf-8")
    return path
