"""A reader and a writer for the YAML the pipeline's configs use, without
PyYAML.

:func:`loads` reads block maps and block lists (nested by indentation,
``- item`` lists at or below their key's column, ``- - x`` and ``- k: v``
items as PyYAML writes them), flow lists and flow maps (``[[3, 3], [5,
5]]``, ``{type: "cosine", eta_min: 1.0e-5}``), single- and double-quoted
scalars, plain scalars (folded over deeper lines, as PyYAML wraps long
strings) and ``#`` comments, in UTF-8. Plain scalars resolve as PyYAML's
``safe_load`` resolves them (YAML 1.1): ``yes``/``no``/``on``/``off``/
``true``/``false`` in their three spellings are booleans, ``~``, ``null``
and an empty value are None, ``1.0e-5`` is a float but ``1e-3`` (no dot)
and ``1.0e5`` (no exponent sign) are strings, ``017`` is octal, ``0x1F``
hexadecimal, ``1_000`` an int, ``1:20`` sexagesimal and ``2024-01-01`` a
``datetime.date``. Anchors, aliases, tags, block scalars (``|``, ``>``),
document markers and flow collections over several lines are outside the
subset and raise ``ValueError``; so are line breaks kept inside a folded
scalar (blank lines), which the reader drops.

:func:`dumps` writes maps as block maps and lists as flow lists, quoting
every string, so that ``yaml.safe_load`` (and :func:`loads`) read back the
same mapping.
"""

from __future__ import annotations

import datetime as _dt
import json
import math
import re
from typing import Any, List, Mapping, Tuple

_BOOL = {v: b for b, words in ((True, ("yes", "true", "on")), (False, ("no", "false", "off")))
         for w in words for v in (w, w.capitalize(), w.upper())}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_DATE = re.compile(r"^([0-9]{4})-([0-9]{2})-([0-9]{2})$")
_DATETIME = re.compile(
    r"^([0-9]{4})-([0-9]{1,2})-([0-9]{1,2})(?:[Tt]|[ \t]+)([0-9]{1,2}):([0-9]{2}):([0-9]{2})"
    r"(?:\.([0-9]*))?(?:[ \t]*(Z|([-+])([0-9]{1,2})(?::([0-9]{2}))?))?$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast):
    sign = -1 if text.startswith("-") else 1
    parts = [cast(p) for p in text.lstrip("+-").split(":")]
    value, base = 0, 1
    for p in reversed(parts):
        value += p * base
        base *= 60
    return sign * value


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t.startswith("-") else 1
    body = t.lstrip("+-")
    if body == "0":
        return 0
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body.startswith("0"):
        return sign * int(body, 8)
    if ":" in body:
        return sign * _sexagesimal(body, int)
    return sign * int(body)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t.startswith("-") else 1.0
    body = t.lstrip("+-")
    if body == ".inf":
        return sign * math.inf
    if body == ".nan":
        return math.nan
    if ":" in body:
        return sign * _sexagesimal(body, float)
    return sign * float(body)


def _timestamp(text: str):
    m = _DATE.match(text)
    if m:
        return _dt.date(*(int(g) for g in m.groups()))
    m = _DATETIME.match(text)
    y, mo, d, h, mi, s, frac, tz, tz_sign, tz_h, tz_m = m.groups()
    micro = int((frac or "0")[:6].ljust(6, "0"))
    tzinfo = None
    if tz == "Z":
        tzinfo = _dt.timezone.utc
    elif tz:
        delta = _dt.timedelta(hours=int(tz_h), minutes=int(tz_m or 0))
        tzinfo = _dt.timezone(-delta if tz_sign == "-" else delta)
    return _dt.datetime(int(y), int(mo), int(d), int(h), int(mi), int(s), micro, tzinfo=tzinfo)


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar as PyYAML's safe loader resolves it."""

    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _DATE.match(text) or _DATETIME.match(text):
        return _timestamp(text)
    return text


# -- reading ---------------------------------------------------------------


def _strip_comment(line: str) -> str:
    """``line`` without a trailing ``# comment`` (a ``#`` at the start or
    after a space, outside quotes)."""

    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 1
            elif ch == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif ch in "\"'" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _double_quoted(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        code = body[i + 1:i + 2]
        if code in _HEX:
            n = _HEX[code]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        elif code in _ESCAPES:
            out.append(_ESCAPES[code])
            i += 2
        else:
            raise ValueError(f"unknown escape \\{code} in a double-quoted scalar")
    return "".join(out)


class _Flow:
    """Recursive descent over one line's flow content (and its scalars)."""

    def __init__(self, text: str) -> None:
        self.text = text
        self.pos = 0

    def _ws(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def _peek(self) -> str:
        self._ws()
        return self.text[self.pos:self.pos + 1]

    def _quoted(self) -> str:
        quote = self.text[self.pos]
        i = self.pos + 1
        while i < len(self.text):
            ch = self.text[i]
            if quote == '"' and ch == "\\":
                i += 2
                continue
            if ch == quote:
                if quote == "'" and self.text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                body = self.text[self.pos + 1:i]
                self.pos = i + 1
                return _double_quoted(body) if quote == '"' else body.replace("''", "'")
            i += 1
        raise ValueError(f"unterminated quoted scalar in {self.text!r}")

    def _plain(self, stops: str) -> str:
        start = self.pos
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch in stops:
                break
            if ch == ":" and stops and self.text[self.pos + 1:self.pos + 2] in ("", " ", ",",
                                                                                 "]", "}"):
                break
            self.pos += 1
        return self.text[start:self.pos].strip()

    def node(self, stops: str = ",]}") -> Any:
        ch = self._peek()
        if ch == "[":
            self.pos += 1
            items = []
            while self._peek() != "]":
                items.append(self.node())
                if self._peek() == ",":
                    self.pos += 1
                elif self._peek() != "]":
                    raise ValueError(f"expected ',' or ']' in {self.text!r}")
            self.pos += 1
            return items
        if ch == "{":
            self.pos += 1
            out = {}
            while self._peek() != "}":
                key = self.node(",:}")
                value = None
                if self._peek() == ":":
                    self.pos += 1
                    value = self.node(",}")
                out[key] = value
                if self._peek() == ",":
                    self.pos += 1
                elif self._peek() != "}":
                    raise ValueError(f"expected ',' or '}}' in {self.text!r}")
            self.pos += 1
            return out
        if ch in ("'", '"'):
            return self._quoted()
        if ch in ("&", "*", "!", "|", ">", "%", "@", "`"):
            raise ValueError(f"{ch!r} (anchors, aliases, tags, block scalars) is outside "
                             f"the YAML subset: {self.text!r}")
        return resolve_plain(self._plain(stops))

    def scalar_line(self) -> Any:
        """A whole value: one flow node and nothing after it."""

        value = self.node("")
        if self._peek():
            raise ValueError(f"unexpected text after a value: {self.text!r}")
        return value


def _split_key(content: str):
    """``(key, rest)`` where ``content`` is ``key: rest``, else None."""

    if content[:1] in ("'", '"'):
        flow = _Flow(content)
        key = flow._quoted()
        if content[flow.pos:flow.pos + 1] == ":" and content[flow.pos + 1:flow.pos + 2] in ("",
                                                                                              " "):
            return key, content[flow.pos + 1:].strip()
        return None
    if content[:1] in ("[", "{"):
        return None
    m = re.search(r":(?:\s|$)", content)
    if not m:
        return None
    return resolve_plain(content[:m.start()].strip()), content[m.end():].strip()


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.replace("\r\n", "\n").split("\n"):
        if raw.startswith("\ufeff"):
            raw = raw[1:]
        if raw.rstrip() in ("---", "...") or raw.startswith(("--- ", "%")):
            raise ValueError("directives and document markers are outside the YAML subset")
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs cannot indent YAML")
        line = _strip_comment(raw)
        if line.strip():
            out.append((len(line) - len(line.lstrip(" ")), line.strip()))
    return out


class _Block:
    def __init__(self, lines: List[Tuple[int, str]]) -> None:
        self.lines = lines
        self.i = 0

    def parse(self, indent: int) -> Any:
        col, content = self.lines[self.i]
        if content == "-" or content.startswith("- "):
            return self._list(col)
        if _split_key(content) is not None:
            return self._map(col)
        value = _Flow(content).scalar_line()
        self.i += 1
        return value

    def _value(self, rest: str, col: int, list_parent: bool) -> Any:
        """The value after ``key:`` or ``-``: inline, or the block below."""

        if rest:
            # a scalar folded over deeper lines (PyYAML wraps long strings):
            # joined by a space, or by nothing after an escaped line break
            while self.i < len(self.lines) and self.lines[self.i][0] > col:
                nxt = self.lines[self.i][1]
                escaped = rest[:1] == '"' and (len(rest) - len(rest.rstrip("\\"))) % 2 == 1
                rest = rest[:-1] + nxt if escaped else f"{rest} {nxt}"
                self.i += 1
            return _Flow(rest).scalar_line()
        if self.i < len(self.lines):
            nxt_col, nxt = self.lines[self.i]
            deeper = nxt_col > col
            same_col_list = (not list_parent and nxt_col == col
                             and (nxt == "-" or nxt.startswith("- ")))
            if deeper or same_col_list:
                return self.parse(nxt_col)
        return None

    def _map(self, col: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            c, content = self.lines[self.i]
            if c < col:
                break
            if c > col:
                raise ValueError(f"bad indentation at {content!r}")
            kv = _split_key(content)
            if kv is None:
                break
            key, rest = kv
            self.i += 1
            out[key] = self._value(rest, col, False)
        return out

    def _list(self, col: int) -> list:
        out = []
        while self.i < len(self.lines):
            c, content = self.lines[self.i]
            if c != col or not (content == "-" or content.startswith("- ")):
                if c > col:
                    raise ValueError(f"bad indentation at {content!r}")
                break
            rest = content[1:].strip()
            item_col = c + (len(content) - len(content[1:].lstrip())) if rest else c
            nested_list = rest == "-" or rest.startswith("- ")
            if nested_list or (rest and _split_key(rest) is not None
                               and rest[:1] not in ("[", "{")):
                # "- - x" opens a list, "- key: value" a map, at the item's column
                self.lines[self.i] = (item_col, rest)
                out.append(self._list(item_col) if nested_list else self._map(item_col))
                continue
            self.i += 1
            out.append(self._value(rest, col, True))
        return out


def loads(text: str) -> Any:
    """Parse a YAML document of the subset (see the module's doc)."""

    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value = block.parse(lines[0][0])
    if block.i != len(lines):
        raise ValueError(f"unexpected content at {lines[block.i][1]!r}")
    return value


# -- writing ---------------------------------------------------------------


def _float_text(v: float) -> str:
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(float(v))
    if "e" in text:
        mant, exp = text.split("e")
        if "." not in mant:
            mant += ".0"
        if exp[0] not in "+-":
            exp = "+" + exp
        text = f"{mant}e{exp}"
    elif "." not in text:
        text += ".0"
    return text


def _str_text(s: str) -> str:
    text = json.dumps(s, ensure_ascii=False)
    # line separators YAML would fold inside a double-quoted scalar
    return (text.replace("\x85", "\\N").replace("\u2028", "\\L").replace("\u2029", "\\P")
            .replace("\ufeff", "\\ufeff"))


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(int(v))
    if isinstance(v, float):
        return _float_text(v)
    if isinstance(v, str):
        return _str_text(v)
    if isinstance(v, (_dt.date, _dt.datetime)):
        return v.isoformat(sep=" ") if isinstance(v, _dt.datetime) else v.isoformat()
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:  # a numpy scalar
        return _scalar(v.item())
    raise TypeError(f"cannot write a {type(v).__name__} as YAML")


def _flow(v: Any) -> str:
    if isinstance(v, Mapping):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _scalar(v)


def _block(obj: Mapping[str, Any], indent: int, out: List[str]) -> None:
    pad = " " * indent
    for k, v in obj.items():
        if isinstance(v, Mapping) and v:
            out.append(f"{pad}{_scalar(k)}:")
            _block(v, indent + 2, out)
        else:
            out.append(f"{pad}{_scalar(k)}: {_flow(v)}")


def dumps(obj: Mapping[str, Any]) -> str:
    """``obj`` (a mapping of scalars, lists and mappings) as YAML text."""

    out: List[str] = []
    _block(obj, 0, out)
    return "\n".join(out) + "\n"
