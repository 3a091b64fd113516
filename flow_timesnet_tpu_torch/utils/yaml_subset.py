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

:func:`dumps` writes what PyYAML's ``safe_dump(obj, allow_unicode=True,
sort_keys=False)`` writes, byte for byte (block maps and lists, strings
quoted only where their plain text would read back as another value, long
lines folded at 80 columns), but for a string holding a line break, which
it writes escaped in double quotes; ``yaml.safe_load`` and :func:`loads`
read back the same mapping.
"""

from __future__ import annotations

import datetime as _dt
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
        try:
            key = flow._quoted()
        except ValueError:  # a quoted scalar folded over the next lines: a value
            return None
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
#
# PyYAML's ``safe_dump(obj, allow_unicode=True, sort_keys=False)``, byte for
# byte: its representer's scalar texts and its emitter's block style, scalar
# analysis, quoting and folding at 80 columns, followed step by step.

_WIDTH = 80  # PyYAML's best_width
_BREAKS = "\n\x85\u2028\u2029"
_SPACE_OR_BREAK = "\0 \t\r" + _BREAKS
_QUOTE_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\t": "t", "\n": "n", "\x0b": "v",
                  "\x0c": "f", "\r": "r", "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N",
                  "\xa0": "_", "\u2028": "L", "\u2029": "P"}


def _represent(v: Any) -> Tuple[str, bool]:
    """A scalar's text and whether its plain text resolves back to it."""

    if v is None:
        return "null", True
    if isinstance(v, bool):
        return ("true" if v else "false"), True
    if isinstance(v, int):
        return str(int(v)), True
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan", True
        if math.isinf(v):
            return (".inf" if v > 0 else "-.inf"), True
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text, True
    if isinstance(v, str):
        return v, v not in ("<<", "=") and isinstance(resolve_plain(v), str)
    if isinstance(v, _dt.datetime):
        return v.isoformat(" "), True
    if isinstance(v, _dt.date):
        return v.isoformat(), True
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:  # a numpy scalar
        return _represent(v.item())
    raise TypeError(f"cannot write a {type(v).__name__} as YAML")


def _analyze(s: str) -> Tuple[bool, bool, bool]:
    """PyYAML's ``Emitter.analyze_scalar`` (unicode allowed): whether ``s``
    spans lines, may be written plain in block context, and single-quoted."""

    if not s:
        return False, True, True
    indicators = s.startswith(("---", "..."))
    line_breaks = special = False
    lead_space = lead_break = trail_space = trail_break = break_space = space_break = False
    preceded, followed = True, len(s) == 1 or s[1] in _SPACE_OR_BREAK
    prev_space = prev_break = False
    for i, ch in enumerate(s):
        if i == 0:
            indicators |= ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and followed)
        else:
            indicators |= (ch == ":" and followed) or (ch == "#" and preceded)
        line_breaks |= ch in _BREAKS
        if not (ch == "\n" or " " <= ch <= "~"):
            special |= not ((ch == "\x85" or "\xa0" <= ch <= "\ud7ff" or "\ue000" <= ch <= "\ufffd"
                             or "\U00010000" <= ch < "\U0010ffff") and ch != "\ufeff")
        if ch == " ":
            lead_space |= i == 0
            trail_space |= i == len(s) - 1
            break_space |= prev_break
            prev_space, prev_break = True, False
        elif ch in _BREAKS:
            lead_break |= i == 0
            trail_break |= i == len(s) - 1
            space_break |= prev_space
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
        preceded = ch in _SPACE_OR_BREAK
        followed = i + 2 >= len(s) or s[i + 2] in _SPACE_OR_BREAK
    plain = not (lead_space or lead_break or trail_space or trail_break or break_space
                 or space_break or special or line_breaks or indicators)
    single = not (break_space or space_break or special)
    return line_breaks, plain, single


class _Emitter:
    """The state of PyYAML's emitter that block style reads: the column,
    whether the last character written was whitespace or an indentation,
    and the stack of indents."""

    def __init__(self) -> None:
        self.out: List[str] = []
        self.column = 0
        self.whitespace = self.indention = True
        self.indent = None
        self.indents: List[Any] = []

    def write(self, data: str) -> None:
        self.out.append(data)
        self.column += len(data)

    def line_break(self) -> None:
        self.out.append("\n")
        self.column = 0
        self.whitespace = self.indention = True

    def write_indent(self) -> None:
        indent = self.indent or 0
        if (not self.indention or self.column > indent
                or (self.column == indent and not self.whitespace)):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def indicator(self, text: str, need_space: bool, whitespace=False, indention=False) -> None:
        self.write(text if self.whitespace or not need_space else " " + text)
        self.whitespace = whitespace
        self.indention = self.indention and indention

    def push_indent(self, flow: bool, indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = 2 if flow else 0
        elif not indentless:
            self.indent += 2

    def node(self, v: Any, in_mapping: bool = False, simple_key: bool = False) -> None:
        if isinstance(v, (Mapping, list)) and not v:  # an empty collection: flow style
            self.indicator("{" if isinstance(v, Mapping) else "[", True, whitespace=True)
            self.indicator("}" if isinstance(v, Mapping) else "]", False)
        elif isinstance(v, Mapping):
            self.push_indent(flow=False)
            for key, value in v.items():
                self.write_indent()
                text, _ = _represent(key)
                if not text or len(text) >= 128 or _analyze(text)[0]:
                    raise ValueError(f"a mapping key that is not a simple key: {key!r}")
                self.node(key, in_mapping=True, simple_key=True)
                self.indicator(":", False)
                self.node(value, in_mapping=True)
            self.indent = self.indents.pop()
        elif isinstance(v, list):
            self.push_indent(flow=False, indentless=in_mapping and not self.indention)
            for item in v:
                self.write_indent()
                self.indicator("-", True, indention=True)
                self.node(item)
            self.indent = self.indents.pop()
        else:
            self.scalar(v, simple_key)

    def scalar(self, v: Any, simple_key: bool) -> None:
        self.push_indent(flow=True)
        text, implicit = _represent(v)
        multiline, plain, single = _analyze(text)
        if implicit and plain and not (simple_key and not text):
            self.plain(text, not simple_key)
        elif single and not multiline:
            self.single_quoted(text, not simple_key)
        else:
            # PyYAML would single-quote a string holding a line break and
            # write the break itself; it is written escaped, double-quoted
            self.double_quoted(text, not simple_key)
        self.indent = self.indents.pop()

    def plain(self, text: str, split: bool) -> None:
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces, start = False, 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > _WIDTH and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self.write(text[start:end])
                start = end
            spaces = ch == " "

    def single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        spaces, start = False, 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if (start + 1 == end and self.column > _WIDTH and split
                            and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch in " '":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            spaces = ch == " "
        self.indicator("'", False)

    def double_quoted(self, text: str, split: bool) -> None:
        self.indicator('"', True)
        start = 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\ufeff' or not (
                    " " <= ch <= "~" or "\xa0" <= ch <= "\ud7ff" or "\ue000" <= ch <= "\ufffd"):
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _QUOTE_ESCAPES:
                        self.write("\\" + _QUOTE_ESCAPES[ch])
                    elif ch <= "\xff":
                        self.write("\\x%02X" % ord(ch))
                    elif ch <= "\uffff":
                        self.write("\\u%04X" % ord(ch))
                    else:
                        self.write("\\U%08X" % ord(ch))
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > _WIDTH and split):
                self.write(text[start:end] + "\\")
                start = max(start, end)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
        self.indicator('"', False)


def dumps(obj: Mapping[str, Any]) -> str:
    """``obj`` (a mapping of scalars, lists and mappings) as YAML text, as
    PyYAML's ``safe_dump(obj, allow_unicode=True, sort_keys=False)`` writes
    it (but strings holding a line break: see :meth:`_Emitter.scalar`)."""

    emitter = _Emitter()
    emitter.node(dict(obj))
    emitter.line_break()
    return "".join(emitter.out)
