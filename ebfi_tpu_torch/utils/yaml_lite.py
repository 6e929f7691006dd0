"""A reader for the YAML the repository's configs use, without PyYAML
(the port does not depend on it).

It gives what ``yaml.safe_load`` gives (YAML 1.1 scalar resolution, so
an untagged ``2e5`` is the string "2e5" and ``!!float 2e5`` the float
200000.0) for this subset:

- block mappings and block sequences (an item is a scalar or a flow
  collection), with or without the sequence indented under its key;
- flow sequences ``[a, b]`` and flow mappings ``{k: v}`` on one line;
- plain, single-quoted and double-quoted scalars; ``null``/``~``, YAML
  1.1 booleans (``True``, ``yes``, ``off``, ...), decimal, octal, hex
  and binary ints, floats with a dot, ``.inf`` and ``.nan``;
- anchors ``&X`` and aliases ``*X``; the tags ``!!float``, ``!!int``,
  ``!!str`` and ``!!bool``;
- ``#`` comments and blank lines.

Anything else (multi-line scalars, block scalars ``|``/``>``, mappings
inside block sequences, merge keys, other tags, timestamps, sexagesimal
numbers, tabs in indentation, several documents) raises
:class:`YamlLiteError`.  ``utils/logger.py``'s ``dump_yaml`` writes within
this subset.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$"
)
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9][0-9]?"
    r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$"
)
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YamlLiteError(ValueError):
    pass


def _to_float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v.startswith("-") else 1.0
    if v[:1] in "+-":
        v = v[1:]
    if ":" in v:
        raise YamlLiteError(f"sexagesimal number {text!r} is not supported")
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    return sign * float(v)


def _to_int(text: str) -> int:
    v = text.replace("_", "")
    sign = -1 if v.startswith("-") else 1
    if v[:1] in "+-":
        v = v[1:]
    if ":" in v:
        raise YamlLiteError(f"sexagesimal number {text!r} is not supported")
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v.startswith("0"):
        return sign * int(v, 8)
    return sign * int(v)


def resolve_plain(text: str) -> Any:
    """A plain scalar as YAML 1.1's implicit resolvers type it."""
    if _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if _FLOAT.match(text):
        return _to_float(text)
    if _INT.match(text):
        return _to_int(text)
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text) or text in ("<<", "=") or text[:1] in "!&*@`|>%":
        raise YamlLiteError(f"scalar {text!r} is outside the supported subset")
    return text


def _tagged(tag: str, text: str) -> Any:
    if tag == "!!str":
        return text
    if tag == "!!float":
        return _to_float(text)
    if tag == "!!int":
        return _to_int(text)
    if tag == "!!bool":
        if text.lower() not in _BOOL_VALUES:
            raise YamlLiteError(f"!!bool {text!r}")
        return _BOOL_VALUES[text.lower()]
    raise YamlLiteError(f"tag {tag} is not supported")


def _double_quoted(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1 : i + 2]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            out.append(chr(int(body[i + 2 : i + 2 + n], 16)))
            i += 2 + n
        else:
            raise YamlLiteError(f"escape \\{e} is not supported")
    return "".join(out)


def _end_of_quoted(s: str, i: int) -> int:
    """Index just past the quoted scalar starting at s[i]."""
    q = s[i]
    j = i + 1
    while j < len(s):
        if q == '"' and s[j] == "\\":
            j += 2
            continue
        if s[j] == q:
            if q == "'" and s[j + 1 : j + 2] == "'":
                j += 2
                continue
            return j + 1
        j += 1
    raise YamlLiteError(f"unterminated quoted scalar in {s!r}")


def _quoted(token: str) -> str:
    if token[0] == "'":
        return token[1:-1].replace("''", "'")
    return _double_quoted(token[1:-1])


def _strip_comment(line: str) -> str:
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            i = _end_of_quoted(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _split_key(content: str):
    """(key text, rest) of 'key: rest' / 'key:', or None if not a mapping
    entry."""
    i = 0
    if content[:1] in "'\"":
        i = _end_of_quoted(content, 0)
        if content[i : i + 1] == ":" and content[i + 1 : i + 2] in ("", " "):
            return content[:i], content[i + 1 :].strip()
        return None
    while i < len(content):
        if content[i] == ":" and content[i + 1 : i + 2] in ("", " "):
            return content[:i].rstrip(), content[i + 1 :].strip()
        if content[i] in "[{":
            return None
        i += 1
    return None


class _Reader:
    def __init__(self, text: str):
        self.anchors: Dict[str, Any] = {}
        self.lines: List[Tuple[int, str]] = []
        for n, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            if body.startswith("\t"):
                raise YamlLiteError(f"line {n}: tab in indentation")
            content = _strip_comment(body)
            if not content:
                continue
            if content.startswith(("---", "...", "%")):
                raise YamlLiteError(f"line {n}: directives and document markers are not supported")
            self.lines.append((len(raw) - len(body), content))
        self.i = 0

    # -- inline nodes ------------------------------------------------------

    def _props(self, text: str):
        """(anchor, tag, rest) of a node's leading &anchor and !!tag."""
        anchor = tag = None
        while text[:1] in ("&", "!"):
            head, _, text = text.partition(" ")
            text = text.strip()
            if head[0] == "&":
                anchor = head[1:]
            else:
                tag = head
        return anchor, tag, text

    def inline(self, text: str) -> Any:
        anchor, tag, text = self._props(text)
        if text.startswith("*"):
            if anchor or tag or " " in text:
                raise YamlLiteError(f"alias {text!r} with properties or trailing text")
            if text[1:] not in self.anchors:
                raise YamlLiteError(f"unknown alias {text!r}")
            return self.anchors[text[1:]]
        if text[:1] in "[{":
            if tag:
                raise YamlLiteError(f"tag {tag} on a collection")
            value, end = self._flow(text, 0)
            if text[end:].strip():
                raise YamlLiteError(f"text after a flow collection: {text!r}")
        else:
            value = self._scalar(text, tag)
        if anchor:
            self.anchors[anchor] = value
        return value

    def _scalar(self, text: str, tag=None) -> Any:
        if text[:1] in "'\"":
            if _end_of_quoted(text, 0) != len(text):
                raise YamlLiteError(f"text after a quoted scalar: {text!r}")
            s = _quoted(text)
            return _tagged(tag, s) if tag else s
        if ": " in text or text.endswith(":") or " #" in text:
            raise YamlLiteError(f"plain scalar {text!r} is outside the supported subset")
        return _tagged(tag, text) if tag else resolve_plain(text)

    def _flow(self, s: str, i: int):
        """Flow collection at s[i] -> (value, index past it)."""
        close = "]" if s[i] == "[" else "}"
        out: Any = [] if close == "]" else {}
        i += 1
        while True:
            while i < len(s) and s[i] == " ":
                i += 1
            if i >= len(s):
                raise YamlLiteError(f"flow collection not closed on its line: {s!r}")
            if s[i] == close:
                return out, i + 1
            key, i = self._flow_node(s, i)
            if close == "}":
                while i < len(s) and s[i] == " ":
                    i += 1
                if s[i : i + 1] != ":":
                    raise YamlLiteError(f"flow mapping entry without ':' in {s!r}")
                value, i = self._flow_node(s, i + 1)
                out[key] = value
            else:
                out.append(key)
            while i < len(s) and s[i] == " ":
                i += 1
            if s[i : i + 1] == ",":
                i += 1
            elif s[i : i + 1] != close:
                raise YamlLiteError(f"expected ',' or {close!r} in {s!r}")

    def _flow_node(self, s: str, i: int):
        while i < len(s) and s[i] == " ":
            i += 1
        anchor = tag = None
        while s[i : i + 1] in ("&", "!"):
            j = i
            while j < len(s) and s[j] not in " ,]}":
                j += 1
            if s[i] == "&":
                anchor = s[i + 1 : j]
            else:
                tag = s[i:j]
            i = j
            while i < len(s) and s[i] == " ":
                i += 1
        if s[i : i + 1] in ("[", "{"):
            value, i = self._flow(s, i)
        elif s[i : i + 1] in ("'", '"'):
            j = _end_of_quoted(s, i)
            value, i = self._scalar(s[i:j], tag), j
        else:
            j = i
            while j < len(s) and s[j] not in ",]}" and not (s[j] == ":" and s[j + 1 : j + 2] in " ,]}"):
                j += 1
            text = s[i:j].strip()
            if text.startswith("*"):
                if text[1:] not in self.anchors:
                    raise YamlLiteError(f"unknown alias {text!r}")
                value = self.anchors[text[1:]]
            else:
                value = self._scalar(text, tag)
            i = j
        if anchor:
            self.anchors[anchor] = value
        return value, i

    # -- block nodes -------------------------------------------------------

    def block(self, indent: int) -> Any:
        if self.lines[self.i][1].startswith("- ") or self.lines[self.i][1] == "-":
            return self._sequence(indent)
        return self._mapping(indent)

    def _child(self, parent_indent: int, text: str, in_mapping: bool) -> Any:
        """The value of an entry whose inline part is ``text`` (properties
        only, or nothing): a block on the following lines, or null."""
        anchor, tag, rest = self._props(text)
        if rest:
            return self.inline(text)
        value = None
        if self.i < len(self.lines):
            ind, content = self.lines[self.i]
            is_seq = content.startswith("- ") or content == "-"
            if ind > parent_indent or (in_mapping and ind == parent_indent and is_seq):
                if tag:
                    raise YamlLiteError(f"tag {tag} on a collection")
                value = self.block(ind)
        if value is None and tag:
            value = _tagged(tag, "")
        if anchor:
            self.anchors[anchor] = value
        return value

    def _mapping(self, indent: int) -> dict:
        out: Dict[Any, Any] = {}
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlLiteError(f"unexpected indentation at {content!r}")
            if content.startswith("- ") or content == "-":
                break
            kv = _split_key(content)
            if kv is None:
                raise YamlLiteError(f"expected 'key: value', got {content!r}")
            key_text, rest = kv
            key = _quoted(key_text) if key_text[:1] in "'\"" else resolve_plain(key_text)
            self.i += 1
            out[key] = self._child(indent, rest, in_mapping=True)
        return out

    def _sequence(self, indent: int) -> list:
        out: List[Any] = []
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind != indent or not (content.startswith("- ") or content == "-"):
                if ind > indent:
                    raise YamlLiteError(f"unexpected indentation at {content!r}")
                break
            item = content[1:].strip()
            self.i += 1
            if item and item[:1] not in "'\"[{" and _split_key(item) is not None:
                raise YamlLiteError(f"a mapping inside a block sequence is not supported: {content!r}")
            out.append(self._child(indent, item, in_mapping=False))
        return out


def safe_load(text: str) -> Any:
    """Parse ``text``; what ``yaml.safe_load`` returns for the subset."""
    reader = _Reader(text)
    if not reader.lines:
        return None
    if len(reader.lines) == 1 and _split_key(reader.lines[0][1]) is None and not (
        reader.lines[0][1].startswith("- ")
    ):
        return reader.inline(reader.lines[0][1])
    value = reader.block(reader.lines[0][0])
    if reader.i != len(reader.lines):
        raise YamlLiteError(f"unexpected text at {reader.lines[reader.i][1]!r}")
    return value


def load_file(path: str) -> Any:
    with open(path) as f:
        return safe_load(f.read())
