"""GML (Graph Modelling Language) parsing.

The reference loads network graphs with igraph's GML reader
(src/main/routing/topology.c:326-360). We parse the same dialect
ourselves — the format is a simple recursive `key value` / `key [ ... ]`
structure — so the framework has no external graph-library dependency.

Supported value types: integers, floats, double-quoted strings (with
backslash escapes), and nested lists. Comments start with `#` outside
strings. Keys can repeat (e.g. many `node [...]` blocks).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterator, Union

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<comment>\#[^\n]*)
      | (?P<string>"(?:[^"\\]|\\.)*")
      | (?P<lbracket>\[)
      | (?P<rbracket>\])
      | (?P<number>[+-]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
      | (?P<key>[A-Za-z_][A-Za-z0-9_]*)
    )
    """,
    re.VERBOSE,
)

Value = Union[int, float, str, "GmlRecord"]


class GmlError(ValueError):
    pass


class GmlRecord:
    """An ordered multimap of key -> values (keys may repeat)."""

    def __init__(self):
        self._items: list[tuple[str, Value]] = []

    def add(self, key: str, value: Value) -> None:
        self._items.append((key, value))

    def get(self, key: str, default=None) -> Value:
        for k, v in self._items:
            if k == key:
                return v
        return default

    def get_all(self, key: str) -> list[Value]:
        return [v for k, v in self._items if k == key]

    def __contains__(self, key: str) -> bool:
        return any(k == key for k, _ in self._items)

    def items(self) -> Iterator[tuple[str, Value]]:
        return iter(self._items)

    def __repr__(self) -> str:
        return f"GmlRecord({self._items!r})"


def _tokenize(text: str) -> Iterator[tuple[str, str]]:
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                return
            raise GmlError(f"bad GML syntax at offset {pos}: "
                           f"{text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "comment":
            continue
        yield kind, m.group(kind)
    return


def _parse_record(tokens: Iterator[tuple[str, str]], depth: int) -> GmlRecord:
    rec = GmlRecord()
    for kind, tok in tokens:
        if kind == "rbracket":
            if depth == 0:
                raise GmlError("unbalanced ']'")
            return rec
        if kind != "key":
            raise GmlError(f"expected key, got {tok!r}")
        key = tok
        try:
            vkind, vtok = next(tokens)
        except StopIteration:
            raise GmlError(f"key {key!r} has no value") from None
        if vkind == "lbracket":
            rec.add(key, _parse_record(tokens, depth + 1))
        elif vkind == "string":
            rec.add(key, vtok[1:-1].replace('\\"', '"').replace("\\\\", "\\"))
        elif vkind == "number":
            try:
                rec.add(key, int(vtok))
            except ValueError:
                rec.add(key, float(vtok))
        elif vkind == "key":
            # bare words (GML allows unquoted constants like `directed 0`
            # only as numbers, but be permissive and keep the word)
            rec.add(key, vtok)
        else:
            raise GmlError(f"unexpected value token {vtok!r} for key {key!r}")
    if depth != 0:
        raise GmlError("unbalanced '['")
    return rec


@dataclass
class GmlGraph:
    directed: bool = False
    nodes: list[GmlRecord] = field(default_factory=list)
    edges: list[GmlRecord] = field(default_factory=list)
    attrs: GmlRecord = field(default_factory=GmlRecord)


def parse_gml(text: str) -> GmlGraph:
    top = _parse_record(_tokenize(text), 0)
    graph = top.get("graph")
    if not isinstance(graph, GmlRecord):
        raise GmlError("no 'graph [...]' block found")
    out = GmlGraph(attrs=graph)
    out.directed = bool(graph.get("directed", 0))
    for node in graph.get_all("node"):
        if not isinstance(node, GmlRecord):
            raise GmlError("'node' must be a [...] block")
        if "id" not in node:
            raise GmlError("node missing required 'id'")
        out.nodes.append(node)
    for edge in graph.get_all("edge"):
        if not isinstance(edge, GmlRecord):
            raise GmlError("'edge' must be a [...] block")
        if "source" not in edge or "target" not in edge:
            raise GmlError("edge missing required 'source'/'target'")
        out.edges.append(edge)
    return out
