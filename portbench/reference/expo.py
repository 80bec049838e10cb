"""A plain reader of the Prometheus text exposition format.

The benchmark's own parser, written from the format's description (one
sample a line: ``name{label="value",...} number``; ``#`` lines are
comments): it shares no code with the program's parser, so the answers it
judges are read independently of the code under test.
"""

from __future__ import annotations

import math

_ESCAPES = {"\\": "\\", '"': '"', "n": "\n"}


def _labels(text: str, i: int) -> tuple[dict[str, str], int]:
    """Parse ``{a="x",b="y"}`` starting at ``text[i] == '{'``; returns the
    labels and the index after the closing brace."""
    out: dict[str, str] = {}
    i += 1
    while True:
        while text[i] in " ,":
            i += 1
        if text[i] == "}":
            return out, i + 1
        eq = text.index("=", i)
        name = text[i:eq].strip()
        if text[eq + 1] != '"':
            raise ValueError(f"label {name!r} has no quoted value")
        j = eq + 2
        chars: list[str] = []
        while text[j] != '"':
            if text[j] == "\\":
                chars.append(_ESCAPES.get(text[j + 1], text[j + 1]))
                j += 2
            else:
                chars.append(text[j])
                j += 1
        out[name] = "".join(chars)
        i = j + 1


def _number(tok: str) -> float:
    low = tok.lower()
    if low in ("+inf", "inf"):
        return math.inf
    if low == "-inf":
        return -math.inf
    if low == "nan":
        return math.nan
    return float(tok)


def parse(text: str) -> list[tuple[str, dict[str, str], float]]:
    """Every sample of an exposition as ``(name, labels, value)``."""
    out = []
    for raw in text.split("\n"):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        brace = line.find("{")
        space = line.find(" ")
        if brace != -1 and (space == -1 or brace < space):
            name = line[:brace]
            labels, end = _labels(line, brace)
            rest = line[end:].split()
        else:
            name, *rest = line.split()
            labels = {}
        if not rest:
            raise ValueError(f"sample without a value: {line!r}")
        out.append((name, labels, _number(rest[0])))
    return out


def family(samples, name: str) -> dict[frozenset, float]:
    """One family's samples keyed by their label set."""
    return {frozenset(lab.items()): v for n, lab, v in samples if n == name}


def total(samples, name: str, match: dict[str, str] | None = None) -> float | None:
    """Sum of a family's samples whose labels include ``match``; None when
    no sample matches."""
    vals = [v for n, lab, v in samples
            if n == name and all(lab.get(k) == x for k, x in (match or {}).items())]
    return sum(vals) if vals else None
