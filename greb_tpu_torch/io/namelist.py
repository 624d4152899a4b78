"""Minimal Fortran namelist reader/writer.

Supports the subset used by the reference configs (reference ``namelist``,
``namelist_original``, doc/namelist.md): ``&group ... /`` blocks,
``name = value`` with ``!`` comments, scalars (int/real/logical/string),
comma/space-separated arrays, and ``n*value`` repeat syntax.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List


def _parse_scalar(tok: str) -> Any:
    t = tok.strip()
    if not t:
        return None
    if (t[0] == '"' and t[-1] == '"') or (t[0] == "'" and t[-1] == "'"):
        return t[1:-1]
    low = t.lower()
    if low in (".true.", "t", ".t."):
        return True
    if low in (".false.", "f", ".f."):
        return False
    try:
        return int(t)
    except ValueError:
        pass
    try:
        # Fortran exponents: 1.d0 / 1.e0
        return float(low.replace("d", "e"))
    except ValueError:
        return t


def _parse_values(raw: str) -> Any:
    # split on commas or whitespace, outside quotes
    toks: List[str] = []
    buf, q = "", None
    for ch in raw:
        if q:
            buf += ch
            if ch == q:
                q = None
            continue
        if ch in "\"'":
            q = ch
            buf += ch
        elif ch in ", \t\n":
            if buf:
                toks.append(buf)
                buf = ""
        else:
            buf += ch
    if buf:
        toks.append(buf)

    vals: List[Any] = []
    for tok in toks:
        m = re.fullmatch(r"(\d+)\*(.+)", tok)
        if m and not tok.startswith(('"', "'")):
            vals.extend([_parse_scalar(m.group(2))] * int(m.group(1)))
        else:
            v = _parse_scalar(tok)
            if v is not None:
                vals.append(v)
    if len(vals) == 1:
        return vals[0]
    return vals


def _strip_comment(line: str) -> str:
    out, q = "", None
    for ch in line:
        if q:
            out += ch
            if ch == q:
                q = None
            continue
        if ch in "\"'":
            q = ch
            out += ch
        elif ch == "!":
            break
        else:
            out += ch
    return out


def parse_namelist(text: str) -> Dict[str, Dict[str, Any]]:
    groups: Dict[str, Dict[str, Any]] = {}
    current = None
    pending_key = None
    for raw_line in text.splitlines():
        line = _strip_comment(raw_line).strip()
        if not line:
            continue
        if line.startswith("&"):
            current = line[1:].strip().lower()
            groups.setdefault(current, {})
            pending_key = None
            continue
        if line in ("/", "&end", "$end"):
            current = None
            pending_key = None
            continue
        if current is None:
            continue
        # possibly multiple assignments per line; handle the common single case
        m = re.match(r"([A-Za-z_]\w*)\s*(\([^)]*\))?\s*=\s*(.*)", line)
        if m:
            key = m.group(1).lower()
            groups[current][key] = _parse_values(m.group(3))
            pending_key = key
        elif pending_key is not None:
            # continuation of an array value
            prev = groups[current][pending_key]
            more = _parse_values(line)
            prev_list = prev if isinstance(prev, list) else [prev]
            more_list = more if isinstance(more, list) else [more]
            groups[current][pending_key] = prev_list + more_list
    return groups


def read_namelist(path: str) -> Dict[str, Dict[str, Any]]:
    with open(path, "r") as f:
        return parse_namelist(f.read())


def write_namelist(groups: Dict[str, Dict[str, Any]], path: str) -> None:
    def fmt(v: Any) -> str:
        if isinstance(v, bool):
            return ".true." if v else ".false."
        if isinstance(v, str):
            return f'"{v}"'
        if isinstance(v, (list, tuple)):
            return ", ".join(fmt(x) for x in v)
        return repr(v)

    with open(path, "w") as f:
        for g, kv in groups.items():
            f.write(f"&{g.upper()}\n")
            for k, v in kv.items():
                f.write(f"{k} = {fmt(v)}\n")
            f.write("/\n")
