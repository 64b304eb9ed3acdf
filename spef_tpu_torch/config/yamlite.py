"""The YAML subset experiment configs use, read and written without PyYAML.

Experiment ``config.yaml`` files are nested block mappings whose leaves are
scalars (int, float, bool, null, plain or quoted strings) or lists (block
``- item`` sequences or flow ``[a, b]``).  That is all this module parses;
anything else raises ``ValueError``.  ``safe_load`` and ``safe_dump`` keep
PyYAML's names so :mod:`spef_tpu_torch.config.node` reads like its JAX twin.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

__all__ = ["safe_load", "safe_dump"]

_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")


def _scalar(text: str) -> Any:
    s = text.strip()
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s in ("true", "True", "TRUE"):
        return True
    if s in ("false", "False", "FALSE"):
        return False
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        return body.replace("''", "'") if s[0] == "'" else body.replace('\\"', '"')
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [_scalar(v) for v in inner.split(",")] if inner else []
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    if s in (".inf", "+.inf"):
        return float("inf")
    if s == "-.inf":
        return float("-inf")
    return s


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"tab indentation is not supported: {raw!r}")
        out.append((len(line) - len(line.lstrip(" ")), line.strip()))
    return out


def _block(lines: List[Tuple[int, str]], i: int, indent: int) -> Tuple[Any, int]:
    """Parse the mapping or sequence whose items sit at ``indent``."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        seq: List[Any] = []
        while i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("-"):
            item = lines[i][1][1:].strip()
            if not item:
                raise ValueError("nested block sequences are not supported")
            seq.append(_scalar(item))
            i += 1
        return seq, i
    mapping: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        text = lines[i][1]
        if ":" not in text:
            raise ValueError(f"expected 'key: value', got {text!r}")
        key, _, rest = text.partition(":")
        key = key.strip()
        rest = rest.strip()
        i += 1
        if rest:
            mapping[key] = _scalar(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            mapping[key], i = _block(lines, i, lines[i][0])
        else:
            mapping[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return mapping, i


def safe_load(stream) -> Any:
    """Parse a config document from a string or a text file object."""
    text = stream if isinstance(stream, str) else stream.read()
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"could not parse past {lines[i][1]!r}")
    return value


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    if s == "" or s != s.strip() or _scalar(s) != s or any(c in s for c in ":#[]{},'\""):
        return "'" + s.replace("'", "''") + "'"
    return s


def safe_dump(data: Dict[str, Any], default_flow_style: bool = False,
              sort_keys: bool = False) -> str:
    """Block-style dump of a nested mapping of scalars and lists."""
    del default_flow_style  # always block style, as PyYAML gives with False

    def emit(d: Dict[str, Any], indent: int) -> List[str]:
        out = []
        for k in (sorted(d) if sort_keys else d):
            v = d[k]
            pad = " " * indent
            if isinstance(v, dict):
                out.append(f"{pad}{k}:")
                out.extend(emit(v, indent + 2))
            elif isinstance(v, (list, tuple)):
                if not v:
                    out.append(f"{pad}{k}: []")
                else:
                    out.append(f"{pad}{k}:")
                    out.extend(f"{pad}- {_dump_scalar(x)}" for x in v)
            else:
                out.append(f"{pad}{k}: {_dump_scalar(v)}")
        return out

    return "\n".join(emit(data, 0)) + "\n"
