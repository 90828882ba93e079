"""Minimal JSON-path editing for constraint input files (a copy of
morphablegraphs_tpu.utils.jsonpath, which is host Python).

Replaces reference examples/jsonpath_wrapper.py (used to tweak input files
between runs): dotted/indexed paths like
"elementaryActions[0].constraints[0].trajectoryConstraints[2].position".
"""

from __future__ import annotations

import re
from typing import Any, List, Union

_TOKEN = re.compile(r"([^.\[\]]+)|\[(-?\d+)\]")


def _tokens(path: str) -> List[Union[str, int]]:
    out: List[Union[str, int]] = []
    for name, idx in _TOKEN.findall(path):
        out.append(int(idx) if idx != "" else name)
    return out


def get_value(data: Any, path: str) -> Any:
    cur = data
    for t in _tokens(path):
        cur = cur[t]
    return cur


def set_value(data: Any, path: str, value: Any) -> Any:
    toks = _tokens(path)
    cur = data
    for t in toks[:-1]:
        cur = cur[t]
    cur[toks[-1]] = value
    return data


def delete_value(data: Any, path: str) -> Any:
    toks = _tokens(path)
    cur = data
    for t in toks[:-1]:
        cur = cur[t]
    del cur[toks[-1]]
    return data
