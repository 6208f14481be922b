"""HLO text analysis: collective bytes + schedule for the roofline terms.

``cost_analysis()`` does not report collective traffic, so we parse the
compiled (post-SPMD) HLO text and sum operand bytes of every
all-gather / all-reduce / reduce-scatter / all-to-all / collective-permute.
Shapes in the partitioned module are PER-DEVICE, so the sums are per-device
wire bytes — exactly what the collective roofline term wants.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16, "token": 0,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
# op name appears right after the '=' result type, e.g.
#   %ag = bf16[2,128]{1,0} all-gather(bf16[1,128]{1,0} %p), dims=...
_OP_LINE_RE = re.compile(
    r"=\s*(?P<result>\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s*"
    r"(?P<op>" + "|".join(_COLLECTIVES) + r")(?:-start|-done)?\("
)


def shape_bytes(shape_str: str) -> int:
    """bytes of one 'dtype[d0,d1,...]' or tuple '(a, b, ...)' string."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int]
    count_by_op: Dict[str, int]
    schedule: List[Tuple[str, int]]      # (op, operand_bytes) in program order

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())


def collective_stats(hlo_text: str) -> CollectiveStats:
    bytes_by_op: Dict[str, int] = defaultdict(int)
    count_by_op: Dict[str, int] = defaultdict(int)
    schedule: List[Tuple[str, int]] = []
    for line in hlo_text.splitlines():
        m = _OP_LINE_RE.search(line)
        if not m:
            continue
        if "-done(" in line:
            continue  # async pair: count the -start only
        op = m.group("op")
        # operand bytes: shapes inside the call parens; fall back to result
        paren = line[m.end() - 1 :]
        depth = 0
        end = 0
        for i, ch in enumerate(paren):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        args = paren[1:end] if end else ""
        b = shape_bytes(args)
        if b == 0:
            b = shape_bytes(m.group("result"))
        bytes_by_op[op] += b
        count_by_op[op] += 1
        schedule.append((op, b))
    return CollectiveStats(dict(bytes_by_op), dict(count_by_op), schedule)


def dup_op_histogram(hlo_text: str, top: int = 12) -> List[Tuple[str, int]]:
    """Fusion-name histogram — a cheap remat/redundancy smell test."""
    counts: Dict[str, int] = defaultdict(int)
    for m in re.finditer(r"%(\w+?)(?:\.\d+)?\s*=", hlo_text):
        counts[m.group(1)] += 1
    return sorted(counts.items(), key=lambda kv: -kv[1])[:top]
