"""The comparison of a duplicates pass with the plain reference.

Three numbers, each against its limit. All three are exact comparisons,
so each limit is 0: a sound program reads 0 on every seed, and the
control (the reference with the candidate filter of a multi-index hash)
reads thousands of near groups off (`PERF.md` gives the readings).

- `near_groups_diff`: near groups in the answer and not in the
  reference, plus the reverse (a multiset difference of id sets);
- `exact_groups_diff`: the same for the exact groups, with any group of
  another kind counted here too;
- `file_rows_diff`: groups whose file rows differ from those of their
  objects, as a multiset of (name, extension, materialized_path, cas_id,
  size_in_bytes).
"""

from __future__ import annotations

import collections
from typing import Any

from sdbench.reference import dedup as _ref

LIMITS = {"near_groups_diff": 0, "exact_groups_diff": 0, "file_rows_diff": 0}


def expect(data: Any, arg: dict[str, Any], device: Any) -> _ref.Expected:
    """The reference's answer to the traffic's call `arg` over `data`."""
    return _ref.expect(data, int(arg["threshold"]), device)


def _diff(a: collections.Counter, b: collections.Counter) -> int:
    return sum((a - b).values()) + sum((b - a).values())


def judge(answer: list[dict[str, Any]], expected: Any) -> dict[str, int]:
    """The three numbers for one pass's `answer` against `expected` (a
    `reference.dedup.Expected`)."""
    near: collections.Counter = collections.Counter()
    exact: collections.Counter = collections.Counter()
    stray = 0
    files_off = 0
    for g in answer:
        ids = frozenset(g["object_ids"])
        if g.get("kind") == "near":
            near[ids] += 1
        elif g.get("kind") == "exact":
            exact[ids] += 1
        else:
            stray += 1
        got = sorted(tuple(f.get(k) for k in _ref.FILE_KEYS) for f in g.get("files", ()))
        want = [expected.file_row(o) for o in g["object_ids"]]
        if None in want or got != sorted(want):
            files_off += 1
    return {
        "near_groups_diff": _diff(near, expected.near),
        "exact_groups_diff": _diff(exact, expected.exact) + stray,
        "file_rows_diff": files_off,
    }
