"""The readers of the program's own spans (core/program_spans.py): a
traced CPU run reports the metrics that need no card, they agree with
the benchmark's own spans, and a trace ring that lost passes is read
over the passes it holds whole."""

from __future__ import annotations

import types

import pytest

from sdbench.core import harness, program_spans
from sdbench.core.spec import Spec

NO_CARD = ("sql_select_s", "sql_exact_s", "sql_files_s", "pairs_prepare_s", "pairs_blocks_s",
           "near_self_s", "components_s")


def test_a_traced_cpu_run_reports_the_program_spans(tiny_root):
    spec = Spec(tiny_root)
    r = harness.run_cell(spec, spec.cell("tiny.dedup"), 2**31 + 23, 1.0, True, "cpu")
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for name in NO_CARD:
        assert m[name] > 0, name
        assert r["metrics"][name]["unit"] == "s"
    # the card's metrics find nothing to read on the CPU
    assert "pairs_device_s" not in m and "pairs_idle_s" not in m
    sql = m["sql_select_s"] + m["sql_exact_s"] + m["sql_files_s"]
    assert abs(sql - m["dup_sql_s"]) <= max(0.1 * m["dup_sql_s"], 0.005)
    assert m["pairs_prepare_s"] + m["pairs_blocks_s"] <= m["near_pairs_s"]


def _rec(stage, pc0, seconds, span_id, parent_id=None, **fields):
    rec = {"stage": stage, "pc0": pc0, "seconds": seconds, "span_id": span_id,
           "parent_id": parent_id, "trace_id": "t"}
    if fields:
        rec["fields"] = fields
    return rec


def _passes(n):
    """n passes of 10 s, each with a 4 s `near` that holds two 1 s blocks
    (device_s 0.5 each), and the records in the order they ended."""
    recs = []
    for k in range(n):
        t = 100.0 + 20 * k
        recs += [_rec("duplicates.select", t + 1, 1, f"s{k}"),
                 _rec("duplicates.near.block", t + 3, 1, f"b{k}a", f"n{k}", device_s=0.5),
                 _rec("duplicates.near.block", t + 4.5, 1, f"b{k}b", f"n{k}", device_s=0.5),
                 _rec("duplicates.near", t + 2, 4, f"n{k}"),
                 _rec("duplicates", t, 10, f"d{k}")]
    return recs, [(100.0 + 20 * k - 0.5, 100.0 + 20 * k + 10.5) for k in range(n)]


@pytest.fixture
def ring(monkeypatch):
    """The program's trace ring, replaced by a list the test fills."""
    from spacedrive_tpu_torch.telemetry import trace

    held: list = []
    monkeypatch.setattr(trace, "recent", lambda trace_id=None: list(held))
    return held


def _full(monkeypatch, ring):
    """The ring as a full one, which has dropped its oldest records."""
    from spacedrive_tpu_torch.telemetry import trace

    monkeypatch.setattr(trace, "TRACE_RING", len(ring))


def test_a_ring_that_lost_passes_is_read_over_those_it_holds(ring, monkeypatch):
    recs, passes = _passes(3)
    ctx = types.SimpleNamespace(spans={"pass": passes}, trace=None)
    ring.extend(recs)
    assert program_spans.per_pass(ctx, "duplicates.near.block") == 2.0
    assert program_spans.self_per_pass(ctx, "duplicates.near") == 2.0
    assert program_spans.window(ctx)[1] == 3
    # the ring dropped the first pass's oldest records: that pass no longer
    # counts, and the two it holds whole give the same values a pass
    ring[:] = recs[2:] + [_rec("duplicates.select", 161, 3, "later")]
    _full(monkeypatch, ring)
    assert program_spans.window(ctx)[1] == 2
    assert program_spans.per_pass(ctx, "duplicates.near.block") == 2.0
    assert program_spans.per_pass(ctx, "duplicates.select") == 1.0
    assert program_spans.per_pass(
        ctx, "duplicates.near.block", lambda r: r["fields"]["device_s"]) == 1.0
    # a ring that holds no pass whole, or no records with pc0, gives None
    ring[:] = recs[-3:]
    _full(monkeypatch, ring)
    assert program_spans.per_pass(ctx, "duplicates.near.block") is None
    ring[:] = [{k: v for k, v in r.items() if k != "pc0"} for r in recs]
    assert program_spans.per_pass(ctx, "duplicates.near.block") is None
    assert program_spans.self_per_pass(ctx, "duplicates.near") is None


def test_the_readers_find_nothing_in_a_program_without_the_spans(tiny_root, ring):
    """A program that records no such spans (the benchmark laid over an
    older checkout): every reader returns None and none raises."""
    spec = Spec(tiny_root)
    _recs, passes = _passes(2)
    ring.append({"stage": "walk", "seconds": 1.0, "span_id": "w", "parent_id": None})
    for trace in (None, types.SimpleNamespace(busy_s=1.0, busy_within=lambda spans: 0.0)):
        ctx = types.SimpleNamespace(spans={"pass": passes}, trace=trace)
        for name in NO_CARD + ("pairs_device_s", "pairs_idle_s"):
            assert spec.reader(name)(ctx) is None, name
