"""A run with the timed path broken underneath comes out not correct,
once for each fault that a duplicates pass can have. The harness's look
for a card is skipped (the run is on the CPU at 4,096 files); the rest
of a run is as on the card: the Node, the router, the window, the
reference and the check. A one-card cell has no exchange between chips
to leave out."""

from __future__ import annotations

import pytest

from sdbench.core import harness
from sdbench.core.spec import Spec

from spacedrive_tpu_torch.object import duplicates
from spacedrive_tpu_torch.ops import phash_torch


def run(root, seed=2**31 + 3):
    spec = Spec(root)
    return harness.run_cell(spec, spec.cell("tiny.dedup"), seed, 0.5, False, "cpu")


def test_sound_run_is_correct(tiny_root):
    r = run(tiny_root)
    assert r["correct"] is True
    assert all(c["value"] == 0 for c in r["checks"].values())


def _unchanged(orig):
    """The pass answers as if nothing had been found: no groups."""
    def fn(*args, **kwargs):
        orig(*args, **kwargs)
        return []
    return ("object.duplicates", "find_duplicates", fn)


def _half_batch(orig):
    """Half of the hashes left out of the pair search."""
    def fn(hashes, threshold, device="cuda"):
        return orig(hashes[: len(hashes) // 2], threshold, device)
    return ("ops.phash_torch", "near_pairs", fn)


def _altered_pair(orig):
    """One pair altered where it is produced."""
    def fn(hashes, threshold, device="cuda"):
        for k, (a, b) in enumerate(orig(hashes, threshold, device)):
            yield (a, (b + 1) % len(hashes)) if k == 0 else (a, b)
    return ("ops.phash_torch", "near_pairs", fn)


def _altered_file_row(orig):
    """One file row of the answer altered."""
    def fn(*args, **kwargs):
        out = orig(*args, **kwargs)
        out[0]["files"][0] = dict(out[0]["files"][0], name="IMG_wrong")
        return out
    return ("object.duplicates", "find_duplicates", fn)


MODULES = {"object.duplicates": duplicates, "ops.phash_torch": phash_torch}


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_pair, _altered_file_row])
def test_fault_is_not_correct(tiny_root, monkeypatch, fault):
    mod_name, attr, _fn = fault(None)
    mod = MODULES[mod_name]
    _m, _a, broken = fault(getattr(mod, attr))
    monkeypatch.setattr(mod, attr, broken)
    r = run(tiny_root)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
