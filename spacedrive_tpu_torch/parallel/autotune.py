"""Pipeline sizing constants read by the indexing pass.

Counterpart of the constants in `spacedrive_tpu/parallel/autotune.py`
(the one home for pipeline sizing there too). The live controller that
retunes them is not ported; these are its static top rungs.
"""

from __future__ import annotations

#: per-device cas dispatch pad rungs: a 5-file tail pads to 32 rows,
#: not 1024 (ops/cas.pack_canonical_batch packs against them)
BATCH_LADDER = (32, 256, 1024)

#: identifier host-window rows per device: one window is one hot-bucket
#: dispatch of the top ladder rung
IDENTIFY_DEVICE_WINDOW = BATCH_LADDER[-1]

#: thumbnail images per device resize call
THUMB_DEVICE_BATCH = 32

#: embedding images per device forward
EMBED_DEVICE_BATCH = 32

#: feeder read-ahead of a single-device pass: windows parked ahead of
#: the consumer (parallel/feeder.py)
FEEDER_BASE_DEPTH = 3
