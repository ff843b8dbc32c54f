"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phase 1 checks for a CUDA device, prints its name and power limit, and
builds the BLAKE3 chunk kernel (K1) from the sources in this checkout.
Phase 2 holds K1 bit for bit against its plain torch version on the
card at every small cas bucket (32 rows), at the 1024-row x 57-chunk
hot bucket and at the validator's 1024-row x 256-chunk bucket, checks
rows against the pure-Python reference, times K1 and the plain version
with CUDA events, and counts the instructions of K1's block loop in the
built kernel's SASS (`cuobjdump -sass`) for a bound by count. Phase 3 builds
a corpus from the seed (4,096 files: 3,072 over 100 KiB, 768 over the
small buckets, 256 JPEG/PNG images), runs the indexing pass
(`index_pass`, device="cuda") and checks its cas_ids against the plain
path on the card and the reference on the host, its thumbnails against
their expected dimensions, and its embeddings. Phase 4 runs the library
path (`python -m spacedrive_tpu_torch index --library`: a Node on the
card, IndexerJob → FileIdentifierJob → MediaProcessorJob on its job
system, K1 launched from the identifier's window pipeline, the images
sent to the node's thumbnailer actor and embedded) over the phase-3
corpus plus 16,384 small files, three times: a cold scan (cas_ids
against phase 3, the plain path and the reference; objects, duplicates
and journal entries checked; each image's webp, media_data row,
embedding, search-index vector and journal vouches checked against
phase 3), a warm rescan of the unchanged tree (K1 must not launch, the
media job must do nothing, no webp may change), and an incremental
rescan after 32 in-place rewrites, 16 additions (4 of them images) and
16 deletions. Phase 5 runs the library's read side on phase 4's library:
16 near-duplicate images are added and scanned, ObjectValidatorJob
writes every file's integrity_checksum (K1 on buckets of 1-256 chunks,
the host C hasher for the rest; held against the host hasher and the
reference), `duplicates` and `search` run through their CLI helpers
(pHash bits against the plain CPU path, planted pairs grouped, exact
groups against the DB after one object is split in two; semantic, name
and label queries), and
`near_pairs` and the scorer run at 262,144 seeded hashes and vectors
against host references (`near_pairs` through H1, the pair-search
kernel, against its plain torch path too, and on a 4096 x 2^20 block,
timed; the `kernels` line gains H1's entry). Phase 6 runs the labeler: LabelerNet at full
width (seeded weights) on 16 seeded 224² images on the card against the
CPU in bf16 (decisions may flip only within 0.35 ± 0.05), timed at batch
16 and 256 with CUDA events and traced with torch.profiler; `labeler
provision --bundled` into phase 4's data dir and one more `index
--library`, whose label rows must equal a CPU forward on the actor's
decoded inputs and which search filters by; and a CNN and a YOLOv8-layout
ONNX graph on the card against the CPU in float32 with the TF32 globals
off and on, then `labeler provision --from model.onnx` and one actor
batch. Phases 4-5 scan with no labeler model provisioned, so the
node's labeler skips their images. Phase 7 trains the labeler: (a) one
full-width `train_step` (224², batch 8) on the card against the CPU
from one seeded `create_train_state` (loss, every gradient, the
parameters after the step), then steps at batch 64 timed with CUDA
events and one traced with torch.profiler; (b) a user's run: 720
rendered scenes in a folder per kind, `labeler train` on the card at
the TrainConfig defaults (600 steps), then `index --library` of 48
held-out renders, whose labels must name their kind and equal a CPU
forward of the saved checkpoint; (c) the resize, the embedder and the
scorer with the TF32 globals on, against the CPU. After each of phases
2-7 no degradation counter may have moved (`check_healthy`; the
process pool's errors, retries and restarts among them): those phases
run with no fault plan, and the autotune controller is live in every
Node they start. Phase 8 is the device seam on the one
card: (a) cas_ids over slot lists `[cuda:0] * k`, k = 1-4, at 1024 x 57
rows per slot and at row counts that leave pad rows, against the
single-device path and the reference, K1 timed per slot count, the
resize and the embedder at k = 2 and 4 against k = 1, and the sharded
Hamming matrix; (b) `index_pass` again over every 8th of phase 3's
files of each kind (hard links taken before phase 4; a cut for the time
limit) under four injected faults, whose results must
be phase 3's, with the planned activations, one feeder restart, a cas
fallback and the one-device ladder's end level; one more injected K1
failure at the shipped reset_timeout, after which the retry and the
next call must hash on the card at the ladder's last rung, never on the
CPU; a host-ranked query on phase 5's index; a thumbnailer chunk forced past the ladder to the CPU
resize; (c) the hardware inventory against `nvidia-smi` and a profiled
identify job whose trace names K1; it prints the identify dispatch rows
the autotune rung cap allows at the ladder's end level. Phase 9 is the
host execution plane, with the ladder and the autotune controller
reset first: (a) `index --library` then `duplicates` over every 8th
image and every 4th other file of phase 3's (the hard links; a cut for
the time limit) and four near copies, on fresh data dirs, with
`SD_PROCS=0` and with `SD_PROCS=min(8, cpu_count)` (the controller
live in both): every planted pair in a near group; cas_ids, objects,
media_data rows, pHash bits, duplicate groups and webp bytes equal,
embeddings within 1e-5; the pool's worker gauge at N while it
is up, at least one ok job per embed chunk and pHash row, and no pool
error, retry or restart; (b) the pooled `duplicates` again, on a copy
taken before it, under `procpool.worker:crash:times=1`: one restart, a
retried job, the same groups and bits; (c) a FileIdentifierJob over
the un-identified copy of (a)'s library, every fetch stalled past the
controller's urgent wait, with a 0.2 s tick and the static window cut
to 16 rows: at least 8 windows, the window widened, the depth
deepened, decisions on the `autotune` ring and counter, the ids of
(a); then `SD_AUTOTUNE=0`: the static sizes and the same ids. Phase 10
is the other decoders, with the ladder and the controller reset first:
it prints which kinds this host decodes (`{"decoders": ...}`: PDF
always; SVG, HEIF and video where librsvg, libheif and libav or cv2 are
found; a kind found but not decoded fails), builds a seeded corpus of
each available kind (64 PDFs of six layouts, 32 SVG/SVGZ, 32 AVIFs
written by PIL, the committed clip, its tkhd-rotated copy and 14
cover-art MPEG audio files, 32 JPEGs), decodes it on the host per kind
(seconds printed), times the card resize of every frame, and runs
`index --library` on the card over it: cas_ids against the plain path
(K1 launched), a webp per file at its dims, each card frame within 1
level of the `[cpu]` resize and stored as its encode, film strips on
clips and none on cover art, video media_data rows equal to
`VideoMetadata.to_row`, vectors for the image rows only (HEIF's within
1e-5 of a CPU embed) and the journal's vouches; then a warm rescan
with 0 K1 launches, 0 thumbnails and 0 media work, and `check_healthy`
by delta. It prints `{"other_decoders": ...}`.
Phase 11 is the node's control plane and its rspc API, with the ladder
and the controller reset first: a Node on the card over phase 4's data
dir (20,496 rows with vectors and labels after phases 5-6), driven
through `node.router`: `nodeState` names the card and the provisioned
labeler; `search.paths` paged in full by name and by size (each row
once, in order), `library.statistics` and `kindStatistics` against
COUNT(*), `search.semantic` of a phase-3 image (itself first, cosine
>= 0.9999), `search.duplicates` against `find_duplicates` and
`labels.list` against the label table (the size key has no index, as
in JAX; the port pages by size at rest through an order cached per
library DB, so only the first two pages cost a pass over every row);
ten pages by size with a write to the library DB before each (each
takes the SQL path, as a page does while a job writes), timed; then
`library.create` and
`locations.create` over a new ~512-file location (phase 3's size mix,
32 JPEGs, 4 near copies), waited on through `jobs.isActive` with a
bound: K1 launched, cas_ids against the plain path on the CPU,
JobProgress events, invalidations of `search.paths`, `locations.list`
and `labels.list` and a completion notification on the node bus; a
`locations.fullRescan` with 0 K1 launches; `files.validate` against
the host hasher; round trips of `preferences.update/get`,
`toggleFeatureFlag`, `tags.create/assign` and `backups.backup/getAll`;
`check_healthy` by delta. It prints `{"api": ...}` with its seconds by
step.
Phase 12 is the observability plane (trace context, spans, the host
sampler), with the ladder, the controller and the port's telemetry
reset first: a Node on the card with the sampler on (its default rate)
creates a new library and a ~256-file location through the router
(phase 3's size mix: 192 files of 101-512 KiB, 48 small, 16 JPEGs of
640-4032 px): one trace id must hold `walk`, `identify.hash`,
`identify.db`, `task.dispatch`, `feeder.fetch`, `thumbnail.decode`,
`thumbnail.device` and `thumbnail.encode`; K1 launched; cas_ids against
the plain path on the CPU (8 also against `blake3_ref`); the
`identify.hash` spans no longer than the identifier's hash seconds;
`telemetry.trace_export` Chrome-trace JSON with every `X` event's dur >=
0; `telemetry.profile` with samples, `device_dispatch` among its frame
groups, and the sampler's self-measured overhead under 0.05; the text of
`telemetry.debug_bundle` without the node's identity hex or a planted
secret `SD_*` value. Then the same corpus into a second data dir with
`SD_PROFILE=0`: no sampler, equal cas_ids and webp bytes; `check_healthy`
by delta. It prints `{"observability": ...}` with its seconds by step,
span counts and seconds by stage, the sampler's samples, state and
group shares and overhead.
Phase 13 is the node's samplers and verdicts, with the ladder, the
controller and the port's telemetry reset first, the history writer
and the resource sampler at 0.1 s, its Nodes as users run them (the serve
layer on): phase 12's size mix scanned through
the router on a new Node and data dir, three times. (1) A clean scan,
the attribution of the pass (`telemetry.attrib`) partitions its window
(the unrounded sweep to 1e-9 s), and the identify job's pass (the spans
between its markers) covers >= 0.9 of its wall time; `telemetry.health`
healthy, `device` unknown (one card dispatches no sharded part) and
`serve` healthy, `feeder`, `event_loop`, `resilience` and `slo`
neither degraded nor unhealthy; `pass_throughput` not breached;
`telemetry.tenants` with the library as the serve surface's one tenant,
`telemetry.serve` enabled with JAX's keys, the gate normal and no class
shed, `telemetry.mesh` this node alone; the resource gauges above 0 and >= 5 history records
with the allowlist's keys. (2)
A scan under `feeder.fetch:stall:delay_s=0.4`: its `link` bucket >= 0.3
s and above `device` and `host_cpu`. (3) With `SD_HISTORY=0`,
`SD_RESOURCES=0` and `SD_TENANT_OBS=0`, traced with torch.profiler
(CUDA activity only): cas_ids and webp bytes equal the clean scan's, no
history record, no resource sampler; the card's busy seconds in the
trace (merged kernel, memcpy and memset intervals) beside the scan's
attribution window. Every scan's
cas_ids against the plain path on the CPU (8 also against
`blake3_ref`); `check_healthy` by delta for the clean and quiet scans.
It prints `{"verdicts": ...}`.
Phase 14 is the live location, with the ladder and the controller reset
first: a Node on the card (without the labeler) over phase 4's data dir,
whose libraries' locations it watches through inotify (required), takes
a seeded burst, each step settled before the next (no unpaired move
half, no debounced flush or size roll-up, no flush in flight,
`jobs.isActive` false). (a) One rename timed to its row, then the 256
images of `images/` renamed, `small/` (16,384 files) renamed and an empty
folder made: K1 launched no time and nothing rehashed, every row keeps
its id and object, and the watcher ring's burst record shows the
window widened to 2 s. (b) One new file timed to its cas_id, then 63
more (16 JPEG/PNG of 640-4032 px, 32 of 101-512 KiB, 16 under 16 KiB), a
64-file directory moved in and 32 files rewritten in place (16 at their
size, 16 grown): K1 launched, 128 files hashed on the card and 32 by
dirty range, cas_ids against the plain path on the card and blake3_ref
(one child process per core), thumbnails at their dimensions, embeddings
and media_data. (c) 32 files and a directory removed: their rows and
journal rows gone; after the orphan remover's `invoke`, no object
without a file_path and no journal row without its path. (d) A second
location through `locations.create`, then through the router
`files.copyFiles` of 16 images into it (its watcher's rescan launches K1,
the copies link to their sources' objects, the object count holds),
`cutFiles` of 8, `deleteFiles` of 8 and `eraseFiles` of 4 within the
first (no rescan of the erased location starts); every fs job
completes. (e) `ephemeralFiles.list` of 32 JPEGs outside every location:
cas_ids against blake3_ref and the plain path, the ephemeral thumbnails
resized on the card at their dimensions. (f) `locations.fullRescan` of
both locations: K1 launched no time, both media jobs idle, and the
file_path rows by (location, path, name, extension, is_dir, size,
cas_id, object_id) unchanged. (g) No ERROR record of the location,
job or object loggers, every job of the phase completed, the watchers
settled, `check_healthy` by delta. It prints `{"live_location": ...}`
with the seconds and K1 launches of each step and the latency from an
event to its row (a rename) and to its cas_id (a new file).
Phase 15 is the replica, run on phase 14's Node before it shuts down,
its watchers still running. (a) Where the host has the `cryptography`
package (else the line says so and (a) is skipped): FileEncryptorJob
over 32 of phase 4's files (16 over 100 KiB, 8 JPEGs, 8 under 16 KiB,
each kind from one directory) through the Node's job manager; each
`.sdenc` reaches the library through the watcher with a cas_id from K1
on the card (against the plain path and blake3_ref); `files.cutFiles` moves them into a new
sibling directory and FileDecryptorJob decrypts them there: each
plaintext equals its original byte for byte, gets its cas_id bit for
bit and links to its object (no new object); then `keys.unlock`,
`keys.add` (automount), `keys.state` and a wrong-password retry that
leaves the vault unlocked and every key mounted, through the router at
the standard Argon2id profile. (b) The owner backfills (the pairing
owner's step), a second Node on the card on its own data dir joins the
library as JAX's `p2p/pairing.py:132-200` writes a joined library
(same id, each instance holding the other's row), and its IngestActor
pulls the op log through a loopback transport over the owner's
`get_ops`, 1,000 ops a request, its `on_applied` refreshing the
joiner's vector index: every model of `SYNC_MODELS` holds the same rows
on both sides by sync id and synced values; a second pull applies 0
ops; the join launches K1 no time and runs the embedder no time;
`search.semantic` of 8 images gives the owner's objects with scores
within 1e-5. Then the joiner tags 16 objects and notes one through its
router, the owner's IngestActor pulls them back, and both sides hold
equal rows again; no ERROR record, `check_healthy` by delta. It prints
`{"replica": ...}` with the op count by model, the ingest's ops/s, the
write-combined transactions and the seconds of each step.
Phase 16 is the p2p transport, on its own `P2P` instances and
identities on 127.0.0.1 (no Node), with the ladder and the controller
reset first. (a) Two instances find each other by unicast
`MdnsDiscovery` beacons; the sender takes >= 32 MiB of phase 3's files
from the snapshot (the largest, 4 more over 100 KiB and 8 under it),
computes each one's cas_id with `cas.cas_id_cpu`, opens a stream with
`P2P.new_stream` and sends them by Spaceblock over Noise XX under a
SPACEDROP header that carries its trace; the receiver, in a span under
that trace, reads the received files' sampled messages and hashes them
with `cas.cas_ids` on the card (K1 launched): equal bytes, cas_ids
equal bit for bit, the span's trace id the sender's. (b) A local
`RelayServer` introduces `RelayClient`s: 8 MiB over the hole-punched
UDP stream (a direct stream, no pipe spliced) and 8 MiB from a client
with punching off over the relay's splice, each acknowledged by the
BLAKE3 of what the receiver read (host C hasher); `check_healthy` by
delta. (c) `p2p.connect:reset:times=1` fails one dial with
ConnectionResetError and the next opens; `p2p.write:reset:times=1`
fails a punched stream's write with UdpStreamError, poisons its reader
and puts `stream_failed` on the `p2p` ring; the degradation counters
move by those 2 fault activations alone. It prints `{"p2p": ...}` with
the MB/s of (a) and (b) and the seconds of each step.
Phase 17 is the node's p2p, on two port Nodes on the card (A and B,
without the labeler), their P2P managers attached on 127.0.0.1 with
unicast beacons and every stream Noise over TCP, with the ladder and
the controller reset first; K1's launches are told apart by the Node
whose identifier window made them. (a) A indexes 64 of 80 files taken
evenly from phase 3's snapshot (hard links) through K1; B joins A's library by
`p2p.pairLibrary` through its router and A consents by
`p2p.acceptPairing` through its own; B's rows equal A's on every row
and field A's op log carries (phase 15's comparison), and the join
launches K1 no time. (b) A indexes 16 more of them through K1; B
converges by the SYNC alert and its pull alone, launching K1 no time.
The media job writes media_data rows without an op, as JAX's does, so
B gets those of (a)'s images from A's backfill at the join and not the
new image's: rows no op carries are counted (`uncarried`), and may be
media_data rows only. (c) A sends >= 8 MiB of
its files (most over 100 KiB, 4 under) to B by `p2p.spacedrop` under a
trace, B accepts by `p2p.acceptSpacedrop`; the bytes arrive equal, B's
receive span is in A's trace, and B indexes the received folder into a
library of its own through K1 on the card: its cas_ids equal A's rows
bit for bit. (d) `check_healthy` by delta, then one
`p2p.sync_serve:vanish` activation, armed as B's next pull starts,
fails that pull once: the sync policy retries it and B converges on
A's new tag; the degradation counters move by that one activation. It
prints `{"node_p2p": ...}` with the seconds of each step, the join's
ops/s and the Spacedrop's MB/s.
Phase 18 is cloud sync, with the ladder and the controller reset
first: a port `CloudRelay` on 127.0.0.1 in this process and two port
Nodes on the card (A and B, without the labeler), their P2P managers
on 127.0.0.1 with discovery disabled, so the relay is their only route.
(a) A indexes 64 of 80 files taken evenly from phase 3's snapshot (hard
links) through K1; B holds A's library as a joined library is written
(phase 15's `_join_library`); both set the relay's origin and enable
cloud sync through their routers (`cloud.setApiOrigin`,
`cloud.sync.enable`); A backfills; B's rows equal A's on what A's op
log carries (phase 17's comparison, media_data counted), K1 launched
no time for B, and `cloud.sync.state` shows A's pushed ops and B's
received collections and ingested ops. (b) A indexes the 16 others
through K1; they reach B by A's push and B's poll alone, K1 launched
no time for B. (c) One `relay.http:500` and one `relay.http:truncate`
activation, armed as B's next pull starts (A's requests held back
meanwhile), fail two attempts of that pull, which the relay policy
retries: `sd_resilience_retries_total` rises by >= 2, B converges on
A's new tag, and the degradation counters move by those 2 activations
alone. (d) B's `refresh_federation(force=True)` pushes its snapshot and
A's, which reaches no peer directly, stores it with `transport ==
"relay"`. It prints `{"cloud_sync": ...}` with the ops A pushed, the
collections B received, B's ingest ops/s and the seconds of each step.

Phase 19 is the HTTP API host, with the ladder and the controller reset
first: a port Node on the card (without the labeler, p2p off) serves
`start_api` on 127.0.0.1:0, driven through the port's own HTTP and
websocket client (utils/http.py). (a) `POST /rspc/locations.create`
indexes 64 files taken evenly from phase 3's snapshot (56 others, 8
images; hard links) while a websocket subscribed to
`invalidation.listen` and `jobs.progress` receives the job's progress
and the `search.paths` / `locations.list` invalidations; K1 launches for
this Node's identifier windows alone (`_K1Owners`), every cas_id equals
the plain path's and `blake3_ref`'s, and the media job embeds on the
card. (b) `search.paths` by a new tag, posted twice: `X-SD-Cache: miss`
then `hit` with the same bytes; after `tags.assign` on 8 objects the
same query misses and returns those 8. (c) `GET /search?q=<an indexed
image>` embeds the query on the card and ranks the image first, its
score within 1e-5 of the in-process router's `search.semantic`. (d) A
thumbnail's bytes equal its file in the store; a 64 KiB `Range` read of
the largest file answers 206 with the exact bytes and `Content-Range`.
After the scan the interactive class's latency SLO is `ok` over the
Node's history, `telemetry.serve` is enabled with JAX's keys, the gate
normal and no class shed, and `/health` answers 200 with `serve`
healthy. (e) On the Node's own (default) policy, the interactive budget
is held on purpose through the gate's `admit`, then 24 cache-cold reads
sent at once answer 429 with `Retry-After: 1` (a full queue, or its
deadline), `/health` polled throughout never answers 503, the gate is
in brownout after it with `serve` degraded, and `/metrics` counts the
24 sheds. (f) After the Node shuts down, the mobile bridge
(`mobile.handle_core_msg` on the card) answers (b)'s query on the same
data dir with (b)'s rows. It prints `{"api_serve": ...}` with each
step's seconds, the launches, the websocket frames and the sheds.
Phase 20 is the mesh work plane and the execution continuum, with the
ladder, the controller and the telemetry reset first: two port Nodes
on the card (A and B, without the labeler), their P2P managers on
127.0.0.1 with unicast beacons and every stream Noise over TCP, B
joined to A's library by `p2p.pairLibrary` and A's consent, and a solo
port Node on the card with p2p off; all three read one folder of 64
files taken evenly from phase 3's snapshot (56 others, 8 images; hard
links). K1's launches are told apart by the Node whose identifier
window or mesh identify shard made them. (a) A's
`distribute_location_index` with 8 files a shard: B executes identify
shards (`sd_work_shards_total{result="completed_remote"}` > 0), K1
launches on A, B and the solo Node, every cas_id equals `blake3_ref`,
and A's rows, object grouping and journal vouches equal the solo
Node's pass through the same entry point. (b) A's
`distribute_location_stages` of thumb, media.extract, phash and embed:
B executes stage shards; webp bytes, media_data rows and pHash bits
equal the solo pass's, vectors within 1e-5 (the largest |d| and
whether they matched bit for bit printed), and `check_healthy` by
delta. (c) 16 more files, distributed in shards of 2 under
`p2p.steal:vanish` with a 2 s lease clamp: B vanishes with its lease,
A re-pools it at the deadline and ends with the solo pass's rows,
objects and journal; the degradation counters move by that one
activation. It prints `{"mesh_work": ...}` with each step's seconds,
the shards by executor, the per-stage files/s of `rates_report` and
K1's launches by Node.

Any failed check exits non-zero. Without a CUDA device the script exits
non-zero before any work. The last line of standard output is
{"ok": true, "device": {...}}; the line before it is the card's
`nvidia-smi` name and power limit, and earlier lines carry the kernel
table, the pass's stage times, the read side's, the labeler's, the
training's, the device seam's, the execution plane's, the other
decoders', the API's, the observability plane's, the verdicts', the
live location's, the replica's, the p2p transport's, the node's p2p's,
cloud sync's, the API host's and the mesh work plane's numbers, and
each phase's wall seconds, as JSON.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import io
import json
import logging
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor

_T_START = time.perf_counter()  # the smoke's wall clock, from before torch loads

import numpy as np
import torch

# H100 SXM: 132 SMs with 64 INT32 lanes each (NVIDIA Hopper white paper);
# HBM3 at 3.35 TB/s (data sheet). The clock is read from the card.
SMS = 132
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
# 32-bit instructions of one compression on sm_90: 7 rounds x 8 G x 12,
# plus the 8 output xors. Each half of G is a = a+b+m (one three-input
# IADD3), d ^= a, d >>>= 16 or 8 (one PRMT byte permute), c += d,
# b ^= c, b >>>= 12 or 7 (one SHF funnel shift): 6 instructions, all on
# the integer pipe of 64 lanes per SM.
OPS_PER_BLOCK = 7 * 8 * 12 + 8
# POPC issues at 16 a clock on an sm_90 SM (the CUDA programming guide's
# throughput table). H1 spends at least one on a pair: its filter on one
# 32-bit half rejects most pairs after one, a pair it passes takes two
POPC_PER_SM, POPC_PER_PAIR = 16, 1
# the benchmark's count of a pair (sdbench/core/roofline.py): a 64-term
# ±1 dot product, 128 operations, against the int8 dense peak
OPS_PER_PAIR, INT8_OPS_PER_S = 128, 1979e12

DEVICE = "cuda"
# the corpus: a 1M-file library cut to 4,096 files for the time limit;
# each hash dispatch keeps the production shape (1024 rows x 57 chunks)
N_LARGE, N_SMALL, N_IMAGES = 3072, 768, 256
LONG_SIDE = (640, 4032)
# the validator's largest bucket: DEVICE_BATCH rows of 256 chunks
VALIDATOR_ROWS, VALIDATOR_CHUNKS = 1024, 256


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of `fn` over `reps` runs, each bracketed by
    CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# --- phase 2: K1 against its plain version --------------------------------


def packed_batch(rng, lengths, chunks):
    """Random messages of `lengths` packed as the cas path packs them:
    uint8 [rows, chunks*1024] with zero tails, int32 lengths."""
    from spacedrive_tpu_torch.ops import cas

    msgs = [rng.bytes(n) for n in lengths]
    return msgs, cas.pack_canonical_batch(msgs, chunks)


def phase_kernel(rng, sm_clock_hz: float) -> dict:
    from spacedrive_tpu_torch.ops import blake3_cuda, blake3_ref, blake3_torch, cas

    dev = torch.device(DEVICE)

    def hold(rows: int, c: int, lengths: list[int], what: str = "") -> tuple[int, tuple]:
        """K1 against its plain version on messages of `lengths` packed
        into `rows` x `c` chunks, and 16 rows' digests against blake3_ref;
        returns the largest difference and the lanes."""
        msgs, (arr, lens) = packed_batch(rng, lengths, c)
        check(arr.shape[0] == rows, f"pack gave {arr.shape[0]} rows, want {rows}")
        words = blake3_torch.host_words(arr).to(dev)
        lanes, _ = blake3_torch.chunk_lanes(words, torch.from_numpy(lens).to(dev), c)
        k1 = blake3_cuda.chunk_cvs(*lanes)
        plain = blake3_torch.chunk_cvs_plain(*lanes)
        torch.cuda.synchronize()
        err = int((k1.to(torch.int64) - plain.to(torch.int64)).abs().max())
        check(torch.equal(k1, plain), f"K1 differs from its plain version at {rows}x{c}")
        hexes = blake3_torch.words_to_hex(blake3_torch.hash_batch(words, lens, c, dev), 64)
        for i in sorted(rng.choice(len(msgs), 16, replace=False)):
            check(hexes[i] == blake3_ref.blake3_hex(msgs[i]),
                  f"row {i} (len {len(msgs[i])}) of {rows}x{c} differs from blake3_ref")
        print(f"phase 2: K1 == plain at {rows} rows x {c} chunks{what}; 16 rows == blake3_ref",
              flush=True)
        return err, lanes

    max_err = 0
    for rows, c in [(32, c) for c in cas.SMALL_BUCKETS] + [(1024, cas.LARGE_CHUNKS)]:
        cap = c * 1024
        edges = [0, 1, 63, 64, 65, 1023, 1024, 1025, cap - 1, cap, max(0, cap - 1024), cap // 2]
        edges = sorted({n for n in edges if n <= cap})
        n_real = rows - 4  # the last rows stay pad rows (length 1, zero byte)
        lengths = edges + [int(x) for x in rng.integers(0, cap + 1, n_real - len(edges))]
        max_err = max(max_err, hold(rows, c, lengths)[0])

    # the validator's largest shape: 1024 rows x 256 chunks (whole files
    # of up to 256 KiB), random lengths with every 1024*k and 1024*k+1
    rows, c = VALIDATOR_ROWS, VALIDATOR_CHUNKS
    cap = c * 1024
    edges = sorted({n for k in range(c + 1) for n in (1024 * k, 1024 * k + 1) if 0 < n <= cap})
    lengths = edges + [int(x) for x in rng.integers(1, cap + 1, rows - len(edges))]
    err, lanes = hold(rows, c, lengths, f" (the validator's largest bucket; lengths 1024k and "
                                        f"1024k+1 for k = 0..{c})")
    max_err = max(max_err, err)
    validator_ms = cuda_ms(lambda: blake3_cuda.chunk_cvs(*lanes), reps=20)
    validator_plain_ms = cuda_ms(lambda: blake3_torch.chunk_cvs_plain(*lanes), reps=3, warmup=1)
    validator_bound = k1_bound(lanes, sm_clock_hz)

    # timing at the hot shape with production data: 1024 sampled
    # messages of 57,352 bytes (56 full chunks and one 8-byte chunk)
    rows, c = 1024, cas.LARGE_CHUNKS
    _, (arr, lens) = packed_batch(rng, [cas.LARGE_MSG_LEN] * rows, c)
    words = blake3_torch.host_words(arr).to(dev)
    lanes, _ = blake3_torch.chunk_lanes(words, torch.from_numpy(lens).to(dev), c)
    check(torch.equal(blake3_cuda.chunk_cvs(*lanes), blake3_torch.chunk_cvs_plain(*lanes)),
          "K1 differs from its plain version on the hot batch")
    k1_ms = cuda_ms(lambda: blake3_cuda.chunk_cvs(*lanes), reps=50)
    plain_ms = cuda_ms(lambda: blake3_torch.chunk_cvs_plain(*lanes), reps=20, warmup=1)
    hot = k1_bound(lanes, sm_clock_hz)
    sass = k1_sass_count()
    by_count = hot["active_blocks"] * sass["loop_cycles_per_lane_block"] / (SMS * sm_clock_hz) * 1e3
    print(json.dumps({"hot_shape": hot, "validator_shape": validator_bound, "k1_sass": sass,
                      "k1_bound_by_count_ms": by_count,
                      "k1_share_of_bound_by_count": by_count / k1_ms}), flush=True)
    torch_ops_ms(dev, blake3_torch._as_u32(blake3_cuda.chunk_cvs(*lanes)).T.reshape(rows, c, 8))
    return {
        "name": "blake3_chunk_cvs",
        "route": "cuda",
        "source": "spacedrive_tpu_torch/ops/csrc/blake3_chunk.cu",
        "replaces": "spacedrive_tpu/ops/blake3_pallas.py:165",
        "parity": "bit-identical",
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": hot["bound_ms"],
        "bound_by": hot["bound_by"],
        "bound_ms_by_count": by_count,
        "ms_1024x256": validator_ms,
        "plain_ms_1024x256": validator_plain_ms,
        "bound_ms_1024x256": validator_bound["bound_ms"],
        "library_ms": None,
    }


def k1_bound(lanes, sm_clock_hz: float) -> dict:
    """K1's least time for these lanes, derived: the larger of the
    integer operations of the active blocks (OPS_PER_BLOCK each) over the
    card's INT32 lanes and the bytes (words and lane vectors in, CVs
    out) over HBM."""
    chunk_len = lanes[1].to(torch.int64)
    active_blocks = int(((chunk_len + 63) // 64).clamp(min=1).sum())
    n = lanes[0].shape[0]
    ops = active_blocks * OPS_PER_BLOCK
    nbytes = n * 1024 + 3 * n * 4 + 8 * n * 4
    ops_ms = ops / (SMS * INT32_LANES_PER_SM * sm_clock_hz) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"lanes": n, "active_blocks": active_blocks, "ops": ops, "bytes": nbytes,
            "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


# SASS opcodes that issue to the 32-bit integer pipes (64 lanes per SM
# on sm_90, the CUDA programming guide's throughput table)
INT_OPCODES = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT", "IMAD", "IMUL",
               "LEA", "ISETP", "SEL", "IMNMX", "IABS", "BMSK", "POPC", "FLO", "BREV"}
NON_ISSUE = {"NOP"}


def k1_sass_count() -> dict:
    """Count the instructions of K1's block loop (one compression: 7
    rounds x 8 G plus the output xors) in the built kernel's SASS
    (`cuobjdump -sass` of the extension). The loop is the range closed
    by the kernel's backward branch. Returns the opcode counts, the
    integer-pipe instructions per G, and the cycles one lane-block costs
    an SM: the larger of its integer instructions over 64 lanes and all
    its instructions over the SM's issue rate of 4 warp instructions (128
    lanes) a clock."""
    import glob
    import re
    import shutil

    from spacedrive_tpu_torch.ops import blake3_cuda

    so = sorted(glob.glob(os.path.join(blake3_cuda.BUILD_DIR, "blake3_chunk", "*.so")))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(bool(so), "no built K1 extension to disassemble")
    out = subprocess.run([tool, "-sass", so[0]], capture_output=True, text=True, check=True,
                         timeout=120).stdout
    body = out[out.index("blake3_chunk_cvs_kernel"):]
    end = body.find("Function :", 10)
    body = body if end < 0 else body[:end]
    instrs = []  # (address, opcode, text)
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;/]*?)\s*;", body):
        text = m.group(2).strip()
        tokens = [t for t in text.split() if not t.startswith("@")]
        if tokens:
            instrs.append((int(m.group(1), 16), tokens[0].split(".")[0], text))
    loops = []
    for addr, op, text in instrs:
        target = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)`\s*)?(0x[0-9a-f]+)", text)
        if op == "BRA" and target and int(target.group(1), 16) < addr:
            loops.append((int(target.group(1), 16), addr))
    # the block loop; if the disassembly shows none, the whole kernel
    lo, hi = max(loops, key=lambda r: r[1] - r[0]) if loops else (0, instrs[-1][0])
    ops: dict[str, int] = {}
    for addr, op, _ in instrs:
        if lo <= addr <= hi and op not in NON_ISSUE:
            ops[op] = ops.get(op, 0) + 1
    total = sum(ops.values())
    int_ops = sum(n for op, n in ops.items() if op in INT_OPCODES)
    g_per_block = 7 * 8
    return {"loop_found": bool(loops), "loop_instructions": total, "loop_int_instructions": int_ops,
            "int_per_g": int_ops / g_per_block, "derived_int_per_g": 12,
            "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1])),
            "loop_cycles_per_lane_block": max(int_ops / INT32_LANES_PER_SM, total / 128)}


def torch_ops_ms(dev, cvs) -> None:
    """Time the torch ops beside K1 on the main path (the XLA programs
    of the JAX package, ported as torch ops, not kernels) at the pass's
    shapes, for the breakdown: the tree reduce of one hot window, one
    resize call of 32 canvases of the 1024 bucket, one embed forward of
    32 images."""
    from spacedrive_tpu_torch.models import embedder
    from spacedrive_tpu_torch.ops import blake3_torch, thumbnail_torch

    gen = torch.Generator(device=dev).manual_seed(0)
    n_chunks = torch.full((cvs.shape[0],), cvs.shape[1], dtype=torch.int64, device=dev)
    canvases = torch.randint(0, 256, (32, 1024, 1024, 4), dtype=torch.uint8, device=dev,
                             generator=gen)
    scales = torch.full((32, 2), 512 / 1024, dtype=torch.float32, device=dev)
    images = torch.rand((32, embedder.IMAGE_SIZE, embedder.IMAGE_SIZE, 3), device=dev,
                        generator=gen)
    model = embedder.PatchPoolEmbedder(dev)
    with torch.no_grad():
        print(json.dumps({"torch_ops_ms": {
            "tree_reduce_1024x57": cuda_ms(lambda: blake3_torch._tree_reduce(cvs, n_chunks), 20),
            "resize_32x1024x1024_to_512": cuda_ms(
                lambda: thumbnail_torch._resize_canvases(canvases, scales, 512, 512), 10),
            "embed_forward_32": cuda_ms(lambda: model(images), 20),
        }}), flush=True)


# --- phase 3: the indexing pass -------------------------------------------

ASPECTS = [(1, 1), (4, 3), (3, 2), (16, 9)]
WIDE = [(5, 1), (6, 1)]  # beyond 4:1: the host resize path


def _image(args) -> tuple[str, int, int, int]:
    """Write one smooth seeded image (gradients plus coarse noise, so the
    encoders stay fast); returns (path, width, height, exif orientation)."""
    from PIL import Image

    path, w, h, seed, fmt, orientation = args
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    base = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.uint16)
    yy, xx = np.mgrid[0:h, 0:w]
    base[..., 0] += (xx * 64 // w).astype(np.uint16)
    base[..., 1] += (yy * 64 // h).astype(np.uint16)
    img = Image.fromarray(np.clip(base, 0, 255).astype(np.uint8))
    if fmt == "jpg":
        exif = Image.Exif()
        exif[0x0112] = orientation
        img.save(path, "JPEG", quality=90, exif=exif.tobytes())
    else:
        img.save(path, "PNG", compress_level=1)
    return path, w, h, orientation


def build_corpus(root: str, rng) -> tuple[list[tuple[str, int]], list[tuple[str, int, int, int]]]:
    """4,096 files: 3,072 of 101 KiB-512 KiB (log-uniform sizes), 768
    over the small buckets (0-byte and the 102399/102400/102401 edges
    included), 256 images. Returns the (path, size) of the non-images
    and the (path, w, h, orientation) of the images."""
    from spacedrive_tpu_torch.ops import cas

    files = []
    large = np.exp(rng.uniform(np.log(101 * 1024), np.log(512 * 1024), N_LARGE)).astype(int)
    specials = [0, 0, 1, 102399, 102400, 102401, 1023, 1024, 1025, 57352]
    small = list(specials)
    lo = 0
    per = (N_SMALL - len(specials)) // len(cas.SMALL_BUCKETS)
    for c in cas.SMALL_BUCKETS:
        hi = min(c * 1024 - 8, cas.MINIMUM_FILE_SIZE)
        small += [int(x) for x in rng.integers(lo, hi + 1, per)]
        lo = hi + 1
    small += [int(x) for x in rng.integers(0, cas.MINIMUM_FILE_SIZE + 1, N_SMALL - len(small))]
    for i, size in enumerate(list(large) + small):
        d = os.path.join(root, f"d{i % 16:02d}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"f{i:05d}.bin")
        with open(path, "wb") as f:
            f.write(rng.bytes(int(size)))
        files.append((path, int(size)))

    jobs = []
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    for i in range(N_IMAGES):
        if i < 8:
            aw, ah = WIDE[i % 2]
            long_side = int(rng.integers(1280, 2049))
        else:
            aw, ah = ASPECTS[i % 4]
            long_side = int(np.exp(rng.uniform(np.log(LONG_SIDE[0]), np.log(LONG_SIDE[1]))))
        w, h = long_side, max(1, long_side * ah // aw)
        if i % 2:  # portrait form
            w, h = h, w
        fmt = "jpg" if i % 3 else "png"
        orientation = (1, 6, 8, 3)[i % 4] if fmt == "jpg" else 1
        jobs.append((os.path.join(img_dir, f"img{i:03d}.{fmt}"), w, h, int(rng.integers(1 << 30)),
                     fmt, orientation))
    with ThreadPoolExecutor(8) as pool:
        images = list(pool.map(_image, jobs))
    return files, images


def plain_cas_ids(messages: list[bytes]) -> list[str]:
    """cas_ids through the plain torch chunk stage on the card."""
    from spacedrive_tpu_torch.ops import blake3_torch, cas

    out: list[str | None] = [None] * len(messages)
    buckets: dict[int, list[int]] = {}
    for i, m in enumerate(messages):
        c = cas.LARGE_CHUNKS if len(m) == cas.LARGE_MSG_LEN else cas._bucket_for(len(m))
        buckets.setdefault(c, []).append(i)
    for c, idx in buckets.items():
        for off in range(0, len(idx), cas.DEVICE_BATCH):
            part = idx[off:off + cas.DEVICE_BATCH]
            arr, lens = cas.pack_canonical_batch([messages[i] for i in part], c)
            words = blake3_torch.hash_batch(arr, lens, c, DEVICE, blake3_torch.chunk_cvs_plain)
            for i, hx in zip(part, blake3_torch.words_to_hex(words[:len(part)], 16)):
                out[i] = hx
    return out  # type: ignore[return-value]


def phase_pass(rng, tmp: str) -> dict:
    from PIL import Image

    from spacedrive_tpu_torch.index_pass import index_pass
    from spacedrive_tpu_torch.models import embedder
    from spacedrive_tpu_torch.object.media.thumbnail import process
    from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore
    from spacedrive_tpu_torch.ops import blake3_cuda, cas, embed_torch, thumbnail_torch

    corpus = os.path.join(tmp, "corpus")
    data_dir = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    files, images = build_corpus(corpus, rng)
    print(f"phase 3: corpus of {len(files) + len(images)} files in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    blake3_cuda.chunk_cvs.launches = 0
    result = index_pass(corpus, data_dir, device=DEVICE, keep_pixels=True)
    launches = blake3_cuda.chunk_cvs.launches
    summary = result.summary
    print(json.dumps(summary), flush=True)
    n_files = len(files) + len(images)
    check(summary["files"] == n_files, f"pass saw {summary['files']} files, want {n_files}")
    check(launches > 0, "the pass launched K1 no time")

    # every cas_id against the plain chunk stage on the card
    sized = files + [(p, os.path.getsize(p)) for p, *_ in images]
    hashed = [(p, s) for p, s in sized if s > 0]
    msgs = [cas.read_message(p, s) for p, s in hashed]
    plain = plain_cas_ids(msgs)
    for (p, _), want in zip(hashed, plain):
        check(result.cas_ids[p] == want, f"cas_id of {p} differs from the plain path")
    for p, s in sized:
        if s == 0:
            check(result.cas_ids[p] is None, f"empty file {p} got a cas_id")
    # 64 random files against the pure-Python reference on the host
    for i in rng.choice(len(hashed), 64, replace=False):
        p, s = hashed[i]
        check(result.cas_ids[p] == cas.cas_id_cpu(p, s), f"cas_id of {p} differs from blake3_ref")
    print(f"phase 3: {len(hashed)} cas_ids == plain path on the card; 64 == blake3_ref", flush=True)

    # every image has its thumbnail, at scale_dimensions after orientation
    store = ThumbnailStore(data_dir)
    for path, w, h, orientation in images:
        cas_id = result.cas_ids[path]
        webp = store.path_for(None, cas_id)
        check(os.path.exists(webp), f"no thumbnail for {path}")
        tw, th = thumbnail_torch.scale_dimensions(w, h)
        if orientation in (5, 6, 7, 8):
            tw, th = th, tw
        with Image.open(webp) as im:
            check(im.size == (tw, th), f"thumbnail of {path} is {im.size}, want {(tw, th)}")
    check(summary["thumbnails"] == len(images), "thumbnail count")
    # a few device resizes against the same resize on the host (±1 level)
    small_imgs = sorted(
        (im for im in images if max(im[1], im[2]) <= 4 * min(im[1], im[2])),
        key=lambda im: im[1] * im[2],
    )[8:16]
    decoded = [process.decode_image(p) for p, *_ in small_imgs]
    host = thumbnail_torch.resize_batch([d.array for d in decoded], [d.target for d in decoded],
                                        device="cpu")
    resize_err = 0
    for (p, *_), want in zip(small_imgs, host):
        got = result.resized[result.cas_ids[p]]
        check(got.shape == want.shape, f"resized {p}: {got.shape} vs {want.shape}")
        resize_err = max(resize_err, int(np.abs(got.astype(int) - want.astype(int)).max()))
    check(resize_err <= 1, f"device resize differs from the host by {resize_err} levels")

    # embeddings: [128] float32, finite; a few against the CPU forward
    check(len(result.embeddings) == len(images), "embedding count")
    for vec in result.embeddings.values():
        check(vec.shape == (embedder.EMBED_DIM,) and vec.dtype == np.float32
              and bool(np.isfinite(vec).all()), "embedding is not a finite [128] float32")
    planes = np.stack([embedder.decode_image(p) for p, *_ in small_imgs])
    host_vecs = embed_torch.embed_batch(planes, "cpu")  # the reference forward
    for (p, *_), want in zip(small_imgs, host_vecs):
        check(np.allclose(result.embeddings[result.cas_ids[p]], want, atol=1e-5, rtol=1e-5),
              f"embedding of {p} differs from the CPU forward")
    print(f"phase 3: {len(images)} thumbnails at their dims (resize vs host max |d| "
          f"{resize_err}); {len(result.embeddings)} embeddings finite", flush=True)

    t = result.timings
    seconds = summary["seconds"]
    stages = {
        "files_per_s": n_files / seconds,
        "seconds": seconds,
        "k1_launches": launches,
        "thumbnails": summary["thumbnails"],
        "timings_s": t,
        "identify_read_share": t["read"] / t["identify"],
        "identify_hash_wait_share": t["hash_wait"] / t["identify"],
        "identify_dispatch_share": t["dispatch"] / t["identify"],
    }
    print(json.dumps({"pass": stages}), flush=True)
    return {"launches": launches, "corpus": corpus, "data_dir": data_dir,
            "cas_ids": result.cas_ids, "images": images, "embeddings": result.embeddings,
            "resized": result.resized,
            "large": [p for p, s in files if s > cas.MINIMUM_FILE_SIZE]}


# --- phase 4: the library path ------------------------------------------------

# a 1M-file library cut to ~20k file_path rows for the time limit; the
# file widths (1 B-16 KiB small files, 101-512 KiB large ones, the
# 1024 x 57-chunk hot dispatch) stay
N_LIB_SMALL = 16_384
LIBRARY_CUT = ("a 1M-file library cut to the phase-3 corpus plus 16,384 small files "
               "(~20.5k file_path rows) for the time limit")


def add_small_files(root: str, rng) -> list[str]:
    """16,384 files of 1 B-16 KiB (log-uniform sizes) in 64 directories;
    a quarter repeat the bytes of another of them."""
    n_dup = N_LIB_SMALL // 4
    sizes = np.exp(rng.uniform(0, np.log(16 * 1024), N_LIB_SMALL - n_dup)).astype(int)
    datas = [rng.bytes(int(s)) for s in sizes]
    datas += [datas[int(i)] for i in rng.integers(0, len(datas), n_dup)]
    paths = []
    for i, data in enumerate(datas):
        d = os.path.join(root, "small", f"s{i % 64:02d}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"m{i:05d}.dat")
        with open(path, "wb") as f:
            f.write(data)
        paths.append(path)
    return paths


def library_rows(data_dir: str) -> dict:
    """The smoke library's file rows, journal rows by key, the last
    indexer, identifier and media job rows, media_data and
    object_embedding rows, and the search sidecar's object ids."""
    from spacedrive_tpu_torch.node.library import Libraries

    (lib,) = Libraries(data_dir).load_all()
    try:
        out = {
            "lib_id": str(lib.id),
            "rows": lib.db.query("SELECT * FROM file_path WHERE is_dir = 0"),
            "journal": {(r["materialized_path"], r["name"], r["extension"]): r
                        for r in lib.db.query("SELECT * FROM index_journal")},
            "jobs": lib.db.query("SELECT * FROM job ORDER BY date_created DESC, rowid DESC "
                                 "LIMIT 3")[::-1],
            "media_data": lib.db.query("SELECT * FROM media_data"),
            "embeddings": lib.db.query("SELECT * FROM object_embedding"),
        }
        with open(lib.db.path + ".searchidx/meta.json", encoding="utf-8") as f:
            out["sidecar_ids"] = json.load(f)["ids"]
    finally:
        lib.close()
    return out


def webp_files(data_dir: str) -> dict[str, tuple[int, int]]:
    """{webp path: (size, mtime_ns)} under the library's thumbnail store."""
    out = {}
    for dirpath, _, files in os.walk(os.path.join(data_dir, "thumbnails")):
        for f in files:
            if f.endswith(".webp"):
                st = os.stat(os.path.join(dirpath, f))
                out[os.path.join(dirpath, f)] = (st.st_size, st.st_mtime_ns)
    return out


def run_library_pass(corpus: str, data_dir: str) -> dict:
    """One `index --library` run on the card (`cli.index_library` on a
    Node on DEVICE, which the smoke builds to read its stage seconds),
    with K1's launch count set to 0 just before it and read just after;
    returns its numbers."""
    import asyncio
    from datetime import datetime

    from spacedrive_tpu_torch.cli import index_library
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    node = Node(data_dir, device=DEVICE)
    node.config.config.p2p.enabled = False
    blake3_cuda.chunk_cvs.launches = 0
    t0 = time.perf_counter()
    summary = asyncio.run(index_library(corpus, data_dir, "smoke", DEVICE, node=node))
    wall = time.perf_counter() - t0
    launches = blake3_cuda.chunk_cvs.launches
    th = node.thumbnailer
    actor_s, generated, thumb_errors, job_s = th.stage_seconds, th.generated, th.errors, \
        node.stage_seconds
    lb = node.image_labeler
    labeler = {"labeled": lb.labeled, "skipped": lb.skipped, "errors": lb.errors,
               "forwards": lb.forwards, "stage_s": dict(lb.stage_seconds)}
    got = library_rows(data_dir)
    jobs = got["jobs"]
    check([j["name"] for j in jobs] == ["indexer", "file_identifier", "media_processor"]
          and all(j["status"] == 2 for j in jobs), f"library jobs did not complete: {jobs}")
    meta = [unpackb(j["metadata"]) for j in jobs]
    secs = [(datetime.fromisoformat(j["date_completed"])
             - datetime.fromisoformat(j["date_started"])).total_seconds() for j in jobs]
    ident, media = meta[1], meta[2]
    return {
        **got, "summary": summary, "indexer": meta[0], "identifier": ident, "media": media,
        "launches": launches, "generated": generated, "labeler": labeler,
        "numbers": {
            "files": summary["files"],
            "files_per_s": summary["files"] / wall,
            "seconds": wall,
            "indexer_s": secs[0],
            "indexer_walk_s": meta[0]["scan_read_time"],
            "indexer_db_s": meta[0]["db_write_time"],
            "identifier_s": secs[1],
            "identifier_read_s": ident["read_time"],
            "identifier_rehash_s": ident["rehash_time"],
            "identifier_dispatch_s": ident["dispatch_time"],
            "identifier_hash_wait_s": ident["hash_wait_time"],
            "identifier_db_s": ident["db_time"],
            "media_s": secs[2],
            "thumb_decode_s": actor_s["decode"],
            "thumb_device_s": actor_s["device"],
            "thumb_encode_s": actor_s["encode"],
            "thumb_batch_s": actor_s["batch"],
            "media_data_s": job_s.get("media_data", 0.0),
            "embed_decode_s": job_s.get("embed_decode", 0.0),
            "embed_forward_s": job_s.get("embed_forward", 0.0),
            "embed_write_s": job_s.get("embed_write", 0.0),
            "k1_launches": launches,
            "device_files": ident["device_files"],
            "walk_journal_hits": meta[0].get("journal_hit", 0),
            "identifier_journal_hits": ident["journal_hits"],
            "dirty_range_rehash": ident["journal_dirty_rehash"],
            "thumbnails_dispatched": media["thumbnails_dispatched"],
            "thumbnails_generated": generated,
            "thumbnail_errors": thumb_errors,
            "media_data_extracted": media["media_data_extracted"],
            "embeddings_written": media["embeddings_written"],
            "labeled": lb.labeled,
            "labeler_skipped": lb.skipped,
        },
    }


def _row_path(corpus: str, r: dict) -> str:
    name = r["name"] + (f".{r['extension']}" if r["extension"] else "")
    return os.path.join(corpus, r["materialized_path"].strip("/"), name)


def rewrite_in_place(path: str) -> None:
    """Flip 64 bytes inside the first sample range (same length) and
    move the mtime on, as an editor saving in place would."""
    from spacedrive_tpu_torch.ops import cas

    off = cas.HEADER_OR_FOOTER_SIZE + 100
    with open(path, "r+b") as f:
        f.seek(off)
        old = f.read(64)
        f.seek(off)
        f.write(bytes(b ^ 0x5A for b in old))
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))


def check_media(cold: dict, p3: dict, data_dir: str, rng) -> None:
    """The cold scan's media job against phase 3: a webp per image at
    `scale_dimensions` after orientation, within a mean 1 level of phase
    3's thumbnail of the same cas_id; a media_data row per image with
    its written resolution; an embedding per image allclose 1e-5 to
    phase 3's (8 also to the CPU forward); the search sidecar; and the
    journal's thumb, embed and media vouches."""
    from PIL import Image

    from spacedrive_tpu_torch.models import embedder
    from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore
    from spacedrive_tpu_torch.ops import embed_torch, thumbnail_torch
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    images = p3["images"]
    n = len(images)
    by_path = {_row_path(p3["corpus"], r): r for r in cold["rows"]}
    cas_of_object = {r["object_id"]: r["cas_id"] for r in cold["rows"] if r["object_id"]}
    dims_of_cas = {by_path[p]["cas_id"]: (w, h) for p, w, h, _ in images}
    media = cold["media"]
    check(media["thumbnails_dispatched"] == n and cold["generated"] == n,
          f"{media['thumbnails_dispatched']} thumbnails dispatched, {cold['generated']} written, "
          f"want {n}")
    check(media["media_data_extracted"] == n and media["embeddings_written"] == n,
          f"media job metadata {media}, want {n} media_data rows and {n} embeddings")

    store = ThumbnailStore(os.path.join(data_dir, "thumbnails"))
    p3_store = ThumbnailStore(p3["data_dir"])
    mean_d, max_d = 0.0, 0
    for path, w, h, orientation in images:
        row = by_path[path]
        cas_id = row["cas_id"]
        webp = store.path_for(cold["lib_id"], cas_id)
        check(os.path.exists(webp), f"no library thumbnail for {path}")
        tw, th = thumbnail_torch.scale_dimensions(w, h)
        if orientation in (5, 6, 7, 8):
            tw, th = th, tw
        with Image.open(webp) as im:
            check(im.size == (tw, th), f"library thumbnail of {path} is {im.size}, want {(tw, th)}")
            got = np.asarray(im.convert("RGBA"), np.int16)
        with Image.open(p3_store.path_for(None, cas_id)) as im:
            want = np.asarray(im.convert("RGBA"), np.int16)
        d = np.abs(got - want)
        mean_d, max_d = max(mean_d, float(d.mean())), max(max_d, int(d.max()))
        payload = unpackb(cold["journal"][(row["materialized_path"], row["name"],
                                           row["extension"])]["payload"])
        check(payload.get("thumb") is True and payload.get("embed") is True
              and isinstance(payload.get("media"), str) and payload["media"] != "",
              f"journal entry of {path} does not vouch thumb, embed and media: {payload}")
    check(mean_d <= 1.0, f"a library thumbnail differs from phase 3's by mean |d| {mean_d}")

    check(len(cold["media_data"]) == n, f"{len(cold['media_data'])} media_data rows, want {n}")
    for r in cold["media_data"]:
        want = list(dims_of_cas[cas_of_object[r["object_id"]]])
        check(unpackb(r["resolution"]) == want, f"media_data resolution {r['resolution']} != {want}")

    check(len(cold["embeddings"]) == n, f"{len(cold['embeddings'])} embeddings, want {n}")
    vec_of_cas = {}
    for r in cold["embeddings"]:
        cas_id = cas_of_object[r["object_id"]]
        vec = embedder.blob_to_vector(r["vector"])
        check(vec is not None and r["dim"] == embedder.EMBED_DIM
              and r["model"] == embedder.MODEL_NAME, f"malformed embedding row of {cas_id}")
        check(np.allclose(vec, p3["embeddings"][cas_id], atol=1e-5, rtol=1e-5),
              f"library embedding of {cas_id} differs from phase 3's")
        vec_of_cas[cas_id] = vec
    sample = [images[int(i)][0] for i in rng.choice(n, 8, replace=False)]
    host = embed_torch.embed_batch(np.stack([embedder.decode_image(p) for p in sample]), "cpu")
    for p, want in zip(sample, host):
        check(np.allclose(vec_of_cas[by_path[p]["cas_id"]], want, atol=1e-5, rtol=1e-5),
              f"library embedding of {p} differs from the CPU forward")
    ids = cold["sidecar_ids"]
    check(len(ids) == len(set(ids)) == n and set(ids) == {r["object_id"] for r in cold["embeddings"]},
          f"the search sidecar holds {len(ids)} vectors, want the {n} embedded objects")
    print(f"phase 4: cold media job: {n} webps at their dims (vs phase 3: max mean |d| "
          f"{mean_d:.4f}, max |d| {max_d}); {n} media_data rows; {n} embeddings == phase 3 "
          f"(8 == CPU forward); sidecar {len(ids)} vectors; journal vouches thumb/embed/media",
          flush=True)


def phase_library(rng, tmp: str, p3: dict) -> dict:
    from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore
    from spacedrive_tpu_torch.ops import cas

    corpus = p3["corpus"]
    data_dir = os.path.join(tmp, "library")
    t0 = time.perf_counter()
    small = add_small_files(corpus, rng)
    print(f"phase 4: +{len(small)} small files in {time.perf_counter() - t0:.1f} s; {LIBRARY_CUT}",
          flush=True)

    # cold scan
    cold = run_library_pass(corpus, data_dir)
    rows = cold["rows"]
    print(json.dumps({"library_cold": cold["summary"]}), flush=True)
    check(cold["launches"] > 0, "the cold library scan launched K1 no time")
    check(len(rows) == len(p3["cas_ids"]) + len(small),
          f"library has {len(rows)} files, want {len(p3['cas_ids']) + len(small)}")
    by_path = {_row_path(corpus, r): r for r in rows}
    for path, want in p3["cas_ids"].items():
        check(by_path[path]["cas_id"] == want, f"library cas_id of {path} differs from phase 3")
    sized = [(p, os.path.getsize(p)) for p in by_path]
    hashed = [(p, s) for p, s in sized if s > 0]
    plain = plain_cas_ids([cas.read_message(p, s) for p, s in hashed])
    for (p, _), want in zip(hashed, plain):
        check(by_path[p]["cas_id"] == want, f"library cas_id of {p} differs from the plain path")
    for p, s in sized:
        if s == 0:
            check(by_path[p]["cas_id"] is None and by_path[p]["object_id"] is None,
                  f"empty file {p} got a cas_id or an object")
    for i in rng.choice(len(hashed), 64, replace=False):
        p, s = hashed[i]
        check(by_path[p]["cas_id"] == cas.cas_id_cpu(p, s), f"library cas_id of {p} != blake3_ref")
    objects_of: dict[str, set] = {}
    for r in rows:
        if r["cas_id"] is not None:
            objects_of.setdefault(r["cas_id"], set()).add(r["object_id"])
    check(all(len(o) == 1 and None not in o for o in objects_of.values()),
          "rows of one cas_id do not share one object")
    check(cold["summary"]["objects"] == len(objects_of),
          f"{cold['summary']['objects']} objects for {len(objects_of)} distinct cas_ids")
    check(len(objects_of) < len(hashed), "no duplicates were linked to a shared object")
    keys = {(r["materialized_path"], r["name"], r["extension"]) for r in rows}
    check(keys <= set(cold["journal"]), "a file has no journal entry after the cold scan")
    print(f"phase 4: cold scan {len(rows)} files; {len(hashed)} cas_ids == phase 3 / plain path; "
          f"64 == blake3_ref; {len(objects_of)} objects == distinct cas_ids", flush=True)
    check_media(cold, p3, data_dir, rng)

    # warm rescan of the unchanged tree
    webps = webp_files(data_dir)
    warm = run_library_pass(corpus, data_dir)
    check(warm["launches"] == 0, f"the warm rescan launched K1 {warm['launches']} times")
    # every file the cold scan hashed is a journal hit, and so is every
    # empty file (journaled with the "" sentinel): nothing else
    n_empty = len(sized) - len(hashed)
    check(cold["identifier"]["device_files"] == len(hashed),
          f"cold scan hashed {cold['identifier']['device_files']} files, want {len(hashed)}")
    check(warm["indexer"].get("journal_hit") == len(hashed) + n_empty == len(rows),
          f"warm journal hits {warm['indexer'].get('journal_hit')} != {len(hashed)} hashed "
          f"+ {n_empty} empty files")
    check(warm["identifier"]["device_files"] == 0 and warm["identifier"]["journal_dirty_rehash"] == 0,
          "the warm rescan hashed files")
    check({r["id"]: r["cas_id"] for r in warm["rows"]} == {r["id"]: r["cas_id"] for r in rows},
          "the warm rescan changed cas_ids")
    print(f"phase 4: warm rescan: 0 K1 launches, {len(rows)} journal hits ({len(hashed)} hashed "
          f"+ {n_empty} empty files)", flush=True)
    check(warm["media"] == {"media_data_extracted": 0, "media_data_skipped": 0,
                            "thumbnails_dispatched": 0, "embeddings_written": 0},
          f"the warm rescan's media job did work: {warm['media']}")
    check(warm["generated"] == 0, f"the warm rescan wrote {warm['generated']} thumbnails")
    check(webp_files(data_dir) == webps, "the warm rescan changed a webp file")
    print("phase 4: warm rescan: 0 thumbnails dispatched or written, 0 media_data rows "
          "extracted, 0 embeddings; no webp changed", flush=True)

    # incremental rescan: 32 rewrites in place, 16 additions, 16 deletions
    rewritten = [p3["large"][int(i)] for i in rng.choice(len(p3["large"]), 32, replace=False)]
    for p in rewritten:
        rewrite_in_place(p)
    added = []
    for i, size in enumerate([int(x) for x in rng.integers(1, 400_000, 12)]):
        path = os.path.join(corpus, "added", f"a{i:02d}.bin")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(rng.bytes(size))
        added.append(path)
    added_images = [_image((os.path.join(corpus, "added", f"a{12 + i:02d}.{fmt}"), w, h,
                            int(rng.integers(1 << 30)), fmt, orientation))
                    for i, (w, h, fmt, orientation) in enumerate(
                        [(1600, 1200, "jpg", 6), (900, 1350, "png", 1), (2400, 1350, "jpg", 8),
                         (700, 700, "png", 1)])]
    added += [p for p, *_ in added_images]
    deleted = [small[int(i)] for i in rng.choice(len(small), 16, replace=False)]
    for p in deleted:
        os.remove(p)
    inc = run_library_pass(corpus, data_dir)
    ident = inc["identifier"]
    check(ident["device_files"] == len(added),
          f"incremental rescan hashed {ident['device_files']} files on the card, want {len(added)}")
    check(ident["journal_dirty_rehash"] == len(rewritten),
          f"{ident['journal_dirty_rehash']} dirty-range rehashes, want {len(rewritten)}")
    check(inc["launches"] > 0, "the incremental rescan launched K1 no time")
    by_path = {_row_path(corpus, r): r for r in inc["rows"]}
    check(not any(p in by_path for p in deleted), "deleted files still have rows")
    check(len(inc["rows"]) == len(rows) + len(added) - len(deleted), "row count after rescan")
    for p in rewritten + added:
        check(by_path[p]["cas_id"] == cas.cas_id_cpu(p), f"cas_id of {p} != blake3_ref after rescan")
    print(f"phase 4: incremental rescan: {len(rewritten)} dirty-range rehashes, {len(added)} "
          f"files through K1, {len(deleted)} rows removed", flush=True)
    n_new = len(added_images)
    check(inc["media"] == {"media_data_extracted": n_new, "media_data_skipped": 0,
                           "thumbnails_dispatched": n_new, "embeddings_written": n_new},
          f"the incremental media job did not do exactly the {n_new} new images: {inc['media']}")
    check(inc["generated"] == n_new, f"the incremental rescan wrote {inc['generated']} thumbnails")
    store = ThumbnailStore(os.path.join(data_dir, "thumbnails"))
    for path, w, h, orientation in added_images:
        cas_id = by_path[path]["cas_id"]
        check(store.exists(inc["lib_id"], cas_id), f"no thumbnail for the new image {path}")
        check(inc["journal"][(by_path[path]["materialized_path"], by_path[path]["name"],
                              by_path[path]["extension"])]["cas_id"] == cas_id, "journal cas")
    print(f"phase 4: incremental rescan: the media job thumbnailed, extracted and embedded "
          f"exactly the {n_new} new images", flush=True)

    out = {"cut": LIBRARY_CUT}
    for name, run in (("cold", cold), ("warm", warm), ("incremental", inc)):
        out[name] = run["numbers"]
    print(json.dumps({"library_pass": out}), flush=True)
    return {"launches": {name: run["launches"] for name, run in
                         (("library_cold", cold), ("library_warm", warm),
                          ("library_incremental", inc))},
            "corpus": corpus, "data_dir": data_dir, "rewritten": rewritten,
            "images": [p for p, *_ in p3["images"]] + [p for p, *_ in added_images]}


# --- phase 5: the library's read side ----------------------------------------

# near duplicates planted before phase 5's scan: corpus JPEGs re-encoded
# at another quality, corpus PNGs resized by 0.9
N_NEAR_JPEG, N_NEAR_PNG = 8, 8
NEAR_QUALITY, NEAR_SCALE = 60, 0.9
DUP_THRESHOLD = 8  # the CLI's default
# the image share of a 1M-file library (BASELINE config 5, full-library
# dedup): 262,144 seeded hashes with 1,024 planted clusters, the pair
# set checked against a host all-pairs on the first 16,384
N_PAIR_HASHES, N_PAIR_CLUSTERS, N_PAIR_SUBSET = 262_144, 1024, 16_384
# the search index at the same scale, with planted exact ties
N_SEARCH_VECTORS, SEARCH_K = 262_144, 100
# files held against blake3_ref (pure Python, ~0.5 MB/s): device-leg
# files at random and the smallest host-leg ones
N_REF_DEVICE, N_REF_HOST = 60, 4


def _near_copy(args) -> None:
    from PIL import Image

    src, dst = args
    with Image.open(src) as im:
        if dst.endswith(".jpg"):
            im.convert("RGB").save(dst, "JPEG", quality=NEAR_QUALITY)
        else:
            w, h = im.size
            im.resize((max(1, int(w * NEAR_SCALE)), max(1, int(h * NEAR_SCALE))),
                      Image.BILINEAR).save(dst, "PNG", compress_level=1)


def add_near_duplicates(corpus: str, images: list[str], rng) -> list[tuple[str, str]]:
    """N_NEAR_JPEG corpus JPEGs re-encoded and N_NEAR_PNG corpus PNGs
    resized under corpus/near/; returns (original, copy) pairs."""
    jpgs = [p for p in images if p.endswith(".jpg")]
    pngs = [p for p in images if p.endswith(".png")]
    pairs = []
    for group in (jpgs, pngs):
        n = N_NEAR_JPEG if group is jpgs else N_NEAR_PNG
        for i in sorted(rng.choice(len(group), n, replace=False)):
            src = group[int(i)]
            pairs.append((src, os.path.join(corpus, "near", "n_" + os.path.basename(src))))
    os.makedirs(os.path.join(corpus, "near"), exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(_near_copy, pairs))
    return pairs


def _open_library(data_dir: str):
    from spacedrive_tpu_torch.node.library import Libraries

    (lib,) = Libraries(data_dir).load_all()
    return lib


def _timed(totals: dict, key: str, fn, sync: bool = False):
    """`fn`, adding its wall seconds to totals[key] (after a device
    synchronize when `sync`, so that its device work counts)."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            return out
        finally:
            totals[key] += time.perf_counter() - t0
    return timed


def run_validator(data_dir: str, corpus: str) -> dict:
    """ObjectValidatorJob over the location on a Node on DEVICE, K1's
    launches and the validator's leg counts set to 0 just before it and
    read just after. The job's seconds are split by timing, for this run
    only, the host leg (`file_checksum`: read and C hash of a whole
    file), the packing of device batches, `hash_batch` up to a device
    synchronize (copy in, K1, the tree reduction) and `write_ops`; the
    rest is the device leg's reads, the row queries, op building and the
    job system."""
    import asyncio

    from spacedrive_tpu_torch.jobs import JobBuilder
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.object.validation import file_checksums
    from spacedrive_tpu_torch.object.validation import hash as vhash
    from spacedrive_tpu_torch.object.validation.job import ObjectValidatorJob
    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.sync.manager import SyncManager
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    async def run() -> dict:
        node = Node(data_dir, device=DEVICE)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            (lib,) = node.libraries.libraries.values()
            loc = lib.db.find_one("location", path=os.path.abspath(corpus))
            job = ObjectValidatorJob({"location_id": loc["id"]})
            await JobBuilder(job).spawn(node.jobs, lib)
            await node.jobs.wait_idle()
            return lib.db.find_one("job", id=job.id.bytes)
        finally:
            await node.shutdown()

    split = dict.fromkeys(("host_hash_s", "pack_s", "device_hash_s", "db_write_s"), 0.0)
    patches = [(vhash, "file_checksum", _timed(split, "host_hash_s", vhash.file_checksum)),
               (vhash.cas, "pack_canonical_batch",
                _timed(split, "pack_s", vhash.cas.pack_canonical_batch)),
               (vhash.blake3_torch, "hash_batch",
                _timed(split, "device_hash_s", vhash.blake3_torch.hash_batch, sync=True)),
               (SyncManager, "write_ops", _timed(split, "db_write_s", SyncManager.write_ops))]
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, wrapped in patches:
        setattr(owner, name, wrapped)
    file_checksums.device_files.clear()
    file_checksums.host_files = 0
    blake3_cuda.chunk_cvs.launches = 0
    t0 = time.perf_counter()
    try:
        row = asyncio.run(run())
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    seconds = time.perf_counter() - t0
    launches = blake3_cuda.chunk_cvs.launches
    check(row is not None and row["status"] == 2,
          f"the validator job did not complete: {row and row['errors_text']}")
    split["other_s"] = seconds - sum(split.values())
    return {"seconds": seconds, "launches": launches, "metadata": unpackb(row["metadata"]),
            "device_files": dict(sorted(file_checksums.device_files.items())),
            "host_files": file_checksums.host_files, "split_s": split}


def check_validator(data_dir: str, corpus: str, got: dict, rng) -> dict:
    """Every file's integrity_checksum against the host C hasher over the
    whole file; N_REF_DEVICE + N_REF_HOST files against blake3_ref; one
    CRDT op per row; K1 launched."""
    from spacedrive_tpu_torch.object.validation import file_checksum
    from spacedrive_tpu_torch.object.validation.hash import DEVICE_MAX_BYTES

    lib = _open_library(data_dir)
    try:
        rows = lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")
        n_ops = lib.db.count("crdt_operation", "kind = 'u:integrity_checksum'")
    finally:
        lib.close()
    paths = [_row_path(corpus, r) for r in rows]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:  # the C hasher releases the interpreter lock
        want = list(pool.map(file_checksum, paths))
    host_hasher_s = time.perf_counter() - t0
    for r, p, w in zip(rows, paths, want):
        check(r["integrity_checksum"] == w, f"integrity_checksum of {p} != the host hasher's")
    check(got["metadata"]["validated"] == len(rows), f"validated {got['metadata']} of {len(rows)}")
    check(n_ops == len(rows), f"{n_ops} integrity_checksum ops for {len(rows)} rows")
    check(got["launches"] > 0, "the validator launched K1 no time")
    check(sum(got["device_files"].values()) + got["host_files"] == len(rows),
          f"device {got['device_files']} + host {got['host_files']} files != {len(rows)} rows")
    sizes = [os.path.getsize(p) for p in paths]
    device_leg = [i for i, n in enumerate(sizes) if 0 < n <= DEVICE_MAX_BYTES]
    host_leg = sorted((i for i, n in enumerate(sizes) if n > DEVICE_MAX_BYTES), key=sizes.__getitem__)
    sample = [int(i) for i in rng.choice(device_leg, N_REF_DEVICE, replace=False)] \
        + host_leg[:N_REF_HOST]
    t0 = time.perf_counter()
    contents = []
    for i in sample:
        with open(paths[i], "rb") as f:
            contents.append(f.read())
    for i, ref in zip(sample, blake3_ref_hexes(contents, 32)):
        check(rows[i]["integrity_checksum"] == ref, f"integrity_checksum of {paths[i]} != blake3_ref")
    ref_s = time.perf_counter() - t0
    print(f"phase 5: validator: {len(rows)} integrity_checksums == the host hasher; "
          f"{len(sample)} == blake3_ref; {n_ops} CRDT ops; device files by bucket "
          f"{got['device_files']}, host files {got['host_files']}, K1 launches "
          f"{got['launches']}", flush=True)
    return {"files": len(rows), "bytes": sum(sizes), "check_host_hasher_s": host_hasher_s,
            "check_ref_s": ref_s, "check_ref_bytes": sum(sizes[i] for i in sample)}


def _gray_plane(path: str):
    """The duplicate job's decode: the original, JPEG in draft mode."""
    from PIL import Image

    from spacedrive_tpu_torch.ops import phash_torch

    with Image.open(path) as img:
        if img.format == "JPEG":
            img.draft("RGB", (phash_torch.DCT_SIZE, phash_torch.DCT_SIZE))
        return phash_torch.to_gray32(np.asarray(img.convert("RGBA")))


def _duplicates_run(data_dir: str) -> tuple[list, dict, float]:
    import asyncio

    from spacedrive_tpu_torch.cli import duplicates_library
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    t0 = time.perf_counter()
    groups = asyncio.run(duplicates_library(data_dir, "smoke", DUP_THRESHOLD, DEVICE))
    seconds = time.perf_counter() - t0
    lib = _open_library(data_dir)
    try:
        row = lib.db.query_one("SELECT metadata FROM job WHERE name = 'duplicate_detector' "
                               "ORDER BY date_created DESC, rowid DESC LIMIT 1")
    finally:
        lib.close()
    return groups, unpackb(row["metadata"]), seconds


def split_one_object(data_dir: str) -> None:
    """Move the last file of a non-image object that several files share
    onto a new object of the same kind: the state two devices leave when
    each mints an object for one cas_id before sync merges them, and the
    one exact-duplicate group a scan alone never makes."""
    from spacedrive_tpu_torch.files.kind import ObjectKind

    lib = _open_library(data_dir)
    try:
        row = lib.db.query_one(
            "SELECT fp.id, fp.object_id, o.kind FROM file_path fp "
            "JOIN object o ON o.id = fp.object_id WHERE o.kind != ? AND fp.object_id IN "
            "(SELECT object_id FROM file_path GROUP BY object_id HAVING COUNT(*) > 1) "
            "ORDER BY fp.id DESC LIMIT 1", (int(ObjectKind.Image),))
        check(row is not None, "no object is shared by two files")
        pub = b"split-object" + row["object_id"].to_bytes(4, "big")
        fp_pub = lib.db.find_one("file_path", id=row["id"])["pub_id"]
        sync = lib.sync
        box = {}

        def writes(conn):
            box["id"] = conn.execute("INSERT INTO object (pub_id, kind) VALUES (?, ?)",
                                     (pub, row["kind"])).lastrowid
            conn.execute("UPDATE file_path SET object_id = ? WHERE id = ?", (box["id"], row["id"]))

        # with its CRDT ops, as a device that minted the object writes it
        sync.write_ops(sync.shared_create("object", pub.hex(), [("kind", row["kind"])])
                       + [sync.shared_update("file_path", fp_pub.hex(), "object_id", pub.hex())],
                       writes)
    finally:
        lib.close()


def check_duplicates(data_dir: str, corpus: str, pairs: list[tuple[str, str]]) -> dict:
    """`duplicates` through the CLI helper, after `split_one_object`:
    every image object hashed (8 bytes), the bits equal to the plain CPU
    path on the same gray planes but for counted near-median flips,
    every planted pair in one near group, the exact groups equal to the
    DB's cas_id groups (one), a second run hashing nothing, and H1
    launched by each run, whole blocks of the objects' hashes."""
    import torch as _torch

    from spacedrive_tpu_torch.files.kind import ObjectKind
    from spacedrive_tpu_torch.ops import hamming_cuda, phash_torch

    split_one_object(data_dir)
    hamming_cuda.near_pairs_block.launches = 0
    groups, meta, seconds = _duplicates_run(data_dir)
    launches = [hamming_cuda.near_pairs_block.launches]
    lib = _open_library(data_dir)
    try:
        objs = lib.db.query("SELECT id, phash FROM object WHERE kind = ?", (int(ObjectKind.Image),))
        rows = lib.db.query("SELECT * FROM file_path WHERE is_dir = 0 AND object_id IS NOT NULL")
    finally:
        lib.close()
    check(all(o["phash"] is not None and len(o["phash"]) == 8 for o in objs),
          "an image object has no 8-byte phash")
    check(meta["hashed"] == len(objs), f"the job hashed {meta['hashed']} of {len(objs)} images")
    path_of = {}
    for r in rows:
        path_of.setdefault(r["object_id"], _row_path(corpus, r))
    with ThreadPoolExecutor(8) as pool:
        planes = np.stack(list(pool.map(_gray_plane, [path_of[o["id"]] for o in objs])))
    plain = np.unpackbits(phash_torch.phash_batch(planes, "cpu"), axis=1)
    got = np.unpackbits(np.frombuffer(b"".join(o["phash"] for o in objs), np.uint8)
                        .reshape(-1, 8), axis=1)
    ac = phash_torch.dct_low(_torch.from_numpy(planes)).numpy()
    med = np.median(ac[:, 1:], axis=1, keepdims=True)
    near_median = np.abs(ac - med) <= 1e-5 * np.abs(ac).max(axis=1, keepdims=True)
    flips = got != plain
    check(not (flips & ~near_median).any(), "a pHash bit away from the median differs from "
          "the plain CPU path")

    object_of = {p: oid for oid, p in path_of.items()}
    near = [set(g["object_ids"]) for g in groups if g["kind"] == "near"]
    for a, b in pairs:
        oa, ob = object_of[a], object_of[b]
        check(any(oa in g and ob in g for g in near), f"planted pair {a}, {b} is in no near group")
    by_cas: dict[str, set] = {}
    for r in rows:
        if r["cas_id"] is not None:
            by_cas.setdefault(r["cas_id"], set()).add(r["object_id"])
    want_exact = sorted(sorted(ids) for ids in by_cas.values() if len(ids) > 1)
    got_exact = sorted(sorted(g["object_ids"]) for g in groups if g["kind"] == "exact")
    check(got_exact == want_exact and len(want_exact) == 1,
          f"exact groups {got_exact} != the DB's cas_id groups {want_exact}")

    hamming_cuda.near_pairs_block.launches = 0
    groups2, meta2, seconds2 = _duplicates_run(data_dir)
    launches.append(hamming_cuda.near_pairs_block.launches)
    blocks = -(-len(objs) // phash_torch.PAIR_BLOCK)
    check(all(k > 0 and k % blocks == 0 for k in launches),
          f"the duplicates runs launched H1 {launches} times, not whole passes of {blocks} blocks")
    check(meta2["hashed"] == 0, f"the second duplicates run hashed {meta2['hashed']}")
    check([sorted(g["object_ids"]) for g in groups2] == [sorted(g["object_ids"]) for g in groups],
          "the second duplicates run found other groups")
    print(f"phase 5: duplicates: {len(objs)} image objects hashed on the card, {int(flips.sum())} "
          f"bits differ from the plain CPU path (all within 1e-5 of the median); {len(near)} near "
          f"groups hold every one of the {len(pairs)} planted pairs; {len(got_exact)} exact "
          f"groups == the DB's; a second run hashed 0; H1 launches {launches}", flush=True)
    return {"images": len(objs), "seconds": seconds, "second_run_s": seconds2,
            "h1_launches": sum(launches),
            "near_groups": len(near), "exact_groups": len(got_exact),
            "flips_near_median": int(flips.sum()), "reused": meta.get("reused", 0)}


def _popcount64(x: np.ndarray) -> np.ndarray:
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x)
    table = np.array([bin(i).count("1") for i in range(256)], np.uint8)
    return table[x.view(np.uint8)].reshape(*x.shape, 8).sum(-1)


def host_pairs(h64: np.ndarray, threshold: int) -> list[tuple[int, int]]:
    """All pairs (i < j) within `threshold` bits, row-major, by XOR and
    popcount on the host."""
    out = []
    for off in range(0, len(h64), 512):
        d = _popcount64(h64[off:off + 512, None] ^ h64[None, :])
        r, c = np.nonzero(d <= threshold)
        keep = off + r < c
        out += list(zip((off + r[keep]).tolist(), c[keep].tolist()))
    return out


def check_near_pairs_at_scale(rng) -> dict:
    """`near_pairs` at N_PAIR_HASHES seeded hashes with N_PAIR_CLUSTERS
    planted clusters (2-4 members, each at most DUP_THRESHOLD/2 bits from
    its centre): one H1 launch a block, the pairs equal to the plain
    torch path's (`plain_block` on the card, exact in bf16), every
    planted pair returned, every returned pair within the threshold by
    host XOR-popcount, and on the first N_PAIR_SUBSET hashes the pairs
    equal to a host all-pairs and to the plain path's on the CPU. Then
    H1 against the plain path on the first block of a 2^20-hash library
    (`h1_block_ms`)."""
    from spacedrive_tpu_torch.ops import hamming_cuda, phash_torch

    bits = rng.integers(0, 2, (N_PAIR_HASHES, 64)).astype(bool)
    members = rng.permutation(N_PAIR_HASHES)[:N_PAIR_CLUSTERS * 4].reshape(N_PAIR_CLUSTERS, 4)
    planted = set()
    for c, row in enumerate(members):
        size = 2 + c % 3
        centre = bits[row[0]].copy()
        for m in row[:size]:
            flip = rng.choice(64, int(rng.integers(0, DUP_THRESHOLD // 2 + 1)), replace=False)
            bits[m] = centre
            bits[m, flip] ^= True
        for i in range(size):
            for j in range(i + 1, size):
                planted.add((int(min(row[i], row[j])), int(max(row[i], row[j]))))
    packed = np.packbits(bits, axis=1)
    hashes = [h.tobytes() for h in packed]
    h64 = packed.view(">u8").reshape(-1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hamming_cuda.near_pairs_block.launches = 0
    t0 = time.perf_counter()
    pairs = list(phash_torch.near_pairs(hashes, DUP_THRESHOLD, DEVICE))
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"near_pairs_at_scale": hamming_cuda.near_pairs_block.launches}
    blocks = -(-N_PAIR_HASHES // phash_torch.PAIR_BLOCK)
    check(launches["near_pairs_at_scale"] == blocks,
          f"near_pairs launched H1 {launches['near_pairs_at_scale']} times for {blocks} blocks")
    pm = phash_torch._plus_minus(torch.from_numpy(bits).to(DEVICE))
    plain = phash_torch._plain_launcher(pm, N_PAIR_HASHES, DUP_THRESHOLD)
    want = [p for off in range(0, N_PAIR_HASHES, phash_torch.PAIR_BLOCK)
            for p in phash_torch.block_pairs(plain, off, phash_torch.PAIR_CAPACITY)[0]]
    del pm, plain
    torch.cuda.empty_cache()
    check(pairs == want, f"H1's {len(pairs)} pairs on {N_PAIR_HASHES} hashes != the plain "
          f"torch path's {len(want)} on the card")
    got = set(pairs)
    check(len(got) == len(pairs), "near_pairs returned a pair twice")
    check(planted <= got, f"{len(planted - got)} planted pairs missing from near_pairs")
    a = np.array([p[0] for p in pairs])
    b = np.array([p[1] for p in pairs])
    dist = _popcount64(h64[a] ^ h64[b])
    check(bool((dist <= DUP_THRESHOLD).all()), "near_pairs returned a pair beyond the threshold")
    hamming_cuda.near_pairs_block.launches = 0
    sub = list(phash_torch.near_pairs(hashes[:N_PAIR_SUBSET], DUP_THRESHOLD, DEVICE))
    launches["near_pairs_subset"] = hamming_cuda.near_pairs_block.launches
    check(sub == host_pairs(h64[:N_PAIR_SUBSET], DUP_THRESHOLD),
          f"near_pairs on {N_PAIR_SUBSET} hashes != the host all-pairs")
    check(sub == list(phash_torch.near_pairs(hashes[:N_PAIR_SUBSET], DUP_THRESHOLD, "cpu")),
          f"H1's pairs on {N_PAIR_SUBSET} hashes != the plain torch path's")
    block = h1_block_ms(rng)
    print(f"phase 5: near_pairs at {N_PAIR_HASHES} hashes: {len(pairs)} pairs in {seconds:.3f} s "
          f"(peak device memory {peak / 2**30:.2f} GiB, {launches['near_pairs_at_scale']} H1 "
          f"launches) == the plain path's on the card; all {len(planted)} planted pairs among "
          f"them, all within {DUP_THRESHOLD} bits; the {N_PAIR_SUBSET}-hash subset's {len(sub)} "
          f"pairs == host all-pairs == plain path on the CPU; H1 {block['ms']:.4f} ms a 4096 x "
          f"2^20 block with its buffer to the host, {block['block_pairs']} pairs == the plain "
          f"path's (POPC bound {block['popc_bound_ms']:.4f} ms, the benchmark's count "
          f"{block['count_bound_ms']:.4f} ms; the plain path {block['plain_ms']:.2f} ms)",
          flush=True)
    return {"hashes": N_PAIR_HASHES, "pairs": len(pairs), "planted_pairs": len(planted),
            "seconds": seconds, "peak_device_bytes": peak, "subset_pairs": len(sub),
            "h1_launches": launches, "h1_block": block}


def h1_block_ms(rng, n: int = 2**20, planted: int = 1024) -> dict:
    """H1 on the first block of `n` uniform hashes at DUP_THRESHOLD, with
    `planted` of its rows given a copy within the threshold at a later
    column: its pairs equal to the plain path's (`plain_block` on the
    card) on the same block, and the median ms of each, its pairs to the
    host included, beside H1's bounds (the POPC bound of the block's
    pairs at POPC_PER_PAIR and the card's maximum SM clock; the
    benchmark's count, OPS_PER_PAIR a pair at the int8 dense peak)."""
    from spacedrive_tpu_torch.ops import hamming_cuda, phash_torch

    rows, capacity = phash_torch.PAIR_BLOCK, phash_torch.PAIR_CAPACITY
    words = rng.integers(0, 2**64, n, dtype=np.uint64)
    for r in rng.choice(rows, planted, replace=False):
        flip = rng.choice(64, int(rng.integers(0, DUP_THRESHOLD + 1)), replace=False)
        words[rng.integers(rows, n)] = words[r] ^ np.uint64(sum(1 << int(f) for f in flip))
    table = torch.from_numpy(words.view(np.int64)).to(DEVICE)
    bits = np.unpackbits(words.view(np.uint8).reshape(n, 8), axis=1).astype(bool)
    pm = phash_torch._plus_minus(torch.from_numpy(bits).to(DEVICE))

    buf = hamming_cuda.near_pairs_block(table, n, 0, rows, DUP_THRESHOLD, capacity).cpu().numpy()
    count = int(buf[0])
    check(0 < count <= capacity, f"H1 found {count} pairs in the block, room for {capacity}")
    got = phash_torch.decode_pairs(buf[1:1 + count])
    want = phash_torch.decode_pairs(phash_torch.plain_block(pm, n, 0, DUP_THRESHOLD))
    check(got == want, f"H1's {len(got)} pairs in a 4096 x {n} block != the plain path's "
          f"{len(want)}")
    ms = cuda_ms(lambda: hamming_cuda.near_pairs_block(
        table, n, 0, rows, DUP_THRESHOLD, capacity).cpu(), reps=10)
    plain_ms = cuda_ms(lambda: phash_torch.plain_block(pm, n, 0, DUP_THRESHOLD),
                       reps=3, warmup=1)
    del pm
    torch.cuda.empty_cache()
    pairs = rows * (n - rows) + rows * (rows - 1) // 2
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"rows": rows, "columns": n, "pairs": pairs, "block_pairs": count, "ms": ms,
            "plain_ms": plain_ms,
            "popc_bound_ms": pairs * POPC_PER_PAIR / (sms * POPC_PER_SM * sm_clock_hz) * 1e3,
            "count_bound_ms": pairs * OPS_PER_PAIR / INT8_OPS_PER_S * 1e3}


def h1_kernel(read: dict) -> dict:
    """H1's entry in the smoke's `kernels` line, from phase 5's numbers:
    `launches_by_path` counts each path from 0 just before it."""
    block = read["near_pairs"]["h1_block"]
    by_path = {"duplicates": read["duplicates"]["h1_launches"],
               **read["near_pairs"]["h1_launches"]}
    return {
        "name": "hamming_near_pairs",
        "route": "cuda",
        "source": "spacedrive_tpu_torch/ops/csrc/hamming_pairs.cu",
        "replaces": "none",
        "parity": "exact",
        "ms": block["ms"],
        "plain_ms": block["plain_ms"],
        "bound_ms": block["popc_bound_ms"],
        "bound_by": "popc",
        "bound_ms_by_count": block["count_bound_ms"],
        "library_ms": None,
        "launches_by_path": by_path,
        "launches": sum(by_path.values()),
    }


def _search(data_dir: str, query: str, semantic: bool, take: int) -> dict:
    import asyncio

    from spacedrive_tpu_torch.cli import search_library

    return asyncio.run(search_library(query, data_dir, "smoke", semantic, take, DEVICE))


def check_search(data_dir: str, images: list[str], rng) -> dict:
    """`search` through the CLI helper: a corpus image's path ranks its
    own object first at cosine 1 ± 1e-5; a name search equals its SQL;
    a label-name probe is the centroid of the labeled objects' vectors
    and ranks as a host float64 ranking does."""
    from spacedrive_tpu_torch.models import embedder

    probe_path = images[int(rng.integers(len(images)))]
    t0 = time.perf_counter()
    out = _search(data_dir, probe_path, True, 5)
    semantic_s = time.perf_counter() - t0
    check(out["resolved"] and len(out["nodes"]) == 5, f"semantic query by path: {out}")
    first = out["nodes"][0]
    name = os.path.basename(probe_path)
    check(f"{first['name']}.{first['extension']}" == name,
          f"semantic query by {name} ranked {first['name']} first")
    check(abs(first["score"] - 1.0) <= 1e-5, f"self cosine {first['score']}")

    out = _search(data_dir, "img01", False, 10)
    lib = _open_library(data_dir)
    try:
        want = [r["id"] for r in lib.db.query(
            "SELECT id FROM file_path WHERE name LIKE '%img01%' ORDER BY name ASC, id ASC "
            "LIMIT 10")]
        objs = [r["object_id"] for r in lib.db.query(
            "SELECT object_id FROM object_embedding ORDER BY object_id LIMIT 3")]
        lid = lib.db.insert("label", name="smoke-label")
        for oid in objs:
            lib.db.insert("label_on_object", label_id=lid, object_id=oid)
        emb = {r["object_id"]: embedder.blob_to_vector(r["vector"])
               for r in lib.db.query("SELECT object_id, vector FROM object_embedding")}
        fp_of = {r["object_id"]: r["id"] for r in lib.db.query(
            "SELECT object_id, MIN(id) AS id FROM file_path WHERE object_id IS NOT NULL "
            "GROUP BY object_id")}
    finally:
        lib.close()
    check([n["id"] for n in out["nodes"]] == want and want, f"name search != SQL {want}")

    out = _search(data_dir, "smoke-label", True, 10)
    check(out["resolved"] is True, "the label-name probe did not resolve")
    ids = sorted(emb)
    unit = np.stack([emb[i] / np.linalg.norm(emb[i]) for i in ids]).astype(np.float64)
    centroid = unit[[ids.index(o) for o in objs]].mean(0)
    centroid /= np.linalg.norm(centroid)
    scores = unit @ centroid
    order = np.argsort(-scores, kind="stable")[:10]
    check([n["id"] for n in out["nodes"]] == [fp_of[ids[i]] for i in order],
          "the label-name probe ranks otherwise than the host")
    check(np.allclose([n["score"] for n in out["nodes"]], scores[order], atol=1e-5, rtol=1e-5),
          "label-name probe scores differ from the host's")
    print(f"phase 5: search: {name} ranks itself first (cosine {first['score']:.7f}); name "
          f"search == SQL ({len(want)} rows); label probe == host ranking", flush=True)
    return {"semantic_query_s": semantic_s}


def check_query_at_scale(rng) -> dict:
    """The scorer at N_SEARCH_VECTORS seeded vectors with planted exact
    ties: the card's top-k ids equal a host stable ranking of the card's
    scores (np.argsort(-s, kind="stable")), ties included, and the
    scores equal a host float64 product within 1e-5."""
    import types

    from spacedrive_tpu_torch.object.search import index as search_index

    m = rng.standard_normal((N_SEARCH_VECTORS, 128), dtype=np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    probe_row = int(rng.integers(N_SEARCH_VECTORS))
    tied = np.array([t for t in rng.permutation(N_SEARCH_VECTORS)[:513] if t != probe_row][:512])
    m[tied[:8]] = m[probe_row]  # 9 rows tied at the top
    for k in range(8, 512, 4):  # 126 more groups of 4 tied rows
        m[tied[k + 1:k + 4]] = m[tied[k]]
    dev_m = torch.from_numpy(m).to(DEVICE)
    probe = torch.from_numpy(m[probe_row]).to(DEVICE)
    scores, rows = search_index.score_top_k(dev_m, probe, SEARCH_K)
    s = (dev_m * probe).sum(dim=1).cpu().numpy()
    want = np.argsort(-s, kind="stable")[:SEARCH_K]
    check(rows.cpu().numpy().tolist() == want.tolist(), "the card's top-k != the host's stable ranking")
    check(sorted(rows[:9].tolist()) == rows[:9].tolist()
          and set(rows[:9].tolist()) == {probe_row, *tied[:8].tolist()},
          "the tied top rows are not in row order")
    host = m.astype(np.float64) @ m[probe_row].astype(np.float64)
    check(np.allclose(scores.cpu().numpy(), host[want], atol=1e-5, rtol=1e-5),
          "scores differ from the host float64 product")
    query_ms = cuda_ms(lambda: search_index.score_top_k(dev_m, probe, SEARCH_K), reps=20)
    library_ms = cuda_ms(lambda: torch.topk(dev_m @ probe, SEARCH_K), reps=20)
    idx = search_index.LibraryIndex(types.SimpleNamespace(node=None))
    idx._matrix, idx._ids, idx._loaded = m, list(range(N_SEARCH_VECTORS)), True
    idx.query(m[probe_row], SEARCH_K, DEVICE)  # uploads the matrix once
    t0 = time.perf_counter()
    for _ in range(10):
        idx.query(m[probe_row], SEARCH_K, DEVICE)
    host_query_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"phase 5: query at {N_SEARCH_VECTORS} vectors: top-{SEARCH_K} == host stable "
          f"ranking, 9 tied top rows in row order; {query_ms:.3f} ms a query on the card "
          f"({host_query_ms:.3f} ms through LibraryIndex.query)", flush=True)
    return {"vectors": N_SEARCH_VECTORS, "k": SEARCH_K, "score_top_k_ms": query_ms,
            "matmul_topk_ms": library_ms, "library_query_ms": host_query_ms}


def read_side_ops_ms(rng) -> dict:
    """The read side's torch programs at the main path's shapes: the DCT
    of 64 planes (one duplicate step)."""
    from spacedrive_tpu_torch.ops import phash_torch

    gray = torch.from_numpy(rng.random((64, 32, 32), dtype=np.float32)).to(DEVICE)
    return {"phash_64_ms": cuda_ms(lambda: phash_torch.phash_bits(gray), reps=20)}


def phase_read_side(rng, p4: dict) -> dict:
    corpus, data_dir = p4["corpus"], p4["data_dir"]
    t_phase = time.perf_counter()
    steps_s: dict[str, float] = {}  # wall seconds of each step, its checks included

    def step(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        steps_s[name] = time.perf_counter() - t0
        return out

    pairs = step("near_copies", add_near_duplicates, corpus, p4["images"], rng)
    scan = step("rescan", run_library_pass, corpus, data_dir)
    check(scan["media"]["thumbnails_dispatched"] == len(pairs),
          f"the rescan's media job dispatched {scan['media']['thumbnails_dispatched']} "
          f"thumbnails, want the {len(pairs)} near copies")
    print(f"phase 5: +{len(pairs)} near duplicates scanned in {scan['numbers']['seconds']:.1f} s "
          f"(K1 launches {scan['launches']})", flush=True)

    got = step("validator", run_validator, data_dir, corpus)
    validator = {**step("validator_check", check_validator, data_dir, corpus, got, rng),
                 **{k: got[k] for k in ("seconds", "launches", "device_files", "host_files",
                                        "split_s")}}
    duplicates = step("duplicates", check_duplicates, data_dir, corpus, pairs)
    near_pairs = step("near_pairs_at_scale", check_near_pairs_at_scale, rng)
    search = step("search", check_search, data_dir, p4["images"], rng)
    query = step("query_at_scale", check_query_at_scale, rng)
    ops_ms = step("torch_ops", read_side_ops_ms, rng)
    out = {"cut": LIBRARY_CUT, "near_copies": len(pairs),
           "rescan": {k: scan["numbers"][k] for k in ("seconds", "files_per_s", "k1_launches")},
           "validator": validator, "duplicates": duplicates, "near_pairs": near_pairs,
           "search": {**search, **query}, "torch_ops_ms": ops_ms, "steps_s": steps_s,
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps({"read_side": out}), flush=True)
    return {"launches": {"read_side_rescan": scan["launches"], "validator": got["launches"]},
            "h1": h1_kernel(out)}


# --- phase 6: the labeler --------------------------------------------------

# LabelerNet computes in bf16 on the card (cuDNN) and on the CPU (oneDNN),
# sums in another order: probabilities within LABEL_BAND, and a label
# decision may differ only where the CPU probability lies within
# LABEL_BAND of the threshold (the bound tests/test_torch_labeler.py
# states against the JAX forward). ONNX graphs run in float32 with TF32
# off inside each call: within ONNX_RTOL (and ONNX_ATOL near zero).
LABEL_THRESHOLD, LABEL_BAND = 0.35, 0.05
ONNX_RTOL, ONNX_ATOL = 1e-5, 1e-5
LABEL_BATCH, LABEL_BATCH_LARGE, LABEL_SIZE = 16, 256, 224
BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)


def device_kernels(fn) -> dict:
    """Kernels launched by one call of `fn` and their summed device
    milliseconds, from a `torch.profiler` trace (None where the trace
    shows no device time), and the five largest kernels as [name,
    launches, ms]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:5]
    return {"kernels": sum(e.count for e in evs), "device_busy_ms": busy if busy > 0 else None,
            "top_kernels": [[e.key[:100], e.count, e.self_device_time_total / 1e3]
                            for e in top]}


def _label_flips(got: np.ndarray, want: np.ndarray) -> tuple[int, int]:
    """(decisions that differ outside the band, differing inside it)."""
    differ = (got >= LABEL_THRESHOLD) != (want >= LABEL_THRESHOLD)
    near = np.abs(want - LABEL_THRESHOLD) <= LABEL_BAND
    return int((differ & ~near).sum()), int((differ & near).sum())


def check_labeler_net(rng) -> dict:
    """(a) LabelerNet at full width (seeded weights, 80 classes) on 16
    seeded 224² images on the card against the CPU, both bf16; then its
    forward timed at batch 16 and 256."""
    import copy

    from spacedrive_tpu_torch.models import labeler

    seed = int(rng.integers(1 << 31))
    cpu = labeler.init_params(torch.Generator().manual_seed(seed))
    gpu = copy.deepcopy(cpu).to(DEVICE)
    x = rng.random((LABEL_BATCH, LABEL_SIZE, LABEL_SIZE, 3), dtype=np.float32)
    t0 = time.perf_counter()
    want = labeler.infer_step(cpu, torch.from_numpy(x))[0].numpy()
    cpu_s = time.perf_counter() - t0
    got, mask = labeler.infer_step(gpu, torch.from_numpy(x).to(DEVICE))
    got = got.cpu().numpy()
    check(got.shape == (LABEL_BATCH, labeler.NUM_CLASSES) and np.isfinite(got).all(),
          f"LabelerNet on the card gave {got.shape} or non-finite probabilities")
    check(np.array_equal(mask.cpu().numpy(), got >= LABEL_THRESHOLD), "infer_step's mask")
    dprob = float(np.abs(got - want).max())
    outside, inside = _label_flips(got, want)
    check(outside == 0, f"{outside} label decisions flip outside {LABEL_THRESHOLD} ± {LABEL_BAND}")
    check(dprob <= LABEL_BAND, f"max |dprob| {dprob} over {LABEL_BAND}")

    flops = labeler.conv_flops(gpu, LABEL_SIZE)
    params = sum(p.numel() for p in gpu.parameters())
    timings = {}
    for batch in (LABEL_BATCH, LABEL_BATCH_LARGE):
        images = torch.rand((batch, LABEL_SIZE, LABEL_SIZE, 3), device=DEVICE,
                            generator=torch.Generator(DEVICE).manual_seed(seed + batch))
        with torch.no_grad():
            ms = cuda_ms(lambda: gpu(images), reps=20)
            kernels = device_kernels(lambda: gpu(images))
        moved = images.numel() * 4 + params * 4 + batch * labeler.NUM_CLASSES * 4
        bound_ms = max(moved / HBM_BYTES_PER_S, batch * flops / BF16_PEAK_FLOPS) * 1e3
        timings[batch] = {"ms": ms, "images_per_s": batch / ms * 1e3,
                          "gflop_per_s": batch * flops / ms / 1e6, "bound_ms": bound_ms,
                          "bound_by": "operations" if batch * flops / BF16_PEAK_FLOPS
                          > moved / HBM_BYTES_PER_S else "bytes", **kernels}
        if kernels["device_busy_ms"] is not None:
            timings[batch]["device_idle_share"] = max(0.0, 1 - kernels["device_busy_ms"] / ms)
    print(f"phase 6: LabelerNet full width ({params} parameters, {flops / 1e9:.3f} GFLOP per "
          f"{LABEL_SIZE}² image from the shapes): card vs CPU bf16 max |dprob| {dprob:.5f}, "
          f"{inside} decisions flip inside {LABEL_THRESHOLD} ± {LABEL_BAND}, 0 outside; "
          f"{timings[LABEL_BATCH]['ms']:.3f} ms at batch {LABEL_BATCH}, "
          f"{timings[LABEL_BATCH_LARGE]['ms']:.3f} ms at batch {LABEL_BATCH_LARGE} "
          f"({timings[LABEL_BATCH_LARGE]['images_per_s']:.0f} images/s, "
          f"{timings[LABEL_BATCH_LARGE]['gflop_per_s']:.0f} GFLOP/s)", flush=True)
    return {"parameters": params, "gflop_per_image": flops / 1e9, "max_dprob": dprob,
            "flips_in_band": inside, "cpu_forward_s": cpu_s,
            "batch_16": timings[LABEL_BATCH], "batch_256": timings[LABEL_BATCH_LARGE]}


def _cli_json(argv: list[str]) -> tuple[int, dict]:
    """`python -m spacedrive_tpu_torch <argv>` in process; (rc, its JSON)."""
    import contextlib
    import io

    from spacedrive_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    return rc, json.loads(out.getvalue())


def labelled_scan(corpus: str, data_dir: str) -> dict:
    """`index --library` of `corpus` on the card with a LabelerNet
    checkpoint provisioned in `data_dir`, the actor's decoded inputs
    recorded (the smoke wraps `_decode_chunk`): every image row the port
    decodes is labelled, and the label rows equal a CPU forward of the
    checkpoint on those inputs outside the band. Returns the scan, the
    image rows, the label rows (object_id, label id, name), the classes
    and the decisions that differ inside the band."""
    from spacedrive_tpu_torch.models import checkpoint, labeler, labeler_actor
    from spacedrive_tpu_torch.object.media.thumbnail.process import IMAGE_EXTENSIONS

    decoded: dict[int, np.ndarray] = {}  # object id → the actor's decoded input
    decode = labeler_actor.ImageLabeler._decode_chunk

    def recording(self, chunk):
        out = decode(self, chunk)
        for entry, arr in zip(chunk, out):
            if arr is not None:
                decoded[entry["object_id"]] = arr
        return out

    labeler_actor.ImageLabeler._decode_chunk = recording
    try:
        scan = run_library_pass(corpus, data_dir)
    finally:
        labeler_actor.ImageLabeler._decode_chunk = decode
    lb = scan["labeler"]
    images = [r for r in scan["rows"]
              if (r["extension"] or "").lower() in IMAGE_EXTENSIONS and r["object_id"]]
    check(lb["errors"] == 0 and lb["skipped"] == 0, f"the labeler failed or skipped: {lb}")
    check(lb["labeled"] == len(images) and len(decoded) == len({r["object_id"] for r in images}),
          f"labelled {lb['labeled']} of {len(images)} image rows")
    check(lb["forwards"] == -(-len(images) // labeler_actor.DEFAULT_BATCH_SIZE),
          f"{lb['forwards']} labeler forwards for {len(images)} images")

    tree, meta = checkpoint.load(os.path.join(data_dir, "image_labeler", "weights.npz"))
    classes = list(meta["classes"])
    cpu = labeler.from_flax(tree, len(classes), meta["widths"], meta["depths"], "cpu")
    ids = sorted(decoded)
    want = labeler.infer_step(cpu, torch.from_numpy(np.stack([decoded[i] for i in ids])))[0]
    want = want.numpy()
    lib = _open_library(data_dir)
    try:
        rows = lib.db.query("SELECT lo.object_id, l.id, l.name FROM label_on_object lo "
                            "JOIN label l ON l.id = lo.label_id")
    finally:
        lib.close()
    got = np.zeros_like(want)  # 1 where the card wrote the label
    pos = {oid: k for k, oid in enumerate(ids)}
    for r in rows:
        if r["name"] in classes:
            got[pos[r["object_id"]], classes.index(r["name"])] = 1.0
    outside, inside = _label_flips(got, want)
    check(outside == 0, f"{outside} label rows differ from the CPU forward outside the band")
    return {"scan": scan, "images": images, "rows": rows, "classes": classes,
            "flips_in_band": inside}


def check_labeled_library(data_dir: str, corpus: str) -> dict:
    """(b) `labeler provision --bundled` into the library's data dir, then
    `index --library` once more (`labelled_scan`): every image row the
    port decodes is labelled on the card, with the names a CPU forward of
    the port gives on the same decoded inputs (outside the band);
    `search.paths` filtered by a written label returns exactly its files;
    `labeler status` says enabled."""
    from spacedrive_tpu_torch.api.search import search_paths

    rc, info = _cli_json(["labeler", "provision", "--bundled", "--data-dir", data_dir])
    check(rc == 0 and info.get("kind") == "checkpoint", f"labeler provision --bundled: {info}")
    rc, status = _cli_json(["labeler", "status", "--data-dir", data_dir])
    check(rc == 0 and status["enabled"] is True, f"labeler status: {status}")

    got = labelled_scan(corpus, data_dir)
    scan, rows, classes, inside = got["scan"], got["rows"], got["classes"], got["flips_in_band"]
    lb, images = scan["labeler"], got["images"]
    lib = _open_library(data_dir)
    try:
        by_label = collections.Counter(r["name"] for r in rows if r["name"] in classes)
        name = by_label.most_common(1)[0][0]
        lid = next(r["id"] for r in rows if r["name"] == name)
        hits, cursor = [], None
        while True:  # the API's pages of at most 100 rows
            page = search_paths(lib, {"filter": {"labels": [lid]}, "take": 100,
                                      **({"cursor": cursor} if cursor else {})})
            hits += page["nodes"]
            cursor = page["cursor"]
            if cursor is None:
                break
        want_ids = [r["id"] for r in lib.db.query(
            "SELECT id FROM file_path WHERE object_id IN (SELECT object_id FROM "
            "label_on_object WHERE label_id = ?) ORDER BY id", (lid,))]
        check(sorted(n["id"] for n in hits) == want_ids,
              f"search.paths filtered by {name!r} != its files")
        label_rows = lib.db.count("label")
    finally:
        lib.close()
    semantic = _search(data_dir, name, True, 5)
    check(semantic["resolved"] is True, f"semantic search by the label {name!r} did not resolve")
    n_rows = sum(by_label.values())
    print(f"phase 6: {lb['labeled']} image rows labelled on the card in {lb['forwards']} "
          f"forwards, {n_rows} label_on_object rows == the CPU forward ({inside} decisions "
          f"inside the band); search by {name!r} returns its {len(want_ids)} files", flush=True)
    return {"rescan_s": scan["numbers"]["seconds"], "k1_launches": scan["launches"],
            "images": len(images), "labeled": lb["labeled"], "forwards": lb["forwards"],
            "decode_s": lb["stage_s"].get("decode", 0.0),
            "forward_s": lb["stage_s"].get("forward", 0.0),
            "write_s": lb["stage_s"].get("write", 0.0),
            "label_on_object_rows": n_rows, "label_rows": label_rows, "flips_in_band": inside,
            "labels": dict(by_label)}


def _onnx_graphs(rng) -> dict[str, bytes]:
    """A seeded CNN classifier (Conv s2 p1 → BN → SiLU → MaxPool → GAP →
    Gemm) and a YOLOv8-layout head ([B, 4 + 80, 784 anchors]) at the
    actor's batch and 224²."""
    from spacedrive_tpu_torch.models import onnx_proto as P

    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = P.make_value_info("x", (LABEL_BATCH, 3, LABEL_SIZE, LABEL_SIZE))
    cnn = P.make_model([
        P.make_node("Conv", ["x", "w", "b"], ["c"], strides=[2, 2], pads=[1, 1, 1, 1],
                    kernel_shape=[3, 3]),
        P.make_node("BatchNormalization", ["c", "g", "be", "mu", "var"], ["bn"]),
        P.make_node("Sigmoid", ["bn"], ["sig"]),
        P.make_node("Mul", ["bn", "sig"], ["silu"]),
        P.make_node("MaxPool", ["silu"], ["mp"], kernel_shape=[2, 2], strides=[2, 2]),
        P.make_node("GlobalAveragePool", ["mp"], ["gap"]),
        P.make_node("Flatten", ["gap"], ["flat"]),
        P.make_node("Gemm", ["flat", "fw", "fb"], ["out"], transB=1),
    ], [x], [P.make_value_info("out", (LABEL_BATCH, 5))], {
        "w": f(64, 3, 3, 3), "b": f(64), "g": f(64), "be": f(64), "mu": f(64) * 0.1,
        "var": rng.random(64).astype(np.float32) + 0.5, "fw": f(5, 64), "fb": f(5)})
    head = P.make_model([
        P.make_node("Conv", ["x", "w"], ["c"], kernel_shape=[8, 8], strides=[8, 8]),
        P.make_node("Reshape", ["c", "shape"], ["r"]),
        P.make_node("Transpose", ["r"], ["rt"], perm=[0, 2, 1]),
        P.make_node("MatMul", ["rt", "m"], ["mm"]),
        P.make_node("Sigmoid", ["mm"], ["s"]),
        P.make_node("Transpose", ["s"], ["out"], perm=[0, 2, 1]),
    ], [x], [P.make_value_info("out", (LABEL_BATCH, 84, 784))], {
        "w": f(32, 3, 8, 8) * 0.1, "shape": np.array([LABEL_BATCH, 32, 784], np.int64),
        "m": f(32, 84) * 0.2})
    return {"cnn": P.encode_model(cnn), "yolo_head": P.encode_model(head)}


def check_onnx(rng, tmp: str, images: list[str]) -> dict:
    """(c) The ONNX executor: each graph on the card against the CPU in
    float32, again with the TF32 globals on; then `labeler provision
    --from model.onnx` and one actor batch of 16 corpus images on the
    card against the CPU actor."""
    import asyncio
    import types

    from spacedrive_tpu_torch.db.database import LibraryDb
    from spacedrive_tpu_torch.models import labeler_actor, onnx_runtime

    x = rng.random((LABEL_BATCH, 3, LABEL_SIZE, LABEL_SIZE), dtype=np.float32)
    out: dict = {}
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    graphs = _onnx_graphs(rng)
    for name, buf in graphs.items():
        want = onnx_runtime.load(buf, "cpu")(torch.from_numpy(x))[0].numpy()
        model = onnx_runtime.load(buf, DEVICE)
        dev_x = torch.from_numpy(x).to(DEVICE)
        runs = {}
        try:
            for tf32 in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
                runs[tf32] = model(dev_x)[0].cpu().numpy()
                check(np.allclose(runs[tf32], want, rtol=ONNX_RTOL, atol=ONNX_ATOL),
                      f"ONNX {name} on the card (TF32 globals {tf32}) differs from the CPU: "
                      f"max |d| {np.abs(runs[tf32] - want).max()}")
                check(torch.backends.cudnn.allow_tf32 is tf32, "the executor left TF32 flags")
            ms = cuda_ms(lambda: model(dev_x), reps=20)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        out[name] = {"max_abs_err": float(np.abs(runs[False] - want).max()),
                     "tf32_on_bitwise_equal": bool(np.array_equal(runs[True], runs[False])),
                     "ms": ms, "nodes": len(model.nodes), **device_kernels(lambda: model(dev_x))}

    src = os.path.join(tmp, "classifier.onnx")
    with open(src, "wb") as fh:
        fh.write(graphs["cnn"])
    names = os.path.join(tmp, "classes.txt")
    with open(names, "w") as fh:
        fh.write("\n".join(f"class {c}" for c in "abcde") + "\n")
    data_dir = os.path.join(tmp, "onnx_node")
    rc, info = _cli_json(["labeler", "provision", "--from", src, "--classes", names,
                          "--data-dir", data_dir, "--device", DEVICE])
    check(rc == 0 and info["kind"] == "onnx" and info["classes"] == 5,
          f"labeler provision --from model.onnx: {info}")
    lib = types.SimpleNamespace(id="66666666-6666-6666-6666-666666666666",
                                db=LibraryDb(None, memory=True))
    entries = [{"file_path_id": i, "path": p,
                "object_id": lib.db.insert("object", pub_id=os.urandom(16), kind=5)}
               for i, p in enumerate(images[:LABEL_BATCH])]
    actor = labeler_actor.ImageLabeler(os.path.join(data_dir, "image_labeler"), device=DEVICE)

    async def one_batch():
        try:
            await actor.wait_batch(actor.new_batch(lib, entries))
        finally:
            await actor.shutdown()

    asyncio.run(one_batch())
    check(actor.labeled == LABEL_BATCH and actor.forwards == 1 and actor.errors == 0,
          f"the ONNX actor batch: labeled {actor.labeled}, forwards {actor.forwards}")
    cpu_actor = labeler_actor.ImageLabeler(os.path.join(data_dir, "image_labeler"), device="cpu")
    check(cpu_actor._ensure_model(), "the CPU actor did not load the model")
    arrays = np.stack(cpu_actor._decode_chunk(entries))
    want = cpu_actor._infer_chunk(arrays)
    got = actor._infer_chunk(arrays)
    check(np.allclose(got, want, rtol=ONNX_RTOL, atol=ONNX_ATOL),
          "the ONNX actor on the card differs from the CPU actor")
    written = {(r["object_id"], r["name"]) for r in lib.db.query(
        "SELECT lo.object_id, l.name FROM label_on_object lo JOIN label l ON l.id = lo.label_id")}
    check(written == {(e["object_id"], actor.classes[j]) for e, row in zip(entries, want)
                      for j in np.nonzero(row >= LABEL_THRESHOLD)[0]},
          "the ONNX actor's label rows differ from the CPU probabilities")
    lib.db.close()
    print(f"phase 6: ONNX on the card == CPU (rtol {ONNX_RTOL}) with the TF32 globals on and "
          f"off: cnn {out['cnn']['ms']:.3f} ms, yolo_head {out['yolo_head']['ms']:.3f} ms at "
          f"batch {LABEL_BATCH}; provision --from model.onnx + one actor batch: "
          f"{len(written)} label rows == CPU", flush=True)
    out["actor_rows"] = len(written)
    return out


def phase_labeler(rng, tmp: str, p4: dict) -> dict:
    t_phase = time.perf_counter()
    steps_s: dict[str, float] = {}

    def step(name: str, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        steps_s[name] = time.perf_counter() - t0
        return result

    net = step("labeler_net", check_labeler_net, rng)
    library = step("library", check_labeled_library, p4["data_dir"], p4["corpus"])
    onnx = step("onnx", check_onnx, rng, tmp, p4["images"])
    out = {"net": net, "library": library, "onnx": onnx, "steps_s": steps_s,
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps({"labeler": out}), flush=True)
    return {"launches": {"labeler_rescan": library["k1_launches"]}}


# --- phase 7: training ---------------------------------------------------

# One training step, card against CPU, both bf16 (cuDNN's weight gradients
# against oneDNN's, in another order and not bitwise reproducible): the
# loss within TRAIN_LOSS_ATOL, each parameter's gradient within
# TRAIN_GRAD_RTOL relative L2 and cosine >= TRAIN_GRAD_COS, the
# parameters after the step within one AdamW step each way (2·lr): the
# bounds tests/test_torch_train.py states against the JAX step.
TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_COS = 0.015, 0.25, 0.97
TRAIN_CHECK_BATCH, TRAIN_BATCH, TRAIN_TIMED_STEPS = 8, 64, 30
# 7b: a folder of SCENE_CLASSES x SCENES_PER_KIND renders at the
# TrainConfig defaults; HELD_OUT_PER_KIND renders from another seed to
# label after training
SCENES_PER_KIND, HELD_OUT_PER_KIND, HELD_OUT_SEED = 120, 8, 987654
MIN_EVAL_TOP1, MIN_HELD_OUT_HITS = 0.9, 6
# float32 paths held with the TF32 globals on (tests/test_torch_gpu.py's
# tolerances): the resize within 1 level, embeddings and scores 1e-5
TF32_EMBED_TOL, TF32_SCORE_TOL = 1e-5, 1e-5


def _rel_cos(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    got, want = got.double().ravel(), want.double().ravel()
    return (float((got - want).norm() / want.norm()),
            float(got @ want / (got.norm() * want.norm())))


def check_train_step(rng) -> dict:
    """(a) `labeler.train_step` at the full width (80 classes, widths
    32-256, depths 1,2,2,1, 224²) from one seeded `create_train_state`:
    one step on the card against one on the CPU on a seeded batch of 8;
    then steps at batch 64 timed with CUDA events, one traced."""
    from spacedrive_tpu_torch.models import labeler

    seed = int(rng.integers(1 << 31))
    size = labeler.DEFAULT_IMAGE_SIZE
    cpu, cpu_opt = labeler.create_train_state(torch.Generator().manual_seed(seed))
    gpu, gpu_opt = labeler.create_train_state(torch.Generator().manual_seed(seed),
                                              model=labeler.LabelerNet().to(DEVICE))
    lr = cpu_opt.defaults["lr"]
    x = torch.from_numpy(rng.random((TRAIN_CHECK_BATCH, size, size, 3), dtype=np.float32))
    y = torch.zeros((TRAIN_CHECK_BATCH, labeler.NUM_CLASSES))
    y[torch.arange(TRAIN_CHECK_BATCH),
      torch.from_numpy(rng.integers(0, labeler.NUM_CLASSES, TRAIN_CHECK_BATCH))] = 1.0
    t0 = time.perf_counter()
    want = float(labeler.train_step(cpu, cpu_opt, x, y))
    cpu_s = time.perf_counter() - t0
    got = float(labeler.train_step(gpu, gpu_opt, x.to(DEVICE), y.to(DEVICE)))
    check(np.isfinite(got) and abs(got - want) <= TRAIN_LOSS_ATOL,
          f"train_step loss on the card {got} vs the CPU {want}")
    worst_rel, worst_cos, max_dp = 0.0, 1.0, 0.0
    for (name, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        rel, cos = _rel_cos(q.grad.cpu(), p.grad)
        check(rel <= TRAIN_GRAD_RTOL and cos >= TRAIN_GRAD_COS,
              f"gradient of {name}: card vs CPU relative L2 {rel}, cosine {cos}")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        max_dp = max(max_dp, float((q.detach().cpu() - p.detach()).abs().max()))
    check(max_dp <= 2 * lr * 1.001 + 1e-6, f"parameters after the step differ by {max_dp}")

    images = torch.rand((TRAIN_BATCH, size, size, 3), device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(seed))
    labels = torch.zeros((TRAIN_BATCH, labeler.NUM_CLASSES), device=DEVICE)
    labels[torch.arange(TRAIN_BATCH), torch.arange(TRAIN_BATCH) % labeler.NUM_CLASSES] = 1.0

    def step():
        return labeler.train_step(gpu, gpu_opt, images, labels)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_TIMED_STEPS):
        loss = step()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / TRAIN_TIMED_STEPS
    check(bool(torch.isfinite(loss)), "the timed steps' loss is not finite")
    peak = torch.cuda.max_memory_allocated()
    kernels = device_kernels(step)
    work = 3 * labeler.conv_flops(gpu, size) * TRAIN_BATCH
    bound_ms = work / BF16_PEAK_FLOPS * 1e3
    out = {"loss_cpu": want, "loss_card": got, "cpu_step_s": cpu_s,
           "grad_rel_l2_max": worst_rel, "grad_cos_min": worst_cos, "param_max_abs_diff": max_dp,
           "batch": TRAIN_BATCH, "timed_steps": TRAIN_TIMED_STEPS, "ms_per_step": ms,
           "images_per_s": TRAIN_BATCH / ms * 1e3, "tflop_per_s": work / ms / 1e9,
           "bound_ms": bound_ms, "bound_share": bound_ms / ms, "peak_memory_bytes": peak,
           **kernels}
    if kernels["device_busy_ms"] is not None:
        out["device_idle_share"] = max(0.0, 1 - kernels["device_busy_ms"] / ms)
    print(f"phase 7: train_step full width, card vs CPU at batch {TRAIN_CHECK_BATCH}: loss "
          f"{got:.5f} vs {want:.5f}, gradients within {worst_rel:.4f} relative L2 (cosine >= "
          f"{worst_cos:.5f}), parameters within {max_dp:.2e}; batch {TRAIN_BATCH}: "
          f"{ms:.3f} ms per step ({out['images_per_s']:.0f} images/s, "
          f"{out['tflop_per_s']:.1f} TFLOP/s, {100 * out['bound_share']:.2f}% of the bf16 "
          f"bound), {kernels['kernels']} kernels per step, peak {peak / 2**30:.2f} GiB",
          flush=True)
    return out


def _save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def check_training_run(rng, tmp: str) -> dict:
    """(b) A user's training run: SCENES_PER_KIND renders of each scene
    kind at the TrainConfig defaults (96², widths 16-128, batch 32, 600
    steps) in a folder per kind, `labeler train` on the card into a fresh
    data dir, then `index --library` of HELD_OUT_PER_KIND held-out renders
    per kind (seed 987654) there: eval top-1 >= MIN_EVAL_TOP1, every row
    labelled, >= MIN_HELD_OUT_HITS of each kind's rows carry its name at
    the actor's threshold, and the rows equal a CPU forward of the saved
    checkpoint (`labelled_scan`)."""
    from spacedrive_tpu_torch.models import train

    cfg = train.TrainConfig()
    t0 = time.perf_counter()
    tree, held = os.path.join(tmp, "scenes"), os.path.join(tmp, "held_out")
    os.makedirs(held)
    r = np.random.default_rng(int(rng.integers(1 << 31)))
    for kind in train.SCENE_CLASSES:
        os.makedirs(os.path.join(tree, kind))
        for i in range(SCENES_PER_KIND):
            _save_png(os.path.join(tree, kind, f"{i:04d}.png"),
                      train.render_scene(kind, r, cfg.image_size))
    r = np.random.default_rng(HELD_OUT_SEED)
    for kind in train.SCENE_CLASSES:
        for i in range(HELD_OUT_PER_KIND):
            _save_png(os.path.join(held, f"{kind.replace(' ', '_')}_{i}.png"),
                      train.render_scene(kind, r, cfg.image_size))
    render_s = time.perf_counter() - t0

    data_dir = os.path.join(tmp, "train_node")
    t0 = time.perf_counter()
    rc, out = _cli_json(["labeler", "train", tree, "--data-dir", data_dir, "--device", DEVICE])
    train_s = time.perf_counter() - t0
    check(rc == 0 and out["checkpoint"] == os.path.join(data_dir, "image_labeler", "weights.npz"),
          f"labeler train: {out}")
    metrics = out["metrics"]
    check(metrics["eval_top1"] >= MIN_EVAL_TOP1 and np.isfinite(metrics["final_loss"]),
          f"labeler train's metrics {metrics}: eval top-1 under {MIN_EVAL_TOP1}")

    got = labelled_scan(held, data_dir)
    scan = got["scan"]
    names: dict[int, set[str]] = collections.defaultdict(set)
    for row in got["rows"]:
        names[row["object_id"]].add(row["name"])
    hits = collections.Counter()
    for row in got["images"]:
        kind = row["name"].rsplit("_", 1)[0].replace("_", " ")
        hits[kind] += kind in names[row["object_id"]]
    check(len(got["images"]) == len(train.SCENE_CLASSES) * HELD_OUT_PER_KIND,
          f"{len(got['images'])} held-out image rows")
    check(all(hits[k] >= MIN_HELD_OUT_HITS for k in train.SCENE_CLASSES),
          f"held-out renders named by kind: {dict(hits)} (< {MIN_HELD_OUT_HITS} of "
          f"{HELD_OUT_PER_KIND})")
    lb = scan["labeler"]
    print(f"phase 7: labeler train over {len(train.SCENE_CLASSES) * SCENES_PER_KIND} renders: "
          f"{cfg.steps} steps in {train_s:.1f} s ({cfg.steps / train_s:.1f} steps/s with data, "
          f"eval and save), eval top-1 {metrics['eval_top1']:.3f}; index of "
          f"{len(got['images'])} held-out renders: {lb['labeled']} labelled, by kind "
          f"{dict(hits)}, rows == the CPU forward ({got['flips_in_band']} decisions inside "
          f"the band), {scan['launches']} K1 launches", flush=True)
    return {"renders": len(train.SCENE_CLASSES) * SCENES_PER_KIND, "render_s": render_s,
            "train_s": train_s, "steps": cfg.steps, "steps_per_s": cfg.steps / train_s,
            "metrics": metrics, "index_s": scan["numbers"]["seconds"],
            "held_out": len(got["images"]), "labeled": lb["labeled"],
            "forwards": lb["forwards"], "hits_by_kind": dict(hits),
            "flips_in_band": got["flips_in_band"], "k1_launches": scan["launches"]}


def check_tf32(rng) -> dict:
    """(c) The resize, the embedder and the scorer on the card with the
    TF32 globals on and `set_float32_matmul_precision("high")`, against
    the CPU at their stated tolerances; the globals are off again after."""
    import types

    from spacedrive_tpu_torch.object.search import index as search_index
    from spacedrive_tpu_torch.ops import embed_torch
    from spacedrive_tpu_torch.ops import thumbnail_torch as tt

    shapes = [(3024, 4032), (4032, 3024), (1080, 1920), (700, 500)]
    images = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for h, w in shapes]
    targets = [tt.scale_dimensions(w, h)[::-1] for h, w in shapes]
    x = rng.random((64, 32, 32, 3), dtype=np.float32)
    m = rng.normal(size=(65_536, 128)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    m[[10, 999, 40_000]] = m[3]
    idx = search_index.LibraryIndex(types.SimpleNamespace(node=None))
    idx._matrix, idx._ids, idx._loaded = m, list(range(len(m))), True
    probes = (m[3], rng.normal(size=128).astype(np.float32))
    want_resize = tt.resize_batch(images, targets, device="cpu")
    want_embed = embed_torch.embed_batch(x, "cpu")
    want_query = [idx.query(p, k=100, device="cpu") for p in probes]
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        resize = tt.resize_batch(images, targets, device=DEVICE)
        embed = embed_torch.embed_batch(x, DEVICE)
        query = [idx.query(p, k=100, device=DEVICE) for p in probes]
        still_on = torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    check(still_on, "a float32 path left the caller's TF32 globals changed")
    levels = max(int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max())
                 for g, w in zip(resize, want_resize))
    check(all(g.shape == w.shape for g, w in zip(resize, want_resize)) and levels <= 1,
          f"resize with TF32 on: {levels} levels from the CPU")
    embed_err = float(np.abs(embed - want_embed).max())
    check(np.allclose(embed, want_embed, atol=TF32_EMBED_TOL, rtol=TF32_EMBED_TOL),
          f"embeddings with TF32 on: max |d| {embed_err} from the CPU")
    score_err = 0.0
    for got, want in zip(query, want_query):
        check([i for i, _ in got] == [i for i, _ in want], "scorer ranking with TF32 on")
        d = np.abs(np.array([s for _, s in got]) - np.array([s for _, s in want]))
        score_err = max(score_err, float(d.max()))
        check(np.allclose([s for _, s in got], [s for _, s in want], atol=TF32_SCORE_TOL,
                          rtol=TF32_SCORE_TOL), f"scores with TF32 on: max |d| {score_err}")
    check([i for i, _ in query[0][:4]] == [3, 10, 999, 40_000], "scorer ties with TF32 on")
    print(f"phase 7: TF32 globals on: resize within {levels} level(s) of the CPU, embeddings "
          f"within {embed_err:.2e}, scores within {score_err:.2e}, ties in row order", flush=True)
    return {"resize_max_levels": levels, "embed_max_abs_err": embed_err,
            "score_max_abs_err": score_err}


def phase_training(rng, tmp: str) -> dict:
    t_phase = time.perf_counter()
    steps_s: dict[str, float] = {}

    def step(name: str, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        steps_s[name] = time.perf_counter() - t0
        return result

    train_step = step("train_step", check_train_step, rng)
    run = step("training_run", check_training_run, rng, tmp)
    tf32 = step("tf32", check_tf32, rng)
    out = {"train_step": train_step, "training_run": run, "tf32": tf32, "steps_s": steps_s,
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps({"training": out}), flush=True)
    return {"launches": {"training_index": run["k1_launches"]}}


# --- phase 8: the device seam and the fault plane ---------------------------

# slot lists [cuda:0] * k on the one card: the split's overhead, not scaling
SEAM_SLOTS = (1, 2, 3, 4)
SEAM_ROWS_PER_SLOT = 1024  # the production dispatch: 1024 x 57 chunks per slot
SEAM_PAD_ROWS = (5, 33, 1031)
N_SEAM_REF = 64  # rows held against blake3_ref (pure Python, ~0.5 MB/s)
N_SEAM_IMAGES = 32
N_SEAM_HASHES = 4096
N_SEAM_ACTOR = 8
N_SEAM_PROFILE = 64
N_LAST_RUNG = 256  # hot and small messages each, through the cas last rung
# the time limit's cuts of earlier paths (phases 14 and 15 add ~200 s):
# 8(b) runs on every 8th of phase 3's files of each kind, 9(a) and (c) on
# every 8th image and every 4th other file
SEAM_FAULTS_EVERY = 8
POOL_IMAGES_EVERY = 8
POOL_OTHERS_EVERY = 4
# every pipeline fault family once, on the main path
SEAM_FAULTS = ("device.blake3:xla:times=1;device.thumbnail:raise:times=1;"
               "embed.forward:xla:times=1;feeder.fetch:crash:times=1")
# where a one-slot ladder ends after a failure and a re-armed probe: the
# "one_device" script of tests/test_torch_mesh.py (the JAX transitions),
# and tests/test_torch_chaos.py's pass under SEAM_FAULTS at k = 1
ONE_DEVICE_END_LEVEL = 1
K1_KERNEL = "blake3_chunk_cvs_kernel"


def degradation() -> dict:
    """Every degradation counter the port keeps (all zero in a healthy
    process)."""
    from spacedrive_tpu_torch.parallel import mesh
    from spacedrive_tpu_torch.telemetry import metrics as tm
    from spacedrive_tpu_torch.telemetry.events import RESILIENCE_EVENTS

    return {
        "demotion_level": mesh.LADDER.level,
        "demotion_gauge": tm.DEVICE_DEMOTION.value(),
        "cas_fallbacks": tm.CAS_BACKEND_FALLBACK.value(),
        "host_queries": tm.SEARCH_QUERIES.value(path="host"),
        "thumbnail_cpu_fallbacks": sum(e["type"] == "thumbnail_cpu_fallback"
                                       for e in RESILIENCE_EVENTS.snapshot()),
        "feeder_restarts": tm.FEEDER_RESTARTS.value(),
        "fault_activations": tm.FAULTS_INJECTED.value(),
        "pool_errors": tm.PROCPOOL_JOBS.value(result="error"),
        "pool_retries": tm.PROCPOOL_JOBS.value(result="retried"),
        "pool_restarts": tm.PROCPOOL_RESTARTS.value(),
    }


def check_healthy(phase: str, since: dict | None = None) -> None:
    """Phases 2-7 and 9(a) run with no fault plan: a demotion, a cas
    fallback, a host-ranked query, a CPU-resized chunk, a feeder
    restart, a fault activation, or a process-pool error, retry or
    restart means a degraded run, which must not pass as healthy. With
    `since` (a `degradation()` taken before the phase) the counters are
    read as the phase's deltas."""
    from spacedrive_tpu_torch.utils import faults

    got = degradation()
    if since is not None:
        got = {k: v if k.startswith("demotion") else v - since[k] for k, v in got.items()}
    check(faults.active_plan() is None and not any(got.values()),
          f"phase {phase} degraded: {got}")


def snapshot_corpus(corpus: str, root: str, keep: set[str] | None = None) -> str:
    """Hard links to phase 3's files, taken before phase 4 adds, rewrites
    and deletes files in the corpus (its 32 in-place rewrites reach the
    links too; phase 8 holds those to the plain path); with `keep`, to
    those of its paths relative to `corpus` only."""
    for dirpath, _dirs, files in os.walk(corpus):
        dst = os.path.join(root, os.path.relpath(dirpath, corpus))
        os.makedirs(dst, exist_ok=True)
        for f in files:
            if keep is None or os.path.relpath(os.path.join(dirpath, f), corpus) in keep:
                os.link(os.path.join(dirpath, f), os.path.join(dst, f))
    return root


def every_nth(corpus: str, images_step: int, others_step: int) -> set[str]:
    """Every `images_step`-th image and every `others_step`-th other file
    of `corpus` (paths relative to it, in sorted order): a cut of an
    earlier phase's depth for the smoke's time limit."""
    files = sorted(os.path.relpath(os.path.join(d, f), corpus)
                   for d, _, fs in os.walk(corpus) for f in fs)
    images = [f for f in files if f.endswith((".jpg", ".png"))]
    others = [f for f in files if not f.endswith((".jpg", ".png"))]
    return set(images[::images_step]) | set(others[::others_step])


def k1_ms_by_slots(msgs: list[bytes], dev: torch.device) -> dict[int, float]:
    """K1 alone on one SEAM_ROWS_PER_SLOT x 57 share per slot, each slot on its own
    stream of the one card, for every slot count: median ms."""
    from spacedrive_tpu_torch.ops import blake3_cuda, blake3_torch, cas

    arr, lens = cas.pack_canonical_batch(msgs, cas.LARGE_CHUNKS)
    lanes, _ = blake3_torch.chunk_lanes(blake3_torch.host_words(arr).to(dev),
                                        torch.from_numpy(lens).to(dev), cas.LARGE_CHUNKS)
    streams = [torch.cuda.Stream(dev) for _ in SEAM_SLOTS]

    def k1_on(k: int) -> None:
        cur = torch.cuda.current_stream()
        for st in streams[:k]:
            st.wait_stream(cur)
            with torch.cuda.stream(st):
                blake3_cuda.chunk_cvs(*lanes)
        for st in streams[:k]:
            cur.wait_stream(st)

    return {k: cuda_ms(lambda k=k: k1_on(k), reps=20) for k in SEAM_SLOTS}


def check_sharded(rng, p3: dict) -> dict:
    """(a) cas, resize, embed and the Hamming matrix over [cuda:0] * k
    against the single-device path; K1 timed per slot count."""
    from spacedrive_tpu_torch.models import embedder
    from spacedrive_tpu_torch.object.media.thumbnail import process
    from spacedrive_tpu_torch.ops import blake3_cuda, cas, embed_torch, phash_torch, thumbnail_torch
    from spacedrive_tpu_torch.ops.blake3_ref import StreamingBlake3

    dev = torch.device("cuda", 0) if DEVICE == "cuda" else torch.device(DEVICE)
    hot = [rng.bytes(cas.LARGE_MSG_LEN) for _ in range(SEAM_ROWS_PER_SLOT * max(SEAM_SLOTS))]
    single = cas.cas_ids(hot, DEVICE)
    for i in rng.choice(len(hot), N_SEAM_REF, replace=False):
        check(single[i] == StreamingBlake3().update(hot[i]).hexdigest()[:16],
              f"cas_id of hot row {i} differs from blake3_ref")
    blake3_cuda.chunk_cvs.launches = 0
    for k in SEAM_SLOTS:
        for rows in (SEAM_ROWS_PER_SLOT * k, *SEAM_PAD_ROWS):
            got = cas.cas_ids_begin(hot[:rows], devices=[dev] * k)()
            check(got == single[:rows], f"{k}-slot cas_ids of {rows} rows differ")
    launches = blake3_cuda.chunk_cvs.launches

    k1_ms = k1_ms_by_slots(hot[:SEAM_ROWS_PER_SLOT], dev)

    imgs = sorted((im for im in p3["images"] if max(im[1], im[2]) <= 4 * min(im[1], im[2])),
                  key=lambda im: im[1] * im[2])[:N_SEAM_IMAGES]
    decoded = [process.decode_image(p) for p, *_ in imgs]
    arrays, targets = [d.array for d in decoded], [d.target for d in decoded]
    one = thumbnail_torch.resize_batch(arrays, targets, devices=[dev])
    planes = np.stack([embedder.decode_image(p) for p, *_ in imgs])
    vec_one = embed_torch.embed_batch(planes, devices=[dev])
    resize_diff, embed_diff = {}, {}
    for k in (2, 4):
        got = thumbnail_torch.resize_batch(arrays, targets, devices=[dev] * k)
        check(all(g.shape == o.shape for g, o in zip(got, one)), f"{k}-slot resize shapes")
        resize_diff[k] = max(int(np.abs(g.astype(int) - o.astype(int)).max())
                             for g, o in zip(got, one))
        check(resize_diff[k] <= 1, f"{k}-slot resize differs by {resize_diff[k]} levels")
        vec = embed_torch.embed_batch(planes, devices=[dev] * k)
        embed_diff[k] = float(np.abs(vec - vec_one).max())
        check(np.allclose(vec, vec_one, atol=1e-5, rtol=1e-5),
              f"{k}-slot embeddings differ by {embed_diff[k]}")

    hashes = [rng.bytes(8) for _ in range(N_SEAM_HASHES)]
    want = phash_torch.hamming_matrix(hashes, DEVICE)
    for slots in (None, [dev] * 4):
        got = phash_torch.hamming_matrix_sharded(hashes, DEVICE, devices=slots)
        check(got.shape == want.shape and np.array_equal(got, want),
              f"hamming_matrix_sharded over {slots} != hamming_matrix")
    print(f"phase 8: sharded cas == single device at k = {SEAM_SLOTS} "
          f"({SEAM_ROWS_PER_SLOT} x 57 per slot and "
          f"{SEAM_PAD_ROWS} rows), {N_SEAM_REF} == blake3_ref; resize max |d| {resize_diff}, "
          f"embed max |d| {embed_diff} vs k = 1; hamming_matrix_sharded == hamming_matrix at "
          f"{N_SEAM_HASHES}; K1 ms by slot count {k1_ms}", flush=True)
    return {"launches": launches, "k1_ms_by_slots": k1_ms, "resize_max_diff": resize_diff,
            "embed_max_diff": embed_diff}


def check_faults_pass(p3: dict, p4: dict, snapshot: str, tmp: str) -> dict:
    """(b) `index_pass` over a quarter of phase 3's files (every
    SEAM_FAULTS_EVERY-th image and other file) under SEAM_FAULTS: the
    results of phase 3, the planned activations, one feeder restart, a
    cas fallback, and the one-device ladder's end level."""
    from spacedrive_tpu_torch.index_pass import index_pass
    from spacedrive_tpu_torch.ops import blake3_cuda, cas
    from spacedrive_tpu_torch.parallel import autotune, mesh
    from spacedrive_tpu_torch.utils import faults

    keep = every_nth(snapshot, SEAM_FAULTS_EVERY, SEAM_FAULTS_EVERY)
    snapshot = snapshot_corpus(snapshot, os.path.join(tmp, "seam_cut"), keep)
    before = degradation()
    mesh.LADDER.reset_timeout = 0.0
    plan = faults.FaultPlan.parse(SEAM_FAULTS, seed=1)
    blake3_cuda.chunk_cvs.launches = 0
    t0 = time.perf_counter()
    try:
        with faults.active(plan):
            result = index_pass(snapshot, os.path.join(tmp, "seam_data"), device=DEVICE,
                                keep_pixels=True)
    finally:
        mesh.LADDER.reset_timeout = 30.0
    seconds = time.perf_counter() - t0
    launches = blake3_cuda.chunk_cvs.launches
    after = degradation()
    end_level = mesh.LADDER.level
    # what the autotune rung cap makes of that level (the JAX rule): the
    # identify dispatch a one-card user gets until the process restarts
    rows_at_end = autotune.policy("identify").dispatch_rows_per_device()
    mesh.LADDER.reset()

    rewritten = {os.path.relpath(p, p3["corpus"]) for p in p4["rewritten"]}
    changed = []
    kept = {path: want for path, want in p3["cas_ids"].items()
            if os.path.relpath(path, p3["corpus"]) in keep}
    kept_cas = {p3["cas_ids"][p] for p, *_ in p3["images"]
                if os.path.relpath(p, p3["corpus"]) in keep}
    kept_images = kept_cas & p3["resized"].keys()
    for path, want in kept.items():
        rel = os.path.relpath(path, p3["corpus"])
        got = result.cas_ids[os.path.join(snapshot, rel)]
        if rel in rewritten:
            changed.append((got, os.path.join(snapshot, rel)))
        else:
            check(got == want, f"cas_id of {rel} under faults differs from phase 3")
    plain = plain_cas_ids([cas.read_message(p) for _, p in changed])
    check([g for g, _ in changed] == plain, "a rewritten file's cas_id differs from the plain path")
    check(result.resized.keys() == kept_images, "thumbnails under faults")
    for c in kept_images:
        check(np.array_equal(result.resized[c], p3["resized"][c]), f"thumbnail pixels of {c} changed")
    check(result.embeddings.keys() == kept_cas & p3["embeddings"].keys(),
          "embeddings under faults")
    worst = max(float(np.abs(result.embeddings[c] - p3["embeddings"][c]).max())
                for c in result.embeddings)
    check(worst <= 1e-5, f"embeddings under faults differ by {worst}")
    delta = {k: after[k] - before[k] for k in after}
    check(sum(plan.activations().values()) == 4 and delta["fault_activations"] == 4,
          f"activations {plan.activations()}")
    check(delta["feeder_restarts"] == 1, f"feeder restarts {delta['feeder_restarts']}")
    check(delta["cas_fallbacks"] >= 1, "no cas fallback under device.blake3")
    check(end_level == ONE_DEVICE_END_LEVEL,
          f"the ladder ended at level {end_level}, want {ONE_DEVICE_END_LEVEL}")
    print(f"phase 8: index_pass under {SEAM_FAULTS} in {seconds:.1f} s: {len(kept)} "
          f"cas_ids == phase 3 ({len(changed)} rewritten == plain path), {len(kept_images)} "
          f"thumbnails' pixels == phase 3, embeddings within {worst:.3g}; activations "
          f"{plan.activations()}, ladder ended at level {end_level}", flush=True)
    print(f"phase 8: policy('identify').dispatch_rows_per_device() at ladder level {end_level}: "
          f"{rows_at_end}", flush=True)
    return {"launches": launches, "seconds": seconds, "files": len(keep), "end_level": end_level,
            "dispatch_rows_at_end_level": rows_at_end,
            "activations": plan.activations(), "counter_deltas": delta,
            "embed_max_diff": worst}


def check_last_rung(rng) -> dict:
    """The cas ladder at the shipped reset_timeout, as users get it: one
    `device.blake3:xla` demotes the one card to the last rung, where the
    batch re-runs inside `finish()` on the card (K1 launches, every
    slot a CUDA device) and so does the next call: ids == the clean
    run's, and nothing hashes on the CPU."""
    from spacedrive_tpu_torch.ops import blake3_cuda, blake3_torch, cas
    from spacedrive_tpu_torch.parallel import mesh
    from spacedrive_tpu_torch.telemetry.events import RESILIENCE_EVENTS
    from spacedrive_tpu_torch.utils import faults

    check(mesh.LADDER.reset_timeout == mesh.DeviceLadder().reset_timeout,
          f"reset_timeout {mesh.LADDER.reset_timeout} is not the shipped default")
    msgs = [rng.bytes(cas.LARGE_MSG_LEN) for _ in range(N_LAST_RUNG)] + [
        rng.bytes(int(n)) for n in rng.integers(1, cas.MAX_SMALL_MSG_LEN, N_LAST_RUNG)]
    clean = cas.cas_ids(msgs, DEVICE)
    before = degradation()
    RESILIENCE_EVENTS.clear()
    slots, real = [], blake3_torch.hash_batch_begin

    def spy(arr, lens, c, devices):
        slots.extend(devices)
        return real(arr, lens, c, devices)

    plan = faults.FaultPlan.parse("device.blake3:xla:times=1")
    blake3_torch.hash_batch_begin = spy
    try:
        blake3_cuda.chunk_cvs.launches = 0
        with faults.active(plan):
            retried = cas.cas_ids(msgs, DEVICE)
        retry_launches, level = blake3_cuda.chunk_cvs.launches, mesh.LADDER.level
        blake3_cuda.chunk_cvs.launches = 0
        later = cas.cas_ids(msgs, DEVICE)
        later_launches = blake3_cuda.chunk_cvs.launches
    finally:
        blake3_torch.hash_batch_begin = real
        mesh.LADDER.reset()
    rung_events = sum(e["type"] == "cas_last_rung" for e in RESILIENCE_EVENTS.snapshot())
    RESILIENCE_EVENTS.clear()
    delta = {k: v - before[k] for k, v in degradation().items()}
    check(retried == clean and later == clean, "cas_ids at the last rung differ from the clean run")
    check(plan.activations() == {"device.blake3": 1}, f"activations {plan.activations()}")
    check(level == mesh.LEVEL_HOST, f"one failure on one card left the ladder at {level}")
    check(retry_launches > 0 and later_launches > 0,
          f"K1 launches at the last rung: {retry_launches} / {later_launches}")
    check(bool(slots) and all(d.type == "cuda" for d in slots),
          f"a last-rung share ran off the card: {sorted({str(d) for d in slots})}")
    check(rung_events == 2 and delta["cas_fallbacks"] == 3,
          f"last-rung events {rung_events}, cas fallbacks {delta['cas_fallbacks']}")
    print(f"phase 8: device.blake3:xla at reset_timeout {mesh.LADDER.reset_timeout:g} s: the "
          f"ladder fell to level {level}, the retry and the next call hashed {len(msgs)} "
          f"messages on the card ({retry_launches} / {later_launches} K1 launches), ids == clean",
          flush=True)
    return {"launches": retry_launches + later_launches, "level": level,
            "k1_launches": [retry_launches, later_launches]}


#: the widest device-score gap across which the host may rank two hits
#: the other way: 8 float32 ulp at a cosine of 1, fixed (the host's
#: matrix-vector product and the device's product and sum round apart
#: by about 1e-7); it does not grow with the gaps measured
SWAP_EPS = 1e-6


def ranking_swaps(device_hits: list, host_hits: list) -> list:
    """Every place where the host's top-k ranks differently from the
    device's: (x, y, device score of x - device score of y) for a pair
    the host orders the other way, and (x, None, gap) / (None, y, gap)
    for a hit one side has and the other has not, its gap to the other
    side's k-th score. [] = the same ranking."""
    dev, host = dict(device_hits), dict(host_hits)
    pos = {i: r for r, (i, _) in enumerate(host_hits)}
    out = [(x, y, sx - sy) for r, (x, sx) in enumerate(device_hits) for y, sy in device_hits[r + 1:]
           if x in pos and y in pos and pos[x] > pos[y]]
    out += [(i, None, s - host_hits[-1][1]) for i, s in device_hits if i not in host]
    out += [(None, i, s - device_hits[-1][1]) for i, s in host_hits if i not in dev]
    return out


def check_host_query(p4: dict, rng) -> dict:
    """`search.query:raise` on phase 5's index: the host ranks as the
    device does but for hits whose device scores lie within SWAP_EPS of
    each other (every such swap printed with its gap), the scores
    within 1e-5, and `sd_search_queries_total{path="host"}` moves by 1."""
    from spacedrive_tpu_torch.object.search import index as search_index
    from spacedrive_tpu_torch.telemetry import metrics as tm
    from spacedrive_tpu_torch.utils import faults

    lib = _open_library(p4["data_dir"])
    try:
        idx = search_index.get_index(lib)
        idx.refresh()
        _ids, vecs = idx.vectors()
        probe = vecs[int(rng.integers(len(vecs)))]
        device_hits = idx.query(probe, k=20, device=DEVICE)
        host0 = tm.SEARCH_QUERIES.value(path="host")
        with faults.active(faults.FaultPlan.parse("search.query:raise:times=1")):
            host_hits = idx.query(probe, k=20, device=DEVICE)
    finally:
        lib.close()
    check(tm.SEARCH_QUERIES.value(path="host") == host0 + 1, "the host query was not counted")
    host_of = dict(host_hits)
    diff = max(abs(host_of[i] - s) for i, s in device_hits if i in host_of)
    scores = [s for _, s in device_hits]
    closest = min(a - b for a, b in zip(scores, scores[1:]))
    swaps = ranking_swaps(device_hits, host_hits)
    wide = [s for s in swaps if abs(s[2]) > SWAP_EPS]
    check(not wide, f"the host ranking differs from the device ranking beyond {SWAP_EPS:g}: "
          f"{wide} (all swaps {swaps}; host-device score diff {diff:.3g}); host {host_hits}, "
          f"device {device_hits}")
    check(diff <= 1e-5, f"host scores differ by {diff}")
    print(f"phase 8: search.query fault: host ranking == device ranking over {len(vecs)} vectors "
          f"but for {len(swaps)} swaps within {SWAP_EPS:g} {[(x, y, f'{g:.3g}') for x, y, g in swaps]}"
          f" (scores within {diff:.3g}; closest adjacent device scores {closest:.3g} apart)",
          flush=True)
    return {"host_score_max_diff": diff, "swaps": [list(s) for s in swaps],
            "closest_gap": closest}


def check_actor_fallback(p3: dict, snapshot: str, tmp: str) -> dict:
    """A thumbnailer chunk whose device resize fails at every rung takes
    the CPU resize: `thumbnail_cpu_fallback` on the ring, every
    thumbnail written, pixels within one level of phase 3's."""
    import asyncio

    from spacedrive_tpu_torch.object.media.thumbnail import actor as actor_mod
    from spacedrive_tpu_torch.parallel import mesh
    from spacedrive_tpu_torch.telemetry.events import RESILIENCE_EVENTS
    from spacedrive_tpu_torch.utils import faults

    imgs = sorted((im for im in p3["images"] if max(im[1], im[2]) <= 4 * min(im[1], im[2])),
                  key=lambda im: im[1] * im[2])[:N_SEAM_ACTOR]
    entries = []
    for path, *_ in imgs:
        snap = os.path.join(snapshot, os.path.relpath(path, p3["corpus"]))
        entries.append((p3["cas_ids"][path], snap, snap.rsplit(".", 1)[1]))
    cas_of = {snap: c for c, snap, _ in entries}
    by_obj, host_out = {}, []
    real_decode, real_resize = actor_mod.decode, actor_mod.resize_decoded

    def decode(path, ext):
        d = real_decode(path, ext)
        by_obj[id(d)] = cas_of[path]
        return d

    def resize(ds, device="cuda", devices=None):
        out = real_resize(ds, device, devices)
        if devices is not None:  # the actor's CPU fallback
            host_out.extend((by_obj[id(d)], a) for d, a in zip(ds, out))
        return out

    async def run() -> tuple[int, int]:
        th = actor_mod.Thumbnailer(os.path.join(tmp, "seam_actor"), device=DEVICE)
        th.chunk_rows = N_SEAM_ACTOR
        try:
            await th.wait_batch(th.new_indexed_thumbnails_batch("seam", entries))
            return th.generated, th.errors
        finally:
            await th.shutdown()

    RESILIENCE_EVENTS.clear()
    actor_mod.decode, actor_mod.resize_decoded = decode, resize
    try:
        with faults.active(faults.FaultPlan.parse("device.thumbnail:raise:times=inf")):
            generated, errors = asyncio.run(run())
    finally:
        actor_mod.decode, actor_mod.resize_decoded = real_decode, real_resize
        mesh.LADDER.reset()
    events = [e for e in RESILIENCE_EVENTS.snapshot() if e["type"] == "thumbnail_cpu_fallback"]
    check(len(events) == 1 and events[0]["fields"]["entries"] == len(entries),
          f"thumbnail_cpu_fallback events: {events}")
    check((generated, errors) == (len(entries), 0), f"actor wrote {generated}, errors {errors}")
    check(len(host_out) == len(entries), "not every image took the CPU resize")
    worst = 0
    for c, arr in host_out:
        want = p3["resized"][c]
        check(arr.shape == want.shape, f"CPU-resized {c}: {arr.shape} vs {want.shape}")
        worst = max(worst, int(np.abs(arr.astype(int) - want.astype(int)).max()))
    check(worst <= 1, f"the CPU fallback differs from phase 3 by {worst} levels")
    print(f"phase 8: a chunk of {len(entries)} past the ladder took the CPU resize "
          f"(thumbnail_cpu_fallback emitted; pixels within {worst} of phase 3)", flush=True)
    RESILIENCE_EVENTS.clear()
    return {"cpu_fallback_max_diff": worst}


def check_inventory_and_profile(name_power: str, snapshot: str, tmp: str) -> dict:
    """(c) `accelerators()` names the card nvidia-smi names; with
    SD_TORCH_PROFILE set one identify job writes a trace holding K1."""
    import asyncio
    import glob

    from spacedrive_tpu_torch.cli import index_library
    from spacedrive_tpu_torch.node.hardware import accelerators
    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.telemetry import profiler

    acc = accelerators()
    smi_name = name_power.split(",")[0].strip()
    check(bool(acc) and len(acc) == torch.cuda.device_count() and acc[0]["kind"] == smi_name
          and acc[0]["platform"] == "gpu", f"accelerators() {acc} vs nvidia-smi {smi_name!r}")

    corpus = os.path.join(tmp, "seam_profile_corpus")
    os.makedirs(corpus)
    large = sorted(glob.glob(os.path.join(snapshot, "d*", "*.bin")),
                   key=os.path.getsize)[-N_SEAM_PROFILE:]
    for p in large:
        os.link(p, os.path.join(corpus, os.path.basename(p)))
    logdir = os.path.join(tmp, "seam_profile")
    os.environ[profiler.ENV_VAR] = logdir
    blake3_cuda.chunk_cvs.launches = 0
    try:
        asyncio.run(index_library(corpus, os.path.join(tmp, "seam_profile_data"), "prof", DEVICE,
                                  no_p2p=True))
    finally:
        del os.environ[profiler.ENV_VAR]
    launches = blake3_cuda.chunk_cvs.launches
    traces = glob.glob(os.path.join(logdir, "identify", "*.pt.trace.json"))
    check(len(traces) == 1, f"profile traces: {traces}")
    with open(traces[0], encoding="utf-8") as f:
        text = f.read()
    check(K1_KERNEL in text, f"the identify trace has no {K1_KERNEL}")
    check(launches > 0 and not profiler.profiling_active(), "the profiled identify job")
    print(f"phase 8: accelerators() = {acc}; the profiled identify job wrote "
          f"{os.path.basename(traces[0])} ({len(text)} bytes) naming {K1_KERNEL}", flush=True)
    return {"launches": launches, "accelerators": acc, "trace_bytes": len(text)}


def phase_device_seam(rng, tmp: str, p3: dict, p4: dict, snapshot: str, name_power: str) -> dict:
    t_phase = time.perf_counter()
    steps_s: dict[str, float] = {}

    def step(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        steps_s[name] = time.perf_counter() - t0
        return out

    sharded = step("sharded", check_sharded, rng, p3)
    faulted = step("faults_pass", check_faults_pass, p3, p4, snapshot, tmp)
    last_rung = step("last_rung", check_last_rung, rng)
    query = step("host_query", check_host_query, p4, rng)
    actor = step("actor_fallback", check_actor_fallback, p3, snapshot, tmp)
    inventory = step("inventory_profile", check_inventory_and_profile, name_power, snapshot, tmp)
    out = {"sharded": {k: v for k, v in sharded.items() if k != "launches"},
           "faults_pass": {k: v for k, v in faulted.items() if k != "launches"},
           "last_rung": {k: v for k, v in last_rung.items() if k != "launches"},
           "host_query": query, "actor_fallback": actor,
           "inventory": {k: v for k, v in inventory.items() if k != "launches"},
           "steps_s": steps_s, "seconds": time.perf_counter() - t_phase}
    print(json.dumps({"device_seam": out}), flush=True)
    return {"launches": {"seam_sharded_cas": sharded["launches"],
                         "seam_index_pass_faults": faulted["launches"],
                         "seam_last_rung": last_rung["launches"],
                         "seam_profiled_identify": inventory["launches"]}}

# --- phase 9: the host execution plane ------------------------------------

# the process pool's size on the card's host: one worker a core, at most 8
N_POOL = min(8, os.cpu_count() or 1)
POOL_LIBRARY = "pool"
# near copies added to phase 9's library (the first JPEGs and PNGs by
# path), so the duplicate runs have near groups to find
N_POOL_NEAR = 2
# 9(c): every producer fetch stalls past URGENT_WAIT_S (0.5 s), and the
# static identify window is cut from 1,024 to 16 rows a card so 9(a)'s
# ~1,000 rows make at least 8 windows while the controller widens them
# (64 rows while 9(a) kept every file: 10 windows over 3,972 rows; 32
# rows, 10 windows over 1,988)
CONTROLLER_STALL = "feeder.fetch:stall:times=inf,delay_s=0.6"
CONTROLLER_WINDOW = 16
CONTROLLER_INTERVAL_S = 0.2


def pool_counters() -> dict:
    from spacedrive_tpu_torch.telemetry import metrics as tm

    return {"ok": tm.PROCPOOL_JOBS.value(result="ok"),
            "error": tm.PROCPOOL_JOBS.value(result="error"),
            "retried": tm.PROCPOOL_JOBS.value(result="retried"),
            "restarts": tm.PROCPOOL_RESTARTS.value(),
            "workers": tm.PROCPOOL_WORKERS.value()}


def file_cas(data_dir: str) -> dict:
    """cas_id by file key (materialized path, name, extension)."""
    lib = _open_library(data_dir)
    try:
        return {(r["materialized_path"], r["name"], r["extension"]): r["cas_id"]
                for r in lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")}
    finally:
        lib.close()


def pool_library(data_dir: str) -> dict:
    """What the pool must not change, by file key or cas_id: cas_ids,
    the object count, media_data rows, pHash bits, embeddings and webp
    bytes."""
    lib = _open_library(data_dir)
    try:
        db = lib.db
        cas_of = {r["id"]: r["cas_id"] for r in db.query(
            "SELECT o.id, fp.cas_id FROM object o JOIN file_path fp ON fp.object_id = o.id")}
        out = {
            "objects": db.count("object"),
            "media_data": {cas_of[r["object_id"]]: {k: r[k] for k in r.keys()
                                                    if k not in ("id", "object_id")}
                           for r in db.query("SELECT * FROM media_data")},
            "phash": {cas_of[r["id"]]: bytes(r["phash"]) for r in db.query(
                "SELECT id, phash FROM object WHERE phash IS NOT NULL")},
            "vectors": {cas_of[r["object_id"]]: np.frombuffer(r["vector"], "<f4")
                        for r in db.query("SELECT object_id, vector FROM object_embedding")},
            "lib_id": str(lib.id),
        }
    finally:
        lib.close()
    out["cas"] = file_cas(data_dir)
    out["thumbs"] = {}
    for dirpath, _, files in os.walk(os.path.join(data_dir, "thumbnails")):
        for f in files:
            if f.endswith(".webp"):
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out["thumbs"][f] = fh.read()
    return out


def _groups_by_cas(groups: list, data_dir: str) -> list:
    cas_of = {}
    lib = _open_library(data_dir)
    try:
        for r in lib.db.query("SELECT object_id, cas_id FROM file_path WHERE object_id IS NOT NULL"):
            cas_of[r["object_id"]] = r["cas_id"]
    finally:
        lib.close()
    return sorted((g["kind"], sorted({cas_of[o] for o in g["object_ids"]})) for g in groups)


def _pool_duplicates(data_dir: str) -> tuple[list, float, float, dict]:
    """`duplicates` on a Node the smoke reads: groups, wall seconds, the
    decode leg's seconds and the job's metadata."""
    import asyncio

    from spacedrive_tpu_torch.cli import duplicates_library
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    node = Node(data_dir, device=DEVICE, with_labeler=False)
    node.config.config.p2p.enabled = False
    t0 = time.perf_counter()
    groups = asyncio.run(duplicates_library(data_dir, POOL_LIBRARY, DUP_THRESHOLD, DEVICE,
                                            node=node))
    seconds = time.perf_counter() - t0
    lib = _open_library(data_dir)
    try:
        row = lib.db.query_one("SELECT metadata FROM job WHERE name = 'duplicate_detector' "
                               "ORDER BY date_created DESC, rowid DESC LIMIT 1")
    finally:
        lib.close()
    return groups, seconds, node.stage_seconds.get("phash_decode", 0.0), unpackb(row["metadata"])


def pool_leg(corpus: str, data_dir: str, procs: int, crash_copy: str | None = None) -> dict:
    """`index --library` then `duplicates` with SD_PROCS=procs, fresh
    data dir, the controller live; K1's launches counted from 0 over
    both. With `crash_copy` the data dir is copied there between the
    two (for 9(b))."""
    import asyncio
    import shutil
    from datetime import datetime

    from spacedrive_tpu_torch.cli import index_library
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    os.environ["SD_PROCS"] = str(procs)
    node = Node(data_dir, device=DEVICE, with_labeler=False)
    node.config.config.p2p.enabled = False
    blake3_cuda.chunk_cvs.launches = 0
    t0 = time.perf_counter()
    asyncio.run(index_library(corpus, data_dir, POOL_LIBRARY, DEVICE, node=node))
    index_s = time.perf_counter() - t0
    lib = _open_library(data_dir)
    try:
        jobs = {j["name"]: j for j in lib.db.query("SELECT * FROM job")}
    finally:
        lib.close()
    media = jobs["media_processor"]
    media_s = (datetime.fromisoformat(media["date_completed"])
               - datetime.fromisoformat(media["date_started"])).total_seconds()
    embeds = unpackb(media["metadata"])["embeddings_written"]
    if crash_copy is not None:
        shutil.copytree(data_dir, crash_copy)
    groups, dup_s, dup_decode_s, dup_meta = _pool_duplicates(data_dir)
    launches = blake3_cuda.chunk_cvs.launches
    out = pool_library(data_dir)
    out.update(dir=data_dir, launches=launches, dup_meta=dup_meta, numbers={
        "procs": procs, "index_s": index_s, "media_job_s": media_s,
        "embed_decode_s": node.stage_seconds.get("embed_decode", 0.0),
        "embed_forward_s": node.stage_seconds.get("embed_forward", 0.0),
        "embed_chunks": -(-embeds // 32), "embeddings": embeds,
        "duplicates_s": dup_s, "duplicates_decode_s": dup_decode_s,
        "phash_hashed": dup_meta["hashed"], "k1_launches": launches})
    out["groups"] = _groups_by_cas(groups, data_dir)
    return out


def check_pool_equal(got: dict, want: dict, what: str) -> float:
    """Every result the pool must not change, exactly; the embeddings
    within 1e-5. Returns the largest embedding difference."""
    for key in ("cas", "objects", "media_data", "phash", "groups", "thumbs"):
        check(got[key] == want[key], f"{what}: {key} differs from the inline run")
    check(got["vectors"].keys() == want["vectors"].keys(), f"{what}: embedded objects differ")
    worst = max((float(np.abs(v - want["vectors"][k]).max()) for k, v in got["vectors"].items()),
                default=0.0)
    check(worst <= 1e-5, f"{what}: embeddings differ by {worst}")
    return worst


def pool_corpus(snapshot: str, root: str) -> tuple[str, list]:
    """Hard links to every POOL_IMAGES_EVERY-th image and every
    POOL_OTHERS_EVERY-th other file of the snapshot, plus N_POOL_NEAR
    re-encoded JPEGs and
    N_POOL_NEAR resized PNGs under near/; returns the corpus and the
    planted (original, copy) pairs as file keys."""
    snapshot_corpus(snapshot, root, every_nth(snapshot, POOL_IMAGES_EVERY, POOL_OTHERS_EVERY))
    images = sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                    for f in fs if f.endswith((".jpg", ".png")))
    os.makedirs(os.path.join(root, "near"), exist_ok=True)
    pairs = []
    for ext in (".jpg", ".png"):
        # the first that decode (phase 4 rewrote some files in place)
        for p in (p for p in images if p.endswith(ext)):
            if sum(a.endswith(ext) for a, _ in pairs) == N_POOL_NEAR:
                break
            copy = os.path.join("near", "n_" + os.path.basename(p))
            try:
                _near_copy((os.path.join(root, p), os.path.join(root, copy)))
            except OSError:
                continue
            pairs.append((p, copy))

    def key(rel: str) -> tuple:
        d, f = os.path.split(rel)
        name, ext = os.path.splitext(f)
        return (f"/{d}/" if d else "/", name, ext[1:])

    return root, [(key(a), key(b)) for a, b in pairs]


def check_pool(snapshot: str, tmp: str) -> dict:
    """(a) the pool against inline; (b) a worker crash in the pooled
    duplicates run."""
    from spacedrive_tpu_torch.parallel import procpool
    from spacedrive_tpu_torch.utils import faults

    clean = degradation()
    snapshot, planted = pool_corpus(snapshot, os.path.join(tmp, "corpus_p9"))
    inline = pool_leg(snapshot, os.path.join(tmp, "pool0"), 0)
    check(all(f in inline["cas"] for pair in planted for f in pair),
          f"planted files missing from the library: {planted}")
    near = [set(ids) for kind, ids in inline["groups"] if kind == "near"]
    missing = [(a, b) for a, b in planted
               if not any({inline["cas"][a], inline["cas"][b]} <= g for g in near)]
    check(not missing, f"planted pairs in no near group: {missing}")
    check(not procpool.POOL.running() and pool_counters()["workers"] == 0,
          "SD_PROCS=0 started the pool")
    before = pool_counters()
    os.environ["SD_PROCS"] = str(N_POOL)
    check(procpool.POOL.start(), "the pool did not start")  # the smoke's own hold
    try:
        procpool.POOL.warm(timeout=60)
        up = pool_counters()["workers"], procpool.POOL.worker_count()
        crash_dir = os.path.join(tmp, "pool_crash")
        pooled = pool_leg(snapshot, os.path.join(tmp, f"pool{N_POOL}"), N_POOL, crash_copy=crash_dir)
        after = pool_counters()
        check(up == (N_POOL, N_POOL) and after["workers"] == N_POOL,
              f"workers while the pool is up: {up}, after the runs {after['workers']}")
        worst = check_pool_equal(pooled, inline, "SD_PROCS=%d" % N_POOL)
        check(pooled["launches"] > 0 and inline["launches"] > 0, "phase 9 launched K1 no time")
        want_jobs = pooled["numbers"]["embed_chunks"] + pooled["numbers"]["phash_hashed"]
        jobs_ok = after["ok"] - before["ok"]
        check(jobs_ok >= want_jobs, f"{jobs_ok} pool jobs ok, want >= {want_jobs}")
        check(after["error"] == before["error"] and after["retried"] == before["retried"]
              and after["restarts"] == before["restarts"], f"pool failures: {before} -> {after}")
        check_healthy("9a", since=clean)

        # (b) one worker killed mid-job in the pooled duplicates run
        plan = faults.FaultPlan.parse("procpool.worker:crash:times=1", seed=1)
        with faults.active(plan):
            groups, crash_s, _, _ = _pool_duplicates(crash_dir)
        crashed = pool_counters()
        crash_groups = _groups_by_cas(groups, crash_dir)
        crash_phash = pool_library(crash_dir)["phash"]
    finally:
        procpool.POOL.stop()
        os.environ.pop("SD_PROCS", None)
    check(plan.activations() == {"procpool.worker": 1}, f"activations {plan.activations()}")
    check(crashed["restarts"] - after["restarts"] == 1,
          f"restarts under one crash: {crashed['restarts'] - after['restarts']}")
    check(crashed["retried"] - after["retried"] >= 1, "the killed worker's job was not retried")
    check(crash_groups == inline["groups"] and crash_phash == inline["phash"],
          "the crashed duplicates run found other groups or bits")
    check(pool_counters()["workers"] == 0, "the pool's workers outlived its last hold")
    numbers = {"inline": inline["numbers"], "pooled": pooled["numbers"],
               "n_pool": N_POOL, "cpu_count": os.cpu_count(), "embed_max_diff": worst,
               "pool_jobs_ok": jobs_ok, "crash": {
                   "seconds": crash_s, "restarts": crashed["restarts"] - after["restarts"],
                   "retried": crashed["retried"] - after["retried"]}}
    print(f"phase 9: SD_PROCS={N_POOL} (cpu_count {os.cpu_count()}) == SD_PROCS=0: "
          f"{len(inline['cas'])} cas_ids, {inline['objects']} objects, "
          f"{len(inline['media_data'])} media_data rows, {len(inline['phash'])} pHashes, "
          f"{len(inline['groups'])} groups (the {len(planted)} planted pairs in near groups), "
          f"{len(inline['thumbs'])} webps exact, embeddings "
          f"within {worst:.3g}; {jobs_ok:g} pool jobs, 0 errors / retries / restarts; embed "
          f"decode {inline['numbers']['embed_decode_s']:.2f} -> "
          f"{pooled['numbers']['embed_decode_s']:.2f} s, duplicates decode "
          f"{inline['numbers']['duplicates_decode_s']:.2f} -> "
          f"{pooled['numbers']['duplicates_decode_s']:.2f} s; a worker crash: "
          f"{numbers['crash']['restarts']:g} restart, {numbers['crash']['retried']:g} retried, "
          f"same groups", flush=True)
    return {"inline": inline, "launches": inline["launches"] + pooled["launches"],
            "numbers": numbers}


def _identify_again(src: str, dst: str, plan: str | None) -> dict:
    """A copy of `src`'s data dir with every file un-identified, then one
    FileIdentifierJob on the card (under `plan`); its cas_ids, the
    controller's decisions and knobs, the windows fetched."""
    import asyncio
    import shutil

    from spacedrive_tpu_torch.cli import _open
    from spacedrive_tpu_torch.jobs import JobBuilder
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.object.file_identifier.job import FileIdentifierJob
    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.parallel import autotune
    from spacedrive_tpu_torch.telemetry import metrics as tm
    from spacedrive_tpu_torch.telemetry.events import AUTOTUNE_EVENTS
    from spacedrive_tpu_torch.utils import faults

    shutil.copytree(src, dst)
    lib = _open_library(dst)
    try:
        lib.db.execute("UPDATE file_path SET cas_id = NULL, object_id = NULL")
        lib.db.execute("DELETE FROM index_journal")
    finally:
        lib.close()

    async def run() -> None:
        node = Node(dst, device=DEVICE, with_labeler=False)
        node.config.config.p2p.enabled = False
        try:
            lib = await _open(node, POOL_LIBRARY)
            loc = lib.db.query("SELECT id FROM location")[0]
            await JobBuilder(FileIdentifierJob({"location_id": loc["id"], "backend": DEVICE})
                             ).spawn(node.jobs, lib)
            await node.jobs.wait_idle()
        finally:
            await node.shutdown()

    AUTOTUNE_EVENTS.clear()
    decisions0 = {(w, a): tm.AUTOTUNE_DECISIONS.value(workload=w, action=a)
                  for w in autotune.WORKLOADS for a in ("promote", "demote")}
    fetches0 = tm.FEEDER_FETCH_SECONDS.stats()["count"]
    blake3_cuda.chunk_cvs.launches = 0
    t0 = time.perf_counter()
    with faults.active(faults.FaultPlan.parse(plan, seed=1) if plan else None):
        asyncio.run(run())
    seconds = time.perf_counter() - t0
    counted = {f"{w}.{a}": tm.AUTOTUNE_DECISIONS.value(workload=w, action=a) - v
               for (w, a), v in decisions0.items()}
    return {"cas": file_cas(dst), "seconds": seconds, "launches": blake3_cuda.chunk_cvs.launches,
            "windows": int(tm.FEEDER_FETCH_SECONDS.stats()["count"] - fetches0) - 1,
            "decisions": [e["fields"] for e in AUTOTUNE_EVENTS.snapshot()
                          if e["type"] == "decision"],
            "decisions_counted": {k: v for k, v in counted.items() if v},
            "knobs": autotune.policy("identify").snapshot()}


def check_controller(inline: dict, tmp: str) -> dict:
    """(c) the live controller on the card: a FileIdentifierJob whose
    every fetch stalls past URGENT_WAIT_S widens its windows and deepens
    its feeder, the decisions land on the ring and the counter, and the
    ids equal the run without faults; then SD_AUTOTUNE=0 reads the
    static sizes and gives the same ids."""
    from spacedrive_tpu_torch.parallel import autotune, feeder, mesh

    base = autotune.IDENTIFY_DEVICE_WINDOW
    autotune.reset()
    mesh.LADDER.reset()
    autotune.CONTROLLER.interval = CONTROLLER_INTERVAL_S
    autotune.IDENTIFY_DEVICE_WINDOW = CONTROLLER_WINDOW
    try:
        stalled = _identify_again(inline["dir"], os.path.join(tmp, "ctl_stall"), CONTROLLER_STALL)
    finally:
        autotune.IDENTIFY_DEVICE_WINDOW = base
        autotune.CONTROLLER.interval = 1.0
    knobs = stalled["knobs"]
    check(stalled["cas"] == inline["cas"], "cas_ids under the stalled feeder differ")
    check(stalled["windows"] >= 8, f"the stalled job fetched {stalled['windows']} windows")
    # the depth is shed again while the loop lags (DB linking runs on the
    # loop), so the check is that it was deepened, not where it ended
    deepened = max((d["new"] for d in stalled["decisions"] if d["knob"] == "depth_extra"),
                   default=0)
    check(knobs["window_scale"] >= 2 and deepened >= 1,
          f"the controller did not widen and deepen: {knobs}, depth reached {deepened}")
    check(stalled["decisions"] and sum(stalled["decisions_counted"].values())
          == len(stalled["decisions"]), f"decisions: ring {len(stalled['decisions'])}, "
          f"counter {stalled['decisions_counted']}")
    check(stalled["launches"] > 0, "the stalled identify launched K1 no time")

    autotune.reset()
    os.environ["SD_AUTOTUNE"] = "0"
    try:
        pol = autotune.policy("identify")
        static = (pol.identify_window_rows(1), pol.feeder_depth(1), pol.dispatch_rows_per_device(),
                  autotune.policy("embed").embed_chunk_rows(1),
                  autotune.policy("thumbnail").thumb_chunk_rows(1))
        check(static == (1024, feeder.pipeline_depth(1), 1024, 32, 32),
              f"SD_AUTOTUNE=0 sizes {static}")
        off = _identify_again(inline["dir"], os.path.join(tmp, "ctl_off"), None)
    finally:
        os.environ.pop("SD_AUTOTUNE", None)
    check(off["cas"] == inline["cas"], "cas_ids under SD_AUTOTUNE=0 differ")
    check(off["decisions"] == [] and off["windows"] == -(-len(inline["cas"]) // 1024),
          f"SD_AUTOTUNE=0 made decisions or other windows: {off['windows']}")
    autotune.reset()
    print(f"phase 9: controller under {CONTROLLER_STALL} (window {CONTROLLER_WINDOW} rows, tick "
          f"{CONTROLLER_INTERVAL_S} s): {stalled['windows']} windows in {stalled['seconds']:.1f} s, "
          f"{len(stalled['decisions'])} decisions, final knobs {knobs}; ids == the clean run; "
          f"SD_AUTOTUNE=0: {off['windows']} windows of 1024, ids equal", flush=True)
    print(json.dumps({"controller_decisions": stalled["decisions"]}), flush=True)
    return {"launches": stalled["launches"] + off["launches"], "numbers": {
        "stalled": {k: stalled[k] for k in ("seconds", "windows", "knobs", "decisions_counted")},
        "static": {k: off[k] for k in ("seconds", "windows")}}}


def phase_execution_plane(tmp: str, snapshot: str) -> dict:
    from spacedrive_tpu_torch.parallel import autotune, mesh

    t_phase = time.perf_counter()
    mesh.LADDER.reset()
    autotune.reset()
    steps_s: dict[str, float] = {}
    t0 = time.perf_counter()
    pool = check_pool(snapshot, tmp)
    steps_s["pool"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctl = check_controller(pool["inline"], tmp)
    steps_s["controller"] = time.perf_counter() - t0
    out = {"pool": pool["numbers"], "controller": ctl["numbers"], "steps_s": steps_s,
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps({"execution_plane": out}), flush=True)
    return {"launches": {"plane_pool_passes": pool["launches"],
                         "plane_controller_identify": ctl["launches"]}}


# --- phase 10: the other decoders ------------------------------------------

# the seeded corpus of the other kinds, at the shapes users keep: scanned
# and typeset PDF pages, vector art, phone-size AVIF photos (cut to
# 640-1280 px on the long side: PIL's AVIF encoder takes ~1.5 s for
# 1280x960 on one core), the committed clip and cover-art audio
PDF_KINDS = (["image"] * 16 + ["vector"] * 16 + ["text"] * 16 + ["xref"] * 8 + ["rotate"] * 4
             + ["thumb"] * 4)  # 64 documents
N_P10_SVG = 32  # 16 .svg, 16 .svgz
N_P10_AVIF = 32
N_P10_COVER = 14
N_P10_JPEG = 32
P10_CLIP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                        "torch_clip_128x96.mp4")
P10_CUT = ("AVIF photos 640-1280 px on the long side (PIL's encoder speed), "
           "one clip and its rotated copy (no video encoder on the card's host)")


def decoders_available() -> dict:
    """What this host decodes: PDF always, SVG where librsvg loads, HEIF
    where libheif does, video through the native frontend (libav found;
    a failed build raises), else cv2, else none; and whether PIL writes
    AVIF (the corpus's HEIF files)."""
    from PIL import features

    from spacedrive_tpu_torch.native import video
    from spacedrive_tpu_torch.object.media.images import heif_available
    from spacedrive_tpu_torch.object.media.svg import svg_available

    if video.video_available():
        vid = "native"
    else:
        try:
            import cv2  # noqa: F401
            vid = "cv2"
        except ImportError:
            vid = "none"
    return {"pdf": True, "svg": svg_available(), "heif": heif_available(), "video": vid,
            "avif_writer": bool(features.check("avif"))}


def _pdf(objs: list[bytes], version: bytes = b"1.4") -> bytes:
    """A classic-xref PDF of `objs` (object i+1 = objs[i], 1 the catalog)."""
    out = bytearray(b"%PDF-" + version + b"\n")
    offsets = []
    for i, o in enumerate(objs, 1):
        offsets.append(len(out))
        out += str(i).encode() + b" 0 obj\n" + o + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 " + str(len(objs) + 1).encode() + b"\n0000000000 65535 f \n"
    out += b"".join(f"{off:010d} 00000 n \n".encode() for off in offsets)
    out += (b"trailer\n<< /Size " + str(len(objs) + 1).encode() + b" /Root 1 0 R >>\nstartxref\n"
            + str(xref).encode() + b"\n%%EOF\n")
    return bytes(out)


def _stream(data: bytes, extra: bytes = b"", flate: bool = True) -> bytes:
    body = zlib.compress(data) if flate else data
    return (b"<< /Length " + str(len(body)).encode() + (b" /Filter /FlateDecode" if flate else b"")
            + extra + b" >>\nstream\n" + body + b"\nendstream")


WORDS = ("storage", "index", "library", "object", "thumbnail", "peer", "sync", "volume",
         "journal", "device", "tag", "label", "search", "album", "photo", "document")


def _text_content(rng, lines: int, size: int = 14) -> bytes:
    out = [b"BT /F1 %d Tf 72 720 Td %d TL" % (size, size + 4)]
    for _ in range(lines):
        words = " ".join(WORDS[int(i)] for i in rng.integers(0, len(WORDS), 8))
        out.append(b"(" + words.encode() + b") Tj T*")
    return b" ".join(out) + b" ET"


def _page_pdf(content: bytes, box=(612, 792), page_extra: bytes = b"",
              extra_objs: list[bytes] = ()) -> bytes:
    return _pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 %d %d] /Contents 4 0 R "
        b"/Resources << /Font << /F1 5 0 R >> >>" % box + page_extra + b" >>",
        _stream(content),
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
        *extra_objs,
    ])


def _vector_content(rng) -> bytes:
    ops = []
    for _ in range(int(rng.integers(6, 16))):
        r, g, b = (rng.uniform(0, 1, 3)).round(2)
        x, y = rng.integers(20, 560), rng.integers(20, 740)
        kind = int(rng.integers(0, 3))
        if kind == 0:
            ops.append(b"%.2f %.2f %.2f rg %d %d %d %d re f" % (r, g, b, x, y, rng.integers(10, 200),
                                                                 rng.integers(10, 200)))
        elif kind == 1:
            ops.append(b"%.2f %.2f %.2f rg %d %d m %d %d l %d %d l h f" % (
                r, g, b, x, y, x + rng.integers(-150, 150), y + rng.integers(10, 200),
                x + rng.integers(-150, 150), y - rng.integers(10, 200)))
        else:
            ops.append(b"%.2f %.2f %.2f RG %d w %d %d m %d %d l S" % (
                r, g, b, rng.integers(1, 12), x, y, rng.integers(20, 590), rng.integers(20, 770)))
    return b"\n".join(ops) + b"\nBT /F1 28 Tf 1 0 0 1 72 60 Tm 0 0 0 rg (vector page) Tj ET"


def _xref_stream_pdf(rng) -> bytes:
    """Catalog, pages and page in an object stream, a stream xref (W [1 4 2])."""
    content = _text_content(rng, 6, 12)
    inner = {1: b"<< /Type /Catalog /Pages 2 0 R >>",
             2: b"<< /Type /Pages /Kids [3 0 R] /Count 1 /MediaBox [0 0 420 595] >>",
             3: b"<< /Type /Page /Parent 2 0 R /Contents 4 0 R >>"}
    body, pairs = b"", []
    for n, payload in inner.items():
        pairs.append((n, len(body)))
        body += payload + b" "
    header = " ".join(f"{n} {o}" for n, o in pairs).encode()
    comp = zlib.compress(header + b"\n" + body)
    out = bytearray(b"%PDF-1.5\n")
    offsets = {6: len(out)}
    out += (b"6 0 obj\n<< /Type /ObjStm /N 3 /First " + str(len(header) + 1).encode()
            + b" /Length " + str(len(comp)).encode() + b" /Filter /FlateDecode >>\nstream\n"
            + comp + b"\nendstream\nendobj\n")
    offsets[4] = len(out)
    out += b"4 0 obj\n" + _stream(content, flate=False) + b"\nendobj\n"
    xref_off = len(out)
    entries = {0: (0, 0, 0xFFFF), 1: (2, 6, 0), 2: (2, 6, 1), 3: (2, 6, 2),
               4: (1, offsets[4], 0), 5: (1, xref_off, 0), 6: (1, offsets[6], 0)}
    rows = b"".join(bytes([t]) + f2.to_bytes(4, "big") + f3.to_bytes(2, "big")
                    for t, f2, f3 in (entries[n] for n in range(7)))
    comp_x = zlib.compress(rows)
    out += (b"5 0 obj\n<< /Type /XRef /Size 7 /W [1 4 2] /Root 1 0 R /Length "
            + str(len(comp_x)).encode() + b" /Filter /FlateDecode >>\nstream\n" + comp_x
            + b"\nendstream\nendobj\nstartxref\n" + str(xref_off).encode() + b"\n%%EOF")
    return bytes(out)


def _smooth(rng, w: int, h: int):
    from PIL import Image

    coarse = rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
    return Image.fromarray(coarse).resize((w, h), Image.BILINEAR)


def _jpeg_bytes(img, quality: int = 85) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def build_pdfs(root: str, rng) -> list[str]:
    paths = []
    for i, kind in enumerate(PDF_KINDS):
        if kind == "image":  # a scanned page or a slide, as PIL writes it
            w, h = ((1275, 1650), (1650, 1275), (1600, 900), (850, 1100))[i % 4]
            buf = io.BytesIO()
            _smooth(rng, w, h).save(buf, "PDF", resolution=150.0)
            data = buf.getvalue()
        elif kind == "vector":
            data = _page_pdf(_vector_content(rng))
        elif kind == "text":
            data = _page_pdf(_text_content(rng, int(rng.integers(8, 30))),
                             box=((612, 792), (595, 842))[i % 2])
        elif kind == "xref":
            data = _xref_stream_pdf(rng)
        elif kind == "rotate":
            data = _page_pdf(_text_content(rng, 12), page_extra=b" /Rotate %d" % (90 * (1 + i % 3)))
        else:  # the page's own /Thumb (a DCT image XObject)
            thumb = _jpeg_bytes(_smooth(rng, 106, 137))
            data = _page_pdf(_vector_content(rng), page_extra=b" /Thumb 6 0 R", extra_objs=[
                _stream(thumb, b" /Type /XObject /Subtype /Image /Width 106 /Height 137 "
                               b"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /DCTDecode",
                        flate=False)])
        path = os.path.join(root, "docs", f"{kind}_{i:02d}.pdf")
        with open(path, "wb") as f:
            f.write(data)
        paths.append(path)
    return paths


def build_svgs(root: str, rng) -> list[str]:
    paths = []
    for i in range(N_P10_SVG):
        w, h = int(rng.integers(64, 2000)), int(rng.integers(64, 2000))
        shapes = []
        for _ in range(int(rng.integers(5, 40))):
            r, g, b = rng.integers(0, 256, 3)
            shapes.append(
                f'<circle cx="{rng.integers(0, w)}" cy="{rng.integers(0, h)}" '
                f'r="{rng.integers(4, max(5, min(w, h) // 3))}" fill="rgb({r},{g},{b})" '
                f'fill-opacity="{rng.uniform(0.3, 1):.2f}"/>' if rng.random() < 0.5 else
                f'<rect x="{rng.integers(0, w)}" y="{rng.integers(0, h)}" '
                f'width="{rng.integers(4, w)}" height="{rng.integers(4, h)}" '
                f'fill="rgb({r},{g},{b})" stroke="black" stroke-width="{rng.integers(1, 6)}"/>')
        doc = (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" '
               f'viewBox="0 0 {w} {h}">' + "".join(shapes) + "</svg>").encode()
        path = os.path.join(root, "art", f"art_{i:02d}.svg" + ("z" if i % 2 else ""))
        with open(path, "wb") as f:
            f.write(gzip.compress(doc) if i % 2 else doc)
        paths.append(path)
    return paths


def _write_avif(args) -> str:
    path, seed, w, h = args
    _smooth(np.random.default_rng(seed), w, h).save(path, "AVIF", quality=70)
    return path


def build_avifs(root: str, rng) -> list[str]:
    sizes = [(1280, 960), (960, 1280), (1024, 768), (640, 480), (1200, 675), (800, 800)]
    jobs = [(os.path.join(root, "photos", f"photo_{i:02d}.avif"), int(rng.integers(1 << 31)),
             *sizes[i % len(sizes)]) for i in range(N_P10_AVIF)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        return list(ex.map(_write_avif, jobs))


def _rotate_tkhd_90(data: bytes) -> bytes:
    """Rewrite the mp4 tkhd display matrix to a 90° clockwise rotation
    (how phones mark portrait video)."""
    i = data.find(b"tkhd")
    check(i > 4, "the clip has no tkhd box")
    moff = i + 4 + (40 if data[i + 4] == 0 else 52)

    def fixed(v, shift=16):
        return struct.pack(">i", int(v * (1 << shift)))

    matrix = (fixed(0) + fixed(1) + fixed(0, 30) + fixed(-1) + fixed(0) + fixed(0, 30)
              + fixed(0) + fixed(0) + fixed(1, 30))
    return data[:moff] + matrix + data[moff + 36:]


def _cover_audio(rng) -> bytes:
    """MPEG-1 Layer III frames behind an ID3v2.3 tag whose APIC frame
    holds seeded JPEG cover art (500-1000 px a side)."""
    side = int(rng.integers(500, 1001))
    apic = b"\x00image/jpeg\x00\x03cover\x00" + _jpeg_bytes(_smooth(rng, side, side))
    n = len(apic) + 10
    size = bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F, n & 0x7F])
    tag = b"APIC" + struct.pack(">I", len(apic)) + b"\x00\x00" + apic
    return b"ID3\x03\x00\x00" + size + tag + (b"\xff\xfb\x90\x00" + b"\x00" * 413) * 40


def build_videos(root: str, rng, with_covers: bool) -> list[str]:
    """The committed clip, its 90°-rotated copy, and (with the native
    frontend) cover-art audio named .mpg: the taxonomy thumbnails video
    extensions only, and libav finds the MPEG audio and its cover by
    content."""
    with open(P10_CLIP, "rb") as f:
        clip = f.read()
    files = {"clip.mp4": clip, "clip_rot90.mov": _rotate_tkhd_90(clip)}
    if with_covers:
        for i in range(N_P10_COVER):
            files[f"song_{i:02d}.mpg"] = _cover_audio(rng)
    paths = []
    for name, data in files.items():
        path = os.path.join(root, "video", name)
        with open(path, "wb") as f:
            f.write(data)
        paths.append(path)
    return paths


def build_jpegs(root: str, rng) -> list[str]:
    paths = []
    for i in range(N_P10_JPEG):
        long = int(rng.integers(640, 4033))
        short = int(long * (0.75, 0.5625, 0.666)[i % 3])
        w, h = (long, short) if i % 2 else (short, long)
        path = os.path.join(root, "jpeg", f"img_{i:02d}.jpg")
        _smooth(rng, w, h).save(path, "JPEG", quality=88)
        paths.append(path)
    return paths


def build_decoder_corpus(root: str, rng, avail: dict) -> tuple[dict[str, list[str]], dict]:
    """{kind: [paths]} (PDF, SVG, HEIF, video, JPEG) and {kind: why skipped}."""
    for d in ("docs", "art", "photos", "video", "jpeg"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    kinds: dict[str, list[str]] = {"pdf": build_pdfs(root, rng)}
    skipped = {}
    if avail["svg"]:
        kinds["svg"] = build_svgs(root, rng)
    else:
        skipped["svg"] = "librsvg not found on this host"
    if avail["heif"] and avail["avif_writer"]:
        kinds["heif"] = build_avifs(root, rng)
    else:
        skipped["heif"] = ("libheif not found on this host" if not avail["heif"]
                           else "PIL on this host writes no AVIF")
    if avail["video"] != "none":
        kinds["video"] = build_videos(root, rng, avail["video"] == "native")
        if avail["video"] != "native":
            skipped["video_cover_art"] = "libav not found: cv2 reads no cover art"
    else:
        skipped["video"] = "neither libav nor cv2 found on this host"
    kinds["jpeg"] = build_jpegs(root, rng)
    return kinds, skipped


def _host_decodes(kinds: dict[str, list[str]]) -> tuple[dict, dict]:
    """Every file decoded on the host by the port's host half (the
    actor's decode), serially: {path: Decoded} and seconds per kind."""
    from spacedrive_tpu_torch.object.media.thumbnail import process

    decoded, seconds = {}, {}
    for kind, paths in kinds.items():
        t0 = time.perf_counter()
        for p in paths:
            decoded[p] = process.decode(p, p.rsplit(".", 1)[1])
        seconds[kind] = time.perf_counter() - t0
    return decoded, seconds


def _expected_target(kind: str, path: str, d) -> tuple[int, int]:
    """(h, w) the JAX host half gives this file: video at
    `video_dimensions` of the frame, JPEGs at `scale_dimensions` of the
    header's size (a draft-mode decode comes out smaller), the rest at
    `scale_dimensions` of the decoded frame."""
    from PIL import Image

    from spacedrive_tpu_torch.ops import thumbnail_dims

    h, w = d.array.shape[:2]
    if kind == "video":
        return thumbnail_dims.video_dimensions(w, h)[::-1]
    if kind == "jpeg":
        with Image.open(path) as im:
            return thumbnail_dims.scale_dimensions(*im.size)[::-1]
    return thumbnail_dims.scale_dimensions(w, h)[::-1]


def _recording_actor():
    """Wrap the actor's decode and device resize to record, per file, the
    Decoded it made and the frame the card returned for it. Returns
    (records, restore)."""
    from spacedrive_tpu_torch.object.media.thumbnail import actor

    decode, resize = actor.decode, actor.resize_decoded
    path_of: dict[int, str] = {}
    records: dict[str, tuple] = {}

    def rec_decode(path, ext):
        d = decode(path, ext)
        path_of[id(d)] = path
        records[path] = (d, None)
        return d

    def rec_resize(ds, *args, **kwargs):
        out = resize(ds, *args, **kwargs)
        for d, o in zip(ds, out):
            records[path_of[id(d)]] = (d, o)
        return out

    actor.decode, actor.resize_decoded = rec_decode, rec_resize

    def restore():
        actor.decode, actor.resize_decoded = decode, resize

    return records, restore


def check_decoder_library(root: str, kinds: dict, cold: dict, decoded: dict,
                          records: dict) -> dict:
    """The cold scan's rows against the host half and the plain path:
    cas_ids; a webp per file at its dims, the card's frame within 1 level
    of the [cpu] resize and stored as its encode, film strips on clips
    and none on cover art; video media_data rows byte for byte; vectors
    for the image rows only, HEIF's within 1e-5 of a CPU embed; the
    journal's vouches."""
    from PIL import Image

    from spacedrive_tpu_torch.models import embedder
    from spacedrive_tpu_torch.object.media.media_data import VideoMetadata
    from spacedrive_tpu_torch.object.media.thumbnail import process
    from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore
    from spacedrive_tpu_torch.ops import cas, embed_torch
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    by_path = {_row_path(root, r): r for r in cold["rows"]}
    files = [p for ps in kinds.values() for p in ps]
    check(set(files) <= set(by_path), "a corpus file has no file_path row")
    msgs = [cas.read_message(p, os.path.getsize(p)) for p in files]
    plain = plain_cas_ids(msgs)
    for p, want in zip(files, plain):
        check(by_path[p]["cas_id"] == want, f"cas_id of {p} differs from the plain path")

    store = ThumbnailStore(os.path.join(cold["data_dir"], "thumbnails"))
    kind_of = {p: k for k, ps in kinds.items() for p in ps}
    max_d, mean_d, stragglers, strips = 0, 0.0, 0, {"clip": 0, "cover": 0}
    for p in files:
        kind, d = kind_of[p], decoded[p]
        webp = store.path_for(cold["lib_id"], by_path[p]["cas_id"])
        check(os.path.exists(webp), f"no thumbnail for {p}")
        th, tw = _expected_target(kind, p, d)
        check(d.target == (th, tw), f"{p}: target {d.target}, want {(th, tw)}")
        with Image.open(webp) as im:
            check(im.size == (tw, th), f"thumbnail of {p} is {im.size}, want {(tw, th)}")
            got = np.asarray(im.convert("RGB"), np.int16)
        rd, out = records[p]
        check(np.array_equal(rd.array, d.array)
              and (rd.target, rd.is_video) == (d.target, d.is_video),
              f"{p}: the actor decoded otherwise")
        if out is None:
            check(process.needs_cpu_fallback(d), f"{p} was neither resized on the card nor a straggler")
            stragglers += 1
            continue
        (cpu,) = process.resize_decoded([d], devices=[torch.device("cpu")])
        diff = np.abs(out.astype(np.int16) - cpu.astype(np.int16))
        max_d, mean_d = max(max_d, int(diff.max())), max(mean_d, float(diff.mean()))
        with open(webp, "rb") as f:
            check(f.read() == process.finish(d, out), f"{p}: the stored webp is not its card frame's")
        if kind == "video":
            is_clip = p.endswith((".mp4", ".mov"))
            check(d.is_video == is_clip, f"{p}: is_video {d.is_video}")
            strip = max(4, min(tw // 10, 20))
            edge, mid = got[:, :strip].mean(), got[:, strip:-strip].mean()
            if is_clip:
                check(edge < 0.75 * mid, f"{p}: no film strip ({edge:.1f} vs {mid:.1f})")
                strips["clip"] += 1
            else:
                strips["cover"] += 1
    check(max_d <= 1, f"card frames differ from the [cpu] resize by max |d| {max_d}, mean {mean_d}")
    clip = next((p for p in kinds.get("video", []) if p.endswith("clip.mp4")), None)
    if clip is not None:
        rot = clip.replace("clip.mp4", "clip_rot90.mov")
        check(decoded[clip].array.shape[:2] == (96, 128)
              and decoded[rot].array.shape[:2] == (128, 96), "the tkhd rotation was not applied")

    # media_data: every JPEG (EXIF extension) and video row; videos byte for byte
    obj_of = {p: by_path[p]["object_id"] for p in files}
    rows = {r["object_id"]: r for r in cold["media_data"]}
    n_video = 0
    for p in kinds.get("video", []):
        want = VideoMetadata.from_path(p)
        check(want is not None, f"{p}: no video facts")
        cols = want.to_row(obj_of[p])
        got = rows.get(obj_of[p])
        check(got is not None and all(bytes(got[k]) == cols[k] for k in ("resolution", "camera_data")),
              f"{p}: media_data row differs from VideoMetadata.to_row")
        check(unpackb(got["camera_data"])["video"] is True, f"{p}: not a video row")
        n_video += 1
    n_jpeg = len(kinds["jpeg"])
    check(len(rows) == n_jpeg + n_video, f"{len(rows)} media_data rows, want {n_jpeg + n_video}")

    # embeddings: image rows only (JPEG and HEIF); HEIF vectors == a CPU embed
    images = kinds["jpeg"] + kinds.get("heif", [])
    vec_of = {r["object_id"]: embedder.blob_to_vector(r["vector"]) for r in cold["embeddings"]}
    check(set(vec_of) == {obj_of[p] for p in images},
          f"{len(vec_of)} embeddings, want the {len(images)} image objects")
    heif_d = 0.0
    if kinds.get("heif"):
        host = embed_torch.embed_batch(
            np.stack([embedder.decode_image(p) for p in kinds["heif"]]), "cpu")
        for p, want in zip(kinds["heif"], host):
            heif_d = max(heif_d, float(np.abs(vec_of[obj_of[p]] - want).max()))
        check(heif_d <= 1e-5, f"a HEIF vector differs from the CPU embed by {heif_d}")
    for p in files:
        r = by_path[p]
        key = (r["materialized_path"], r["name"], r["extension"])
        payload = unpackb(cold["journal"][key]["payload"])
        check(payload.get("thumb") is True, f"{p}: no thumb vouch")
        check(bool(payload.get("embed")) == (p in images), f"{p}: embed vouch {payload.get('embed')}")
    return {"card_vs_cpu_max_abs": max_d, "card_vs_cpu_mean_abs": mean_d, "stragglers": stragglers,
            "film_strips": strips["clip"], "cover_art": strips["cover"], "video_rows": n_video,
            "heif_vector_max_abs": heif_d, "cas_ids": len(files)}


def phase_decoders(rng, tmp: str, name_power: str) -> dict:
    """Phase 10: every kind this host decodes, thumbnailed on the card by
    `index --library`, then a warm rescan that does nothing."""
    from spacedrive_tpu_torch.object.media.thumbnail import process
    from spacedrive_tpu_torch.parallel import autotune, mesh

    t_phase = time.perf_counter()
    mesh.LADDER.reset()
    autotune.reset()
    since = degradation()
    avail = decoders_available()
    root = os.path.join(tmp, "p10_corpus")
    kinds, skipped = build_decoder_corpus(root, rng, avail)
    print(json.dumps({"decoders": {**avail, "counts": {k: len(v) for k, v in kinds.items()},
                                   "skipped": skipped}}), flush=True)
    decoded, decode_s = _host_decodes(kinds)
    on_card = [d for d in decoded.values() if not process.needs_cpu_fallback(d)]
    process.resize_decoded(on_card, DEVICE)  # warm: each bucket's first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    process.resize_decoded(on_card, DEVICE)
    torch.cuda.synchronize()
    resize_s = time.perf_counter() - t0

    data_dir = os.path.join(tmp, "p10_data")
    records, restore = _recording_actor()
    try:
        cold = run_library_pass(root, data_dir)
    finally:
        restore()
    cold["data_dir"] = data_dir
    check(cold["launches"] > 0, "the decoders' scan launched K1 no time")
    got = check_decoder_library(root, kinds, cold, decoded, records)
    n_files = sum(len(v) for v in kinds.values())
    media = cold["media"]
    check(media["thumbnails_dispatched"] == n_files == cold["generated"],
          f"{media['thumbnails_dispatched']} thumbnails dispatched, {cold['generated']} written, "
          f"want {n_files}")

    warm = run_library_pass(root, data_dir)
    wm = warm["media"]
    check(warm["launches"] == 0 and warm["generated"] == 0 and wm["thumbnails_dispatched"] == 0
          and wm["media_data_extracted"] == 0 and wm["embeddings_written"] == 0,
          f"the warm rescan did work: {warm['launches']} K1 launches, {warm['generated']} "
          f"thumbnails, media {wm}")
    check_healthy("10", since)
    out = {
        "decoders": avail, "skipped": skipped, "files": {k: len(v) for k, v in kinds.items()},
        "cut": P10_CUT, "k1_launches_cold": cold["launches"], "k1_launches_warm": warm["launches"],
        "decode_s_by_kind": decode_s, "decode_ms_per_file": {
            k: 1e3 * decode_s[k] / len(kinds[k]) for k in kinds},
        "card_resize_s": resize_s, "card_resize_frames": len(on_card),
        "scan": cold["numbers"], "warm_scan_s": warm["numbers"]["seconds"], **got,
        "card": name_power, "seconds": time.perf_counter() - t_phase,
    }
    print(json.dumps({"other_decoders": out}), flush=True)
    print(f"phase 10: {n_files} files of {len(kinds)} kinds thumbnailed on the card "
          f"({got['stragglers']} host-path stragglers), K1 {cold['launches']} launches cold, "
          f"0 warm; {name_power}", flush=True)
    return {"launches": {"decoders_cold": cold["launches"], "decoders_warm": warm["launches"]}}


# --- phase 11: the node's control plane and its rspc API on the card -----------

# the API's own scan: ~512 files in phase 3's size mix (a new location
# of a new library beside phase 4's), 32 of them JPEGs and 4 near copies
N_API_LARGE, N_API_SMALL, N_API_JPEG, N_API_NEAR = 380, 96, 32, 4
API_WAIT_S = 120  # the bound on a scan's `jobs.isActive` wait
API_TAKE = 100  # search.paths' largest page (api/search.py MAX_TAKE)
API_WRITE_PAGES = 10  # pages by size walked with a write before each


def build_api_corpus(root: str, rng, sizes: tuple[int, int, int, int] | None = None) -> list[str]:
    """`sizes` = (large, small, jpegs, near), default (N_API_LARGE,
    N_API_SMALL, N_API_JPEG, N_API_NEAR): that many files of 101 KiB-512
    KiB (log-uniform sizes), files over the small buckets, JPEGs of phase
    3's aspects and orientations and re-encoded copies of them; returns
    every path."""
    from spacedrive_tpu_torch.ops import cas

    n_large, n_small, n_jpeg, n_near = sizes or (N_API_LARGE, N_API_SMALL, N_API_JPEG, N_API_NEAR)
    large = np.exp(rng.uniform(np.log(101 * 1024), np.log(512 * 1024), n_large)).astype(int)
    small = rng.integers(0, cas.MINIMUM_FILE_SIZE + 1, n_small)
    paths = []
    for i, size in enumerate(list(large) + list(small)):
        path = os.path.join(root, f"d{i % 8}", f"f{i:04d}.bin")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(rng.bytes(int(size)))
        paths.append(path)
    jobs = []
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(n_jpeg):
        aw, ah = ASPECTS[i % 4]
        long_side = int(np.exp(rng.uniform(np.log(LONG_SIDE[0]), np.log(LONG_SIDE[1]))))
        w, h = long_side, max(1, long_side * ah // aw)
        if i % 2:
            w, h = h, w
        jobs.append((os.path.join(root, "images", f"api{i:02d}.jpg"), w, h,
                     int(rng.integers(1 << 30)), "jpg", (1, 6, 8, 3)[i % 4]))
    near = [(p, os.path.join(root, "near", "n_" + os.path.basename(p)))
            for p, *_ in jobs[:n_near]]
    os.makedirs(os.path.join(root, "near"), exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        paths += [p for p, *_ in pool.map(_image, jobs)]
        list(pool.map(_near_copy, near))
    return paths + [dst for _, dst in near]


async def _until_idle(r, node, lid: str) -> float:
    """Poll `jobs.isActive` until the library's jobs are done; fails past
    API_WAIT_S. Returns the seconds waited."""
    import asyncio

    t0 = time.perf_counter()
    while await r.exec(node, "jobs.isActive", library_id=lid):
        check(time.perf_counter() - t0 < API_WAIT_S, f"jobs still active after {API_WAIT_S} s")
        await asyncio.sleep(0.05)
    return time.perf_counter() - t0


async def _page_all(r, node, lid: str, order: str) -> tuple[list, list]:
    """Every row of `search.paths` in `order`, page by page; the ids and
    the order values."""
    seen, vals, cursor = [], [], None
    while True:
        page = await r.exec(node, "search.paths",
                            {"take": API_TAKE, "orderBy": order, "cursor": cursor}, library_id=lid)
        seen += [n["__id"] for n in page["items"]]
        vals += [n["name" if order == "name" else "size_in_bytes"] for n in page["nodes"]]
        cursor = page["cursor"]
        if cursor is None:
            return seen, vals


def check_walk(walk: tuple[list, list], order: str, n_rows: int) -> None:
    seen, vals = walk
    check(len(seen) == len(set(seen)) == n_rows,
          f"search.paths by {order}: {len(seen)} rows ({len(set(seen))} distinct) of {n_rows}")
    check(vals == sorted(vals), f"search.paths by {order} is out of order")


async def _walk_by_size_under_writes(r, node, lid: str, steps: dict) -> None:
    """The first API_WRITE_PAGES pages by size with a write to the library
    DB before each (as a running job makes): each such page takes the SQL
    path. Times the pages alone, beside the walk at rest."""
    vals, cursor, paged = [], None, 0.0
    for i in range(API_WRITE_PAGES):
        await r.exec(node, "preferences.update", {"smoke": {"page": i}}, library_id=lid)
        t0 = time.perf_counter()
        page = await r.exec(node, "search.paths",
                            {"take": API_TAKE, "orderBy": "sizeInBytes", "cursor": cursor},
                            library_id=lid)
        paged += time.perf_counter() - t0
        vals += [n["size_in_bytes"] for n in page["nodes"]]
        cursor = page["cursor"]
    check(len(vals) == API_WRITE_PAGES * API_TAKE and vals == sorted(vals),
          f"search.paths by size under writes: {len(vals)} rows, in order: {vals == sorted(vals)}")
    steps["paths_by_size_under_writes_s"] = paged
    print(f"phase 11: search.paths by size, {API_WRITE_PAGES} pages with a write before each: "
          f"{1e3 * paged / API_WRITE_PAGES:.1f} ms a page", flush=True)


async def api_read_side(r, node, lib, images: list[str], rng, steps: dict) -> None:
    """11.3: the read procedures on phase 4's library (phases 5-6 extended
    it) against the DB and the port's own calls."""
    import asyncio

    from spacedrive_tpu_torch.api.cache import normalise
    from spacedrive_tpu_torch.db.database import blob_u64
    from spacedrive_tpu_torch.object.duplicates import find_duplicates

    lid = str(lib.id)
    n_rows = lib.db.count("file_path")
    for order, step in (("name", "paths_by_name_s"), ("sizeInBytes", "paths_by_size_s")):
        t0 = time.perf_counter()
        check_walk(await _page_all(r, node, lid, order), order, n_rows)
        steps[step] = time.perf_counter() - t0
    await _walk_by_size_under_writes(r, node, lid, steps)

    t0 = time.perf_counter()
    stats = await r.exec(node, "library.statistics", library_id=lid)
    sizes = [blob_u64(x["size_in_bytes_bytes"]) or 0
             for x in lib.db.query("SELECT size_in_bytes_bytes FROM file_path")]
    check(stats["total_object_count"] == lib.db.count("object")
          and int(stats["total_bytes_used"]) == sum(sizes), f"library.statistics: {stats}")
    ks = await r.exec(node, "library.kindStatistics", library_id=lid)
    want = {x["kind"]: x["n"] for x in lib.db.query(
        "SELECT kind, COUNT(*) AS n FROM object WHERE kind IS NOT NULL GROUP BY kind")}
    check({s["kind"]: s["count"] for s in ks["statistics"]} == want,
          f"kindStatistics {ks} != the DB's {want}")
    steps["statistics_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    probe = images[int(rng.integers(len(images)))]
    sem = await r.exec(node, "search.semantic", {"query": probe, "take": 5}, library_id=lid)
    first = sem["nodes"][0] if sem["nodes"] else {}
    check(sem["resolved"] and f"{first.get('name')}.{first.get('extension')}"
          == os.path.basename(probe) and first["score"] >= 0.9999,
          f"search.semantic of {probe} ranked {first.get('name')} first ({first.get('score')})")
    steps["semantic_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    dups = await r.exec(node, "search.duplicates", {}, library_id=lid)
    want_dups = await asyncio.to_thread(find_duplicates, lib, DUP_THRESHOLD, DEVICE)
    check(dups == want_dups and any(g["kind"] == "near" for g in dups),
          f"search.duplicates ({len(dups)} groups) != find_duplicates ({len(want_dups)})")
    steps["duplicates_s"] = time.perf_counter() - t0

    labels = await r.exec(node, "labels.list", library_id=lid)
    check(labels == normalise("label", lib.db.find("label")) and labels["items"]
          and lib.db.count("label_on_object") > 0, "labels.list != the label table")
    print(f"phase 11: {n_rows} rows paged by name and by size, each once; statistics and "
          f"{len(want)} kinds == COUNT(*); {os.path.basename(probe)} ranks itself first "
          f"(cosine {first['score']:.7f}); {len(dups)} duplicate groups == find_duplicates; "
          f"{len(labels['items'])} labels == the label table", flush=True)


async def api_scan(r, node, root: str, paths: list[str], steps: dict) -> dict:
    """11.4-11.6: a new library, a new location through `locations.create`
    (K1 launched, cas_ids against the plain path on the CPU, progress,
    invalidations and the completion notification on the node bus), a
    `locations.fullRescan` that launches K1 no time, and `files.validate`
    against the host hasher. Returns K1's launches by step."""
    from spacedrive_tpu_torch.api import CoreEventKind
    from spacedrive_tpu_torch.object.validation import file_checksum
    from spacedrive_tpu_torch.ops import blake3_cuda, cas

    t0 = time.perf_counter()
    sub = node.event_bus.subscribe()
    lid = (await r.exec(node, "library.create", {"name": "api"}))["uuid"]
    lib = next(x for x in node.libraries.libraries.values() if str(x.id) == lid)
    blake3_cuda.chunk_cvs.launches = 0
    loc_id = await r.exec(node, "locations.create", {"path": root}, library_id=lid)
    await _until_idle(r, node, lid)
    create_launches = blake3_cuda.chunk_cvs.launches
    await node.thumbnailer.wait_library_batch(lib.id)
    steps["create_scan_s"] = time.perf_counter() - t0
    events = sub.poll()
    sub.close()
    progress = [e[1] for e in events if isinstance(e, tuple) and e[0] == "JobProgress"]
    keys = {e[1].key for e in events
            if isinstance(e, tuple) and e[0] == CoreEventKind.INVALIDATE_OPERATION
            and e[1].library_id == lid}
    check(create_launches > 0, "locations.create launched K1 no time")
    check({p.name for p in progress} >= {"indexer", "file_identifier", "media_processor"},
          f"JobProgress on the node bus: {sorted({p.name for p in progress})}")
    check(keys >= {"search.paths", "locations.list", "labels.list"},
          f"invalidations on the node bus: {sorted(keys)}")
    reports = await r.exec(node, "jobs.reports", library_id=lid)
    check(len(reports) == 3 and all(x["status"] == "COMPLETED" for x in reports),
          f"the scan's jobs: {[(x['name'], x['status'], x['errors']) for x in reports]}")
    notes = [n for n in await r.exec(node, "notifications.get")
             if n["id"]["library_id"] == lid and n["data"].get("job") == "media_processor"]
    check(len(notes) == 1 and notes[0]["data"]["kind"] == "ok",
          f"completion notifications: {notes}")

    t0 = time.perf_counter()
    rows = lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")
    by_path = {_row_path(root, x): x for x in rows}
    check(set(paths) <= set(by_path) and len(rows) == len(paths) + 1,  # + the .spacedrive marker
          f"{len(rows)} file rows for {len(paths)} files and the marker")
    hashed = [p for p in by_path if os.path.getsize(p) > 0]
    plain = cas.cas_ids([cas.read_message(p, os.path.getsize(p)) for p in hashed], "cpu")
    for p, want in zip(hashed, plain):
        check(by_path[p]["cas_id"] == want, f"cas_id of {p} != the plain path on the CPU")
    steps["check_cas_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    blake3_cuda.chunk_cvs.launches = 0
    await r.exec(node, "locations.fullRescan", {"location_id": loc_id}, library_id=lid)
    await _until_idle(r, node, lid)
    rescan_launches = blake3_cuda.chunk_cvs.launches
    check(rescan_launches == 0, f"the fullRescan of the unchanged tree launched K1 "
          f"{rescan_launches} times")
    steps["full_rescan_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    blake3_cuda.chunk_cvs.launches = 0
    await r.exec(node, "files.validate", {"location_id": loc_id}, library_id=lid)
    await _until_idle(r, node, lid)
    validate_launches = blake3_cuda.chunk_cvs.launches
    steps["validate_s"] = time.perf_counter() - t0
    rows = lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")
    with ThreadPoolExecutor(8) as pool:
        want = list(pool.map(file_checksum, [_row_path(root, x) for x in rows]))
    for x, w in zip(rows, want):
        check(x["integrity_checksum"] == w, f"integrity_checksum of {x['name']} != the host "
              f"hasher's")
    check(validate_launches > 0, "files.validate launched K1 no time")
    print(f"phase 11: locations.create: {len(rows)} files, K1 {create_launches} launches, "
          f"{len(hashed)} cas_ids == the plain path on the CPU, {len(progress)} JobProgress "
          f"events, invalidated {sorted(keys)}, a completion notification; fullRescan 0 K1 "
          f"launches; files.validate: {len(rows)} checksums == the host hasher, K1 "
          f"{validate_launches} launches", flush=True)
    return {"lib": lib, "launches": {"api_create": create_launches,
                                     "api_full_rescan": rescan_launches,
                                     "api_validate": validate_launches}}


async def api_round_trips(r, node, lib, steps: dict) -> None:
    """11.7: preferences, a feature flag, tags and backups through the
    router."""
    t0 = time.perf_counter()
    lid = str(lib.id)
    doc = {"explorer": {"layout": "grid", "size": 3}, "theme": "dark"}
    await r.exec(node, "preferences.update", doc, library_id=lid)
    check(await r.exec(node, "preferences.get", library_id=lid) == doc, "preferences round trip")
    for on in (True, False):
        got = await r.exec(node, "toggleFeatureFlag", {"feature": "filesOverP2P", "enabled": on})
        state = await r.exec(node, "nodeState")
        check(got is on and ("filesOverP2P" in state["features"]) is on, "toggleFeatureFlag")
    tag_id = await r.exec(node, "tags.create", {"name": "smoke-tag", "color": "#0af"},
                          library_id=lid)
    objs = [x["id"] for x in lib.db.query("SELECT id FROM object ORDER BY id LIMIT 3")]
    await r.exec(node, "tags.assign", {"tag_id": tag_id, "object_ids": objs}, library_id=lid)
    tagged = await r.exec(node, "search.paths", {"filter": {"tags": [tag_id]}}, library_id=lid)
    for_obj = await r.exec(node, "tags.getForObject", objs[0], library_id=lid)
    check({n["object_id"] for n in tagged["nodes"]} == set(objs)
          and [n["name"] for n in for_obj["nodes"]] == ["smoke-tag"], "tags round trip")
    backup_id = await r.exec(node, "backups.backup", library_id=lid)
    backups = await r.exec(node, "backups.getAll")
    check(any(b["id"] == backup_id and b["library_id"] == lid for b in backups),
          "backups.getAll lacks the backup")
    steps["round_trips_s"] = time.perf_counter() - t0


def phase_api(rng, tmp: str, p4: dict) -> dict:
    """Phase 11: a Node on the card over phase 4's data dir, driven
    through its router."""
    import asyncio

    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.parallel import autotune, mesh

    t_phase = time.perf_counter()
    mesh.LADDER.reset()
    autotune.reset()
    since = degradation()
    steps: dict[str, float] = {}
    root = os.path.join(tmp, "p11_corpus")
    t0 = time.perf_counter()
    paths = build_api_corpus(root, rng)
    steps["corpus_s"] = time.perf_counter() - t0

    async def run() -> dict:
        t0 = time.perf_counter()
        node = Node(p4["data_dir"], device=DEVICE)
        node.config.config.p2p.enabled = False
        await node.start()
        steps["boot_s"] = time.perf_counter() - t0
        try:
            r = node.router
            state = await r.exec(node, "nodeState")
            check(state["device_model"] == torch.cuda.get_device_name(0)
                  and len(state["accelerators"]) == torch.cuda.device_count(),
                  f"nodeState's card: {state['device_model']}, {state['accelerators']}")
            check(state["image_labeler_version"] not in (None, "none"),
                  f"image_labeler_version {state['image_labeler_version']!r}")
            (lib,) = node.libraries.libraries.values()
            await api_read_side(r, node, lib, p4["images"], rng, steps)
            scan = await api_scan(r, node, root, paths, steps)
            await api_round_trips(r, node, scan["lib"], steps)
            return {"state": state, **scan}
        finally:
            await node.shutdown()

    got = asyncio.run(run())
    check_healthy("11", since)
    seconds = time.perf_counter() - t_phase
    print(json.dumps({"api": {"steps_s": steps, "seconds": seconds, "files": len(paths),
                              "k1_launches": got["launches"],
                              "device_model": got["state"]["device_model"],
                              "image_labeler_version": got["state"]["image_labeler_version"]}}),
          flush=True)
    print(f"phase 11: the router on the card in {seconds:.1f} s", flush=True)
    return {"launches": got["launches"]}


# --- phase 12: observability (trace context, spans, the host sampler) ------

#: phase 3's size mix at ~256 files: 192 of 101-512 KiB, 48 small, 16 JPEGs
N_OBS_LARGE, N_OBS_SMALL, N_OBS_JPEG = 192, 48, 16
N_OBS_REF = 8  # cas_ids also held against blake3_ref (pure Python)
OBS_STAGES = ("walk", "identify.hash", "identify.db", "task.dispatch", "feeder.fetch",
              "thumbnail.decode", "thumbnail.device", "thumbnail.encode")
OBS_SECRET = "sk-observability-smoke-planted-secret-0123456789"
OBS_OVERHEAD = 0.05  # the bar of JAX's test_overhead_at_default_rate_under_5pct


def _webps(data_dir: str) -> dict[str, bytes]:
    out = {}
    for dirpath, _, files in os.walk(os.path.join(data_dir, "thumbnails")):
        for f in files:
            if f.endswith(".webp"):
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[f] = fh.read()
    return out


async def obs_scan(node, root: str, steps: dict, tag: str) -> dict:
    """A new library and a location over `root` through the router, waited
    on; its cas_ids by path, the identifier's metadata, K1's launches and
    the scan's wall seconds (from `locations.create` to its thumbnails)."""
    from spacedrive_tpu_torch.jobs.report import JobReport
    from spacedrive_tpu_torch.ops import blake3_cuda

    r = node.router
    t0 = time.perf_counter()
    lid = (await r.exec(node, "library.create", {"name": f"obs-{tag}"}))["uuid"]
    lib = next(x for x in node.libraries.libraries.values() if str(x.id) == lid)
    blake3_cuda.chunk_cvs.launches = 0
    t_scan = time.perf_counter()
    await r.exec(node, "locations.create", {"path": root}, library_id=lid)
    await _until_idle(r, node, lid)
    await node.thumbnailer.wait_library_batch(lib.id)
    launches = blake3_cuda.chunk_cvs.launches
    wall_s = time.perf_counter() - t_scan
    steps[f"{tag}_scan_s"] = time.perf_counter() - t0
    reports = {x["name"]: x for x in await r.exec(node, "jobs.reports", library_id=lid)}
    check(set(reports) == {"indexer", "file_identifier", "media_processor"}
          and all(x["status"] == "COMPLETED" for x in reports.values()),
          f"the {tag} scan's jobs: {[(x['name'], x['status']) for x in reports.values()]}")
    # the .spacedrive marker names its library, so it differs between the scans
    rows = [x for x in lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")
            if os.path.basename(_row_path(root, x)) != ".spacedrive"]
    (row,) = lib.db.find("job", name="file_identifier")
    return {"lid": lid, "launches": launches, "identifier": JobReport.from_row(row).metadata,
            "cas": {_row_path(root, x): x["cas_id"] for x in rows}, "wall_s": wall_s}


def check_trace(trace_mod, identifier: dict) -> dict:
    """One trace id holds every stage of the scan; the identify.hash spans
    sum to no more than the identifier's hash seconds (`identifier`: its
    report's metadata). Returns span
    counts and seconds by stage of that trace."""
    by_trace: dict[str, list] = collections.defaultdict(list)
    for rec in trace_mod.recent():
        by_trace[rec["trace_id"]].append(rec)
    full = [t for t, recs in by_trace.items() if set(OBS_STAGES) <= {x["stage"] for x in recs}]
    check(len(full) == 1, f"{len(full)} traces hold every stage of {OBS_STAGES}; stages by trace: "
          f"{ {t[:8]: sorted({x['stage'] for x in recs}) for t, recs in by_trace.items()} }")
    stages: dict[str, dict] = {}
    for rec in by_trace[full[0]]:
        st = stages.setdefault(rec["stage"], {"spans": 0, "seconds": 0.0})
        st["spans"] += 1
        st["seconds"] += rec["seconds"]
    hash_s = float(identifier["hash_time"])
    # the job's metadata rounds each window's seconds to 0.1 ms
    check(stages["identify.hash"]["seconds"] <= hash_s + 1e-3,
          f"identify.hash spans sum to {stages['identify.hash']['seconds']:.4f} s, over the "
          f"identifier's hash seconds {hash_s}")
    return {"trace_id": full[0], "stages": stages, "identifier_hash_s": hash_s}


def phase_observability(rng, tmp: str) -> dict:
    """Phase 12: a Node on the card with the host sampler on scans a new
    ~256-file location through the router under one trace; the trace
    export, the profile and the debug bundle through their procedures;
    the same corpus again with SD_PROFILE=0 gives the same results."""
    import asyncio

    from spacedrive_tpu_torch import telemetry
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.ops import blake3_ref, cas
    from spacedrive_tpu_torch.parallel import autotune, mesh
    from spacedrive_tpu_torch.telemetry import sampler, trace

    t_phase = time.perf_counter()
    mesh.LADDER.reset()
    autotune.reset()
    telemetry.reset()
    since = degradation()
    steps: dict[str, float] = {}
    root = os.path.join(tmp, "p12_corpus")
    t0 = time.perf_counter()
    paths = build_api_corpus(root, rng, (N_OBS_LARGE, N_OBS_SMALL, N_OBS_JPEG, 0))
    steps["corpus_s"] = time.perf_counter() - t0
    os.environ["SD_CLOUD_TOKEN"] = OBS_SECRET

    async def profiled() -> dict:
        data_dir = os.path.join(tmp, "p12_sdx")
        node = Node(data_dir, device=DEVICE)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            check(node._profiler_started and sampler.SAMPLER.running(), "the sampler is not running")
            scan = await obs_scan(node, root, steps, "profiled")
            t0 = time.perf_counter()
            r = node.router
            doc = json.loads(json.dumps(await r.exec(node, "telemetry.trace_export")))
            xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
            check(xs and all(e["dur"] >= 0 for e in xs),
                  f"trace_export: {len(xs)} X events, some with dur < 0")
            profile = await r.exec(node, "telemetry.profile")
            bundle = json.dumps(await r.exec(node, "telemetry.debug_bundle"), default=str)
            identity_hex = node.config.config.identity.to_bytes().hex()
            steps["procedures_s"] = time.perf_counter() - t0
        finally:
            await node.shutdown()
        check(identity_hex not in bundle and OBS_SECRET not in bundle,
              "the debug bundle holds the identity hex or a secret SD_* value")
        return {**scan, "x_events": len(xs), "profile": profile, "bundle_bytes": len(bundle),
                "webps": _webps(data_dir)}

    async def unprofiled() -> dict:
        data_dir = os.path.join(tmp, "p12_sdx_off")
        node = Node(data_dir, device=DEVICE)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            check(not node._profiler_started and not sampler.SAMPLER.running(),
                  "SD_PROFILE=0 started the sampler")
            scan = await obs_scan(node, root, steps, "unprofiled")
        finally:
            await node.shutdown()
        return {**scan, "webps": _webps(data_dir)}

    on = asyncio.run(profiled())
    t0 = time.perf_counter()
    spans = check_trace(trace, on["identifier"])
    check(on["launches"] > 0, "the profiled scan launched K1 no time")
    hashed = [p for p in paths if os.path.getsize(p) > 0]
    plain = cas.cas_ids([cas.read_message(p, os.path.getsize(p)) for p in hashed], "cpu")
    for p, want in zip(hashed, plain):
        check(on["cas"].get(p) == want, f"cas_id of {p} != the plain path on the CPU")
    for p in hashed[:: max(1, len(hashed) // N_OBS_REF)][:N_OBS_REF]:
        msg = cas.read_message(p, os.path.getsize(p))
        check(on["cas"][p] == blake3_ref.blake3_hex(msg, 8), f"cas_id of {p} != blake3_ref")
    prof = on["profile"]
    check(prof["enabled"] and prof["samples"] > 0, f"telemetry.profile: {prof}")
    groups = {g["group"]: g["share"] for g in prof["frame_groups"]}
    check("device_dispatch" in groups, f"no device_dispatch samples among {groups}")
    ratio = telemetry.gauge_value("sd_profile_overhead_ratio")
    check(prof["overhead_ratio"] < OBS_OVERHEAD and ratio < OBS_OVERHEAD,
          f"sampler overhead {prof['overhead_ratio']} (gauge {ratio}) >= {OBS_OVERHEAD}")
    steps["checks_s"] = time.perf_counter() - t0

    os.environ["SD_PROFILE"] = "0"
    try:
        off = asyncio.run(unprofiled())
    finally:
        os.environ.pop("SD_PROFILE", None)
        os.environ.pop("SD_CLOUD_TOKEN", None)
    check(off["cas"] == on["cas"], "cas_ids with SD_PROFILE=0 != with the sampler on")
    check(off["webps"] == on["webps"] and len(on["webps"]) == N_OBS_JPEG,
          f"webp bytes with SD_PROFILE=0 != with the sampler on ({len(off['webps'])} / "
          f"{len(on['webps'])} files)")
    check_healthy("12", since)
    seconds = time.perf_counter() - t_phase
    total = max(1, prof["samples"])
    print(json.dumps({"observability": {
        "steps_s": steps, "seconds": seconds, "files": len(paths),
        "spans_by_stage": spans["stages"], "identifier_hash_s": spans["identifier_hash_s"],
        "trace_x_events": on["x_events"], "bundle_bytes": on["bundle_bytes"],
        "sampler": {"samples": prof["samples"], "hz": prof["hz"],
                    "states": {k: v / total for k, v in prof["states"].items()},
                    "threads": prof["threads"], "groups": groups,
                    "overhead_ratio": prof["overhead_ratio"]},
        "k1_launches": {"profiled": on["launches"], "unprofiled": off["launches"]}}}),
        flush=True)
    print(f"phase 12: one trace over {len(OBS_STAGES)} stages, {prof['samples']} samples, "
          f"overhead {prof['overhead_ratio']:.4f}, SD_PROFILE=0 bit-identical, in "
          f"{seconds:.1f} s", flush=True)
    return {"launches": {"observability_profiled": on["launches"],
                         "observability_unprofiled": off["launches"]}}


# --- phase 13: the node's samplers and verdicts (plane 6.2b) ---------------

VERDICT_ENV = {"SD_HISTORY_INTERVAL_S": "0.1", "SD_RESOURCE_INTERVAL_S": "0.1"}
QUIET_ENV = {"SD_HISTORY": "0", "SD_RESOURCES": "0", "SD_TENANT_OBS": "0"}
VERDICT_STALL = "feeder.fetch:stall:delay_s=0.4"
VERDICT_COVER = 0.9  # JAX's test_clean_pass_buckets_cover_wall_time bar
VERDICT_PARTITION = 1e-9  # the unrounded sweep against its window
VERDICT_ROUNDING = 3e-6  # five buckets and the window, each rounded to 1 us
VERDICT_HISTORY_MIN = 5
RESOURCE_GAUGES = ("sd_resource_rss_bytes", "sd_resource_fds", "sd_resource_threads")
# `telemetry.serve`'s key tree, JAX's (`ServeRuntime.snapshot` under
# `enabled`): what a dashboard reads off a node with the serve layer
_SERVE_CLASS_KEYS = ("inflight", "queued", "admitted_total", "shed_total", "max_inflight",
                     "sheddable")
_SERVE_CACHE_KEYS = ("entries", "weight", "max_entries", "max_weight", "inflight_loads")
SERVE_KEYS = {"enabled": None,
              "gate": {"enabled": None, "mode": None,
                       "classes": {c: dict.fromkeys(_SERVE_CLASS_KEYS)
                                   for c in ("control", "sync", "interactive", "background")}},
              "caches": {c: dict.fromkeys(_SERVE_CACHE_KEYS) for c in ("query", "thumb", "meta")}}


def key_tree(doc):
    """`doc`'s nested dict keys, every leaf None (SERVE_KEYS's shape)."""
    return {k: key_tree(v) for k, v in doc.items()} if isinstance(doc, dict) else None


def check_serve_doc(doc: dict, where: str) -> dict:
    """`telemetry.serve` of a Node with the serve layer on, at rest: JAX's
    keys, the gate in its normal mode, no class shed; its classes."""
    check(doc.get("enabled") is True and key_tree(doc) == SERVE_KEYS,
          f"{where}: telemetry.serve {key_tree(doc)}")
    classes = doc["gate"]["classes"]
    check(doc["gate"]["mode"] == "normal" and not any(c["shed_total"] for c in classes.values())
          and classes["interactive"]["admitted_total"] > 0,
          f"{where}: the gate {doc['gate']}")
    return classes
KINETO_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def card_trace(path: str):
    """A torch.profiler context that traces CUDA activity only, its
    Chrome trace written to `path` on exit."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA],
                   on_trace_ready=lambda p: p.export_chrome_trace(path))


def card_busy_s(path: str) -> dict:
    """The card's busy seconds in a Chrome trace: the union of its
    kernel, memcpy and memset intervals (streams overlap, so they are
    merged, not summed), and the kernel count."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in KINETO_DEVICE_CATS and e.get("ph") == "X")
    busy, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return {"busy_s": busy / 1e6, "kernels": sum(e.get("cat") == "kernel" for e in events),
            "device_events": len(spans)}


def check_attribution(doc: dict, wall_s: float, tag: str) -> dict:
    """The scan's report (`telemetry.attrib` of its last pass): its
    buckets partition its window (the sweep's unrounded segments to
    VERDICT_PARTITION, the document's rounded buckets to
    VERDICT_ROUNDING). The identify job's pass, the spans between its
    `started` and `settled` markers, covers >= VERDICT_COVER of the
    markers' wall time: JAX's bar, which times a FileIdentifierJob. The
    whole scan's coverage is returned, not held: the media job's embed
    and media_data steps carry no span in either package."""
    from spacedrive_tpu_torch.telemetry import attrib
    from spacedrive_tpu_torch.telemetry import trace as trace_mod

    check("error" not in doc and doc["spans"] > 0, f"{tag} attribution: {doc}")
    spans = trace_mod.recent(doc["trace_id"])
    intervals = attrib._span_intervals(spans)
    window = max(iv["t1"] for iv in intervals) - min(iv["t0"] for iv in intervals)
    swept = sum(seg["seconds"] for seg in attrib._sweep(intervals))
    check(abs(swept - window) <= VERDICT_PARTITION,
          f"{tag} attribution: segments sum to {swept!r} s over a {window!r} s window")
    total = sum(doc["buckets"].values())
    check(abs(total - doc["wall_seconds"]) <= VERDICT_ROUNDING,
          f"{tag} attribution: buckets {doc['buckets']} sum to {total} != {doc['wall_seconds']}")
    check(set(doc["buckets"]) == set(attrib.BUCKETS)
          and all(v >= 0 for v in doc["buckets"].values()), f"{tag} buckets: {doc['buckets']}")
    marks = {(p["job"], p["event"]): p["ts"] for p in doc["passes"]}
    t0, t1 = marks[("file_identifier", "started")], marks[("file_identifier", "settled")]
    identify = attrib.report(doc["trace_id"], [
        x for x in spans if t0 <= x["t0"] and x["t0"] + x["seconds"] <= t1])
    covered = sum(identify["buckets"].values())
    check(covered >= VERDICT_COVER * (t1 - t0),
          f"{tag}: the identify pass's buckets cover {covered:.4f} s of its {t1 - t0:.4f} s "
          f"(< {VERDICT_COVER})")
    return {"buckets": doc["buckets"], "window_s": doc["wall_seconds"], "wall_s": wall_s,
            "coverage": total / wall_s, "spans": doc["spans"],
            "top_stages": dict(list(doc["top_stages"].items())[:6]),
            "identify": {"buckets": identify["buckets"], "wall_s": t1 - t0,
                         "coverage": covered / (t1 - t0)}}


def phase_verdicts(rng, tmp: str) -> dict:
    """Phase 13: a Node on the card scans phase 12's size mix through the
    router while its history writer and resource sampler run at 0.1 s;
    the attribution of the pass, the health, SLO, tenant, serve and mesh
    procedures and the card's busy share of the scan; a scan under an
    injected feeder stall blames the link bucket; with the plane off the
    scan is bit-identical and writes no history."""
    import asyncio

    from spacedrive_tpu_torch import telemetry
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.ops import blake3_ref, cas
    from spacedrive_tpu_torch.parallel import autotune, mesh
    from spacedrive_tpu_torch.telemetry import history, resources
    from spacedrive_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    mesh.LADDER.reset()
    autotune.reset()
    telemetry.reset()
    since = degradation()
    steps: dict[str, float] = {}
    root = os.path.join(tmp, "p13_corpus")
    t0 = time.perf_counter()
    paths = build_api_corpus(root, rng, (N_OBS_LARGE, N_OBS_SMALL, N_OBS_JPEG, 0))
    steps["corpus_s"] = time.perf_counter() - t0
    saved = {k: os.environ.get(k) for k in (*VERDICT_ENV, *QUIET_ENV)}
    os.environ.update(VERDICT_ENV)

    async def scan(tag: str, trace_path: str | None = None) -> dict:
        data_dir = os.path.join(tmp, f"p13_sdx_{tag}")
        node = Node(data_dir, device=DEVICE)
        node.config.config.p2p.enabled = False
        await node.start()
        try:
            if trace_path is None:
                got = await obs_scan(node, root, steps, tag)
            else:
                with card_trace(trace_path):
                    got = await obs_scan(node, root, steps, tag)
                    torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = node.router
            got["attrib"] = await r.exec(node, "telemetry.attrib", {"refresh": True})
            got["health"] = await r.exec(node, "telemetry.health")
            got["slo"] = await r.exec(node, "telemetry.slo")
            got["tenants"] = await r.exec(node, "telemetry.tenants")
            got["serve"] = await r.exec(node, "telemetry.serve")
            got["mesh"] = await r.exec(node, "telemetry.mesh")
            got["gauges"] = {g: telemetry.gauge_value(g) for g in RESOURCE_GAUGES}
            got["resources_started"] = node._resources_started
            got["resource_samples"] = resources.SAMPLER.sample_count()
            got["allowlist"] = sorted(history.default_samplers())
            steps[f"{tag}_procedures_s"] = time.perf_counter() - t0
        finally:
            await node.shutdown()
        got["history"] = history.read(history.history_dir(data_dir))
        got["webps"] = _webps(data_dir)
        return got

    try:
        trace_path = os.path.join(tmp, "p13_card_trace.json")
        clean = asyncio.run(scan("clean"))
        t0 = time.perf_counter()
        att = check_attribution(clean["attrib"], clean["wall_s"], "the clean scan")
        health = {k: v["status"] for k, v in clean["health"]["subsystems"].items()}
        check(clean["health"]["status"] == "healthy",
              f"health {clean['health']['status']}: {health}; feeder "
              f"{clean['health']['subsystems']['feeder']}; slo "
              f"{[(x['name'], x['status'], x.get('current')) for x in clean['slo']['slos']]}")
        check(health["device"] == "unknown" and health["serve"] == "healthy",
              f"device / serve verdicts {health['device']} / {health['serve']} (want unknown / "
              "healthy)")
        for sub in ("feeder", "event_loop", "resilience", "slo"):
            check(health[sub] not in ("degraded", "unhealthy"), f"health {sub}: {health[sub]}")
        slos = {x["name"]: x["status"] for x in clean["slo"]["slos"]}
        check(slos["pass_throughput"] != "breach", f"pass_throughput breached: {clean['slo']}")
        # the router's library-scoped requests are the serve surface's
        # one tenant, this library
        tenants = clean["tenants"]
        serve_surface = tenants["surfaces"].get("serve") or {}
        residents = serve_surface.get("residents") or [{}]
        check(tenants["enabled"] is True and tenants["k"] == 8 and set(tenants["surfaces"])
              == {"serve"} and len(residents) == 1 and residents[0].get("share") == 1.0
              and serve_surface["total"] == residents[0]["count"] > 0,
              f"telemetry.tenants: {tenants}")
        serve_classes = check_serve_doc(clean["serve"], "13 (clean scan)")
        local = clean["mesh"]["local"]
        check(clean["mesh"]["mesh"] == {"peers": {}} and local["health"]["status"] == "healthy"
              and clean["lid"] in local["node"]["libraries"],
              f"telemetry.mesh: peers {clean['mesh']['mesh']}, libraries "
              f"{list(local['node']['libraries'])}")
        check(all(v > 0 for v in clean["gauges"].values()), f"resource gauges {clean['gauges']}")
        full = [x for x in clean["history"] if sorted(x["v"]) == clean["allowlist"]]
        check(len(full) >= VERDICT_HISTORY_MIN,
              f"{len(full)} of {len(clean['history'])} history records hold the allowlist "
              f"(want >= {VERDICT_HISTORY_MIN})")
        check_healthy("13 (clean scan)", since)
        steps["clean_checks_s"] = time.perf_counter() - t0

        with faults.active(faults.FaultPlan.parse(VERDICT_STALL)):
            stalled = asyncio.run(scan("stalled"))
        stall = check_attribution(stalled["attrib"], stalled["wall_s"], "the stalled scan")
        b = stall["buckets"]
        check(b["link"] >= 0.3 and b["link"] > b["device"] and b["link"] > b["host_cpu"],
              f"the stalled scan's buckets {b}: link must be >= 0.3 s and above device and "
              "host_cpu")

        # the stall's fault activations are expected: read the quiet
        # scan's degradation counters from here
        mesh.LADDER.reset()
        autotune.reset()
        telemetry.reset()
        since = degradation()
        os.environ.update(QUIET_ENV)
        # the card's busy time is read on this scan: CUPTI's tracing slows
        # the clean scan's feeder past health's 1 s wait bar
        quiet = asyncio.run(scan("quiet", trace_path))
        card = card_busy_s(trace_path)
        quiet_att = check_attribution(quiet["attrib"], quiet["wall_s"], "the quiet scan")
        card["window_s"] = quiet_att["window_s"]
        card["share_of_window"] = card["busy_s"] / quiet_att["window_s"]
        check(quiet["cas"] == clean["cas"], "cas_ids with the plane off != with it on")
        check(quiet["webps"] == clean["webps"] and len(clean["webps"]) == N_OBS_JPEG,
              f"webp bytes with the plane off != with it on ({len(quiet['webps'])} / "
              f"{len(clean['webps'])} files)")
        check(quiet["history"] == [], f"SD_HISTORY=0 wrote {len(quiet['history'])} records")
        check(not quiet["resources_started"] and quiet["resource_samples"] == 0
              and not any(quiet["gauges"].values()),
              f"SD_RESOURCES=0 sampled: started {quiet['resources_started']}, "
              f"{quiet['resource_samples']} samples, gauges {quiet['gauges']}")
        check(not any(k.startswith("resource_") or k.startswith("tenant_")
                      for k in quiet["allowlist"]),
              f"the plane off still samples {quiet['allowlist']}")
        check_healthy("13 (quiet scan)", since)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    t0 = time.perf_counter()
    hashed = [p for p in paths if os.path.getsize(p) > 0]
    plain = cas.cas_ids([cas.read_message(p, os.path.getsize(p)) for p in hashed], "cpu")
    for tag, got in (("clean", clean), ("stalled", stalled), ("quiet", quiet)):
        check(got["launches"] > 0, f"the {tag} scan launched K1 no time")
        for p, want in zip(hashed, plain):
            check(got["cas"].get(p) == want, f"{tag} scan: cas_id of {p} != the plain path")
    for p in hashed[:: max(1, len(hashed) // N_OBS_REF)][:N_OBS_REF]:
        msg = cas.read_message(p, os.path.getsize(p))
        check(clean["cas"][p] == blake3_ref.blake3_hex(msg, 8), f"cas_id of {p} != blake3_ref")
    steps["plain_check_s"] = time.perf_counter() - t0
    seconds = time.perf_counter() - t_phase
    print(json.dumps({"verdicts": {
        "steps_s": steps, "seconds": seconds, "files": len(paths),
        "attribution": {"clean": att, "stalled": stall, "quiet": quiet_att},
        "card": card,
        "health": health,
        "slo": {x["name"]: {"status": x["status"], "current": x["current"],
                            **({"windows": x["windows"]} if x["name"] == "interactive_p99"
                               else {})}
                for x in clean["slo"]["slos"]},
        "slo_status": clean["slo"]["status"],
        "serve_classes": serve_classes,
        "tenants": {"total": serve_surface["total"], "residents": len(residents)},
        "history_records": {"clean": len(clean["history"]), "allowlist": len(full),
                            "stalled": len(stalled["history"]), "quiet": 0},
        "resource_gauges": clean["gauges"], "resource_samples": clean["resource_samples"],
        "k1_launches": {t: g["launches"] for t, g in (("clean", clean), ("stalled", stalled),
                                                      ("quiet", quiet))}}}), flush=True)
    print(f"phase 13: identify buckets cover {att['identify']['coverage']:.3f} of its pass "
          f"({att['coverage']:.3f} of the scan), card busy {card['share_of_window']:.3f} of a "
          f"scan's window, health {clean['health']['status']}, "
          f"stalled link {b['link']:.3f} s, plane off bit-identical, in {seconds:.1f} s",
          flush=True)
    return {"launches": {"verdicts_clean": clean["launches"],
                         "verdicts_stalled": stalled["launches"],
                         "verdicts_quiet": quiet["launches"]}}


# --- phase 14: the live location (watchers, fs ops, orphans) -----------------

LIVE_RENAMES = 256  # file renames within one directory
LIVE_DIR_MIN = 500  # files under the renamed directory, at least
LIVE_NEW = (16, 32, 16)  # new images, files of 101-512 KiB, files under 16 KiB
LIVE_MOVED_IN = (32, 32)  # a directory moved in: files of 101-512 KiB, under 16 KiB
LIVE_REWRITES = 16  # rewritten in place at the same size, and as many at a new size
LIVE_REMOVED = 32  # files removed, beside one directory
LIVE_FS = {"copy": 16, "cut": 8, "delete": 8, "erase": 4}
LIVE_BROWSE = 32  # JPEGs listed by ephemeralFiles.list
LIVE_WAIT_S = 120  # the bound on one step's settling
LIVE_QUIET_S = 0.1  # watchers, debounce and jobs idle this long: the step has settled
LIVE_ORACLE_COLS = ("location_id", "materialized_path", "name", "extension", "is_dir",
                    "size_in_bytes_bytes", "cas_id", "object_id")


def blake3_ref_hexes(messages: list[bytes], out_len: int = 8) -> list[str]:
    """blake3_ref's `out_len`-byte digests of `messages` in hex (pure
    Python, ~0.8 MB/s), in one child process per core: each imports the
    reference alone. The default length is a cas_id's."""
    import pickle

    code = ("import pickle, sys\n"
            "from spacedrive_tpu_torch.ops import blake3_ref\n"
            "msgs = pickle.load(sys.stdin.buffer)\n"
            f"pickle.dump([blake3_ref.blake3_hex(m, {int(out_len)}) for m in msgs], "
            "sys.stdout.buffer)\n")
    n = max(1, min(os.cpu_count() or 1, len(messages)))
    parts = [messages[i::n] for i in range(n)]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", code], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, cwd=root, env=env) for _ in parts]
    outs = []
    try:
        for proc, part in zip(procs, parts):
            proc.stdin.write(pickle.dumps(part))
            proc.stdin.close()
        for proc in procs:
            outs.append(pickle.loads(proc.stdout.read()))
            check(proc.wait(timeout=300) == 0, "a blake3_ref child failed")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    got: list[str] = [""] * len(messages)
    for i, out in enumerate(outs):
        got[i::n] = out
    return got


def _now_iso() -> str:
    from spacedrive_tpu_torch.db.database import now_iso

    return now_iso()


def _live_rows(db, loc_id: int) -> dict[int, dict]:
    return {r["id"]: r for r in db.query("SELECT * FROM file_path WHERE location_id = ?", (loc_id,))}


def _oracle_set(db) -> set:
    return {tuple(r[c] for c in LIVE_ORACLE_COLS) for r in db.query("SELECT * FROM file_path")}


def _jobs_since(db, since: str) -> list[dict]:
    from datetime import datetime

    from spacedrive_tpu_torch.jobs.report import JobReport

    def seconds(r) -> float:
        if not (r["date_started"] and r["date_completed"]):
            return 0.0
        return (datetime.fromisoformat(r["date_completed"])
                - datetime.fromisoformat(r["date_started"])).total_seconds()

    return [{"name": r["name"], "status": r["status"], "created": r["date_created"],
             "errors": r["errors_text"], "metadata": JobReport.from_row(r).metadata,
             "seconds": seconds(r)}
            for r in db.query("SELECT * FROM job WHERE date_created >= ? ORDER BY rowid", (since,))]


def _job_seconds(jobs: list[dict]) -> dict[str, float]:
    """Seconds each kind of job ran, summed (they overlap on the job
    system's workers)."""
    out: dict[str, float] = collections.Counter()
    for j in jobs:
        out[j["name"]] += j["seconds"]
    return dict(out)


def _identifier_sum(jobs: list[dict], key: str) -> int:
    return sum(int(j["metadata"].get(key, 0)) for j in jobs if j["name"] == "file_identifier")


def _live_orphans(db) -> tuple[int, int]:
    """(objects without a file_path, journal rows without their path)."""
    objects = db.query_one("SELECT COUNT(*) AS n FROM object o WHERE NOT EXISTS "
                           "(SELECT 1 FROM file_path fp WHERE fp.object_id = o.id)")["n"]
    journal = db.query_one(
        "SELECT COUNT(*) AS n FROM index_journal ij WHERE NOT EXISTS (SELECT 1 FROM file_path fp "
        "WHERE fp.location_id = ij.location_id AND fp.materialized_path = ij.materialized_path "
        "AND fp.name = ij.name AND fp.extension = ij.extension)")["n"]
    return objects, journal


class _ErrorRecords(logging.Handler):
    """Counts the ERROR records of the location manager and the jobs."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records: list[str] = []

    def emit(self, record):
        self.records.append(f"{record.name}: {record.getMessage()}")


async def _live_settle(node, lid: str, what: str) -> float:
    """Wait until the watchers hold no unpaired move half, no debounced
    flush and no flush in flight, and `jobs.isActive` is false, for
    LIVE_QUIET_S on end; fails past LIVE_WAIT_S. Returns the seconds
    waited."""
    import asyncio

    mgr, r = node.location_manager, node.router
    t0 = time.perf_counter()
    quiet_since = None
    while True:
        check(time.perf_counter() - t0 < LIVE_WAIT_S, f"{what}: not settled after {LIVE_WAIT_S} s")
        busy = bool(mgr._flush_tasks) or await r.exec(node, "jobs.isActive", library_id=lid) or any(
            e.flush_handle is not None or e.dirty_dirs or e.deep_dirs
            or e.watcher._pending_from for e in mgr._watched.values())
        now = time.perf_counter()
        if busy:
            quiet_since = None
        elif quiet_since is None:
            quiet_since = now
        elif now - quiet_since >= LIVE_QUIET_S:
            return now - t0
        await asyncio.sleep(0.02)


async def _until_row(db, cond, what: str) -> float:
    """Poll the library DB until `cond(db)` holds; the seconds it took."""
    import asyncio

    t0 = time.perf_counter()
    while not cond(db):
        check(time.perf_counter() - t0 < LIVE_WAIT_S, f"{what}: no row after {LIVE_WAIT_S} s")
        await asyncio.sleep(0.002)
    return time.perf_counter() - t0


def _burst_flushes(loc_id: int, since_ts: float) -> list[dict]:
    from spacedrive_tpu_torch.telemetry.events import WATCHER_EVENTS

    return [x["fields"] for x in WATCHER_EVENTS.snapshot()
            if x["type"] == "burst_flush" and x["ts"] >= since_ts
            and x["fields"].get("location") == loc_id]


def _write_images(stage: str, rng, n: int, prefix: str) -> list[tuple[str, int, int, int]]:
    """`n` seeded JPEG/PNG images of 640-4032 px written under `stage`
    (phase 3's aspects and orientations); their (path, w, h, orientation)."""
    jobs = []
    os.makedirs(stage, exist_ok=True)
    for i in range(n):
        aw, ah = ASPECTS[i % 4]
        long_side = int(np.exp(rng.uniform(np.log(LONG_SIDE[0]), np.log(LONG_SIDE[1]))))
        w, h = long_side, max(1, long_side * ah // aw)
        if i % 2:
            w, h = h, w
        fmt = "png" if prefix != "browse" and i % 4 == 3 else "jpg"
        jobs.append((os.path.join(stage, f"{prefix}{i:02d}.{fmt}"), w, h,
                     int(rng.integers(1 << 30)), fmt, (1, 6, 8, 3)[i % 4] if fmt == "jpg" else 1))
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(_image, jobs))


def _expected_dims(w: int, h: int, orientation: int) -> tuple[int, int]:
    from spacedrive_tpu_torch.ops import thumbnail_torch

    tw, th = thumbnail_torch.scale_dimensions(w, h)
    return (th, tw) if orientation in (5, 6, 7, 8) else (tw, th)


def _check_thumbs(store, ns, images, cas_of: dict, what: str) -> None:
    from PIL import Image

    for path, w, h, orientation in images:
        webp = store.path_for(ns, cas_of[path])
        check(os.path.exists(webp), f"{what}: no thumbnail for {path}")
        with Image.open(webp) as im:
            check(im.size == _expected_dims(w, h, orientation),
                  f"{what}: the thumbnail of {path} is {im.size}, want "
                  f"{_expected_dims(w, h, orientation)}")


def _check_cas(paths: list[str], cas_of: dict, what: str) -> None:
    """cas_ids of `paths` against the plain path on the card and
    blake3_ref on the host."""
    from spacedrive_tpu_torch.ops import cas

    msgs = [cas.read_message(p, os.path.getsize(p)) for p in paths]
    for p, plain, ref in zip(paths, plain_cas_ids(msgs), blake3_ref_hexes(msgs)):
        check(cas_of.get(p) == plain, f"{what}: cas_id of {p} {cas_of.get(p)} != the plain path's "
              f"{plain}")
        check(plain == ref, f"{what}: the plain path's cas_id of {p} != blake3_ref's")


async def live_renames(ctx: dict) -> dict:
    """14(a): one lone rename timed to its row, then 256 renames within
    one directory and a directory of >= LIVE_DIR_MIN files renamed, and a
    new empty folder at the end of the storm."""
    from spacedrive_tpu_torch.ops import blake3_cuda

    node, lib, loc, corpus = ctx["node"], ctx["lib"], ctx["loc"], ctx["corpus"]
    db, lid, mgr = lib.db, ctx["lid"], node.location_manager
    rows = _live_rows(db, loc["id"])
    by_dir: dict[str, list[dict]] = collections.defaultdict(list)
    for r in rows.values():
        if not r["is_dir"]:
            by_dir[r["materialized_path"]].append(r)
    images = sorted(by_dir["/images/"], key=lambda r: r["name"])[:LIVE_RENAMES]
    check(len(images) == LIVE_RENAMES, f"/images/ holds {len(by_dir['/images/'])} indexed files")
    big = [r for r in rows.values() if r["materialized_path"].startswith("/small/")]
    check(len([r for r in big if not r["is_dir"]]) >= LIVE_DIR_MIN,
          f"/small/ holds {len(big)} rows, want >= {LIVE_DIR_MIN} files")
    lone = sorted(by_dir["/d00/"], key=lambda r: r["name"])[0]

    blake3_cuda.chunk_cvs.launches = 0
    since, t0 = _now_iso(), time.time()
    old = _row_path(corpus, lone)
    os.rename(old, old[:-4] + "_moved.bin")
    latency = await _until_row(db, lambda d: d.find_one("file_path", id=lone["id"])["name"]
                               == lone["name"] + "_moved", "the lone rename")
    ren = {}
    for r in images:
        src = _row_path(corpus, r)
        ren[r["id"]] = "r_" + r["name"]
        os.rename(src, os.path.join(os.path.dirname(src), os.path.basename(src).replace(
            r["name"], ren[r["id"]], 1)))
    os.rename(os.path.join(corpus, "small"), os.path.join(corpus, "small_moved"))
    os.mkdir(os.path.join(corpus, "inbox"))
    t_storm = time.perf_counter()
    small = next(r for r in rows.values() if (r["materialized_path"], r["name"]) == ("/", "small"))
    applied = await _until_row(db, lambda d: d.find_one("file_path", id=small["id"])["name"]
                               == "small_moved", "the directory rename")
    await _live_settle(node, lid, "14(a)")
    storm_s = time.perf_counter() - t_storm
    launches = blake3_cuda.chunk_cvs.launches
    check(launches == 0, f"the rename storm launched K1 {launches} times")
    jobs = _jobs_since(db, since)
    check(_identifier_sum(jobs, "device_files") == 0
          and _identifier_sum(jobs, "journal_dirty_rehash") == 0,
          f"the rename storm rehashed files: {[j['metadata'] for j in jobs]}")
    after = _live_rows(db, loc["id"])
    for r in images:
        got = after.get(r["id"])
        check(got is not None and got["name"] == ren[r["id"]] and got["object_id"] == r["object_id"]
              and got["cas_id"] == r["cas_id"], f"renamed image {r['name']}: {got}")
    for r in big:
        got = after.get(r["id"])
        check(got is not None and got["materialized_path"] == "/small_moved/"
              + r["materialized_path"][len("/small/"):] and got["object_id"] == r["object_id"],
              f"row {r['id']} under the renamed directory: {got}")
    flushes = _burst_flushes(loc["id"], t0)
    widened = [f for f in flushes if f["vouched"] >= LIVE_RENAMES]
    check(len(widened) == 1 and widened[0]["debounce_s"] == round(mgr.debounce_max, 3)
          > mgr.debounce, f"the storm's burst_flush records {flushes}: want one with >= "
          f"{LIVE_RENAMES} vouched events and the window widened to {mgr.debounce_max} s")
    print(f"phase 14(a): a rename reached its row in {1e3 * latency:.1f} ms; {LIVE_RENAMES} "
          f"renames and a directory of {len(big)} rows moved in place (ids and objects kept), 0 "
          f"K1 launches, 0 rehashed; burst {widened[0]}", flush=True)
    return {"launches": launches, "rename_latency_ms": 1e3 * latency, "storm_s": storm_s,
            "storm_applied_s": applied, "renamed_dir_rows": len(big), "burst_flush": widened[0]}


async def live_content(ctx: dict, rng) -> dict:
    """14(b): 64 new files (one of them alone, timed to its cas_id), a
    directory of 64 files moved in, 32 rewrites in place."""
    from spacedrive_tpu_torch.ops import blake3_cuda

    node, lib, loc, corpus, tmp = ctx["node"], ctx["lib"], ctx["loc"], ctx["corpus"], ctx["tmp"]
    db, lid = lib.db, ctx["lid"]
    n_img, n_large, n_small = LIVE_NEW
    stage = os.path.join(tmp, "p14_stage")
    images = _write_images(stage, rng, n_img, "new")
    blobs: list[tuple[str, bytes]] = []
    for p, *_ in images:
        with open(p, "rb") as f:
            blobs.append((os.path.join(corpus, "images", os.path.basename(p)), f.read()))
    large = np.exp(rng.uniform(np.log(101 * 1024), np.log(512 * 1024), n_large)).astype(int)
    for i, size in enumerate(large):
        blobs.append((os.path.join(corpus, f"d{i % 8:02d}", f"new{i:02d}.bin"), rng.bytes(int(size))))
    for i in range(n_small):
        blobs.append((os.path.join(corpus, "small_moved", f"s{i % 4:02d}", f"new{i:02d}.dat"),
                      rng.bytes(int(rng.integers(1, 16 * 1024)))))
    incoming = os.path.join(tmp, "p14_incoming")
    moved: list[str] = []
    for i, size in enumerate(list(np.exp(rng.uniform(np.log(101 * 1024), np.log(512 * 1024),
                                                     LIVE_MOVED_IN[0])).astype(int))
                             + list(rng.integers(1, 16 * 1024, LIVE_MOVED_IN[1]))):
        path = os.path.join(incoming, f"sub{i % 2}", f"in{i:02d}.bin")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(rng.bytes(int(size)))
        moved.append(os.path.join(corpus, "incoming", f"sub{i % 2}", f"in{i:02d}.bin"))
    rows = [r for r in _live_rows(db, loc["id"]).values()
            if not r["is_dir"] and r["materialized_path"] in {f"/d{i:02d}/" for i in range(8, 15)}
            and os.path.getsize(_row_path(corpus, r)) > 101 * 1024]
    picked = [rows[int(i)] for i in rng.choice(len(rows), 2 * LIVE_REWRITES, replace=False)]
    same = [_row_path(corpus, r) for r in picked[:LIVE_REWRITES]]
    grown = [_row_path(corpus, r) for r in picked[LIVE_REWRITES:]]

    blake3_cuda.chunk_cvs.launches = 0
    since = _now_iso()
    lone_path, lone_data = blobs[n_img]
    with open(lone_path, "wb") as f:
        f.write(lone_data)
    latency = await _until_row(db, lambda d: (r := d.query_one(
        "SELECT cas_id FROM file_path WHERE location_id = ? AND materialized_path = ? AND "
        "name = ?", (loc["id"], "/d00/", "new00"))) is not None and r["cas_id"] is not None,
        "the lone new file")
    t_burst = time.perf_counter()
    for path, data in blobs[:n_img] + blobs[n_img + 1:]:
        with open(path, "wb") as f:
            f.write(data)
    os.rename(incoming, os.path.join(corpus, "incoming"))
    for p in same:
        rewrite_in_place(p)
    for p in grown:
        with open(p, "ab") as f:
            f.write(rng.bytes(4096))
    await _live_settle(node, lid, "14(b)")
    burst_s = time.perf_counter() - t_burst
    launches = blake3_cuda.chunk_cvs.launches
    check(launches > 0, "the new and changed files launched K1 no time")
    jobs = _jobs_since(db, since)
    device_files = _identifier_sum(jobs, "device_files")
    dirty = _identifier_sum(jobs, "journal_dirty_rehash")
    # every rewritten file is over 100 KiB: its sampled message keeps its
    # 57,352 bytes whatever its size, so the chunk cache rehashes the dirty
    # chunks of all 32 on the host
    n_device, n_dirty = len(blobs) + len(moved), len(same) + len(grown)
    check(device_files == n_device and dirty == n_dirty,
          f"hashed {device_files} files on the card and {dirty} by dirty range, want {n_device} "
          f"and {n_dirty}")
    cas_of = {_row_path(corpus, r): r["cas_id"] for r in _live_rows(db, loc["id"]).values()}
    paths = [p for p, _ in blobs] + moved + same + grown
    _check_cas(paths, cas_of, "14(b)")
    # the new images: thumbnails at their dims, embeddings and media_data
    from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore

    landed = [(os.path.join(corpus, "images", os.path.basename(p)), w, h, o)
              for p, w, h, o in images]
    _check_thumbs(ThumbnailStore(os.path.join(ctx["data_dir"], "thumbnails")), str(lib.id),
                  landed, cas_of, "14(b)")
    objs = {r["object_id"] for r in _live_rows(db, loc["id"]).values()
            if _row_path(corpus, r) in {p for p, *_ in landed}}
    embedded = {r["object_id"] for r in db.query("SELECT object_id FROM object_embedding")}
    media = {r["object_id"] for r in db.query("SELECT object_id FROM media_data")}
    check(len(objs) == n_img and objs <= embedded and objs <= media,
          f"the new images' {len(objs)} objects: {len(objs - embedded)} without an embedding, "
          f"{len(objs - media)} without media_data")
    print(f"phase 14(b): a new file reached its cas_id in {1e3 * latency:.1f} ms; {len(paths)} "
          f"new, moved-in and rewritten files: {device_files} hashed on the card (K1 {launches} "
          f"launches), {dirty} by dirty range; cas_ids == the plain path and blake3_ref; "
          f"{n_img} thumbnails at their dims, embedded", flush=True)
    return {"launches": launches, "new_file_latency_ms": 1e3 * latency, "burst_s": burst_s,
            "files": len(paths), "device_files": device_files, "dirty_range": dirty,
            "chains": sum(j["name"] == "file_identifier" for j in jobs),
            "job_s": _job_seconds(jobs)}


async def live_removals(ctx: dict, rng) -> dict:
    """14(c): 32 files and a directory removed; then the orphan remover."""
    from spacedrive_tpu_torch.location.indexer.journal import key_of
    from spacedrive_tpu_torch.ops import blake3_cuda

    node, lib, loc, corpus = ctx["node"], ctx["lib"], ctx["loc"], ctx["corpus"]
    db, lid = lib.db, ctx["lid"]
    rows = [r for r in _live_rows(db, loc["id"]).values()
            if not r["is_dir"] and r["materialized_path"] in {f"/d{i:02d}/" for i in range(2, 6)}]
    gone = [rows[int(i)] for i in rng.choice(len(rows), LIVE_REMOVED, replace=False)]
    tree = [r for r in _live_rows(db, loc["id"]).values()
            if r["materialized_path"].startswith("/d15/")
            or (r["materialized_path"], r["name"]) == ("/", "d15")]
    blake3_cuda.chunk_cvs.launches = 0
    t0 = time.perf_counter()
    for r in gone:
        os.remove(_row_path(corpus, r))
    shutil.rmtree(os.path.join(corpus, "d15"))
    await _live_settle(node, lid, "14(c)")
    removed_s = time.perf_counter() - t0
    launches = blake3_cuda.chunk_cvs.launches
    left = _live_rows(db, loc["id"])
    journal = {(r["materialized_path"], r["name"], r["extension"])
               for r in db.query("SELECT * FROM index_journal WHERE location_id = ?", (loc["id"],))}
    for r in gone + tree:
        check(r["id"] not in left, f"the removed {_row_path(corpus, r)} still has its row")
        check(key_of(r) not in journal, f"the removed {_row_path(corpus, r)} keeps its journal row")
    objects_before = db.count("object")
    orphans_before = _live_orphans(db)
    t0 = time.perf_counter()
    await lib.orphan_remover.invoke()
    await _until_row(db, lambda d: _live_orphans(d) == (0, 0), "the orphan remover")
    remover_s = time.perf_counter() - t0
    print(f"phase 14(c): {len(gone)} files and a directory of {len(tree)} rows removed, rows and "
          f"journal rows gone; the orphan remover took {objects_before - db.count('object')} "
          f"objects and left no orphan (before: {orphans_before}) in {remover_s:.2f} s", flush=True)
    return {"launches": launches, "removed_s": removed_s, "remover_s": remover_s,
            "rows_removed": len(gone) + len(tree),
            "objects_removed": objects_before - db.count("object"),
            "orphans_before": list(orphans_before)}


async def live_fs_ops(ctx: dict, rng) -> dict:
    """14(d): a second watched location through `locations.create`; then
    `files.copyFiles` into it, `cutFiles`, `deleteFiles` and `eraseFiles`
    within the first, each settled before the next."""
    from spacedrive_tpu_torch.ops import blake3_cuda

    node, lib, loc, corpus, tmp = ctx["node"], ctx["lib"], ctx["loc"], ctx["corpus"], ctx["tmp"]
    db, lid, r = lib.db, ctx["lid"], node.router
    steps: dict[str, float] = {}
    target = os.path.join(tmp, "p14_target")
    os.makedirs(target)
    t0 = time.perf_counter()
    loc2 = await r.exec(node, "locations.create", {"path": target, "name": "target"},
                        library_id=lid)
    await _live_settle(node, lid, "14(d) locations.create")
    steps["create_s"] = time.perf_counter() - t0
    check(node.location_manager.is_watched(lib, loc2), "locations.create started no watcher")
    rows = _live_rows(db, loc["id"])
    imgs = sorted((x for x in rows.values() if x["materialized_path"] == "/images/"
                   and x["name"].startswith("r_")), key=lambda x: x["id"])
    sources = [imgs[int(i)] for i in rng.choice(len(imgs), LIVE_FS["copy"], replace=False)]
    launches = {}

    async def op(name: str, key: str, arg: dict) -> float:
        blake3_cuda.chunk_cvs.launches = 0
        t0 = time.perf_counter()
        await r.exec(node, key, arg, library_id=lid)
        await _live_settle(node, lid, f"14(d) {key}")
        launches[name] = blake3_cuda.chunk_cvs.launches
        steps[f"{name}_s"] = time.perf_counter() - t0
        return t0

    objects = db.count("object")
    await op("copy", "files.copyFiles", {
        "source_location_id": loc["id"], "target_location_id": loc2,
        "sources_file_path_ids": [x["id"] for x in sources], "target_relative_path": "copies"})
    copies = {x["name"]: x for x in _live_rows(db, loc2).values()
              if x["materialized_path"] == "/copies/"}
    check(len(copies) == len(sources), f"{len(copies)} copies indexed, want {len(sources)}")
    for s in sources:
        c = copies.get(s["name"])
        check(c is not None and c["cas_id"] == s["cas_id"] and c["object_id"] == s["object_id"],
              f"the copy of {s['name']}: {c} (source cas {s['cas_id']}, object {s['object_id']})")
    check(launches["copy"] > 0, "the copies' rescan launched K1 no time")
    check(db.count("object") == objects, f"the copies made {db.count('object') - objects} objects")

    pool = {f"/d{i:02d}/": sorted((x for x in rows.values() if x["materialized_path"] == f"/d{i:02d}/"
                                   and not x["is_dir"]), key=lambda x: x["id"]) for i in (6, 8, 9)}
    cut = pool["/d06/"][:LIVE_FS["cut"]]
    await op("cut", "files.cutFiles", {
        "source_location_id": loc["id"], "target_location_id": loc["id"],
        "sources_file_path_ids": [x["id"] for x in cut], "target_relative_path": "d07"})
    after = _live_rows(db, loc["id"])
    for x in cut:
        check(after.get(x["id"], {}).get("materialized_path") == "/d07/"
              and after[x["id"]]["object_id"] == x["object_id"]
              and os.path.exists(_row_path(corpus, after[x["id"]])),
              f"the cut {x['name']}: {after.get(x['id'])}")
    check(launches["cut"] == 0, f"the cut launched K1 {launches['cut']} times")

    deleted = pool["/d08/"][:LIVE_FS["delete"]]
    await op("delete", "files.deleteFiles", {"location_id": loc["id"],
                                             "file_path_ids": [x["id"] for x in deleted]})
    erased = pool["/d09/"][:LIVE_FS["erase"]]
    ts_erase = time.time()
    since_erase = _now_iso()
    await op("erase", "files.eraseFiles", {"location_id": loc["id"], "passes": 1,
                                           "file_path_ids": [x["id"] for x in erased]})
    after = _live_rows(db, loc["id"])
    for x in deleted + erased:
        check(x["id"] not in after and not os.path.exists(_row_path(corpus, x)),
              f"{_row_path(corpus, x)}: row {x['id'] in after}, on disk {os.path.exists(_row_path(corpus, x))}")
    flushes = _burst_flushes(loc["id"], ts_erase)
    rescans = [j for j in _jobs_since(db, since_erase) if j["name"] == "indexer"]
    check(not flushes and not rescans, f"a rescan started in the erased location: flushes "
          f"{flushes}, indexer jobs {len(rescans)}")
    reports = {j["name"]: j for j in await r.exec(node, "jobs.reports", library_id=lid)}
    for name in ("file_copier", "file_cutter", "file_deleter", "file_eraser"):
        check(reports.get(name, {}).get("status") == "COMPLETED",
              f"{name}: {reports.get(name, {}).get('status')} {reports.get(name, {}).get('errors')}")
    delete_ops = db.query_one("SELECT COUNT(*) AS n FROM crdt_operation WHERE model = 'file_path' "
                              "AND kind = 'd'")["n"]
    print(f"phase 14(d): {len(copies)} copies indexed in the second location through K1 "
          f"({launches['copy']} launches), linked to their sources' objects (objects "
          f"{objects} -> {db.count('object')}); {len(cut)} cut in place, {len(deleted)} deleted, "
          f"{len(erased)} erased with no rescan of their location", flush=True)
    return {"launches": sum(launches.values()), "launches_by_op": launches, "steps_s": steps,
            "loc2": loc2, "file_path_delete_ops": delete_ops}


async def live_ephemeral(ctx: dict, rng) -> dict:
    """14(e): `ephemeralFiles.list` of a directory outside every location."""
    from spacedrive_tpu_torch.object.media.thumbnail.store import ThumbnailStore

    node, tmp = ctx["node"], ctx["tmp"]
    root = os.path.join(tmp, "p14_browse")
    images = _write_images(root, rng, LIVE_BROWSE, "browse")
    device_s = node.thumbnailer.stage_seconds["device"]
    t0 = time.perf_counter()
    listing = await node.router.exec(node, "ephemeralFiles.list", {"path": root})
    list_s = time.perf_counter() - t0
    await node.thumbnailer.wait_library_batch(None)
    thumbs_s = time.perf_counter() - t0
    entries = {e["path"]: e for e in listing["entries"]}
    check(len(entries) == LIVE_BROWSE, f"ephemeralFiles.list gave {len(entries)} entries")
    cas_of = {p: e["cas_id"] for p, e in entries.items()}
    _check_cas(sorted(entries), cas_of, "14(e)")
    _check_thumbs(ThumbnailStore(os.path.join(ctx["data_dir"], "thumbnails")), None, images,
                  cas_of, "14(e)")
    card_s = node.thumbnailer.stage_seconds["device"] - device_s
    check(card_s > 0, "the ephemeral thumbnails took no time on the card")
    print(f"phase 14(e): ephemeralFiles.list of {len(entries)} JPEGs in {list_s:.2f} s, cas_ids "
          f"== blake3_ref; their thumbnails resized on the card ({card_s:.3f} s) at their dims",
          flush=True)
    return {"list_s": list_s, "thumbnails_s": thumbs_s, "card_resize_s": card_s}


async def live_oracle(ctx: dict, loc2: int) -> dict:
    """14(f): `locations.fullRescan` of both locations changes nothing."""
    from spacedrive_tpu_torch.ops import blake3_cuda

    node, lib, loc = ctx["node"], ctx["lib"], ctx["loc"]
    db, lid, r = lib.db, ctx["lid"], node.router
    before = _oracle_set(db)
    blake3_cuda.chunk_cvs.launches = 0
    since = _now_iso()
    t0 = time.perf_counter()
    for loc_id in (loc["id"], loc2):
        await r.exec(node, "locations.fullRescan", {"location_id": loc_id}, library_id=lid)
    await _live_settle(node, lid, "14(f)")
    seconds = time.perf_counter() - t0
    launches = blake3_cuda.chunk_cvs.launches
    check(launches == 0, f"the closing fullRescan launched K1 {launches} times")
    media = [j["metadata"] for j in _jobs_since(db, since) if j["name"] == "media_processor"]
    idle = {"media_data_extracted": 0, "media_data_skipped": 0, "thumbnails_dispatched": 0,
            "embeddings_written": 0}
    check(len(media) == 2 and all({k: m.get(k) for k in idle} == idle for m in media),
          f"the closing fullRescans' media jobs did work: {media}")
    after = _oracle_set(db)
    check(after == before, f"the fullRescan changed rows: {len(before - after)} gone, "
          f"{len(after - before)} new (e.g. {sorted(before ^ after, key=str)[:4]})")
    print(f"phase 14(f): fullRescan of both locations ({len(after)} rows) in {seconds:.2f} s: 0 K1 "
          f"launches, the media jobs idle, every row as the watchers left it", flush=True)
    return {"launches": launches, "seconds": seconds, "rows": len(after),
            "job_s": _job_seconds(_jobs_since(db, since))}


def phase_live(rng, tmp: str, p4: dict, then=None) -> dict:
    """Phase 14: a Node on the card over phase 4's data dir watches its
    locations through a seeded burst of changes, the fs-ops jobs and the
    orphan remover; a closing fullRescan changes nothing. `then(ctx)`,
    where given, runs on that Node before it shuts down (phase 15); its
    result is returned under "then"."""
    import asyncio

    from spacedrive_tpu_torch.location.indexer.job import IndexerJob
    from spacedrive_tpu_torch.location.watcher import inotify
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.parallel import autotune, mesh

    t_phase = time.perf_counter()
    # the seconds the scans' full directory-size roll-ups take, beside the
    # watcher's own per-directory sizes (`rollup_seconds`)
    rollup = {"indexer_s": 0.0}
    full_rollup = IndexerJob._rollup_directory_sizes

    def timed_rollup(library, loc_id):
        t0 = time.perf_counter()
        try:
            full_rollup(library, loc_id)
        finally:
            rollup["indexer_s"] += time.perf_counter() - t0

    IndexerJob._rollup_directory_sizes = staticmethod(timed_rollup)
    mesh.LADDER.reset()
    autotune.reset()
    since = degradation()
    errors = _ErrorRecords()
    watched_loggers = [logging.getLogger(n) for n in (
        "spacedrive_tpu_torch.location", "spacedrive_tpu_torch.jobs",
        "spacedrive_tpu_torch.object")]
    for lg in watched_loggers:
        lg.addHandler(errors)
    steps: dict[str, float] = {}

    async def run() -> dict:
        t0 = time.perf_counter()
        # no labeler: phase 6 holds the labelled scan, and it would relabel
        # every image in the closing fullRescan
        node = Node(p4["data_dir"], device=DEVICE, with_labeler=False)
        node.config.config.p2p.enabled = False
        await node.start()
        steps["boot_s"] = time.perf_counter() - t0
        try:
            lib = next(x for x in node.libraries.libraries.values() if x.name == "smoke")
            loc = lib.db.find_one("location", path=os.path.abspath(p4["corpus"]))
            mgr = node.location_manager
            backends = sorted({type(e.watcher).__name__ for e in mgr._watched.values()})
            check(mgr.is_watched(lib, loc["id"]) and backends == ["InotifyWatcher"]
                  and inotify.available(), f"the node's watchers: {backends}")
            ctx = {"node": node, "lib": lib, "lid": str(lib.id), "loc": loc,
                   "corpus": p4["corpus"], "data_dir": p4["data_dir"], "tmp": tmp}
            phase_since = _now_iso()
            out = {"backend": backends[0], "rollup_s": {}}
            for name, fn in (("renames", lambda: live_renames(ctx)),
                             ("content", lambda: live_content(ctx, rng)),
                             ("removals", lambda: live_removals(ctx, rng)),
                             ("fs_ops", lambda: live_fs_ops(ctx, rng)),
                             ("ephemeral", lambda: live_ephemeral(ctx, rng)),
                             ("oracle", lambda: live_oracle(ctx, out["fs_ops"]["loc2"]))):
                t0, r0, w0 = time.perf_counter(), rollup["indexer_s"], mgr.rollup_seconds
                out[name] = await fn()
                steps[f"{name}_s"] = time.perf_counter() - t0
                out["rollup_s"][name] = {"indexer": rollup["indexer_s"] - r0,
                                         "watcher": mgr.rollup_seconds - w0}
            # (g): every job of the phase completed, nothing is left to apply
            jobs = _jobs_since(lib.db, phase_since)
            bad = [(j["name"], j["status"], j["errors"]) for j in jobs if j["status"] != 2]
            check(not bad, f"jobs of phase 14 that did not complete: {bad}")
            out["jobs"] = len(jobs)
            out["events_applied"] = mgr.events_applied
            await _live_settle(node, str(lib.id), "14(g)")
            if then is not None:
                out["then"] = await then(ctx)
            return out
        finally:
            await node.shutdown()

    try:
        got = asyncio.run(run())
    finally:
        IndexerJob._rollup_directory_sizes = staticmethod(full_rollup)
        for lg in watched_loggers:
            lg.removeHandler(errors)
    check(not errors.records, f"phase 14 logged {len(errors.records)} failures: "
          f"{errors.records[:5]}")
    check_healthy("14", since)
    # phase 15 ran on this phase's Node: its seconds are its own
    seconds = time.perf_counter() - t_phase - (got["then"]["seconds"] if then else 0.0)
    launches = {f"live_{k}": got[k]["launches"]
                for k in ("renames", "content", "removals", "fs_ops", "oracle")}
    print(json.dumps({"live_location": {
        "steps_s": steps, "seconds": seconds, "backend": got["backend"],
        "k1_launches": launches, "jobs": got["jobs"], "events_applied": got["events_applied"],
        "rollup_s": got["rollup_s"],
        **{k: {x: y for x, y in got[k].items() if x not in ("launches", "loc2")}
           for k in ("renames", "content", "removals", "fs_ops", "ephemeral", "oracle")}}}),
        flush=True)
    print(f"phase 14: the live location on the card ({got['backend']}) in {seconds:.1f} s: "
          f"rename {got['renames']['rename_latency_ms']:.1f} ms to its row, a new file "
          f"{got['content']['new_file_latency_ms']:.1f} ms to its cas_id; the fullRescan "
          f"oracle holds", flush=True)
    return {"launches": launches, "then": got.get("then")}


REPLICA_FILES = (16, 8, 8)  # files over 100 KiB, JPEGs, files under 16 KiB
REPLICA_DIR = "p15_decrypted"  # the sibling directory the copies are decrypted in
REPLICA_PASSWORD = "correct horse battery staple"
# Argon2id (KiB, passes, lanes) of the jobs' keyslots: the standard profile
# (128 MiB, 8 passes) takes ~0.8 s a derivation on a host core, 64 of them
# here; the keys.* calls run the standard profile
REPLICA_KDF = [1024, 1, 1]
REPLICA_QUERIES = 8
REPLICA_TAGGED = 16
REPLICA_SCORE_TOL = 1e-5


def _synced_fields(db) -> dict[str, set[str]]:
    """The fields each model's ops carry in a library's op log."""
    fields: dict[str, set[str]] = collections.defaultdict(set)
    for x in db.query("SELECT DISTINCT model, kind FROM crdt_operation"):
        if x["kind"].startswith("u:"):
            fields[x["model"]].add(x["kind"][2:])
    return fields


def _sync_view(db, fields: dict[str, set[str]]) -> dict[str, dict]:
    """Every synced model's rows by sync id, with the values of the
    fields its ops carry (`fields`), the foreign keys as their targets'
    sync ids."""
    from spacedrive_tpu_torch.db.sync_registry import SYNC_MODELS, SyncKind

    def sync_id(v):
        return v.hex() if isinstance(v, (bytes, bytearray)) else v

    ids = {t: {r["id"]: sync_id(r[f]) for r in db.query(f"SELECT id, {f} FROM {t}")}
           for t, f in (("object", "pub_id"), ("location", "pub_id"), ("tag", "pub_id"),
                        ("label", "name"))}
    view: dict[str, dict] = {}
    for model in SYNC_MODELS.values():
        if model.kind is SyncKind.LOCAL:
            continue
        refs = {fr.column: fr.table for fr in model.foreign_refs}
        cols = fields.get(model.name, set()) - set(model.local_fields)
        rows = {}
        for r in db.query(f"SELECT * FROM {model.name}"):
            if model.kind is SyncKind.RELATION:
                key = (ids[model.item.table].get(r[model.item.column]),
                       ids[model.group.table].get(r[model.group.column]))
            elif model.id_ref is not None:
                key = ids[model.id_ref.table].get(r[model.id_ref.column])
            else:
                key = sync_id(r[model.id_field])
            rows[key] = {c: (ids[refs[c]].get(r[c]) if c in refs and r[c] is not None else r[c])
                         for c in sorted(cols)}
        view[model.name] = rows
    return view


def _carried_ids(db) -> dict[str, set]:
    """The record ids each model's ops carry in a library's op log, keyed
    as `_sync_view` keys its rows."""
    from spacedrive_tpu_torch.utils.msgpack_codec import unpackb

    ids: dict[str, set] = collections.defaultdict(set)
    for x in db.query("SELECT DISTINCT model, record_id FROM crdt_operation"):
        rid = unpackb(x["record_id"])
        ids[x["model"]].add((rid["item"], rid["group"]) if isinstance(rid, dict) else rid)
    return ids


def _table_columns(db, table: str) -> list[str]:
    return [x["name"] for x in db.query(f"PRAGMA table_info({table})")]


def _check_views_equal(a: dict, b: dict, what: str) -> dict[str, int]:
    """Fails on any model whose rows differ; returns the rows by model."""
    for model in a:
        if a[model] != b[model]:
            ka, kb = set(a[model]), set(b[model])
            diff = [k for k in ka & kb if a[model][k] != b[model][k]]
            example = ([(k, {c: (a[model][k][c], b[model][k].get(c)) for c in a[model][k]
                             if a[model][k][c] != b[model][k].get(c)}) for k in diff[:2]])
            check(False, f"{what}: {model} differs: {len(ka - kb)} rows only on the owner, "
                  f"{len(kb - ka)} only on the joiner, {len(diff)} with other values, e.g. "
                  f"{sorted(ka ^ kb, key=str)[:2]} {example}")
    return {m: len(rows) for m, rows in a.items()}


async def replica_crypto(ctx: dict, rng) -> dict:
    """15(a): the crypto jobs through the live location, and keys.*."""
    import filecmp

    from spacedrive_tpu_torch.api.router import RspcError
    from spacedrive_tpu_torch.db.database import blob_u64
    from spacedrive_tpu_torch.jobs import JobBuilder
    from spacedrive_tpu_torch.object.fs.encrypt import FileDecryptorJob, FileEncryptorJob
    from spacedrive_tpu_torch.ops import blake3_cuda

    node, lib, loc, corpus = ctx["node"], ctx["lib"], ctx["loc"], ctx["corpus"]
    db, lid, r = lib.db, ctx["lid"], node.router
    steps: dict[str, float] = {}
    launches: dict[str, int] = {}
    rows = [x for x in _live_rows(db, loc["id"]).values()
            if not x["is_dir"] and x["cas_id"] and x["name"] != ".spacedrive"
            and os.path.exists(_row_path(corpus, x))]
    size = {x["id"]: blob_u64(x["size_in_bytes_bytes"]) or 0 for x in rows}
    pools = (
        [x for x in rows if size[x["id"]] > 100 * 1024 and x["extension"] not in ("jpg", "png")],
        [x for x in rows if x["extension"] == "jpg"],
        [x for x in rows if size[x["id"]] < 16 * 1024 and x["extension"] not in ("jpg", "png")],
    )
    chosen = []
    for pool, n in zip(pools, REPLICA_FILES):
        # each kind from one directory (the one with the most candidates),
        # so the watcher's rescans of the copies are a few chains; names
        # are distinct within it, and the three directories hold no name
        # twice in the corpus
        by_dir = collections.defaultdict(list)
        for x in pool:
            by_dir[x["materialized_path"]].append(x)
        best = sorted(by_dir.items(), key=lambda kv: (-len(kv[1]), kv[0]))[0][1]
        best.sort(key=lambda x: x["id"])
        check(len(best) >= n, f"15(a): {len(best)} candidates, want {n}")
        chosen += [best[int(i)] for i in rng.choice(len(best), n, replace=False)]
    check(len({(x["name"], x["extension"]) for x in chosen}) == len(chosen),
          "15(a): two chosen files share a name")
    os.makedirs(os.path.join(corpus, REPLICA_DIR))
    await _live_settle(node, lid, "15(a) mkdir")
    objects = db.count("object")
    since = _now_iso()

    def enc_rows(path: str | None = None) -> list[dict]:
        return [x for x in db.query(
            "SELECT * FROM file_path WHERE location_id = ? AND extension = 'sdenc'"
            + (" AND materialized_path = ?" if path else ""),
            (loc["id"], path) if path else (loc["id"],)) if x["cas_id"]]

    async def run(name: str, job=None, key: str | None = None, arg=None, ready=None) -> None:
        blake3_cuda.chunk_cvs.launches = 0
        t0 = time.perf_counter()
        if job is not None:
            await JobBuilder(job).spawn(node.jobs, lib)
        else:
            await r.exec(node, key, arg, library_id=lid)
        await _until_row(db, ready, f"15(a) {name}")
        await _live_settle(node, lid, f"15(a) {name}")
        steps[f"{name}_s"] = time.perf_counter() - t0
        launches[name] = blake3_cuda.chunk_cvs.launches

    await run("encrypt", FileEncryptorJob({
        "location_id": loc["id"], "file_path_ids": [x["id"] for x in chosen],
        "password": REPLICA_PASSWORD, "_test_overrides": REPLICA_KDF}),
        ready=lambda db: len(enc_rows()) == len(chosen))
    encrypted = {_row_path(corpus, x): x for x in enc_rows()}
    check(set(encrypted) == {_row_path(corpus, x) + ".sdenc" for x in chosen},
          "15(a): the .sdenc rows are not the encrypted files")
    check(launches["encrypt"] > 0, "15(a): the .sdenc files were hashed without K1")
    _check_cas(sorted(encrypted), {p: x["cas_id"] for p, x in encrypted.items()}, "15(a) .sdenc")
    new_objects = len({x["cas_id"] for x in encrypted.values()})
    await run("cut", key="files.cutFiles", arg={
        "source_location_id": loc["id"], "target_location_id": loc["id"],
        "sources_file_path_ids": [x["id"] for x in encrypted.values()],
        "target_relative_path": REPLICA_DIR},
        ready=lambda db: len(enc_rows(f"/{REPLICA_DIR}/")) == len(chosen))
    check(launches["cut"] == 0, f"15(a): the cut launched K1 {launches['cut']} times")

    def decrypted(db) -> dict[str, dict]:
        return {f"{x['name']}.{x['extension']}" if x["extension"] else x["name"]: x
                for x in db.query("SELECT * FROM file_path WHERE location_id = ? AND "
                                  "materialized_path = ? AND extension != 'sdenc'",
                                  (loc["id"], f"/{REPLICA_DIR}/")) if x["cas_id"]}

    await run("decrypt", FileDecryptorJob({
        "location_id": loc["id"], "file_path_ids": [x["id"] for x in enc_rows()],
        "password": REPLICA_PASSWORD, "_test_overrides": REPLICA_KDF}),
        ready=lambda db: len(decrypted(db)) == len(chosen))
    check(launches["decrypt"] > 0, "15(a): the decrypted copies were hashed without K1")
    got = decrypted(db)
    for x in chosen:
        name = f"{x['name']}.{x['extension']}" if x["extension"] else x["name"]
        y = got.get(name)
        check(y is not None and y["cas_id"] == x["cas_id"] and y["object_id"] == x["object_id"],
              f"15(a): the decrypted {name}: {y and (y['cas_id'], y['object_id'])}, its original "
              f"{(x['cas_id'], x['object_id'])}")
        check(filecmp.cmp(_row_path(corpus, x), _row_path(corpus, y), shallow=False),
              f"15(a): the decrypted {name} differs from its original")
    check(db.count("object") == objects + new_objects,
          f"15(a): objects {objects} -> {db.count('object')}, want +{new_objects} (the .sdenc)")
    jobs = _jobs_since(db, since)
    bad = [(j["name"], j["status"], j["errors"]) for j in jobs if j["status"] != 2]
    check(not bad, f"15(a): jobs that did not complete: {bad}")

    # keys.* through the router, at the standard Argon2id profile
    t0 = time.perf_counter()
    await r.exec(node, "keys.unlock", {"password": REPLICA_PASSWORD}, library_id=lid)
    await r.exec(node, "keys.add", {"automount": True}, library_id=lid)
    st = await r.exec(node, "keys.state", library_id=lid)
    check(st["unlocked"] and len(st["keys"]) == 1 and st["keys"][0]["mounted"],
          f"15(a): keys.state after unlock and add: {st}")
    try:
        await r.exec(node, "keys.unlock", {"password": "wrong"}, library_id=lid)
        check(False, "15(a): keys.unlock took a wrong password")
    except RspcError:
        pass
    st = await r.exec(node, "keys.state", library_id=lid)
    check(st["unlocked"] and all(k["mounted"] for k in st["keys"]),
          f"15(a): a wrong-password retry changed the vault: {st}")
    check(await r.exec(node, "keys.unlock", {"password": REPLICA_PASSWORD}, library_id=lid)
          is not None, "15(a): the true password no longer unlocks")
    steps["keys_s"] = time.perf_counter() - t0
    print(f"phase 15(a): {len(chosen)} files encrypted, indexed through the watcher (K1 "
          f"{launches['encrypt']} launches), moved and decrypted (K1 {launches['decrypt']}): "
          f"every copy's cas_id and object are its original's; keys.* through the router",
          flush=True)
    return {"files": len(chosen), "launches": launches, "steps_s": steps,
            "job_s": _job_seconds(jobs), "new_objects": new_objects}


def _join_library(joiner, owner_lib):
    """The joiner's library as JAX's p2p/pairing.py:132-200 writes it
    (pairing itself is plane 6.7b): a DB under the owner's library id
    holding this node's instance row and the owner's instance rows, the
    config file, the Library on the node. The owner registers the
    joiner's instance row and a 0 watermark for it."""
    from spacedrive_tpu_torch.db import LibraryDb
    from spacedrive_tpu_torch.db.database import new_pub_id
    from spacedrive_tpu_torch.location.indexer.rules import seed_rules
    from spacedrive_tpu_torch.node.library import Library, LibraryConfig, _config_vm, _platform_int
    from spacedrive_tpu_torch.sync.hlc import NTP64

    libraries = joiner.libraries
    db = LibraryDb(libraries._db_path(owner_lib.id))
    me = {"pub_id": new_pub_id(), "identity": joiner.identity.to_remote_identity().to_bytes(),
          "node_id": joiner.id.bytes, "node_name": joiner.config.config.name,
          "node_platform": _platform_int()}
    instance_id = db.insert("instance", **me, last_seen=_now_iso(), date_created=_now_iso())
    for inst in owner_lib.db.find("instance"):
        db.insert("instance", pub_id=inst["pub_id"], identity=inst["identity"] or b"",
                  node_id=inst["node_id"] or b"", node_name=inst["node_name"] or "",
                  node_platform=inst["node_platform"] or 0, last_seen=_now_iso(),
                  date_created=inst["date_created"] or _now_iso())
    config = LibraryConfig(name=owner_lib.config.name, description=owner_lib.config.description,
                           instance_id=instance_id)
    _config_vm.save(libraries._config_path(owner_lib.id), config.to_dict())
    lib = Library(owner_lib.id, config, db, uuid.UUID(bytes=me["pub_id"]), node=joiner)
    libraries.libraries[lib.id] = lib
    seed_rules(db)
    owner_lib.db.insert("instance", **me, last_seen=_now_iso(), date_created=_now_iso())
    owner_lib.sync.timestamps.setdefault(lib.sync.instance, NTP64(0))
    return lib


def _loopback(src_sync):
    """tests/test_sync_ingest.py's loopback transport over one peer's
    `get_ops`: (ops, has_more)."""
    async def request_ops(timestamps, count):
        ops = src_sync.get_ops(count=count, clocks=timestamps)
        return ops, len(ops) == count
    return request_ops


async def _semantic_hits(node, lid: str, query: str) -> list[tuple[str, float]]:
    """`search.semantic` through `node`'s router: (object pub_id, score)."""
    lib = node.libraries.libraries[uuid.UUID(lid)]
    res = await node.router.exec(node, "search.semantic", {"query": query, "take": 10},
                                 library_id=lid)
    check(res["resolved"], f"search.semantic did not resolve {query}")
    pubs = {}
    for fp_id, score in res["scores"].items():
        row = lib.db.query_one("SELECT o.pub_id FROM file_path fp JOIN object o "
                               "ON o.id = fp.object_id WHERE fp.id = ?", (int(fp_id),))
        pubs[row["pub_id"].hex()] = score
    return sorted(pubs.items(), key=lambda kv: -kv[1])


async def replica_join(ctx: dict, rng, tmp: str) -> dict:
    """15(b): a second Node joins the library by its op log."""
    import asyncio

    from spacedrive_tpu_torch.location.indexer.job import IndexerJob
    from spacedrive_tpu_torch.location.locations import update_location_size
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.object.orphan_remover import process_clean_up_async
    from spacedrive_tpu_torch.object.search.index import on_embeddings_applied
    from spacedrive_tpu_torch.ops import blake3_cuda, embed_torch
    from spacedrive_tpu_torch.sync.ingest import OPS_PER_REQUEST, IngestActor, backfill_operations
    from spacedrive_tpu_torch.telemetry import counter_value

    owner, lib, corpus = ctx["node"], ctx["lib"], ctx["corpus"]
    db, lid = lib.db, ctx["lid"]
    steps: dict[str, float] = {}
    t0 = time.perf_counter()
    backfilled = await asyncio.to_thread(backfill_operations, lib.sync)
    steps["backfill_s"] = time.perf_counter() - t0
    by_model = {x["model"]: x["n"] for x in db.query(
        "SELECT model, COUNT(*) AS n FROM crdt_operation GROUP BY model ORDER BY model")}
    n_ops = sum(by_model.values())

    async def derive(library) -> int:
        """What a replica derives from its rows and no op carries: the
        orphan clean-up (objects whose last file_path went) and the
        directory and location sizes (the indexer's roll-up at the end
        of a scan). Returns the orphans removed."""
        removed = await process_clean_up_async(library.db)
        for x in library.db.find("location"):
            IndexerJob._rollup_directory_sizes(library, x["id"])
            update_location_size(library, x["id"])
        return removed

    embeds = {"chunks": 0}
    embed_chunk = embed_torch._embed_chunk

    def counted(*a, **k):
        embeds["chunks"] += 1
        return embed_chunk(*a, **k)

    t0 = time.perf_counter()
    joiner = Node(os.path.join(tmp, "p15_joiner"), device=DEVICE, with_labeler=False)
    joiner.config.config.p2p.enabled = False
    await joiner.start()
    try:
        jlib = _join_library(joiner, lib)
        await joiner._init_library(jlib)
        steps["join_s"] = time.perf_counter() - t0
        for a, b in ((db, jlib.db), (jlib.db, db)):
            check({x["pub_id"] for x in b.find("instance")} <= {x["pub_id"] for x in a.find("instance")},
                  "15(b): an instance lacks the other's instance row")
        actor = IngestActor(jlib.sync, _loopback(lib.sync), ops_per_request=OPS_PER_REQUEST,
                            on_applied=lambda: on_embeddings_applied(jlib))
        jlib.ingest = actor
        # the joiner's orphan remover waits for the whole log: its tick
        # would drop an object whose file_path link has not arrived yet
        await jlib.orphan_remover.stop()
        combined0 = counter_value("sd_sync_txn_combined_total")
        blake3_cuda.chunk_cvs.launches = 0
        embed_torch._embed_chunk = counted
        try:
            t0 = time.perf_counter()
            actor.notify()
            await actor.wait_idle()
            steps["pull_s"] = time.perf_counter() - t0
            applied, rejected = actor.applied, actor.rejected
            t0 = time.perf_counter()
            actor.notify()
            await actor.wait_idle()
            steps["second_pull_s"] = time.perf_counter() - t0
            check(actor.applied == applied, f"15(b): a second pull applied {actor.applied - applied} ops")
            join_launches = blake3_cuda.chunk_cvs.launches
        finally:
            embed_torch._embed_chunk = embed_chunk
        combined = counter_value("sd_sync_txn_combined_total") - combined0
        rate = applied / steps["pull_s"] if steps["pull_s"] else 0.0
        print(f"phase 15(b): the joiner applied {applied} of {n_ops} ops ({rejected} rejected) "
              f"in {steps['pull_s']:.2f} s, {rate:.0f} ops/s, {combined:.0f} transactions "
              f"combined; steps {json.dumps(steps)}", flush=True)
        check(join_launches == 0, f"15(b): the join launched K1 {join_launches} times")
        check(embeds["chunks"] == 0, f"15(b): the join ran the embedder {embeds['chunks']} times")
        t0 = time.perf_counter()
        orphans = {"owner": await derive(lib), "joiner": await derive(jlib)}
        jlib.orphan_remover.start()
        steps["derive_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fields = _synced_fields(db)
        rows = _check_views_equal(_sync_view(db, fields), _sync_view(jlib.db, fields),
                                  "15(b) after the pull")
        steps["compare_s"] = time.perf_counter() - t0

        # search.semantic on both sides, the joiner on its card
        images = sorted((x for x in db.query(
            "SELECT fp.* FROM file_path fp JOIN object_embedding e ON e.object_id = fp.object_id "
            "WHERE fp.location_id = ? AND fp.extension IN ('jpg', 'png')", (ctx["loc"]["id"],))
            if os.path.exists(_row_path(corpus, x))), key=lambda x: x["id"])
        check(len(images) >= REPLICA_QUERIES, f"15(b): {len(images)} embedded images")
        t0 = time.perf_counter()
        worst = 0.0
        for i in rng.choice(len(images), REPLICA_QUERIES, replace=False):
            q = _row_path(corpus, images[int(i)])
            want, got = await _semantic_hits(owner, lid, q), await _semantic_hits(joiner, lid, q)
            if dict(got).keys() != dict(want).keys():
                check(False, f"15(b): search.semantic of {q}: the joiner's hits {got} differ "
                      f"from the owner's {want}")
                continue
            for (pw, sw), (pg, sg) in zip(want, got):
                worst = max(worst, abs(sw - sg), abs(sw - dict(got)[pw]))
                check(pw == pg or abs(sw - sg) <= REPLICA_SCORE_TOL,
                      f"15(b): search.semantic of {q}: rank order differs beyond a tie")
        check(worst <= REPLICA_SCORE_TOL, f"15(b): search.semantic scores differ by {worst}")
        steps["search_s"] = time.perf_counter() - t0

        # the joiner writes; the owner pulls those ops back
        t0 = time.perf_counter()
        jr = joiner.router
        tag = await jr.exec(joiner, "tags.create", {"name": "replica", "color": "#2a9d8f"},
                            library_id=lid)
        objs = sorted(x["id"] for x in jlib.db.query("SELECT id FROM object"))
        picked = [objs[int(i)] for i in rng.choice(len(objs), REPLICA_TAGGED, replace=False)]
        await jr.exec(joiner, "tags.assign", {"tag_id": tag, "object_ids": picked}, library_id=lid)
        fp = jlib.db.query_one("SELECT id, object_id FROM file_path WHERE object_id = ?", (picked[0],))
        await jr.exec(joiner, "files.setNote", {"id": fp["id"], "note": "written on the replica"},
                      library_id=lid)
        back = IngestActor(lib.sync, _loopback(jlib.sync), on_applied=lambda: on_embeddings_applied(lib))
        lib.ingest = back
        back.notify()
        await back.wait_idle()
        steps["write_back_s"] = time.perf_counter() - t0
        check(back.applied >= 2 + REPLICA_TAGGED + 1,
              f"15(b): the owner applied {back.applied} of the joiner's ops")
        # the joiner's log relays the owner's own ops too, written since
        # the owner's node loaded the library: the owner applies them
        # again (as JAX's does), so it derives its local state again
        t0 = time.perf_counter()
        orphans["owner_after_write_back"] = await derive(lib)
        steps["derive_again_s"] = time.perf_counter() - t0
        fields = _synced_fields(db)
        rows = _check_views_equal(_sync_view(db, fields), _sync_view(jlib.db, fields),
                                  "15(b) after the write-back")
        tagged = db.query_one("SELECT COUNT(*) AS n FROM tag_on_object t JOIN tag g ON g.id = t.tag_id "
                              "WHERE g.name = 'replica'")["n"]
        check(tagged == REPLICA_TAGGED, f"15(b): the owner holds {tagged} tagged objects")
    finally:
        await joiner.shutdown()
    print(f"phase 15(b): a second Node joined the library: {applied} of {n_ops} ops applied in "
          f"{steps['pull_s']:.2f} s ({rate:.0f} ops/s, {combined:.0f} transactions combined), every "
          f"synced model equal, a second pull applied 0, K1 0 and the embedder 0 on the joiner; "
          f"search.semantic equal; the joiner's tag and note came back", flush=True)
    unsynced = {m: sorted(set(_table_columns(db, m)) - fields.get(m, set()))
                for m in rows}
    return {"ops": n_ops, "ops_by_model": by_model, "backfilled": backfilled, "applied": applied,
            "rejected": rejected, "ops_per_s": rate, "txn_combined": combined, "rows": rows,
            "orphans_removed": orphans, "columns_no_op_carries": unsynced,
            "write_back_ops": back.applied, "launches": join_launches,
            "embed_chunks": embeds["chunks"], "search_worst_score_diff": worst, "steps_s": steps}


def phase_replica(rng, tmp: str):
    """Phase 15, run by phase 14 on its Node (`phase_live(then=...)`):
    (a) the crypto jobs through the live location, where the host has
    `cryptography`; (b) a second Node joins the library by its op log."""
    import importlib.util

    async def run(ctx: dict) -> dict:
        t_phase = time.perf_counter()
        since = degradation()
        out: dict = {}
        if importlib.util.find_spec("cryptography") is None:
            out["crypto"] = {"skipped": "no cryptography on this host"}
        else:
            out["crypto"] = await replica_crypto(ctx, rng)
        out["join"] = await replica_join(ctx, rng, tmp)
        out["seconds"] = time.perf_counter() - t_phase
        out["since"] = since
        return out

    return run


def report_replica(got: dict) -> dict:
    check_healthy("15", got.pop("since"))
    crypto, join = got["crypto"], got["join"]
    launches = {"replica_crypto": sum(crypto.get("launches", {}).values()),
                "replica_join": join["launches"]}
    print(json.dumps({"replica": {**got, "k1_launches": launches}}), flush=True)
    print(f"phase 15: the replica in {got['seconds']:.1f} s", flush=True)
    return {"launches": launches}


# --- phase 16: the p2p transport ----------------------------------------------------

P2P_SEND_BYTES = 32 << 20  # (a): at least this much of phase 3's files
P2P_PUNCH_BYTES = 8 << 20  # (b): over the punched path, and again over the splice
P2P_WAIT_S = 60  # the bound on one step of the phase


def p2p_files(snapshot: str) -> list[str]:
    """(a)'s files from phase 3's snapshot: the largest first until
    P2P_SEND_BYTES (PNGs of up to ~3 MB), the 4 largest `.bin` files
    over 100 KiB (the cas_id's sampled read) and 8 under 100 KiB (the
    whole-file message), in sorted order."""
    from spacedrive_tpu_torch.ops import cas

    sized = sorted(((os.path.getsize(os.path.join(d, f)), os.path.join(d, f))
                    for d, _, fs in os.walk(snapshot) for f in fs), reverse=True)
    picked, total = [], 0
    for size, path in sized:
        if total >= P2P_SEND_BYTES:
            break
        picked.append(path)
        total += size
    bins = [p for s, p in sized if p.endswith(".bin") and s > cas.MINIMUM_FILE_SIZE]
    small = [p for s, p in sized if 1024 < s <= cas.MINIMUM_FILE_SIZE]
    picked += [p for p in bins if p not in picked][:4] + small[::max(1, len(small) // 8)][:8]
    return sorted(set(picked))


def unicast_beacons(discovery, p2ps, ports) -> list:
    """Discovery backends for two P2Ps that beacon to each other on
    127.0.0.1 (multicast may be closed on the host), on free UDP ports
    taken before either starts."""
    import socket

    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in p2ps]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        udp = [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()
    return [discovery(p, port, bind_port=udp[i], interval=0.05, expiry=5.0,
                      beacon_addrs=[("127.0.0.1", udp[1 - i])])
            for i, (p, port) in enumerate(zip(p2ps, ports))]


async def p2p_spacedrop(tmp: str, paths: list[str], want: list[str]) -> dict:
    """16(a): two P2Ps find each other by unicast beacons on 127.0.0.1;
    one opens a stream to the other with a SPACEDROP header that carries
    its trace, and sends `paths` by Spaceblock over Noise; the receiver,
    under the sender's trace, hashes what it received on the card, and
    its cas_ids must be `want`."""
    import asyncio

    from spacedrive_tpu_torch import telemetry
    from spacedrive_tpu_torch.ops import cas
    from spacedrive_tpu_torch.p2p import (
        P2P, BlockSize, Header, HeaderType, Identity, SpaceblockRequest, SpaceblockRequests,
        Transfer,
    )
    from spacedrive_tpu_torch.p2p.mdns import MdnsDiscovery
    from spacedrive_tpu_torch.telemetry import trace

    steps: dict[str, float] = {}
    recv_dir = os.path.join(tmp, "p2p_received")
    os.makedirs(recv_dir)
    got: dict = {}
    done = asyncio.Event()

    async def handler(stream) -> None:
        try:
            header = await Header.read(stream)
            check(header.type == HeaderType.SPACEDROP, f"16(a): header {header.type!r}")
            with trace.use(trace.TraceContext.from_wire(header.trace)):
                with telemetry.span("p2p.spacedrop_receive") as sp:
                    sinks = [open(os.path.join(recv_dir, f"{i:03d}_{os.path.basename(r.name)}"),
                                  "wb") for i, r in enumerate(header.spacedrop.requests)]
                    try:
                        await Transfer(header.spacedrop).receive(stream, sinks)
                    finally:
                        for f in sinks:
                            f.close()
                    t0 = time.perf_counter()
                    # off the loop, so the sender's last ack is read on time
                    got["cas"] = await asyncio.to_thread(
                        lambda: cas.cas_ids([cas.read_message(f.name) for f in sinks], DEVICE))
                    got["cas_s"] = time.perf_counter() - t0
            got["trace_id"], got["sizes"] = sp.trace_id, [os.path.getsize(f.name) for f in sinks]
        except Exception as exc:  # surfaced by the sender below
            got["error"] = exc
        finally:
            done.set()

    sender, receiver = P2P("sd-smoke", Identity()), P2P("sd-smoke", Identity())
    receiver.set_stream_handler(handler)
    try:
        t0 = time.perf_counter()
        ports = [await p.listen(host="127.0.0.1") for p in (sender, receiver)]
        beacons = unicast_beacons(MdnsDiscovery, (sender, receiver), ports)
        for d in beacons:
            await d.start()
        async with asyncio.timeout(P2P_WAIT_S):
            while not (sender.discovered_peers() and receiver.discovered_peers()):
                await asyncio.sleep(0.01)
        check([p.identity for p in sender.discovered_peers()] == [receiver.remote_identity],
              "16(a): the sender discovered the receiver alone")
        steps["discovery_s"] = time.perf_counter() - t0

        sizes = [os.path.getsize(p) for p in paths]
        reqs = SpaceblockRequests(
            # the block size of a spacedrop (JAX p2p/operations.py:112)
            id=uuid.UUID(int=16), block_size=BlockSize.from_file_size(max(sizes)),
            requests=[SpaceblockRequest(name=os.path.basename(p), size=s)
                      for p, s in zip(paths, sizes)])
        ctx = trace.new_context()
        t0 = time.perf_counter()
        stream = await sender.new_stream(receiver.remote_identity)
        files = [open(p, "rb") for p in paths]
        try:
            with trace.use(ctx):
                await Header(HeaderType.SPACEDROP, spacedrop=reqs,
                             trace=trace.wire_current()).write(stream)
            await Transfer(reqs).send(stream, files)
            steps["send_s"] = time.perf_counter() - t0
            async with asyncio.timeout(P2P_WAIT_S):
                await done.wait()
        finally:
            for f in files:
                f.close()
            await stream.close()
        steps["received_and_hashed_s"] = time.perf_counter() - t0
    finally:
        for p in (sender, receiver):
            await p.shutdown()
    if "error" in got:
        raise SmokeFailure(f"16(a): the receiver failed: {got['error']!r}") from got["error"]
    check(got["sizes"] == sizes, "16(a): received sizes")
    for i, path in enumerate(paths):
        with open(path, "rb") as f, open(os.path.join(
                recv_dir, f"{i:03d}_{os.path.basename(path)}"), "rb") as g:
            check(f.read() == g.read(), f"16(a): the received bytes of {path}")
    bad = [p for p, g, w in zip(paths, got["cas"], want) if g != w]
    check(not bad, f"16(a): card cas_ids differ from cas_id_cpu for {len(bad)} files: {bad[:4]}")
    check(got["trace_id"] == ctx.trace_id, "16(a): the receiver's span is not in the sender's trace")
    return {"files": len(paths), "bytes": sum(sizes), "over_100k": sum(
        s > cas.MINIMUM_FILE_SIZE for s in sizes), "block_size": reqs.block_size.size,
        "mb_per_s": sum(sizes) / 1e6 / steps["send_s"], "card_cas_s": got["cas_s"],
        "steps_s": steps}


async def p2p_punched(rng) -> dict:
    """16(b): a local RelayServer introduces two RelayClients; P2P_PUNCH_BYTES
    go over the hole-punched UDP stream and again over the relay's
    splice from a third client with punching off. The receiver returns
    the BLAKE3 of what it read (host C hasher)."""
    import asyncio

    from spacedrive_tpu_torch.ops.blake3_host import blake3_digest
    from spacedrive_tpu_torch.p2p import P2P, Identity
    from spacedrive_tpu_torch.p2p.relay import RelayClient, RelayServer

    payload = rng.bytes(P2P_PUNCH_BYTES)
    want = blake3_digest(payload)

    async def on_stream(stream) -> None:
        data = await stream.read_exact(P2P_PUNCH_BYTES)
        await stream.write(blake3_digest(data))
        try:  # hold the stream until the dialer closes it
            await stream.read_exact(1)
        except asyncio.IncompleteReadError:
            pass

    srv = RelayServer()
    port = await srv.start()
    peers = [P2P("sd-smoke", Identity()) for _ in range(3)]
    clients = [RelayClient(p, ("127.0.0.1", port), on_stream, query_interval=0.1, punch=punch)
               for p, punch in zip(peers, (True, True, False))]
    out: dict = {}
    try:
        for c in clients:
            await c.start()
        target = peers[1].remote_identity
        async with asyncio.timeout(P2P_WAIT_S):
            while not all(c._ctrl and c._relay_udp for c in clients) or not all(
                    target in p.peers and p.peers[target].relayed for p in (peers[0], peers[2])):
                await asyncio.sleep(0.01)
        for name, p in (("punched", peers[0]), ("spliced", peers[2])):
            t0 = time.perf_counter()
            stream = await p.new_stream(target, timeout=20)
            dial_s = time.perf_counter() - t0
            check(bool(getattr(stream, "direct", False)) == (name == "punched"),
                  f"16(b): the {name} stream took the other path")
            t0 = time.perf_counter()
            try:
                await stream.write(payload)
                async with asyncio.timeout(P2P_WAIT_S):
                    digest = await stream.read_exact(32)
            finally:
                await stream.close()
            seconds = time.perf_counter() - t0
            check(digest == want, f"16(b): BLAKE3 of the {name} bytes differs")
            out[name] = {"dial_s": dial_s, "seconds": seconds,
                         "mb_per_s": P2P_PUNCH_BYTES / 1e6 / seconds}
        check(clients[0].punch_stats["direct"] == 1 and clients[1].punch_stats["accepted"] == 1,
              f"16(b): punch stats {clients[0].punch_stats} {clients[1].punch_stats}")
        check(srv.stats.pipes_opened == 1 and srv.stats.bytes_relayed > P2P_PUNCH_BYTES,
              f"16(b): the relay spliced {srv.stats.snapshot()}")
        out["relay"] = srv.stats.snapshot()
    finally:
        for c in clients:
            await c.shutdown()
        for p in peers:
            await p.shutdown()
        await srv.shutdown()
    return out


async def p2p_faults() -> dict:
    """16(c): `p2p.connect:reset:times=1` fails one dial with a
    ConnectionResetError and the next dial opens; `p2p.write:reset:times=1`
    fails the first write on a punched stream with UdpStreamError,
    poisons its reader and puts `stream_failed` on the `p2p` ring."""
    import asyncio

    from spacedrive_tpu_torch.p2p import P2P, Identity
    from spacedrive_tpu_torch.p2p.mdns import MdnsDiscovery
    from spacedrive_tpu_torch.p2p.relay import RelayClient, RelayServer
    from spacedrive_tpu_torch.p2p.udpstream import UdpStreamError
    from spacedrive_tpu_torch.telemetry.events import P2P_EVENTS
    from spacedrive_tpu_torch.utils import faults

    released = asyncio.Event()

    async def on_stream(stream) -> None:
        await released.wait()

    a, b = P2P("sd-smoke", Identity()), P2P("sd-smoke", Identity())
    b.set_stream_handler(on_stream)
    srv = RelayServer()
    port = await srv.start()
    clients = [RelayClient(p, ("127.0.0.1", port), on_stream, query_interval=0.1) for p in (a, b)]
    out: dict = {}
    try:
        ports = [await p.listen(host="127.0.0.1") for p in (a, b)]
        for d in unicast_beacons(MdnsDiscovery, (a, b), ports):
            await d.start()
        for c in clients:
            await c.start()
        async with asyncio.timeout(P2P_WAIT_S):
            while not (a.discovered_peers() and all(c._ctrl and c._relay_udp for c in clients)):
                await asyncio.sleep(0.01)
        with faults.active(faults.FaultPlan.parse("p2p.connect:reset:times=1")) as plan:
            try:
                await a.new_stream(b.remote_identity)
                check(False, "16(c): p2p.connect:reset did not fail the dial")
            except ConnectionResetError:
                pass
            stream = await a.new_stream(b.remote_identity)
            await stream.close()
            out["connect"] = plan.activations()
        stream = await clients[0].punch_dial(b.remote_identity)
        failed_before = sum(e["type"] == "stream_failed" for e in P2P_EVENTS.snapshot())
        try:
            with faults.active(faults.FaultPlan.parse("p2p.write:reset:times=1")) as plan:
                try:
                    await stream.write(b"x" * 4096)
                    check(False, "16(c): p2p.write:reset did not fail the write")
                except UdpStreamError:
                    pass
                out["write"] = plan.activations()
            try:
                await stream.read_exact(1)
                check(False, "16(c): the failed stream's reader still reads")
            except UdpStreamError:
                pass
        finally:
            await stream.close()
        out["stream_failed_events"] = sum(
            e["type"] == "stream_failed" for e in P2P_EVENTS.snapshot()) - failed_before
        # the accepting side closes its end; its FIN goes unanswered (the
        # failed stream shut its socket), and shutting its relay client
        # down cancels that wait
        released.set()
        await asyncio.sleep(0.05)
    finally:
        for c in clients:
            await c.shutdown()
        for p in (a, b):
            await p.shutdown()
        await srv.shutdown()
    check(out["connect"] == {"p2p.connect": 1} and out["write"] == {"p2p.write": 1}
          and out["stream_failed_events"] == 1, f"16(c): {out}")
    return out


def phase_p2p(rng, tmp: str, snapshot: str) -> dict:
    """Phase 16: the p2p transport on its own P2P instances on 127.0.0.1
    (no Node): (a) discovery and a Spaceblock over Noise TCP, hashed on
    the card by the receiver; (b) a hole-punched UDP stream and the
    relay's splice; (c) the `p2p.connect` and `p2p.write` fault points."""
    import asyncio

    from spacedrive_tpu_torch.ops import blake3_cuda, cas
    from spacedrive_tpu_torch.parallel import autotune, mesh

    t_phase = time.perf_counter()
    mesh.LADDER.reset()
    autotune.reset()
    since = degradation()
    paths = p2p_files(snapshot)
    t0 = time.perf_counter()
    want = [cas.cas_id_cpu(p) for p in paths]  # the sender's host path, before it sends
    expected_s = time.perf_counter() - t0
    blake3_cuda.chunk_cvs.launches = 0
    spacedrop = asyncio.run(p2p_spacedrop(tmp, paths, want))
    launches = blake3_cuda.chunk_cvs.launches
    spacedrop["steps_s"]["expected_cas_s"] = expected_s
    punched = asyncio.run(p2p_punched(rng))
    check_healthy("16", since)
    clean = degradation()
    fault_points = asyncio.run(p2p_faults())
    moved = {k: v - clean[k] for k, v in degradation().items() if not k.startswith("demotion")}
    check(moved == {**{k: 0 for k in moved}, "fault_activations": 2},
          f"16(c): degradation counters moved {moved}")
    return {"spacedrop": spacedrop, "punched": punched, "faults": fault_points,
            "launches": launches, "seconds": time.perf_counter() - t_phase}


def report_p2p(got: dict) -> dict:
    check(got["launches"] > 0, "16(a): the receiver's cas_ids launched K1 no time")
    print(json.dumps({"p2p": got}), flush=True)
    print(f"phase 16: the p2p transport in {got['seconds']:.1f} s: (a) "
          f"{got['spacedrop']['mb_per_s']:.1f} MB/s over Noise TCP, (b) "
          f"{got['punched']['punched']['mb_per_s']:.1f} MB/s punched, "
          f"{got['punched']['spliced']['mb_per_s']:.1f} MB/s spliced", flush=True)
    return {"launches": {"p2p_transfer": got["launches"]}}


# --- phase 17: the node's p2p ---------------------------------------------------------

P2P_NODE_FILES = 80  # (a) and (b): every n-th of phase 3's files, 64 then 16
P2P_NODE_DROP_BYTES = 8 << 20  # (c): at least this much of A's files


class _K1Owners:
    """K1's CUDA launches by the Node whose FileIdentifierJob window or
    mesh identify shard made them (its config name), "other" for any
    launch outside both: the wrapper of `chunk_cvs` reads a thread-local
    owner that wrappers of `FileIdentifierJob._fetch_window` and
    `location/indexer/mesh._execute_shard_sync` set around the window
    or shard they run."""

    def __init__(self):
        import threading

        self.by = collections.Counter()
        self._local = threading.local()

    def __enter__(self):
        from spacedrive_tpu_torch.location.indexer import mesh
        from spacedrive_tpu_torch.object.file_identifier.job import FileIdentifierJob
        from spacedrive_tpu_torch.ops import blake3_cuda

        chunk_cvs, fetch = blake3_cuda.chunk_cvs, FileIdentifierJob._fetch_window
        shard = mesh._execute_shard_sync
        local, by = self._local, self.by

        def counted(words, *a, **k):
            if words.is_cuda:
                by[getattr(local, "owner", None) or "other"] += 1
            return chunk_cvs(words, *a, **k)

        def owned(job, library, *a, **k):
            local.owner = library.node.config.config.name
            try:
                return fetch(job, library, *a, **k)
            finally:
                local.owner = None

        def owned_shard(library, *a, **k):
            local.owner = library.node.config.config.name
            try:
                return shard(library, *a, **k)
            finally:
                local.owner = None

        # the kernel's wrapper counts its launches on the module's
        # `chunk_cvs`, this wrapper while it is in place
        counted.launches = chunk_cvs.launches
        self._saved = (blake3_cuda, chunk_cvs, FileIdentifierJob, fetch, mesh, shard)
        blake3_cuda.chunk_cvs, FileIdentifierJob._fetch_window = counted, owned
        mesh._execute_shard_sync = owned_shard
        return self

    def __exit__(self, *exc):
        blake3_cuda, chunk_cvs, job_cls, fetch, mesh, shard = self._saved
        chunk_cvs.launches = blake3_cuda.chunk_cvs.launches
        blake3_cuda.chunk_cvs, job_cls._fetch_window = chunk_cvs, fetch
        mesh._execute_shard_sync = shard

    def take(self) -> dict:
        out = dict(self.by)
        self.by.clear()
        return out


async def node_p2p(tmp: str, snapshot: str, since: dict) -> dict:
    """17(a)-(d) on two port Nodes on the card, their managers on
    127.0.0.1 with unicast beacons, every stream Noise over TCP; `since`
    is the degradation counters before the phase."""
    import asyncio

    from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.p2p.manager import P2PManager
    from spacedrive_tpu_torch.telemetry import trace
    from spacedrive_tpu_torch.telemetry.events import RESILIENCE_EVENTS
    from spacedrive_tpu_torch.utils import faults

    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(snapshot) for f in fs)
    picked = files[::len(files) // P2P_NODE_FILES][:P2P_NODE_FILES]
    more = picked[4::5]
    first = [f for f in picked if f not in more]
    loc_dir = os.path.join(tmp, "p17_a_location")
    os.makedirs(loc_dir)

    def link(paths) -> None:
        for path in paths:
            os.link(path, os.path.join(loc_dir, f"{picked.index(path):03d}_{os.path.basename(path)}"))

    steps: dict[str, float] = {}
    out: dict = {"steps_s": steps}
    t0 = time.perf_counter()
    nodes = []
    for name in ("p17-a", "p17-b"):
        node = Node(os.path.join(tmp, name), device=DEVICE, with_labeler=False)
        node.config.config.p2p.enabled = False  # the manager is attached below
        node.config.config.name = name
        await node.start()
        node.p2p = P2PManager(node, beacon_addrs=[("127.0.0.1", 1)], bind_host="127.0.0.1")
        nodes.append(node)
    a, b = nodes
    owners = _K1Owners()
    try:
        with owners:
            for n in nodes:
                await n.p2p.start()
            da, db_ = (n.p2p.p2p._discovery[0] for n in nodes)
            da.beacon_addrs, db_.beacon_addrs = [("127.0.0.1", db_.bind_port)], [("127.0.0.1", da.bind_port)]
            da.interval = db_.interval = 0.05
            async with asyncio.timeout(P2P_WAIT_S):
                while not (a.p2p.p2p.discovered_peers() and b.p2p.p2p.discovered_peers()):
                    await asyncio.sleep(0.01)
            steps["start_s"] = time.perf_counter() - t0

            # (a) A indexes 64 files through K1; B joins A's library
            t0 = time.perf_counter()
            lid = (await a.router.exec(a, "library.create", {"name": "p17"}))["uuid"]
            lib_a = a.libraries.get(uuid.UUID(lid))
            link(first)
            loc = LocationCreateArgs(path=loc_dir).create(lib_a)
            await scan_location(lib_a, loc, a.jobs, backend=DEVICE)
            await a.jobs.wait_idle()
            steps["a_index_s"] = time.perf_counter() - t0
            out["a_index_launches"] = owners.take()
            check(out["a_index_launches"].get("p17-a", 0) > 0 and set(out["a_index_launches"])
                  == {"p17-a"}, f"17(a): A's index launched K1 {out['a_index_launches']}")

            offers = []
            a.event_bus.on(lambda ev: offers.append(ev[1]) if isinstance(ev, tuple) and ev
                           and ev[0] == "PairingRequest" else None)

            async def consent():
                while not offers:
                    await asyncio.sleep(0.01)
                await a.router.exec(a, "p2p.acceptPairing", str(offers[0].id))

            def views() -> tuple[dict, dict, dict]:
                """A's and B's rows that A's op log carries, on the fields
                its ops carry, and the count of A's rows no op carries by
                model (the media job writes media_data without an op, as
                JAX's does: a replica gets those rows only from the
                owner's backfill at the join)."""
                fields, carried = _synced_fields(lib_a.db), _carried_ids(lib_a.db)
                a_view, b_view = _sync_view(lib_a.db, fields), _sync_view(lib_b.db, fields)
                keep = {m: {k: r for k, r in rows.items() if k in carried[m]}
                        for m, rows in a_view.items()}
                return (keep, {m: {k: r for k, r in rows.items() if k in carried[m]}
                               for m, rows in b_view.items()},
                        {m: len(a_view[m]) - len(keep[m]) for m in a_view
                         if len(a_view[m]) != len(keep[m])})

            async def converged(what: str) -> dict:
                """B's rows once they equal A's as `views` gives them; past
                P2P_WAIT_S the check names the rows that differ."""
                try:
                    async with asyncio.timeout(P2P_WAIT_S):
                        while (got := views())[0] != got[1]:
                            await asyncio.sleep(0.02)
                except TimeoutError:
                    pass
                a_rows, b_rows, uncarried = views()
                check(set(uncarried) <= {"media_data"}, f"{what}: rows no op carries {uncarried}")
                return {"rows": _check_views_equal(a_rows, b_rows, what), "uncarried": uncarried}

            t0 = time.perf_counter()
            async with asyncio.timeout(P2P_WAIT_S):
                joined, _ = await asyncio.gather(
                    b.router.exec(b, "p2p.pairLibrary",
                                  {"identity": str(a.p2p.p2p.remote_identity), "library_id": lid}),
                    consent())
                check(joined == lid, f"17(a): B joined {joined}, not {lid}")
            lib_b = b.libraries.get(uuid.UUID(lid))
            out["rows_a"] = await converged("17(a) after the join")
            steps["join_s"] = time.perf_counter() - t0
            n_ops = lib_a.db.count("crdt_operation")
            out["join_ops"] = n_ops
            out["join_ops_per_s"] = n_ops / steps["join_s"]
            out["join_launches"] = owners.take()
            check(not out["join_launches"], f"17(a): the join launched K1 {out['join_launches']}")

            # (b) A indexes 16 more; B converges by the SYNC alert and pull alone
            t0 = time.perf_counter()
            link(more)
            await scan_location(lib_a, loc, a.jobs, backend=DEVICE)
            await a.jobs.wait_idle()
            steps["a_index_more_s"] = time.perf_counter() - t0
            out["rows_b"] = await converged("17(b) after A's second scan")
            steps["sync_s"] = time.perf_counter() - t0
            out["sync_launches"] = owners.take()
            check(set(out["sync_launches"]) == {"p17-a"},
                  f"17(b): K1 launched {out['sync_launches']} (A's scan alone may)")
            check(lib_b.db.count("file_path", "is_dir = 0") == len(picked),
                  f"17(b): B holds {lib_b.db.count('file_path', 'is_dir = 0')} files")

            # (c) A spacedrops >= 8 MiB to B; B indexes what it received on the card
            rows_a = {(r["name"], r["extension"]): r["cas_id"] for r in lib_a.db.query(
                "SELECT name, extension, cas_id FROM file_path WHERE is_dir = 0")}
            by_size = sorted((os.path.getsize(os.path.join(loc_dir, f)), f)
                             for f in os.listdir(loc_dir))
            drop, total = [], 0
            for size, f in reversed(by_size):
                if total >= P2P_NODE_DROP_BYTES:
                    break
                drop.append(os.path.join(loc_dir, f))
                total += size
            drop += [os.path.join(loc_dir, f) for size, f in by_size if 1024 < size <= 100 * 1024][:4]
            dest = os.path.join(tmp, "p17_b_inbox")
            drops = []
            b.event_bus.on(lambda ev: drops.append(ev[1]) if isinstance(ev, tuple) and ev
                           and ev[0] == "SpacedropRequest" else None)

            async def accept():
                while not drops:
                    await asyncio.sleep(0.01)
                await b.router.exec(b, "p2p.acceptSpacedrop", {"id": str(drops[0].id),
                                                                "target_dir": dest})

            ctx = trace.new_context()
            t0 = time.perf_counter()
            async with asyncio.timeout(P2P_WAIT_S):
                with trace.use(ctx):
                    await asyncio.gather(a.router.exec(a, "p2p.spacedrop", {
                        "identity": str(b.p2p.p2p.remote_identity), "file_paths": drop}), accept())
            steps["spacedrop_s"] = time.perf_counter() - t0
            sizes = [os.path.getsize(p) for p in drop]
            out["drop"] = {"files": len(drop), "bytes": sum(sizes), "over_100k": sum(
                s > 100 * 1024 for s in sizes), "mb_per_s": sum(sizes) / 1e6 / steps["spacedrop_s"]}
            for p in drop:
                with open(p, "rb") as f, open(os.path.join(dest, os.path.basename(p)), "rb") as g:
                    check(f.read() == g.read(), f"17(c): the received bytes of {p}")
            spans = [r for r in trace.recent(ctx.trace_id)
                     if r["stage"].endswith("p2p.spacedrop_receive")]
            check(len(spans) == 1, f"17(c): {len(spans)} receive spans in A's trace")
            t0 = time.perf_counter()
            inbox_id = (await b.router.exec(b, "library.create", {"name": "p17 inbox"}))["uuid"]
            inbox = b.libraries.get(uuid.UUID(inbox_id))
            inbox_loc = LocationCreateArgs(path=dest).create(inbox)
            await scan_location(inbox, inbox_loc, b.jobs, backend=DEVICE)
            await b.jobs.wait_idle()
            steps["b_index_s"] = time.perf_counter() - t0
            out["b_index_launches"] = owners.take()
            check(set(out["b_index_launches"]) == {"p17-b"},
                  f"17(c): B's index launched K1 {out['b_index_launches']}")
            got = {(r["name"], r["extension"]): r["cas_id"] for r in inbox.db.query(
                "SELECT name, extension, cas_id FROM file_path WHERE is_dir = 0")}
            check(len(got) == len(drop) and all(rows_a[k] == v for k, v in got.items()),
                  f"17(c): B's cas_ids differ from A's rows: "
                  f"{[k for k, v in got.items() if rows_a.get(k) != v][:4]}")

            # (d) one p2p.sync_serve activation fails B's next pull, which retries
            check_healthy("17", since)
            t0 = time.perf_counter()
            retries0 = sum(e["type"] == "retry" and e["fields"]["policy"] == "p2p_sync"
                           for e in RESILIENCE_EVENTS.snapshot())
            actor, pull = lib_b.ingest, lib_b.ingest.request_ops
            plan = faults.FaultPlan.parse("p2p.sync_serve:vanish:times=1")

            async def armed_pull(timestamps, count):
                if faults.active_plan() is None:
                    faults.install(plan)  # B's pull is the next sync leg A serves
                return await pull(timestamps, count)

            actor.request_ops = armed_pull
            try:
                await a.router.exec(a, "tags.create", {"name": "p17", "color": "#2a9d8f"},
                                    library_id=lid)
                out["rows_d"] = await converged("17(d) after the failed pull")
            finally:
                actor.request_ops = pull
                faults.install(None)
            steps["fault_s"] = time.perf_counter() - t0
            retried = [e["fields"] for e in RESILIENCE_EVENTS.snapshot()
                       if e["type"] == "retry" and e["fields"]["policy"] == "p2p_sync"][retries0:]
            out["fault"] = {"activations": plan.activations(), "retries": retried}
            check(plan.activations() == {"p2p.sync_serve": 1} and len(retried) == 1,
                  f"17(d): {out['fault']}")
            out["fault_launches"] = owners.take()
            check(not out["fault_launches"], f"17(d): K1 launched {out['fault_launches']}")
    finally:
        for n in nodes:
            await n.shutdown()
    out["launches"] = sum(sum(out[k].values()) for k in (
        "a_index_launches", "join_launches", "sync_launches", "b_index_launches", "fault_launches"))
    return out


def phase_node_p2p(tmp: str, snapshot: str) -> dict:
    """Phase 17: the node's p2p on two port Nodes on the card: (a) B pairs
    into A's library, (b) sync over the wire, (c) Spacedrop, (d) a
    failed pull that retries."""
    import asyncio

    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.parallel import autotune, mesh

    t_phase = time.perf_counter()
    mesh.LADDER.reset()
    autotune.reset()
    since = degradation()
    blake3_cuda.chunk_cvs.launches = 0
    got = asyncio.run(node_p2p(tmp, snapshot, since))
    check(blake3_cuda.chunk_cvs.launches == got["launches"],
          f"17: K1 launched {blake3_cuda.chunk_cvs.launches} times, {got['launches']} in windows")
    moved = {k: v - since[k] for k, v in degradation().items() if not k.startswith("demotion")}
    check(moved == {**{k: 0 for k in moved}, "fault_activations": 1},
          f"17(d): degradation counters moved {moved}")
    got["seconds"] = time.perf_counter() - t_phase
    return got


def report_node_p2p(got: dict) -> dict:
    print(json.dumps({"node_p2p": got}), flush=True)
    steps = got["steps_s"]
    print(f"phase 17: the node's p2p in {got['seconds']:.1f} s: (a) A indexed "
          f"{got['rows_a']['rows']['file_path']} files ({got['a_index_launches']['p17-a']} K1 "
          f"launches), "
          f"B joined "
          f"{got['join_ops']} ops in {steps['join_s']:.2f} s ({got['join_ops_per_s']:.0f} ops/s, "
          f"K1 0 on B), (b) synced in {steps['sync_s']:.2f} s, (c) spacedrop "
          f"{got['drop']['mb_per_s']:.1f} MB/s, B's cas_ids equal A's, (d) the failed pull "
          f"retried", flush=True)
    return {"launches": {"p2p_node": got["launches"]}}


# --- phase 18: cloud sync ----------------------------------------------------------------

CLOUD_FILES = 80  # (a) and (b): every n-th of phase 3's files, 64 then 16
CLOUD_WAIT_S = 60  # the bound on one step of the phase
CLOUD_FAULTS = "relay.http:500:times=1;relay.http:truncate:times=1"


async def cloud_sync(tmp: str, snapshot: str, since: dict) -> dict:
    """18(a)-(d) on two port Nodes on the card and a port relay in this
    process; `since` is the degradation counters before the phase."""
    import asyncio

    from spacedrive_tpu_torch.cloud.relay import CloudRelay
    from spacedrive_tpu_torch.location.locations import LocationCreateArgs, scan_location
    from spacedrive_tpu_torch.node.config import P2PDiscoveryState
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.p2p.manager import P2PManager
    from spacedrive_tpu_torch.sync.ingest import backfill_operations
    from spacedrive_tpu_torch.telemetry import counter_value
    from spacedrive_tpu_torch.telemetry.events import RESILIENCE_EVENTS
    from spacedrive_tpu_torch.utils import faults

    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(snapshot) for f in fs)
    picked = files[::len(files) // CLOUD_FILES][:CLOUD_FILES]
    more = picked[4::5]
    first = [f for f in picked if f not in more]
    loc_dir = os.path.join(tmp, "p18_a_location")
    os.makedirs(loc_dir)

    def link(paths) -> None:
        for path in paths:
            os.link(path, os.path.join(loc_dir, f"{picked.index(path):03d}_{os.path.basename(path)}"))

    steps: dict[str, float] = {}
    out: dict = {"steps_s": steps}
    t0 = time.perf_counter()
    relay = CloudRelay()
    origin = f"http://127.0.0.1:{await relay.start()}"
    nodes = []
    for name in ("p18-a", "p18-b"):
        node = Node(os.path.join(tmp, name), device=DEVICE, with_labeler=False)
        node.config.config.p2p.enabled = False  # the manager is attached below
        node.config.config.p2p.discovery = P2PDiscoveryState.DISABLED
        node.config.config.name = name
        await node.start()
        node.p2p = P2PManager(node, beacon_addrs=[], bind_host="127.0.0.1")
        nodes.append(node)
    a, b = nodes
    owners = _K1Owners()
    try:
        with owners:
            for n in nodes:
                await n.p2p.start()
                check(not n.p2p.p2p._discovery, "18: a Node runs LAN discovery")
            steps["start_s"] = time.perf_counter() - t0

            # (a) A indexes 64 files through K1; B holds A's library and
            # converges through the relay alone
            t0 = time.perf_counter()
            lid = (await a.router.exec(a, "library.create", {"name": "p18"}))["uuid"]
            lib_a = a.libraries.get(uuid.UUID(lid))
            link(first)
            loc = LocationCreateArgs(path=loc_dir).create(lib_a)
            await scan_location(lib_a, loc, a.jobs, backend=DEVICE)
            await a.jobs.wait_idle()
            steps["a_index_s"] = time.perf_counter() - t0
            out["a_index_launches"] = owners.take()
            check(out["a_index_launches"].get("p18-a", 0) > 0 and set(out["a_index_launches"])
                  == {"p18-a"}, f"18(a): A's index launched K1 {out['a_index_launches']}")

            def views() -> tuple[dict, dict, dict]:
                """As phase 17's: A's and B's rows that A's op log carries,
                and A's rows no op carries, counted by model."""
                fields, carried = _synced_fields(lib_a.db), _carried_ids(lib_a.db)
                a_view, b_view = _sync_view(lib_a.db, fields), _sync_view(lib_b.db, fields)
                keep = {m: {k: r for k, r in rows.items() if k in carried[m]}
                        for m, rows in a_view.items()}
                return (keep, {m: {k: r for k, r in rows.items() if k in carried[m]}
                               for m, rows in b_view.items()},
                        {m: len(a_view[m]) - len(keep[m]) for m in a_view
                         if len(a_view[m]) != len(keep[m])})

            async def converged(what: str) -> dict:
                try:
                    async with asyncio.timeout(CLOUD_WAIT_S):
                        while (got := views())[0] != got[1]:
                            await asyncio.sleep(0.02)
                except TimeoutError:
                    pass
                a_rows, b_rows, uncarried = views()
                check(set(uncarried) <= {"media_data"}, f"{what}: rows no op carries {uncarried}")
                return {"rows": _check_views_equal(a_rows, b_rows, what), "uncarried": uncarried}

            t0 = time.perf_counter()
            lib_b = _join_library(b, lib_a)
            await b._init_library(lib_b)
            for n in nodes:
                await n.router.exec(n, "cloud.setApiOrigin", origin)
                got = await n.router.exec(n, "cloud.sync.enable", library_id=lid)
                check(got["enabled"] and n.libraries.get(uuid.UUID(lid)).cloud_sync is not None,
                      f"18(a): cloud.sync.enable on {n.config.config.name} gave {got}")
            steps["enable_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["backfilled_ops"] = await asyncio.to_thread(backfill_operations, lib_a.sync)
            lib_a.sync.event_bus.emit(("SyncMessage", "Created"))  # the sender pushes them now
            out["rows_a"] = await converged("18(a) through the relay")
            steps["converge_s"] = time.perf_counter() - t0
            out["ops"] = lib_a.db.count("crdt_operation")
            out["converge_launches"] = owners.take()
            check(not out["converge_launches"],
                  f"18(a): K1 launched {out['converge_launches']} while B converged")
            states = [await n.router.exec(n, "cloud.sync.state", library_id=lid) for n in nodes]
            out["state_a"], out["state_b"] = states
            check(states[0]["enabled"] and states[0]["sent_ops"] > 0,
                  f"18(a): A's cloud.sync.state {states[0]}")
            check(states[1]["enabled"] and states[1]["received_collections"] > 0
                  and states[1]["ingested_ops"] > 0, f"18(a): B's cloud.sync.state {states[1]}")
            out["ingest_ops_per_s"] = states[1]["ingested_ops"] / steps["converge_s"]

            # (b) 16 more on A reach B by push and poll
            t0 = time.perf_counter()
            link(more)
            await scan_location(lib_a, loc, a.jobs, backend=DEVICE)
            await a.jobs.wait_idle()
            steps["a_index_more_s"] = time.perf_counter() - t0
            out["rows_b"] = await converged("18(b) after A's second scan")
            steps["sync_s"] = time.perf_counter() - t0
            out["sync_launches"] = owners.take()
            check(set(out["sync_launches"]) == {"p18-a"},
                  f"18(b): K1 launched {out['sync_launches']} (A's scan alone may)")
            check(lib_b.db.count("file_path", "is_dir = 0") == len(picked),
                  f"18(b): B holds {lib_b.db.count('file_path', 'is_dir = 0')} files")

            # (c) a 500 and a truncated body on B's next pull, each retried
            check_healthy("18", since)
            t0 = time.perf_counter()
            a_client, b_client = lib_a.cloud_sync.client, lib_b.cloud_sync.client
            retries0 = counter_value("sd_resilience_retries_total")
            since_ts = time.time()
            plan = faults.FaultPlan.parse(CLOUD_FAULTS)
            a_open, a_quiet, a_busy, armed = asyncio.Event(), asyncio.Event(), [0], [True]
            a_open.set()
            a_quiet.set()
            a_once, b_pull = a_client._request_once, b_client.pull_ops

            async def a_held(*args):
                """A's requests wait while B's armed pull runs, so the
                plan fires on B's attempts alone."""
                await a_open.wait()
                a_busy[0] += 1
                a_quiet.clear()
                try:
                    return await a_once(*args)
                finally:
                    a_busy[0] -= 1
                    if not a_busy[0]:
                        a_quiet.set()

            async def armed_pull(*args, **kwargs):
                if not armed[0]:
                    return await b_pull(*args, **kwargs)
                armed[0] = False
                a_open.clear()
                await a_quiet.wait()
                faults.install(plan)
                try:
                    return await b_pull(*args, **kwargs)
                finally:
                    faults.install(None)
                    a_open.set()

            a_client._request_once, b_client.pull_ops = a_held, armed_pull
            try:
                await a.router.exec(a, "tags.create", {"name": "p18", "color": "#e76f51"},
                                    library_id=lid)
                out["rows_c"] = await converged("18(c) after the failed attempts")
            finally:
                a_client._request_once, b_client.pull_ops = a_once, b_pull
                faults.install(None)
            steps["fault_s"] = time.perf_counter() - t0
            retried = [e["fields"] for e in RESILIENCE_EVENTS.snapshot()
                       if e["type"] == "retry" and e["ts"] >= since_ts]
            out["fault"] = {"activations": plan.activations(), "retries": retried,
                            "retries_total": counter_value("sd_resilience_retries_total")
                            - retries0}
            check(plan.activations() == {"relay.http": 2} and out["fault"]["retries_total"] >= 2
                  and len(retried) == 2 and all(r["policy"] == "relay" for r in retried),
                  f"18(c): {out['fault']}")
            check(lib_b.db.find_one("tag", name="p18") is not None, "18(c): A's tag is not on B")
            out["fault_launches"] = owners.take()
            check(not out["fault_launches"], f"18(c): K1 launched {out['fault_launches']}")

            # (d) the federation's relay leg
            t0 = time.perf_counter()
            await b.p2p.refresh_federation(force=True)
            mesh = await a.p2p.refresh_federation(force=True)
            pid = f"instance:{lib_b.sync.instance}"
            got = mesh["peers"].get(pid) or {}
            check(got.get("transport") == "relay" and got.get("error") is None
                  and (got.get("snapshot") or {}).get("node", {}).get("name") == "p18-b",
                  f"18(d): A's view of B {({k: v for k, v in got.items() if k != 'snapshot'})}")
            steps["federation_s"] = time.perf_counter() - t0
            out["sent_ops"] = lib_a.cloud_sync.sent_ops
            out["received_collections"] = lib_b.cloud_sync.received_collections
            out["ingested_ops"] = lib_b.cloud_sync.ingested_ops
            out["relay_collections"] = len(relay.libraries[lid]["collections"])
    finally:
        for n in nodes:
            await n.shutdown()
        await relay.shutdown()
    out["launches"] = sum(sum(out[k].values()) for k in (
        "a_index_launches", "converge_launches", "sync_launches", "fault_launches"))
    return out


def phase_cloud_sync(tmp: str, snapshot: str) -> dict:
    """Phase 18: cloud sync between two port Nodes on the card through a
    port relay: (a) B converges through the relay, (b) push and poll,
    (c) two failed attempts of a pull that retries, (d) the federation's
    relay leg."""
    import asyncio

    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.parallel import autotune, mesh

    t_phase = time.perf_counter()
    mesh.LADDER.reset()
    autotune.reset()
    since = degradation()
    blake3_cuda.chunk_cvs.launches = 0
    got = asyncio.run(cloud_sync(tmp, snapshot, since))
    check(blake3_cuda.chunk_cvs.launches == got["launches"],
          f"18: K1 launched {blake3_cuda.chunk_cvs.launches} times, {got['launches']} in windows")
    moved = {k: v - since[k] for k, v in degradation().items() if not k.startswith("demotion")}
    check(moved == {**{k: 0 for k in moved}, "fault_activations": 2},
          f"18(c): degradation counters moved {moved}")
    got["seconds"] = time.perf_counter() - t_phase
    return got


def report_cloud_sync(got: dict) -> dict:
    print(json.dumps({"cloud_sync": got}), flush=True)
    steps = got["steps_s"]
    print(f"phase 18: cloud sync in {got['seconds']:.1f} s: (a) A indexed "
          f"{got['rows_a']['rows']['file_path']} files ({got['a_index_launches']['p18-a']} K1 "
          f"launches), A pushed {got['sent_ops']} ops, B received "
          f"{got['received_collections']} collections and converged in "
          f"{steps['converge_s']:.2f} s ({got['ingest_ops_per_s']:.0f} ops/s, K1 0 on B), "
          f"(b) synced in {steps['sync_s']:.2f} s, (c) a 500 and a truncated body retried, "
          f"(d) B's snapshot through the relay", flush=True)
    return {"launches": {"cloud_node": got["launches"]}}


# --- phase 19: the API host -------------------------------------------------------------


SERVE_FILES = (56, 8)  # (a): every n-th of phase 3's other files, and of its images
SERVE_WAIT_S = 60  # the bound on one step of the phase
SERVE_BURST = 24  # (e): requests offered past the interactive budget and queue
SERVE_SCORE_TOL = 1e-5  # (c): /search's score against the in-process router's


async def api_serve(tmp: str, snapshot: str, since: dict) -> dict:
    """19(a)-(f) on a port Node on the card serving its HTTP API on
    127.0.0.1, driven through the port's own HTTP and websocket client;
    `since` is the degradation counters before the phase."""
    import asyncio
    import threading

    from spacedrive_tpu_torch import mobile
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.ops import embed_torch
    from spacedrive_tpu_torch.telemetry.events import LOOP_EVENTS, SERVE_EVENTS
    from spacedrive_tpu_torch.utils import http

    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(snapshot) for f in fs)
    images = [f for f in files if f.endswith((".png", ".jpg"))]
    others = [f for f in files if f not in set(images)]
    picked = (others[::len(others) // SERVE_FILES[0]][:SERVE_FILES[0]]
              + images[::len(images) // SERVE_FILES[1]][:SERVE_FILES[1]])
    loc_dir = os.path.join(tmp, "p19_location")
    os.makedirs(loc_dir)
    for i, path in enumerate(picked):
        os.link(path, os.path.join(loc_dir, f"{i:03d}_{os.path.basename(path)}"))
    steps: dict[str, float] = {}
    out: dict = {"steps_s": steps, "files": len(picked)}
    embeds = {"chunks": 0}
    embed_chunk = embed_torch._embed_chunk

    def counted(*a, **k):
        embeds["chunks"] += 1
        return embed_chunk(*a, **k)

    t0 = time.perf_counter()
    node = Node(os.path.join(tmp, "p19"), device=DEVICE, with_labeler=False)
    node.config.config.p2p.enabled = False
    node.config.config.name = "p19"
    node.config.save()  # (f)'s bridge builds its Node from this config
    await node.start()
    base = f"http://127.0.0.1:{await node.start_api('127.0.0.1', 0)}"
    client = http.HttpClient()
    owners = _K1Owners()
    release = asyncio.Event()
    held: list = []

    async def rspc(key: str, arg=None, lid=None, expect: int = 200):
        r = await client.request("POST", f"{base}/rspc/{key}",
                                 json={"arg": arg, "library_id": lid})
        check(r.status == expect, f"19: {key} answered {r.status}: {r.body[:200]!r}")
        return r

    try:
        embed_torch._embed_chunk = counted
        with owners:
            steps["start_s"] = time.perf_counter() - t0

            # (a) locations.create over HTTP: the scan through K1 and the
            # embedder, its progress and invalidations on a websocket
            t0 = time.perf_counter()
            lid = (await rspc("library.create", {"name": "p19"})).json()["result"]["uuid"]
            ws = await http.ws_connect(base + "/rspc/ws")
            frames: list = []
            for mid, key, lib in (("inv", "invalidation.listen", None),
                                  ("jobs", "jobs.progress", lid)):
                await ws.send_str(json.dumps({"id": mid, "type": "subscriptionAdd", "key": key,
                                              "library_id": lib}))
            await ws.send_str(json.dumps({"id": "rt", "type": "query", "key": "buildInfo"}))
            check(json.loads((await ws.receive(timeout=SERVE_WAIT_S)).data)["id"] == "rt",
                  "19(a): the websocket's round trip")

            async def read_frames() -> None:
                async for msg in ws:
                    frames.append(json.loads(msg.data))

            reader = asyncio.ensure_future(read_frames())
            loc_id = (await rspc("locations.create", {"path": loc_dir}, lid)).json()["result"]
            async with asyncio.timeout(SERVE_WAIT_S):
                while (await rspc("jobs.isActive", None, lid)).json()["result"]:
                    await asyncio.sleep(0.05)
                await node.jobs.wait_idle()
                await node.thumbnailer.wait_library_batch(lid)
                while not any(f.get("id") == "inv" and f["event"]["key"] == "search.paths"
                              for f in frames):
                    await asyncio.sleep(0.02)
            steps["scan_s"] = time.perf_counter() - t0
            out["scan_launches"] = owners.take()
            # what a frontend met during the scan and the serve layer after
            # it, read before this phase's own checks: the interactive
            # class's latency SLO over this Node's history,
            # `telemetry.serve`, and /health with its verdicts
            node.history.sample()
            slo = {x["name"]: x for x in (await rspc("telemetry.slo")).json()["result"]["slos"]}
            out["interactive_p99"] = {k: slo["interactive_p99"].get(k)
                                      for k in ("status", "current", "objective")}
            out["loop_lag_events"] = [e["fields"]["seconds"] for e in LOOP_EVENTS.snapshot()]
            out["serve_mode_events"] = [e["fields"]["mode"] for e in SERVE_EVENTS.snapshot()
                                        if e["type"] == "mode"]
            h = await client.request("GET", f"{base}/health")
            out["health"] = {k: v["status"] for k, v in h.json()["subsystems"].items()}
            out["health_status"] = h.status
            check(out["interactive_p99"]["status"] == "ok",
                  f"19(a): interactive_p99 over the scan {slo['interactive_p99']}")
            out["serve_classes"] = check_serve_doc((await rspc("telemetry.serve")).json()["result"],
                                                   "19(a)")
            check(h.status == 200 and out["health"]["serve"] == "healthy",
                  f"19(a): /health answered {h.status}: {out['health']}; loop lags "
                  f"{out['loop_lag_events']}")

            check(out["scan_launches"].get("p19", 0) > 0 and set(out["scan_launches"]) == {"p19"},
                  f"19(a): the scan over HTTP launched K1 {out['scan_launches']}")
            lib = node.libraries.get(uuid.UUID(lid))
            rows = lib.db.query("SELECT * FROM file_path WHERE is_dir = 0 AND location_id = ? "
                                "AND name != '.spacedrive'", (loc_id,))
            cas_of = {os.path.join(loc_dir, f"{r['name']}.{r['extension']}" if r["extension"]
                                   else r["name"]): r["cas_id"] for r in rows}
            linked = sorted(os.path.join(loc_dir, n) for n in os.listdir(loc_dir)
                            if not n.startswith("."))
            check(len(rows) == len(linked) == len(picked),
                  f"19(a): {len(rows)} rows for {len(linked)} files")
            # the plain path and blake3_ref take seconds: off the Node's loop
            await asyncio.to_thread(_check_cas, linked, cas_of, "19(a)")
            out["embed_chunks_scan"] = embeds["chunks"]
            check(embeds["chunks"] > 0, "19(a): the media job embedded nothing on the card")
            kinds = {f["id"]: f.get("event") for f in frames}
            out["ws_frames"] = len(frames)
            progress = [f for f in frames if f.get("id") == "jobs"]
            invalidated = {f["event"]["key"] for f in frames if f.get("id") == "inv"}
            check(progress and kinds.get("jobs") is not None,
                  "19(a): no job progress on the websocket")
            check({"search.paths", "locations.list"} <= invalidated,
                  f"19(a): invalidations on the websocket {sorted(invalidated)}")
            out["ws"] = {"progress": len(progress), "invalidated": sorted(invalidated)}
            # (b) search.paths twice (a hit with the same bytes), then a tag
            # write the same query shows
            t0 = time.perf_counter()
            tag_id = (await rspc("tags.create", {"name": "p19"}, lid)).json()["result"]
            query = {"filter": {"tags": [tag_id]}, "take": 100}
            first = await rspc("search.paths", query, lid)
            second = await rspc("search.paths", query, lid)
            check((first.headers.get("X-SD-Cache"), second.headers.get("X-SD-Cache"))
                  == ("miss", "hit") and first.body == second.body,
                  f"19(b): X-SD-Cache {first.headers.get('X-SD-Cache')} then "
                  f"{second.headers.get('X-SD-Cache')}")
            oids = sorted({r["object_id"] for r in rows if r["object_id"]})[:8]
            await rspc("tags.assign", {"tag_id": tag_id, "object_ids": oids}, lid)
            third = await rspc("search.paths", query, lid)
            tagged = third.json()["result"]["nodes"]
            check(third.headers.get("X-SD-Cache") == "miss"
                  and sorted({n["object_id"] for n in tagged}) == oids,
                  f"19(b): after the write {third.headers.get('X-SD-Cache')}, "
                  f"{len(tagged)} rows for {len(oids)} tagged objects")
            steps["cache_s"] = time.perf_counter() - t0
            out["tagged_rows"] = len(tagged)

            # (c) GET /search embeds an indexed image on the card and ranks
            # it first, with the in-process router's score
            t0 = time.perf_counter()
            image = next(p for p in linked if p.endswith((".png", ".jpg")))
            chunks = embeds["chunks"]
            r = await client.request("GET", f"{base}/search?library_id={lid}&q={image}&take=5")
            check(r.status == 200, f"19(c): /search answered {r.status}")
            hits = r.json()["result"]
            check(embeds["chunks"] > chunks, "19(c): the query image was not embedded on the card")
            want = await node.router.exec(node, "search.semantic", {"query": image, "take": 5},
                                          lid)
            top = hits["nodes"][0]
            name = os.path.basename(image)
            check(f"{top['name']}.{top['extension']}" == name,
                  f"19(c): /search ranked {top['name']} first, not {name}")
            check(abs(top["score"] - want["nodes"][0]["score"]) <= SERVE_SCORE_TOL
                  and want["nodes"][0]["id"] == top["id"],
                  f"19(c): score {top['score']} against the router's {want['nodes'][0]['score']}")
            out["search"] = {"score": top["score"], "router_score": want["nodes"][0]["score"]}
            steps["search_s"] = time.perf_counter() - t0

            # (d) a thumbnail's bytes and a ranged read of a file
            t0 = time.perf_counter()
            cas = cas_of[image]
            disk = node.thumbnailer.store.path_for(lid, cas)
            shard = os.path.basename(os.path.dirname(disk))
            r = await client.request("GET", f"{base}/spacedrive/thumbnail/{lid}/{shard}/{cas}.webp")
            with open(disk, "rb") as f:
                check(r.status == 200 and r.body == f.read(),
                      f"19(d): the thumbnail answered {r.status}, {len(r.body)} bytes")
            big = max(linked, key=os.path.getsize)
            size = os.path.getsize(big)
            lo, hi = size // 3, size // 3 + 65535
            r = await client.request(
                "GET", f"{base}/spacedrive/file/{lid}/{loc_id}/{os.path.basename(big)}",
                headers={"Range": f"bytes={lo}-{hi}"})
            with open(big, "rb") as f:
                f.seek(lo)
                want_bytes = f.read(hi - lo + 1)
            check(r.status == 206 and r.body == want_bytes
                  and r.headers.get("Content-Range") == f"bytes {lo}-{hi}/{size}",
                  f"19(d): the ranged read answered {r.status} {r.headers.get('Content-Range')}")
            steps["bytes_s"] = time.perf_counter() - t0

            # (e) a burst on the Node's own policy: the interactive budget
            # held on purpose through the gate's admission, then SERVE_BURST
            # cache-cold reads at once, each shed (by a full queue, or by
            # its queue deadline) with Retry-After, while /health (the
            # control class) is polled throughout and never answers 503
            t0 = time.perf_counter()
            gate = node.serve.gate
            budget = gate.policy.budgets["interactive"]

            async def hold(entered: asyncio.Event) -> None:
                async with gate.admit("interactive"):
                    entered.set()
                    await release.wait()

            entered = [asyncio.Event() for _ in range(budget.max_inflight)]
            held += [asyncio.ensure_future(hold(e)) for e in entered]
            for e in entered:
                await e.wait()
            classes = gate.snapshot()["classes"]
            check(classes["interactive"]["inflight"] == budget.max_inflight,
                  f"19(e): the held budget {classes['interactive']}")
            shed0, burst_done, health = gate.shed["interactive"], asyncio.Event(), []

            async def read(i: int):
                r = await client.request("POST", f"{base}/rspc/search.paths", json={
                    "library_id": lid, "arg": {"filter": {"search": f"burst{i}"}}})
                return r.status, r.headers.get("Retry-After")

            async def probe() -> None:
                while not burst_done.is_set():
                    h = await client.request("GET", f"{base}/health")
                    health.append(h.status)
                    if h.status == 503:
                        out.setdefault("unhealthy", sorted(
                            k for k, v in h.json()["subsystems"].items()
                            if v["status"] == "unhealthy"))
                    await asyncio.sleep(0.01)

            prober = asyncio.ensure_future(probe())
            async with asyncio.timeout(SERVE_WAIT_S):
                answers = await asyncio.gather(*(read(i) for i in range(SERVE_BURST)))
            burst_done.set()
            await prober
            brownout = gate.in_brownout()
            health_doc = (await client.request("GET", f"{base}/health")).json()
            metrics = (await client.request("GET", f"{base}/metrics")).text()
            release.set()
            await asyncio.gather(*held)
            shed = gate.shed["interactive"] - shed0
            line = next((x for x in metrics.splitlines() if x.startswith(
                'sd_gate_requests_total{klass="interactive",outcome="shed"}')), "")
            statuses = [a[0] for a in answers]
            check(statuses == [429] * SERVE_BURST and {a[1] for a in answers} == {"1"}
                  and shed == SERVE_BURST,
                  f"19(e): the burst answered {sorted(set(statuses))}, Retry-After "
                  f"{sorted({str(a[1]) for a in answers})}, {shed} sheds")
            check(health and 503 not in health and gate.shed["control"] == 0,
                  f"19(e): /health answered {sorted(set(health))} during the burst "
                  f"({out.get('unhealthy')})")
            check(brownout and health_doc["subsystems"]["serve"]["status"] == "degraded",
                  f"19(e): after the burst the gate's brownout {brownout}, serve "
                  f"{health_doc['subsystems']['serve']}")
            check(line and float(line.split()[-1]) >= SERVE_BURST,
                  f"19(e): /metrics counts {line!r}")
            out["burst"] = {"shed": shed, "health": sorted(set(health)), "probes": len(health),
                            "brownout": brownout, "metrics_shed": float(line.split()[-1]),
                            "max_inflight": budget.max_inflight, "max_queue": budget.max_queue,
                            "queue_deadline_s": budget.queue_deadline_s}
            steps["burst_s"] = time.perf_counter() - t0
            reader.cancel()
            await ws.close()
            out["launches"] = sum(owners.by.values()) + sum(out["scan_launches"].values())
    finally:
        release.set()
        embed_torch._embed_chunk = embed_chunk
        await client.close()
        await node.shutdown()
    check_healthy("19", since)

    # (f) the mobile bridge on the card, on the shut-down Node's data dir
    t0 = time.perf_counter()
    done, box = threading.Event(), {}

    def on_reply(payload: str) -> None:
        box["reply"] = json.loads(payload)
        done.set()

    try:
        mobile.handle_core_msg(json.dumps({"id": 1, "method": "search.paths", "params": {
            "arg": query, "library_id": lid}}), node.data_dir, on_reply, device=DEVICE)
        check(await asyncio.to_thread(done.wait, SERVE_WAIT_S), "19(f): the bridge never answered")
    finally:
        await asyncio.to_thread(mobile.shutdown_core)
    reply = box["reply"][0]["result"]
    check(reply["type"] == "response" and reply["data"]["nodes"] == tagged,
          f"19(f): the bridge answered {reply['type']} with "
          f"{len((reply.get('data') or {}).get('nodes', []))} rows")
    steps["mobile_s"] = time.perf_counter() - t0
    return out


def phase_api_serve(tmp: str, snapshot: str) -> dict:
    """Phase 19: the HTTP API host of a port Node on the card: (a) a scan
    through locations.create over HTTP, watched on a websocket, (b) the
    read cache, (c) /search, (d) a thumbnail and a ranged read, (e) a
    shed burst, (f) the mobile bridge."""
    import asyncio

    from spacedrive_tpu_torch import telemetry
    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.parallel import autotune, mesh

    t_phase = time.perf_counter()
    mesh.LADDER.reset()
    autotune.reset()
    # /health reads the process's recent series: the earlier phases'
    # injected stalls and faults must not speak for this Node
    telemetry.reset()
    since = degradation()
    blake3_cuda.chunk_cvs.launches = 0
    got = asyncio.run(api_serve(tmp, snapshot, since))
    check(blake3_cuda.chunk_cvs.launches == got["launches"],
          f"19: K1 launched {blake3_cuda.chunk_cvs.launches} times, {got['launches']} in windows")
    got["seconds"] = time.perf_counter() - t_phase
    return got


def report_api_serve(got: dict) -> dict:
    print(json.dumps({"api_serve": got}), flush=True)
    steps = got["steps_s"]
    print(f"phase 19: the API host in {got['seconds']:.1f} s: (a) {got['files']} files scanned "
          f"over HTTP in {steps['scan_s']:.2f} s ({got['launches']} K1 launches, "
          f"{got['embed_chunks_scan']} embed chunks, {got['ws_frames']} websocket frames), "
          f"(b) miss, hit, and {got['tagged_rows']} tagged rows after the write, (c) the query "
          f"image first at {got['search']['score']:.6f}, (d) thumbnail and range exact, (e) "
          f"{got['burst']['shed']} sheds with /health {got['burst']['health']}, (f) the bridge "
          f"in {steps['mobile_s']:.2f} s", flush=True)
    return {"launches": {"api_serve": got["launches"]}}


# --- phase 20: the mesh work plane and the execution continuum --------------------------

MESH_FILES = 64  # taken evenly from phase 3's files, MESH_IMAGES of them images
MESH_IMAGES = 8
MESH_MORE = 16  # (c)'s files, taken with the others
MESH_SHARD_FILES = 8
MESH_STAGE_SHARD_FILES = 4  # (b): 2 shards of each stage
MESH_VANISH_SHARD_FILES = 2  # (c): 8 shards, so B's first claim finds work left
MESH_LEASE_S = 2.0  # (c)'s lease clamp: the vanished lease re-pools at this deadline
MESH_WAIT_S = 60  # the bound on one step of the phase
MESH_STAGES = ("thumb", "media.extract", "phash", "embed")


def _mesh_views(node, lib, loc_id: int) -> dict:
    """A library's observable result of the identify and stage passes,
    keyed by content or path so two libraries compare: path -> cas_id,
    cas_id -> the paths of its one object, journal key -> (cas_id, chunk
    digests, thumb, media, pHash and embed vouches), and cas_id -> webp
    bytes, media_data row, pHash and vector blob."""
    from spacedrive_tpu_torch.location.indexer.journal import entry_of_row, key_of

    def key(r):
        return f"{r['materialized_path']}{r['name']}.{r['extension'] or ''}"

    rows = lib.db.query("SELECT fp.*, o.phash AS ph, oe.vector AS vec FROM file_path fp "
                        "LEFT JOIN object o ON o.id = fp.object_id LEFT JOIN object_embedding oe "
                        "ON oe.object_id = o.id WHERE fp.location_id = ? AND fp.is_dir = 0",
                        (loc_id,))
    groups: dict = {}
    for r in rows:
        if r["object_id"] is not None:
            groups.setdefault(r["cas_id"], set()).add(key(r))
    vouches = {}
    for r in lib.db.query("SELECT * FROM index_journal WHERE location_id = ?", (loc_id,)):
        e = entry_of_row(r)
        check(e is not None, "20: a corrupt journal row")
        # a media digest covers the replica's own object_id: its presence
        # and emptiness compare across libraries, its value does not
        vouches[key_of(r)] = (e.cas_id, tuple(e.chunks.digests) if e.chunks else None, e.thumb,
                              e.media_digest is not None, bool(e.media_digest), e.phash, e.embed)
    store = node.thumbnailer.store
    webps = {}
    for r in rows:
        path = store.path_for(str(lib.id), r["cas_id"]) if r["cas_id"] else None
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                webps[r["cas_id"]] = f.read()
    media = {r["cas_id"]: tuple(sorted((k, v) for k, v in r.items()
                                       if k not in ("id", "object_id", "cas_id")))
             for r in lib.db.query("SELECT fp.cas_id, md.* FROM file_path fp JOIN media_data md "
                                   "ON md.object_id = fp.object_id WHERE fp.location_id = ?",
                                   (loc_id,))}
    return {"rows": {key(r): r["cas_id"] for r in rows},
            "groups": {c: frozenset(v) for c, v in groups.items()},
            "journal": vouches, "webp": webps, "media": media,
            "phash": {r["cas_id"]: r["ph"] for r in rows if r["ph"] is not None},
            "vectors": {r["cas_id"]: r["vec"] for r in rows if r["vec"] is not None}}


def _vector_diff(got: dict, want: dict) -> tuple[float, bool]:
    """The largest |d| between two cas -> vector-blob maps of one key
    set, and whether every blob is equal bit for bit."""
    check(set(got) == set(want), f"20(b): vectors for {len(got)} objects, want {len(want)}")
    worst = 0.0
    for c, blob in want.items():
        a, b = np.frombuffer(got[c], np.float32), np.frombuffer(blob, np.float32)
        check(a.shape == b.shape and bool(np.isfinite(a).all()), f"20(b): vector of {c}")
        worst = max(worst, float(np.abs(a - b).max()))
    return worst, all(got[c] == want[c] for c in want)


async def mesh_work(tmp: str, snapshot: str, since: dict) -> dict:
    """20(a)-(c) on two port Nodes on the card joined by pairing, their
    managers on 127.0.0.1 over Noise TCP, against a solo port Node on
    the card with p2p off; `since` is the degradation counters before
    the phase."""
    import asyncio

    from spacedrive_tpu_torch.files.isolated_path import full_path_from_db_row
    from spacedrive_tpu_torch.location.indexer.mesh import (
        distribute_location_index,
        distribute_location_stages,
    )
    from spacedrive_tpu_torch.location.locations import LocationCreateArgs
    from spacedrive_tpu_torch.node.node import Node
    from spacedrive_tpu_torch.ops import cas
    from spacedrive_tpu_torch.p2p.manager import P2PManager
    from spacedrive_tpu_torch.telemetry import counter_value
    from spacedrive_tpu_torch.utils import faults

    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(snapshot) for f in fs)
    images = [f for f in files if f.endswith((".png", ".jpg"))]
    others = [f for f in files if f not in set(images)]
    n_others = MESH_FILES - MESH_IMAGES + MESH_MORE
    picked = (others[::len(others) // n_others][:n_others]
              + images[::len(images) // MESH_IMAGES][:MESH_IMAGES])
    more = picked[MESH_FILES - MESH_IMAGES:n_others]
    loc_dir = os.path.join(tmp, "p20_location")  # one folder, read by A, B and the solo Node
    os.makedirs(loc_dir)

    def link(paths) -> None:
        for path in paths:
            os.link(path, os.path.join(loc_dir, f"{picked.index(path):03d}_{os.path.basename(path)}"))

    link([p for p in picked if p not in more])
    steps: dict[str, float] = {}
    out: dict = {"steps_s": steps}
    t0 = time.perf_counter()
    nodes = []
    for name in ("p20-a", "p20-b", "p20-solo"):
        node = Node(os.path.join(tmp, name), device=DEVICE, with_labeler=False)
        node.config.config.p2p.enabled = False  # A's and B's managers are attached below
        node.config.config.name = name
        await node.start()
        if name != "p20-solo":
            node.p2p = P2PManager(node, beacon_addrs=[("127.0.0.1", 1)], bind_host="127.0.0.1")
        nodes.append(node)
    a, b, solo = nodes
    owners = _K1Owners()
    stage_ids = list(MESH_STAGES)
    try:
        with owners:
            for n in (a, b):
                await n.p2p.start()
            da, db_ = (n.p2p.p2p._discovery[0] for n in (a, b))
            da.beacon_addrs, db_.beacon_addrs = [("127.0.0.1", db_.bind_port)], [("127.0.0.1", da.bind_port)]
            da.interval = db_.interval = 0.05
            async with asyncio.timeout(MESH_WAIT_S):
                while not (a.p2p.p2p.discovered_peers() and b.p2p.p2p.discovered_peers()):
                    await asyncio.sleep(0.01)
            lid = (await a.router.exec(a, "library.create", {"name": "p20"}))["uuid"]
            lib_a = a.libraries.get(uuid.UUID(lid))
            offers = []
            a.event_bus.on(lambda ev: offers.append(ev[1]) if isinstance(ev, tuple) and ev
                           and ev[0] == "PairingRequest" else None)

            async def consent():
                while not offers:
                    await asyncio.sleep(0.01)
                await a.router.exec(a, "p2p.acceptPairing", str(offers[0].id))

            async with asyncio.timeout(MESH_WAIT_S):
                joined, _ = await asyncio.gather(
                    b.router.exec(b, "p2p.pairLibrary",
                                  {"identity": str(a.p2p.p2p.remote_identity), "library_id": lid}),
                    consent())
            check(joined == lid, f"20: B joined {joined}, not {lid}")
            lib_b = b.libraries.get(uuid.UUID(lid))
            loc = LocationCreateArgs(path=loc_dir).create(lib_a)
            # B resolves the session's location on its own replica
            async with asyncio.timeout(MESH_WAIT_S):
                while lib_b.db.find_one("location", pub_id=loc["pub_id"]) is None:
                    await a.p2p._alert_peers(lib_a.id)
                    await asyncio.sleep(0.02)
            lib_s = await solo.create_library("p20-solo")
            loc_s = LocationCreateArgs(path=loc_dir).create(lib_s)
            steps["start_s"] = time.perf_counter() - t0
            out["launches_start"] = owners.take()
            check(not out["launches_start"], f"20: the set-up launched K1 {out['launches_start']}")

            # (a) distributed identify against the solo Node's pass
            b_id = str(b.p2p.p2p.remote_identity)
            out["b_verdict"] = a.p2p.work.peer_verdict(b_id)
            print(f"phase 20: B's federated verdict on A: {out['b_verdict']}", flush=True)
            t0 = time.perf_counter()
            out["solo_identify"] = await distribute_location_index(
                solo, lib_s, loc_s["id"], shard_files=MESH_SHARD_FILES)
            steps["solo_identify_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            async with asyncio.timeout(MESH_WAIT_S):
                out["identify"] = await distribute_location_index(
                    a, lib_a, loc["id"], shard_files=MESH_SHARD_FILES)
            steps["identify_s"] = time.perf_counter() - t0
            out["identify_launches"] = owners.take()
            out["b_executed"] = {"identify": b.p2p.work.worker.executed_shards}
            remote = counter_value("sd_work_shards_total", result="completed_remote",
                                   stage="identify.hash")
            check(out["identify"]["remote_shards"] > 0 and out["b_executed"]["identify"] > 0
                  and remote > 0, f"20(a): B executed no identify shard: {out['identify']}")
            check({"p20-a", "p20-b", "p20-solo"} <= set(out["identify_launches"])
                  and "other" not in out["identify_launches"],
                  f"20(a): K1 launches by Node {out['identify_launches']}")
            want = _mesh_views(solo, lib_s, loc_s["id"])
            got = _mesh_views(a, lib_a, loc["id"])
            hashed = [(full_path_from_db_row(loc_dir, r), r["cas_id"]) for r in lib_a.db.query(
                "SELECT * FROM file_path WHERE location_id = ? AND is_dir = 0 AND cas_id != ''",
                (loc["id"],))]
            check(len(hashed) == sum(1 for c in got["rows"].values() if c),
                  "20(a): a file without its cas_id")
            refs = blake3_ref_hexes([cas.read_message(p) for p, _ in hashed])
            check([c for _, c in hashed] == refs, "20(a): a cas_id differs from blake3_ref")
            for part in ("rows", "groups", "journal"):
                check(got[part] == want[part], f"20(a): A's {part} differ from the solo pass's")
            out["identify_files"] = len(got["rows"])

            # (b) the stage session against the solo Node's
            t0 = time.perf_counter()
            out["solo_stages"] = await distribute_location_stages(
                solo, lib_s, loc_s["id"], stage_ids, shard_files=MESH_STAGE_SHARD_FILES)
            steps["solo_stages_s"] = time.perf_counter() - t0
            before = b.p2p.work.worker.executed_shards
            t0 = time.perf_counter()
            async with asyncio.timeout(MESH_WAIT_S):
                out["stages"] = await distribute_location_stages(
                    a, lib_a, loc["id"], stage_ids, shard_files=MESH_STAGE_SHARD_FILES)
            steps["stages_s"] = time.perf_counter() - t0
            out["stage_launches"] = owners.take()
            check(not out["stage_launches"], f"20(b): the stages launched K1 {out['stage_launches']}")
            out["b_executed"]["stages"] = b.p2p.work.worker.executed_shards - before
            check(out["stages"]["remote_shards"] > 0 and out["b_executed"]["stages"] > 0,
                  f"20(b): B executed no stage shard: {out['stages']}")
            out["rates_b"] = b.p2p.work.worker.rates_report()
            out["rates_a"] = a.p2p.work.worker.rates_report()
            want = _mesh_views(solo, lib_s, loc_s["id"])
            got = _mesh_views(a, lib_a, loc["id"])
            for part in ("webp", "media", "phash", "journal"):
                check(want[part] and got[part] == want[part],
                      f"20(b): A's {part} ({len(got[part])}) differ from the solo pass's "
                      f"({len(want[part])})")
            out["max_vector_d"], out["vectors_bitwise"] = _vector_diff(got["vectors"], want["vectors"])
            check(out["max_vector_d"] <= 1e-5, f"20(b): vectors differ by {out['max_vector_d']}")
            print(f"phase 20: vectors {'equal bit for bit' if out['vectors_bitwise'] else 'within 1e-5'}"
                  f" of the solo pass (max |d| {out['max_vector_d']:.3g})", flush=True)
            out["stage_files"] = {k: len(got[k]) for k in ("webp", "media", "phash", "vectors")}
            check_healthy("20(b)", since)

            # (c) B vanishes mid-lease; A re-pools the lease at its deadline
            link(more)
            t0 = time.perf_counter()
            await distribute_location_index(solo, lib_s, loc_s["id"], shard_files=MESH_SHARD_FILES)
            steps["solo_more_s"] = time.perf_counter() - t0
            plan = faults.FaultPlan.parse("p2p.steal:vanish:arg=lease,times=1")
            expired0 = counter_value("sd_work_shards_total", result="expired", stage="identify.hash")
            t0 = time.perf_counter()
            with faults.active(plan):
                async with asyncio.timeout(MESH_WAIT_S):
                    out["vanish"] = await distribute_location_index(
                        a, lib_a, loc["id"], shard_files=MESH_VANISH_SHARD_FILES,
                        lease_max_s=MESH_LEASE_S)
            steps["vanish_s"] = time.perf_counter() - t0
            out["vanish_launches"] = owners.take()
            out["expired"] = counter_value("sd_work_shards_total", result="expired",
                                           stage="identify.hash") - expired0
            check(plan.activations() == {"p2p.steal": 1} and out["expired"] >= 1,
                  f"20(c): activations {plan.activations()}, {out['expired']} leases expired")
            check(out["vanish"]["local_shards"] + out["vanish"]["remote_shards"]
                  == out["vanish"]["shards"], f"20(c): {out['vanish']}")
            want = _mesh_views(solo, lib_s, loc_s["id"])
            got = _mesh_views(a, lib_a, loc["id"])
            for part in ("rows", "groups", "journal"):
                check(got[part] == want[part], f"20(c): A's {part} differ from the solo pass's: "
                      f"{sorted(k for k in set(got[part]) | set(want[part]) if got[part].get(k) != want[part].get(k))[:4]}")
            out["vanish_files"] = len(got["rows"])
    finally:
        for n in nodes:
            await n.shutdown()
    out["launches_by_node"] = dict(collections.Counter(out["identify_launches"])
                                   + collections.Counter(out["vanish_launches"]))
    out["launches"] = sum(out["launches_by_node"].values())
    return out


def phase_mesh_work(tmp: str, snapshot: str) -> dict:
    """Phase 20: the mesh work plane and the execution continuum on two
    port Nodes on the card against a solo one: (a) distributed identify,
    (b) a stage session, (c) a vanished lease re-pooled."""
    import asyncio

    from spacedrive_tpu_torch import telemetry
    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.parallel import autotune, mesh

    t_phase = time.perf_counter()
    mesh.LADDER.reset()
    autotune.reset()
    telemetry.reset()  # the work counters and the stage rates count this phase alone
    since = degradation()
    blake3_cuda.chunk_cvs.launches = 0
    got = asyncio.run(mesh_work(tmp, snapshot, since))
    check(blake3_cuda.chunk_cvs.launches == got["launches"],
          f"20: K1 launched {blake3_cuda.chunk_cvs.launches} times, {got['launches']} in shards "
          f"and windows")
    moved = {k: v - since[k] for k, v in degradation().items() if not k.startswith("demotion")}
    check(moved == {**{k: 0 for k in moved}, "fault_activations": 1},
          f"20(c): degradation counters moved {moved}")
    got["seconds"] = time.perf_counter() - t_phase
    return got


def report_mesh_work(got: dict) -> dict:
    print(json.dumps({"mesh_work": got}, default=str), flush=True)
    steps = got["steps_s"]
    ident, stages = got["identify"], got["stages"]
    print(f"phase 20: the mesh work plane in {got['seconds']:.1f} s: (a) {got['identify_files']} "
          f"files in {ident['shards']} identify shards ({ident['peers']}) in "
          f"{steps['identify_s']:.2f} s, K1 launches by Node {got['launches_by_node']}, rows, "
          f"objects and journal equal the solo pass's; (b) {stages['shards']} stage shards "
          f"({stages['peers']}) in {steps['stages_s']:.2f} s, webp, media_data and pHash equal, "
          f"vectors max |d| {got['max_vector_d']:.3g}; (c) the vanished lease re-pooled, "
          f"{got['expired']} expired, {got['vanish_files']} rows equal", flush=True)
    return {"launches": {"mesh_work": got["launches"]}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--stop-after", type=int, default=20, choices=range(3, 21),
                        metavar="PHASE", help="run phases 1 to PHASE only (default 20: all); "
                        "phase 3 alone times the pass on every visible card")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU", file=sys.stderr)
        return 2
    from spacedrive_tpu_torch.ops import blake3_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    name_power = smi("name,power.limit")
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    print(f"phase 1: {name_power}, max SM clock {sm_clock_hz / 1e6:.0f} MHz, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    # each phase's wall seconds, checks included, from the end of the one before
    phase_s: dict[str, float] = {}
    mark = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_s[name], mark[0] = now - mark[0], now

    blake3_cuda.build()
    print(f"phase 1: K1 built in {time.perf_counter() - mark[0]:.1f} s", flush=True)
    lap("1")

    kernel = phase_kernel(rng, sm_clock_hz)
    check_healthy("2")
    lap("2")
    launches: dict[str, int] = {}
    kernels = [kernel]  # K1, then H1 once phase 5 has run
    with tempfile.TemporaryDirectory(prefix="sd_chip_smoke_") as tmp:
        got = phase_pass(rng, tmp)
        check_healthy("3")
        launches["index_pass"] = got["launches"]
        lap("3")
        if args.stop_after >= 4:
            snapshot = snapshot_corpus(got["corpus"], os.path.join(tmp, "corpus_p3"))
            lib = phase_library(rng, tmp, got)
            check_healthy("4")
            launches.update(lib["launches"])
            lap("4")
        if args.stop_after >= 5:
            read = phase_read_side(rng, lib)
            check_healthy("5")
            launches.update(read["launches"])
            kernels.append(read["h1"])
            lap("5")
        if args.stop_after >= 6:
            labels = phase_labeler(rng, tmp, lib)
            check_healthy("6")
            launches.update(labels["launches"])
            lap("6")
        if args.stop_after >= 7:
            training = phase_training(rng, tmp)
            check_healthy("7")
            launches.update(training["launches"])
            lap("7")
        if args.stop_after >= 8:
            seam = phase_device_seam(rng, tmp, got, lib, snapshot, name_power)
            launches.update(seam["launches"])
            lap("8")
        if args.stop_after >= 9:
            plane = phase_execution_plane(tmp, snapshot)
            launches.update(plane["launches"])
            lap("9")
        if args.stop_after >= 10:
            other = phase_decoders(rng, tmp, name_power)
            launches.update(other["launches"])
            lap("10")
        if args.stop_after >= 11:
            api = phase_api(rng, tmp, {**lib, "images": lib["images"][:N_IMAGES]})
            launches.update(api["launches"])
            lap("11")
        if args.stop_after >= 12:
            obs = phase_observability(rng, tmp)
            launches.update(obs["launches"])
            lap("12")
        if args.stop_after >= 13:
            verdicts = phase_verdicts(rng, tmp)
            launches.update(verdicts["launches"])
            lap("13")
        if args.stop_after >= 14:
            then = phase_replica(rng, tmp) if args.stop_after >= 15 else None
            live = phase_live(rng, tmp, lib, then)
            launches.update(live["launches"])
            if then is not None:
                launches.update(report_replica(live["then"])["launches"])
            lap("14" if then is None else "14 and 15")  # 15 runs on 14's Node
        if args.stop_after >= 16:
            launches.update(report_p2p(phase_p2p(rng, tmp, snapshot))["launches"])
            lap("16")
        if args.stop_after >= 17:
            launches.update(report_node_p2p(phase_node_p2p(tmp, snapshot))["launches"])
            lap("17")
        if args.stop_after >= 18:
            launches.update(report_cloud_sync(phase_cloud_sync(tmp, snapshot))["launches"])
            lap("18")
        if args.stop_after >= 19:
            launches.update(report_api_serve(phase_api_serve(tmp, snapshot))["launches"])
            lap("19")
        if args.stop_after >= 20:
            launches.update(report_mesh_work(phase_mesh_work(tmp, snapshot))["launches"])
            lap("20")
    lap("cleanup")
    print(json.dumps({"wall_s": {"phases": phase_s,
                                 "smoke": time.perf_counter() - _T_START}}), flush=True)
    # launches on the main paths, each counted from 0 just before it
    kernel["launches_by_path"] = launches
    kernel["launches"] = sum(launches.values())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
