#!/usr/bin/env python3
"""Smoke run of minio_tpu_torch on one CUDA card.

    python3 chip_smoke.py            (from the repository root)

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. The card's name and power limit; build every CUDA kernel from
   minio_tpu_torch/ops/csrc/ (one nvcc per source, started together).
2. Every kernel against its plain PyTorch version on the card, exact
   byte equality, at the shapes the main path gives it: gf_apply at the
   EC 8+4 PUT window (32 x 8 x 128 KiB, byte and u32 contracts), at the
   4 x 8 decode rows, at ragged lengths and at the batcher's 256-block
   bucket (a sample of 8 batch rows), at r = 5..8 (two row groups of its
   row-packed tables), at k = 15 (two groups of shard loads), at bucket
   8, into the framer's strided out= and from an unaligned base;
   highwayhash256 at 1, 12, 96 and 384
   streams x 128 KiB, at 3,072 (16 sampled rows), at the edges of its
   shared-memory ring's stages, at ragged lengths, on framed rows hashed
   from byte 32 and from an unaligned base, and against the host numpy
   hash; rs_i8 at the 32-block window in words (parity and decode rows),
   at ragged word counts, at k = 12, 15 and 16 with r = 1, 4 and 32 (the
   widest matrix: one full 128-bit K, 8 row groups), at ragged byte
   lengths, from an unaligned base, and against gf_apply at 256 blocks;
   then the golden erasure and HighwayHash self-tests through the card.
3. The main path, one client: the S3 server (minio_tpu_torch.server) on
   12 drives, EC 8+4, device cuda, in this process (here and in 4-4d
   with its periodic scanner off: those phases take drives away by hand
   and compare heals with copies). PUT a 256 MiB, a
   33 MiB + 777 B and a 200 KiB object over signed HTTP, GET each back;
   wipe the copies of 4 data-shard drives and GET again; flip one byte of
   a data-shard block and GET again. Byte identity every time. Ranged
   GETs (206, Content-Range) inside a window and across two windows,
   healthy and with the 4 drives wiped; one aws-chunked
   (STREAMING-AWS4-HMAC-SHA256-PAYLOAD) PUT read back byte for byte. The
   256 MiB object again as a body streamed in 1 MiB writes, signed and
   UNSIGNED-PAYLOAD; a 40 MiB PUT with an x-amz-checksum-crc32 header and
   one with a CRC32 aws-chunked trailer (STREAMING-UNSIGNED-PAYLOAD-
   TRAILER), each read back with x-amz-checksum-mode: ENABLED; a wrong
   CRC32 answered 400 XAmzContentChecksumMismatch with the key absent; a
   GET stream closed after its first window. After the phase no lease of
   the card's pinned pool is outstanding.
4. The main path, concurrent: a fresh server as in 3, with the default
   MTPU_BATCH_FORCE. 16 client threads each PUT 6 objects (1 MiB,
   3 MiB + 5 B, 8 MiB, twice) whose keys share one `hash_order`; 16
   threads GET all 96; the copies on the 4 drives holding data shards 0-3
   are wiped and 16 threads GET all 96 again. Byte identity every time;
   on each of the put, get and reconstruct routes at least one device
   dispatch carried 2 or more requests' windows, no window went to the
   host, and no deadline culled a member; no pool lease is outstanding
   after the phase. Each route's kernel-lane
   dispatches are read as round trip, queue wait and service apart. Then
   each route's device function alone, with no request threads, at every
   bucket that route used (host clock): the yardstick for the lane's
   service under load, weighted by the phase's own bucket counts.
   Phases 3 and 4 run with the MRF heal queue closed on their sets.
4b. Multipart and healing: a fresh server as in 3, MRF open. BASELINE
   configs[4]: 16 clients each upload one 5 MiB part of one upload at
   once (80 MiB), then complete it. The AWS CLI's defaults: a 256 MiB
   object as 32 parts of 8 MiB, 10 in flight, completed; GET whole, 3
   ranges across part boundaries, HEAD with the -32 ETag, beside a
   256 MiB single-part PUT and GET; InvalidPart, EntityTooSmall and
   NoSuchUpload after an abort. BASELINE configs[3], heal, on copies of
   the drives taken first: one data-shard drive wiped, the single-part
   object healed by the MRF queue a GET filled (deep, as the JAX
   package's MRF heals) and the multipart one by the admin heal in
   normal mode; then two data and two parity drives wiped of both and
   healed by POST /minio/admin/v3/heal?deep=true, polled. After each
   heal the healed drives' shard files and journal fields equal the
   copies, and a GET with 4 other drives wiped (MRF stopped) returns the
   bytes. Wall time and MiB/s of each operation, the phase's launches,
   0 pool leases outstanding.
4c. The bucket namespace, on phase 4b's server with a fresh MRF queue
   (stopped while drives are taken away by hand). A bucket with
   versioning Enabled: three 256 MiB PUTs to one key give three version
   ids; each GET by versionId is exact, the oldest again with 4 data
   drives away (reconstruct); a DELETE writes a marker (GET 404 with
   x-amz-delete-marker, HEAD of its id 405), whose DELETE brings the
   newest back; the oldest version's DELETE removes its data dir from
   all 12 drives; two PUTs after Suspended replace the null version and
   leave the Enabled-era ones. CopyObject of phase 4b's 256 MiB
   single-part and multipart objects into the bucket, exact, a deep
   heal_object of each copy finding every shard good; an UploadPartCopy
   upload of the first 64 MiB, 40 MiB across two 32 MiB windows and the
   last 5 MiB + 777 B of the single-part object beside an uploaded 5 MiB
   part, exact. 16 clients PUT 1,200 keys of 1 KiB
   (dir00..49/obj000..023) into an unversioned bucket, their commits
   coalescing in the group-commit lanes (at least one batch of 2 or
   more members, no demotion, no deadline cull; batches, members a
   batch, solo bypasses, demotions and fsyncs saved printed);
   ListObjectsV2 in pages of 1000 (continuation tokens), then the same
   listing again, which must be served from the walk stream (metacache
   hits up, walks started unchanged), with delimiter / (50 prefixes,
   the shallow walk), with prefix dir42/, V1 with a marker inside
   dir07/, and ListObjectVersions of the versioned bucket in pages of 2
   equal what was written; the metacache stats and the journal-summary
   counters are printed. The deep listing again with one drive away,
   and after 3 drives missed a DeleteObjects of a tenth of the keys it
   lists none of them (each of these listings bumps the bucket first:
   drives moved by hand are no mutation the set sees, and a fresh walk
   meets the next rotation of walked drives). DeleteBucket refuses both buckets
   (409) until every version, marker and key is deleted; then no file
   of theirs is left on any drive. MiB/s of the versioned PUTs, GETs by
   version id and copies, keys/s of the PUTs, the deep listing (first
   and repeated) and DeleteObjects, the phase's launches, 0 pool leases
   outstanding after 4b and 4c.
4d. A crash with group-commit WALs live: `python -m
   minio_tpu_torch.server --device cuda` in a subprocess on 12 fresh
   drives with MTPU_GROUP_COMMIT_CKPT_S=3600, so that no checkpoint
   retires a frame; 16 clients PUT 1 KiB keys and DELETE every 4th
   after its PUT; SIGKILL after 500 acknowledged PUTs; the server
   booted again on the same drives in this process. Its boot recovery
   must replay WAL frames on every drive; every acknowledged key reads
   back its bytes and is listed, no key whose DELETE was acknowledged
   is read or listed, and no pool lease is outstanding.
4e. The drive plane: `python -m minio_tpu_torch.server
   --scanner-interval 1` in a subprocess on 12 fresh drives (the drive
   health wrapper on, as by default). Every drive gets format.json with
   one layout, /minio/health/ready answers 200. 16 clients load 512 MiB
   of 16 MiB objects, 64 MiB + 1 B, a multipart of 8 x 8 MiB, 100 keys
   of 1 KiB and a versioned bucket of 20 keys x 3 versions with 10
   delete markers. Replaced at boot: the server stops cleanly, drive 3 is
   copied, wiped and the server restarted: drive 3 must be adopted into
   slot 3 and marked healing, /ready answer 503 naming set 0 with one
   healing drive while GETs of the preloaded keys return their bytes;
   once the drive lifecycle manager's bulk heal reports done, /ready is
   200, and every shard file of drive 3 equals the copy byte for byte
   and its journals as version lists. Replaced while serving: 16 clients
   PUT and GET 1 MiB objects (8 pairs each, 0.25 s apart) while drive 7
   is wiped; its format must be restored within two polls and its bulk
   heal converge with no request failing; every acknowledged key reads
   back, and (in this process) a second heal of every version of every
   key heals nothing. A hung drive, in this process: an ErasureSet over
   wrap_disks(op_timeout=1.0, bulk_timeout=1.0) with one drive asleep
   30 s on every call; a 16 MiB PUT and its GET each finish within the
   deadline plus a healthy PUT's time, the breaker opens after 3 faults
   and then fails calls in under 10 ms, the half-open probe readmits the
   drive once the sleep is lifted, and a deep scan cycle (1 in 1) finds
   and rebuilds a flipped byte. The scanner, on the phase's drives in
   this process: a cycle's usage equals what the phase wrote (objects,
   versions, delete markers, bytes), and a cycle rebuilds one drive's
   copy of a key with no client read. Time to heal each replaced drive,
   MiB/s written to it and objects/s, the launches (the servers' while
   serving, read from their clean-stop line, and this process's; gf_apply
   by its number of rows), 1 KiB PUT keys/s from 16 clients with
   --drive-timeout 10 and 0 (fresh servers, turns 10/0), and 0
   pool leases outstanding.
   Phases 3-4e run with MTPU_FILEINFO_CACHE=off and MTPU_HOT_CACHE=off
   (they take drives away by hand and read: a cache hit would answer
   for the drives) and MTPU_HTTP_WORKERS=1 (their servers are one
   process; 4d's SIGKILL must hit the server itself).
4f. The pre-forked fleet: `python -m minio_tpu_torch.server
   --scanner-interval 0` with MTPU_HTTP_WORKERS=4 and both caches on,
   on 12 fresh drives (EC 8+4), in its own session. The parent holds no
   CUDA context (no /dev/nvidia* descriptor; nvidia-smi's compute apps
   and the device memory used are printed) and each of the 4 workers
   holds one. 16 clients' 1 KiB PUT keys/s and 1 MiB PUT+GET MiB/s on
   the fresh drives. Phase 4's 96 objects PUT by 16 clients, each
   request on a fresh connection so that SO_REUSEPORT spreads them, and
   GET back byte for byte. Worker 3 SIGKILLed while 16 clients read
   (retrying a cut connection): the parent respawns it and its new pid
   holds a context within 30 s, no read failing. 40 coherence rounds,
   alternating a 1 KiB and a 1 MiB key: PUT new bytes, 8 GETs on fresh
   connections return them; DELETE, 8 GETs answer 404; PUT again, a
   listing from a fresh connection names the key; 0 stale reads. Before
   the SIGKILL, the observability plane across the fleet: an admin
   trace subscriber on one worker receives the entries of 64 HEADs sent
   on fresh connections from all 4 workers (the parent's trace pump),
   and two scrapes of /minio/v2/metrics/cluster through fresh
   connections each count all 64 (every worker's snapshot, merged).
   SIGTERM to the parent: it exits 0 within 20 s, every worker printed
   its launches (each must have launched gf_apply and highwayhash256)
   and every drive carries the clean-shutdown stamp. Then the same two
   aggregates from one worker on fresh drives, printed beside the
   card's name, power limit and the host's cores.
4g. Pools of erasure sets: `python -m minio_tpu_torch.server` with
   MTPU_HTTP_WORKERS=2, both caches on and MTPU_REBALANCE_WORKERS=4, on
   `ROOT/p1/d{1...24}`: one pool of 2 sets x 12 at EC 8+4. 16 clients
   load 12 objects of 16 MiB (4e's size), 64 MiB + 1 B, a multipart of
   8 x 8 MiB, 20 keys of 1 KiB, and 20 keys x 3 versions with 10 delete
   markers in a versioned bucket; every key's journal must lie on the
   12 drives of the set the port's sip_hash_mod names under the
   deployment id; 16 clients' 1 KiB PUT keys/s. SIGTERM; restarted with
   `ROOT/p2/d{1...16}` added (MinIO's documented expansion): pool 2 is
   1 x 16 at EC 12+4 under pool 1's deployment id, every key and version
   reads back, and the 1 KiB PUT rate on 2 pools is printed beside the
   one on 1. `rebalance-start` until complete, then (after a restart on
   the same pools) `decommission?pool=0` until complete, each while 16
   clients overwrite 2 keys each with 1 MiB PUT+GET pairs 0.25 s apart
   and read a preloaded 1 KiB key: 0 failed and 0 stale reads; each
   walk's keys and bytes moved, wall, keys/s and MiB/s, and its server's
   gf_apply launches by (k, r), which must include k = 12. No journal
   is left on pool 1's drives. Restarted on pool 2 alone: every key and
   version (ids and ETags), the live clients' last acknowledged bodies
   among them, reads back byte for byte. The shard files of every sixth
   migrated 16 MiB object (two) and of the 64 MiB + 1 B one on pool 2's drives equal
   the 12+4 encode and digests of the plain PyTorch path on the CPU
   (computed on a thread while the servers run). The phase's drives are
   removed afterwards.
4h. Four nodes, one set (MinIO's "Deploy MinIO: Multi-Node Multi-Drive",
   `minio server https://minio{1...4}.example.net:9000/mnt/disk{1...4}/minio`):
   four `python -m minio_tpu_torch.server` processes on 127.0.0.1
   (ports P0-P3, grid ports +1000), each given the same 16 explicit
   http:// endpoints ROOT/h/n<i>/d<j>, boot one set of 16 at EC 12+4;
   node 0 with MTPU_HTTP_WORKERS=2, the others 1; both caches on,
   behind the cross-node coherence gates: after boot every node's
   worker 0 reports 3 of 3 peers armed and node 0's sibling its gate
   open (GET /minio/admin/v3/info). 16 clients, client t through node t
   mod 4, load 8 x 16 MiB, 64 MiB + 1 B, a 4 x 8 MiB multipart and 50
   keys of 1 KiB; every key is read back through the node after its
   writer: 0 lost, 0 differing. An armed GET (admin trace
   ?types=all on node 0) of a 16 MiB object through node 0: its tree
   holds `wire` spans with the subtrees of the other nodes it read from
   (two or more) stitched under them, each span tagged with its node; /minio/v2/metrics/cluster
   ?cluster=true through node 0 carries minio_tpu_cluster_node_up 1 for
   the 4 nodes. 8 keys of 1 MiB and 64 KiB are
   overwritten through node 1 in 4 rounds and read and HEAD through
   nodes 0 (both workers), 2 and 3: 0 stale, with fileinfo-cache and
   hot-cache hits on nodes 2 and 3 and on both of node 0's workers
   (printed); 16 clients' 1 KiB PUT rate over the four nodes, each PUT's
   bump pushed to 3 peers and acked. 16 clients overwrite 8 keys of 64 KiB
   through all four nodes for 5 s: each key then reads as one whole
   written body, the same from every node. Node 3 is SIGKILLed under 16
   clients' paced 1 MiB PUT+GET pairs on nodes 0-2: no request fails;
   the pairs' p50/p99 before and after the kill and the GET p50/p99
   with node 3 down are printed, and every key reads back through
   nodes 0-2 (decode rows); every gate of nodes 0-2 is then shut. Node
   2 SIGKILLed too: a PUT and a GET answer 503 within the 10 s drive
   deadline, and an armed grid trace on node 0 shows the calls the
   kills cut as `wire` spans tagged with a fault. Nodes 2 and 3 restart (time until they serve), an admin
   heal through node 3 brings every key written while node 3 was down
   to its drives, every node is armed again (nodes 0 and 1 through new
   resyncs) and the overwrite rounds show 0 stale; node 0 SIGKILLed,
   every key reads back byte for byte through nodes 1-3. Nodes 1-3
   stop cleanly and print their launches, their dsync locks (taken,
   refused, acquire histogram) and their grid peers' breakers: node 1's
   breaker to node 3 must have opened after the kill, and the time from
   the kill to its opening and the calls it failed fast are printed.
   The same load on one node of 16 local drives at EC 12+4, served by
   5 workers as the four nodes serve from 5 processes, gives the PUT
   and GET MiB/s and the 1 KiB PUT rate the distributed ones are printed
   against. gf_apply must have launched at k = 12 with parity rows and
   with decode rows on the nodes.
4i. A distributed expansion and decommission (MinIO's "Expand a
   Distributed MinIO Deployment", `minio server
   https://minio{1...4}.example.net/mnt/disk{1...4}/minio
   https://minio{5...8}.example.net/mnt/disk{1...4}/minio`, then `mc
   admin rebalance` and "Decommission a Server Pool"): four processes on
   127.0.0.1, each serving its 4 drives of each pool (both 1 x 16 at EC
   12+4), node 0 with 2 workers, both caches on, MTPU_GRID_LOCK_TTL=6,
   MTPU_ELASTIC_JANITOR_S=1, MTPU_MIG_BATCH=1. 16 clients over the
   nodes load pool 1 with 16 x 16 MiB, 64 MiB + 1 B, 10 x 1 KiB and 5
   keys x 3 versions with 3 delete markers. The four restart with pool
   2 appended; a rebalance started through node 2 is read through node
   3 while it runs, its live state ahead of the checkpoint on the
   drives, and stopped through node 1 (paused, or complete). Pool 1 is
   decommissioned through node 1 under 16 paced 1 MiB PUT+GET clients
   on nodes 0, 2 and 3 (started once the start answered, so their keys
   land in pool 2); node 1, the coordinator, is SIGKILLed after 12
   keys moved; a survivor's janitor resumes the walk once the lease
   lapsed (the seconds from the kill are printed, and the keys, bytes
   and seconds of the walk after the resume apart) and the drain ends
   "complete", with `mig.page` batches served by at least two nodes
   (counts by node from their clean stops). 0 failed and 0 stale client
   requests; no journal left on pool 1's drives of nodes 0, 2, 3. The
   four restart on pool 2 alone, an admin heal through node 1 brings
   its drives up to date, and every key and version reads back byte
   for byte through each node. gf_apply must have launched at
   k = 12, r = 4 on the nodes. The nodes of both pools run with
   MTPU_SLOW_OP_MS=100; printed only: the ten span names with the most
   summed time among the records the survivors logged for spans that
   started after the resume, and the slowest record's ancestry.
4j. The front end every server phase above serves through (the event
   loop, the default): a server on 12 drives, EC 8+4, with the
   MTPU_HTTP_KEEPALIVE_S=2 and MTPU_MAX_CONNS=16 of its environment: a
   partial request head is closed by the 2 s idle deadline without being
   dispatched, and the 17th connection is answered 503 + Retry-After
   before it sends a byte. Then a server on 12 fresh drives with the hot
   cache on: with the soft RLIMIT_NOFILE raised to the hard one, N =
   min(2,000, (hard - 512) / 2) keep-alive connections each get one
   answer and park, the server holding 0 recv leases, then each GETs a
   64 KiB object, identical. 16 GETs pipelined on one connection come
   back in order; a 64 MiB aws-chunked PUT goes through the pooled
   decoder and a reader with a 256 KiB receive buffer gets it back
   identical, its last window left to the loop (offloads > 0), the
   pinned pool and the recv pool back to idle; a GET with 2 data-shard
   drives away reconstructs on the card from a loop dispatch; 16 hot
   4 KiB GETs are answered on the loop thread (as many hot hits, no
   dispatch). 1 KiB PUT keys/s and hot 4 KiB GETs/s of 64 keep-alive
   clients through the loop, then through MTPU_HTTP_EVENTLOOP=off on the
   same drives, printed beside the card's name, power limit and the
   host's cores. gf_apply and highwayhash256 must have launched.
4k. The power cut (minio_tpu_torch/storage/crashdisk.py, the double the
   crash-point matrix of tests/test_torch_crash_matrix.py runs on the
   CPU): an ErasureSet in this process over 12 CrashDisk-wrapped drives,
   EC 8+4, device cuda. A 2 MiB + 777 B overwrite of a non-inline object
   is cut at its durable sub-steps (each drive's shard stream, its
   staging cleanup, the data dir's move, the kept journal's link, the
   journal, the directory's sync, the settle's drop of the kept journal
   and its reclaim of the old data dir) in tear mode at every one and in
   drop mode at every other one; then the heal commit of one
   wiped data-shard drive at each of its sub-steps in drop mode; a
   multipart completion over the key (one 2 MiB + 777 B part) at every
   CUT_MP_STRIDE-th sub-step and four concurrent inline overwrites
   committed as one lane batch a drive at every CUT_LANE_STRIDE-th, both
   in drop mode (an acknowledged member must read its new body). After
   each cut: recover_drives (the deep sweep on all 12, no live WAL
   frame), a GET through the card giving the old or the new object (the
   new one once the PUT was acknowledged; the old one at every cut of
   the heal), the same answer after the heals recovery listed, no tmp/
   or staging/ entry left, every pooled lease back. The points walked by
   mode, the fired_op names with their counts and the wall time are
   printed; gf_apply with parity rows and with r = 1 and highwayhash256
   must have launched.
4l. The observability plane: the S3 server in this process on 12
   drives, EC 8+4, with MTPU_SLOW_OP_MS=50 and drive 5's journal
   commits delayed 80 ms (4e's SleepyDisk under its health wrapper); an
   admin trace?types=all subscriber; a profile started. 16 clients for
   8 s, each round a 1 MiB PUT and its GET, a GET of one of 16 1 MiB keys
   with data shards on drives 2 and 9, whose copies are moved away
   (decode rows), and a 1 KiB PUT (the lanes), 100 ms apart (paced, so
   that the subscriber keeps up). Every 1 MiB PUT's tree has a write
   span of each of the 12 drives under the request; every 1 MiB PUT
   and GET has a `batcher.dispatch` kernel span whose lane_ms (CUDA
   events on the lane's stream around the dispatch) is above 0 and
   within its service_ms (the lane's host clock around the same call)
   plus 0.25 ms, and service_ms within the span; every degraded GET one
   whose op is reconstruct; a slow-op record names the delayed drive;
   the scrape parses as Prometheus text and its per-API counts over the
   load equal the requests sent; admin info's SLO snapshot has the GET
   and PUT objectives; speedtest answers; the downloaded profile is a
   zip whose local/profile.txt names put_object. Then two unpaced
   windows of the same rounds from 16 clients, OBS_UNPACED_S each,
   disarmed and then armed (a types=all subscriber): printed, no claim,
   the rounds, the 1 MiB PUT and GET p50 of each, and for the armed one
   the entries received, the whole request trees among them and the
   entries the server dropped for the subscriber. Then 0 pooled leases
   are out. Printed, no claim: one-thread 1 KiB and 1 MiB PUT p50,
   disarmed and armed, two turns each, in one run.
5. B5's own entry point (python -m minio_tpu_torch.experiments.rs_i8_kernel):
   rs_i8 against make_encoder32, the mma rate probe (binary m16n8k128
   and s8 m16n8k32 mma.sync, with the time each shape's product needs at
   256 blocks), then both kernels timed at 256 blocks.
   In phases 3, 4, 4b, 4c, 4d (the restarted server), 4e, 4f, 4g, 4h,
   4j, 4k, 4l and 5 every kernel's launch count is set to 0 just before the phase
   and read just after (4e's servers, 4f's and 4g's workers and 4h's
   nodes count from their start, less their boot self-tests; a
   SIGKILLed node's are not counted); each kernel of the phase's path
   must have launched, in 4e gf_apply with one row (r = 1), in 4f in
   every worker, in 4g and 4h at k = 12. Each phase's wall time is
   printed on a line of its own.
6. Times: each kernel at the main path's shapes with CUDA events (inputs
   rotated over buffers larger than L2), its plain version's time and
   its bound; gf_apply at 8, 32 and 256 blocks (parity rows) and at 32
   (the decode rows of 4 lost data shards and of 1), each also queued
   behind a spin kernel, which hides the host's launch time; rs_i8 at 32
   and 256 blocks, also queued; highwayhash256 at
   1, 12, 96, 384 and 3,072 streams x 128 KiB, each beside its bound and
   against the 1-stream time, the floor of its packet recurrence.

The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import http.client
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import zlib

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT32_OPS_PER_S = 67e12        # H100 SXM 32-bit rate outside tensor cores
INT8_TC_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core rate
MIB = 1 << 20
K, M = 8, 4
SHARD = (1 << 20) // K         # EC 8+4 shard block of a 1 MiB erasure block


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def log(*parts) -> None:
    print(*parts, flush=True)


class Timer:
    """CUDA-event time of fn(i) in ms: warm-up, then the mean of `iters`.
    queued=True first puts a spin kernel on the stream, so the launches
    queue behind it and a launch shorter than its host-side call is timed
    on the device, not at the host's pace."""

    SPIN_CYCLES_PER_ITER = 200_000      # ~0.1 ms at the H100's clocks

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, iters: int, warmup: int = 2,
                 queued: bool = False) -> float:
        torch = self.torch
        for i in range(warmup):
            fn(i)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(self.SPIN_CYCLES_PER_ITER * iters)
        e0.record()
        for i in range(iters):
            fn(i)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters


def max_abs_err(torch, a, b) -> int:
    """Largest byte difference of two results compared as bytes (a u32
    word result is compared through its little-endian byte view)."""
    a, b = a.view(torch.uint8), b.view(torch.uint8)
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.int() - b.int()).abs().max().item()) if a.numel() else 0


def decode_rows():
    from minio_tpu_torch.ops import gf256
    return np.ascontiguousarray(
        gf256.decode_matrix(K, M, tuple(range(4, 12)))[:4])


def hh_shape(s: int, length: int, sms: int, base: int = 0,
             stride: int | None = None) -> str:
    """hash_rows' launch shape for s rows of `length` bytes, as text."""
    from minio_tpu_torch.ops import hh_device
    sh = hh_device.launch_shape(s, length, sms, base,
                                length if stride is None else stride)
    return (f"[{sh.blocks} blocks x <= {sh.streams_per_block} streams, "
            f"{sh.threads} threads, {sh.stages} stages x {sh.stage_bytes} B, "
            f"{sh.smem_bytes} B shared]")


def phase_kernels(torch, dev, rng, errs):
    from minio_tpu_torch.erasure.selftest import erasure_self_test
    from minio_tpu_torch.experiments import rs_i8_kernel
    from minio_tpu_torch.ops import gf256, hh_device, rs_device
    from minio_tpu_torch.storage import bitrot
    from minio_tpu_torch.utils.highwayhash import MAGIC_KEY, highwayhash256_many

    def rand(*shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape,
                                             dtype=np.uint8)).to(dev)

    def note(kern, what, err):
        log(f"{kern} {what} max_abs_err {err}")
        errs[kern] = max(errs[kern], err)

    pm = gf256.parity_matrix(K, M)
    dec = decode_rows()
    window = rand(32, K, SHARD)
    cases = [("parity u8", pm, window), ("decode rows", dec, window),
             ("parity ragged 98", pm, rand(1, K, 98)),
             ("parity ragged 1543", pm, rand(3, K, 1543)),
             ("decode ragged 3200", dec, rand(1, K, 3200))]
    for what, mat, data in cases:
        note("gf_apply", f"{what} {tuple(data.shape)}", max_abs_err(
            torch, rs_device.gf_apply(mat, data),
            rs_device.gf_apply_plain(mat, data)))
    out32 = rs_device.make_encoder32(pm)(window.view(torch.int32))
    note("gf_apply", f"parity u32 {tuple(out32.shape)}", max_abs_err(
        torch, out32, rs_device.gf_apply_plain(pm, window)))
    bucket = rand(256, K, SHARD)
    full = rs_device.gf_apply(pm, bucket)
    rows = torch.from_numpy(np.sort(rng.choice(256, size=8, replace=False))
                            ).to(dev)
    note("gf_apply", "256-block bucket, 8 sampled batch rows",
         max_abs_err(torch, full.index_select(0, rows),
                     rs_device.gf_apply_plain(pm, bucket.index_select(0,
                                                                    rows))))
    # Two row groups (r = 5..8), a second group of shard loads (k = 15),
    # the batcher's bucket 8, the framer's strided out= into [B, 12, L]
    # and a base that is not 16-byte aligned (the byte path at full width).
    cases = [(f"parity {K}+{r}", gf256.parity_matrix(K, r),
              rand(2, K, SHARD)) for r in range(5, 9)]
    cases += [("parity 8+7 ragged 1543", gf256.parity_matrix(K, 7),
               rand(3, K, 1543)),
              ("parity 15+4", gf256.parity_matrix(15, 4), rand(4, 15, SHARD)),
              ("parity 15+6 ragged 3200", gf256.parity_matrix(15, 6),
               rand(2, 15, 3200)),
              ("parity bucket 8", pm, rand(8, K, SHARD)),
              ("decode rows bucket 8", dec, rand(8, K, SHARD)),
              ("parity unaligned base", pm,
               rand(2 * K * SHARD + 3)[3:].view(2, K, SHARD))]
    for what, mat, data in cases:
        note("gf_apply", f"{what} {tuple(data.shape)}", max_abs_err(
            torch, rs_device.gf_apply(mat, data),
            rs_device.gf_apply_plain(mat, data)))
    shards = rand(32, K + M, SHARD)
    rs_device.gf_apply(pm, shards[:, :K], out=shards[:, K:])
    note("gf_apply", f"strided out= into {tuple(shards.shape)}", max_abs_err(
        torch, shards[:, K:], rs_device.gf_apply_plain(pm, shards[:, :K])))
    del cases, shards
    torch.cuda.synchronize()

    words = window.view(torch.int32)                       # [32, 8, 32768]
    for what, mat in (("parity", pm), ("decode rows", dec)):
        note("rs_i8", f"{what} words {tuple(words.shape)}", max_abs_err(
            torch, rs_i8_kernel.rs_apply8(mat, words),
            rs_i8_kernel.rs_apply8_plain(mat, words)))
    for l4 in (1, 25, 1000):
        w = rand(3, K, 4 * l4).view(torch.int32)
        note("rs_i8", f"ragged words {tuple(w.shape)}", max_abs_err(
            torch, rs_i8_kernel.rs_apply8(pm, w),
            rs_i8_kernel.rs_apply8_plain(pm, w)))
    # k = 12, 15, 16 at r = 1, 4, 32; ragged byte lengths; unaligned base.
    cases = [(f"{k}+{r}", k, r, rand(4, k, SHARD))
             for k, r in ((12, 4), (15, 1), (16, 32), (16, 1), (8, 32))]
    cases += [(f"{k}+{r} ragged {n}", k, r, rand(3, k, n))
              for k, r, n in ((8, 4, 98), (16, 32, 1543), (15, 1, 3200))]
    cases += [("8+4 unaligned base", 8, 4,
               rand(2 * K * SHARD + 3)[3:].view(2, K, SHARD)),
              ("16+32 unaligned base ragged", 16, 32,
               rand(2 * 16 * 4001 + 5)[5:].view(2, 16, 4001))]
    for what, k, r, data in cases:
        mat = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
        note("rs_i8", f"{what} {tuple(data.shape)}", max_abs_err(
            torch, rs_i8_kernel.rs_apply8(mat, data),
            rs_i8_kernel.rs_apply8_plain(mat, data)))
    del cases
    bw = bucket.view(torch.int32)                          # [256, 8, 32768]
    note("rs_i8", f"vs gf_apply, words {tuple(bw.shape)}", max_abs_err(
        torch, rs_i8_kernel.make_encoder8(pm)(bw),
        rs_device.make_encoder32(pm)(bw)))
    del bucket, full, bw
    torch.cuda.synchronize()

    # highwayhash256 at 1, 12, 96 and 384 streams x 128 KiB: one plain run
    # over the 384 rows, the smaller launches hash its first rows.
    sms = hh_device.sm_count(dev)
    srows = rand(384, SHARD)
    t0 = time.perf_counter()
    plain = hh_device.hash_bytes_plain(srows)
    torch.cuda.synchronize()
    log(f"highwayhash256 plain version over (384, {SHARD}): "
        f"{time.perf_counter() - t0:.3f} s; card of {sms} SMs")
    for s in (1, 12, 96, 384):
        note("highwayhash256", f"({s}, {SHARD}) {hh_shape(s, SHARD, sms)}",
             max_abs_err(torch, hh_device.hash_rows(srows[:s]), plain[:s]))
    got = hh_device.hash_rows(srows)
    words = hh_device.hash_words(srows.view(torch.int32).view(32, 12, -1))
    note("highwayhash256", "u32 words (32, 12, 32768)",
         max_abs_err(torch, words, plain))
    host = highwayhash256_many(MAGIC_KEY, srows[:4].cpu().numpy())
    check(np.array_equal(got[:4].cpu().numpy(), host),
          "highwayhash256 differs from the host numpy hash")
    del srows, plain, got
    big = rand(3072, SHARD)        # the batcher's 256-block bucket
    pick = torch.from_numpy(np.sort(rng.choice(3072, size=16, replace=False))
                            ).to(dev)
    note("highwayhash256", f"(3072, {SHARD}) {hh_shape(3072, SHARD, sms)}, "
         "16 sampled rows", max_abs_err(
             torch, hh_device.hash_rows(big).index_select(0, pick),
             hh_device.hash_bytes_plain(big.index_select(0, pick))))
    del big
    # Stage edges through the ring: rows 16-byte multiples apart, lengths
    # of a stage +- 1, 16, 31 and 3 stages + 5, at 7 streams (4 KiB
    # stages) and 3,072 (2 KiB).
    for s in (7, 3072):
        stage, edge = hh_device.launch_shape(s, SHARD, sms).stage_bytes, 0
        for length in [stage + d for d in (-31, -16, -1, 1, 16, 31)] \
                + [3 * stage + 5]:
            r = rand(s, -(-length // 16) * 16)[:, :length]
            check(hh_device.launch_shape(s, length, sms, r.data_ptr(),
                                         r.stride(0)).stages > 0,
                  f"stage edge {length} missed the ring")
            edge = max(edge, max_abs_err(torch, hh_device.hash_rows(r),
                                         hh_device.hash_bytes_plain(r)))
        note("highwayhash256", f"stage edges of {stage} B at {s} streams",
             edge)
    ragged = 0
    for length in (1, 31, 33, 63, 98, 4097, SHARD + 5):
        r = rand(7, length)
        ragged = max(ragged, max_abs_err(torch, hh_device.hash_rows(r),
                                         hh_device.hash_bytes_plain(r)))
    note("highwayhash256", "ragged contiguous lengths", ragged)
    framed = rand(64, 32 + SHARD)
    note("highwayhash256", f"framed (64, 32 + {SHARD}) skip=32 "
         f"{hh_shape(64, SHARD, sms, 32, 32 + SHARD)}", max_abs_err(
             torch, hh_device.hash_rows(framed, skip=32),
             hh_device.hash_bytes_plain(framed[:, 32:])))
    framed = rand(10, 32 + 1000)
    unaligned = rand(12, 5 + 20000)
    note("highwayhash256", "framed (10, 32 + 1000) skip=32 and unaligned "
         f"base (12, 5 + 20000) skip=5 {hh_shape(12, 20000, sms, 5, 20005)}",
         max(max_abs_err(torch, hh_device.hash_rows(framed, skip=32),
                         hh_device.hash_bytes_plain(framed[:, 32:])),
             max_abs_err(torch, hh_device.hash_rows(unaligned, skip=5),
                         hh_device.hash_bytes_plain(unaligned[:, 5:]))))
    check(all(v == 0 for v in errs.values()), f"kernels disagree: {errs}")

    erasure_self_test(rs_device.GpuBackend(dev))
    bitrot.device_self_test(dev)
    torch.cuda.synchronize()
    log("golden erasure and HighwayHash self-tests through the card: ok")


class Client:
    """Header-SigV4 S3 requests with the port's own signer."""

    def __init__(self, address: str, access: str = "minioadmin",
                 secret: str = "minioadmin"):
        from minio_tpu_torch.s3 import sigv4
        self.sigv4, self.address = sigv4, address
        self.access, self.secret = access, secret

    def __call__(self, method: str, path: str, body: bytes = b""):
        return self.send(method, path, body)[:2]

    def send(self, method: str, path: str, body: bytes = b"",
             extra: dict | None = None, payload_hash: str | None = None,
             encode=None, query: dict | None = None
             ) -> tuple[int, bytes, dict]:
        """(status, body, lowercased response headers). encode(signed
        headers) -> the wire body, for bodies framed after signing;
        query: {name: value} of the query string."""
        q = {k: [v] for k, v in (query or {}).items()}
        uri, headers = self.sigv4.sign_headers(
            method, self.address, path, self.access, self.secret,
            payload_hash or hashlib.sha256(body).hexdigest(), query=q,
            extra=extra)
        if q:
            uri += "?" + urllib.parse.urlencode(
                [(k, v[0]) for k, v in q.items()])
        host, _, port = self.address.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=600)
        try:
            conn.request(method, uri, headers=headers,
                         body=body if encode is None else encode(headers))
            resp = conn.getresponse()
            return resp.status, resp.read(), {
                k.lower(): v for k, v in resp.getheaders()}
        finally:
            conn.close()

    def stream_put(self, path: str, body: bytes, signed: bool = True,
                   extra: dict | None = None, piece: int = MIB):
        """A PUT whose body goes out in `piece`-byte writes behind its
        Content-Length, signed (the body's SHA-256) or UNSIGNED-PAYLOAD:
        (status, body, headers)."""
        view = memoryview(body)
        return self.send(
            "PUT", path, extra={"content-length": str(len(body)),
                                **(extra or {})},
            payload_hash=hashlib.sha256(body).hexdigest() if signed
            else self.sigv4.UNSIGNED_PAYLOAD,
            encode=lambda _h: (view[i:i + piece]
                               for i in range(0, len(body), piece)))

    def trailer_put(self, path: str, body: bytes, crc: str,
                    chunk: int = 64 * 1024):
        """The SDKs' default upload shape: STREAMING-UNSIGNED-PAYLOAD-
        TRAILER aws-chunked frames and an x-amz-checksum-crc32 trailer."""
        def encode(_headers):
            out = bytearray()
            for i in range(0, len(body), chunk):
                part = body[i:i + chunk]
                out += f"{len(part):x}\r\n".encode() + part + b"\r\n"
            out += f"0\r\nx-amz-checksum-crc32:{crc}\r\n\r\n".encode()
            return bytes(out)
        return self.send("PUT", path, extra={
            "content-encoding": "aws-chunked",
            "x-amz-decoded-content-length": str(len(body)),
            "x-amz-trailer": "x-amz-checksum-crc32"},
            payload_hash=self.sigv4.STREAMING_UNSIGNED_TRAILER,
            encode=encode)

    def ranged_get(self, path: str, lo: int, hi: int):
        """GET bytes lo..hi: (status, body, Content-Range)."""
        st, body, h = self.send("GET", path, extra={"range":
                                                   f"bytes={lo}-{hi}"})
        return st, body, h.get("content-range")

    def chunked_put(self, path: str, body: bytes, chunk: int = 64 * 1024):
        """A STREAMING-AWS4-HMAC-SHA256-PAYLOAD PUT: `chunk`-byte frames,
        each signature chained from the previous, from the request's."""
        sigv4 = self.sigv4

        def encode(headers):
            amz_date, prev = headers["x-amz-date"], \
                headers["authorization"].rsplit("Signature=", 1)[1]
            scope = f"{amz_date[:8]}/us-east-1/s3/aws4_request"
            key = sigv4.signing_key(self.secret, amz_date[:8], "us-east-1")
            out = bytearray()
            for data in [body[i:i + chunk]
                         for i in range(0, len(body), chunk)] + [b""]:
                sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope,
                                 prev, sigv4.EMPTY_SHA256,
                                 hashlib.sha256(data).hexdigest()])
                prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
                out += f"{len(data):x};chunk-signature={prev}\r\n".encode()
                out += data + b"\r\n"
            return bytes(out)
        return self.send("PUT", path, extra={
            "content-encoding": "aws-chunked",
            "x-amz-decoded-content-length": str(len(body))},
            payload_hash=sigv4.STREAMING_PAYLOAD, encode=encode)


# Ranged GETs of phase 3: (object, first byte, last byte) inside one
# 32-block window and across the boundary of two.
WINDOW = 32 * MIB
RANGES = (("big", 1000, 2999), ("big", 3 * WINDOW - 1000, 3 * WINDOW + 500),
          ("mid", WINDOW - 5 * MIB - 7, WINDOW + 700))


def check_ranges(c: "Client", objs: dict, what: str) -> None:
    for name, lo, hi in RANGES:
        st, got, crange = c.ranged_get(f"/smoke/{name}", lo, hi)
        check(st == 206 and crange == f"bytes {lo}-{hi}/{len(objs[name])}"
              and got == objs[name][lo:hi + 1],
              f"{what} ranged GET {name} bytes={lo}-{hi}: {st} {crange}")


def drive_root() -> str:
    """Drives on /dev/shm where it has room, else under the temp dir."""
    if os.path.isdir("/dev/shm") and shutil.disk_usage("/dev/shm").free > 4 << 30:
        return tempfile.mkdtemp(prefix="chip_smoke-", dir="/dev/shm")
    return tempfile.mkdtemp(prefix="chip_smoke-")


class Server:
    """The port's S3 server on 12 drives under `root` (fresh, unless a
    phase left them), serving from a thread of this process until
    stop(); with mrf=False its MRF heal queue stays closed. Its periodic
    scanner is off (a phase that takes drives away by hand must not see
    them healed behind it); the drive health wrapper is on unless `args`
    says otherwise."""

    def __init__(self, root: str, name: str, mrf: bool = False,
                 device: str = "cuda", args: tuple = ()):
        from minio_tpu_torch import server
        self.drives = [os.path.join(root, name, f"d{i}") for i in range(12)]
        self.srv = server.boot(["--address", "127.0.0.1:0", "--device",
                                device, "--scanner-interval", "0", *args,
                                *self.drives])
        self.es = self.srv.objects.sets[0]
        self.es._mrf_closed = not mrf
        check(self.es.default_parity == M, "12 drives must give EC 8+4")
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.client = Client(self.srv.address)

    def stop(self) -> None:
        self.srv.shutdown()
        self.thread.join(timeout=60)


def reset_launches() -> None:
    from minio_tpu_torch.experiments import rs_i8_kernel
    from minio_tpu_torch.ops import hh_device, rs_device
    rs_device.LAUNCHES = hh_device.LAUNCHES = rs_i8_kernel.LAUNCHES = 0
    rs_device.LAUNCHES_BY_R.clear()


def read_launches() -> dict:
    from minio_tpu_torch.experiments import rs_i8_kernel
    from minio_tpu_torch.ops import hh_device, rs_device
    return {"gf_apply": rs_device.LAUNCHES,
            "highwayhash256": hh_device.LAUNCHES,
            "rs_i8": rs_i8_kernel.LAUNCHES}


def data_holders(bucket: str, key: str, count: int, first_shard: int = 0):
    """Drives holding data shards first_shard.. of the key's distribution."""
    from minio_tpu_torch.object.erasure_object import hash_order
    dist = hash_order(f"{bucket}/{key}", 12)
    return [i for i in range(12) if first_shard <= dist[i] - 1 < K][:count]


def phase_main_path(torch, rng, root):
    s = Server(root, "seq")
    es, c = s.es, s.client
    try:
        objs = {"big": rng.bytes(256 * MIB),
                "mid": rng.bytes(33 * MIB + 777),
                "small": rng.bytes(200 * 1024)}
        reset_launches()
        es.device_windows = dict.fromkeys(es.device_windows, 0)

        check(c("PUT", "/smoke")[0] == 200, "make bucket")
        times = {}
        for name, body in objs.items():
            t0 = time.perf_counter()
            st, _ = c("PUT", f"/smoke/{name}", body)
            times[("put", name)] = time.perf_counter() - t0
            check(st == 200, f"PUT {name}: {st}")
        for name, body in objs.items():
            t0 = time.perf_counter()
            st, got = c("GET", f"/smoke/{name}")
            times[("get", name)] = time.perf_counter() - t0
            check(st == 200 and got == body, f"GET {name} not identical")
        log(f"main path: PUT+GET of {len(objs)} objects identical, windows "
            f"{es.device_windows}")
        check_ranges(c, objs, "healthy")
        body = rng.bytes(5 * MIB + 3)
        st, _, h = c.chunked_put("/smoke/chunked", body)
        check(st == 200 and h.get("etag") == f'"{hashlib.md5(body).hexdigest()}"',
              f"aws-chunked PUT: {st} {h.get('etag')}")
        check(c("GET", "/smoke/chunked") == (200, body),
              "aws-chunked PUT did not read back identical")
        log(f"main path: {len(RANGES)} ranged GETs (inside a window, across "
            "two) answered 206 with the range; aws-chunked PUT of "
            f"{len(body)} B read back identical")
        streamed_and_checksummed(c, es, objs["big"], rng, times)

        before = es.device_windows["reconstruct"]
        moved = []
        for name in objs:
            for i in data_holders("smoke", name, 4):
                src = os.path.join(s.drives[i], "smoke", name)
                dst = os.path.join(s.drives[i], f"wiped-{name}")
                os.rename(src, dst)
                moved.append((dst, src))
        for name, body in objs.items():
            st, got = c("GET", f"/smoke/{name}")
            check(st == 200 and got == body,
                  f"degraded GET {name} (4 data drives wiped) not identical")
        check(es.device_windows["reconstruct"] > before,
              "degraded GET did not reconstruct on the card")
        before = es.device_windows["reconstruct"]
        check_ranges(c, objs, "4 data drives wiped")
        check(es.device_windows["reconstruct"] > before,
              "degraded ranged GET did not reconstruct on the card")
        for dst, src in moved:
            os.rename(dst, src)
        log("main path: GET and ranged GETs with 4 data-shard drives wiped "
            "identical")

        before = es.device_windows["reconstruct"]
        for name in ("big", "mid"):
            d = os.path.join(s.drives[data_holders("smoke", name, 1)[0]],
                             "smoke", name)
            (ddir,) = [e for e in os.listdir(d) if e != "xl.meta"]
            with open(os.path.join(d, ddir, "part.1"), "r+b") as f:
                f.seek(32 + 100)
                b = f.read(1)
                f.seek(32 + 100)
                f.write(bytes([b[0] ^ 0x01]))
            st, got = c("GET", f"/smoke/{name}")
            check(st == 200 and got == objs[name],
                  f"GET {name} with a flipped byte not identical")
        check(es.device_windows["reconstruct"] > before,
              "bitrot-demoted GET did not reconstruct on the card")
        log("main path: GET with one flipped shard byte identical")

        bad = Client(s.srv.address, secret="wrong-secret")
        check(bad("GET", "/smoke/small")[0] == 403, "bad signature not 403")

        launches = read_launches()
        windows = dict(es.device_windows)
        log(f"main path launches {launches} set windows {windows} host "
            f"windows {es.host_windows}")
        check(launches["gf_apply"] and launches["highwayhash256"],
              f"a kernel of the path never launched: {launches}")
        check(all(windows.values()), f"a device route never ran: {windows}")
        check(not any(es.host_windows.values()),
              f"windows went to the host: {es.host_windows}")
        size = len(objs["big"]) / MIB
        log(f"256 MiB object: PUT {size / times[('put', 'big')]:.1f} MiB/s, "
            f"GET {size / times[('get', 'big')]:.1f} MiB/s (host clock over "
            "signed HTTP on localhost, one client); streamed PUT signed "
            f"{size / times[('stream put', 'signed')]:.1f} MiB/s, "
            f"UNSIGNED-PAYLOAD "
            f"{size / times[('stream put', 'unsigned')]:.1f} MiB/s")
        return launches
    finally:
        s.stop()
        check_pool_idle("main path")


def check_pool_idle(what: str, device: str = "cuda") -> None:
    """Every pooled lease of the phase went back to the card's pool (a
    response's last lease returns just after its last byte is sent)."""
    from minio_tpu_torch.io.bufpool import global_pool
    pool = global_pool(device)
    t0 = time.perf_counter()
    while pool.stats()["outstanding"] and time.perf_counter() - t0 < 10:
        time.sleep(0.05)
    st = pool.stats()
    log(f"{what}: pinned pool {st}")
    check(st["outstanding"] == 0 and st["leaks"] == 0,
          f"{what}: {st['outstanding']} pool leases outstanding, "
          f"{st['leaks']} leaked after the phase")


def streamed_and_checksummed(c: "Client", es, big: bytes, rng,
                             times: dict) -> None:
    """Phase 3's streamed-body cases: the 256 MiB object PUT as a body
    streamed in 1 MiB writes, signed and UNSIGNED-PAYLOAD; a CRC32 header
    PUT and an aws-chunked trailer PUT read back with x-amz-checksum-mode;
    a wrong CRC32 refused with nothing committed; a GET stream closed
    after its first window."""
    etag = f'"{hashlib.md5(big).hexdigest()}"'
    for mode in ("signed", "unsigned"):
        t0 = time.perf_counter()
        st, _, h = c.stream_put(f"/smoke/stream-{mode}", big,
                                signed=mode == "signed")
        times[("stream put", mode)] = time.perf_counter() - t0
        check(st == 200 and h.get("etag") == etag,
              f"streamed {mode} PUT: {st} {h.get('etag')}")
        check(c("GET", f"/smoke/stream-{mode}") == (200, big),
              f"streamed {mode} PUT did not read back identical")
    body = rng.bytes(40 * MIB + 5)
    crc = base64.b64encode(zlib.crc32(body).to_bytes(4, "big")).decode()
    for kind in ("header", "trailer"):
        path = f"/smoke/crc-{kind}"
        if kind == "header":
            st, err, h = c.stream_put(path, body,
                                      extra={"x-amz-checksum-crc32": crc})
        else:
            st, err, h = c.trailer_put(path, body, crc)
        check(st == 200 and h.get("x-amz-checksum-crc32") == crc,
              f"CRC32 {kind} PUT: {st} {h.get('x-amz-checksum-crc32')} "
              f"{err[:200]!r}")
        st, got, h = c.send("GET", path,
                            extra={"x-amz-checksum-mode": "ENABLED"})
        check(st == 200 and got == body
              and h.get("x-amz-checksum-crc32") == crc,
              f"CRC32 {kind} PUT read back: {st} "
              f"{h.get('x-amz-checksum-crc32')}")
    st, err, _ = c.stream_put("/smoke/crc-wrong", body, extra={
        "x-amz-checksum-crc32": "AAAAAA=="})
    check(st == 400 and b"<Code>XAmzContentChecksumMismatch</Code>" in err,
          f"wrong CRC32 PUT answered {st}: {err[:200]!r}")
    check(c("GET", "/smoke/crc-wrong")[0] == 404,
          "a refused checksum PUT left its key behind")
    _, chunks = es.get_object_stream("smoke", "stream-signed")
    check(bytes(next(chunks)) == big[:WINDOW], "first GET window differs")
    chunks.close()
    from minio_tpu_torch.io.bufpool import global_pool
    out = global_pool("cuda").stats()["outstanding"]
    check(out == 0, f"GET closed after one window left {out} leases out")
    log("main path: 256 MiB streamed PUTs (signed, UNSIGNED-PAYLOAD) read "
        "back identical; CRC32 header and trailer PUTs stored and returned "
        f"with x-amz-checksum-mode; a wrong CRC32 answered 400 "
        "XAmzContentChecksumMismatch with nothing committed; a GET closed "
        "after its first window returned every lease")


CONC_THREADS = 16
CONC_SIZES = (MIB, 3 * MIB + 5, 8 * MIB, MIB, 3 * MIB + 5, 8 * MIB)


def conc_keys(bucket: str) -> list[list[str]]:
    """Per thread, one key per object; every key's hash_order over 12
    drives is the same, so one survivor set serves every degraded read."""
    want = zlib.crc32(f"{bucket}/t0-o0-0".encode()) % 12
    out = []
    for t in range(CONC_THREADS):
        keys = []
        for j in range(len(CONC_SIZES)):
            salt = 0
            while zlib.crc32(f"{bucket}/t{t}-o{j}-{salt}".encode()) % 12 \
                    != want:
                salt += 1
            keys.append(f"t{t}-o{j}-{salt}")
        out.append(keys)
    return out


def run_clients(fn, per_thread) -> float:
    """fn(thread_index, item) for each thread's items in turn, all threads
    started together; raises the first failure. Returns the wall time."""
    barrier = threading.Barrier(len(per_thread))
    errs = []

    def work(t, items):
        barrier.wait()
        try:
            for item in items:
                fn(t, item)
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(e)
    threads = [threading.Thread(target=work, args=(t, items))
               for t, items in enumerate(per_thread)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "a client hung")
    if errs:
        raise errs[0]
    return wall


def summarize(hist: dict) -> str:
    from minio_tpu_torch.utils.latency import summarize as summ
    s = summ(hist)
    return f"p50 <= {s['p50'] * 1e3:g} ms, p99 <= {s['p99'] * 1e3:g} ms " \
        f"(n={s['count']}, mean {hist['sum'] / max(1, hist['count']) * 1e3:.3f} ms)"


def phase_concurrent(torch, rng, root):
    """16 clients at once through the stripe batchers; returns (launches,
    stats) of the phase."""
    os.environ.pop("MTPU_BATCH_FORCE", None)      # the default: device
    s = Server(root, "conc")
    es, c = s.es, s.client
    try:
        bucket = "conc"
        check(c("PUT", f"/{bucket}")[0] == 200, "make bucket")
        keys = conc_keys(bucket)
        bodies = {j: rng.bytes(n) for j, n in enumerate(CONC_SIZES)}
        # Every thread's j-th object gets its own bytes: a prefix that names
        # the key in front of the shared random body of that size.
        objs = {keys[t][j]: keys[t][j].encode().ljust(64, b".")
                + bodies[j][64:]
                for t in range(CONC_THREADS) for j in range(len(CONC_SIZES))}
        total = sum(len(b) for b in objs.values()) / MIB
        reset_launches()

        def put(t, j):
            st, _ = c("PUT", f"/{bucket}/{keys[t][j]}", objs[keys[t][j]])
            check(st == 200, f"PUT {keys[t][j]}: {st}")

        def get(t, j):
            st, got = c("GET", f"/{bucket}/{keys[t][j]}")
            check(st == 200 and got == objs[keys[t][j]],
                  f"GET {keys[t][j]} not identical")
        items = [list(range(len(CONC_SIZES)))] * CONC_THREADS
        walls = {"put": run_clients(put, items),
                 "get": run_clients(get, items)}
        wiped = data_holders(bucket, keys[0][0], 4)
        moved = []
        for i in wiped:
            for key in objs:
                src = os.path.join(s.drives[i], bucket, key)
                dst = os.path.join(s.drives[i], f"wiped-{key}")
                os.rename(src, dst)
                moved.append((dst, src))
        walls["degraded get"] = run_clients(get, items)
        for dst, src in moved:
            os.rename(dst, src)
        launches = read_launches()
        stats = es.batcher_stats()

        log(f"concurrent: {CONC_THREADS} clients, {len(objs)} objects, "
            f"{total:.1f} MiB each pass, identical every time; wiped drives "
            f"{wiped} (data shards 0-3 of every key)")
        for what, wall in walls.items():
            log(f"concurrent {what}: {wall:.3f} s, {total / wall:.1f} MiB/s "
                "aggregate (host clock over signed HTTP on localhost)")
        for route in ("put", "get", "reconstruct"):
            r = stats["routes"][route]
            dev_d = r["dispatches"]["device"]
            log(f"batcher {route}: device dispatches {dev_d}, host "
                f"dispatches {r['dispatches']['host']}, members "
                f"{r['requests']}, mean {r['requests']['device'] / max(1, dev_d):.2f} "
                f"max {r['max_members']} members a dispatch, "
                f"{r['multi_member_dispatches']} with 2+, buckets "
                f"{dict(sorted(r['buckets'].items()))}, fill ratio "
                f"{r['fill_ratio']:.4f}, deadline culls "
                f"{r['deadline_failures']}")
            log(f"batcher {route}: coalescing wait {summarize(r['wait_hist'])}")
            for part in ("round_trip", "wait", "service"):
                log(f"batcher {route}: lane {part.replace('_', ' ')} "
                    f"{summarize(r[f'lane_{part}_hist'])}")
        lane = stats["lane"]
        log(f"kernel lane: {lane['submitted_total']} dispatches, service "
            f"{summarize(lane['service_hist'])}, rejected "
            f"{lane['rejected_total']}")
        log(f"concurrent launches {launches} set windows {stats['windows']}")
        for route in ("put", "get", "reconstruct"):
            r = stats["routes"][route]
            check(r["multi_member_dispatches"] >= 1,
                  f"no {route} dispatch carried 2+ requests' windows")
            check(r["dispatches"]["host"] == 0
                  and r["requests"]["host"] == r["requests"]["bypass"] == 0,
                  f"{route} windows went to the host: {r}")
            check(r["deadline_failures"] == 0, f"{route} deadline culls")
            check(stats["windows"]["host"][route] == 0,
                  f"{route} host windows")
        check(launches["gf_apply"] and launches["highwayhash256"],
              f"a kernel of the path never launched: {launches}")
        return launches, stats
    finally:
        s.stop()
        check_pool_idle("concurrent")


# Phase 4b: multipart uploads and healing.
CONF4_PARTS = 16          # BASELINE.json configs[4]: 16 concurrent 5 MiB parts
AWS_PART = 8 * MIB        # the AWS CLI's multipart_chunksize
AWS_INFLIGHT = 10         # the AWS CLI's max_concurrent_requests


def xml_tag(body: bytes, tag: str) -> str:
    start = body.find(f"<{tag}>".encode())
    end = body.find(f"</{tag}>".encode(), start)
    return body[start + len(tag) + 2:end].decode() if start >= 0 else ""


def mp_upload(c: "Client", path: str, parts: list, inflight: int) -> str:
    """One multipart upload of `parts`, `inflight` part PUTs at a time;
    returns the completed ETag after checking it."""
    st, body, _ = c.send("POST", path, query={"uploads": ""})
    check(st == 200, f"initiate {path}: {st} {body[:200]!r}")
    uid = xml_tag(body, "UploadId")
    etags = [""] * len(parts)

    def put(_t, n):
        st, err, h = c.send("PUT", path, parts[n], query={
            "partNumber": str(n + 1), "uploadId": uid})
        check(st == 200, f"part {n + 1} of {path}: {st} {err[:200]!r}")
        etags[n] = h["etag"]
    run_clients(put, [list(range(t, len(parts), inflight))
                      for t in range(inflight)])
    xml = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n + 1}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in enumerate(etags)) + "</CompleteMultipartUpload>"
    st, body, _ = c.send("POST", path, xml.encode(), query={"uploadId": uid})
    want = hashlib.md5(b"".join(hashlib.md5(p).digest()
                                for p in parts)).hexdigest()
    etag = xml_tag(body, "ETag")
    check(st == 200 and etag == f'"{want}-{len(parts)}"',
          f"complete {path}: {st} {body[:300]!r}")
    return etag


def mp_refusals(c: "Client", rng) -> None:
    """InvalidPart, EntityTooSmall and NoSuchUpload after an abort."""
    path = "/mph/refused"
    small = rng.bytes(1000)
    answers = []
    for case in ("InvalidPart", "EntityTooSmall", "NoSuchUpload"):
        st, body, _ = c.send("POST", path, query={"uploads": ""})
        uid = xml_tag(body, "UploadId")
        etags = [c.send("PUT", path, small, query={
            "partNumber": str(n), "uploadId": uid})[2]["etag"]
            for n in (1, 2)]
        if case == "NoSuchUpload":
            check(c.send("DELETE", path, query={"uploadId": uid})[0] == 204,
                  "abort")
            st, body, _ = c.send("PUT", path, small, query={
                "partNumber": "3", "uploadId": uid})
        else:
            parts = [(2, '"' + "0" * 32 + '"')] if case == "InvalidPart" \
                else list(zip((1, 2), etags))
            st, body, _ = c.send("POST", path, (
                "<CompleteMultipartUpload>" + "".join(
                    f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag>"
                    "</Part>" for n, e in parts)
                + "</CompleteMultipartUpload>").encode(),
                query={"uploadId": uid})
            c.send("DELETE", path, query={"uploadId": uid})
        want = 404 if case == "NoSuchUpload" else 400
        check(st == want and xml_tag(body, "Code") == case,
              f"{case}: {st} {body[:200]!r}")
        answers.append(f"{case} {st}")
    log("multipart: refused as S3 does: " + ", ".join(answers))


def snapshot(drives: list, keys, dst: str) -> None:
    for i, d in enumerate(drives):
        for key in keys:
            shutil.copytree(os.path.join(d, "mph", key),
                            os.path.join(dst, f"d{i}", key))


def same_as_copy(drives: list, copy: str, i: int, key: str) -> None:
    """Drive i's shard files and journal fields of `key` equal the copy."""
    from minio_tpu_torch.storage.meta import XLMeta
    a, b = os.path.join(drives[i], "mph", key), os.path.join(copy, f"d{i}",
                                                             key)

    def files(d):
        return {f"{e}/{f}": open(os.path.join(d, e, f), "rb").read()
                for e in sorted(os.listdir(d)) if e != "xl.meta"
                for f in sorted(os.listdir(os.path.join(d, e)))}

    def journal(d):
        xl = XLMeta.load(open(os.path.join(d, "xl.meta"), "rb").read())
        return xl.versions, xl.inline
    check(files(a) == files(b), f"healed drive {i} {key}: shard files differ")
    check(journal(a) == journal(b), f"healed drive {i} {key}: journal differs")


def wiped_get(s: "Server", key: str, body: bytes, shards) -> float:
    """GET `key` with the drives of the given shards taken away (then put
    back); checks the bytes and returns the wall time."""
    from minio_tpu_torch.object.erasure_object import hash_order
    dist = hash_order(f"mph/{key}", 12)
    moved = []
    try:
        for sh in shards:
            i = dist.index(sh + 1)
            src = os.path.join(s.drives[i], "mph", key)
            os.rename(src, src + ".away")
            moved.append(src)
        t0 = time.perf_counter()
        st, got = s.client("GET", f"/mph/{key}")
        wall = time.perf_counter() - t0
        check(st == 200 and got == body,
              f"GET {key} with shards {shards} away not identical")
        return wall
    finally:
        for src in moved:
            os.rename(src + ".away", src)


def admin_heal(c: "Client", deep: bool) -> tuple[dict, float]:
    """POST /minio/admin/v3/heal, then poll GET until the sweep ends."""
    t0 = time.perf_counter()
    st, body, _ = c.send("POST", "/minio/admin/v3/heal",
                         query={"deep": "true"} if deep else None)
    check(st == 200, f"admin heal: {st} {body[:200]!r}")
    while True:
        st, body, _ = c.send("GET", "/minio/admin/v3/heal")
        status = json.loads(body)
        if status["state"] != "running":
            break
        time.sleep(0.05)
    wall = time.perf_counter() - t0
    check(status["state"] == "done" and status["failures"] == 0,
          f"admin heal: {status}")
    return status, wall


def phase_multipart_heal(torch, rng, s: "Server", root: str):
    """Multipart uploads and healing over signed HTTP (phase 4b) on the
    server `s`; returns the phase's launches and its two 256 MiB objects
    ({"aws": multipart, "single": single-part}), left in bucket mph for
    phase 4c."""
    from minio_tpu_torch.object.erasure_object import hash_order
    es, c = s.es, s.client
    rate = {}
    size = 256 * MIB

    def note(what: str, wall: float, mib: float) -> None:
        rate[what] = (wall, mib / wall)
        log(f"multipart/heal: {what}: {wall:.4f} s, {mib / wall:.1f} MiB/s "
            "(host clock over signed HTTP on localhost)")
    try:
        check(c("PUT", "/mph")[0] == 200, "make bucket")
        reset_launches()
        conf4 = rng.bytes(CONF4_PARTS * 5 * MIB)
        t0 = time.perf_counter()
        mp_upload(c, "/mph/conf4", [conf4[o:o + 5 * MIB] for o in
                                    range(0, len(conf4), 5 * MIB)],
                  CONF4_PARTS)
        note(f"configs[4] upload, {CONF4_PARTS} clients x 5 MiB parts",
             time.perf_counter() - t0, len(conf4) / MIB)
        check(c("GET", "/mph/conf4") == (200, conf4),
              "configs[4] object did not read back identical")

        objs = {"aws": rng.bytes(size), "single": rng.bytes(size)}
        big = objs["aws"]
        t0 = time.perf_counter()
        etag = mp_upload(c, "/mph/aws", [big[o:o + AWS_PART] for o in
                                         range(0, len(big), AWS_PART)],
                         AWS_INFLIGHT)
        note(f"256 MiB upload, 32 x 8 MiB parts, {AWS_INFLIGHT} in flight",
             time.perf_counter() - t0, size / MIB)
        t0 = time.perf_counter()
        check(c("PUT", "/mph/single", objs["single"])[0] == 200,
              "single-part PUT")
        note("256 MiB single-part PUT", time.perf_counter() - t0,
             size / MIB)
        for key in ("aws", "single"):
            t0 = time.perf_counter()
            st, got = c("GET", f"/mph/{key}")
            note(f"GET {key}", time.perf_counter() - t0, size / MIB)
            check(st == 200 and got == objs[key], f"GET {key} not identical")
        for lo, hi in ((AWS_PART - 100, AWS_PART + 99),
                       (10 * AWS_PART - 7, 11 * AWS_PART + 5),
                       (100 * MIB - 5, 117 * MIB)):
            st, got, crange = c.ranged_get("/mph/aws", lo, hi)
            check(st == 206 and got == big[lo:hi + 1]
                  and crange == f"bytes {lo}-{hi}/{len(big)}",
                  f"ranged GET of the multipart object {lo}-{hi}: {st}")
        st, _, h = c.send("HEAD", "/mph/aws")
        check(st == 200 and h.get("etag") == etag and etag.endswith('-32"')
              and h.get("content-length") == str(len(big)),
              f"HEAD of the multipart object: {st} {h}")
        log(f"multipart: 3 ranged GETs across part boundaries answered 206 "
            f"with the range; HEAD answered ETag {etag}")
        mp_refusals(c, rng)

        copy = os.path.join(root, "mph-copy")
        snapshot(s.drives, objs, copy)
        dists = {k: hash_order(f"mph/{k}", 12) for k in objs}

        # configs[3], one data-shard drive: the MRF queue a degraded GET
        # filled heals the single-part object; the admin heal in normal
        # mode the multipart one.
        lost = {k: dists[k].index(1) for k in objs}        # shard 0
        shutil.rmtree(os.path.join(s.drives[lost["single"]], "mph",
                                   "single"))
        t0 = time.perf_counter()
        st, got = c("GET", "/mph/single")
        check(st == 200 and got == objs["single"], "degraded GET")
        t1 = time.perf_counter()
        check(es.mrf.drain(timeout=600), "the MRF queue did not drain")
        note("one drive, MRF heal of the single-part object (deep), "
             "drained after its GET", time.perf_counter() - t1, size / MIB)
        mrf = es.mrf.stats()
        check(mrf["healed"] >= 1 and not mrf["dropped"], f"MRF {mrf}")
        es.mrf.stop()                  # degraded reads below heal nothing
        shutil.rmtree(os.path.join(s.drives[lost["aws"]], "mph", "aws"))
        status, wall = admin_heal(c, deep=False)
        check(status["healed"] == 1, f"normal heal sweep: {status}")
        note("one drive, admin heal sweep (normal) of 3 objects, "
             "the multipart one rebuilt", wall, size / MIB)
        for key in objs:
            same_as_copy(s.drives, copy, lost[key], key)
            others = [sh for sh in range(K) if sh != 0][:4]
            wall = wiped_get(s, key, objs[key], others)
            note(f"GET {key}, 4 other data drives away after the heal", wall,
                 size / MIB)
        log(f"heal, one data-shard drive: MRF {mrf}; admin sweep {status}; "
            "healed drives equal their copies")

        # configs[3], two data and two parity drives: admin heal, deep.
        for key in objs:
            for sh in (1, 6, 8, 11):
                shutil.rmtree(os.path.join(s.drives[dists[key].index(sh + 1)],
                                           "mph", key))
        status, wall = admin_heal(c, deep=True)
        check(status["healed"] == 2, f"deep heal sweep: {status}")
        note("four drives, admin heal sweep (deep) of 3 objects, two "
             "rebuilt", wall, 2 * size / MIB)
        for key in objs:
            for sh in (1, 6, 8, 11):
                same_as_copy(s.drives, copy, dists[key].index(sh + 1), key)
            wall = wiped_get(s, key, objs[key], (0, 2, 3, 4))
            note(f"GET {key}, 4 other data drives away after the deep heal",
                 wall, size / MIB)
        wall = wiped_get(s, "aws", big, (0, 1, 2, 3))
        note("GET of the multipart object, 4 data drives away", wall,
             size / MIB)
        log(f"heal, two data and two parity drives: admin sweep {status}; "
            "healed drives equal their copies")

        launches = read_launches()
        log(f"multipart/heal launches {launches} set windows "
            f"{es.device_windows} host windows {es.host_windows}")
        check(launches["gf_apply"] and launches["highwayhash256"],
              f"a kernel of the path never launched: {launches}")
        check(not any(es.host_windows.values()),
              f"windows went to the host: {es.host_windows}")
        gap = rate["GET single"][1] / rate["GET aws"][1]
        log(f"multipart GET {rate['GET aws'][1]:.1f} MiB/s against "
            f"single-part {rate['GET single'][1]:.1f} MiB/s: the single-part "
            f"GET is {gap:.2f}x as fast")
        return launches, objs
    finally:
        check_pool_idle("multipart/heal")


# Phase 4c: the bucket namespace.
NS_BIG = 256 * MIB          # each versioned PUT, as phase 4b's objects
# 2,000 keys of 1 KiB for the listing: with 10,000 and phase 4g the
# script ran 1155.4 s on an H100 against a 1,200 s limit; with phase 4h
# and 5,000 keys 4c took 197.6 s, with 2,000 84.8 s and the script
# 864.9 s; with 3,000 and phase 4i 4c took 159.6 s and the script
# 1149.0 s (an H100 80GB HBM3 at 700 W on a slow host).
NS_DIRS, NS_PER_DIR = 50, 24      # 1,200 keys (2,000 until phase 4j)
NS_CLIENTS = 16
# UploadPartCopy's ranges of the 256 MiB source, (offset, length): its
# first 64 MiB, 40 MiB across the boundary of its 32 MiB windows 3 and 4,
# and its last 5 MiB + 777 B; an uploaded 5 MiB part goes between.
NS_PART_COPIES = [(0, 64 * MIB), (96 * MIB - 20 * MIB, 40 * MIB),
                  (NS_BIG - 5 * MIB - 777, 5 * MIB + 777)]
VERSIONING = ("<VersioningConfiguration><Status>{}</Status>"
              "</VersioningConfiguration>")


def xml_entries(body: bytes, tag: str) -> list[dict]:
    """The children of each <tag> element of an S3 XML answer, as
    {child tag: text}, in document order."""
    import xml.etree.ElementTree as ET
    return [{c.tag.split("}")[-1]: c.text or "" for c in e}
            for e in ET.fromstring(body).iter() if e.tag.split("}")[-1] == tag]


class mrf_paused:
    """Drives taken away by hand: the set's MRF worker stops first (a heal
    must not race the drives' return) and a fresh queue opens after."""

    def __init__(self, es):
        self.es = es

    def __enter__(self):
        self.es.mrf.stop()

    def __exit__(self, *exc):
        with self.es._mrf_lock:
            self.es._mrf = None


class drives_away:
    """Move `<drive>/<path>` aside on the given drives, and back."""

    def __init__(self, s: "Server", drives, path: str):
        self.srcs = [os.path.join(s.drives[i], path) for i in drives]

    def __enter__(self):
        for src in self.srcs:
            os.rename(src, src + ".away")

    def __exit__(self, *exc):
        for src in self.srcs:
            os.rename(src + ".away", src)


def list_all(c: "Client", bucket: str, query: dict) -> tuple[list, list, int]:
    """ListObjectsV2 through every continuation token: (keys, common
    prefixes, pages)."""
    keys, prefixes, pages, q = [], [], 0, {"list-type": "2", **query}
    while True:
        st, body, _ = c.send("GET", f"/{bucket}", query=q)
        check(st == 200, f"ListObjectsV2 {q}: {st} {body[:200]!r}")
        pages += 1
        keys += [e["Key"] for e in xml_entries(body, "Contents")]
        prefixes += [e["Prefix"] for e in xml_entries(body, "CommonPrefixes")]
        if xml_tag(body, "IsTruncated") != "true":
            return keys, prefixes, pages
        q["continuation-token"] = xml_tag(body, "NextContinuationToken")


def list_versions(c: "Client", bucket: str, page: int) -> list[tuple]:
    """ListObjectVersions through both markers, `page` entries a page:
    [(key, version id, delete marker, is latest)]."""
    out, q = [], {"versions": "", "max-keys": str(page)}
    while True:
        st, body, _ = c.send("GET", f"/{bucket}", query=q)
        check(st == 200, f"ListObjectVersions {q}: {st} {body[:200]!r}")
        import xml.etree.ElementTree as ET
        for e in ET.fromstring(body):
            tag = e.tag.split("}")[-1]
            if tag in ("Version", "DeleteMarker"):
                f = {x.tag.split("}")[-1]: x.text for x in e}
                out.append((f["Key"], f["VersionId"], tag == "DeleteMarker",
                            f["IsLatest"] == "true"))
        if xml_tag(body, "IsTruncated") != "true":
            return out
        q = {"versions": "", "max-keys": str(page),
             "key-marker": xml_tag(body, "NextKeyMarker"),
             "version-id-marker": xml_tag(body, "NextVersionIdMarker")}


def delete_objects(c: "Client", bucket: str, items, quiet: bool = True):
    """POST ?delete of (key, version id or "") items, 1000 a request; the
    per-key errors must be none."""
    items = list(items)
    for i in range(0, len(items), 1000):
        xml = ("<Delete>" + ("<Quiet>true</Quiet>" if quiet else "") + "".join(
            f"<Object><Key>{k}</Key>"
            + (f"<VersionId>{v}</VersionId>" if v else "") + "</Object>"
            for k, v in items[i:i + 1000]) + "</Delete>").encode()
        st, body, _ = c.send("POST", f"/{bucket}", xml,
                             query={"delete": ""}, extra={
                                 "content-md5": base64.b64encode(
                                     hashlib.md5(xml).digest()).decode()})
        check(st == 200 and b"<Error>" not in body,
              f"DeleteObjects: {st} {body[:300]!r}")


def phase_namespace(rng, s: "Server", src: dict) -> dict:
    """The bucket namespace over signed HTTP (phase 4c) on phase 4b's
    server, its MRF reopened; returns the phase's launches."""
    es, c = s.es, s.client
    vb, lb = "vers", "keys"
    rate = {}

    def note(what: str, wall: float, amount: float, unit: str) -> None:
        rate[what] = amount / wall
        log(f"namespace: {what}: {wall:.4f} s, {amount / wall:.1f} {unit} "
            "(host clock over signed HTTP on localhost)")

    def vid_of(h: dict) -> str:
        vid = h.get("x-amz-version-id", "")
        check(vid and vid != "null", f"no version id in {h}")
        return vid

    with es._mrf_lock:
        es._mrf = None                 # phase 4b stopped it: a fresh queue
    reset_launches()
    windows0 = dict(es.host_windows)
    check(c("PUT", f"/{vb}")[0] == 200, "make versioned bucket")
    check(c.send("PUT", f"/{vb}", VERSIONING.format("Enabled").encode(),
                 query={"versioning": ""})[0] == 200, "enable versioning")
    st, body, _ = c.send("GET", f"/{vb}", query={"versioning": ""})
    check(xml_tag(body, "Status") == "Enabled", f"versioning: {body!r}")

    # -- versions -------------------------------------------------------
    bodies = [rng.bytes(NS_BIG) for _ in range(3)]
    vids = []
    t0 = time.perf_counter()
    for b in bodies:
        st, _, h = c.send("PUT", f"/{vb}/obj", b)
        check(st == 200, f"versioned PUT: {st}")
        vids.append(vid_of(h))
    big = f"{NS_BIG // MIB} MiB"
    note(f"3 versioned PUTs of {big}", time.perf_counter() - t0,
         3 * NS_BIG / MIB, "MiB/s")
    check(len(set(vids)) == 3, f"version ids not distinct: {vids}")
    t0 = time.perf_counter()
    for v, b in zip(vids, bodies):
        st, got, h = c.send("GET", f"/{vb}/obj", query={"versionId": v})
        check(st == 200 and got == b and h.get("x-amz-version-id") == v,
              f"GET by versionId {v}: {st}")
    note(f"3 GETs by versionId of {big}", time.perf_counter() - t0,
         3 * NS_BIG / MIB, "MiB/s")
    before = es.device_windows["reconstruct"]
    with mrf_paused(es), drives_away(s, data_holders(vb, "obj", 4),
                                     f"{vb}/obj"):
        t0 = time.perf_counter()
        st, got, _ = c.send("GET", f"/{vb}/obj", query={"versionId": vids[0]})
        note("GET of the oldest version, 4 data drives away",
             time.perf_counter() - t0, NS_BIG / MIB, "MiB/s")
        check(st == 200 and got == bodies[0], "degraded GET by versionId")
    check(es.device_windows["reconstruct"] > before,
          "the degraded GET by versionId did not reconstruct on the card")
    st, _, h = c.send("DELETE", f"/{vb}/obj")
    check(st == 204 and h.get("x-amz-delete-marker") == "true",
          f"DELETE without a version: {st} {h}")
    marker = vid_of(h)
    st, _, h = c.send("GET", f"/{vb}/obj")
    check(st == 404 and h.get("x-amz-delete-marker") == "true",
          f"GET under a delete marker: {st} {h}")
    st, _, h = c.send("HEAD", f"/{vb}/obj", query={"versionId": marker})
    check(st == 405, f"HEAD of the marker's version: {st}")
    check(c.send("DELETE", f"/{vb}/obj", query={"versionId": marker})[0]
          == 204, "DELETE of the marker")
    check(c("GET", f"/{vb}/obj") == (200, bodies[2]),
          "the newest version is not back after its marker went")
    old_ddir = {es.disks[i].read_version(vb, "obj", vids[0]).data_dir
                for i in range(12)}
    check(len(old_ddir) == 1 and "" not in old_ddir, f"data dirs {old_ddir}")
    check(c.send("DELETE", f"/{vb}/obj", query={"versionId": vids[0]})[0]
          == 204, "DELETE of the oldest version")
    check(not any(os.path.exists(os.path.join(d, vb, "obj", *old_ddir))
                  for d in s.drives),
          "the oldest version's data dir is left on a drive")
    check(c.send("PUT", f"/{vb}", VERSIONING.format("Suspended").encode(),
                 query={"versioning": ""})[0] == 200, "suspend versioning")
    nulls = [rng.bytes(3 * MIB + 5), rng.bytes(5 * MIB + 7)]
    for b in nulls:
        st, _, h = c.send("PUT", f"/{vb}/obj", b)
        check(st == 200 and "x-amz-version-id" not in h,
              f"suspended PUT: {st} {h}")
    got = [(v, dm, lat) for k, v, dm, lat in list_versions(c, vb, 1000)
           if k == "obj"]
    check(got == [("null", False, True), (vids[2], False, False),
                  (vids[1], False, False)],
          f"versions after the suspended PUTs: {got}")
    check(c("GET", f"/{vb}/obj") == (200, nulls[1]),
          "the second suspended PUT does not read back")
    log("namespace: 3 versions read by id (one with 4 data drives away); a "
        "delete marker (404 GET, 405 HEAD of its id) removed; the oldest "
        "version's data dir gone from all 12 drives; suspended PUTs replaced "
        "the null version, the Enabled-era versions stayed")

    # -- copies ---------------------------------------------------------
    check(c.send("PUT", f"/{vb}", VERSIONING.format("Enabled").encode(),
                 query={"versioning": ""})[0] == 200, "enable versioning")
    copies = {}
    for dst, key in (("copy-single", "single"), ("copy-mp", "aws")):
        t0 = time.perf_counter()
        st, body, h = c.send("PUT", f"/{vb}/{dst}", extra={
            "x-amz-copy-source": f"/mph/{key}"})
        note(f"CopyObject of the {big} {key} object",
             time.perf_counter() - t0, len(src[key]) / MIB, "MiB/s")
        check(st == 200 and xml_tag(body, "ETag"), f"copy {key}: {st} "
              f"{body[:200]!r}")
        copies[dst] = vid_of(h)
        check(c("GET", f"/{vb}/{dst}") == (200, src[key]),
              f"the copy of {key} does not read back identical")
        res = es.heal_object(vb, dst, copies[dst], deep=True)
        check(res.healed == 0 and res.before == ["ok"] * 12,
              f"deep heal of the copy of {key}: {res}")
    body = src["single"]
    st, xml, _ = c.send("POST", f"/{vb}/upc", query={"uploads": ""})
    uid = xml_tag(xml, "UploadId")
    etags, want = [], b""
    plan = [("copy", NS_PART_COPIES[0]), ("copy", NS_PART_COPIES[1]),
            ("put", rng.bytes(5 * MIB)), ("copy", NS_PART_COPIES[2])]
    t0 = time.perf_counter()
    for n, (kind, arg) in enumerate(plan, 1):
        q = {"partNumber": str(n), "uploadId": uid}
        if kind == "put":
            part = arg
            st, xml, h = c.send("PUT", f"/{vb}/upc", part, query=q)
            etags.append(h.get("etag"))
        else:
            off, length = arg
            part = body[off:off + length]
            st, xml, h = c.send("PUT", f"/{vb}/upc", query=q, extra={
                "x-amz-copy-source": "/mph/single",
                "x-amz-copy-source-range": f"bytes={off}-{off + length - 1}"})
            etags.append(xml_tag(xml, "ETag"))
        want += part
        check(st == 200 and etags[-1] == f'"{hashlib.md5(part).hexdigest()}"',
              f"part {n} ({kind}): {st} {xml[:200]!r}")
    xml = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>")
    st, resp, h = c.send("POST", f"/{vb}/upc", xml.encode(),
                         query={"uploadId": uid})
    check(st == 200, f"complete the UploadPartCopy upload: {st} {resp!r}")
    copies["upc"] = vid_of(h)
    note("UploadPartCopy upload (3 ranges + 1 part), completed",
         time.perf_counter() - t0, len(want) / MIB, "MiB/s")
    check(c("GET", f"/{vb}/upc") == (200, want),
          "the UploadPartCopy object does not read back identical")
    log(f"namespace: both {big} copies read back identical and a deep heal "
        "of each found every shard good; the UploadPartCopy object "
        f"({len(want)} B) read back identical")

    # -- listing --------------------------------------------------------
    check(c("PUT", f"/{lb}")[0] == 200, "make listing bucket")
    keys = [f"dir{d:02d}/obj{o:03d}" for d in range(NS_DIRS)
            for o in range(NS_PER_DIR)]
    small = np.frombuffer(rng.bytes(len(keys) * 1024), np.uint8) \
        .reshape(len(keys), 1024)

    def put(_t, i):
        st, _ = c("PUT", f"/{lb}/{keys[i]}", small[i].tobytes())
        check(st == 200, f"PUT {keys[i]}: {st}")
    gc0 = es.group_commit.stats()
    wall = run_clients(put, [list(range(t, len(keys), NS_CLIENTS))
                             for t in range(NS_CLIENTS)])
    note(f"{len(keys)} PUTs of 1 KiB, {NS_CLIENTS} clients", wall,
         len(keys), "keys/s")
    gc1 = es.group_commit.stats()
    gcd = {k: gc1[k] - gc0[k] for k in (
        "batches", "members", "solo_bypass", "solo_demotions",
        "fsyncs_saved", "deadline_culls", "merged_members")}
    log(f"namespace: group commit over the PUTs: {gcd['batches']} batches, "
        f"{gcd['members'] / max(1, gcd['batches']):.2f} members a batch, "
        f"{gcd['solo_bypass']} solo bypasses, {gcd['solo_demotions']} "
        f"demotions, {gcd['fsyncs_saved']} fsyncs saved, "
        f"{gcd['deadline_culls']} deadline culls; batch sizes "
        f"{gc1['size_buckets']}; member wait {summarize(gc1['wait_hist'])}")
    check(gcd["members"] > gcd["batches"] > 0,
          f"no group-commit batch had more than one member: {gcd}")
    check(gcd["solo_demotions"] == 0 and gcd["deadline_culls"] == 0,
          f"group-commit members demoted or culled: {gcd}")
    from minio_tpu_torch.storage import meta_scan
    scan0 = dict(meta_scan.counters)
    mc0 = es.metacache.stats()
    t0 = time.perf_counter()
    got, _, pages = list_all(c, lb, {"max-keys": "1000"})
    note(f"deep ListObjectsV2 of {len(keys)} keys, pages of 1000",
         time.perf_counter() - t0, len(keys), "keys/s")
    check(got == keys and pages == -(-len(keys) // 1000),
          f"deep listing: {len(got)} keys in {pages} pages")
    mc1 = es.metacache.stats()
    t0 = time.perf_counter()
    got, _, pages = list_all(c, lb, {"max-keys": "1000"})
    note(f"the same deep listing again, from the walk stream",
         time.perf_counter() - t0, len(keys), "keys/s")
    check(got == keys, f"repeated deep listing: {len(got)} keys")
    mc2 = es.metacache.stats()
    check(mc2["hits"] > mc1["hits"] and
          mc2["walks_started"] == mc1["walks_started"],
          f"the repeated listing walked the drives again: {mc1} -> {mc2}")
    t0 = time.perf_counter()
    got, prefixes, _ = list_all(c, lb, {"delimiter": "/"})
    note(f"delimiter / page of {NS_DIRS} prefixes (shallow walk)",
         time.perf_counter() - t0, NS_DIRS, "prefixes/s")
    check(got == [] and prefixes == [f"dir{d:02d}/" for d in range(NS_DIRS)],
          f"delimiter listing: {len(got)} keys, {len(prefixes)} prefixes")
    log(f"namespace: metacache {mc0} -> {mc1} -> {mc2} -> "
        f"{es.metacache.stats()}; journal summaries "
        f"{ {k: meta_scan.counters[k] - scan0[k] for k in scan0} }")
    d42 = f"dir{42 % NS_DIRS:02d}/"
    got, _, _ = list_all(c, lb, {"prefix": d42})
    check(got == [k for k in keys if k.startswith(d42)],
          f"prefix {d42}: {len(got)} keys")
    d57 = 57 % NS_DIRS
    st, body, _ = c.send("GET", f"/{lb}", query={
        "marker": f"dir{d57:02d}/obj{NS_PER_DIR // 2:03d}", "delimiter": "/",
        "max-keys": "5"})
    want_p = [f"dir{d:02d}/" for d in range(d57, min(d57 + 5, NS_DIRS))]
    more = d57 + 5 < NS_DIRS
    check(st == 200 and [e["Prefix"] for e in xml_entries(
        body, "CommonPrefixes")] == want_p and
        xml_tag(body, "NextMarker") == (want_p[-1] if more else ""),
        f"V1 with a marker inside dir{d57:02d}/: {st} {body[:300]!r}")
    got = list_versions(c, vb, 2)
    want_v = sorted([("copy-mp", copies["copy-mp"], False, True),
                     ("copy-single", copies["copy-single"], False, True),
                     ("obj", "null", False, True),
                     ("obj", vids[2], False, False),
                     ("obj", vids[1], False, False),
                     ("upc", copies["upc"], False, True)],
                    key=lambda e: e[0])
    check(got == want_v, f"ListObjectVersions in pages of 2: {got}")
    log(f"namespace: ListObjectsV2 of {len(keys)} keys in pages of 1000, "
        f"{NS_DIRS} common prefixes, prefix {d42}, V1 with a marker inside a "
        "collapsed prefix, and ListObjectVersions in pages of 2 all equal "
        "what was written")

    with mrf_paused(es):
        with drives_away(s, [5], lb):
            # Taking a drive away by hand is no mutation the set sees:
            # bump, so that the listing walks the drives as they are.
            es.metacache.bump(lb)
            got, _, _ = list_all(c, lb, {"max-keys": "1000"})
        check(got == keys, f"deep listing with one drive away: {len(got)}")
        gone = keys[:len(keys) // 10]
        with drives_away(s, [0, 4, 9], lb):
            t0 = time.perf_counter()
            delete_objects(c, lb, [(k, "") for k in gone])
            note(f"DeleteObjects of {len(gone)} keys, 3 drives missing it",
                 time.perf_counter() - t0, len(gone), "keys/s")
        for _ in range(2):          # the walked drives rotate walk by walk
            es.metacache.bump(lb)
            got, _, _ = list_all(c, lb, {"max-keys": "1000"})
            check(got == keys[len(gone):],
                  f"a deleted key listed: {len(got)} keys")
    log("namespace: the deep listing with one drive away, and after 3 "
        "drives missed a DeleteObjects, listed no deleted key")

    # -- clean-up ---------------------------------------------------------
    for b in (vb, lb):
        st, body, _ = c.send("DELETE", f"/{b}")
        check(st == 409 and xml_tag(body, "Code") == "BucketNotEmpty",
              f"DeleteBucket of non-empty {b}: {st}")
    delete_objects(c, vb, [(k, v) for k, v, _, _ in list_versions(c, vb,
                                                                   1000)])
    # The deleted keys again too: 3 drives still hold their stale copies.
    delete_objects(c, lb, [(k, "") for k in keys])
    for b in (vb, lb):
        check(c.send("DELETE", f"/{b}")[0] == 204, f"DeleteBucket {b}")
    left = [os.path.join(r, f) for d in s.drives for b in (vb, lb)
            for r, _, fs in os.walk(os.path.join(d, b)) for f in fs]
    left += [os.path.join(r, f) for d in s.drives
             for sub in (f"multipart/{vb}", f"buckets/{vb}", f"buckets/{lb}")
             for r, _, fs in os.walk(os.path.join(d, ".mtpu.sys", sub))
             for f in fs]
    check(not left, f"files left after the clean-up: {left[:5]}")
    check(c("GET", f"/{vb}")[0] == 404, "the versioned bucket is still there")

    launches = read_launches()
    log(f"namespace launches {launches}; host windows "
        f"{ {k: es.host_windows[k] - windows0[k] for k in windows0} }")
    check(launches["gf_apply"] and launches["highwayhash256"],
          f"a kernel of the path never launched: {launches}")
    check(es.host_windows == windows0,
          f"windows went to the host: {es.host_windows}")
    return launches


# Phase 4d: a crash with group-commit WALs live.
CRASH_CLIENTS = 16
CRASH_KEYS = 400              # a client at most; the kill comes first
CRASH_ACKS = 500              # acknowledged PUTs before the SIGKILL (1,000
                              # until phase 4j)
CRASH_DELETE_EVERY = 4        # each client deletes every 4th key it PUT


def phase_crash(rng, root: str, device: str = "cuda") -> dict:
    """Group-committed small writes survive a SIGKILL (phase 4d): the
    port's server in a subprocess on 12 fresh drives, its WAL
    checkpoints an hour apart so that every batch's frame is still live;
    16 clients PUT 1 KiB keys and delete every 4th after its PUT; SIGKILL
    after CRASH_ACKS acknowledged PUTs; the server booted again on the
    same drives, in this process. Its recovery must replay WAL frames;
    every acknowledged key reads back its bytes and is listed, no key
    whose DELETE was acknowledged is listed or read, and no pool lease
    is outstanding. Returns the restarted server's launches."""
    import signal
    import socket
    drives = [os.path.join(root, "crash", f"d{i}") for i in range(12)]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, MTPU_GROUP_COMMIT_CKPT_S="3600",
               MTPU_HTTP_WORKERS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--device", device,
         "--address", f"127.0.0.1:{port}", *drives],
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    lines: list[str] = []
    errs: list[str] = []
    acks = {}                       # key -> body, PUT acknowledged
    deleted, unsure = set(), set()  # DELETE acknowledged; outcome unknown
    mu = threading.Lock()
    try:
        def read_out():
            for line in proc.stdout:
                lines.append(line.rstrip())
        reader = threading.Thread(target=read_out, daemon=True)
        reader.start()
        t0 = time.perf_counter()
        while not any("serving S3 on" in ln for ln in lines):
            check(proc.poll() is None and time.perf_counter() - t0 < 180,
                  f"the crash server did not boot: {lines[-20:]}")
            time.sleep(0.1)
        log(f"crash: server pid {proc.pid} up in "
            f"{time.perf_counter() - t0:.1f} s: {lines[-1]}")
        c = Client(f"127.0.0.1:{port}")
        check(c("PUT", "/crash")[0] == 200, "make the crash bucket")
        bodies = np.frombuffer(rng.bytes(CRASH_CLIENTS * CRASH_KEYS * 1024),
                               np.uint8).reshape(CRASH_CLIENTS, CRASH_KEYS,
                                                 1024)
        killed = threading.Event()
        lost = (OSError, http.client.HTTPException)

        def failed(what: str) -> None:
            if not killed.is_set():       # after the kill: the server is gone
                errs.append(what)

        def client(t: int) -> None:
            for i in range(CRASH_KEYS):
                key, body = f"t{t:02d}/k{i:05d}", bodies[t, i].tobytes()
                try:
                    st, _ = c("PUT", f"/crash/{key}", body)
                except lost as e:
                    return failed(f"PUT {key}: {e!r}")
                if st != 200:
                    return failed(f"PUT {key}: {st}")
                with mu:
                    acks[key] = body
                if i % CRASH_DELETE_EVERY:
                    continue
                with mu:
                    unsure.add(key)
                try:
                    st, _ = c("DELETE", f"/crash/{key}")
                except lost as e:
                    return failed(f"DELETE {key}: {e!r}")
                if st != 204:
                    return failed(f"DELETE {key}: {st}")
                with mu:
                    unsure.discard(key)
                    deleted.add(key)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(CRASH_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        while len(acks) < CRASH_ACKS and any(th.is_alive() for th in threads):
            time.sleep(0.005)
        killed.set()
        proc.send_signal(signal.SIGKILL)
        wall = time.perf_counter() - t0
        proc.wait(timeout=60)
        for th in threads:
            th.join(120)
        check(not any(th.is_alive() for th in threads), "a client hung")
        check(not errs, f"crash clients failed before the kill: {errs[:5]}")
        check(len(acks) >= CRASH_ACKS, f"only {len(acks)} PUTs acknowledged")
        log(f"crash: SIGKILL after {len(acks)} acknowledged PUTs and "
            f"{len(deleted)} acknowledged DELETEs in {wall:.2f} s "
            f"({len(acks) / wall:.1f} PUTs/s over HTTP); "
            f"{len(unsure)} DELETEs in flight")
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=60)
    wal = []
    for d in drives:
        gdir = os.path.join(d, ".mtpu.sys", "gcommit")
        if os.path.isdir(gdir):
            wal += [os.path.getsize(os.path.join(gdir, f))
                    for f in os.listdir(gdir)]
    log(f"crash: WAL bytes left on the drives {sum(wal)} in {len(wal)} files")
    check(sum(wal) > 0, "no group-commit WAL frame was live at the kill")

    s = Server(root, "crash", device=device)
    # After the boot's self-tests: the launches are the restart's reads.
    reset_launches()
    try:
        rec = s.srv.recovery
        log(f"crash: restart recovery {rec}")
        check(rec["wal_replayed"] > 0, f"no WAL frame replayed: {rec}")
        check(rec["swept"] == 12, f"not every drive swept: {rec}")
        live = {k: b for k, b in acks.items()
                if k not in deleted and k not in unsure}
        bad = [k for k, b in live.items()
               if s.client("GET", f"/crash/{k}") != (200, b)]
        check(not bad, f"{len(bad)} acknowledged keys do not read back: "
              f"{bad[:5]}")
        gone = [k for k in deleted
                if s.client("GET", f"/crash/{k}")[0] != 404]
        check(not gone, f"deleted keys read back: {gone[:5]}")
        listed, _, _ = list_all(s.client, "crash", {"max-keys": "1000"})
        check(not set(listed) & deleted,
              f"deleted keys listed: {sorted(set(listed) & deleted)[:5]}")
        check(set(live) <= set(listed),
              f"acknowledged keys not listed: "
              f"{sorted(set(live) - set(listed))[:5]}")
        launches = read_launches()
        log(f"crash: after the restart {len(live)} acknowledged keys read "
            f"back and are listed, {len(deleted)} deleted keys neither; "
            f"launches {launches}")
        check(launches["highwayhash256"],
              f"the restarted server's GETs never launched: {launches}")
    finally:
        s.stop()
    check_pool_idle("crash restart", device)
    return launches


# Phase 4e: the drive plane.
DP_BIG = 16 * MIB               # MinIO's own layout: 16 MiB objects
DP_BIG_BYTES = 1 << 29          # of them, 512 MiB (2 GiB until phase 4i,
                                # 1 GiB until phase 4j)
DP_RAGGED = 64 * MIB + 1        # a ragged tail
DP_MP_PARTS = 8                 # a multipart object of 8 x AWS_PART
DP_SMALL = 100                  # keys of 1 KiB (1,000 until phase 4i, 500
                                # until phase 4j)
DP_VKEYS, DP_VERSIONS, DP_MARKERS = 20, 3, 10   # (200, 3, 100 before 4i;
                                                # 100, 3, 50 before 4j)
DP_VBODY = 4 * 1024
DP_CLIENTS = 16
DP_LIVE_KEYS = 8                # keys a client PUTs and GETs while serving
                                # (24 until phase 4j)
DP_LIVE_SIZE = MIB              # their size
DP_LIVE_PAUSE = 0.25            # seconds between a client's pairs
DP_INTERVAL = 1.0               # --scanner-interval of the phase's server
HUNG_SLEEP = 30.0               # the hung drive's sleep on every call
SMALL_RATE_KEYS = 16            # 1 KiB PUTs a client for the rate pair (32
                                # until phase 4j)


class ServerProc:
    """`python -m minio_tpu_torch.server` in a subprocess on `drives` in
    a session of its own (kill() takes its process group, fleet workers
    included), its output collected; MTPU_HTTP_WORKERS=`workers`, the
    environment's cache switches unless `env` overrides them. Up once
    every worker printed its serving line; stop() sends SIGINT (the
    clean stop) and returns the launches a one-process server printed
    while serving."""

    def __init__(self, drives: list, extra: tuple = (),
                 device: str = "cuda", workers: int = 1,
                 env: dict | None = None, port: int | None = None,
                 wait: bool = True):
        import socket
        if port is None:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
        self.workers = workers
        self.t_start = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "minio_tpu_torch.server", "--device",
             device, "--address", f"127.0.0.1:{port}", *extra, *drives],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env={**os.environ, "MTPU_HTTP_WORKERS": str(workers),
                 **(env or {})},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        self.lines: list[str] = []
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        self.client = Client(f"127.0.0.1:{port}")
        if wait:
            self.wait_serving()

    def wait_serving(self) -> None:
        """Until every worker printed its serving line (at most 240 s)."""
        t0 = time.perf_counter()
        try:
            while sum("serving S3 on" in ln for ln in self.lines) \
                    < self.workers:
                check(self.proc.poll() is None
                      and time.perf_counter() - t0 < 240,
                      f"the server did not boot: {self.lines[-20:]}")
                time.sleep(0.05)
        except BaseException:
            self.kill()
            raise
        self.t_serving = time.time()

    def kill(self) -> None:
        """SIGKILL the whole process group; reap the server."""
        import signal
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=60)

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())

    def line(self, prefix: str) -> str:
        return next((ln for ln in self.lines if ln.startswith(prefix)), "")

    def stop(self) -> dict:
        import signal
        try:
            self.proc.send_signal(signal.SIGINT)
            rc = self.proc.wait(timeout=120)
        finally:
            self.kill()
        self.reader.join(30)
        check(rc == 0, f"the server's clean stop exited {rc}: "
              f"{self.lines[-20:]}")
        done = self.line("kernel launches while serving: ")
        check(done, f"no launch line at the clean stop: {self.lines[-20:]}")
        return json.loads(done.split(": ", 1)[1])


def drive_files(root: str) -> dict:
    """Relative path -> bytes of every file of a drive outside its system
    volume (journals parsed: their versions and inline data)."""
    from minio_tpu_torch.storage.meta import XLMeta
    out = {}
    for dirpath, _, files in os.walk(root):
        if os.path.relpath(dirpath, root).split(os.sep)[0] == ".mtpu.sys":
            continue
        for f in files:
            full = os.path.join(dirpath, f)
            blob = open(full, "rb").read()
            if f == "xl.meta":
                xl = XLMeta.load(blob)
                blob = (xl.versions, xl.inline)
            out[os.path.relpath(full, root)] = blob
    return out


def shard_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root)
               if os.path.relpath(d, root).split(os.sep)[0] != ".mtpu.sys"
               for f in fs)


def drive_heal_status(c: "Client", drive: int) -> dict:
    st, body, _ = c.send("GET", "/minio/admin/v3/heal")
    check(st == 200, f"admin heal status: {st} {body[:200]!r}")
    return next((d for d in json.loads(body).get("drive_heal", {})
                 .get("drives", []) if d["drive"] == drive), {})


def wait_healed(c: "Client", drive: int, timeout: float = 600) -> dict:
    t0 = time.perf_counter()
    while True:
        entry = drive_heal_status(c, drive)
        if entry.get("state") == "done":
            return entry
        check(time.perf_counter() - t0 < timeout,
              f"drive {drive} not healed in {timeout} s: {entry}")
        time.sleep(0.1)


def ready(c: "Client") -> tuple[int, dict]:
    st, body, _ = c.send("GET", "/minio/health/ready")
    return st, json.loads(body)


def add_launches(a: dict, b: dict) -> dict:
    by_r = dict(a.get("gf_apply_by_r", {}))
    for r, n in b.get("gf_apply_by_r", {}).items():
        by_r[str(r)] = by_r.get(str(r), 0) + n
    return {"gf_apply": a.get("gf_apply", 0) + b.get("gf_apply", 0),
            "gf_apply_by_r": by_r,
            "highwayhash256": a.get("highwayhash256", 0)
            + b.get("highwayhash256", 0)}


def in_process_launches() -> dict:
    from minio_tpu_torch.ops import rs_device
    got = read_launches()
    return {"gf_apply": got["gf_apply"],
            "gf_apply_by_r": {str(r): n for r, n in
                              sorted(rs_device.LAUNCHES_BY_R.items())},
            "highwayhash256": got["highwayhash256"]}


class SleepyDisk:
    """A drive whose every call first waits on `release` for up to
    HUNG_SLEEP seconds while `hang` is set: a drive that hangs instead
    of dying; and whose calls of an op in `delays` first sleep that
    long: a slow drive."""

    def __init__(self, disk):
        self._disk = disk
        self.hang = False
        self.release = threading.Event()
        self.delays: dict = {}      # op -> seconds each call sleeps first

    @property
    def root(self):
        return self._disk.root

    @property
    def endpoint(self):
        return self._disk.endpoint

    def __getattr__(self, name: str):
        attr = getattr(self._disk, name)
        if not callable(attr):
            return attr

        def call(*a, **kw):
            if self.hang:
                self.release.wait(HUNG_SLEEP)
            delay = self.delays.get(name)
            if delay:
                time.sleep(delay)
            return attr(*a, **kw)
        return call


def phase_hung_drive(rng, root: str, device: str = "cuda") -> None:
    """An ErasureSet in this process over wrap_disks(op_timeout=1.0) (and
    the same bulk deadline), one drive asleep on every call: the PUT and
    GET of 16 MiB finish within the deadline plus a healthy one's time,
    the breaker opens after 3 faults and then fails calls in under
    10 ms, and once the sleep is lifted the half-open probe readmits the
    drive after its cooldown."""
    from minio_tpu_torch.object.erasure_object import ErasureSet
    from minio_tpu_torch.storage.health import wrap_disks
    from minio_tpu_torch.storage.local import FaultyDisk, LocalStorage
    timeout = 1.0
    sleepy = [SleepyDisk(LocalStorage(os.path.join(root, "hung", f"d{i}")))
              for i in range(12)]
    disks = wrap_disks(sleepy, op_timeout=timeout, bulk_timeout=timeout)
    es = ErasureSet(disks, device=device)
    es._mrf_closed = True
    try:
        es.make_bucket("hung")
        bodies = [rng.bytes(DP_BIG) for _ in range(4)]

        def put_get(key: str, body: bytes) -> tuple[float, float]:
            t0 = time.perf_counter()
            es.put_object("hung", key, body)
            t1 = time.perf_counter()
            check(es.get_object("hung", key)[1] == body,
                  f"hung drive: GET {key} not identical")
            return t1 - t0, time.perf_counter() - t1
        for i in range(2):
            put_get(f"warm{i}", bodies[0])
        put_h, get_h = put_get("healthy", bodies[1])
        # The (closed) MRF queue exists before the drive hangs: its first
        # use, a degraded write's enqueue, reads every drive's pending
        # list once.
        es.mrf.save_now()
        h = data_holders("hung", "slow", 1)[0]
        sleepy[h].hang = True
        put_s, get_s = put_get("slow", bodies[2])
        log(f"hung drive: drive {h} asleep {HUNG_SLEEP:.0f} s on every "
            f"call, deadline {timeout} s: 16 MiB PUT {put_s:.4f} s, GET "
            f"{get_s:.4f} s (healthy {put_h:.4f} s, {get_h:.4f} s)")
        # Each within the deadline plus a healthy PUT's time (0.5 s of
        # the host's spread beside it).
        check(max(put_s, get_s) <= timeout + put_h + 0.5,
              "the hung drive held a request past its deadline")
        # The PUT's staging clean-up on the drive fails in the
        # background, about when the GET's metadata read does.
        t0 = time.perf_counter()
        while disks[h].is_online() and time.perf_counter() - t0 < 3:
            time.sleep(0.01)
        info = disks[h].health_info()
        check(not disks[h].is_online() and info["consecutive_faults"] >= 3,
              f"the breaker did not open after 3 faults: {info}")
        fast = []
        for _ in range(5):
            t0 = time.perf_counter()
            try:
                disks[h].list_vols()
            except FaultyDisk:
                fast.append(time.perf_counter() - t0)
        check(len(fast) == 5 and max(fast) < 0.010,
              f"the open breaker did not fail fast: {fast}")
        sleepy[h].hang = False
        sleepy[h].release.set()
        t_lift = time.perf_counter()
        readmitted = None
        while readmitted is None and time.perf_counter() - t_lift < 15:
            try:
                disks[h].list_vols()
                readmitted = time.perf_counter() - t_lift
            except FaultyDisk:
                time.sleep(0.1)
        check(readmitted is not None and disks[h].is_online(),
              "the half-open probe did not readmit the drive")
        put_get("after", bodies[3])
        check(es.heal_object("hung", "after").before[h] == "ok",
              "the readmitted drive missed the next PUT")
        # The deep sample at 1 in 1: a flipped byte in a shard is found
        # and rebuilt by a scan cycle, with no client read.
        from minio_tpu_torch.object.scanner import Scanner
        objdir = os.path.join(sleepy[(h + 1) % 12].root, "hung", "healthy")
        ddir = next(e for e in os.listdir(objdir) if e != "xl.meta")
        part = os.path.join(objdir, ddir, "part.1")
        orig = open(part, "rb").read()
        flipped = bytearray(orig)
        flipped[len(flipped) // 2] ^= 0x5A
        open(part, "wb").write(bytes(flipped))
        t0 = time.perf_counter()
        Scanner([es], throttle=0, deep_every=1).scan_cycle()
        deep_wall = time.perf_counter() - t0
        check(open(part, "rb").read() == orig,
              "the deep scan did not repair the flipped byte")
        log(f"hung drive: breaker open after {info['consecutive_faults']} "
            f"faults, calls failed in at most {max(fast) * 1e3:.3f} ms; "
            f"the probe readmitted the drive {readmitted:.2f} s after the "
            "sleep was lifted (cooldown 5 s from the breaker's opening); "
            "the next PUT reached all 12 drives; a deep scan cycle "
            f"({deep_wall:.2f} s) found a flipped byte in a shard of "
            "`healthy` and rebuilt it")
    finally:
        es.close()
        for d in disks:
            d.close()


def small_put_rate(root: str, name: str, drive_timeout: str, rng,
                   device: str = "cuda") -> float:
    """Keys/s of 1 KiB PUTs from DP_CLIENTS clients (phase 4c's shape, cut
    to SMALL_RATE_KEYS a client) on a fresh server in this process."""
    s = Server(root, name, device=device,
               args=("--drive-timeout", drive_timeout))
    try:
        check(s.client("PUT", "/rate")[0] == 200, "make the rate bucket")
        bodies = rng.bytes(DP_CLIENTS * SMALL_RATE_KEYS * 1024)

        def put(t: int, i: int) -> None:
            o = (t * SMALL_RATE_KEYS + i) * 1024
            st, _ = s.client("PUT", f"/rate/dir{t:02d}/obj{i:03d}",
                             bodies[o:o + 1024])
            check(st == 200, f"small PUT: {st}")
        wall = run_clients(put, [range(SMALL_RATE_KEYS)] * DP_CLIENTS)
    finally:
        s.stop()
    return DP_CLIENTS * SMALL_RATE_KEYS / wall


def phase_drive_plane(rng, root: str, device: str = "cuda") -> dict:
    """The drive plane (phase 4e); returns its launches (the servers'
    while serving, and this process's)."""
    from minio_tpu_torch.object.scanner import Scanner
    from minio_tpu_torch.storage.meta import XLMeta
    drives = [os.path.join(root, "dp", f"d{i}") for i in range(12)]
    extra = ("--scanner-interval", str(DP_INTERVAL))
    launches = {}
    # What the phase wrote: bucket -> key -> [(size, delete marker)].
    model: dict = {"dpb": {}, "dpv": {}}
    pool = rng.bytes(DP_BIG_BYTES + DP_RAGGED + DP_MP_PARTS * AWS_PART)
    view = memoryview(pool)
    n_big = DP_BIG_BYTES // DP_BIG
    big = {f"big/{i:04d}": (i * DP_BIG, DP_BIG) for i in range(n_big)}
    big["ragged"] = (DP_BIG_BYTES, DP_RAGGED)

    def body_of(key: str) -> bytes:
        o, n = big[key]
        return bytes(view[o:o + n])

    # -- boot and load ---------------------------------------------------
    p = ServerProc(drives, extra, device)
    try:
        c = p.client
        fmts = [json.load(open(os.path.join(d, ".mtpu.sys",
                                            "format.json"))) for d in drives]
        layout = {(f["id"], json.dumps(f["xl"]["sets"])) for f in fmts}
        check(len(layout) == 1 and len({f["xl"]["this"] for f in fmts}) == 12
              and [f["xl"]["this"] for f in fmts] == fmts[0]["xl"]["sets"][0],
              "the 12 drives' format.json disagree")
        check(ready(c)[0] == 200, f"fresh server not ready: {ready(c)}")
        log(f"drive plane: booted in {p.t_serving - p.t_start:.2f} s; "
            f"{p.line('format: ')}")
        check(c("PUT", "/dpb")[0] == 200, "make bucket dpb")
        check(c("PUT", "/dpv")[0] == 200, "make bucket dpv")
        check(c.send("PUT", "/dpv", VERSIONING.format("Enabled").encode(),
                     query={"versioning": ""})[0] == 200, "versioning")
        t0 = time.perf_counter()

        def put_big(_t: int, key: str) -> None:
            st, err = c("PUT", f"/dpb/{key}", body_of(key))
            check(st == 200, f"PUT {key}: {st} {err[:200]!r}")
        keys = sorted(big)
        run_clients(put_big, [keys[t::DP_CLIENTS]
                              for t in range(DP_CLIENTS)])
        wall_big = time.perf_counter() - t0
        for key in keys:
            model["dpb"][key] = [(big[key][1], False)]
        o = DP_BIG_BYTES + DP_RAGGED
        parts = [bytes(view[o + n * AWS_PART:o + (n + 1) * AWS_PART])
                 for n in range(DP_MP_PARTS)]
        mp_upload(c, "/dpb/mp", parts, DP_MP_PARTS)
        model["dpb"]["mp"] = [(DP_MP_PARTS * AWS_PART, False)]
        small = rng.bytes(DP_SMALL * 1024)
        t0 = time.perf_counter()

        def put_small(_t: int, i: int) -> None:
            st, _ = c("PUT", f"/dpb/small/{i:05d}",
                      small[i * 1024:(i + 1) * 1024])
            check(st == 200, f"PUT small/{i}: {st}")
        run_clients(put_small, [range(t, DP_SMALL, DP_CLIENTS)
                                for t in range(DP_CLIENTS)])
        wall_small = time.perf_counter() - t0
        for i in range(DP_SMALL):
            model["dpb"][f"small/{i:05d}"] = [(1024, False)]
        vbody = rng.bytes(DP_VKEYS * DP_VERSIONS * DP_VBODY)

        def put_versions(_t: int, k: int) -> None:
            for v in range(DP_VERSIONS):
                o = (k * DP_VERSIONS + v) * DP_VBODY
                st, _ = c("PUT", f"/dpv/v{k:04d}", vbody[o:o + DP_VBODY])
                check(st == 200, f"PUT v{k} #{v}: {st}")
            if k < DP_MARKERS:
                st, _, h = c.send("DELETE", f"/dpv/v{k:04d}")
                check(st == 204 and h.get("x-amz-delete-marker") == "true",
                      f"marker on v{k}: {st} {h}")
        run_clients(put_versions, [range(t, DP_VKEYS, DP_CLIENTS)
                                   for t in range(DP_CLIENTS)])
        for k in range(DP_VKEYS):
            model["dpv"][f"v{k:04d}"] = [(DP_VBODY, False)] * DP_VERSIONS \
                + ([(0, True)] if k < DP_MARKERS else [])
        log(f"drive plane: loaded {n_big} x {DP_BIG / MIB:g} MiB and "
            f"{DP_RAGGED} B in {wall_big:.2f} s "
            f"({(DP_BIG_BYTES + DP_RAGGED) / MIB / wall_big:.1f} "
            f"MiB/s, {DP_CLIENTS} clients), a multipart of {DP_MP_PARTS} x "
            f"{AWS_PART / MIB:g} MiB, "
            f"{DP_SMALL} keys of 1 KiB ({DP_SMALL / wall_small:.1f} keys/s), "
            f"{DP_VKEYS} keys x {DP_VERSIONS} versions and {DP_MARKERS} "
            "delete markers")
    finally:
        launches = add_launches(launches, p.stop())

    # -- a drive replaced at boot ----------------------------------------
    d3 = drives[3]
    snap = os.path.join(root, "dp-snap3")
    shutil.copytree(d3, snap)
    slot3 = fmts[3]["xl"]["this"]
    shutil.rmtree(d3)
    os.makedirs(d3)
    p = ServerProc(drives, extra, device)
    try:
        c = p.client
        adopted = json.load(open(os.path.join(d3, ".mtpu.sys",
                                              "format.json")))
        check(adopted["xl"]["this"] == slot3 and adopted["id"] == fmts[0]["id"],
              f"drive 3 not adopted into slot 3: {adopted}")
        check(" 1 healing" in p.line("format: "),
              f"the boot did not mark drive 3 healing: {p.line('format: ')}")
        st, doc = ready(c)
        check(st == 503 and doc["degraded_sets"][0]["set"] == 0
              and doc["degraded_sets"][0]["healing_drives"] == 1,
              f"readiness while drive 3 heals: {st} {doc}")
        sample = keys[::8] + ["small/00000", f"small/{DP_SMALL - 1:05d}"]

        def get_one(_t: int, key: str) -> None:
            want = body_of(key) if key in big else \
                small[int(key[6:]) * 1024:(int(key[6:]) + 1) * 1024]
            check(c("GET", f"/dpb/{key}") == (200, want),
                  f"GET {key} while drive 3 heals")
        run_clients(get_one, [sample[t::DP_CLIENTS]
                              for t in range(DP_CLIENTS)])
        during = drive_heal_status(c, 3).get("state", "")
        entry = wait_healed(c, 3)
        boot_heal = entry["finished_at"] - p.t_start
        heal_wall = entry["finished_at"] - entry["started"]
        check(ready(c)[0] == 200, f"not ready after the heal: {ready(c)}")
        healed_bytes = shard_bytes(d3)
        log(f"drive plane: drive 3 replaced at boot: {len(sample)} GETs "
            f"exact while it healed (heal {during or 'not yet started'} "
            f"then); bulk heal finished {boot_heal:.2f} s after the "
            f"process started ({entry['finished_at'] - p.t_serving:.2f} s "
            f"after it served; tracker {heal_wall:.2f} s), "
            f"{entry['objects_scanned']} keys scanned, "
            f"{entry['objects_healed']} healed by the sweep, "
            f"{healed_bytes / MIB / heal_wall:.1f} MiB/s of shard bytes "
            f"to the new drive ({healed_bytes} B), "
            f"{entry['objects_scanned'] / heal_wall:.1f} objects/s; "
            "ready 200 again")
        got, want = drive_files(d3), drive_files(snap)
        check(sorted(got) == sorted(want),
              f"drive 3 after its heal: {len(got)} files against "
              f"{len(want)} in the snapshot, e.g. "
              f"{sorted(set(got) ^ set(want))[:5]}")
        bad = [k for k in want if got[k] != want[k]]
        check(not bad, f"drive 3 differs from its snapshot: {bad[:5]}")
        log(f"drive plane: drive 3's {len(want)} files equal the snapshot "
            "(shard files byte for byte, journals as version lists)")

        # -- a drive replaced while serving ------------------------------
        acks: dict = {}
        errs: list = []
        live_pool = rng.bytes(64 * DP_LIVE_SIZE)
        ran: list = []

        def live(t: int) -> None:
            # DP_LIVE_KEYS PUT-then-GET pairs a client, paced: the
            # clients run through the wipe and into the refill, and
            # leave the server time for it (all in one interpreter).
            t0 = time.time()
            for i in range(DP_LIVE_KEYS):
                key = f"live/t{t:02d}/k{i:03d}"
                o = (t * 7919 + i * 104729) % (63 * DP_LIVE_SIZE)
                body = live_pool[o:o + DP_LIVE_SIZE]
                try:
                    st, _ = c("PUT", f"/dpb/{key}", body)
                    if st != 200:
                        errs.append(f"PUT {key}: {st}")
                        return
                    acks[key] = body
                    st, got = c("GET", f"/dpb/{key}")
                    if (st, got) != (200, body):
                        errs.append(f"GET {key}: {st}")
                        return
                except (OSError, http.client.HTTPException) as e:
                    errs.append(f"{key}: {e!r}")
                    return
                time.sleep(DP_LIVE_PAUSE)
            ran.append(time.time() - t0)
        clients = [threading.Thread(target=live, args=(t,))
                   for t in range(DP_CLIENTS)]
        for th in clients:
            th.start()
        try:
            time.sleep(1.0)
            d7 = drives[7]
            away = os.path.join(root, "dp-wiped7")
            t_wipe = time.time()
            os.rename(d7, away)
            os.makedirs(d7)
            shutil.rmtree(away)
            fmt7 = os.path.join(d7, ".mtpu.sys", "format.json")
            while not os.path.exists(fmt7):
                check(time.time() - t_wipe < 2 * DP_INTERVAL + 1.0,
                      "drive 7's format was not restored within two polls")
                time.sleep(0.01)
            restored = time.time() - t_wipe
            entry7 = wait_healed(c, 7)
        finally:
            for th in clients:
                th.join(600)
        check(not any(th.is_alive() for th in clients), "a live client hung")
        check(not errs, f"client requests failed while drive 7 healed: "
              f"{errs[:5]}")
        for key, body in acks.items():
            model["dpb"][key] = [(len(body), False)]

        def check_ack(_t: int, key: str) -> None:
            check(c("GET", f"/dpb/{key}") == (200, acks[key]),
                  f"acknowledged {key} does not read back")
        ack_keys = sorted(acks)
        run_clients(check_ack, [ack_keys[t::DP_CLIENTS]
                                for t in range(DP_CLIENTS)])
        wall7 = entry7["finished_at"] - entry7["started"]
        bytes7 = shard_bytes(d7)
        log(f"drive plane: drive 7 holds {bytes7} B after its refill "
            f"({bytes7 / MIB / wall7:.1f} MiB/s over the tracker's time, "
            "the clients' writes to it included)")
        log(f"drive plane: drive 7 wiped while {DP_CLIENTS} clients PUT "
            f"and GET {DP_LIVE_SIZE} B objects: format restored "
            f"{restored:.2f} s "
            f"after the wipe (polls every {DP_INTERVAL} s), bulk heal "
            f"finished {entry7['finished_at'] - t_wipe:.2f} s after it "
            f"(tracker {wall7:.2f} s, {entry7['objects_scanned']} keys, "
            f"{entry7['objects_scanned'] / wall7:.1f} objects/s); the "
            f"clients ran {min(ran):.2f}-{max(ran):.2f} s from 1 s before "
            f"the wipe; no request failed; {len(acks)} acknowledged keys "
            "read back")
    finally:
        launches = add_launches(launches, p.stop())
    log(f"drive plane: the servers' launches while serving {launches}")

    # -- a hung drive, and the scanner, in this process -------------------
    reset_launches()
    phase_hung_drive(rng, root, device)
    launches = add_launches(launches, in_process_launches())
    s = Server(root, "dp", device=device)
    try:
        # The boot's self-tests launched the kernels: count from here.
        reset_launches()
        es = s.es
        # Both refills done: a second heal of every version of every key
        # heals nothing (16 threads).
        work = [(b, k, "") for b, ks in model.items() for k in ks
                if b != "dpv"]
        work += [(b, k, fi.version_id or "null")
                 for b, ks in model.items() if b == "dpv" for k in ks
                 for fi in es.list_versions_all(b, k)]
        t0 = time.perf_counter()
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(16) as ex:
            healed = list(ex.map(lambda w: es.heal_object(*w).healed, work))
        check(not any(healed) and len(healed) == sum(
            len(v) for v in model["dpv"].values()) + len(model["dpb"]),
            f"a second heal healed {sum(healed)} of {len(healed)}")
        log(f"drive plane: a second heal of all {len(work)} versions of "
            f"every key healed 0 ({time.perf_counter() - t0:.2f} s, 16 "
            "threads in process)")
        sc = Scanner([es], throttle=0)
        t0 = time.perf_counter()
        u = sc.scan_cycle()
        wall = time.perf_counter() - t0
        want = {"objects": 0, "versions": 0, "delete_markers": 0,
                "total_size": 0}
        for keysv in model.values():
            for vers in keysv.values():
                want["objects"] += 1
                want["versions"] += len(vers)
                want["delete_markers"] += sum(m for _, m in vers)
                want["total_size"] += sum(n for n, m in vers if not m)
        got_u = {k: getattr(u, k) for k in want}
        check(got_u == want, f"scanner usage {got_u} != written {want}")
        log(f"drive plane: a scan cycle of {u.objects} keys in "
            f"{wall:.2f} s; usage equals what the phase wrote: {got_u}")
        victim = os.path.join(s.drives[5], "dpb", "big", "0000")
        before = drive_files(victim)
        shutil.rmtree(victim)
        sc.scan_cycle()
        check(os.path.isdir(victim) and drive_files(victim) == before,
              "the scan did not repair drive 5's copy of big/0000")
        log("drive plane: a cycle rebuilt drive 5's copy of big/0000 "
            "(journal and shard file) with no client read")
    finally:
        s.stop()
    launches = add_launches(launches, in_process_launches())
    check_pool_idle("drive plane", device)

    rates = {}
    for turn, timeout_s in enumerate(("10", "0")):
        rates.setdefault(timeout_s, []).append(
            small_put_rate(root, f"rate{turn}", timeout_s, rng, device))
    log(f"drive plane: 1 KiB PUTs from {DP_CLIENTS} clients (phase 4c's "
        "shape, "
        f"{DP_CLIENTS * SMALL_RATE_KEYS} keys a run, fresh servers, turns "
        "10/0): --drive-timeout 10 (the health wrapper) "
        + " / ".join(f"{r:.1f}" for r in rates["10"])
        + " keys/s; --drive-timeout 0 "
        + " / ".join(f"{r:.1f}" for r in rates["0"]) + " keys/s")
    log(f"drive plane: launches in the phase {launches}")
    check(int(launches["gf_apply_by_r"].get("1", 0)) > 0
          and launches["highwayhash256"] > 0,
          f"the drive plane launched no r = 1 gf_apply or no hash: "
          f"{launches}")
    return launches


# Phase 4f: the pre-forked fleet.
FLEET_WORKERS = 4
FLEET_ROUNDS = 40               # coherence rounds, half 1 KiB, half 1 MiB
                                # (200 until phase 4i, 100 until 4j)
FLEET_GETS = 8                  # fresh connections a check
RATE_KEYS = 16                  # 1 KiB PUTs a client for the fleet's rate
                                # (32 until phase 4j)
RATE_PAIRS = 4                  # 1 MiB PUT+GET pairs a client


def cuda_processes(pids) -> dict:
    """pid -> whether the process holds a CUDA context (/dev/nvidia*
    among its open descriptors)."""
    out = {}
    for pid in pids:
        fd_dir = f"/proc/{pid}/fd"
        held = False
        for fd in os.listdir(fd_dir):
            try:
                held |= os.readlink(os.path.join(fd_dir, fd)).startswith(
                    "/dev/nvidia")
            except OSError:
                continue
        out[pid] = held
    return out


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", query, "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60
                          ).stdout.strip()


def fleet_pids(p: ServerProc) -> dict:
    """worker id -> pid of its latest serving line."""
    import re
    out = {}
    for ln in list(p.lines):
        m = re.search(r"serving S3 on .*worker (\d+) of \d+, pid (\d+)", ln)
        if m:
            out[int(m.group(1))] = int(m.group(2))
    return out


def fleet_rates(c: "Client", rng, tag: str) -> tuple[float, float, float]:
    """16 clients, each on fresh connections: keys/s of 1 KiB PUTs,
    MiB/s of 1 MiB PUT+GET pairs (both directions counted), and the
    HTTP floor: requests/s of /minio/health/live, which no object work
    follows (this process's clients and the front end alone)."""
    def probe(_t: int, _i: int) -> None:
        check(c("GET", "/minio/health/live")[0] == 200, "live probe")
    wall_p = run_clients(probe, [range(RATE_KEYS)] * CONC_THREADS)
    check(c("PUT", f"/{tag}")[0] == 200, f"make bucket {tag}")
    small = rng.bytes(CONC_THREADS * RATE_KEYS * 1024)

    def put_small(t: int, i: int) -> None:
        o = (t * RATE_KEYS + i) * 1024
        st, _ = c("PUT", f"/{tag}/s{t:02d}/{i:03d}", small[o:o + 1024])
        check(st == 200, f"1 KiB PUT: {st}")
    wall_s = run_clients(put_small, [range(RATE_KEYS)] * CONC_THREADS)
    big = [rng.bytes(MIB) for _ in range(CONC_THREADS)]

    def pair(t: int, i: int) -> None:
        st, _ = c("PUT", f"/{tag}/m{t:02d}/{i}", big[t])
        check(st == 200, f"1 MiB PUT: {st}")
        check(c("GET", f"/{tag}/m{t:02d}/{i}") == (200, big[t]),
              "1 MiB GET differs")
    wall_m = run_clients(pair, [range(RATE_PAIRS)] * CONC_THREADS)
    return (CONC_THREADS * RATE_KEYS / wall_s,
            2 * CONC_THREADS * RATE_PAIRS / wall_m,
            CONC_THREADS * RATE_KEYS / wall_p)


FLEET_HEADS = 64                # HEADs on fresh connections for 1b


def scrape_counts(c: "Client") -> dict:
    """Per-API request counts of one scrape (a fresh connection)."""
    st, text, _ = c.send("GET", "/minio/v2/metrics/cluster")
    check(st == 200, f"metrics scrape: {st}")
    return api_counts(prometheus_samples(text.decode()))


def fleet_observability(c: "Client", pids: dict, key: str) -> None:
    """4f's step 1b: a trace subscriber on one worker receives the
    requests of every worker, and one scrape through any worker counts
    every worker's requests (the parent's control pipes)."""
    before = scrape_counts(c)
    tail = TraceTail(c.address, "s3")
    t0 = time.perf_counter()
    for _ in range(FLEET_HEADS):
        check(c("HEAD", f"/flt/{key}")[0] == 200, "fleet HEAD")
    wall = time.perf_counter() - t0
    entries = tail.stop()
    heads = [e for e in entries if e.get("api") == "HEAD:object"]
    seen = sorted({e["worker"] for e in heads})
    log(f"fleet trace: a subscriber on one worker got {len(heads)} of "
        f"{FLEET_HEADS} HEADs (sent on fresh connections in {wall:.2f} s) "
        f"from workers {seen}, pids {[pids.get(w) for w in seen]}")
    check(len(heads) == FLEET_HEADS and seen == sorted(pids),
          f"fleet trace: {len(heads)} HEAD entries from workers {seen}")
    for turn in range(2):
        got = scrape_counts(c).get("HEAD:object", 0) \
            - before.get("HEAD:object", 0)
        check(got == FLEET_HEADS, f"fleet scrape {turn}: {got} HEADs "
              f"counted, {FLEET_HEADS} sent")
    log(f"fleet metrics: two scrapes through fresh connections each count "
        f"the {FLEET_HEADS} HEADs over all {len(pids)} workers")


def phase_fleet(rng, root: str, device: str = "cuda") -> dict:
    """The pre-forked fleet (phase 4f): `python -m minio_tpu_torch.server`
    with MTPU_HTTP_WORKERS=4 and the caches on, on 12 fresh drives;
    returns the launches every worker printed at its drain."""
    import signal
    from concurrent.futures import ThreadPoolExecutor
    from minio_tpu_torch.storage.local import CLEAN_SHUTDOWN_FILE
    caches_on = {"MTPU_FILEINFO_CACHE": "on", "MTPU_HOT_CACHE": "on"}
    drives = [os.path.join(root, "fleet", f"d{i}") for i in range(12)]
    used0 = smi("--query-gpu=memory.used")
    p = ServerProc(drives, ("--scanner-interval", "0"), device,
                   workers=FLEET_WORKERS, env=caches_on)
    try:
        c = p.client
        boot_s = p.t_serving - p.t_start
        pids = fleet_pids(p)
        check(sorted(pids) == list(range(FLEET_WORKERS)),
              f"not every worker served: {pids}")
        held = cuda_processes([p.proc.pid, *pids.values()])
        check(not held[p.proc.pid], "the fleet parent holds the card")
        check(all(held[pid] for pid in pids.values()),
              f"a worker holds no CUDA context: {held}")
        apps = smi("--query-compute-apps=pid,used_memory")
        used1 = smi("--query-gpu=memory.used")
        mem = {int(a.split(",")[0]): a.split(",")[1].strip()
               for a in apps.splitlines() if a.strip()}
        log(f"fleet: {FLEET_WORKERS} workers up in {boot_s:.2f} s, nproc "
            f"{os.cpu_count()}; parent pid {p.proc.pid} holds no CUDA "
            f"context, workers {pids} each hold one; nvidia-smi "
            f"compute apps: {mem or 'none listed'}; device memory used "
            f"{used0} before the boot, {used1} after")
        check(p.proc.pid not in mem, "nvidia-smi lists the parent")
        if any(pid in mem for pid in pids.values()):
            log("fleet: device memory a worker " + ", ".join(
                f"{w}: {mem.get(pid, 'not listed')}"
                for w, pid in sorted(pids.items())))
        else:
            # nvidia-smi sees other pids (another pid namespace): the
            # device-wide growth over the fleet's boot, shared out.
            grew = int(used1.split()[0]) - int(used0.split()[0])
            log(f"fleet: device memory a worker {grew / FLEET_WORKERS:.0f} "
                f"MiB (the device's {grew} MiB growth over the boot / "
                f"{FLEET_WORKERS}; nvidia-smi lists none of the workers' "
                "pids)")

        # Aggregates at 4 workers, on the fresh drives.
        rates = {FLEET_WORKERS: fleet_rates(c, rng, "rate4")}

        # 1. Phase 4's 96 objects from 16 clients, then read back.
        keys = conc_keys("flt")
        data = {k: rng.bytes(n) for row in keys
                for k, n in zip(row, CONC_SIZES)}
        check(c("PUT", "/flt")[0] == 200, "make bucket flt")

        def put(_t: int, k: str) -> None:
            st, err = c("PUT", f"/flt/{k}", data[k])
            check(st == 200, f"fleet PUT {k}: {st} {err[:200]!r}")

        def get(_t: int, k: str) -> None:
            check(c("GET", f"/flt/{k}") == (200, data[k]),
                  f"fleet GET {k} differs")
        wall_put = run_clients(put, keys)
        wall_get = run_clients(get, keys)
        total = sum(map(len, data.values())) / MIB
        log(f"fleet: 96 objects ({total:.1f} MiB) PUT by 16 clients in "
            f"{wall_put:.2f} s, GET byte-identical in {wall_get:.2f} s")

        # 1b. The fleet's observability plane: one worker's trace
        # subscriber sees every worker, any worker's scrape sums them.
        fleet_observability(c, pids, keys[0][0])

        # 2. A sibling SIGKILLed while 16 clients read: it comes back.
        victim = pids[FLEET_WORKERS - 1]
        stop = threading.Event()
        failures, retried, served = [], [0], [0]
        flat = [k for row in keys for k in row]

        def reader(t: int) -> None:
            i = t
            while not stop.is_set():
                k = flat[i % len(flat)]
                for attempt in range(3):
                    try:
                        if c("GET", f"/flt/{k}") == (200, data[k]):
                            served[0] += 1
                            break
                    except (OSError, http.client.HTTPException):
                        pass
                    retried[0] += 1
                else:
                    failures.append(k)
                i += CONC_THREADS
        readers = [threading.Thread(target=reader, args=(t,))
                   for t in range(CONC_THREADS)]
        for th in readers:
            th.start()
        time.sleep(1.0)
        t0 = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        new = None
        while time.perf_counter() - t0 < 30:
            new = fleet_pids(p).get(FLEET_WORKERS - 1)
            if new not in (None, victim) and \
                    cuda_processes([new]).get(new):
                break
            time.sleep(0.1)
        respawn_s = time.perf_counter() - t0
        time.sleep(1.0)
        stop.set()
        for th in readers:
            th.join(120)
        check(new not in (None, victim) and respawn_s < 30,
              f"worker {FLEET_WORKERS - 1} was not respawned with a CUDA "
              f"context within 30 s: {p.lines[-10:]}")
        check(not failures, f"reads failed through the respawn: "
              f"{failures[:5]}")
        log(f"fleet: worker {FLEET_WORKERS - 1} (pid {victim}) SIGKILLed; "
            f"pid {new} serving with its context after {respawn_s:.2f} s; "
            f"{served[0]} GETs served meanwhile, {retried[0]} retried, "
            "0 failed")

        # 3. Cross-worker coherence: every read after a write sees it
        # (the respawned worker among the rest).
        stale = []
        pool = ThreadPoolExecutor(max_workers=FLEET_GETS)
        small_key, big_key = "coh/small", "coh/big"
        t0 = time.perf_counter()
        for r in range(FLEET_ROUNDS):
            key = small_key if r % 2 == 0 else big_key
            body = rng.bytes(1024 if key == small_key else MIB)
            check(c("PUT", f"/flt/{key}", body)[0] == 200, "round PUT")
            got = list(pool.map(lambda _: c("GET", f"/flt/{key}"),
                                range(FLEET_GETS)))
            stale += [(r, "put", st) for st, b in got
                      if (st, b) != (200, body)]
            check(c("DELETE", f"/flt/{key}")[0] == 204, "round DELETE")
            got = list(pool.map(lambda _: c("GET", f"/flt/{key}")[0],
                                range(FLEET_GETS)))
            stale += [(r, "delete", st) for st in got if st != 404]
            check(c("PUT", f"/flt/{key}", body)[0] == 200, "round PUT")
            st, page, _ = c.send("GET", "/flt",
                                 query={"list-type": "2", "prefix": key})
            if st != 200 or f"<Key>{key}</Key>".encode() not in page:
                stale.append((r, "list", st))
        pool.shutdown()
        check(not stale, f"stale reads across workers: {stale[:10]}")
        log(f"fleet: {FLEET_ROUNDS} overwrite/delete/list rounds (1 KiB "
            f"and 1 MiB keys, {FLEET_GETS} fresh GETs after each write) in "
            f"{time.perf_counter() - t0:.2f} s: 0 stale reads")

        # 4. SIGTERM to the parent: every worker drains and stamps.
        t0 = time.perf_counter()
        p.proc.send_signal(signal.SIGTERM)
        rc = p.proc.wait(timeout=60)
        drain_s = time.perf_counter() - t0
        p.reader.join(30)
        check(rc == 0 and drain_s < 20, f"the fleet's SIGTERM drain: exit "
              f"{rc} after {drain_s:.2f} s: {p.lines[-10:]}")
        per_worker = {}
        for ln in p.lines:
            if " kernel launches while serving: " in ln \
                    and ln.startswith("worker "):
                per_worker[int(ln.split()[1])] = json.loads(
                    ln.split(": ", 1)[1])
        check(sorted(per_worker) == list(range(FLEET_WORKERS)),
              f"launch lines of workers {sorted(per_worker)} only")
        for w, n in per_worker.items():
            check(n["gf_apply"] > 0 and n["highwayhash256"] > 0,
                  f"worker {w} did not launch both kernels: {n}")
        missing = [d for d in drives if not os.path.exists(
            os.path.join(d, ".mtpu.sys", CLEAN_SHUTDOWN_FILE))]
        check(not missing, f"drives without the clean-shutdown stamp: "
              f"{missing}")
        log(f"fleet: SIGTERM drained every worker, parent exit 0 in "
            f"{drain_s:.2f} s, 12 drives stamped; launches by worker "
            f"(the respawned one's since its boot) "
            f"{dict(sorted(per_worker.items()))}")
    finally:
        p.kill()

    # The same aggregates from one worker, on fresh drives.
    one = ServerProc([os.path.join(root, "fleet1", f"d{i}")
                      for i in range(12)], ("--scanner-interval", "0"),
                     device, workers=1, env=caches_on)
    try:
        rates[1] = fleet_rates(one.client, rng, "rate1")
    finally:
        one.stop()
    card = smi("--query-gpu=name,power.limit")
    for w, (keys_s, mib_s, floor) in sorted(rates.items()):
        log(f"fleet: {w} worker(s), 16 clients: 1 KiB PUT {keys_s:.1f} "
            f"keys/s, 1 MiB PUT+GET {mib_s:.1f} MiB/s, HTTP floor (live "
            f"probes) {floor:.1f} requests/s ({card}, nproc "
            f"{os.cpu_count()})")
    return {k: sum(n[k] for n in per_worker.values())
            for k in ("gf_apply", "highwayhash256")}


def release(rows) -> None:
    """Return the pool leases a framer's rows hold."""
    from minio_tpu_torch.io.bufpool import leases_of
    for h in leases_of(rows):
        h.release()


def mean_ms(hist: dict) -> float:
    return hist["sum"] / max(1, hist["count"]) * 1e3


def solo_dispatch_ms(torch, rng, stats: dict, runs: int = 5) -> dict:
    """Host-clock ms of each route's device function alone, with no
    request threads around, at every bucket the route used in the
    concurrent phase; then each route's lane service mean beside the solo
    time weighted by that route's own bucket counts."""
    from minio_tpu_torch.ops import gf256, hh_device, rs_device
    pm = gf256.parity_matrix(K, M)
    routes = stats["routes"]
    most = max(max(routes[r]["buckets"], default=8)
               for r in ("put", "get", "reconstruct"))
    win = rng.integers(0, 256, size=(most, K, SHARD), dtype=np.uint8)
    framed = rng.integers(0, 256, size=(most, K, 32 + SHARD),
                          dtype=np.uint8)
    fns = {"put": (hh_device.make_mesh_framer(pm, "cuda"), win),
           "get": (hh_device.make_mesh_deframer(K, "cuda"), framed),
           "reconstruct": (rs_device.make_mesh_matrix(decode_rows(), "cuda"),
                           win)}
    out = {}
    for route, (fn, x) in fns.items():
        used = routes[route]["buckets"]
        solo = {}
        for b in sorted(used):
            release(fn(x[:b]))
            t0 = time.perf_counter()
            for _ in range(runs):
                release(fn(x[:b]))
            solo[b] = (time.perf_counter() - t0) / runs * 1e3
        weighted = sum(solo[b] * n for b, n in used.items()) \
            / max(1, sum(used.values()))
        r = routes[route]
        rt, wait, service = (mean_ms(r[f"lane_{p}_hist"]) for p in
                             ("round_trip", "wait", "service"))
        log(f"solo {route} device function, no request threads: "
            + ", ".join(f"bucket {b} {ms:.3f} ms" for b, ms in solo.items())
            + f"; weighted by the phase's buckets {weighted:.3f} ms")
        log(f"lane {route} means: round trip {rt:.3f} ms = wait {wait:.3f} "
            f"+ service {service:.3f} + handoffs {rt - wait - service:.3f}; "
            f"service / solo at its buckets {service / weighted:.2f}x")
        out[route] = solo
    return out


PL_WORKERS = 2                  # the fleet of the phase's servers
PL_CLIENTS = 16
PL_BIG, PL_N_BIG = 16 * MIB, 12  # MinIO's object size in 4e (24 before 4i)
PL_RAGGED = 64 * MIB + 1
PL_MP_PARTS = 8                 # a multipart of 8 x AWS_PART
PL_SMALL = 20                   # keys of 1 KiB (50 until phase 4j)
PL_VKEYS, PL_VERSIONS, PL_MARKERS = 20, 3, 10   # (50, 3, 25 until 4j)
PL_VBODY = 4 * 1024
PL_RATE_KEYS = 8                # 1 KiB PUTs a client for each rate (16
                                # until phase 4j)
PL_LIVE_KEYS = 2                # keys a live client overwrites in turn (4
                                # until phase 4j)
PL_SAMPLE = 8                   # migrated 16 MiB objects recomputed
PL_WALK_WORKERS = "4"           # MTPU_REBALANCE_WORKERS of the servers
PL_K, PL_M = 12, 4              # pool 2's geometry


def fleet_stop(p: "ServerProc") -> dict:
    """SIGTERM to a fleet's parent: every worker drains and prints its
    launches; their sum, gf_apply also by "k,r"."""
    import signal
    p.proc.send_signal(signal.SIGTERM)
    try:
        rc = p.proc.wait(timeout=60)
    finally:
        p.kill()
    p.reader.join(30)
    lines = [ln for ln in p.lines if ln.startswith("worker ")
             and " kernel launches while serving: " in ln]
    check(rc == 0 and len(lines) == PL_WORKERS,
          f"the fleet's drain: exit {rc}, {len(lines)} launch lines: "
          f"{p.lines[-10:]}")
    out = {"gf_apply": 0, "highwayhash256": 0, "gf_apply_by_kr": {}}
    for ln in lines:
        n = json.loads(ln.split(": ", 1)[1])
        out["gf_apply"] += n["gf_apply"]
        out["highwayhash256"] += n["highwayhash256"]
        for kr, v in n["gf_apply_by_kr"].items():
            out["gf_apply_by_kr"][kr] = out["gf_apply_by_kr"].get(kr, 0) + v
    return out


def journals(drive: str) -> list[str]:
    """Every key's journal on a drive (the system volume left out)."""
    return [os.path.relpath(dp, drive) for dp, _, fs in os.walk(drive)
            if "xl.meta" in fs
            and os.path.relpath(dp, drive).split(os.sep)[0] != ".mtpu.sys"]


def plain_shard_files(objs: dict) -> dict:
    """key -> the 12+4 shard files (`digest || block` of every erasure
    block, by shard index) of each object's bytes, from the port's plain
    PyTorch GF apply and HighwayHash on the CPU."""
    import torch
    from minio_tpu_torch.erasure.codec import Erasure
    from minio_tpu_torch.ops import gf256, hh_device, rs_device
    from minio_tpu_torch.utils.highwayhash import MAGIC_KEY
    # Two of the host's cores: the servers beside it are the phase.
    torch.set_num_threads(2)
    e = Erasure(PL_K, PL_M, MIB)
    pm = gf256.parity_matrix(PL_K, PL_M)
    rows = PL_K + PL_M
    out = {}
    for key, data in objs.items():
        blocks = [data[o:o + MIB] for o in range(0, len(data), MIB)]
        frames: list[list] = [[] for _ in range(rows)]
        for g in range(0, len(blocks), 16):      # 256 hashed rows a call
            group = blocks[g:g + 16]
            sizes = {len(b) for b in group}
            for size in sorted(sizes, reverse=True):
                same = [b for b in group if len(b) == size]
                shards = torch.from_numpy(np.stack([e.split(b)
                                                    for b in same]))
                full = torch.cat([shards, rs_device.gf_apply(pm, shards)], 1)
                digs = hh_device.hash_blocks_device(
                    MAGIC_KEY, full.reshape(-1, full.shape[-1]))
                digs = digs.reshape(len(same), rows, 32)
                for b in range(len(same)):
                    for j in range(rows):
                        frames[j].append(bytes(digs[b, j].numpy())
                                         + bytes(full[b, j].numpy()))
        out[key] = [b"".join(f) for f in frames]
    return out


def phase_pools(rng, root: str, device: str = "cuda") -> dict:
    """Pools on the card (phase 4g): load a 2 x 12 pool, expand with a
    1 x 16 pool at EC 12+4, rebalance, decommission the first pool and
    restart without it, all under live clients; returns the launches
    the fleets' workers printed."""
    import uuid
    from minio_tpu_torch.object.erasure_object import hash_order
    from minio_tpu_torch.utils.siphash import sip_hash_mod
    import torch
    t_phase = time.perf_counter()
    threads = torch.get_num_threads()
    env = {"MTPU_FILEINFO_CACHE": "on", "MTPU_HOT_CACHE": "on",
           "MTPU_REBALANCE_WORKERS": PL_WALK_WORKERS}
    extra = ("--scanner-interval", "0")
    p1 = [os.path.join(root, "p1", f"d{i}") for i in range(1, 25)]
    p2 = [os.path.join(root, "p2", f"d{i}") for i in range(1, 17)]
    arg1 = os.path.join(root, "p1", "d{1...24}")
    arg2 = os.path.join(root, "p2", "d{1...16}")
    launches = {"gf_apply": 0, "highwayhash256": 0, "gf_apply_by_kr": {}}

    def add(n: dict) -> None:
        launches["gf_apply"] += n["gf_apply"]
        launches["highwayhash256"] += n["highwayhash256"]
        for kr, v in n["gf_apply_by_kr"].items():
            launches["gf_apply_by_kr"][kr] = \
                launches["gf_apply_by_kr"].get(kr, 0) + v

    # What the phase wrote: (bucket, key) -> bytes; versions apart.
    pool = rng.bytes(PL_N_BIG * PL_BIG + PL_RAGGED + PL_MP_PARTS * AWS_PART)
    view = memoryview(pool)
    objs = {("g4b", f"big/{i:03d}"): view[i * PL_BIG:(i + 1) * PL_BIG]
            for i in range(PL_N_BIG)}
    o = PL_N_BIG * PL_BIG
    objs["g4b", "ragged"] = view[o:o + PL_RAGGED]
    o += PL_RAGGED
    parts = [bytes(view[o + n * AWS_PART:o + (n + 1) * AWS_PART])
             for n in range(PL_MP_PARTS)]
    small = rng.bytes(PL_SMALL * 1024)
    for i in range(PL_SMALL):
        objs["g4b", f"small/{i:04d}"] = small[i * 1024:(i + 1) * 1024]
    etags: dict = {}
    versions: dict = {}             # key -> [(version id, etag or marker)]
    sample = sorted(k for b, k in objs if k.startswith("big/"))[::6]
    sample = sample[:PL_SAMPLE] + ["ragged"]
    want_files: dict = {}
    plain = threading.Thread(target=lambda: want_files.update(
        plain_shard_files({k: bytes(objs["g4b", k]) for k in sample})),
        daemon=True, name="plain-shards")
    plain.start()

    def rate(c: "Client", tag: str) -> float:
        """1 KiB PUT keys/s from 16 clients; the keys are deleted after
        (DeleteObjects), so that no walk moves them."""
        bodies = rng.bytes(PL_CLIENTS * PL_RATE_KEYS * 1024)
        keys = [f"{tag}/c{t:02d}/k{i:03d}" for t in range(PL_CLIENTS)
                for i in range(PL_RATE_KEYS)]

        def put(t: int, i: int) -> None:
            key = keys[t * PL_RATE_KEYS + i]
            b = bodies[(t * PL_RATE_KEYS + i) * 1024:][:1024]
            st, _ = c("PUT", f"/g4r/{key}", b)
            check(st == 200, f"rate PUT {key}: {st}")
        wall = run_clients(put, [range(PL_RATE_KEYS)] * PL_CLIENTS)
        delete_objects(c, "g4r", [(k, "") for k in keys])
        return PL_CLIENTS * PL_RATE_KEYS / wall

    def read_all(c: "Client", what: str) -> float:
        def get(_t: int, bk) -> None:
            st, body, h = c.send("GET", f"/{bk[0]}/{bk[1]}")
            check(st == 200 and body == objs[bk],
                  f"{what}: GET {bk[0]}/{bk[1]}: {st}")
            if bk in etags:
                check(h["etag"] == etags[bk], f"{what}: ETag of {bk}")
        items = sorted(objs)
        wall = run_clients(get, [items[t::PL_CLIENTS]
                                 for t in range(PL_CLIENTS)])
        listed = []
        marker = ""
        while True:
            st, body, _ = c.send("GET", "/g4v", query={
                "versions": "", "key-marker": marker,
                **({"version-id-marker": vm} if marker else {})})
            check(st == 200, f"{what}: list versions {st}")
            for e in xml_entries(body, "Version") + \
                    xml_entries(body, "DeleteMarker"):
                listed.append((e["Key"], e["VersionId"],
                               e.get("ETag", "marker")))
            if xml_tag(body, "IsTruncated") != "true":
                break
            marker = xml_tag(body, "NextKeyMarker")
            vm = xml_tag(body, "NextVersionIdMarker")
        want = sorted((k, vid, tag) for k, vs in versions.items()
                      for vid, tag in vs)
        check(sorted(listed) == want, f"{what}: the version listing "
              f"differs: {len(listed)} entries against {len(want)}")
        for k, vs in versions.items():
            for vid, tag in vs:
                if tag != "marker":
                    st, body, h = c.send("GET", f"/g4v/{k}",
                                         query={"versionId": vid})
                    check(st == 200 and h["etag"] == tag,
                          f"{what}: GET {k}?versionId={vid}: {st}")
        return wall

    # -- 1. one pool of 2 x 12 at EC 8+4, loaded ------------------------
    p = ServerProc([arg1], extra, device, workers=PL_WORKERS, env=env)
    try:
        c = p.client
        boot_s = p.t_serving - p.t_start
        check("2 sets x 12, EC 8+4" in p.line("serving S3 on"),
              f"pool 1's layout: {p.line('serving S3 on')}")
        for b in ("g4b", "g4v", "g4r", "g4l"):
            check(c("PUT", f"/{b}")[0] == 200, f"make bucket {b}")
        check(c.send("PUT", "/g4v", VERSIONING.format("Enabled").encode(),
                     query={"versioning": ""})[0] == 200, "versioning")
        t0 = time.perf_counter()

        def put(_t: int, bk) -> None:
            st, err, h = c.send("PUT", f"/{bk[0]}/{bk[1]}", bytes(objs[bk]))
            check(st == 200, f"PUT {bk}: {st} {err[:200]!r}")
            etags[bk] = h["etag"]
        items = sorted(objs)
        run_clients(put, [items[t::PL_CLIENTS] for t in range(PL_CLIENTS)])
        objs["g4b", "mp"] = b"".join(parts)
        etags["g4b", "mp"] = mp_upload(c, "/g4b/mp", parts, PL_MP_PARTS)
        vbody = rng.bytes(PL_VKEYS * PL_VERSIONS * PL_VBODY)

        def put_versions(_t: int, k: int) -> None:
            key, got = f"v{k:03d}", []
            for v in range(PL_VERSIONS):
                o = (k * PL_VERSIONS + v) * PL_VBODY
                st, _, h = c.send("PUT", f"/g4v/{key}",
                                  vbody[o:o + PL_VBODY])
                check(st == 200, f"PUT {key} #{v}: {st}")
                got.append((h["x-amz-version-id"], h["etag"]))
            if k < PL_MARKERS:
                st, _, h = c.send("DELETE", f"/g4v/{key}")
                check(st == 204 and h.get("x-amz-delete-marker") == "true",
                      f"marker on {key}: {st}")
                got.append((h["x-amz-version-id"], "marker"))
            versions[key] = got
        run_clients(put_versions, [range(t, PL_VKEYS, PL_CLIENTS)
                                   for t in range(PL_CLIENTS)])
        wall_load = time.perf_counter() - t0
        rate1 = rate(c, "one")
        dep = json.load(open(os.path.join(p1[0], ".mtpu.sys",
                                          "format.json")))["id"]
        dep_bytes = uuid.UUID(dep).bytes
        per_set = [0, 0]
        for b, k in [*objs, *[("g4v", k) for k in versions]]:
            s = sip_hash_mod(k, 2, dep_bytes)
            held = [i for i, d in enumerate(p1)
                    if os.path.exists(os.path.join(d, b, k, "xl.meta"))]
            check(held == list(range(12 * s, 12 * s + 12)),
                  f"{b}/{k}: journals on drives {held}, SipHash names "
                  f"set {s}")
            per_set[s] += 1
        loaded = sum(map(len, objs.values())) + len(vbody)
        log(f"pools: pool 1 (2 x 12, EC 8+4, {PL_WORKERS} workers) up in "
            f"{boot_s:.2f} s; {PL_CLIENTS} clients loaded "
            f"{loaded / MIB:.1f} MiB in {wall_load:.2f} s ({PL_N_BIG} x 16 "
            f"MiB, 64 MiB + 1 B, a multipart of {PL_MP_PARTS} x 8 MiB, "
            f"{PL_SMALL} x 1 KiB, {PL_VKEYS} keys x {PL_VERSIONS} versions "
            f"and {PL_MARKERS} markers); every journal on the 12 drives "
            f"of the set sip_hash_mod names: {per_set[0]} keys in set 0, "
            f"{per_set[1]} in set 1")
    finally:
        n1 = fleet_stop(p)
        add(n1)

    # -- 2. expanded by a pool of 1 x 16 at EC 12+4 ---------------------
    live_keys: dict = {}
    small_keys = [k for b, k in objs if k.startswith("small/")]

    def walk(c: "Client", start: str, query: dict, status: str) -> dict:
        """The walk under 4e's live clients, started 1 s before it: each
        makes DP_LIVE_KEYS PUT-then-GET pairs of 1 MiB, DP_LIVE_PAUSE
        apart, overwriting its PL_LIVE_KEYS keys in turn, and reads a
        preloaded 1 KiB key after each; returns the walk's final status
        with the clients' counts and how long they ran."""
        failed, stale, pairs, ran = [], [], [0], []
        live_pool = rng.bytes(64 * MIB)

        def client(t: int) -> None:
            t0 = time.time()
            for i in range(DP_LIVE_KEYS):
                key = f"t{t:02d}/k{i % PL_LIVE_KEYS}"
                o = (t * 7919 + i * 104729) % (63 * MIB)
                body = live_pool[o:o + MIB]
                small_k = small_keys[(t * 31 + i) % len(small_keys)]
                try:
                    before = live_keys.get(("g4l", key))
                    st, _ = c("PUT", f"/g4l/{key}", body)
                    if st != 200:
                        failed.append(f"PUT {key}: {st}")
                        continue
                    live_keys["g4l", key] = body
                    st, got, h = c.send("GET", f"/g4l/{key}")
                    if st != 200:
                        failed.append(f"GET {key}: {st}")
                    elif got != body:
                        stale.append(
                            f"GET {key} at pair {i}, {time.time() - t0:.2f} "
                            f"s in: {'the previous body' if got == before else 'an unknown body'}, "
                            f"ETag {h.get('etag')}, {h.get('last-modified')}")
                    st, got = c("GET", f"/g4b/{small_k}")
                    if st != 200:
                        failed.append(f"GET {small_k}: {st}")
                    elif got != objs["g4b", small_k]:
                        stale.append(f"GET {small_k}")
                    pairs[0] += 1
                except (OSError, http.client.HTTPException) as e:
                    failed.append(f"{key}: {e!r}")
                time.sleep(DP_LIVE_PAUSE)
            ran.append(time.time() - t0)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(PL_CLIENTS)]
        for th in threads:
            th.start()
        try:
            time.sleep(1.0)
            st, err, _ = c.send("POST", f"/minio/admin/v3/{start}",
                                query=query)
            check(st == 200, f"{start}: {st} {err[:300]!r}")
            t0 = time.perf_counter()
            while True:
                st, body, _ = c.send("GET", f"/minio/admin/v3/{status}")
                doc = json.loads(body) if body else {}
                if st == 200 and doc.get("status") in ("complete",
                                                       "failed"):
                    break
                check(time.perf_counter() - t0 < 600,
                      f"{status} after 600 s: {st} {body[:300]!r}")
                time.sleep(0.2)
        finally:
            for th in threads:
                th.join(600)
        check(not any(th.is_alive() for th in threads), "a live client hung")
        check(doc["status"] == "complete", f"{start} ended {doc}")
        check(not failed and not stale, f"client reads during {start}: "
              f"failed {failed[:5]}, stale {stale[:5]}")
        doc["client_pairs"] = pairs[0]
        doc["client_s"] = (min(ran), max(ran))
        return doc

    card = smi("--query-gpu=name,power.limit")

    def report(what: str, doc: dict, rec: dict, n: dict) -> None:
        wall = (doc["finished_ns"] - doc["started_ns"]) / 1e9
        moved = rec.get("bytes_moved", 0)
        log(f"pools: {what}: {rec['migrated']} keys and {moved} B moved "
            f"in {wall:.2f} s ({rec['migrated'] / wall:.1f} keys/s, "
            f"{moved / MIB / wall:.1f} MiB/s), {doc.get('yields', 0)} "
            f"yields to clients; {PL_CLIENTS} live clients' "
            f"{doc['client_pairs']} PUT+GET pairs (each client ran "
            f"{doc['client_s'][0]:.2f}-{doc['client_s'][1]:.2f} s from 1 s "
            f"before the walk): 0 failed, 0 stale reads; gf_apply launches "
            f"by k,r {n['gf_apply_by_kr']}, "
            f"highwayhash256 {n['highwayhash256']} ({card}; drives on one "
            "filesystem: every drive reports its free and total bytes, so "
            "placement and capacity favour the pool with more drives)")

    p = ServerProc([arg1, arg2], extra, device, workers=PL_WORKERS, env=env)
    try:
        c = p.client
        check("pool 1: EC 12+4" in p.line("serving S3 on"),
              f"the expanded layout: {p.line('serving S3 on')}")
        ids = {json.load(open(os.path.join(d, ".mtpu.sys",
                                           "format.json")))["id"]
               for d in p2}
        check(ids == {dep}, f"pool 2 formatted under {ids}, not {dep}")
        wall_read = read_all(c, "expanded")
        rate2 = rate(c, "two")
        log(f"pools: restarted with pool 2 (1 x 16, EC 12+4) under "
            f"deployment {dep}; every key and version read back in "
            f"{wall_read:.2f} s; 1 KiB PUTs from {PL_CLIENTS} clients: "
            f"{rate1:.1f} keys/s on 1 pool, {rate2:.1f} on 2 ({card})")
        rb = walk(c, "rebalance-start", {}, "rebalance-status")
    finally:
        n2 = fleet_stop(p)
        add(n2)
    objs.update(live_keys)
    report("rebalance", rb, rb["pools"]["0"], n2)

    p = ServerProc([arg1, arg2], extra, device, workers=PL_WORKERS, env=env)
    try:
        dc = walk(p.client, "decommission", {"pool": "0"},
                  "decommission-status")
    finally:
        n3 = fleet_stop(p)
        add(n3)
    objs.update(live_keys)
    report("decommission of pool 1", dc, dc, n3)
    left = [j for d in p1 for j in journals(d)]
    check(not left, f"journals left on pool 1: {left[:5]}")
    k12 = n2["gf_apply_by_kr"].get(f"{PL_K},{PL_M}", 0) + \
        n3["gf_apply_by_kr"].get(f"{PL_K},{PL_M}", 0)
    check(k12 > 0, "gf_apply never launched at k = 12")

    # -- 4. pool 2 alone -------------------------------------------------
    p = ServerProc([arg2], extra, device, workers=PL_WORKERS, env=env)
    try:
        wall_read = read_all(p.client, "pool 2 alone")
    finally:
        add(fleet_stop(p))
    log(f"pools: restarted on pool 2 alone: {len(objs)} keys (the live "
        f"clients' {len(live_keys)} acknowledged ones among them) and "
        f"{sum(map(len, versions.values()))} versions and markers read "
        f"back byte for byte with their version ids and ETags in "
        f"{wall_read:.2f} s")

    # -- 5. the shard files against the plain path -----------------------
    t0 = time.perf_counter()
    plain.join(600)
    wait_plain = time.perf_counter() - t0
    torch.set_num_threads(threads)
    check(sorted(want_files) == sorted(sample),
          "the plain shard files were not computed")
    for key in sample:
        dist = hash_order(f"g4b/{key}", PL_K + PL_M)
        for i, d in enumerate(p2):
            kdir = os.path.join(d, "g4b", key)
            got = [os.path.join(kdir, s, "part.1") for s in os.listdir(kdir)
                   if os.path.exists(os.path.join(kdir, s, "part.1"))]
            check(len(got) == 1 and open(got[0], "rb").read()
                  == want_files[key][dist[i] - 1],
                  f"{key}: drive {i}'s shard file differs from the plain "
                  "path's")
    log(f"pools: the shard files of {len(sample)} migrated objects "
        f"({len(sample) - 1} x 16 MiB and 64 MiB + 1 B) on pool 2's 16 "
        "drives equal the plain PyTorch path's 12+4 encode and digests on the "
        f"CPU ({wait_plain:.1f} s waited for it at the end); launches "
        f"{launches}; phase {time.perf_counter() - t_phase:.1f} s")
    return launches


DI_NODES, DI_DRIVES = 4, 4       # MinIO's multi-node multi-drive guide
DI_HTTP_WORKERS = (2, 1, 1, 1)   # MTPU_HTTP_WORKERS of each node
DI_CLIENTS = 16
DI_BIG, DI_N_BIG = 16 * MIB, 8    # (32 before phase 4i, 16 before 4j)
DI_RAGGED = 64 * MIB + 1
DI_MP_PARTS = 4                 # a multipart of 4 x AWS_PART
DI_SMALL = 50                   # keys of 1 KiB (250 until phase 4j)
DI_LOCK_KEYS, DI_LOCK_S = 8, 5.0    # keys 16 clients overwrite, seconds
                                    # (10 s until phase 4j)
DI_LOCK_BODY = 64 * 1024
DI_LIVE_SIZE = MIB              # the paced clients' PUT+GET pairs
DI_LIVE_PAUSE = 0.25            # seconds between a client's pairs
DI_LIVE_BEFORE, DI_LIVE_AFTER = 2.0, 3.0   # seconds around the kill (7 s
                                           # after it until phase 4j)
DI_DRIVE_TIMEOUT = 10.0         # the nodes' --drive-timeout (default)
GRID_PORT_OFFSET = 1000         # minio_tpu_torch.server's
DI_COH_KEYS = 8                 # keys overwritten through node 1 a round
DI_COH_ROUNDS = 4               # rounds of the coherence step
DI_COH_READS = 3                # reads of a key through a node a round
DI_COH_SIZES = (MIB, 64 * 1024)  # the coherence keys' sizes, alternating
DI_SMALL_PUTS = 16              # 1 KiB PUTs a client for the small-PUT rate


def bindable(port: int) -> bool:
    import socket
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
            return True
        except OSError:
            return False


def node_ports(n: int) -> list[int]:
    """n S3 ports whose grid ports (+1000) are free too, below the
    kernel's ephemeral range where it leaves room (a restarted node
    binds its ports again, and an outgoing connection may hold a port
    of that range meanwhile)."""
    import random
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        lo, hi = (int(x) for x in f.read().split())
    top = lo - GRID_PORT_OFFSET - n if lo > 12000 else 28000
    log(f"4h: ephemeral ports {lo}-{hi}; node ports under {top}")
    for _ in range(200):
        base = random.randrange(10000, top)
        ports = [base + i for i in range(n)]
        if all(bindable(p) and bindable(p + GRID_PORT_OFFSET)
               for p in ports):
            return ports
    raise RuntimeError("no free ports for the nodes")


def clean_stop(p: "ServerProc") -> None:
    """SIGINT to one process, SIGTERM to a fleet's parent."""
    import signal
    p.proc.send_signal(signal.SIGTERM if p.workers > 1 else signal.SIGINT)


def summaries(p: "ServerProc") -> dict:
    """Once a clean stop was sent: the sums of what the node's workers
    printed at their drain: launches, gf_apply's by "k,r", and the
    dsync locks taken, refused and their acquire histogram, the grid
    peers' breaker stats ("peers", of the last worker printing them)
    and each worker's control-plane line ("control")."""
    from minio_tpu_torch.utils.latency import Histogram
    try:
        rc = p.proc.wait(timeout=120)
    finally:
        p.kill()
    p.reader.join(30)
    check(rc == 0, f"the node's clean stop exited {rc}: {p.lines[-20:]}")
    out = {"gf_apply": 0, "highwayhash256": 0, "gf_apply_by_kr": {},
           "locks": 0, "refused": 0, "hists": [], "peers": [],
           "control": []}
    runs = [ln for ln in p.lines
            if "kernel launches while serving: " in ln]
    check(len(runs) == p.workers, f"{len(runs)} launch lines from "
          f"{p.workers} workers: {p.lines[-10:]}")
    for ln in runs:
        n = json.loads(ln.split(": ", 1)[1])
        out["gf_apply"] += n["gf_apply"]
        out["highwayhash256"] += n["highwayhash256"]
        for kr, v in n["gf_apply_by_kr"].items():
            out["gf_apply_by_kr"][kr] = out["gf_apply_by_kr"].get(kr, 0) + v
    for ln in p.lines:
        if "dsync locks while serving: " in ln:
            n = json.loads(ln.split(": ", 1)[1])
            out["locks"] += n["taken"]
            out["refused"] += n["refused"]
            out["hists"].append(n["acquire_hist"])
        if "grid peers: " in ln:
            out["peers"] = json.loads(ln.split(": ", 1)[1])
        if "control plane while serving: " in ln:
            out["control"].append(json.loads(ln.split(": ", 1)[1]))
    out["acquire"] = Histogram.merge(out["hists"])
    return out


def di_load(nodes: list, objs: dict, parts: list, what: str) -> tuple:
    """16 clients load `objs` (bucket "g4h") and the multipart object,
    client t through node t mod the node count; every key is read back
    through the node after its writer. (PUT MiB/s, GET MiB/s, lost,
    differing)."""
    n = len(nodes)
    keys = sorted(objs)
    st, _ = nodes[0].client("PUT", "/g4h")
    check(st == 200, f"{what}: make bucket: {st}")
    writer: dict = {}

    def put(t: int, key: str) -> None:
        writer[key] = t % n
        st, body = nodes[t % n].client("PUT", f"/g4h/{key}", objs[key])
        check(st == 200, f"{what}: PUT {key} through node {t % n}: {st} "
              f"{body[:200]!r}")
    t0 = time.perf_counter()
    wall = run_clients(put, [keys[t::DI_CLIENTS] for t in range(DI_CLIENTS)])
    mp = b"".join(parts)
    mp_upload(nodes[1 % n].client, "/g4h/mp", parts, DI_MP_PARTS)
    writer["mp"] = 1 % n
    put_wall = time.perf_counter() - t0
    total = sum(len(v) for v in objs.values()) + len(mp)
    bad = {"lost": 0, "differing": 0}

    def get(t: int, key: str) -> None:
        node = (writer[key] + 1) % n
        st, body, _ = nodes[node].client.send("GET", f"/g4h/{key}")
        want = mp if key == "mp" else objs[key]
        if st != 200:
            bad["lost"] += 1
            log(f"{what}: GET {key} through node {node}: {st}")
        elif body != want:
            bad["differing"] += 1
    t0 = time.perf_counter()
    run_clients(get, [(keys + ["mp"])[t::DI_CLIENTS]
                      for t in range(DI_CLIENTS)])
    get_wall = time.perf_counter() - t0
    log(f"{what}: PUT {total / MIB:.1f} MiB ({len(objs) + 1} keys) in "
        f"{put_wall:.2f} s ({wall:.2f} s without the multipart), "
        f"{total / MIB / put_wall:.1f} MiB/s; GET through another node "
        f"{get_wall:.2f} s, {total / MIB / get_wall:.1f} MiB/s; lost "
        f"{bad['lost']}, differing {bad['differing']}")
    check(bad["lost"] == 0 and bad["differing"] == 0,
          f"{what}: {bad} after the load")
    return total / MIB / put_wall, total / MIB / get_wall


def read_back(nodes: list, objs: dict, what: str,
              retry_s: float = 0.0) -> int:
    """Every key of `objs` ({path: bytes}) read through `nodes` in turn
    by 16 clients; a 503 is retried for up to `retry_s` seconds (and
    counted). Raises on a lost or differing key; returns the retries."""
    keys = sorted(objs)
    retries = [0]

    def get(t: int, key: str) -> None:
        node = nodes[t % len(nodes)]
        end = time.monotonic() + retry_s
        while True:
            st, body, _ = node.client.send("GET", key)
            if st != 503 or time.monotonic() > end:
                break
            retries[0] += 1
            time.sleep(0.5)
        check(st == 200 and body == objs[key],
              f"{what}: GET {key}: {st} ({len(body)} bytes, want "
              f"{len(objs[key])})")
    wall = run_clients(get, [keys[t::DI_CLIENTS] for t in range(DI_CLIENTS)])
    log(f"{what}: {len(keys)} keys byte for byte in {wall:.2f} s "
        f"({retries[0]} GETs retried after a 503)")
    return retries[0]


def node_info(p: "ServerProc") -> dict:
    """GET /minio/admin/v3/info of the worker the connection reached:
    its node, worker, pid, coherence (worker 0: the protocol's stats; a
    sibling: {"gate": verdict}) and read caches' counters."""
    st, body, _ = p.client.send("GET", "/minio/admin/v3/info")
    check(st == 200, f"admin info: {st} {body[:200]!r}")
    return json.loads(body)


def worker_infos(p: "ServerProc", tries: int = 0) -> dict:
    """worker id -> its info, over fresh connections until every worker
    of the node answered (the kernel spreads them)."""
    out: dict = {}
    for _ in range(tries or 12 * p.workers):
        d = node_info(p)
        out[d["worker"]] = d
        if len(out) == p.workers:
            break
    check(len(out) == p.workers, f"admin info reached workers "
          f"{sorted(out)} of {p.workers}")
    return out


def coherent(doc: dict) -> bool:
    coh = doc["coherence"] or {}
    return bool(coh.get("coherent", coh.get("gate")))


def wait_armed(nodes: list, what: str, timeout: float = 60.0) -> dict:
    """Until every worker 0 reports all its peers armed and every sibling
    its gate open; {node index: worker 0's coherence stats}."""
    t0 = time.perf_counter()
    while True:
        infos = [worker_infos(p) for p in nodes]
        if all(coherent(d) for inf in infos for d in inf.values()):
            return {i: next(d["coherence"] for d in inf.values()
                            if "armed" in (d["coherence"] or {}))
                    for i, inf in enumerate(infos)}
        check(time.perf_counter() - t0 < timeout, f"{what}: not armed "
              f"after {timeout:.0f} s: " + json.dumps(
                  [{w: d["coherence"] for w, d in inf.items()}
                   for inf in infos])[:1500])
        time.sleep(0.25)


def coherence_rounds(writer: "ServerProc", readers: list, rng,
                     what: str, retry_s: float = 0.0) -> tuple[int, int]:
    """DI_COH_ROUNDS rounds: DI_COH_KEYS keys (half 64 KiB, half 1 MiB)
    overwritten through `writer`, then each read DI_COH_READS times and
    HEAD twice through every reader on fresh connections (a HEAD's size
    and ETag checked against the GET's). A 503 is retried for up to
    `retry_s` seconds (a reader's breaker to a restarted node may hold
    it out until its next probe). (reads, stale); a failed read
    raises."""
    reads = stale = 0
    for r in range(DI_COH_ROUNDS):
        bodies = {f"coh/k{i}": rng.bytes(DI_COH_SIZES[i % 2])
                  for i in range(DI_COH_KEYS)}
        for key, body in bodies.items():
            st, err = writer.client("PUT", f"/g4h/{key}", body)
            check(st == 200, f"{what}: PUT {key}: {st} {err[:200]!r}")

        etags: dict = {}

        def get(t: int, item) -> None:
            nonlocal reads, stale
            p, key, method = item
            end = time.monotonic() + retry_s
            while True:
                st, got, h = p.client.send(method, f"/g4h/{key}")
                if st != 503 or time.monotonic() > end:
                    break
                time.sleep(0.5)
            check(st == 200, f"{what}: {method} {key}: {st}")
            reads += 1
            if method == "GET":
                stale += got != bodies[key]
                etags[key] = h["etag"]
            else:
                stale += int(h["content-length"]) != len(bodies[key]) \
                    or h["etag"] != etags[key]
        for method, n in (("GET", DI_COH_READS), ("HEAD", 2)):
            items = [(p, k, method) for p in readers for k in bodies
                     for _ in range(n)]
            run_clients(get, [items[t::DI_CLIENTS]
                              for t in range(DI_CLIENTS)])
    return reads, stale


def cache_hits(doc: dict) -> tuple[int, int]:
    """(fileinfo-cache hits with its stat class, hot-cache hits)."""
    fi = doc["fi_cache"]
    return fi["hits"] + fi["stat_hits"], doc["hot_cache"]["hits"]


def node_put_rate(nodes: list, rng, tag: str) -> float:
    """keys/s of 1 KiB PUTs from DI_CLIENTS clients, client t through
    node t mod the node count."""
    bodies = rng.bytes(DI_CLIENTS * DI_SMALL_PUTS * 1024)

    def put(t: int, i: int) -> None:
        o = (t * DI_SMALL_PUTS + i) * 1024
        st, _ = nodes[t % len(nodes)].client(
            "PUT", f"/g4h/{tag}/c{t:02d}/{i:03d}", bodies[o:o + 1024])
        check(st == 200, f"{tag}: 1 KiB PUT: {st}")
    wall = run_clients(put, [range(DI_SMALL_PUTS)] * DI_CLIENTS)
    return DI_CLIENTS * DI_SMALL_PUTS / wall


def lock_bodies(t: int, n: int) -> bytes:
    """Client t's n-th body for the lock step: its id, then bytes made
    from the id, so a torn or mixed body shows."""
    head = f"{t:02d}:{n:06d}:".encode()
    seed = int.from_bytes(hashlib.sha256(head).digest()[:8], "little")
    return head + np.random.default_rng(seed).bytes(DI_LOCK_BODY - len(head))


def dist_observability(nodes: list, path: str, body: bytes) -> None:
    """4h's step 1c: an armed GET through node 0 carries a `wire` span
    for each call to another node with that node's subtree stitched
    under it and tagged with its node; `?cluster=true` metrics through
    node 0 carry all four nodes."""
    n0 = nodes[0].client
    tail = TraceTail(n0.address, "all")
    t0 = time.perf_counter()
    check(n0("GET", path) == (200, body), f"4h armed GET {path}")
    get_s = time.perf_counter() - t0
    entries = tail.stop()
    roots = [e for e in entries if e.get("span") == 0
             and e.get("api") == "GET:object" and e.get("path") == path]
    check(len(roots) == 1, f"4h: {len(roots)} trace roots of the GET")
    me = roots[0].get("node")
    tree = [e for e in entries if e.get("trace") == roots[0]["trace"]]
    by_id = {e["span"]: e for e in tree}
    wires = {e["span"] for e in tree if e.get("api") == "wire"}

    def under_wire(e) -> bool:
        seen = set()
        while e is not None and e["parent"] not in seen:
            if e["parent"] in wires:
                return True
            seen.add(e["parent"])
            e = by_id.get(e["parent"])
        return False
    remote = [e for e in tree if e.get("node") not in (None, me)]
    peers = sorted({e["node"] for e in remote})
    check(remote and all(under_wire(e) for e in remote),
          f"4h: remote spans outside a wire span: "
          f"{[(e['api'], e['parent']) for e in remote if not under_wire(e)]}")
    # Node 0 holds 4 of the 16 shards: at least 8 of the 12 data shards
    # a healthy GET reads lie on two other nodes or more (the third may
    # hold parity only, and a fileinfo-cache hit reads no journal).
    check(len(peers) >= 2 and me not in peers,
          f"4h: the GET's tree holds subtrees of nodes {peers} only")
    names: dict = {}
    for e in remote:
        names[e["api"]] = names.get(e["api"], 0) + 1
    log(f"4h armed GET {path} through node 0 ({me}) in {get_s:.3f} s: "
        f"{len(tree)} spans, {len(wires)} wire spans, {len(remote)} "
        f"remote spans stitched under them from nodes {peers}: {names}")
    st, text, _ = n0.send("GET", "/minio/v2/metrics/cluster",
                          query={"cluster": "true"})
    check(st == 200, f"4h cluster metrics: {st}")
    up = {labels: v for (name, labels), v in
          prometheus_samples(text.decode()).items()
          if name == "minio_tpu_cluster_node_up"}
    log(f"4h ?cluster=true metrics through node 0: node_up {up}")
    check(len(up) == len(nodes) and all(v == 1 for v in up.values()),
          f"4h: cluster metrics carry nodes {up}")


def phase_distributed(rng, root: str, device: str = "cuda") -> dict:
    """Four port nodes serving one EC 12+4 set (phase 4h); the launches
    the surviving nodes and the one-node server printed at their clean
    stops."""
    t_phase = time.perf_counter()
    ports = node_ports(DI_NODES)
    eps = [f"http://127.0.0.1:{ports[i]}{root}/h/n{i}/d{j}"
           for i in range(DI_NODES) for j in range(1, DI_DRIVES + 1)]
    env = {"MTPU_FILEINFO_CACHE": "on", "MTPU_HOT_CACHE": "on"}
    extra = ("--scanner-interval", "0", "--drive-timeout",
             str(DI_DRIVE_TIMEOUT))

    def spawn(i: int) -> "ServerProc":
        return ServerProc(eps, extra, device, DI_HTTP_WORKERS[i], env,
                          port=ports[i], wait=False)
    launches = {"gf_apply": 0, "highwayhash256": 0, "gf_apply_by_kr": {}}
    lock_hists: list = []
    locks = refused = 0

    def add(n: dict) -> None:
        nonlocal locks, refused
        launches["gf_apply"] += n["gf_apply"]
        launches["highwayhash256"] += n["highwayhash256"]
        for kr, v in n["gf_apply_by_kr"].items():
            launches["gf_apply_by_kr"][kr] = \
                launches["gf_apply_by_kr"].get(kr, 0) + v
        lock_hists.extend(n["hists"])
        locks += n["locks"]
        refused += n["refused"]

    pool = rng.bytes(DI_N_BIG * DI_BIG + DI_RAGGED + DI_MP_PARTS * AWS_PART
                     + DI_SMALL * 1024)
    view = memoryview(pool)
    objs = {f"big/{i:03d}": view[i * DI_BIG:(i + 1) * DI_BIG]
            for i in range(DI_N_BIG)}
    o = DI_N_BIG * DI_BIG
    objs["ragged"] = view[o:o + DI_RAGGED]
    o += DI_RAGGED
    parts = [bytes(view[o + n * AWS_PART:o + (n + 1) * AWS_PART])
             for n in range(DI_MP_PARTS)]
    o += DI_MP_PARTS * AWS_PART
    for i in range(DI_SMALL):
        objs[f"small/{i:04d}"] = view[o + i * 1024:o + (i + 1) * 1024]
    every = {f"/g4h/{k}": v for k, v in objs.items()}
    every["/g4h/mp"] = b"".join(parts)
    nodes: list = []
    one = None
    try:
        # -- boot: four nodes at once, each waiting for the others' grid
        t0 = time.perf_counter()
        nodes = [spawn(i) for i in range(DI_NODES)]
        for p in nodes:
            p.wait_serving()
        boot_s = time.perf_counter() - t0
        for p in nodes:
            check(any("16 drives, EC 12+4; distributed over 4 nodes" in ln
                      for ln in p.lines), f"node boot: {p.lines[-5:]}")
        log(f"4h: 4 nodes x 4 drives, one set at EC 12+4, serving "
            f"{boot_s:.2f} s after their start (node 0: "
            f"{DI_HTTP_WORKERS[0]} workers)")
        t0 = time.perf_counter()
        armed = wait_armed(nodes, "4h boot")
        log(f"4h coherence: every node's worker 0 armed 3 of 3 peers and "
            f"node 0's sibling gate open {time.perf_counter() - t0:.2f} s "
            f"after serving (resyncs " + ", ".join(
                f"node {i} {a['resyncs']}" for i, a in armed.items()) + ")")
        check(all(a["armed"] == a["peers"] == 3 for a in armed.values()),
              f"4h: peers armed {armed}")

        # -- 1. load through every node, read back through another ----
        dist_put, dist_get = di_load(nodes, objs, parts, "4h load")

        # -- 1b. caches on: overwrites through node 1, reads elsewhere -
        t0 = time.perf_counter()
        readers = [nodes[0], nodes[2], nodes[3]]
        reads, stale = coherence_rounds(nodes[1], readers, rng,
                                        "4h coherence")
        coh_s = time.perf_counter() - t0
        hits = {i: {w: cache_hits(d) for w, d in
                    worker_infos(nodes[i]).items()} for i in (0, 2, 3)}
        small_dist = node_put_rate(nodes, rng, "rate4")
        log(f"4h coherence: {DI_COH_ROUNDS} rounds of {DI_COH_KEYS} keys "
            f"(64 KiB and 1 MiB) overwritten through node 1, {reads} reads "
            f"through nodes 0 (both workers), 2 and 3 in {coh_s:.2f} s: "
            f"{stale} stale; (fileinfo-cache, hot-cache) hits by node and "
            f"worker {hits}; 1 KiB PUTs from {DI_CLIENTS} clients over the "
            f"4 nodes {small_dist:.1f} keys/s ({smi('--query-gpu=name,power.limit')})")
        check(stale == 0, f"4h coherence: {stale} stale reads")
        check(all(h[0] > 0 and h[1] > 0 for i in (2, 3)
                  for h in hits[i].values()),
              f"4h coherence: nodes 2 and 3 served no cache hit: {hits}")
        check(len(hits[0]) == DI_HTTP_WORKERS[0] and
              all(sum(h) > 0 for h in hits[0].values()),
              f"4h coherence: a worker of node 0 served no hit: {hits[0]}")

        # -- 1c. the observability plane over the grid -----------------
        dist_observability(nodes, "/g4h/big/000",
                           bytes(objs["big/000"]))

        # -- 2. locks: 16 clients overwrite 8 keys through all nodes ---
        written: dict = {}
        fails = []
        stop = time.monotonic() + DI_LOCK_S

        def overwrite(t: int, _item) -> None:
            n = 0
            while time.monotonic() < stop:
                key = f"lock/k{(t + n) % DI_LOCK_KEYS}"
                st, body = nodes[t % DI_NODES].client(
                    "PUT", f"/g4h/{key}", lock_bodies(t, n))
                if st != 200:
                    fails.append((key, st, body[:200]))
                written.setdefault(key, set()).add((t, n))
                n += 1
        run_clients(overwrite, [[None]] * DI_CLIENTS)
        check(not fails, f"4h locks: failed overwrites {fails[:3]}")
        torn = stale = 0
        for key in written:
            got = [p.client.send("GET", f"/g4h/{key}")[:2] for p in nodes]
            st, body = got[0]
            t, n = (int(x) for x in body.split(b":")[:2]) \
                if st == 200 else (-1, -1)
            if st != 200 or (t, n) not in written[key] or \
                    body != lock_bodies(t, n):
                torn += 1
            if any(g != got[0] for g in got):
                stale += 1
            every[f"/g4h/{key}"] = body
        puts = sum(len(v) for v in written.values())
        log(f"4h locks: {puts} overwrites of {DI_LOCK_KEYS} keys by "
            f"{DI_CLIENTS} clients through 4 nodes in {DI_LOCK_S:.0f} s; "
            f"torn or foreign bodies {torn}, nodes disagreeing {stale}")
        check(torn == 0 and stale == 0, "4h locks: a body is not one "
              "whole written body, or the nodes disagree")

        # -- 3. one node lost under 16 paced clients on nodes 0-2 ------
        pairs: list = []
        live: dict = {}
        body = rng.bytes(DI_LIVE_SIZE)
        t_kill = [0.0, 0.0]         # monotonic, and wall for the nodes
        end = time.monotonic() + DI_LIVE_BEFORE + DI_LIVE_AFTER

        def paced(t: int, _item) -> None:
            n = 0
            c = nodes[t % 3].client
            while time.monotonic() < end:
                key = f"live/c{t:02d}/k{n:03d}"
                b = body[n:] + body[:n]
                t0 = time.monotonic()
                st_put, err = c("PUT", f"/g4h/{key}", b)
                t1 = time.monotonic()
                st_get, got = c("GET", f"/g4h/{key}")
                t2 = time.monotonic()
                ok = st_put == 200 and st_get == 200 and got == b
                pairs.append((t0, t1, t2, ok, st_put, st_get))
                if st_put == 200:
                    live[f"/g4h/{key}"] = b
                n += 1
                time.sleep(DI_LIVE_PAUSE)

        def killer() -> None:
            time.sleep(DI_LIVE_BEFORE)
            t_kill[0], t_kill[1] = time.monotonic(), time.time()
            nodes[3].kill()
        kt = threading.Thread(target=killer)
        kt.start()
        run_clients(paced, [[None]] * DI_CLIENTS)
        kt.join()
        failed = [p for p in pairs if not p[3]]
        before = sorted(p[2] - p[0] for p in pairs if p[2] < t_kill[0])
        after = [p for p in pairs if p[0] >= t_kill[0]]
        spans = sorted(p[2] - p[0] for p in after)
        gets = sorted(p[2] - p[1] for p in after)

        def ms(xs: list, q: float) -> str:
            return f"{xs[int(len(xs) * q)] * 1e3:.1f}" if xs else "-"
        log(f"4h node 3 SIGKILLed under {DI_CLIENTS} paced clients: "
            f"{len(pairs)} {DI_LIVE_SIZE / MIB:g} MiB PUT+GET pairs, "
            f"{len(failed)} failed; pair p50/p99 before the kill "
            f"{ms(before, 0.5)}/{ms(before, 0.99)} ms (n={len(before)}), "
            f"after it {ms(spans, 0.5)}/{ms(spans, 0.99)} ms "
            f"(n={len(spans)}); GET with node 3 down p50 "
            f"{ms(gets, 0.5)} ms, p99 {ms(gets, 0.99)} ms (n={len(gets)})")
        check(not failed, f"4h: failed requests on live nodes: "
              f"{[(p[4], p[5]) for p in failed[:5]]}")
        every.update(live)
        read_back(nodes[:3], every, "4h with node 3 down")
        shut = {i: {w: coherent(d) for w, d in
                    worker_infos(nodes[i]).items()} for i in range(3)}
        log(f"4h coherence with node 3 down: gates by node and worker "
            f"{shut} (False: shut, the caches answer misses)")
        check(not any(v for g in shut.values() for v in g.values()),
              f"4h: a gate stayed open with node 3 down: {shut}")
        resyncs0 = {i: a["resyncs"] for i, a in armed.items()}

        # -- 4. two nodes lost: 503, within the drive deadline ---------
        # An armed grid trace on node 0 sees the calls the kill cut.
        cut_tail = TraceTail(nodes[0].client.address, "grid")
        nodes[2].kill()
        for method, path, data in (("PUT", "/g4h/two-down", b"x" * MIB),
                                   ("GET", "/g4h/big/000", b"")):
            t0 = time.perf_counter()
            st, _ = nodes[0].client(method, path, data)
            dt = time.perf_counter() - t0
            log(f"4h nodes 2 and 3 down: {method} {path} {st} in "
                f"{dt:.3f} s")
            check(st == 503 and dt < DI_DRIVE_TIMEOUT,
                  f"4h two nodes down: {method} answered {st} in {dt:.2f} s")
        faults: dict = {}
        for e in cut_tail.stop():
            f = (e.get("tags") or {}).get("fault") \
                if e.get("api") == "wire" else None
            if f:
                key = (e["tags"].get("peer"), f)
                faults[key] = faults.get(key, 0) + 1
        log(f"4h armed calls cut by the SIGKILLed nodes, wire spans by "
            f"(peer, fault): {faults}")
        check(faults, "4h: no armed call was annotated as a fault")

        # -- 5. nodes back, then the admin heal ------------------------
        t0 = time.perf_counter()
        for i in (2, 3):
            while not (bindable(ports[i])
                       and bindable(ports[i] + GRID_PORT_OFFSET)):
                check(time.perf_counter() - t0 < 60,
                      f"4h: node {i}'s ports stay taken")
                time.sleep(0.2)
        nodes[2], nodes[3] = spawn(2), spawn(3)
        nodes[2].wait_serving()
        nodes[3].wait_serving()
        back_s = time.perf_counter() - t0
        # Through a restarted node: the others' breakers may still hold
        # node 3's drives out for a cooldown (up to 15 s), and a heal
        # skips what it sees offline.
        # The one-node server of step 7 boots meanwhile.
        # Five workers: the four nodes serve from five processes.
        one = ServerProc([os.path.join(root, "h1", "d{1...16}")], extra,
                         device, sum(DI_HTTP_WORKERS), env, wait=False)
        status, heal_s = admin_heal(nodes[3].client, deep=False)
        missing = 0
        for path in live:
            key = path[len("/g4h/"):]
            missing += sum(not os.path.exists(os.path.join(
                root, "h", "n3", f"d{j}", "g4h", key, "xl.meta"))
                for j in range(1, DI_DRIVES + 1))
        log(f"4h nodes 2 and 3 restarted, serving in {back_s:.2f} s; admin "
            f"heal through node 3 {heal_s:.2f} s ({status.get('healed')} "
            f"healed); "
            f"journals of the {len(live)} keys written with node 3 down "
            f"missing from its drives: {missing}")
        check(missing == 0, "4h: node 3's drives did not heal")
        t0 = time.perf_counter()
        rearmed = wait_armed(nodes, "4h after the restarts")
        rearm_s = time.perf_counter() - t0
        reads, stale = coherence_rounds(nodes[1], [nodes[0], nodes[2],
                                                   nodes[3]], rng,
                                        "4h coherence after the restarts",
                                        retry_s=30.0)
        log(f"4h coherence after nodes 2 and 3 restarted: every node armed "
            f"again ({rearm_s:.2f} s after the heal; resyncs of the nodes "
            f"that stayed up: node 0 {resyncs0[0]} -> "
            f"{rearmed[0]['resyncs']}, node 1 {resyncs0[1]} -> "
            f"{rearmed[1]['resyncs']}); {reads} reads, {stale} stale")
        check(all(rearmed[i]["resyncs"] > resyncs0[i] for i in (0, 1)),
              f"4h: no resync re-armed the nodes: {resyncs0} {rearmed}")
        check(stale == 0, f"4h: {stale} stale reads after the restarts")

        # -- 6. the heal's proof: node 0 lost, nodes 1-3 read all ------
        # Node 1 reads node 3's drives again once its breaker's next
        # half-open probe succeeds; a 503 until then is retried.
        nodes[0].kill()
        read_back(nodes[1:], every, "4h with node 0 down", retry_s=30.0)
        for p in nodes[1:]:
            clean_stop(p)
        sums = [summaries(p) for p in nodes[1:]]
        for n in sums:
            add(n)
        nodes = []
        # The breaker's switch, from node 1 (the one node that served
        # through node 3's SIGKILL and stopped cleanly).
        peer3 = f"127.0.0.1:{ports[3] + GRID_PORT_OFFSET}"
        st3 = next((c for c in sums[0]["peers"] if c["peer"] == peer3),
                   None)
        opened = [t - t_kill[1] for t in (st3 or {}).get("opened_at", [])
                  if t >= t_kill[1]]
        log(f"4h breakers on node 1: to node 3 opened "
            f"{opened[0] if opened else float('nan'):.3f} s after its "
            f"SIGKILL ({len(opened)} opening(s) after it); calls failed "
            f"fast by peer: " + ", ".join(
                f"{c['peer']} {c['fast_fails']} ({c['breaker_opens']} "
                f"opens)" for c in sums[0]["peers"]))
        check(bool(opened), f"4h: node 1's breaker to node 3 never opened "
              f"after the kill: {st3}")

        # -- 7. the same load on one node of 16 local drives -----------
        one.wait_serving()
        local_put, local_get = di_load([one], objs, parts, "4h one node")
        small_one = node_put_rate([one], rng, "rate1")
        log(f"4h small PUTs: {small_dist:.1f} keys/s over 4 nodes, each "
            f"PUT's bump pushed to 3 peers and acked, against "
            f"{small_one:.1f} on one node of 16 drives served by "
            f"{sum(DI_HTTP_WORKERS)} workers ({small_dist / small_one:.3f}x)")
        clean_stop(one)
        add(summaries(one))
    finally:
        for p in nodes + ([one] if one is not None else []):
            p.kill()
    shutil.rmtree(os.path.join(root, "h"), ignore_errors=True)
    shutil.rmtree(os.path.join(root, "h1"), ignore_errors=True)
    from minio_tpu_torch.utils.latency import Histogram
    log(f"4h grid cost: PUT {dist_put:.1f} MiB/s over 4 nodes against "
        f"{local_put:.1f} on one, both served by {sum(DI_HTTP_WORKERS)} "
        f"processes ({dist_put / local_put:.3f}x), GET "
        f"{dist_get:.1f} against {local_get:.1f} "
        f"({dist_get / local_get:.3f}x)")
    log(f"4h dsync: {locks} locks taken on the nodes that stopped cleanly "
        f"(1, 2 and 3 restarted), {refused} refused, acquire "
        f"{summarize(Histogram.merge(lock_hists))}")
    log(f"4h launches by k,r {launches['gf_apply_by_kr']}, highwayhash256 "
        f"{launches['highwayhash256']}; phase {time.perf_counter() - t_phase:.1f} s")
    kr = launches["gf_apply_by_kr"]
    check(kr.get("12,4", 0) > 0 and any(kr.get(f"12,{r}", 0) > 0
                                        for r in (1, 2, 3)),
          f"4h: gf_apply at k = 12 with parity and decode rows: {kr}")
    check(launches["highwayhash256"] > 0, "4h: highwayhash256 never "
          "launched on the nodes")
    return launches


EL_NODES, EL_DRIVES = 4, 4       # MinIO's "Expand a Distributed Deployment"
EL_HTTP_WORKERS = (2, 1, 1, 1)   # MTPU_HTTP_WORKERS of each node
EL_CLIENTS = 16
EL_BIG, EL_N_BIG = 16 * MIB, 16
EL_RAGGED = 64 * MIB + 1
EL_SMALL = 10                   # keys of 1 KiB (cut from 100)
EL_VKEYS, EL_VERSIONS, EL_MARKERS = 5, 3, 3    # (20, 3, 10, cut)
EL_VBODY = 4 * 1024
EL_LIVE_SIZE = MIB              # the paced clients' PUT+GET pairs
EL_LIVE_PAUSE = 0.25            # seconds between a client's pairs
EL_LIVE_KEYS = 4                # keys a paced client overwrites in turn
EL_KILL_AFTER = 12              # keys the drain moved before the SIGKILL
# The cut: a coordinator's lease lapses in 6 s (default 30) and the
# janitor ticks every second (default 10). MTPU_MIG_BATCH=1 (default 8)
# shards each batch of 4 keys over the 4 nodes: the checkpoint, written
# every 16 keys, trails the live walk from the first batch's end until
# the rebalance's byte target or its 16th key (step 4 reads the
# difference while 16 MiB objects move), and a SIGKILL cuts a batch of
# 4 keys, not 32.
EL_ENV = {"MTPU_FILEINFO_CACHE": "on", "MTPU_HOT_CACHE": "on",
          "MTPU_GRID_LOCK_TTL": "6", "MTPU_ELASTIC_JANITOR_S": "1",
          "MTPU_MIG_BATCH": "1", "PYTHONFAULTHANDLER": "1"}


EL_SLOW_MS = 100                # the slow-op log's threshold in 4i


def slow_after_resume(nodes: list, since: float) -> None:
    """4i, print only: the slow-op records (MTPU_SLOW_OP_MS=EL_SLOW_MS)
    the survivors logged for spans that started after the resume: the
    ten span names with the most summed time, and the slowest record's
    ancestry. Each process logs at most 20 records a second."""
    recs = []
    for p in nodes:
        for ln in list(p.lines):
            if "mtpu slow-op: " in ln:
                try:
                    recs.append(json.loads(ln.split("mtpu slow-op: ", 1)[1]))
                except ValueError:
                    continue
    recs = [r for r in recs if not r.get("event")
            and r.get("start", 0) >= since]
    total: dict = {}
    for r in recs:
        total[r["name"]] = total.get(r["name"], 0.0) + r["duration_ms"]
    top = sorted(total.items(), key=lambda kv: -kv[1])[:10]
    log(f"4i slow-op log after the resume: {len(recs)} records over "
        f"{EL_SLOW_MS} ms on nodes 0, 2, 3; summed ms by span name "
        + ", ".join(f"{n} {v:.1f}" for n, v in top))
    if recs:
        worst = max(recs, key=lambda r: r["duration_ms"])
        log(f"4i slowest record: {worst['name']} {worst['duration_ms']} ms "
            f"on {worst.get('node')}, tags {worst.get('tags')}, ancestry "
            f"{worst.get('ancestry')}")


def dump_nodes(nodes: list, what: str) -> None:
    """After a failed check: SIGABRT to each live node's processes,
    whose fault handler prints every thread's stack, and the tail of
    each node's output to stderr."""
    import signal
    live = [p for p in nodes if p is not None and p.proc.poll() is None]
    for p in live:
        try:
            os.killpg(p.proc.pid, signal.SIGABRT)
        except ProcessLookupError:
            pass
    time.sleep(3.0)
    for i, p in enumerate(nodes):
        if p is not None:
            print(f"---- {what}: node {i}, last lines ----\n"
                  + "\n".join(p.lines[-400:]), file=sys.stderr, flush=True)


def admin_json(p: "ServerProc", verb: str, method: str = "GET",
               query: dict | None = None):
    """An admin pool verb through node `p`: (status, JSON or None)."""
    st, body, _ = p.client.send(method, f"/minio/admin/v3/{verb}",
                                query=query)
    return st, (json.loads(body) if st == 200 and body else None)


def checkpoint(drives: list, name: str) -> dict | None:
    """The highest-revision copy of config/<name> on `drives`."""
    best = None
    for d in drives:
        try:
            with open(os.path.join(d, ".mtpu.sys", "config", name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if best is None or doc.get("rev", 0) > best.get("rev", 0):
            best = doc
    return best


def phase_elastic_fleet(rng, root: str, device: str = "cuda") -> dict:
    """A distributed expansion and decommission (phase 4i): four nodes on
    a 16-drive pool, loaded, restarted with a second pool appended, a
    rebalance started, read live and stopped through three other nodes,
    then a decommission of the first pool under paced clients whose
    coordinator is SIGKILLed mid-walk and resumed by a survivor's
    janitor, and a restart on the second pool alone; returns the
    launches the nodes printed at their clean stops."""
    t_phase = time.perf_counter()
    card = smi("--query-gpu=name,power.limit")
    ports = node_ports(EL_NODES)
    drives = {pool: [os.path.join(root, "i", f"n{i}", f"p{pool}", f"d{j}")
                     for i in range(EL_NODES)
                     for j in range(1, EL_DRIVES + 1)] for pool in (1, 2)}
    args = {pool: ",".join(
        f"http://127.0.0.1:{ports[k // EL_DRIVES]}{d}"
        for k, d in enumerate(drives[pool])) for pool in (1, 2)}
    extra = ("--scanner-interval", "0")
    launches = {"gf_apply": 0, "highwayhash256": 0, "gf_apply_by_kr": {}}
    walls: dict = {}

    def add(n: dict) -> None:
        launches["gf_apply"] += n["gf_apply"]
        launches["highwayhash256"] += n["highwayhash256"]
        for kr, v in n["gf_apply_by_kr"].items():
            launches["gf_apply_by_kr"][kr] = \
                launches["gf_apply_by_kr"].get(kr, 0) + v

    def boot(pools: list, what: str, env: dict = EL_ENV) -> list:
        t0 = time.perf_counter()
        nodes = [ServerProc([args[x] for x in pools], extra, device,
                            EL_HTTP_WORKERS[i], env, port=ports[i],
                            wait=False) for i in range(EL_NODES)]
        try:
            for p in nodes:
                p.wait_serving()
            for p in nodes:
                check(f"distributed over {EL_NODES} nodes" in
                      p.line("serving S3 on"), f"{what}: {p.lines[-5:]}")
            wait_armed(nodes, what)
        except BaseException:
            for p in nodes:
                p.kill()
            raise
        walls[what] = time.perf_counter() - t0
        return nodes

    def stop_all(nodes: list) -> list:
        for p in nodes:
            clean_stop(p)
        sums = [summaries(p) for p in nodes]
        for n in sums:
            add(n)
        return sums

    # What the phase wrote: (bucket, key) -> bytes; versions apart.
    blob = rng.bytes(EL_N_BIG * EL_BIG + EL_RAGGED + EL_SMALL * 1024)
    view = memoryview(blob)
    objs = {("g4i", f"big/{i:03d}"): view[i * EL_BIG:(i + 1) * EL_BIG]
            for i in range(EL_N_BIG)}
    o = EL_N_BIG * EL_BIG
    objs["g4i", "ragged"] = view[o:o + EL_RAGGED]
    o += EL_RAGGED
    for i in range(EL_SMALL):
        objs["g4i", f"small/{i:04d}"] = view[o + i * 1024:o + (i + 1) * 1024]
    versions: dict = {}             # key -> [(version id, etag or marker)]
    small_keys = [k for b, k in objs if k.startswith("small/")]

    def read_all(p: "ServerProc", what: str) -> float:
        """Every key byte for byte, every version by its id and ETag and
        the version listing, through node `p`."""
        def get(_t: int, bk) -> None:
            st, body = p.client("GET", f"/{bk[0]}/{bk[1]}")
            check(st == 200 and body == objs[bk],
                  f"{what}: GET {bk[0]}/{bk[1]}: {st}")
        items = sorted(objs)
        t0 = time.perf_counter()
        run_clients(get, [items[t::EL_CLIENTS] for t in range(EL_CLIENTS)])
        listed = []
        marker = vm = ""
        while True:
            st, body, _ = p.client.send("GET", "/g4iv", query={
                "versions": "", "key-marker": marker,
                **({"version-id-marker": vm} if marker else {})})
            check(st == 200, f"{what}: list versions {st}")
            for e in xml_entries(body, "Version") + \
                    xml_entries(body, "DeleteMarker"):
                listed.append((e["Key"], e["VersionId"],
                               e.get("ETag", "marker")))
            if xml_tag(body, "IsTruncated") != "true":
                break
            marker = xml_tag(body, "NextKeyMarker")
            vm = xml_tag(body, "NextVersionIdMarker")
        want = sorted((k, vid, tag) for k, vs in versions.items()
                      for vid, tag in vs)
        check(sorted(listed) == want, f"{what}: the version listing "
              f"differs: {len(listed)} entries against {len(want)}")
        for k, vs in versions.items():
            for vid, tag in vs:
                if tag != "marker":
                    st, _, h = p.client.send("GET", f"/g4iv/{k}",
                                             query={"versionId": vid})
                    check(st == 200 and h["etag"] == tag,
                          f"{what}: GET {k}?versionId={vid}: {st}")
        return time.perf_counter() - t0

    nodes: list = []
    try:
        # -- 1. pool 1 (1 x 16, EC 12+4) on four nodes, loaded ----------
        nodes = boot([1], "4i boot on pool 1")
        c0 = nodes[0].client
        for b in ("g4i", "g4iv", "g4il"):
            check(c0("PUT", f"/{b}")[0] == 200, f"4i: make bucket {b}")
        check(c0.send("PUT", "/g4iv", VERSIONING.format("Enabled").encode(),
                      query={"versioning": ""})[0] == 200, "4i: versioning")
        t0 = time.perf_counter()

        def put(t: int, bk) -> None:
            st, err = nodes[t % EL_NODES].client("PUT", f"/{bk[0]}/{bk[1]}",
                                                 bytes(objs[bk]))
            check(st == 200, f"4i: PUT {bk}: {st} {err[:200]!r}")
        items = sorted(objs)
        run_clients(put, [items[t::EL_CLIENTS] for t in range(EL_CLIENTS)])
        vbody = rng.bytes(EL_VKEYS * EL_VERSIONS * EL_VBODY)

        def put_versions(t: int, k: int) -> None:
            c, key, got = nodes[t % EL_NODES].client, f"v{k:03d}", []
            for v in range(EL_VERSIONS):
                o = (k * EL_VERSIONS + v) * EL_VBODY
                st, _, h = c.send("PUT", f"/g4iv/{key}",
                                  vbody[o:o + EL_VBODY])
                check(st == 200, f"4i: PUT {key} #{v}: {st}")
                got.append((h["x-amz-version-id"], h["etag"]))
            if k < EL_MARKERS:
                st, _, h = c.send("DELETE", f"/g4iv/{key}")
                check(st == 204 and h.get("x-amz-delete-marker") == "true",
                      f"4i: marker on {key}: {st}")
                got.append((h["x-amz-version-id"], "marker"))
            versions[key] = got
        run_clients(put_versions, [range(t, EL_VKEYS, EL_CLIENTS)
                                   for t in range(EL_CLIENTS)])
        walls["load"] = time.perf_counter() - t0
        loaded = sum(map(len, objs.values())) + len(vbody)
        log(f"4i: 4 nodes x 4 drives of pool 1 (1 x 16, EC 12+4) serving "
            f"and armed in {walls['4i boot on pool 1']:.2f} s; "
            f"{EL_CLIENTS} clients over the nodes loaded "
            f"{loaded / MIB:.1f} MiB in {walls['load']:.2f} s "
            f"({EL_N_BIG} x 16 MiB, 64 MiB + 1 B, {EL_SMALL} x 1 KiB, "
            f"{EL_VKEYS} keys x {EL_VERSIONS} versions, {EL_MARKERS} "
            f"markers)")
        stop_all(nodes)
        nodes = []

        # -- 2. restarted with pool 2 appended ---------------------------
        # The slow-op log armed on every node for the walks (read for
        # the drain after the resume, below).
        nodes = boot([1, 2], "4i boot on pools 1 and 2",
                     {**EL_ENV, "MTPU_SLOW_OP_MS": str(EL_SLOW_MS)})
        check("pool 0: EC 12+4; pool 1: EC 12+4" in
              nodes[0].line("serving S3 on"),
              f"4i: the expanded layout {nodes[0].line('serving S3 on')}")

        # -- 3-5. a rebalance started through node 2, read live through
        # node 3, stopped through node 1 ---------------------------------
        t0 = time.perf_counter()
        st, _ = admin_json(nodes[2], "rebalance-start", "POST")
        check(st == 200, f"4i: rebalance-start through node 2: {st}")
        differs = None
        polls = 0
        while differs is None:
            check(time.perf_counter() - t0 < 120, "4i: node 3 never read "
                  "a live rebalance state ahead of its checkpoint")
            st, live = admin_json(nodes[3], "rebalance-status")
            ckpt = checkpoint(drives[1], "rebalance.json")
            polls += 1
            if st == 200 and live and ckpt and \
                    live.get("status") == "rebalancing":
                moved = sum(r["migrated"] for r in live["pools"].values())
                saved = sum(r["migrated"] for r in ckpt["pools"].values())
                if moved > saved:       # the coordinator's, not a copy
                    differs = (moved, saved, live.get("rev"),
                               ckpt.get("rev"))
            check(not (live or {}).get("status") in ("complete", "failed"),
                  f"4i: the rebalance ended before node 3 read it live: "
                  f"{live}")
            time.sleep(0.05)
        st, _ = admin_json(nodes[1], "rebalance-stop", "POST")
        check(st == 200, f"4i: rebalance-stop through node 1: {st}")
        stop_s = time.perf_counter() - t0
        while True:
            # The coordinator pauses once its batch in flight ends.
            st, after = admin_json(nodes[0], "rebalance-status")
            if st == 200 and after and (after.get("paused") or
                                        after["status"] == "complete"):
                break
            check(time.perf_counter() - t0 < 180, f"4i: the stop through "
                  f"node 1 did not reach node 2: {after}")
            time.sleep(0.1)
        paused_s = time.perf_counter() - t0
        rb_moved = sum(r["migrated"] for r in after["pools"].values())
        walls["rebalance"] = paused_s
        log(f"4i rebalance: started through node 2, read live through "
            f"node 3 after {polls} polls ({differs[0]} keys moved live "
            f"against {differs[1]} in the checkpoint on pool 1's drives, "
            f"rev {differs[2]} and {differs[3]}); stopped through node 1 "
            f"{stop_s:.2f} s after the start, paused at {paused_s:.2f} s: "
            f"{after['status']}, paused {after.get('paused')}, {rb_moved} "
            f"keys moved")

        # -- 6-9. pool 1 decommissioned through node 1 under paced clients
        # on nodes 0, 2 and 3; node 1 (the coordinator) SIGKILLed --------
        live_pool = rng.bytes(64 * MIB)
        live_keys: dict = {}
        failed, stale, pairs = [], [], [0]
        done = threading.Event()

        def client(t: int) -> None:
            node = nodes[(0, 2, 3)[t % 3]]
            i = 0
            while not done.is_set():
                key = f"t{t:02d}/k{i % EL_LIVE_KEYS}"
                o = (t * 7919 + i * 104729) % (63 * MIB)
                body = live_pool[o:o + EL_LIVE_SIZE]
                small_k = small_keys[(t * 31 + i) % len(small_keys)]
                try:
                    st, _ = node.client("PUT", f"/g4il/{key}", body)
                    if st != 200:
                        failed.append(f"PUT {key}: {st}")
                    else:
                        live_keys["g4il", key] = body
                        st, got = node.client("GET", f"/g4il/{key}")
                        if st != 200:
                            failed.append(f"GET {key}: {st}")
                        elif got != body:
                            stale.append(f"GET {key}")
                    st, got = node.client("GET", f"/g4i/{small_k}")
                    if st != 200:
                        failed.append(f"GET {small_k}: {st}")
                    elif got != objs["g4i", small_k]:
                        stale.append(f"GET {small_k}")
                    pairs[0] += 1
                except (OSError, http.client.HTTPException) as e:
                    failed.append(f"{key}: {e!r}")
                i += 1
                time.sleep(EL_LIVE_PAUSE)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(EL_CLIENTS)]
        t0 = time.perf_counter()
        st, _ = admin_json(nodes[1], "decommission", "POST", {"pool": "0"})
        check(st == 200, f"4i: decommission through node 1: {st}")
        # The start's notice reached every node before the answer: the
        # clients' keys land in pool 2 and stay out of the walk.
        for th in threads:
            th.start()
        try:
            while True:
                st, doc = admin_json(nodes[1], "decommission-status")
                check(st == 200 and doc and doc["status"] == "draining",
                      f"4i: the drain before the kill: {st} {doc}")
                if doc["migrated"] >= EL_KILL_AFTER:
                    break
                check(time.perf_counter() - t0 < 120,
                      f"4i: the drain stalled: {doc}")
                time.sleep(0.05)
            t_kill = time.time()
            before_kill = time.perf_counter() - t0
            nodes[1].kill()
            resumed_s = at_resume = None
            while True:
                st, doc = admin_json(nodes[2], "decommission-status")
                if doc and resumed_s is None and \
                        doc.get("checkpoint_ns", 0) > t_kill * 1e9:
                    resumed_s = time.time() - t_kill
                    # The resumed walk's first record: its checkpoint.
                    at_resume = (time.perf_counter(), doc["migrated"],
                                 doc["bytes_moved"])
                if doc and doc["status"] in ("complete", "failed"):
                    break
                check(time.perf_counter() - t0 < 300,
                      f"4i: the drain never ended: {doc}")
                time.sleep(0.1)
            drain_s = time.perf_counter() - t0
        finally:
            done.set()
            for th in threads:
                th.join(120)
        check(not any(th.is_alive() for th in threads),
              "4i: a paced client hung")
        check(doc["status"] == "complete" and doc["failed"] == 0,
              f"4i: the drain ended {doc}")
        check(resumed_s is not None, f"4i: no survivor resumed: {doc}")
        # The walk after the resume, apart from the walk before the kill
        # and the dead lease's wait.
        post_s = t0 + drain_s - at_resume[0]
        post_keys = doc["migrated"] - at_resume[1]
        post_bytes = doc["bytes_moved"] - at_resume[2]
        check(not failed and not stale, f"4i: paced clients: failed "
              f"{failed[:5]}, stale {stale[:5]}")
        walls["decommission"] = drain_s
        objs.update(live_keys)
        survivors = [nodes[i] for i in (0, 2, 3)]
        sums = stop_all(survivors)
        slow_after_resume(survivors, t_kill + resumed_s)
        nodes[1] = None
        nodes = []
        pages = {i: sum(c["mig_pages_served"]["batches"]
                        for c in n["control"])
                 for i, n in zip((0, 2, 3), sums)}
        keys_served = {i: sum(c["mig_pages_served"]["keys"]
                              for c in n["control"])
                       for i, n in zip((0, 2, 3), sums)}
        coh = [c for n in sums for c in n["control"] if c["peers"]]
        log(f"4i decommission of pool 1 through node 1: node 1 (the "
            f"coordinator) SIGKILLed {before_kill:.2f} s in, after "
            f"{EL_KILL_AFTER}+ keys; a survivor's janitor resumed the "
            f"walk {resumed_s:.2f} s after the kill (lease TTL 6 s, "
            f"janitor 1 s); complete {drain_s:.2f} s after the start "
            f"with {doc['migrated']} keys and {doc['bytes_moved']} B on "
            f"its record; after the resume {post_keys} keys and "
            f"{post_bytes} B in {post_s:.2f} s "
            f"({post_keys / max(post_s, 1e-9):.3f} keys/s), "
            f"{doc.get('yields', 0)} yields; mig.page batches served by "
            f"the survivors {pages} (keys {keys_served}); {EL_CLIENTS} "
            f"paced clients on nodes 0, 2, 3: {pairs[0]} PUT+GET pairs, "
            f"0 failed, 0 stale ({card})")
        log("4i control planes at the survivors' clean stops: " + "; ".join(
            f"pushes {c['pushes']}, escalations {c['escalations']}, "
            f"resyncs {c['resyncs']}, notices {c['notices']}" for c in coh))
        check(sum(1 for v in pages.values() if v > 0) >= 2,
              f"4i: mig.page served by fewer than two nodes: {pages}")
        left = {i: sum(len(journals(d)) for d in drives[1]
                       if f"{os.sep}n{i}{os.sep}" in d)
                for i in range(EL_NODES)}
        check(all(left[i] == 0 for i in (0, 2, 3)),
              f"4i: journals left on pool 1's drives: {left}")

        # -- 10-11. pool 2 alone, every key through every node ----------
        nodes = boot([2], "4i boot on pool 2 alone")
        # Node 1's drives missed what was written after its SIGKILL: an
        # admin heal through it (as 4h heals node 3) before the reads,
        # or a listing over its stale drives shows only latest versions.
        status, heal_s = admin_heal(nodes[1].client, deep=False)
        walls["heal"] = heal_s
        n1 = [d for d in drives[2] if f"{os.sep}n1{os.sep}" in d]
        behind = sum(not os.path.exists(os.path.join(d, b, k, "xl.meta"))
                     for b, k in [*objs, *[("g4iv", v) for v in versions]]
                     for d in n1)
        log(f"4i: an admin heal through node 1 in {heal_s:.2f} s "
            f"({status.get('healed')} healed); journals missing from node "
            f"1's pool-2 drives after it: {behind}")
        check(behind == 0, "4i: node 1's drives did not heal")
        reads = {i: read_all(p, f"4i pool 2 alone, node {i}")
                 for i, p in enumerate(nodes)}
        log(f"4i: restarted on pool 2 alone ({walls['4i boot on pool 2 alone']:.2f} s "
            f"to serve and arm); {len(objs)} keys (the paced clients' "
            f"{len(live_keys)} acknowledged ones among them) and "
            f"{sum(map(len, versions.values()))} versions and markers read "
            f"back byte for byte through each node in " + ", ".join(
                f"{w:.2f}" for w in reads.values()) + " s; journals left "
            f"on pool 1: {left} (node 1's drives were down for the rest "
            f"of the walk and leave with the pool)")
        stop_all(nodes)
        nodes = []
    except BaseException:
        dump_nodes(nodes, "4i")
        raise
    finally:
        for p in nodes:
            if p is not None:
                p.kill()
    shutil.rmtree(os.path.join(root, "i"), ignore_errors=True)
    kr = launches["gf_apply_by_kr"]
    log(f"4i launches by k,r {kr}, highwayhash256 "
        f"{launches['highwayhash256']}; walls " + ", ".join(
            f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    check(kr.get("12,4", 0) > 0, f"4i: gf_apply at k = 12, r = 4: {kr}")
    check(launches["highwayhash256"] > 0, "4i: highwayhash256 never "
          "launched on the nodes")
    return launches


# ---------------------------------------------------------------------------
# 4j: the event-loop front end
# ---------------------------------------------------------------------------

FE_IDLE_MAX = 2000              # idle keep-alive connections, at most
FE_OBJ = 64 * 1024              # the object each idle connection GETs
FE_GET_THREADS = 8              # client threads of the idle connections
FE_PIPELINE = 16                # GETs pipelined on one connection
FE_BIG = 64 * MIB               # the aws-chunked PUT and the slow read
FE_SLOW_RCVBUF = 256 * 1024     # the slow reader's receive buffer
FE_HOT = 4 * 1024               # the hot GETs' objects
FE_HOT_KEYS = 16
FE_CLIENTS = 64                 # keep-alive clients of the rates
FE_CLIENT_PROCS = 4             # processes they run in
FE_RATE_PUTS = 8                # 1 KiB PUTs a client, a rate
FE_RATE_GETS = 32               # hot 4 KiB GETs a client, a rate
FE_SMALL_ENV = {"MTPU_HTTP_KEEPALIVE_S": "2", "MTPU_MAX_CONNS": "16"}


class env_set:
    """Environment variables set while a server is built (its front end
    and caches read them there), restored after."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class KeepAlive:
    """Signed requests over one persistent HTTP/1.1 connection."""

    def __init__(self, address: str):
        from minio_tpu_torch.s3 import sigv4
        self.sigv4, self.address = sigv4, address
        host, _, port = address.rpartition(":")
        self.conn = http.client.HTTPConnection(host, int(port), timeout=120)

    def request(self, method: str, path: str, body: bytes = b""):
        uri, headers = self.sigv4.sign_headers(
            method, self.address, path, "minioadmin", "minioadmin",
            hashlib.sha256(body).hexdigest())
        self.conn.request(method, uri, body=body, headers=headers)
        resp = self.conn.getresponse()
        return resp.status, resp.read()

    def close(self) -> None:
        self.conn.close()


def raw_conn(address: str, rcvbuf: int = 0):
    import socket
    host, _, port = address.rpartition(":")
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    if rcvbuf:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
    s.settimeout(120)
    s.connect((host, int(port)))
    return s


def signed_get(address: str, path: str) -> bytes:
    """A signed GET's head, for a raw socket."""
    from minio_tpu_torch.s3 import sigv4
    uri, headers = sigv4.sign_headers("GET", address, path, "minioadmin",
                                      "minioadmin", sigv4.EMPTY_SHA256)
    return ("\r\n".join([f"GET {uri} HTTP/1.1"] + [
        f"{k}: {v}" for k, v in headers.items()]) + "\r\n\r\n").encode()


LIVE = b"GET /minio/health/live HTTP/1.1\r\nHost: x\r\n\r\n"


def recv_responses(sock, n: int, buf: bytearray | None = None) -> list:
    """n Content-Length responses off a keep-alive socket: [(status,
    body)]."""
    buf = bytearray() if buf is None else buf
    out = []
    while len(out) < n:
        end = buf.find(b"\r\n\r\n")
        if end >= 0:
            head = buf[:end].decode("latin-1").split("\r\n")
            length = next((int(ln.split(":", 1)[1]) for ln in head[1:]
                           if ln.lower().startswith("content-length:")), 0)
            if len(buf) >= end + 4 + length:
                out.append((int(head[0].split()[1]),
                            bytes(buf[end + 4:end + 4 + length])))
                del buf[:end + 4 + length]
                continue
        got = sock.recv(1 << 20)
        check(bool(got), f"connection closed after {len(out)} of {n} "
              "responses")
        buf += got
    return out


# One client process of fe_rates: CLIENTS keep-alive connections, each on
# a thread, start together at START (wall clock) and make OPS requests:
# 1 KiB PUTs ("put") or GETs of the hot keys whose SHA-256 it is given
# ("get"); prints {"ops", "errors", "t1"}.
_FE_CLIENT = r"""
import hashlib, http.client, json, os, sys, threading, time
from minio_tpu_torch.s3 import sigv4
addr, mode, tag = sys.argv[1:4]
start, clients, ops = float(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6])
want = json.loads(sys.argv[7])
keys = sorted(want)
host, _, port = addr.rpartition(":")
done, errors, ends = [0], [0], []
mu = threading.Lock()

def client(t):
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    body = os.urandom(1024)
    n = bad = 0
    while time.time() < start:
        time.sleep(0.001)
    try:
        for i in range(ops):
            if mode == "put":
                path, data = f"/front/rate-{tag}-{t}-{i}", body
            else:
                path, data = f"/front/{keys[(t + i) % len(keys)]}", b""
            uri, headers = sigv4.sign_headers(
                "PUT" if mode == "put" else "GET", addr, path, "minioadmin",
                "minioadmin", hashlib.sha256(data).hexdigest())
            conn.request("PUT" if mode == "put" else "GET", uri, body=data,
                         headers=headers)
            resp = conn.getresponse()
            got = resp.read()
            ok = resp.status == 200 and (mode == "put" or hashlib.sha256(
                got).hexdigest() == want[path.rsplit("/", 1)[1]])
            n += 1
            bad += not ok
    finally:
        conn.close()
        with mu:
            done[0] += n
            errors[0] += bad
            ends.append(time.time())

threads = [threading.Thread(target=client, args=(int(sys.argv[8]) + t,))
           for t in range(clients)]
for th in threads:
    th.start()
for th in threads:
    th.join()
print(json.dumps({"ops": done[0], "errors": errors[0], "t1": max(ends)}))
"""


def fe_rates(address: str, tag: str, hot_keys: list) -> tuple:
    """(1 KiB PUT keys/s, hot 4 KiB GETs/s) of FE_CLIENTS keep-alive
    clients, each on its own connection, spread over FE_CLIENT_PROCS
    client processes (so that neither the clients nor the server in this
    process share one interpreter's lock)."""
    want = json.dumps({key: hashlib.sha256(body).hexdigest()
                       for key, body in hot_keys})
    per = FE_CLIENTS // FE_CLIENT_PROCS
    rates = []
    for mode, ops in (("put", FE_RATE_PUTS), ("get", FE_RATE_GETS)):
        start = time.time() + 3.0
        procs = [subprocess.Popen(
            [sys.executable, "-c", _FE_CLIENT, address, mode, tag,
             repr(start), str(per), str(ops), want, str(p * per)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p in range(FE_CLIENT_PROCS)]
        docs = []
        for proc in procs:
            out = proc.communicate(timeout=300)[0]
            check(proc.returncode == 0, f"rate client failed: {out[-2000:]}")
            docs.append(json.loads(out.strip().splitlines()[-1]))
        total = sum(d["ops"] for d in docs)
        errors = sum(d["errors"] for d in docs)
        check(total == FE_CLIENTS * ops and not errors,
              f"{mode} rate through {tag}: {total} requests, {errors} "
              "failed or not identical")
        rates.append(total / (max(d["t1"] for d in docs) - start))
    return tuple(rates)


def prime_hot(s: "Server", hot_keys: list) -> None:
    """GET each key until the hot cache holds it with its head template
    (admission runs after a miss's last write)."""
    hc = s.srv.hot_cache
    for key, body in hot_keys:
        t0 = time.perf_counter()
        while True:
            st, got = s.client("GET", f"/front/{key}")
            check(st == 200 and got == body, f"GET {key} not identical")
            entry = hc.get("front", key)
            if entry is not None and entry.head_prefix is not None:
                break
            check(time.perf_counter() - t0 < 20,
                  f"{key} never became resident in the hot cache")


def phase_front_end(rng, root: str, device: str = "cuda") -> dict:
    """4j, see the module docstring."""
    import resource
    import socket
    from minio_tpu_torch.s3 import hotloop
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if hard != resource.RLIM_INFINITY and soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    limit = hard if hard != resource.RLIM_INFINITY else 1 << 20
    n_idle = min(FE_IDLE_MAX, (limit - 512) // 2)
    check(n_idle > 0, f"no room for idle connections: RLIMIT_NOFILE {hard}")
    recv = hotloop.recv_pool()
    reset_launches()

    # Slowloris and the shed at accept, on a server with a 2 s idle
    # deadline and a cap of 16 connections.
    with env_set(**FE_SMALL_ENV):
        small = Server(root, "fe-small", device=device)
    try:
        httpd = small.srv.httpd
        check(type(httpd).__name__ == "EventLoopServer",
              f"the server did not boot the event loop: {type(httpd)}")
        st0 = small.srv.eventloop_stats()
        slow = raw_conn(small.srv.address)
        t0 = time.perf_counter()
        slow.sendall(b"GET /minio/health/live HTTP/1.1\r\nHo")
        slow.settimeout(15)
        try:
            closed = slow.recv(4096) == b""
        except OSError:
            closed = True
        reap_s = time.perf_counter() - t0
        slow.close()
        st1 = small.srv.eventloop_stats()
        check(closed and 1.5 < reap_s < 10,
              f"slowloris head not reaped at the 2 s deadline: {reap_s:.1f} s")
        check(st1["reaped_idle_total"] > st0["reaped_idle_total"]
              and st1["dispatch_total"] == st0["dispatch_total"],
              f"the partial head was dispatched or not reaped: {st1}")
        log(f"front end: slowloris partial head reaped after {reap_s:.2f} s "
            "(deadline 2 s), never dispatched")
        parked = []
        try:
            for _ in range(httpd.max_conns):
                sock = raw_conn(small.srv.address)
                sock.sendall(LIVE)
                check(recv_responses(sock, 1)[0][0] == 200, "live probe")
                parked.append(sock)
            extra = raw_conn(small.srv.address)
            t0 = time.perf_counter()
            shed = bytearray()
            while True:
                got = extra.recv(4096)
                if not got:
                    break
                shed += got
            shed_ms = (time.perf_counter() - t0) * 1e3
            extra.close()
        finally:
            for sock in parked:
                sock.close()
        check(shed.startswith(b"HTTP/1.1 503") and b"Retry-After" in shed
              and small.srv.eventloop_stats()["shed_total"] >= 1,
              f"connection {httpd.max_conns + 1} not shed: {bytes(shed)!r}")
        log(f"front end: connection {httpd.max_conns + 1} past "
            f"MTPU_MAX_CONNS={httpd.max_conns} shed with 503 + Retry-After "
            f"in {shed_ms:.1f} ms, before any byte was sent")
    finally:
        small.stop()

    with env_set(MTPU_HOT_CACHE="on"):
        s = Server(root, "fe", device=device)
    es, c, addr = s.es, s.client, s.srv.address
    try:
        check(c("PUT", "/front")[0] == 200, "make bucket fe")
        obj = rng.bytes(FE_OBJ)
        check(c("PUT", "/front/idle-get", obj)[0] == 200, "PUT idle-get")

        # N idle keep-alive connections: each answered once, then parked
        # holding no recv lease; then each GETs the 64 KiB object.
        t0 = time.perf_counter()
        socks = []
        try:
            for _ in range(n_idle):
                sock = raw_conn(addr)
                sock.sendall(LIVE)
                socks.append(sock)
            for sock in socks:
                check(recv_responses(sock, 1)[0][0] == 200, "live probe")
            t_open = time.perf_counter() - t0
            t1 = time.perf_counter()
            while s.srv.eventloop_stats()["parked"] < n_idle:
                check(time.perf_counter() - t1 < 30,
                      f"{n_idle} connections never all parked: "
                      f"{s.srv.eventloop_stats()}")
                time.sleep(0.05)
            leases = recv.stats()["outstanding"]
            check(leases == 0, f"{n_idle} parked connections hold {leases} "
                  "recv leases")
            head = signed_get(addr, "/front/idle-get")
            bad = []

            def idle_gets(chunk):
                for sock in chunk:
                    sock.sendall(head)
                    st, got = recv_responses(sock, 1)[0]
                    if st != 200 or got != obj:
                        bad.append(st)
            per = -(-n_idle // FE_GET_THREADS)
            get_s = run_clients(lambda _, ch: idle_gets(ch),
                                [[socks[i:i + per]]
                                 for i in range(0, n_idle, per)])
            check(not bad, f"{len(bad)} idle connections' GETs failed: "
                  f"{bad[:5]}")
        finally:
            for sock in socks:
                sock.close()
        log(f"front end: {n_idle} idle keep-alive connections (soft "
            f"RLIMIT_NOFILE raised to {soft}) opened and answered in "
            f"{t_open:.2f} s, parked holding 0 recv leases; then each GET "
            f"{FE_OBJ // 1024} KiB identical in {get_s:.2f} s "
            f"({n_idle / get_s:.0f} GETs/s from {FE_GET_THREADS} threads)")

        # 16 GETs pipelined on one connection.
        keys = [(f"pipe-{i}", rng.bytes(FE_HOT + i)) for i in
                range(FE_PIPELINE)]
        for key, body in keys:
            check(c("PUT", f"/front/{key}", body)[0] == 200, f"PUT {key}")
        sock = raw_conn(addr)
        try:
            sock.sendall(b"".join(signed_get(addr, f"/front/{key}")
                                  for key, _ in keys))
            got = recv_responses(sock, FE_PIPELINE)
        finally:
            sock.close()
        check(got == [(200, body) for _, body in keys],
              "pipelined GETs did not come back in order and identical")
        log(f"front end: {FE_PIPELINE} GETs pipelined on one connection "
            "came back in order, identical")

        # A 64 MiB aws-chunked PUT through the pooled decoder, then a
        # slow reader: the GET's last window is left to the loop.
        big = rng.bytes(FE_BIG)
        t0 = time.perf_counter()
        st, _, h = c.chunked_put("/front/big", big)
        put_s = time.perf_counter() - t0
        check(st == 200 and h.get("etag") ==
              f'"{hashlib.md5(big).hexdigest()}"',
              f"aws-chunked PUT of {FE_BIG // MIB} MiB: {st}")
        check(recv.stats()["outstanding"] == 0,
              "the pooled chunked reader kept its lease")
        off0 = s.srv.eventloop_stats()["offloads_total"]
        # Accepted sockets inherit the listener's send buffer: a small one
        # for the slow reader's connection only.
        lsock = s.srv.httpd.socket
        sndbuf = lsock.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                         FE_SLOW_RCVBUF)
        try:
            sock = raw_conn(addr, rcvbuf=FE_SLOW_RCVBUF)
        finally:
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, sndbuf)
        t0 = time.perf_counter()
        try:
            sock.sendall(signed_get(addr, "/front/big"))
            (st, got), = recv_responses(sock, 1)
        finally:
            sock.close()
        slow_s = time.perf_counter() - t0
        st1 = s.srv.eventloop_stats()
        check(st == 200 and got == big, "slow reader's GET not identical")
        check(st1["offloads_total"] > off0,
              f"the GET's last window was not left to the loop: {st1}")
        check_pool_idle("front end, after the slow reader", device)
        t1 = time.perf_counter()
        while recv.stats()["outstanding"] and time.perf_counter() - t1 < 10:
            time.sleep(0.05)
        check(recv.stats()["outstanding"] == 0,
              f"recv leases outstanding: {recv.stats()}")
        log(f"front end: aws-chunked PUT of {FE_BIG // MIB} MiB through the "
            f"pooled decoder {FE_BIG / MIB / put_s:.1f} MiB/s; a reader with "
            f"a {FE_SLOW_RCVBUF // 1024} KiB receive buffer got it identical "
            f"in {slow_s:.2f} s, {st1['offloads_total'] - off0} final write "
            "left to the loop; pools back to idle")

        # A degraded GET: 2 data-shard drives away, the reconstruct rows
        # run on the card from a loop dispatch.
        rec0 = es.device_windows["reconstruct"]
        disp0 = s.srv.eventloop_stats()["dispatch_total"]
        hc = s.srv.hot_cache
        hc.enabled = False           # the drives answer, not a resident copy
        try:
            with drives_away(s, data_holders("front", "big", 2),
                             "front/big"):
                st, got = c("GET", "/front/big")
        finally:
            hc.enabled = True
        check(st == 200 and got == big, "degraded GET not identical")
        check(es.device_windows["reconstruct"] > rec0,
              "the degraded GET did not reconstruct on the card: windows "
              f"{es.device_windows}, host {es.host_windows}")
        check(s.srv.eventloop_stats()["dispatch_total"] > disp0,
              "the degraded GET was not a loop dispatch")
        log("front end: GET with 2 data-shard drives away identical, "
            "reconstructed on the card from a loop dispatch")

        # Hot 4 KiB GETs answered on the loop thread.
        hot_keys = [(f"hot-{i}", rng.bytes(FE_HOT)) for i in
                    range(FE_HOT_KEYS)]
        for key, body in hot_keys:
            check(c("PUT", f"/front/{key}", body)[0] == 200, f"PUT {key}")
        prime_hot(s, hot_keys)
        st0 = s.srv.eventloop_stats()
        ka = KeepAlive(addr)
        try:
            for key, body in hot_keys:
                check(ka.request("GET", f"/front/{key}") == (200, body),
                      f"hot GET {key} not identical")
        finally:
            ka.close()
        st1 = s.srv.eventloop_stats()
        hits = st1["hot_hits_total"] - st0["hot_hits_total"]
        check(hits == FE_HOT_KEYS
              and st1["dispatch_total"] == st0["dispatch_total"],
              f"hot GETs not answered on the loop: {hits} hits, "
              f"{st1['dispatch_total'] - st0['dispatch_total']} dispatches")
        log(f"front end: {FE_HOT_KEYS} hot {FE_HOT // 1024} KiB GETs "
            "answered on the loop thread, identical, no dispatch")

        loop_rates = fe_rates(addr, "loop", hot_keys)
        st = s.srv.eventloop_stats()
        log(f"front end: loop stats {json.dumps({k: v for k, v in st.items() if k != 'loop_lag'})}")
        launches = read_launches()
    finally:
        s.stop()
    check_pool_idle("front end", device)

    # The same rates through the thread-per-connection front end, on the
    # same drives.
    with env_set(MTPU_HOT_CACHE="on", MTPU_HTTP_EVENTLOOP="off"):
        t = Server(root, "fe", device=device)
    try:
        check(t.srv.eventloop_stats() is None,
              "MTPU_HTTP_EVENTLOOP=off still booted the loop")
        prime_hot(t, hot_keys)
        thread_rates = fe_rates(t.srv.address, "threads", hot_keys)
    finally:
        t.stop()
    check_pool_idle("front end (threads)", device)
    log(f"front end rates ({smi('--query-gpu=name,power.limit')}; "
        f"{os.cpu_count()} host cores; {FE_CLIENTS} keep-alive clients): "
        f"1 KiB PUT keys/s "
        f"loop {loop_rates[0]:.1f} threads {thread_rates[0]:.1f}; hot "
        f"{FE_HOT // 1024} KiB GETs/s loop {loop_rates[1]:.1f} threads "
        f"{thread_rates[1]:.1f}")
    log(f"front end launches {launches}")
    check(launches["gf_apply"] and launches["highwayhash256"],
          f"a kernel of the front end's path never launched: {launches}")
    return launches


CUT_BODY = 2 * MIB + 777        # the overwrite: not inline, a ragged block
CUT_DROP_STRIDE = 2             # drop mode's points: every other one
CUT_MP_STRIDE = 7               # a multipart completion's points walked
CUT_LANE_STRIDE = 11            # a 12-drive lane batch's points walked


def phase_power_cut(rng, root: str, device: str = "cuda") -> dict:
    """The crash-point matrix on the card: an ErasureSet over 12
    CrashDisk-wrapped drives at EC 8+4 (minio_tpu_torch/storage/
    crashdisk.py), a CUT_BODY overwrite of a non-inline object cut at
    each durable sub-step in tear mode and at every CUT_DROP_STRIDE-th
    in drop mode, then the heal commit of
    one wiped data-shard drive cut at each of its sub-steps in drop
    mode. After each cut the drives are remounted through the boot's
    recover_drives, which must take the deep sweep on all 12 and leave
    no live WAL frame; a GET through the card must give the old or the
    new object (the new one once the PUT was acknowledged, the old one
    at every cut of the heal), the same after the heals recovery listed,
    no tmp/ or staging/ entry may be left and every pooled lease must be
    back. gf_apply (parity rows and r = 1)
    and highwayhash256 must have launched."""
    from minio_tpu_torch.object.erasure_object import ErasureSet
    from minio_tpu_torch.object.types import ObjectNotFound, VersionNotFound
    from minio_tpu_torch.io.bufpool import global_pool
    from minio_tpu_torch.server import recover_drives
    from minio_tpu_torch.storage.crashdisk import CrashClock, CrashDisk
    from minio_tpu_torch.storage.local import SYS_VOL, LocalStorage
    bkt, key, n_drives = "cut", "obj", 12
    old, new = rng.bytes(CUT_BODY), rng.bytes(CUT_BODY)
    base = os.path.join(root, "cut", "base")
    pool = global_pool(device)

    def drives(at: str, wrap=None) -> list:
        ds = [LocalStorage(os.path.join(at, f"d{i}"))
              for i in range(n_drives)]
        return [wrap(d) for d in ds] if wrap is not None else ds

    def mkset(ds: list):
        es = ErasureSet(ds, device=device)
        check(es.default_parity == M, "12 drives must give EC 8+4")
        return es

    def read(es):
        try:
            return es.get_object(bkt, key)[1]
        except ObjectNotFound:
            return None

    es = mkset(drives(base))
    try:
        es.make_bucket(bkt)
        es.put_object(bkt, key, old)
    finally:
        es.close()
    # Data shard 0's drive, wiped for the heal: its rebuild is one decode
    # row, and every GET before the heal lands reconstructs it.
    wiped = data_holders(bkt, key, 1)[0]
    walked = {"drop": 0, "tear": 0, "heal": 0, "multipart": 0, "lane": 0}
    fired: dict = {}

    def sweep(mode: str, label: str, op, allowed, prepare=None,
              stride: int = 1, src: str = base, answer=read,
              heals=((bkt, key),)) -> int:
        n = 1
        while True:
            at = os.path.join(root, "cut", f"{label}-{n}")
            shutil.copytree(src, at)
            if prepare is not None:
                prepare(at)
            clock = CrashClock(crash_at=n)
            es = mkset(drives(at, lambda d: CrashDisk(d, clock, mode)))
            es._mrf_closed = True
            acked = False
            try:
                op(es)
                acked = True
            except Exception as e:  # noqa: BLE001 - the cut, below quorum
                check(clock.fired, f"4k {label}: uncut op failed: {e!r}")
            finally:
                es.close()
                clock.power_off()
            where = f"4k {label} n={n} mode={mode} " \
                f"fired_op={clock.fired_op or 'none'}"
            rep = recover_drives(drives(at))
            check(rep["swept"] == n_drives,
                  f"{where}: recovery swept {rep['swept']}/{n_drives} deep")
            for i in range(n_drives):
                g = os.path.join(at, f"d{i}", SYS_VOL, "gcommit")
                live = [f for f in (os.listdir(g) if os.path.isdir(g)
                                    else []) if os.path.getsize(
                    os.path.join(g, f))]
                check(not live, f"{where}: live WAL frames in d{i}")
            es = mkset(drives(at))
            try:
                first = None
                for tag in ("remounted", "healed"):
                    try:
                        got = answer(es)
                    except Exception as e:  # noqa: BLE001 - named below
                        raise RuntimeError(f"chip_smoke: {where} ({tag}): "
                                           f"GET raised {e!r}") from e
                    check(any(got == x for x in allowed(acked)),
                          f"{where} ({tag}): the GET gave none of the "
                          f"allowed versions")
                    check(tag == "remounted" or got == first,
                          f"{where}: the heals moved the answer")
                    first = got
                    if tag == "remounted":
                        for vol, path in {*rep["heal"], *heals}:
                            try:
                                es.heal_object(vol, path)
                            except (ObjectNotFound, VersionNotFound):
                                pass    # absent after the cut: no heal
                if es._mrf is not None:
                    es._mrf.drain(15)
                    es._mrf.stop()
            finally:
                es.close()
            for i in range(n_drives):
                for sub in ("tmp", "staging"):
                    p = os.path.join(at, f"d{i}", SYS_VOL, sub)
                    check(not os.path.isdir(p) or not os.listdir(p),
                          f"{where}: debris left in d{i}/{sub}")
            t0 = time.perf_counter()
            while pool.stats()["outstanding"] and \
                    time.perf_counter() - t0 < 10:
                time.sleep(0.01)
            st = pool.stats()
            check(st["outstanding"] == 0 and st["leaks"] == 0,
                  f"{where}: {st['outstanding']} pooled leases "
                  f"outstanding, {st['leaks']} leaked")
            shutil.rmtree(at, ignore_errors=True)
            if not clock.fired:
                return clock.count
            walked[label] += 1
            fired[clock.fired_op] = fired.get(clock.fired_op, 0) + 1
            n += stride

    t0 = time.perf_counter()
    reset_launches()
    steps = {}
    for mode in ("drop", "tear"):
        # Drop mode walks every other point (CUT_DROP_STRIDE), tear mode
        # every one.
        steps[mode] = sweep(
            mode, mode, lambda es: es.put_object(bkt, key, new),
            lambda acked: [new] if acked else [old, new],
            stride=CUT_DROP_STRIDE if mode == "drop" else 1)
        check(steps[mode] >= 3 * n_drives,
              f"4k {mode}: {steps[mode]} sub-steps, fewer than a shard "
              "stream and two rename_data halves a drive")

    def wipe(at: str) -> None:
        shutil.rmtree(os.path.join(at, f"d{wiped}", bkt, key))
    steps["heal"] = sweep("drop", "heal",
                          lambda es: es.heal_object(bkt, key),
                          lambda acked: [old], prepare=wipe)

    # A multipart completion over the key (C.3's first case).
    mp_body = rng.bytes(CUT_BODY)

    def complete(es) -> None:
        from minio_tpu_torch.object.types import PutOptions
        uid = es.new_multipart_upload(bkt, key, PutOptions())
        part = es.put_object_part(bkt, key, uid, 1, mp_body)
        es.complete_multipart_upload(bkt, key, uid, [(1, part.etag)])
    steps["multipart"] = sweep(
        "drop", "multipart", complete,
        lambda acked: [mp_body] if acked else [old, mp_body],
        stride=CUT_MP_STRIDE)

    # Four concurrent inline overwrites, one lane batch a drive (C.2).
    import itertools
    lane_keys = [f"lane{i}" for i in range(4)]
    lane_old = [rng.bytes(1000 + i) for i in range(4)]
    lane_new = [rng.bytes(1100 + i) for i in range(4)]
    lane_base = os.path.join(root, "cut", "lane-base")
    with env_set(MTPU_GROUP_COMMIT_WAIT_MS="20000"):
        es = mkset(drives(lane_base))
        try:
            es.make_bucket(bkt)
            for k, b in zip(lane_keys, lane_old):
                es.put_object(bkt, k, b)
        finally:
            es.close()
        members: dict = {}

        def lanes(es) -> None:
            members.clear()
            es.group_commit.worth_batching = lambda: True
            gate = threading.Barrier(4)

            def put(i: int) -> None:
                gate.wait()
                try:
                    es.put_object(bkt, lane_keys[i], lane_new[i])
                    members[i] = True
                except Exception:  # noqa: BLE001 - the cut
                    pass
            ts = [threading.Thread(target=put, args=(i,)) for i in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
            if len(members) < 4:
                raise RuntimeError("a lane member was not acknowledged")

        def lane_answer(es) -> tuple:
            out = []
            for k in lane_keys:
                try:
                    out.append(es.get_object(bkt, k)[1])
                except ObjectNotFound:
                    out.append(None)
            return tuple(out)
        # An acknowledged member reads its new body; the others either.
        steps["lane"] = sweep(
            "drop", "lane", lanes,
            lambda acked: list(itertools.product(*[
                [lane_new[i]] if members.get(i) else [lane_old[i],
                                                      lane_new[i]]
                for i in range(4)])),
            stride=CUT_LANE_STRIDE, src=lane_base, answer=lane_answer,
            heals=[(bkt, k) for k in lane_keys])
    launches = in_process_launches()
    wall = time.perf_counter() - t0
    log(f"power cut: sub-steps of the uncut ops {steps}; points walked "
        f"{walked}; fired_op "
        f"{json.dumps(dict(sorted(fired.items())))}; wall {wall:.1f} s")
    log(f"power cut launches {launches}")
    by_r = launches["gf_apply_by_r"]
    check(by_r.get(str(M)) and by_r.get("1"),
          f"4k: gf_apply did not launch with parity rows and with r = 1: "
          f"{by_r}")
    check(launches["highwayhash256"], "4k: highwayhash256 never launched")
    shutil.rmtree(os.path.join(root, "cut"), ignore_errors=True)
    return launches


# -- 4l: the observability plane ---------------------------------------------

OBS_CLIENTS = 16
OBS_LOAD_S = 8.0                # seconds of the 16 clients' load
OBS_PAUSE = 0.1                 # seconds between a client's rounds
OBS_SLOW_MS = 50                # the phase's MTPU_SLOW_OP_MS
OBS_DELAY_S = 0.08              # the delayed drive's rename_data, above it
OBS_DEG_KEYS = 16               # 1 MiB keys read with two drives away
OBS_P50_PUTS = 25               # one-thread PUTs a turn of the p50 pairs
OBS_UNPACED_S = 4.0             # seconds of each unpaced 16-client window
# A drive's write of a PUT: its shard stream, or its journal's commit.
OBS_WRITES = ("disk.create_file", "disk.write_metadata", "disk.rename_data",
              "commit.group")


class TraceTail:
    """A live admin trace (GET /minio/admin/v3/trace?types=...) read on
    a thread of its own: its JSON entries collect in `entries` until
    stop()."""

    def __init__(self, address: str, types: str = "all"):
        import socket
        from minio_tpu_torch.s3 import sigv4
        q = {"types": types}
        uri, headers = sigv4.sign_headers(
            "GET", address, "/minio/admin/v3/trace", "minioadmin",
            "minioadmin", hashlib.sha256(b"").hexdigest(),
            query={k: [v] for k, v in q.items()})
        host, _, port = address.rpartition(":")
        self.conn = http.client.HTTPConnection(host, int(port), timeout=600)
        self.conn.request("GET", uri + "?" + urllib.parse.urlencode(q),
                          headers=headers)
        self.sock = self.conn.sock
        self.resp = self.conn.getresponse()
        check(self.resp.status == 200,
              f"admin trace through {address}: {self.resp.status}")
        self._shut = socket.SHUT_RDWR
        self.entries: list = []
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        # Large reads, split into lines here: a line at a time through
        # the chunked decoder falls behind a loaded server, whose queue
        # for this subscriber then drops its oldest entries.
        buf = b""
        try:
            while True:
                got = self.resp.read1(1 << 20)
                if not got:
                    return
                buf += got
                *lines, buf = buf.split(b"\n")
                self.entries.extend(json.loads(ln) for ln in lines
                                    if ln.strip())
        except (OSError, ValueError, http.client.HTTPException):
            pass            # stop() shut the socket

    def stop(self, settle: float = 0.5) -> list:
        """The entries, once none came for `settle` seconds."""
        n, t0 = -1, time.perf_counter()
        while n != len(self.entries) and time.perf_counter() - t0 < 30:
            n = len(self.entries)
            time.sleep(settle)
        try:
            self.sock.shutdown(self._shut)
        except OSError:
            pass
        self.thread.join(10)
        self.conn.close()
        return self.entries


def trace_trees(entries: list) -> dict:
    """trace id -> (root entry, [its spans' entries])."""
    roots, spans = {}, {}
    for e in entries:
        if e.get("span") == 0:
            roots[e["trace"]] = e
        elif "trace" in e:
            spans.setdefault(e["trace"], []).append(e)
    return {t: (r, spans.get(t, [])) for t, r in roots.items()}


def under_root(span: dict, tree: list) -> bool:
    """Whether the span's parent chain reaches the request (span 0)."""
    by_id = {e["span"]: e for e in tree}
    seen, cur = set(), span
    while cur["parent"] and cur["parent"] not in seen:
        seen.add(cur["parent"])
        cur = by_id.get(cur["parent"])
        if cur is None:
            return False
    return cur["parent"] == 0


def prometheus_samples(text: str) -> dict:
    """{(name, labels): value} of an exposition; raises on a line that
    is neither a HELP/TYPE comment nor a sample."""
    import re
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? '
                        r'(-?[0-9.eE+-]+|NaN|[+-]Inf)$')
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            continue
        m = sample.match(ln)
        check(m is not None, f"not Prometheus text: {ln!r}")
        out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def api_counts(samples: dict) -> dict:
    import re
    out: dict = {}
    for (name, labels), v in samples.items():
        if name == "minio_tpu_http_requests_total":
            api = re.search(r'api="([^"]+)"', labels).group(1)
            out[api] = out.get(api, 0) + int(v)
    return out


def p50(xs):
    return sorted(xs)[len(xs) // 2] if xs else float("nan")


def wait_disarmed(tracing) -> None:
    """The server drops a closed subscription at its next write to the
    stream (a heartbeat within 1 s)."""
    t0 = time.perf_counter()
    while tracing.ACTIVE and time.perf_counter() - t0 < 10:
        time.sleep(0.05)


def unpaced_window(c, srv, bodies, small, deg, deg_body,
                   armed: bool) -> dict:
    """4l's rounds from OBS_CLIENTS clients with no pause for
    OBS_UNPACED_S: the rounds done, the 1 MiB PUT and GET p50 ms and,
    armed (a types=all subscriber), the entries it received, the whole
    request trees among them and what the server dropped for it."""
    from minio_tpu_torch.utils import tracing
    if not armed:
        wait_disarmed(tracing)      # the paced window's subscriber
    tail = TraceTail(srv.address, "all") if armed else None
    check(tracing.ACTIVE == armed, f"4l unpaced: tracing.ACTIVE "
          f"{tracing.ACTIVE}, armed {armed}")
    dropped0 = srv.tracer.dropped
    lat: dict = {"put": [], "get": []}
    mu = threading.Lock()
    end = time.monotonic() + OBS_UNPACED_S

    def load(t: int, _item) -> None:
        n = 0
        while time.monotonic() < end:
            key = f"/obs/unpaced/c{t:02d}/k{n % 4}"
            b = bodies[(t + n) % 4]
            t0 = time.perf_counter()
            check(c("PUT", key, b)[0] == 200, f"4l unpaced PUT {key}")
            t1 = time.perf_counter()
            check(c("GET", key) == (200, b), f"4l unpaced GET {key}")
            t2 = time.perf_counter()
            dk = deg[(t + n) % len(deg)]
            check(c("GET", f"/obsdeg/{dk}") == (200, deg_body[dk]),
                  f"4l unpaced degraded GET {dk}")
            check(c("PUT", f"/obs/unpaced/c{t:02d}/s{n:03d}",
                    small)[0] == 200, "4l unpaced 1 KiB PUT")
            with mu:
                lat["put"].append((t1 - t0) * 1e3)
                lat["get"].append((t2 - t1) * 1e3)
            n += 1
    wall = run_clients(load, [[None]] * OBS_CLIENTS)
    out = {"rounds": len(lat["put"]), "wall_s": round(wall, 3),
           "requests": 4 * len(lat["put"]),
           "put_1mib_p50_ms": round(p50(lat["put"]), 3),
           "get_1mib_p50_ms": round(p50(lat["get"]), 3)}
    if tail is not None:
        entries = tail.stop()
        wait_disarmed(tracing)
        trees = trace_trees(entries)
        out.update(entries=len(entries), trees=len(trees),
                   dropped=srv.tracer.dropped - dropped0)
    return out


def phase_observability(rng, root: str, device: str = "cuda") -> dict:
    """4l, see the module docstring."""
    import io
    import zipfile
    from minio_tpu_torch.utils import tracing
    reset_launches()
    with env_set(MTPU_SLOW_OP_MS=str(OBS_SLOW_MS)):
        s = Server(root, "obs", device=device)
    try:
        c, es, srv = s.client, s.es, s.srv
        check(tracing.ACTIVE and tracing.slow_ms() == OBS_SLOW_MS,
              "4l: MTPU_SLOW_OP_MS did not arm the slow-op log")
        slow_drive = 5
        sleepy = SleepyDisk(es.disks[slow_drive]._disk)
        es.disks[slow_drive]._disk = sleepy
        for b in ("obs", "obsdeg"):
            check(c("PUT", f"/{b}")[0] == 200, f"4l: make bucket {b}")
        # Keys with a data shard on one of the two drives taken away.
        away = (2, 9)
        deg, i = [], 0
        while len(deg) < OBS_DEG_KEYS:
            k = f"deg{i:03d}"
            if set(data_holders("obsdeg", k, K)) & set(away):
                deg.append(k)
            i += 1
        deg_body = {k: rng.bytes(MIB) for k in deg}
        for k in deg:
            check(c("PUT", f"/obsdeg/{k}", deg_body[k])[0] == 200,
                  f"4l: PUT obsdeg/{k}")
        for d in away:
            vol = os.path.join(s.drives[d], "obsdeg")
            os.rename(vol, vol + ".away")
        check(c("POST", "/minio/admin/v3/start-profiling")[0] == 200,
              "4l: start-profiling")
        scrape0 = prometheus_samples(c.send(
            "GET", "/minio/v2/metrics/cluster")[1].decode())
        tail = TraceTail(srv.address, "all")
        time.sleep(0.3)
        bodies = [rng.bytes(MIB) for _ in range(4)]
        small = rng.bytes(1024)
        sent: dict = {}
        mu = threading.Lock()
        end = time.monotonic() + OBS_LOAD_S
        sleepy.delays.update({op: OBS_DELAY_S for op in (
            "write_metadata", "rename_data", "commit_group")})

        def load(t: int, _item) -> None:
            n = 0
            while time.monotonic() < end:
                key = f"/obs/big/c{t:02d}/k{n % 4}"
                b = bodies[(t + n) % 4]
                check(c("PUT", key, b)[0] == 200, f"4l PUT {key}")
                check(c("GET", key) == (200, b), f"4l GET {key}")
                dk = deg[(t + n) % len(deg)]
                check(c("GET", f"/obsdeg/{dk}") == (200, deg_body[dk]),
                      f"4l degraded GET {dk}")
                check(c("PUT", f"/obs/small/c{t:02d}/k{n:03d}",
                        small)[0] == 200, "4l 1 KiB PUT")
                with mu:
                    sent["PUT:object"] = sent.get("PUT:object", 0) + 2
                    sent["GET:object"] = sent.get("GET:object", 0) + 2
                n += 1
                time.sleep(OBS_PAUSE)
        wall = run_clients(load, [[None]] * OBS_CLIENTS)
        sleepy.delays.clear()
        entries = tail.stop()
        scrape1_text = c.send("GET", "/minio/v2/metrics/cluster")[1].decode()
        scrape1 = prometheus_samples(scrape1_text)
        got = api_counts(scrape1)
        base = api_counts(scrape0)
        delta = {a: got.get(a, 0) - base.get(a, 0) for a in sent}
        log(f"4l load: {OBS_CLIENTS} clients {wall:.2f} s, requests sent "
            f"{sent}, the scrape's counts over the load {delta} "
            f"({len(scrape1)} samples parsed)")
        check(delta == sent, f"4l: the scrape's per-API counts {delta} "
              f"are not the requests sent {sent}")
        st, z = c.send("GET", "/minio/admin/v3/download-profiling")[:2]
        check(st == 200, f"4l download-profiling: {st}")
        prof = zipfile.ZipFile(io.BytesIO(z))
        text = prof.read("local/profile.txt").decode()
        check("put_object" in text, "4l: the profile names no put_object:"
              f" {text[:3000]}")
        log(f"4l profile: {prof.namelist()}, {len(text)} bytes of text "
            "naming put_object")

        # -- the trees ----------------------------------------------------
        trees = trace_trees(entries)
        kinds = {"put": 0, "get": 0, "deg": 0, "small": 0}
        dev_ms: dict = {"put": [], "get": [], "deg": []}
        svc_ms: dict = {"put": [], "get": [], "deg": []}
        lanes = 0
        for root_e, tree in trees.values():
            path = root_e.get("path", "")
            kern = [e for e in tree if e.get("api") == "batcher.dispatch"]
            if root_e["api"] == "PUT:object" and path.startswith("/obs/big"):
                kind = "put"
                # 1 MiB at 8+4 goes inline: each drive's write is its
                # journal's (solo, or in a lane batch).
                writes = {e["tags"]["drive"] for e in tree
                          if e.get("api") in OBS_WRITES
                          and under_root(e, tree)}
                check(len(writes) == 12, f"4l: a PUT's tree has write "
                      f"spans of {len(writes)} drives: {path}")
            elif root_e["api"] == "GET:object" and path.startswith("/obs/"):
                kind = "get"
            elif root_e["api"] == "GET:object":
                kind = "deg"
                check(any(e["tags"].get("op") == "reconstruct"
                          for e in kern), f"4l: a degraded GET's tree has "
                      f"no reconstruct kernel span: {path}")
            elif root_e["api"] == "PUT:object":
                kinds["small"] += 1
                lanes += any(e.get("api") == "commit.group" for e in tree)
                continue
            else:
                continue
            kinds[kind] += 1
            timed = [e for e in kern if "lane_ms" in e["tags"]]
            # The CPU (a rehearsal) has no lane stream to time. The
            # events bracket the dispatch inside the lane's service.
            check(kern and (device == "cpu" or timed and all(
                0 < e["tags"]["lane_ms"] <= e["tags"]["service_ms"] + 0.25
                and e["tags"]["service_ms"] <= e["durationMs"]
                for e in timed)), f"4l: {kind} {path}: kernel spans "
                  f"{[e['tags'] for e in kern]}")
            dev_ms[kind] += [e["tags"]["lane_ms"] for e in timed]
            svc_ms[kind] += [e["tags"]["service_ms"] for e in timed]
        n_put = sent["PUT:object"] // 2
        check(kinds["put"] == n_put and kinds["get"] == n_put
              and kinds["deg"] == n_put and kinds["small"] == n_put,
              f"4l: trees received {kinds}, {n_put} of each sent")
        log(f"4l trace: {len(entries)} entries, {len(trees)} request trees "
            f"{kinds}; every 1 MiB PUT's tree with a write span of each "
            f"of the 12 drives under it; kernel lane_ms/service_ms p50 "
            f"put {p50(dev_ms['put']):.3f}/{p50(svc_ms['put']):.3f}, "
            f"get {p50(dev_ms['get']):.3f}/{p50(svc_ms['get']):.3f}, "
            f"reconstruct {p50(dev_ms['deg']):.3f}/"
            f"{p50(svc_ms['deg']):.3f}; 1 KiB PUTs with a commit.group "
            f"span {lanes} of {kinds['small']}")
        # The delayed drive's write: a solo commit's `disk.<op>` span, or
        # the lane batch's `commit.group` span of that drive.
        slow = [r for r in tracing.slow_ops()
                if r.get("name") in OBS_WRITES[1:]
                + ("disk.commit_group",)
                and (r.get("tags") or {}).get("drive")
                == s.drives[slow_drive]]
        check(slow, "4l: no slow-op record names the delayed drive")
        log(f"4l slow-op: {tracing.slow_total} records; the delayed drive's "
            f"{slow[-1]['name']} {slow[-1]['duration_ms']} ms on "
            f"{slow[-1]['tags']['drive']}, ancestry {slow[-1]['ancestry']}")
        st, body, _ = c.send("GET", "/minio/admin/v3/info")
        info = json.loads(body)
        names = {o["name"] for o in info["slo"]["objectives"]}
        check({"get-availability", "put-availability"} <= names,
              f"4l: the SLO snapshot's objectives {names}")
        st, body, _ = c.send("POST", "/minio/admin/v3/speedtest",
                             query={"size": str(MIB), "count": "4"})
        check(st == 200, f"4l speedtest: {st} {body[:200]!r}")
        log(f"4l SLO verdict {info['slo']['verdict']} over "
            f"{sorted(names)}; speedtest {json.loads(body)}")

        # -- unpaced: 16 clients as fast as they go, disarmed then armed --
        tracing.set_slow_ms(0)
        for armed in (False, True):
            got = unpaced_window(c, srv, bodies, small, deg, deg_body,
                                 armed)
            log(f"4l unpaced {'armed' if armed else 'disarmed'}: {got}")
        for d in away:
            vol = os.path.join(s.drives[d], "obsdeg")
            os.rename(vol + ".away", vol)

        # -- the disarmed path's cost, one thread -------------------------
        check(not tracing.ACTIVE, "4l: tracing still armed")
        p50s: dict = {}
        for size in (1024, MIB):
            body = rng.bytes(size)
            for turn in ("disarmed", "armed", "disarmed", "armed"):
                tail = TraceTail(srv.address, "all") \
                    if turn == "armed" else None
                check((tail is not None) == tracing.ACTIVE,
                      f"4l: tracing.ACTIVE {tracing.ACTIVE} {turn}")
                ts = []
                for n in range(OBS_P50_PUTS):
                    t0 = time.perf_counter()
                    check(c("PUT", f"/obs/p50/{size}/{n}", body)[0] == 200,
                          "4l p50 PUT")
                    ts.append((time.perf_counter() - t0) * 1e3)
                if tail is not None:
                    tail.stop(settle=0.2)
                    wait_disarmed(tracing)
                p50s.setdefault((size, turn), []).append(p50(ts))
        log("4l one-thread PUT p50 ms, disarmed and armed (a types=all "
            "trace subscriber), two turns each: " + "; ".join(
                f"{'1 KiB' if size == 1024 else '1 MiB'} {turn} "
                f"{', '.join(f'{v:.3f}' for v in vs)}"
                for (size, turn), vs in p50s.items())
            + f" ({smi('--query-gpu=name,power.limit')})")
    finally:
        tracing.set_slow_ms(0)
        s.stop()
    check_pool_idle("4l")
    launches = in_process_launches()
    log(f"4l launches {launches}")
    by_r = launches["gf_apply_by_r"]
    check(by_r.get(str(M)) and any(by_r.get(str(r)) for r in (1, 2)),
          f"4l: gf_apply without parity or decode rows: {by_r}")
    check(launches["highwayhash256"], "4l: highwayhash256 never launched")
    shutil.rmtree(os.path.join(root, "obs"), ignore_errors=True)
    return launches


def phase_b5_entry_point(torch):
    """python -m minio_tpu_torch.experiments.rs_i8_kernel, in process."""
    from minio_tpu_torch.experiments import rs_i8_kernel
    reset_launches()
    rc = rs_i8_kernel.main([])
    launches = read_launches()
    check(rc == 0, f"rs_i8_kernel entry point exited {rc}")
    check(launches["rs_i8"] > 0, "rs_i8 never launched from its entry point")
    log(f"rs_i8 entry point launches {launches}")
    return launches


def bound(nbytes: int, ops: int, ops_per_s: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gf_bound(b: int, r: int = M) -> tuple[float, str]:
    """gf_apply's bound at b x 8 x 128 KiB stripes and r output rows: the
    stripes read, the rows written and the byte tables read once; one
    table lookup and one XOR per (output row, input shard, byte)."""
    return bound(b * K * SHARD + b * r * SHARD + r * K * 256,
                 2 * b * r * K * SHARD, INT32_OPS_PER_S)


def phase_times(torch, dev, rng):
    """{(kernel, blocks): (ms, plain_ms, bound_ms, bound_by)} at the main
    path's shapes."""
    from minio_tpu_torch.experiments import rs_i8_kernel
    from minio_tpu_torch.ops import gf256, hh_device, rs_device

    timer = Timer(torch)
    out = {}
    pm = gf256.parity_matrix(K, M)
    # gf_apply's rows: parity; the decode rows of 4 lost data shards; the
    # one row of a read that lost data shard 0 alone.
    mats = {"parity": pm, "decode": decode_rows(),
            "one-drive decode": gf256.decode_matrix(K, M,
                                                    tuple(range(1, 9)))[:1]}
    length = SHARD
    # The batcher's bucket 8, one client's 32-block window and the largest
    # bucket; each set of buffers is larger than the 50 MB L2.
    for b, nbuf in ((8, 12), (32, 4), (256, 2)):
        bufs = [torch.from_numpy(rng.integers(0, 256, size=(b, K, length),
                                              dtype=np.uint8)).to(dev)
                for _ in range(nbuf)]
        nbytes = b * K * length + b * M * length
        for rows, mat in mats.items() if b == 32 else (("parity", pm),):
            def launch(i, mat=mat):
                return rs_device.gf_apply(mat, bufs[i % nbuf])
            ms, queued = timer(launch, 40), timer(launch, 40, queued=True)
            bms, by = gf_bound(b, len(mat))
            log(f"time gf_apply {rows} rows at {b} x {K} x {length} B: "
                f"{ms:.4f} ms ({queued:.4f} ms queued behind a spin "
                f"kernel), bound {bms:.4f} ms ({by}), {bms / ms * 100:.2f}% "
                f"of bound ({bms / queued * 100:.2f}% queued)")
            if rows == "parity":
                plain = timer(lambda i: rs_device.gf_apply_plain(
                    pm, bufs[i % nbuf]), iters=2, warmup=1)
                out[("gf_apply", b)] = (ms, plain, bms, by)
        if b != 8:
            def launch(i):
                return rs_i8_kernel.rs_apply8(pm, bufs[i % nbuf])
            ms, queued = timer(launch, 40), timer(launch, 40, queued=True)
            plain = timer(lambda i: rs_i8_kernel.rs_apply8_plain(
                pm, bufs[i % nbuf]), iters=2, warmup=1)
            # The needed int8 product: [8r, 8k] bit matrix over every byte
            # lane.
            out[("rs_i8", b)] = (ms, plain) + bound(
                nbytes, 2 * (8 * M) * (8 * K) * b * length,
                INT8_TC_OPS_PER_S)
            bms = out[("rs_i8", b)][2]
            log(f"time rs_i8 parity rows at {b} x {K} x {length} B: "
                f"{ms:.4f} ms ({queued:.4f} ms queued behind a spin "
                f"kernel), bound {bms:.4f} ms, {bms / ms * 100:.2f}% of "
                f"bound ({bms / queued * 100:.2f}% queued)")
        del bufs
        torch.cuda.empty_cache()

    # Pool 2's geometry in phase 4g, EC 12+4: shards of ceil(1 MiB / 12)
    # = 87,382 B, not a multiple of 16, so the kernel's unvectorized
    # loads; k = 12 > 8 runs its second group of shard loads.
    pm12 = gf256.parity_matrix(PL_K, PL_M)
    l12 = -(-MIB // PL_K)
    for b, nbuf in ((32, 4), (256, 2)):
        bufs = [torch.from_numpy(rng.integers(0, 256, size=(b, PL_K, l12),
                                              dtype=np.uint8)).to(dev)
                for _ in range(nbuf)]

        def launch(i):
            return rs_device.gf_apply(pm12, bufs[i % nbuf])
        ms, queued = timer(launch, 40), timer(launch, 40, queued=True)
        plain = timer(lambda i: rs_device.gf_apply_plain(pm12, bufs[i % nbuf]),
                      iters=2, warmup=1)
        bms, by = bound(b * (PL_K + PL_M) * l12 + PL_M * PL_K * 256,
                        2 * b * PL_M * PL_K * l12, INT32_OPS_PER_S)
        log(f"time gf_apply 12+4 parity rows (k = {PL_K}, r = {PL_M}) at "
            f"{b} x {PL_K} x {l12} B: {ms:.4f} ms ({queued:.4f} ms queued "
            f"behind a spin kernel), plain {plain:.4f} ms, bound "
            f"{bms:.4f} ms ({by}), {bms / ms * 100:.2f}% of bound "
            f"({bms / queued * 100:.2f}% queued)")
        del bufs
    pool = torch.from_numpy(rng.integers(0, 256, size=(4096, l12),
                                         dtype=np.uint8)).to(dev)
    for st in (PL_K + PL_M, 32 * (PL_K + PL_M)):
        def launch(i, st=st):
            o = i * st % (4097 - st)
            return hh_device.hash_rows(pool[o:o + st])
        ms = timer(launch, iters=20)
        bms, by = bound(st * l12 + st * 32, 104 * st * (-(-l12 // 32) + 10),
                        INT32_OPS_PER_S)
        log(f"time highwayhash256 at {st} streams x {l12} B (12+4 blocks): "
            f"{ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{bms / ms * 100:.2f}% of bound")
    del pool
    torch.cuda.empty_cache()

    # highwayhash256 at 1, 12, 96, 384 and 3,072 streams x 128 KiB. Call i
    # hashes rows [o_i, o_i + S) of a 512 MiB pool, o_i walking the pool,
    # so that each launch finds its rows out of L2.
    pool = torch.from_numpy(rng.integers(0, 256, size=(4096, length),
                                         dtype=np.uint8)).to(dev)
    hh = {}
    for s in (1, 12, 96, 384, 3072):
        def launch(i, s=s):
            o = i * s % (4097 - s)
            return hh_device.hash_rows(pool[o:o + s])
        ms = timer(launch, iters=20)
        # ~104 32-bit integer operations per packet update (four lanes of
        # 64-bit adds, 32x32->64 products and XORs, four zipper merges):
        # the data's packets plus the 10 finalisation rounds.
        ops = 104 * s * (length // 32 + (1 if length % 32 else 0) + 10)
        hh[s] = (ms,) + bound(s * length + s * 32, ops, INT32_OPS_PER_S)
    plain = timer(lambda i: hh_device.hash_bytes_plain(pool[384 * i:
                                                            384 * (i + 1)]),
                  iters=1, warmup=0)
    out[("highwayhash256", 32)] = (hh[384][0], plain) + hh[384][1:]
    del pool
    torch.cuda.empty_cache()
    for (name, b), (ms, plain, bms, by) in out.items():
        log(f"time {name} at {b} blocks: {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), {bms / ms * 100:.2f}% of bound")
    floor = hh[1][0]
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    log(f"highwayhash256 recurrence floor (1 stream x {length} B): "
        f"{floor:.4f} ms, {floor * 1e3 * mhz / (length // 32 + 10):.1f} "
        f"cycles a packet update at the {mhz:.0f} MHz maximum SM clock")
    for s, (ms, bms, by) in hh.items():
        log(f"time highwayhash256 at {s} streams x {length} B: {ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), {bms / ms * 100:.2f}% of bound, "
            f"{ms / floor:.3f}x the floor")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    from minio_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    t_start = t0 = time.perf_counter()
    _build.build()
    log(f"kernel build {time.perf_counter() - t0:.2f} s")
    for kern in _build.KERNELS:
        for line in _build.ptxas_report(kern).splitlines():
            if "Used" in line:
                log(f"ptxas {kern}: {line.split(':', 1)[1].strip()}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    errs = {"gf_apply": 0, "highwayhash256": 0, "rs_i8": 0}

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            log(f"phase {name} wall {time.perf_counter() - t0:.1f} s")

    # Phases 3-4e take drives away by hand and then read: no fileinfo or
    # hot-object cache may answer for the drives there, and their
    # servers run in one process (4d's SIGKILL must hit the server).
    os.environ.update(MTPU_FILEINFO_CACHE="off", MTPU_HOT_CACHE="off",
                      MTPU_HTTP_WORKERS="1")
    timed("2 (kernels)", phase_kernels, torch, dev, rng, errs)
    root = drive_root()
    try:
        seq = timed("3", phase_main_path, torch, rng, root)
        conc, conc_stats = timed("4", phase_concurrent, torch, rng, root)
        s = Server(root, "mph", mrf=True)
        try:
            mph, mph_objs = timed("4b", phase_multipart_heal, torch, rng, s,
                                  root)
            ns = timed("4c", phase_namespace, rng, s, mph_objs)
        finally:
            s.stop()
        check_pool_idle("multipart/heal/namespace")
        crash = timed("4d", phase_crash, rng, root)
        for done in ("seq", "conc", "mph", "crash"):
            shutil.rmtree(os.path.join(root, done), ignore_errors=True)
        dp = timed("4e", phase_drive_plane, rng, root)
        for done in os.listdir(root):
            shutil.rmtree(os.path.join(root, done), ignore_errors=True)
        fleet = timed("4f", phase_fleet, rng, root)
        for done in os.listdir(root):
            shutil.rmtree(os.path.join(root, done), ignore_errors=True)
        pools = timed("4g", phase_pools, rng, root)
        for done in os.listdir(root):
            shutil.rmtree(os.path.join(root, done), ignore_errors=True)
        dist = timed("4h", phase_distributed, rng, root)
        for done in os.listdir(root):
            shutil.rmtree(os.path.join(root, done), ignore_errors=True)
        elastic = timed("4i", phase_elastic_fleet, rng, root)
        for done in os.listdir(root):
            shutil.rmtree(os.path.join(root, done), ignore_errors=True)
        front = timed("4j", phase_front_end, rng, root)
        for done in os.listdir(root):
            shutil.rmtree(os.path.join(root, done), ignore_errors=True)
        cut = timed("4k", phase_power_cut, rng, root)
        for done in os.listdir(root):
            shutil.rmtree(os.path.join(root, done), ignore_errors=True)
        obs = timed("4l", phase_observability, rng, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    timed("4 (solo dispatch)", solo_dispatch_ms, torch, rng, conc_stats)
    b5 = timed("5", phase_b5_entry_point, torch)
    times = timed("6", phase_times, torch, dev, rng)

    launches = {k: seq[k] + conc[k] + mph[k] + ns[k] + crash[k] + dp[k]
                + fleet[k] + pools[k] + dist[k] + elastic[k] + front[k]
                + cut[k] + obs[k] for k in ("gf_apply", "highwayhash256")}
    launches["rs_i8"] = b5["rs_i8"]
    meta = {
        "gf_apply": ("minio_tpu_torch/ops/csrc/gf_apply.cu",
                     "minio_tpu/ops/rs_device.py:321", 32),
        "highwayhash256": ("minio_tpu_torch/ops/csrc/highwayhash.cu",
                           "minio_tpu/ops/hh_device.py:525", 32),
        "rs_i8": ("minio_tpu_torch/ops/csrc/rs_i8.cu",
                  "experiments/rs_i8_kernel.py:78", 256),
    }
    kernels = []
    for kern, (src, replaces, blocks) in meta.items():
        ms, plain, bms, by = times[(kern, blocks)]
        kernels.append({"name": kern, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[kern],
                        "max_abs_err": errs[kern], "ms": ms,
                        "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                        "library_ms": None})
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
