"""Smoke run of the PyTorch/CUDA port (minio_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

About 12-18 minutes on one H100 (719-933 s with phase 21, 926.3 s with
phase 22, 940.8 s with phase 23, PERF.md §5; the host's speed moves it by
a third either way),
the kernels' builds included. Phases, each printing one JSON line; any failure exits
non-zero:

  1. build    — compile every hand-written kernel (csrc/*.cu, one nvcc per
                source, all at once) and report nvcc's register/spill lines
                and scan_eval's registers, stack frame and spill bytes
                per instantiation.
  2. kernels  — each kernel on the card against its plain PyTorch
                version, byte for byte (tolerance 0; hh256's and sha256's
                plain versions run on CPU copies of the same rows, where
                they take a quarter to a half of their time on the card,
                which phase 4 reads): gf_matmul with a parity, a
                3-missing decode and a recover matrix at 16 ragged widths
                S from 0 to 349,526 and at the main path's B=8,
                S=349,526 (the parity launch three times: a store race
                shows only sometimes), random 0/1 matrices at r in {1, 2,
                3, 4, 5, 8, 12, 16} x k in {1, 3, 12, 16}, and input and
                output views starting at every byte offset 1..15 (the
                bytes around the output must stay as they were), and input
                and output at each end of a mapping between unmapped
                address ranges (utils/guard_pages.py: a read or store
                outside the tensors faults), as for hh256's main-path rows;
                hh256
                (also against the scalar HighwayHash on one row of each
                case) on rows of every length 0..64, rows starting at
                every offset mod 16 (strides 1031 and 349,526, views that
                start mid-word, a sliced view made contiguous), lengths
                around each ring chunk size, 1 to 9000 rows, 349,526 bytes
                inside longer rows, length == row stride on the tensor's
                last row, and the main path's 8 x (12 + r) rows of 349,526
                bytes for r = 0..4;
                sha256 against its plain version and hashlib (the third
                witness) at lengths 0, 1, 55, 56, 63, 64, 65, 119, 120,
                65,535 and 65,536 (length < S in all but the last) on
                N = 1, 20, 160 and 640 rows of S = 65,536, at the ring's
                edges (1, 31-33, 63-65 and 639-641 rows; lengths of a
                ring stage -1, +0, +1 and both padding forms ending or
                crossing a stage, at 128 and 768 bytes), rows at 4- and
                1-byte alignments (strides 1,028 and 1,031, views from
                bytes 1..3), and config 5's 640 rows at each end of a
                guarded mapping; gf_matmul at config 5's shapes: encode
                (B=32, 4x16, S=65,536) and decode with r = 1 and 4 of
                k = 16 (B=8); chacha20 against its plain version, into a
                new tensor and in place, at the RFC 8439 §2.4.2 vector,
                packages of 64, 4,096 and 65,536 B x P = 1, 2, 16, spans
                shorter than the row (the bytes past them must stay as
                they were), the PUT's flat rows of 1,048,584 and
                4,194,312 B, rows at 8-, 4- and 1-byte alignment, input
                and output rows at different offsets mod 16, GET's
                64 x 65,536 with a short padded last package, and input
                and output at each end of a guarded mapping; and
                sse_put_step / sse_get_step on the card against the same
                steps on CPU tensors (config 2's block, B=2); scan_eval
                against its plain version (ops/scan_plain.py), equal
                masks and COUNT sums, over 250 seeded queries of
                tests/test_scan.py's generator (scripts/scan_cases.py,
                literals longer than the width, nan / inf / -0 / 1e400 /
                subnormal cells) on CSV and JSON-Lines pages at every
                width 8-128, fixed predicates over every node kind also
                held against the host evaluator's WHERE decision, B = 1,
                3, 64 and 254 pages with a ragged last page, packed pages
                with inputs and outputs at each end of a guarded mapping,
                and (a * 3) + 1, which one FMA would round differently.
  3. main path — one 16-drive erasure set at EC 12+4, 4 MiB blocks,
                highwayhash256S streaming bitrot: PUT eight 64 MiB objects,
                one of 64 MiB + 12,345 bytes and one of 1 KiB; GET them all
                back (bytes and MD5 ETags compared); reopen the set with 3
                drives missing (one holds a data shard) and GET them all
                again through the fused verify+decode step. Both kernels'
                launch counters must rise in the PUT and degraded-GET runs.
                Prints the codec's transfer/compute/fetch seconds per
                verb and the per-stage timer report.
  5. concurrent PUT — BASELINE.json config 2: 32 threads each PUT one
                16 MiB object at once into a 16-drive 12+4 set with 1 MiB
                blocks, through the batch former (parallel/scheduler.py)
                and the pipelined PUT loop; every object read back (bytes,
                MD5 ETag). Fails unless the former coalesced, declined
                nothing and routed nothing to the host, and each kernel's
                launches equal the encode dispatches exactly. Prints the
                aggregate GiB/s, the stage report (seconds, p50/p99, the
                pipeline overlap) and the codec's stage seconds. Runs
                under the lock-order watchdog (see Watchdog).
  6. heal     — BASELINE.json config 4 on the phase-3 set: one drive's
                bucket dir deleted (format.json kept), every object healed
                through the former's recover verb; rebuilt part and xl.meta
                files byte-identical to the deleted ones, recover dispatches
                on the card exactly those the size gate sends there, and a
                second pass with a flipped survivor byte that heal must find
                by its digest. Prints heal GiB/s.
  7. MRF      — four 64 MiB PUTs with one drive offline queue on the MRF
                healer; the drive returns, the queue drains, and its shard
                files equal those of a healthy PUT of the same bytes.
  4. timings  — with CUDA events after warm-up: at BASELINE.json's shape
                (B=32, 12+4, 1 MiB blocks, S=87,382) put_step, each kernel
                and each plain version; each kernel alone also at the main
                path's launch shapes: gf_matmul for PUT parity (B=8, 4x12,
                S=349,526), degraded-GET decode (B=8, S=349,526, r=1 and
                r=3) and heal's recover (B=8, r=1), hh256 over 128 rows
                (PUT), 96 rows (degraded GET) and 104 rows (heal) of
                349,526 bytes. Beside each: the byte bound (bytes moved /
                3.35 TB/s), the operation bound (32-bit operations / the
                INT32 rate) and, for hh256, the chain floor: packet rounds
                x the cycles of one trip of the kernel's packet loop (its
                longest dependency chain, read from cuobjdump -sass) at the
                SM clock nvidia-smi reports under load. sha256 at config
                5's encode launch shapes (640 and 160 rows of 65,536 B)
                beside its byte and operation bounds and its chain floor
                (compressions x the chain cycles of one trip of its block
                loop, read the same way), its plain version and
                hashlib.sha256 on the host over the same rows; gf_matmul
                at k = 16: config 5's encode and degraded-GET decodes.
  8. config 5 — BASELINE.json config 5, multipart upload over two server
                sets with SHA-256 bitrot and cross-set shard batching (see
                run_config5 for the cuts): 16 part uploads of 64 MiB in
                flight at once into two pools of one 16+4 set each,
                sharing one batch former; every object read back by bytes
                and multipart ETag, healthy and with 4 of 20 drives gone
                in each pool; then the uploads again under torch.profiler
                for the idle share and the kernels' device ms per encode
                dispatch.
  9. SSE      — BASELINE.json config 2 under SSE-S3 with ChaCha20-Poly1305
                (see run_sse): 8 threads (config 2's 32, cut to a
                quarter for the run's time) each PUT one 16 MiB object at once through setup_put_transforms and the DeviceSSE spec,
                the former and the pipelined loop; every object read back
                through resolve_get_key and chacha_decrypt_ranged (bytes,
                MD5 ETag), three ranged reads across a 64-package batch,
                eight reads with 3 drives gone, the stored bytes against
                ChaChaEncryptor and every tag under open_detached, a
                flipped ciphertext byte found before any plaintext,
                submit_decode(sse=) through sse_get_step, one SSE-C
                object; chacha20 launches equal the encrypted encode
                dispatches and the GET decipher batches, per path. Prints
                the GiB/s, the host Poly1305 seconds for the phase's
                packages (timed on one core) and the idle share of 4 of
                the 8 PUTs run again under the profiler.
  10. s3      — the port's server on the card over HTTP (see run_s3):
                cluster.start_single over 16 fresh drives at 12+4 with 1 MiB
                blocks on the edge transport; 16 concurrent signed PUTs of
                16 MiB (config 2 at half its streams, two rounds reported apart) and their GETs,
                a listing, ranged GETs, a HEAD, an aws-chunked PUT, a
                2 x 64 MiB + tail multipart upload, eight 4 MiB objects read
                by 8 clients at once with 3 drives' bucket gone (config 3's
                shape, cut) and a degraded 64 MiB GET, SSE-S3, SSE-C and
                multipart SSE objects read whole and in ranges by clients
                released at one barrier, a flipped ciphertext byte that
                fails before any plaintext, the PUT round under the
                profiler; launches equal the former's dispatches on the
                card (chacha20: the encrypted encode and decode ones plus
                its GET decipher ones); then `python3 -m minio_tpu_torch
                server` as a subprocess: ListBuckets, a 64 MiB PUT and GET,
                SIGTERM, exit 0.
  11. select  — S3 Select on the card over HTTP (see run_select): a
                fresh server as in phase 10 holding TPC-H lineitem as CSV
                (520,000 rows, ~64.6 MB, under the 64 MiB device cap); Q6's
                predicate with COUNT(*) and with a projection, a
                contains-LIKE over l_comment, eight clients at one barrier
                on 8,000-row objects (at the former's default window, where
                they must take fewer than 8 dispatches, and at 0.4 s), a 4
                MiB SSE-S3 object (chacha20 deciphers, then scan_eval
                scans), a declined SUM; every response equal to the host
                evaluator's framed stream (computed in worker processes
                meanwhile), scan_eval launches equal to the former's scan
                dispatches; Select walls, rows/s, MiB/s, stage seconds, a
                profiled COUNT round.
  12. compress — inline compression on the card over HTTP (see
                run_compress): a fresh server as in phase 10 with
                MINIO_COMPRESS=on; 16 concurrent 16 MiB lineitem CSV PUTs
                (config 2's shape over text, stored S2-framed), four 64 MiB
                CSV objects (also read with 3 drives' bucket gone), two
                compress + SSE-S3 64 MiB objects (chacha20 ciphers the
                compressed stream in the encode dispatch), a compressed
                8,000-row Select (scan_eval), zstd objects where
                `zstandard` imports; raw and stored bytes, ratios, PUT and
                GET GiB/s over client bytes, a profiled PUT round; fails
                without the native snappy codec.
  13. autoheal — the same server's background plane (see run_autoheal):
                one drive emptied while it runs, the disk monitor's timed
                scan_once formats it for its slot and sweep-heals the set
                on the card, file for file; two heal-scanner passes (full,
                then hinted by the update tracker) and one crawler pass,
                each reading every bucket it walks from the metacache's
                feed (no merge walk); a quota refused from the crawler's
                usage cache.
  14. namespace — the namespace plane (see run_namespace): a fresh server
                over 8 drives at 6+2 (on tmpfs where it has room, as
                bench.py --ab-list's pool) with the read cache on; 1,100
                keys in its shape (the bench's 10,000 cut for the run's
                time limit), seeded by worker processes, listed over
                HTTP from the persisted bucket index (a 600-key and a
                500-key segment: the segment size cut with the keys),
                page for page the merge walk's;
                the index persisted, 2 drives' copy removed, reloaded by a
                new boot and restored by the scanner's segment sweep; a
                lifecycle rule expiring 200 of 400 objects in one crawler
                pass; 64 MiB objects read degraded twice (decode, gf_matmul)
                and then from the cache (no decode), an SSE-S3 object's
                cache hit deciphered by chacha20, and a cached Select of
                the first 16 MiB of phase 11's lineitem (scan_eval).
  15. tier    — the tier plane on phase 14's node (see run_tier): an fs
                tier added through the node's TierManager; Transition
                (Days 1) on bucket hot (phase 14's two 64 MiB objects,
                its SSE-S3 object, the lineitem CSV, a new 4 x 16 MiB
                multipart object) and NoncurrentVersionTransition on a
                versioned key, due by the crawler's clock; one crawler
                pass, the node's worker moving every version through
                degraded reads (decode, gf_matmul), remote files equal to
                the stored streams; GET 403 InvalidObjectState, HEAD's
                storage class, the index's sizes, no cache hit; POST
                ?restore for every stub (the 64 MiB ones on the worker),
                GETs byte- and ETag-equal (chacha20 deciphers the SSE
                object, the multipart object keeps its parts and -4
                ETag), the Q6 COUNT over the restored lineitem
                (scan_eval); a reclaim pass back to stubs, a DELETE and a
                DeleteObjects freeing remote files, a stub's xl.meta
                healed with no dispatch; transition, restore and reclaim
                seconds, GiB/s, local bytes at each step.
  16. pools   — the pool plane (see run_pools), bench.py's
                bench_rebalance_ab at card-sized objects: two pools of 8
                drives at 6+2, 1 MiB blocks; about 0.95 GiB PUT over HTTP
                into pool 0 (twelve 64 MiB objects and one 12,345 B longer,
                32 of 2 MiB, an SSE-S3 object, a versioned key with a
                delete marker, a 4 x 16 MiB multipart session half
                uploaded), 2 of its drives' buckets removed, pool 1 added
                through node.add_pool; foreground PUT rounds timed before
                start_decommission(0) and during it (the rounds that had a
                move of the walker in flight for half their window or
                more); the session's next part migrates it; the drain
                completes, every object, version and marker reads back
                byte- and ETag-equal (chacha20 deciphers the SSE object),
                pool 0 is empty; decode / encode / host-routed dispatches,
                drain seconds and GiB/s over the window and over the
                walker's own move seconds, put_p99_degradation_x. Then
                fsck: six planted faults audited, repaired (a 64 MiB
                object's shards recovered on the card, file for file) and
                audited clean; a reboot under MINIO_TPU_FSCK_BOOT=on
                repairs the two planted in pool 0, misses the one planted
                in pool 1 (added after the boot's audit, as the CLI's
                --pool is), which a run_fsck then repairs; the re-armed
                drain moves nothing.
  17. fs      — the single-path FS backend (see run_fs): four 16 MiB
                objects and a 4 x 5 MiB multipart upload over signed HTTP,
                read back byte- and ETag-equal, listed, one deleted, first
                through cluster.start_fs in this process (no kernel
                launch counted), then through `python -m minio_tpu_torch
                server <one path>` as a subprocess (the card's memory in
                use does not rise; SIGTERM, exit 0); GiB/s up and down.
  18. distributed — four nodes of a distributed cluster in this process
                (see run_distributed): 4 x 4 drives on tmpfs, one 12+4
                set at the CLI's default 4 MiB blocks, internode storage,
                lock, peer and bootstrap RPC on each node's listener,
                dsync; over signed HTTP at 8 concurrent requests, four
                64 MiB PUTs, one 12,345 B longer and one of 1 KiB spread
                over the nodes, a 64 MiB SSE-S3 object, each read back
                through another node; every node's MRF queue drained
                (the quorum-ack lane's laggards), node 3 shut down, every
                object read
                degraded, four 64 MiB PUTs at write quorum; node 3
                rebooted and its shards healed by the peers' MRF queues;
                node 0 shut down and the loss objects read through node
                1; 4 rounds of same-key 16 MiB PUTs through nodes 0 and
                2 (one body whole, the 16 xl.meta agreeing once MRF
                drained); GiB/s,
                stage seconds, dispatches and internode RPC calls and
                bytes by verb per step. Then the CLI's `--node` boot as
                four subprocesses on the card: a 64 MiB PUT through node
                0, its GET through node 3, each process's card memory,
                SIGTERM, exit 0. After the boot, a user added through
                node 0's admin router signs a 16 MiB PUT through node 2,
                and one ?cluster=1 scrape through node 1 carries all four
                nodes; a trace?follow=1 stream opened on node 1 (its
                peers' subscriptions grafted in) receives a 16 MiB PUT
                served by node 2, and that PUT's kept span tree holds
                rpc.appendfile spans with the serving nodes' grafted
                rpc.server.appendfile fragments (trace_across_nodes).
  19. iam_admin — IAM, STS and the operator routers (see run_iam_admin):
                a fresh node with IAM on (16 drives at 12+4, 1 MiB
                blocks, tmpfs where it has room), driven through madmin
                over signed HTTP: 128 users, 32 custom policies, 8 groups
                of 16 members, 16 service accounts; 8 users' 64 MiB PUTs
                and GETs at once, a denied PUT, an AssumeRole
                credential's 64 MiB SSE-S3 object (and its refusal without
                the session token), an anonymous GET through a bucket
                policy, an allowed and a denied Q6 Select; the admin heal
                sequence over an emptied drive, `fsck --repair`, `tier
                ls` and `decommission --status` as subprocesses, health,
                two Prometheus scrapes, set-config / config-history /
                restore-config; a reboot on the same drives (iam.load()
                timed). Whether `cryptography` imports, and which
                AES-256-GCM sealed the config, on the phase's first line.
  20. obs     — the tracing plane (see run_obs): a fresh node as in
                phase 19; 2 rounds under each of three conditions,
                interleaved (A: the plane on; B: a live trace?follow=1
                subscriber through madmin.trace_follow, which gets every
                PUT of its round; C: the event journal and the SLO engine
                off), each round 8 signed 16 MiB PUTs at once; an audit
                webhook set through config KV at a loopback receiver gets
                one round's PUTs; p50/p99 per condition and B/A, A/C; the
                kept PUT trees hold engine.put_object with
                pipeline.encode and sched.dispatch, the dispatch with its
                sched.queue/transfer/compute/fetch children, each
                sched.compute the codec's CUDA-event
                compute span of its dispatch within 1 µs; GETs, degraded
                GETs (decode dispatches in their trees, MRF heals as
                mrf.enqueue/mrf.drain events), an SSE-S3 object
                (chacha20), a Q6 COUNT (scan.page, scan_eval); profiling
                (cpu, mem) around one more round; a drive.probation record
                captured into a bundle on drive 0 (seconds to the bundle),
                the SLO windows, the console's online line; a reboot whose
                journal replays the records from before it.
  21. gray    — the gray-failure plane (see run_gray), the reference
                bench's bench_gray_ab on the card's path: a fresh node as
                in phase 19 whose drive 0 is wrapped in a NaughtyDisk
                stalling 0.5 s on the bench's read and write verbs; an OFF
                pass (hedged reads, quorum-ack and quarantine off) and an
                ON pass (the bench's tightened knobs, the quarantine bar at
                twice the healthy p95), each 8 signed 16
                MiB PUTs over 4 clients, the MRF queue drained, 32 GETs
                over 4 clients; PUT and GET p50/p99 per pass and the p99
                speedups, stalls, hedges by trigger, laggards; the ON
                pass's hedged data shards decoded and its abandoned shard
                writes recovered on the card (decode and recover
                dispatches, gf_matmul and hh256 launches); the quarantine
                round trip suspect -> probation -> reconvict -> readmit
                through disk_monitor.scan_once and drivehealth's drive.*
                journal records; the drive disarmed, MRF drained, every
                object read back byte- and ETag-equal (lost_after_mrf 0).
                Runs under the lock-order watchdog (see Watchdog).
  22. admission — the admission plane (see run_admission), the reference
                bench's bench_tenants_ab on the card's path: a fresh
                16-drive 12+4 node with MINIO_TPU_EDGE_WORKERS=4 (one
                SO_REUSEPORT listener a loop), the gate at 8, two IAM
                users at equal QoS shares; a noisy tenant's 8 streams of
                16 MiB PUTs beside a polite tenant's 4 sequential PUTs with
                the plane off, then on (polite p50/p99, isolation_p99_x,
                the noisy tenant's sheds under reason=tenant, the polite
                tenant's: 0); one round of 8 lone-tenant PUTs a mode
                (put_p99_overhead_x, printed, not a verdict); each loop's
                accepts (all four above 0), the edge's counters, pool
                gauges and loop lag; an object-lock bucket with a default
                COMPLIANCE retention (a 16 MiB PUT, its version delete
                refused, a legal hold, a GOVERNANCE object deleted with the
                bypass header) and a 16 MiB post-policy upload; every
                acknowledged PUT read back, bytes and ETag; gf_matmul and
                hh256 launches and encode dispatches on the card.
  23. notify  — bucket event notification (see run_notify), the reference
                bench's bench_notify_ab on the card's path: a fresh
                16-drive 12+4 node, a webhook receiver in this process
                stalling 50 ms a POST, added with madmin; a warm round, 2
                rounds with no configuration and 2 wired to the webhook by
                a signed PUT ?notification, each 8 signed 16 MiB PUTs at
                once with no encode routed to the host (p50/p99 a mode,
                put_p99_degradation_x printed, not a verdict); every key of
                the wired rounds delivered, size and eTag the PUT's, the
                plane's pending, backlog and dropped 0, the delivery-lag
                histogram; a ListenBucketNotification subscriber hearing the
                last round; a DELETE, a delete marker, a multipart
                complete; an fs tier: a crawler pass transitions one object
                and expires another (s3:ObjectRemoved:Lifecycle through a
                config-KV notify_webhook), a restore over HTTP on the tier
                worker (s3:ObjectRestore:Post; the plane's stub and
                restored-copy records); the receiver down for 3 PUTs, the
                node rebooted, the durable backlog delivered after it;
                every PUT read back; gf_matmul and hh256 launches beside
                the encode dispatches.
  24. replicate — active-active replication (see run_replicate), the
                reference bench's bench_replicate_ab on the card's path:
                three fresh 16-drive 12+4 nodes in this process; 16
                versions of 16 MiB preloaded at A, a warm and a baseline
                round of 8 signed 16 MiB PUTs; A->B and B->A registered
                through madmin as wire targets, A's resync to B started,
                2 rounds while it runs (p50/p99 a mode,
                put_p99_degradation_x printed, not a verdict); A's and B's
                listings equal, B serving every preloaded and resync-time
                version's bytes and ETag, a PUT at B reaching A, no replica
                written in a further sync cycle, a marker replicated, each
                plane's pending, dropped and retry queue 0, the lag
                histogram and target_status(); 3 of A's drives offline to
                its set, C reseeded with cold-* through A's degraded GETs
                (decode on the card) and C's applies (encode on the card),
                equal to A's; the drives back and A's MRF drained; every
                node's dispatches by verb, none at or past the codec's gate
                on the host, beside the gf_matmul and hh256 launches.
  4. timings  — (continued) chacha20 at the encode launch (8 rows, 1 MiB
                span in 1,048,584-byte rows) and at GET's 64 x 65,536:
                CUDA events around back-to-back wrapper calls, the kernel's
                own device time (torch.profiler kernel durations over the
                same launches; fails without), the wrapper's host µs per
                call, beside its byte bound, its operation bound (all 992
                operations a block over the INT32 rate) and the two-pipe
                floor (its ALU-pipe operations over that rate; the bound
                is the larger of it and the byte bound), its plain version and chacha20_ref.xor_stream on the host over
                the same bytes, and its SASS summary (utils/sass.unrolled:
                fails if a 64-bit divide is left); sse_put_step against
                put_step at config 2's shape,
                and sse_put_step there and sse_get_step at a degraded-GET
                group (B=8, 3 data shards lost) beside the sum of their
                kernels' bounds and their plain composition on the card;
                scan_eval at Q6's launch (B = 254 pages of 2,048 rows, C = 3
                slots of width 16) and at phase 11's contains-LIKE launch
                (C = 1, W = 64): events ms, the kernel's own time (a CUDA
                graph's replay, the profiler), its byte bound, the sector
                floor of the row-major layout and its plain version on the
                card.

Phases run in the order 1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
16, 17, 18, 19, 20, 21, 22, 23, 4. Phases 3-20 run the gray-failure plane as a
server boots it (hedged reads, the PUT's quorum-ack lane, quarantine, all
on): a phase that takes drives away after its PUTs first drains its MRF
queue, or heals what the quorum-ack lane left behind where it has none, so
that every acknowledged write is on the drives it keeps; after each phase a
"plane" line gives the shard writes that lane abandoned, by stage, the
hedged reads, by trigger, and the write-stall grace and hedge deadline then.
Phase 21 runs the plane off and on.
Each path's launch counters are set to 0 just before it runs and read
just after. Then it prints the kernel table as one JSON line (with each kernel's launches on every path),
the card's name and power limit, and the device line last. It needs one
CUDA card and the repo's minio_tpu_torch package beside it; it imports
nothing of JAX or minio_tpu.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
# H100 SXM integer rate: 132 SMs x 64 INT32 lanes at the 1,980 MHz boost
# clock (Hopper architecture white paper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit operations of one HighwayHash packet round of one row: per state
# lane three u64 adds (2 each), two 32x32->64 products (2 each) and two
# u64 xors (2 each) = 14, x 4 lanes; four zipper merges of five byte
# permutes and two u64 adds (2 each) = 9 each
HH256_OPS_PER_ROUND = 4 * 14 + 4 * 9
# Hopper integer instructions one SHA-256 compression needs (not C
# operators: a three-way xor, Ch or Maj is one LOP3, and three-input adds
# are one IADD3). Per round (64): the two big sigmas are 3 funnel-shift
# rotates (SHF) and one LOP3 each, Ch and Maj one LOP3 each, t1 = h + S1
# + ch + K + W two IADD3, new a = t1 + S0 + maj one IADD3, new e = d + t1
# one IADD = 14. Per scheduled word (48): the two small sigmas are 2
# rotates, a shift (SHF) and one LOP3 each, the four-term sum two IADD3
# = 10. Then 8 state adds and 16 byte permutes (PRMT) of the big-endian
# loads. The built kernel issues more (utils/sass.block_loop reads it).
SHA256_OPS_PER_COMPRESSION = 64 * 14 + 48 * 10 + 8 + 16
# 32-bit operations of one ChaCha20 block of 64 bytes: 10 double rounds of
# 8 quarter rounds, each 4 adds, 4 xors and 4 rotates (byte permutes or
# funnel shifts, one instruction each) = 960, the 16 feed-forward adds and
# the 16 xors with the data
CHACHA20_OPS_PER_BLOCK = 10 * 8 * 12 + 16 + 16
# of those, the 320 round adds and 16 feed-forward adds may issue on the FMA
# pipe (as IMAD); the xors and rotates only on the integer ALU pipe, which
# has the same 64 lanes per SM: the two-pipe floor of a block is its ALU
# operations over the INT32 rate
CHACHA20_ADDS_PER_BLOCK = 10 * 8 * 4 + 16
CHACHA20_ALU_OPS_PER_BLOCK = CHACHA20_OPS_PER_BLOCK - CHACHA20_ADDS_PER_BLOCK
SEED = 20240601
# object sizes of phases 3, 5, 7 and 9
MAIN_OBJECT = 64 << 20              # eight of these, one 12,345 B longer
CONCURRENT = (32, 16 << 20)         # streams, bytes each (config 2)
MRF_OBJECTS = (4, 64 << 20)
CONFIG5 = (8, 2, 64 << 20)          # objects, parts each, bytes per part
#                                     (1 GiB, cut for the run's time)
SSE_OBJECTS = (8, 16 << 20)         # streams, bytes each (config 2, SSE;
                                    # a quarter of its 32, for the run's
                                    # time: the phase is host Poly1305)
SSE_PROFILED_STREAMS = 4            # of them PUT again under the profiler
# phase 10, the server over HTTP
S3_PUTS = (16, 16 << 20)            # streams, bytes each (config 2 at
#                                     half its 32 streams: phase 5 runs 32)
S3_DEGRADED = (8, 4 << 20)          # objects, bytes each (config 3, cut)
S3_BIG = 64 << 20                   # degraded GET past the gate; CLI object
S3_PARTS = (2, 64 << 20, 12345)     # full parts, bytes each, tail bytes
S3_SSE = (2, 16 << 20)              # SSE-S3 objects (and one SSE-C), bytes
S3_SSE_PARTS = (2, 5 << 20)         # SSE-S3 multipart: parts, bytes each
# phase 11, S3 Select over TPC-H lineitem (scripts/scan_cases.py)
SELECT_ROWS = 520_000               # ~64.6 MB, under the 64 MiB device cap
SELECT_CLIENTS = 8                  # concurrent Selects, one object each
SELECT_SMALL_ROWS = 8_000           # ~1 MiB, 4 pages: 8 x 4 = one batch
SELECT_SSE_ROWS = 33_700            # ~4 MiB SSE-S3 object
SELECT_WINDOW_S = 0.4               # the reference's coalescing test's
NS_SELECT_BYTES = 16 << 20          # phases 14-15's lineitem: the first
#                                     16 MiB of rows of phase 11's (each
#                                     Select pages it on the host: ~11 s
#                                     at 64.6 MB, for the run's time)
# phase 12, inline compression over HTTP (lineitem CSV, S2 framing)
COMPRESS_ROWS = 560_000             # one ~69 MB lineitem; objects rotate it
COMPRESS_PUTS = (16, 16 << 20)      # streams, bytes each (config 2's
#                                     shape at half its 32 streams)
COMPRESS_BIG = (4, 64 << 20)        # objects, bytes each
COMPRESS_SSE = (2, 64 << 20)        # compress + SSE-S3 objects, bytes each
#                                     (host Poly1305 again; 2 for the
#                                     run's time)
COMPRESS_SELECT_ROWS = 8_000        # ~1 MiB, 4 pages
# phase 13, the background plane on the same server
NS_KEYS = 1_100                     # bench.py --ab-list's 10,000, cut to fit
                                    # the run's time limit with phase 15
NS_SEGMENT_KEYS = 600               # the index's 5,000-key segments cut with
#                                     the keys, so that it still persists two
NS_VERSIONS_EVERY = 20              # an extra version every 20th key
NS_PAGE = 1000                      # keys a listing page
NS_LIFECYCLE = (400, 200)           # objects, of them under exp/
NS_CACHE = (2, 64 << 20)            # plain objects, bytes each
NS_SSE = 64 << 20                   # the SSE-S3 object
NS_WORKERS = 8                      # processes seeding and walking
TIER_PARTS = (4, 16 << 20)          # the multipart object: parts, bytes
TIER_VERSION_BYTES = 16 << 20       # each version of the versioned key
NS_SHM_MIN_BYTES = 4 << 30          # tmpfs room the phase's drives need
AUTOHEAL_DRIVE = 7                  # the drive emptied (not drive 0, which
#                                     holds the update tracker's file)
# phase 16, the pool plane (bench.py bench_rebalance_ab's two pools of 8
# drives at 6+2, 1 MiB blocks, at card-sized objects)
POOLS_BIG = (12, 64 << 20)          # objects (one more 12,345 B longer)
POOLS_SMALL = (32, 2 << 20)         # the bench's drain inventory (preload
#                                     32 of size // 2): below the 8 MiB gate
POOLS_SSE = 64 << 20                # the SSE-S3 object
POOLS_VERSION_BYTES = 2 << 20       # v1 and v2 of the versioned key
POOLS_PARTS = (4, 16 << 20)         # the multipart session: parts, bytes
POOLS_FOREGROUND = (8, 16 << 20)    # concurrent PUTs a round, bytes each
POOLS_DURING = (3, 24)              # rounds timed during the drain: those
#                                     that must each have a move in flight
#                                     for half their window or more, and
#                                     the most rounds tried for them
POOLS_GONE = (1, 5)                 # pool 0 drives whose buckets go
POOLS_MPU_GRACE_S = 3600.0          # the walker leaves the session to the
#                                     client, whose next part migrates it
POOLS_DRAIN_DEADLINE_S = 300
POOLS_SHM_MIN_BYTES = 6 << 30       # tmpfs room the phase's drives need
# phase 17, the single-path FS backend
FS_OBJECTS = (4, 16 << 20)          # objects, bytes each
FS_PARTS = (4, 5 << 20)             # one multipart upload: parts, bytes
FS_CONTEXT_MIB = 200                # a CUDA context's memory is far above
# phase 18, distributed nodes (upstream's docs/distributed/README.md
# `minio server http://host{1...4}/export{1...4}`: 4 nodes of 4 drives,
# one 12+4 set, the port CLI's default 4 MiB blocks)
DIST_NODES, DIST_DRIVES = 4, 4
DIST_OBJECTS = (4, 64 << 20)        # objects, bytes each; then one 12,345 B
#                                     longer and one of 1 KiB
DIST_SSE = 64 << 20                 # the SSE-S3 object
DIST_LOSS_PUTS = (4, 64 << 20)      # PUTs at quorum with node 3 down
DIST_LOCK = (4, 16 << 20)           # same-key rounds, bytes each PUT
DIST_CLIENTS = 8                    # concurrent signed requests
DIST_CLI_OBJECT = 64 << 20          # the CLI cluster's PUT and GET
DIST_SHM_MIN_BYTES = 4 << 30        # tmpfs room the phase's drives need
# phase 19, IAM and the operator routers (upstream's docs/multi-user and
# docs/sts guides' shapes over phase 10's node: 16 drives, 12+4, 1 MiB)
IAM_USERS = 128                     # cut, with the groups' members and the
#                                     service accounts, for the run's time
IAM_POLICIES = 32                   # each read-write on its own bucket
IAM_GROUPS = (8, 16)                # groups, members each
IAM_SVC = 16                        # service accounts
IAM_ADMIN_CLIENTS = 1               # admin mutations at once (4 at once
#                                     contend: PERF.md §6, PR 18)
IAM_TRAFFIC = (8, 64 << 20)         # users at once, one object each
IAM_SSE = 64 << 20                  # the STS credential's SSE-S3 object
IAM_DENIED = 16 << 20               # the PUT into a denied bucket
IAM_HEAL_DRIVE = 7                  # the drive whose buckets are emptied
IAM_SHM_MIN_BYTES = 4 << 30         # tmpfs room the phase's drives need
DIST_IAM_PUT = 16 << 20             # phase 18: the admin-made user's PUT
# phase 20, the tracing plane (the reference bench's bench_obs_ab and
# bench_incident_ab at phase 19's node: 16 drives, 12+4, 1 MiB blocks)
OBS_ROUNDS = 2                      # rounds per condition, A B C interleaved
#                                     (4 at first, cut for the run's time)
OBS_PUTS = (8, 16 << 20)            # clients, bytes each PUT (the codec's
#                                     8 MiB gate: every batch on the card)
OBS_DEGRADED = 4                    # GETs with 3 drives' bucket gone
OBS_SSE = 16 << 20                  # the SSE-S3 object
OBS_SLO_WINDOWS_S = "5,15"          # the default 60,300 s cut to the phase
OBS_SHM_MIN_BYTES = 4 << 30         # tmpfs room the phase's drives need
# phase 21, the gray-failure plane (the reference bench's bench_gray_ab on
# the card's path: 16 drives, 12+4, 1 MiB blocks, one drive stalling)
GRAY_OBJECTS = (8, 16 << 20)        # objects, bytes each (the codec's 8 MiB
#                                     gate: every group of 8 blocks of 1 MiB
#                                     decodes and recovers on the card)
GRAY_GETS = 32                      # GETs a pass, over GRAY_STREAMS
GRAY_STREAMS = 4                    # client threads a pass
GRAY_STALL_S = 0.5                  # the stalled drive's delay a verb
GRAY_QUAR_RATIO = "2"               # the ON pass's slow-drive bar over the
#                                     healthy p95 (the default 8 convicts
#                                     a 0.5 s drive only while that p95 is
#                                     under 62 ms)
GRAY_SHM_MIN_BYTES = 2 << 30        # tmpfs room the phase's drives need
# phase 22, the admission plane (the reference bench's bench_tenants_ab on
# the card's path: 16 drives, 12+4, 1 MiB blocks, four edge loops)
ADM_OBJECT = 16 << 20               # bytes each PUT (the bench's 1 MiB falls
#                                     under the codec's 8 MiB gate: host)
ADM_NOISY_STREAMS = 8               # the noisy tenant's concurrent PUTs
ADM_POLITE_OPS = 4                  # the polite tenant's sequential PUTs a
#                                     mode (the bench's 24, cut for the
#                                     phase's 40 s: on an H100 80GB HBM3
#                                     at 700 W the phase took 53.6 s at 8,
#                                     21.1 of them reading back 165 PUTs,
#                                     and 39.3 s at 5)
ADM_OVERHEAD_ROUNDS = 1             # lone-tenant rounds of 8 PUTs a mode
#                                     (the bench's 4, cut for the phase's
#                                     40 s: 2 rounds took 7.0 s and 32
#                                     read-backs of the 39.5 s phase on an
#                                     H100 80GB HBM3 at 700 W)
ADM_MAX_CLIENTS = 8                 # the admission gate (the bench's)
ADM_EDGE_WORKERS = 4                # edge loops, one SO_REUSEPORT listener
ADM_PAYLOADS = 4                    # distinct bodies the PUTs rotate
ADM_SHM_MIN_BYTES = 4 << 30         # tmpfs room the phase's drives need
# phase 23, bucket event notification (the reference bench's
# bench_notify_ab on the card's path: 16 drives, 12+4, 1 MiB blocks, a
# webhook stalling 50 ms a POST)
NOTIFY_OBJECT = 16 << 20            # bytes each PUT (the bench's 4 MiB falls
#                                     under the codec's 8 MiB gate: host)
NOTIFY_STREAMS = 8                  # concurrent PUTs a round (the bench's)
NOTIFY_BASE_ROUNDS = 2              # rounds with no configuration (bench)
NOTIFY_ON_ROUNDS = 2                # rounds wired to the webhook (bench)
NOTIFY_WEBHOOK_DELAY_S = 0.05       # the webhook's stall a POST (bench)
NOTIFY_OUTAGE_PUTS = 3              # PUTs while the receiver is down
NOTIFY_PAYLOADS = 4                 # distinct bodies the PUTs rotate
NOTIFY_SHM_MIN_BYTES = 4 << 30      # tmpfs room the phase's drives need
# phase 24, active-active replication (the reference bench's
# bench_replicate_ab on the card's path: 16 drives, 12+4, 1 MiB blocks)
REPL_OBJECT = 16 << 20              # bytes each version (the bench's 2 MiB
#                                     falls under the codec's 8 MiB gate)
REPL_PRELOAD = 16                   # cold-* versions of resync inventory
#                                     (the bench's 48 of 2 MiB)
REPL_STREAMS = 8                    # concurrent PUTs a round (the bench's)
REPL_BASE_ROUNDS = 1                # rounds before the pair (the bench's 2,
#                                     cut: the phase took 37.0 s at 2 on an
#                                     H100 80GB HBM3 at 700 W)
REPL_ON_ROUNDS = 2                  # rounds while A's resync runs
REPL_PAYLOADS = 4                   # distinct bodies the PUTs rotate
REPL_GONE = 3                       # A's drives taken offline for the
#                                     degraded reseed
REPL_SHM_MIN_BYTES = 6 << 30        # tmpfs room the three nodes' drives need
# the gray-failure plane's switches, all off: phase 21's OFF pass (every
# other phase runs the plane as a server boots it, on)
PLANE_OFF = {"MINIO_TPU_HEDGE": "off", "MINIO_TPU_QUORUM_ACK": "off",
             "MINIO_TPU_QUARANTINE": "off"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def card_memory_used_mib() -> int:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()
    return int(out[0])


T_START = time.perf_counter()


class PlaneWatch:
    """The gray-failure plane between two phases, read from this process's
    registry and tracker: the shard writes the PUT's quorum-ack lane
    abandoned (by stage), the spare shard reads raced (by trigger), and the
    write-stall grace and read-hedge deadline the tracker gives at the
    reading."""

    FAMILIES = {"laggards_by_stage": ("minio_tpu_write_laggards_total",
                                      "stage"),
                "hedges_by_trigger": ("minio_tpu_hedged_reads_total",
                                      "trigger")}

    def __init__(self):
        self.last = self.read()

    def read(self) -> dict:
        from minio_tpu_torch.utils import telemetry
        out = {}
        for name, (family, label) in self.FAMILIES.items():
            series = telemetry.REGISTRY.counter(family).series()
            out[name] = {dict(key).get(label, ""): v
                         for key, v in series.items()}
        return out

    def emit(self, after: str, card: str) -> dict:
        from minio_tpu_torch.utils import healthtrack
        now = self.read()
        delta = {name: {lab: v - self.last[name].get(lab, 0)
                        for lab, v in now[name].items()
                        if v != self.last[name].get(lab, 0)}
                 for name in now}
        self.last = now
        out = {"phase": "plane", "after": after, **delta,
               "write_stall_s": healthtrack.write_stall_s(),
               "read_hedge_s": healthtrack.read_hedge_s(), "card": card}
        emit(out)
        return out


class Watchdog:
    """The lock-order watchdog (minio_tpu_torch/utils/lockcheck.py) on, in
    raise mode (MINIO_TPU_LOCKCHECK_RAISE's default), around one phase;
    off in every other phase, as a served path runs it. After the phase
    it prints {"phase": "lockcheck", "after": <phase>, "lockcheck":
    {"roles": the roles taken, "edges": the nested orders recorded,
    "cycles", "held_while_blocking", "long_hold": violations by kind},
    "seconds": the phase's wall time}. A cycle fails the run;
    held-while-blocking and long holds are recorded only, as in the
    reference's suites, their details on stderr."""

    def __init__(self, phase: str, card: str):
        self.phase, self.card = phase, card

    def __enter__(self) -> "Watchdog":
        from minio_tpu_torch.utils import lockcheck
        self.saved = os.environ.get("MINIO_TPU_LOCKCHECK")
        os.environ["MINIO_TPU_LOCKCHECK"] = "on"
        lockcheck.refresh()
        lockcheck.reset()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        from minio_tpu_torch.utils import lockcheck
        seconds = time.perf_counter() - self.t0
        found, graph, roles = (lockcheck.violations(), lockcheck.graph(),
                               lockcheck.roles())
        if self.saved is None:
            os.environ.pop("MINIO_TPU_LOCKCHECK", None)
        else:
            os.environ["MINIO_TPU_LOCKCHECK"] = self.saved
        lockcheck.refresh()
        lockcheck.reset()
        by_kind = {kind: [v for v in found if v.kind == kind]
                   for kind in ("cycle", "held-while-blocking", "long-hold")}
        for v in found:
            print(f"[lockcheck {self.phase}] {v.kind}: {v.detail}",
                  file=sys.stderr, flush=True)
        emit({"phase": "lockcheck", "after": self.phase, "lockcheck": {
            "roles": roles, "edges": sum(len(d) for d in graph.values()),
            "cycles": len(by_kind["cycle"]),
            "held_while_blocking": len(by_kind["held-while-blocking"]),
            "long_hold": len(by_kind["long-hold"])},
            "seconds": round(seconds, 3), "card": self.card})
        if by_kind["cycle"]:
            fail(f"{self.phase}: lock-order cycle(s): "
                 + "; ".join(v.detail for v in by_kind["cycle"]))


def heal_left_behind(eng, left: list) -> dict:
    """Heal, through the set's heal_object, each object whose PUT the
    quorum-ack lane acknowledged with a drive left behind (`left`, fed by
    the engine's on_degraded_write hook, which a server's MRF queue takes
    instead): a phase that takes drives away next reads every acknowledged
    object from the drives it keeps, as a server's does after its MRF
    queue drained. An object with nothing missing heals without a
    dispatch."""
    names = list(dict.fromkeys(left))
    healed = sum(eng.heal_object(b, o, v).disks_healed for b, o, v in names)
    return {"objects": len(names), "drives_healed": healed}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)
    if "phase" in obj:
        print(f"[{time.perf_counter() - T_START:.1f} s] phase "
              f"{obj['phase']} emitted (threads "
              f"{threading.active_count()})", file=sys.stderr, flush=True)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "minio_tpu_torch", "csrc")):
        fail("minio_tpu_torch/ is not beside chip_smoke.py")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    from minio_tpu_torch.ops import (chacha20_cuda, chacha20_plain,
                                     chacha20_ref, highwayhash_cuda,
                                     highwayhash_py, kernels, rs_cuda,
                                     rs_matrix, scan_cuda, sha256_cuda,
                                     sha256_ref)
    from minio_tpu_torch.bitrot import MAGIC_HIGHWAYHASH_KEY as KEY
    from minio_tpu_torch.models import pipeline
    from minio_tpu_torch.utils import guard_pages, sass

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand_u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    def max_err(a, b) -> int:
        if a.shape != b.shape:
            fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel() == 0:
            return 0
        return int((a.to(torch.int16) - b.to(torch.int16)).abs().max())

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build_s = kernels.build()
    emit({"phase": "build", "seconds": round(build_s, 3),
          "wall_s": round(time.perf_counter() - t0, 3),
          "ptxas": {n: [ln for ln in kernels.BUILD_LOG.get(n, "").splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n in kernels.SOURCES},
          # registers, stack frame and spill bytes of each instantiation
          "scan_eval_ptxas": kernels.ptxas_report(
              kernels.BUILD_LOG.get("scan_eval", ""))})

    # -- 2. each kernel against its plain version --------------------------
    t0 = time.perf_counter()
    took = {}                           # seconds of each kernel's checks
    k, m = 12, 4
    n = k + m
    # the plain versions over the longest rows (hh256 at the main path's
    # 349,526 B, sha256 at config 5's 65,536 B) take seconds of host time
    # each: they run in worker processes while the card checks the rest
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    plain_pool = ProcessPoolExecutor(
        4, mp_context=multiprocessing.get_context("spawn"))
    hh_long = {"strided": rand_u8(4, 349526 + 64),
               "main": rand_u8(8 * (k + m), 349526)}
    sha_rows = rand_u8(640, 65536)
    long_plain = {
        **{n_: plain_pool.submit(host_plain, "hh256", r.cpu().numpy(),
                                 349526) for n_, r in hh_long.items()},
        **{f"sha256 {ln}": plain_pool.submit(host_plain, "sha256",
                                             sha_rows.cpu().numpy(), ln)
           for ln in (65535, 65536)}}

    def long_result(name):
        """(digests as a CPU tensor, ms of the plain call)."""
        digests, ms = long_plain[name].result()
        return torch.from_numpy(digests), ms
    lost = [1, 5, 14]                               # two data, one parity
    mask = sum(1 << i for i in range(n) if i not in lost)
    mats = {"parity": rs_matrix.parity_matrix(k, m),
            "decode3": rs_matrix.missing_data_matrix(k, m, mask)[0],
            "recover3": rs_matrix.recover_matrix(k, m, mask)[0]}
    gf_err, gf_cases = 0, 0

    def check_gf(what, m2, x, out_at=None):
        """Kernel == plain version (tolerance 0). With out_at = (flat, o),
        the C entry point writes into flat[o:] and the bytes around its
        output must stay as they were."""
        nonlocal gf_err, gf_cases
        if out_at is None:
            got = rs_cuda.gf_matmul(m2, x)
        else:
            flat, o = out_at
            b, r, s = x.shape[0], m2.shape[0] // 8, x.shape[-1]
            end = o + b * r * s
            before = flat.clone()
            got = flat[o:end].view(b, r, s)
            kernels.check(rs_cuda._launcher()(
                m2.data_ptr(), x.data_ptr(), got.data_ptr(), b, r,
                m2.shape[1] // 8, s, torch.cuda.current_stream().cuda_stream),
                "gf_matmul_launch")
        torch.cuda.synchronize()
        if out_at is not None and not (
                torch.equal(flat[:o], before[:o])
                and torch.equal(flat[end:], before[end:])):
            fail(f"gf_matmul {what}: wrote outside its output")
        err = max_err(got, rs_cuda.gf_matmul_plain(m2, x))
        if err:
            fail(f"gf_matmul {what}: max abs err {err}")
        gf_err = max(gf_err, err)
        gf_cases += 1

    # GF matrices at ragged widths; the main path's own launch shape
    # (batches of 8 blocks of 4 MiB, S = 349,526) three times for the
    # parity matrix, since a store race at a tile edge shows only sometimes
    for name, mat in mats.items():
        m2 = rs_cuda.matrix_bits(mat, dev)
        for s in (0, 1, 2, 3, 5, 15, 16, 17, 31, 33, 4095, 4097, 16384,
                  87382, 100003, 349526):
            check_gf(f"{name} B=2 S={s}", m2, rand_u8(2, k, s))
        x = rand_u8(8, k, 349526)
        for _ in range(3 if name == "parity" else 1):
            check_gf(f"{name} B=8 S=349526", m2, x)
    # random 0/1 matrices, which are not GF expansions, at every (r, k)
    for r in (1, 2, 3, 4, 5, 8, 12, 16):
        for kk in (1, 3, 12, 16):
            m2 = torch.randint(0, 2, (8 * r, 8 * kk), dtype=torch.uint8,
                               device=dev, generator=gen)
            for s in (33, 4097):
                check_gf(f"random {r}x{kk} S={s}", m2, rand_u8(2, kk, s))
    # input and output starting at every byte offset mod 16
    m2 = rs_cuda.matrix_bits(mats["parity"], dev)
    for base in range(1, 16):
        x = rand_u8(base + 3 * k * 4097)[base:].view(3, k, 4097)
        check_gf(f"input at offset {base}", m2, x)
        o = (3 * base) % 16
        check_gf(f"input at {base}, output at {o}", m2, x,
                 (rand_u8(o + 3 * m * 4097 + 16), o))
    # input and output at each end of a mapping between unmapped ranges: a
    # read of a word without an input byte, or a store past the output,
    # stops the kernel with an illegal-address error
    for b, s in ((2, 17), (2, 4097), (8, 349526)):
        n_in, n_out = b * k * s, b * m * s
        with guard_pages.guarded(n_in, dev) as src, \
                guard_pages.guarded(n_out, dev) as dst:
            for at, x in (("start", src[:n_in]), ("end", src[-n_in:])):
                x = x.view(b, k, s)
                x.copy_(rand_u8(b, k, s))
                for o in (0, dst.numel() - n_out):
                    check_gf(f"B={b} S={s} input at the {at} of a mapping, "
                             f"output at {o}", m2, x, (dst, o))
    hh_err, hh_cases = 0, 0

    def check_hh(what, rows, length, plain=None):
        """Kernel == plain version on every row (tolerance 0) and == the
        scalar HighwayHash on the last row, which may end the tensor. The
        plain version runs on a CPU copy of the rows: the same function on
        the same bytes, ~4x faster there than one launch per operation."""
        nonlocal hh_err, hh_cases
        got = highwayhash_cuda.hh256(rows, length, KEY)
        torch.cuda.synchronize()
        if plain is None:
            plain = highwayhash_cuda.hh256_plain(rows.cpu(), length, KEY)
        err = max_err(got.cpu(), plain)
        h = highwayhash_py.HighwayHash(KEY)
        h.update(rows[-1, :length].cpu().numpy().tobytes())
        if err or got[-1].cpu().numpy().tobytes() != h.digest256():
            fail(f"hh256 {what}: kernel disagrees (max abs err {err})")
        hh_err = max(hh_err, err)
        hh_cases += 1

    for length in range(65):
        check_hh(f"length {length}", rand_u8(16, length + 7), length)
    # row starts at every offset mod 16 (1031 = 7 mod 16); at length ==
    # row_stride the last row ends the tensor
    rows = rand_u8(16, 1031)
    for length in (1031, 1030, 1014):
        check_hh(f"16 rows of 1031, length {length}", rows, length)
    flat = rand_u8(16 + 9 * 1031)
    for base in range(1, 16):
        check_hh(f"view from byte {base}",
                 flat[base:base + 9 * 1031].view(9, 1031), 1031)
    check_hh("sliced view made contiguous",
             rand_u8(9, 1040)[:, 5:].contiguous(), 1035)
    # around each ring chunk size tried (512 B is the one built)
    for chunk in (256, 512, 1024, 2048):
        for length in (chunk - 31, chunk - 1, chunk, chunk + 1, chunk + 31):
            check_hh(f"length {length}", rand_u8(5, length + 3), length)
    # row counts off the rows-per-warp grid; 1100 packs 3 rows per warp,
    # 9000 packs 16 and needs more than 48 KB of shared memory per block
    for n_rows in (1, 2, 15, 17, 33, 96, 128, 512, 1100, 9000):
        check_hh(f"{n_rows} rows of 1031", rand_u8(n_rows, 1031), 1031)
    check_hh("349526 in rows of 349590", hh_long["strided"], 349526,
             long_result("strided")[0])
    # the main path's launch shapes: 8 blocks x (12 + 4) rows in a PUT,
    # 8 x 12 survivor rows in a degraded GET, 8 x (12 + r) in a heal with
    # r shards lost. S = 349,526 = 6 mod 16 puts rows at every even
    # offset, and the 128-row tensor's last row ends the allocation.
    rows = hh_long["main"]
    plain = long_result("main")[0]
    for r in range(m + 1):
        check_hh(f"{8 * (k + r)} rows of 349526", rows[:8 * (k + r)], 349526,
                 plain[:8 * (k + r)])
    # the same rows at each end of a mapping between unmapped ranges
    with guard_pages.guarded(rows.numel(), dev) as buf:
        for at, g in (("start", buf[:rows.numel()]),
                      ("end", buf[-rows.numel():])):
            g = g.view_as(rows)
            g.copy_(rows)
            check_hh(f"{len(rows)} rows of 349526 at the {at} of a mapping",
                     g, 349526, plain)
    # gf_matmul at config 5's shapes (k = 16: wider tiles than k = 12, a
    # larger shared-memory opt-in): encode of a full dispatch and the
    # degraded GET's decodes with 1 and 4 data shards lost
    k5, m5, s5 = 16, 4, 65536
    full5 = (1 << (k5 + m5)) - 1
    m2 = rs_cuda.matrix_bits(rs_matrix.parity_matrix(k5, m5), dev)
    check_gf("config 5 encode B=32 4x16 S=65536", m2,
             rand_u8(32, k5, s5))
    for lost in ((3,), (0, 5, 9, 15)):
        mask = full5 & ~sum(1 << i for i in lost)
        m2 = rs_cuda.matrix_bits(rs_matrix.missing_data_matrix(
            k5, m5, mask)[0], dev)
        check_gf(f"config 5 decode r={len(lost)} B=8", m2,
                 rand_u8(8, k5, s5))
    took["gf_matmul+hh256"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    sha_err, sha_cases = check_sha256(
        torch, dev, rand_u8, max_err, sha256_cuda, sha256_ref, guard_pages,
        sha_rows, {ln: long_result(f"sha256 {ln}") for ln in (65535, 65536)})
    took["sha256"] = time.perf_counter() - t1
    plain_pool.shutdown()
    t1 = time.perf_counter()
    cc_err, cc_cases = check_chacha20(torch, dev, rand_u8, max_err,
                                      chacha20_cuda, chacha20_plain,
                                      chacha20_ref, guard_pages, np)
    sse_err = check_sse_steps(torch, dev, rand_u8, max_err, pipeline,
                              rs_cuda, rs_matrix, chacha20_cuda, np)
    took["chacha20+sse_steps"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    scan_err, scan_cases_n, scan_cov = check_scan(torch, dev, np,
                                                  guard_pages)
    took["scan_eval"] = time.perf_counter() - t1
    emit({"phase": "kernels", "gf_matmul_max_abs_err": gf_err,
          "gf_matmul_cases": gf_cases,
          "hh256_max_abs_err": hh_err, "hh256_cases": hh_cases,
          "sha256_max_abs_err": sha_err, "sha256_cases": sha_cases,
          "chacha20_max_abs_err": cc_err, "chacha20_cases": cc_cases,
          "sse_steps_max_abs_err": sse_err,
          "scan_eval_max_abs_err": scan_err,
          "scan_eval_cases": scan_cases_n, "scan_eval_coverage": scan_cov,
          "tolerance": 0,
          "long_plain_ms": {n_: round(f.result()[1], 1)
                            for n_, f in long_plain.items()},
          "seconds_by_check": {n_: round(v, 3) for n_, v in took.items()},
          "seconds": round(time.perf_counter() - t0, 3), "card": card})

    # -- 3. the main path; 5-7. concurrent PUT, heal, MRF ------------------
    from minio_tpu_torch.object import engine as eng_mod
    from minio_tpu_torch.parallel.scheduler import BatchScheduler
    from minio_tpu_torch.storage.datatypes import hash_order
    from minio_tpu_torch.utils import stagetimer
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    counts = LaunchCounts(rs_cuda, highwayhash_cuda, sha256_cuda,
                          chacha20_cuda, scan_cuda)
    plane = PlaneWatch()
    try:
        main_path, state = run_main_path(eng_mod, hash_order, tmp, card,
                                         counts, stagetimer, np)
        plane.emit("main_path", card)
        # one batch former for phases 5-7, closed only after them: a
        # closed former would send its waiters to the host
        sched = BatchScheduler()
        try:
            with Watchdog("concurrent_put", card):
                concurrent = run_concurrent_put(eng_mod, sched, stagetimer,
                                                tmp, card, counts, np)
            plane.emit("concurrent_put", card)
            heal = run_heal(sched, state, tmp, card, counts, np)
            plane.emit("heal", card)
            mrf = run_mrf(sched, tmp, card, counts, np)
            plane.emit("mrf", card)
        finally:
            sched.close()
        # -- 8. config 5: its own former, shared by both pools -----------
        shutil.rmtree(os.path.join(tmp, "concurrent"), ignore_errors=True)
        config5 = run_config5(tmp, card, counts, stagetimer, np)
        plane.emit("config5", card)
        # -- 9. config 2 under SSE: its own former ------------------------
        ssep = run_sse(tmp, card, counts, stagetimer, np)
        plane.emit("sse", card)
        # -- 10. the server over HTTP: its own boot, former and drives ----
        s3p = run_s3(tmp, card, counts, stagetimer, np)
        plane.emit("s3", card)
        # -- 11. S3 Select over HTTP: its own boot, former and drives -----
        selp, lineitem, head, head_q6 = run_select(tmp, card, counts,
                                                   stagetimer, np)
        plane.emit("select", card)
        # -- 12. compression over HTTP; 13. the background plane on the
        # same server ------------------------------------------------------
        compp, node, cstate = run_compress(tmp, card, counts, stagetimer,
                                           np)
        plane.emit("compress", card)
        try:
            autop = run_autoheal(node, cstate, card, counts)
        finally:
            node.shutdown()
        plane.emit("autoheal", card)
        shutil.rmtree(os.path.join(tmp, "compress"), ignore_errors=True)
        # -- 14. the namespace plane: its own boot, former and drives;
        # 15. the tier plane on the same node ------------------------------
        nsp, node, nstate = run_namespace(tmp, card, counts, np, head,
                                          head_q6)
        plane.emit("namespace", card)
        try:
            tierp = run_tier(node, nstate, card, counts, np, head,
                             head_q6)
        finally:
            node.shutdown()
            end_namespace(nstate)
        plane.emit("tier", card)
        # -- 16. the pool plane: its own boot, pools and drives; 17. the
        # single-path FS backend as a subprocess ----------------------------
        poolsp = run_pools(tmp, card, counts, np)
        plane.emit("pools", card)
        fsp = run_fs(tmp, card, counts, np)
        plane.emit("fs", card)
        # -- 18. distributed nodes: four in this process, then the CLI's
        # --node boot as four subprocesses ------------------------------
        distp = run_distributed(tmp, card, counts, stagetimer, np)
        plane.emit("distributed", card)
        # -- 19. IAM, STS and the operator routers: its own boot ----------
        iamp = run_iam_admin(tmp, card, counts, stagetimer, np, head,
                             head_q6)
        plane.emit("iam_admin", card)
        # -- 20. the tracing plane: its own boot ---------------------------
        obsp = run_obs(tmp, card, counts, stagetimer, np, head, head_q6)
        plane.emit("obs", card)
        # -- 21. the gray-failure plane: its own boot ------------------------
        with Watchdog("gray", card):
            grayp = run_gray(tmp, card, counts, np)
        # -- 22. the admission plane: its own boot, four edge loops -----
        admp = run_admission(tmp, card, counts, np)
        # -- 23. bucket event notification: its own boot, a slow webhook
        ntfp = run_notify(tmp, card, counts, np)
        # -- 24. active-active replication: three boots of its own
        replp = run_replicate(tmp, card, counts, np)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths_launches = {"main_path": main_path["launches"],
                      "concurrent_put": concurrent["launches"],
                      "heal": heal["launches"], "mrf": mrf["launches"],
                      "config5": config5["launches"],
                      "sse": ssep["launches"], "s3": s3p["launches"],
                      "select": selp["launches"],
                      "compress": compp["launches"],
                      "autoheal": autop["launches"],
                      "namespace": nsp["launches"],
                      "tier": tierp["launches"],
                      "pools": poolsp["launches"],
                      "fs": fsp["launches"],
                      "distributed": distp["launches"],
                      "iam_admin": iamp["launches"],
                      "obs": obsp["launches"],
                      "gray": grayp["launches"],
                      "admission": admp["launches"],
                      "notify": ntfp["launches"],
                      "replicate": replp["launches"]}

    # -- 4. timings -------------------------------------------------------
    b, s = 32, -(-(1 << 20) // k)
    timing = run_timings(torch, dev, rand_u8, max_err, pipeline, rs_cuda,
                         highwayhash_cuda, rs_matrix, kernels, sass, KEY, b,
                         k, m, s)
    timing.update(run_config5_timings(
        torch, dev, rand_u8, max_err, rs_cuda, rs_matrix, sha256_cuda,
        kernels, sass, timing["sm_clock_mhz"], sha_rows,
        long_result("sha256 65536")))
    timing.update(run_sse_timings(torch, dev, rand_u8, max_err, pipeline,
                                  chacha20_cuda, chacha20_plain,
                                  chacha20_ref, rs_cuda, rs_matrix,
                                  highwayhash_cuda, kernels, sass, KEY, np))
    timing.update(run_scan_timings(torch, dev, np, lineitem))
    timing.update({"phase": "timings", "B": b, "k": k, "m": m, "S": s,
                   "card": card})
    emit(timing)

    def bound_by(t, name):
        return "bytes" if t[f"{name}_byte_bound_ms"] >= \
            t[f"{name}_op_bound_ms"] else "operations"

    emit({"kernels": [
        {"name": "gf_matmul", "route": "cuda",
         "source": "minio_tpu_torch/csrc/gf_matmul.cu",
         "replaces": "minio_tpu/ops/rs_pallas.py:52",
         "launches": main_path["gf_matmul_launches"],
         "launches_by_path": {p: n["gf_matmul"]
                              for p, n in paths_launches.items()},
         "max_abs_err": max(gf_err, timing["gf_matmul_max_abs_err"]),
         "ms": timing["gf_matmul_ms"], "plain_ms": timing["gf_plain_ms"],
         "plain_on": "card",
         "bound_ms": timing["gf_matmul_bound_ms"],
         "bound_by": bound_by(timing, "gf_matmul"), "library_ms": None},
        {"name": "hh256", "route": "cuda",
         "source": "minio_tpu_torch/csrc/hh256.cu",
         "replaces": "minio_tpu/ops/highwayhash_jax.py:336",
         "launches": main_path["hh256_launches"],
         "launches_by_path": {p: n["hh256"]
                              for p, n in paths_launches.items()},
         "max_abs_err": max(hh_err, timing["hh256_max_abs_err"]),
         "ms": timing["hh256_ms"], "plain_ms": timing["hh_plain_ms"],
         "plain_on": timing["hh_plain_on"],
         "bound_ms": timing["hh256_bound_ms"],
         "bound_by": bound_by(timing, "hh256"), "library_ms": None},
        {"name": "sha256", "route": "cuda",
         "source": "minio_tpu_torch/csrc/sha256.cu",
         "replaces": "minio_tpu/ops/sha256_jax.py:127",
         "launches": config5["launches"]["sha256"],
         "launches_by_path": {p: n["sha256"]
                              for p, n in paths_launches.items()},
         "max_abs_err": max(sha_err, timing["sha256_max_abs_err"]),
         "ms": timing["sha256_ms"], "plain_ms": timing["sha256_plain_ms"],
         "plain_on": timing["sha256_plain_on"],
         "bound_ms": timing["sha256_bound_ms"],
         "bound_by": bound_by(timing, "sha256"), "library_ms": None,
         "hashlib_host_ms": timing["sha256_hashlib_ms"],
         "chain_floor_ms": timing["sha256_chain_floor_ms"]},
        {"name": "chacha20", "route": "cuda",
         "source": "minio_tpu_torch/csrc/chacha20.cu",
         "replaces": "minio_tpu/ops/chacha20_jax.py:50",
         "launches": ssep["launches"]["chacha20"],
         "launches_by_path": {p: n["chacha20"]
                              for p, n in paths_launches.items()},
         "launches_by_sse_subpath": {
             p: n["chacha20"]
             for p, n in ssep["launches_by_subpath"].items()},
         "max_abs_err": max(cc_err, sse_err,
                            timing["chacha20_encode"]["max_abs_err"],
                            timing["chacha20_get"]["max_abs_err"]),
         # "ms": CUDA events around back-to-back calls, as for the other
         # kernels (here the wrapper's host rate, above the kernel's time);
         # "device_ms": the kernel's own (torch.profiler durations, None
         # when the profiler kept no record), "device_graph_ms": the
         # replay of a CUDA graph of the same calls
         "ms": timing["chacha20_encode"]["ms"],
         "plain_ms": timing["chacha20_encode"]["plain_ms"],
         "plain_on": "card",
         # the larger of the byte bound and the two-pipe floor; op_bound_ms
         # puts all 992 operations a block on one pipe
         "bound_ms": timing["chacha20_encode"]["bound_ms"],
         "bound_by": timing["chacha20_encode"]["bound_by"],
         "bound_pipe": "ALU",
         "library_ms": None,
         "device_ms": timing["chacha20_encode"]["device_ms"],
         "device_graph_ms": timing["chacha20_encode"]["device_graph_ms"],
         "wrapper_host_us": timing["chacha20_encode"]["wrapper_host_us"],
         "op_bound_ms": timing["chacha20_encode"]["op_bound_ms"],
         "two_pipe_floor_ms": timing["chacha20_encode"]["two_pipe_floor_ms"],
         "get_batch_ms": timing["chacha20_get"]["ms"],
         "get_batch_device_ms": timing["chacha20_get"]["device_ms"],
         "get_batch_device_graph_ms":
             timing["chacha20_get"]["device_graph_ms"],
         "get_batch_wrapper_host_us":
             timing["chacha20_get"]["wrapper_host_us"],
         "get_batch_bound_ms": timing["chacha20_get"]["bound_ms"],
         "get_batch_op_bound_ms": timing["chacha20_get"]["op_bound_ms"],
         "get_batch_two_pipe_floor_ms":
             timing["chacha20_get"]["two_pipe_floor_ms"],
         "host_xor_stream_ms": timing["chacha20_encode"][
             "host_xor_stream_ms"]},
        {"name": "scan_eval", "route": "cuda",
         "source": "minio_tpu_torch/csrc/scan_eval.cu",
         "replaces": "minio_tpu/scan/kernels.py:244",
         "launches": selp["launches"]["scan_eval"],
         "launches_by_path": {p: n["scan_eval"]
                              for p, n in paths_launches.items()},
         "max_abs_err": max(scan_err, timing["scan_eval_q6"]["max_abs_err"],
                            timing["scan_eval_like"]["max_abs_err"]),
         # "ms": CUDA events around back-to-back calls at Q6's launch
         # (B = 254, C = 3, W = 16); device_ms / device_graph_ms the
         # kernel's own time (profiler, a CUDA graph's replay);
         # sector_floor_ms the 32-byte sectors holding the bytes bound_ms
         # counts; like_*: the same at phase 11's contains-LIKE launch
         "ms": timing["scan_eval_q6"]["ms"],
         "plain_ms": timing["scan_eval_q6"]["plain_ms"],
         "plain_on": "card",
         "bound_ms": timing["scan_eval_q6"]["bound_ms"],
         "bound_by": timing["scan_eval_q6"]["bound_by"],
         "library_ms": None,
         "sector_floor_ms": timing["scan_eval_q6"]["sector_floor_ms"],
         "device_ms": timing["scan_eval_q6"]["device_ms"],
         "device_graph_ms": timing["scan_eval_q6"]["device_graph_ms"],
         "wrapper_host_us": timing["scan_eval_q6"]["wrapper_host_us"],
         **{f"like_{k}": timing["scan_eval_like"][k]
            for k in ("ms", "device_ms", "device_graph_ms", "plain_ms",
                      "bound_ms", "sector_floor_ms")}}]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def host_plain(kind: str, rows, length: int) -> tuple:
    """hh256's or sha256's plain version over uint8 rows (a numpy array)
    on the host, in a worker process: (the digests as a numpy array, ms of
    the call)."""
    sys.path.insert(0, HERE)
    import torch
    from minio_tpu_torch.bitrot import MAGIC_HIGHWAYHASH_KEY
    from minio_tpu_torch.ops import highwayhash_cuda, sha256_ref
    torch.set_num_threads(2)            # four of these share the host
    x = torch.from_numpy(rows)
    t0 = time.perf_counter()
    if kind == "sha256":
        got = sha256_ref.sha256_rows(x, length)
    else:
        got = highwayhash_cuda.hh256_plain(x, length, MAGIC_HIGHWAYHASH_KEY)
    return got.numpy(), (time.perf_counter() - t0) * 1e3


def check_scan(torch, dev, np, guard_pages) -> tuple[int, int, dict]:
    """scan_eval against its plain version on the card, tolerance 0 on the
    mask and the COUNT sums: the seeded port of tests/test_scan.py's query
    generator (scripts/scan_cases.py, with literals longer than the page
    width and nan / inf / -0 / 1e400 / subnormal cells) over CSV and
    JSON-Lines corpora at every width bucket 8-128; fixed predicates over
    every node kind (scan_cases.ORACLE_WHERE), whose masks must also equal
    the host evaluator's WHERE decision row by row; B = 1, 3, 64 and 254
    pages with a ragged last page; packed pages (the former's batch) with
    inputs and outputs at each end of a guarded mapping; and the query
    one FMA contraction would flip."""
    from minio_tpu_torch.ops import scan_cuda, scan_plain, scan_program
    from minio_tpu_torch.s3select import sql
    from minio_tpu_torch.scan import pager
    from minio_tpu_torch.scan.plan import compile_plan
    from minio_tpu_torch.scripts import scan_cases as sc
    stats = {"queries": 0, "evaluator_checked": 0, "widths": set(),
             "kinds": set(), "batches": set()}
    err_max = 0

    def on_dev(arrays):
        return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

    def err_of(got, want) -> int:
        if got.shape != want.shape:
            fail(f"scan_eval: shape {tuple(got.shape)} != "
                 f"{tuple(want.shape)}")
        if got.numel() == 0:
            return 0
        return int((got.long() - want.long()).abs().max())

    def check(what, program, arrs, outs=None):
        nonlocal err_max
        before = scan_cuda.scan_eval.launches
        mask, counts = scan_cuda.scan_eval(program, **arrs) if outs is None \
            else scan_cuda.scan_eval(program, mask=outs[0], counts=outs[1],
                                     **arrs)
        torch.cuda.synchronize()
        if scan_cuda.scan_eval.launches != before + 1:
            fail(f"scan_eval {what}: the wrapper did not count its launch")
        pm, pc = scan_plain.scan_eval(program.prog, program.cspec, **arrs)
        err = max(err_of(mask, pm), err_of(counts, pc))
        if err:
            fail(f"scan_eval {what}: kernel disagrees with the plain "
                 f"version (max abs err {err})")
        err_max = max(err_max, err)
        stats["queries"] += 1
        stats["kinds"] |= sc.node_kinds(program.prog)
        return mask, counts

    # the generator's queries at every width bucket (0: the narrow words)
    for fmt in ("CSV", "JSON"):
        for width in (0, 12, 30, 60, 100):
            for expr, program, pages, _q, _r in sc.page_cases(
                    fmt, width, 100 + width, 25):
                check(f"{fmt} W={pages.width} {expr!r}", program,
                      on_dev(pages.arrays))
                stats["widths"].add(pages.width)
    if stats["widths"] != {8, 16, 32, 64, 128}:
        fail(f"scan_eval: widths {sorted(stats['widths'])} checked")
    # every node kind, against the evaluator's WHERE decision too
    rows = sc.rows_of(sc.oracle_csv(), "CSV")
    for where in sc.ORACLE_WHERE:
        q = sql.parse(f"SELECT COUNT(*), COUNT(s) FROM S3Object WHERE "
                      f"{where}")
        plan = compile_plan(q, "CSV")
        program = scan_program.program_for(plan)
        pages = pager.build_pages(rows, plan)
        mask, _ = check(f"oracle {where!r}", program, on_dev(pages.arrays))
        want = np.array([bool(sql.evaluate(q.where, r, q.alias))
                         for r in rows])
        got = mask.reshape(-1)[:len(rows)].cpu().numpy().astype(bool)
        if not np.array_equal(got, want):
            fail(f"scan_eval {where!r}: the mask is not the evaluator's "
                 f"WHERE decision on rows "
                 f"{np.flatnonzero(got != want)[:8].tolist()}")
        stats["evaluator_checked"] += 1
    missing = sc.ALL_KINDS - stats["kinds"]
    if missing:
        fail(f"scan_eval: node kinds never checked: {sorted(missing)}")
    # batches of 1, 3, 64 and 254 pages, the last one ragged
    for expr, program, pages, _q, _r in sc.page_cases("CSV", 30, 7, 4,
                                                      rows=2500):
        for B in (1, 3, 64, 254):
            check(f"B={B} {expr!r}", program,
                  on_dev(sc.tile_pages(pages.arrays, B, 1234)))
            stats["batches"].add(B)
    # packed pages of two requests; inputs and outputs at each end of a
    # mapping between unmapped ranges (a read or store outside faults)
    for expr, program, pages, _q, _r in sc.page_cases("JSON", 60, 9, 4,
                                                      rows=2100):
        packed = np.concatenate([scan_cuda.pack_pages(pages.arrays)] * 2)
        B, P = packed.shape
        R, C, W = pages.shape_key()
        k = len(program.cspec)
        n_out = B * R + 4 * B * k
        with guard_pages.guarded(packed.nbytes, dev) as src, \
                guard_pages.guarded(n_out, dev) as dst:
            for x in (src[:packed.nbytes], src[-packed.nbytes:]):
                x.copy_(torch.from_numpy(packed.reshape(-1)).to(dev))
                v = scan_cuda.unpack(x.view(B, P), R, C, W)
                check(f"packed {expr!r}", program, v)
                for out in (dst[:n_out], dst[-n_out:]):
                    counts = out[:4 * B * k].view(torch.int32).view(B, k)
                    check(f"packed {expr!r}, outputs in a guarded mapping",
                          program, v, (out[4 * B * k:].view(B, R), counts))
    # one rounding per operation, as the evaluator's floats
    data, expr = sc.fma_case()
    plan = compile_plan(sql.parse(expr), "CSV")
    pages = pager.build_pages(sc.rows_of(data, "CSV"), plan)
    _m, counts = check("fma", scan_program.program_for(plan),
                       on_dev(pages.arrays))
    if int(counts[0, 0]) != 1:
        fail("scan_eval: (a * 3) + 1 was contracted into one FMA")
    return err_max, stats["queries"], {
        "evaluator_checked": stats["evaluator_checked"],
        "widths": sorted(stats["widths"]),
        "node_kinds": len(stats["kinds"]),
        "batches": sorted(stats["batches"])}


def check_sha256(torch, dev, rand_u8, max_err, sha256_cuda, sha256_ref,
                 guard_pages, c5, c5_plains) -> tuple[int, int]:
    """Phase 2 for sha256: the kernel against its plain version and
    hashlib on every row (tolerance 0). The plain version runs on a CPU
    copy of the rows: the same function on the same bytes, ~2.5x faster
    there than one launch per operation. c5: 640 rows of 65,536 B;
    c5_plains: length -> (their plain digests, ms), for the lengths a
    worker process computed. Returns (max abs err, cases)."""
    err, cases = 0, 0

    def plain_of(rows, length):
        return sha256_ref.sha256_rows(rows.cpu(), length)

    def check(what, rows, length, plain=None, want=None):
        nonlocal err, cases
        got = sha256_cuda.sha256_rows(rows, length)
        torch.cuda.synchronize()
        if plain is None:
            plain = plain_of(rows, length)
        e = max_err(got.cpu(), plain)
        host = rows[:, :length].cpu().numpy()
        if want is None:
            want = [hashlib.sha256(r.tobytes()).digest() for r in host]
        got_np = got.cpu().numpy()
        if e or any(got_np[i].tobytes() != want[i]
                    for i in range(len(want))):
            fail(f"sha256 {what}: kernel disagrees (max abs err {e})")
        err = max(err, e)
        cases += 1

    # every padding branch, length < S in all but the last, on 1 to 640
    # rows of config 5's shard length (the plain version runs once per
    # length, on all 640 rows)
    for length in (0, 1, 55, 56, 63, 64, 65, 119, 120, 65535, 65536):
        plain = c5_plains[length][0] if length in c5_plains \
            else plain_of(c5, length)
        want = [hashlib.sha256(r.tobytes()).digest()
                for r in c5[:, :length].cpu().numpy()]
        for n in (1, 20, 160, 640):
            check(f"{n} rows, length {length}", c5[:n], length,
                  plain[:n], want[:n])
    c5_plain = c5_plains[65536][0]
    # the ring's edges: a block of the kernel is 32 rows (one per lane of
    # its round warp), a ring stage 128 bytes of a row, and the three
    # producers' two slots each turn every 6 stages (768 bytes). Row counts
    # around one and two blocks and config 5's 640, on rows of 1031 bytes
    # (every offset mod 16); lengths of a stage -1, +0, +1 and both padding
    # forms (length % 64 = 55, 56, 63, 0) ending a stage or crossing into
    # the next, at the first stage and after a turn of the slots
    rows = rand_u8(641, 1031)
    plain = plain_of(rows, 1031)
    want = [hashlib.sha256(r.tobytes()).digest()
            for r in rows.cpu().numpy()]
    for n in (1, 31, 32, 33, 63, 64, 65, 639, 640, 641):
        check(f"{n} rows of 1031", rows[:n], 1031, plain[:n], want[:n])
    for length in sorted({base + d for base in (128, 768)
                          for d in (-9, -8, -1, 0, 1, 55, 56, 63, 64)}):
        check(f"33 rows, length {length}", rand_u8(33, length + 5), length)
    # rows on 4- and 1-byte boundaries, and views starting mid-word
    for stride in (1028, 1031):
        r = rand_u8(33, stride)
        for length in (stride, stride - 5, 519):
            check(f"33 rows of {stride}, length {length}", r, length)
    flat = rand_u8(4 + 9 * 1031)
    for base in (1, 2, 3):
        check(f"view from byte {base}",
              flat[base:base + 9 * 1031].view(9, 1031), 1031)
    # config 5's rows (their plain digests from the first loop), and a
    # ragged small shape, at each end of a mapping between unmapped
    # ranges: a read outside the rows faults
    small = rand_u8(3, 1031)
    for src, length, plain in ((c5, 65536, c5_plain),
                               (small, 1031, plain_of(small, 1031))):
        n, s_len = src.shape
        with guard_pages.guarded(src.numel(), dev) as buf:
            for at, g in (("start", buf[:src.numel()]),
                          ("end", buf[-src.numel():])):
                g = g.view_as(src)
                g.copy_(src)
                check(f"{n} rows of {s_len} at the {at} of a mapping", g,
                      length, plain)
    return err, cases


def check_chacha20(torch, dev, rand_u8, max_err, chacha20_cuda,
                   chacha20_plain, chacha20_ref, guard_pages, np
                   ) -> tuple[int, int]:
    """Phase 2 for chacha20: the kernel against its plain version on every
    byte (tolerance 0), into a new tensor and in place (bytes at or past
    the span must stay as they were). Returns (max abs err, cases)."""
    rng = np.random.default_rng(SEED + 3)
    err, cases = 0, 0

    def words(*shape):
        return chacha20_cuda.words(
            rng.integers(0, 1 << 32, shape, dtype=np.uint32), dev)

    def check(what, data, keys, nonces, pkg_bytes, span=None, out=None):
        """Into a new tensor, into `out` when given (preset to data), and
        in place (in `out`, or a copy of data)."""
        nonlocal err, cases
        want = chacha20_plain.keystream_xor(data, keys, nonces, pkg_bytes,
                                            span)
        results = [chacha20_cuda.keystream_xor(data, keys, nonces,
                                               pkg_bytes, span)]
        if out is not None:
            out.copy_(data)
            chacha20_cuda.keystream_xor(data, keys, nonces, pkg_bytes, span,
                                        out=out)
            torch.cuda.synchronize()
            results.append(out.clone())
        inplace = data.clone() if out is None else out
        inplace.copy_(data)
        chacha20_cuda.keystream_xor(inplace, keys, nonces, pkg_bytes, span,
                                    out=inplace)
        torch.cuda.synchronize()
        results.append(inplace)
        e = max(max_err(r, want) for r in results)
        if e:
            fail(f"chacha20 {what}: kernel disagrees (max abs err {e})")
        err = max(err, e)
        cases += 1

    # RFC 8439 §2.4.2: the sunscreen plaintext, one 128-byte package
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer "
          b"you only one tip for the future, sunscreen would be it.")
    key, nonce = bytes(range(32)), bytes.fromhex("000000000000004a00000000")
    got = chacha20_cuda.keystream_xor(
        torch.frombuffer(bytearray(pt), dtype=torch.uint8)[None].to(dev),
        chacha20_cuda.words(np.frombuffer(key, "<u4")[None], dev),
        chacha20_cuda.words(np.frombuffer(nonce, "<u4")[None, None], dev),
        128).cpu().numpy().tobytes()
    if got[:16] != bytes.fromhex("6e2e359a2568f98041ba0728dd0d6981") or \
            got != chacha20_ref.xor_stream(pt, key, nonce):
        fail("chacha20: the RFC 8439 §2.4.2 vector disagrees")
    cases += 1
    # package sizes and counts, and spans shorter than the row (a multiple
    # of 64 and not): a wrong counter, nonce index or package shows at
    # P > 1 and pkg_bytes < row length
    for pkg in (64, 4096, 65536):
        for p in (1, 2, 16):
            data = rand_u8(3, p * pkg + 40)
            keys, nonces = words(3, 8), words(3, p, 3)
            for span in (None, p * pkg - 64, p * pkg - 1):
                if span != 0:
                    check(f"P={p} x {pkg} B, span {span}", data, keys,
                          nonces, pkg, span)
    # the PUT's flat (B, k*S) rows at 12+4: 1 MiB blocks (k*S = 1,048,584)
    # and 4 MiB (4,194,312), 8-byte aligned; then rows at 8-, 4- and
    # 1-byte alignment (views from bytes 8, 4 and 1 of a buffer)
    for stride, span in ((1048584, 1 << 20), (4194312, 4 << 20)):
        check(f"8 rows of {stride}, span {span}", rand_u8(8, stride),
              words(8, 8), words(8, span // 65536, 3), 65536, span)
    flat = rand_u8(8 + 8 * 1048584)
    keys, nonces = words(8, 8), words(8, 16, 3)
    for base in (8, 4, 1):
        view = flat[base:base + 8 * 1048584].view(8, 1048584)
        if view.data_ptr() % 16 != base % 16:
            fail("chacha20: the view does not start where intended")
        check(f"8 rows of 1048584 from byte {base}", view, keys, nonces,
              65536, 1 << 20)
    # input and output rows at different offsets mod 16 (strides 5 and 11
    # bytes over a span of four 8 KiB tiles and a fifth cut mid-block)
    span = 4 * 8192 + 4096 + 37
    flat_in, flat_out = rand_u8(16 + 3 * (span + 5)), \
        rand_u8(16 + 3 * (span + 11))
    keys, nonces = words(3, 8), words(3, 10, 3)
    for a, b in ((1, 6), (3, 0), (0, 13), (8, 15), (15, 7), (6, 6)):
        view = flat_in[a:a + 3 * (span + 5)].view(3, span + 5)
        out = flat_out[b:b + 3 * (span + 11)].view(3, span + 11)[:, :span + 5]
        check(f"3 rows in from byte {a}, out from byte {b}", view, keys,
              nonces, 4096, span, out=out)
    # GET's decipher batch: 64 packages of 65,536 B, a short last package
    # zero-padded to a 64-byte multiple, and a lone short package
    rows = rand_u8(64, 65536)
    rows[-1, 1000:] = 0
    keys, nonces = words(64, 8), words(64, 1, 3)
    check("GET 64 x 65536, short last package", rows, keys, nonces, 65536)
    got = chacha20_cuda.xor_packages(rows, keys, nonces[:, 0])
    if max_err(got, chacha20_plain.keystream_xor(rows, keys, nonces,
                                                 65536)):
        fail("chacha20: xor_packages disagrees")
    check("GET one padded package of 1024", rand_u8(1, 1024), keys[:1],
          nonces[:1], 1024)
    # input and output at each end of a mapping between unmapped ranges: a
    # load or store outside the rows faults
    for n_rows, length, span, pkg in ((8, 1048584, 1 << 20, 65536),
                                      (64, 65536, 65536, 65536),
                                      (3, 129, 100, 64)):
        n = n_rows * length
        src = rand_u8(n_rows, length)
        keys, nonces = words(n_rows, 8), words(n_rows, -(-span // pkg), 3)
        with guard_pages.guarded(n, dev) as a, \
                guard_pages.guarded(n, dev) as b:
            for at, x in (("start", a[:n]), ("end", a[-n:])):
                x = x.view(n_rows, length)
                x.copy_(src)
                for o in (b[:n], b[-n:]):
                    check(f"{n_rows} x {length} input at the {at} of a "
                          "mapping", x, keys, nonces, pkg, span,
                          out=o.view(n_rows, length))
    return err, cases


def check_sse_steps(torch, dev, rand_u8, max_err, pipeline, rs_cuda,
                    rs_matrix, chacha20_cuda, np) -> int:
    """Phase 2 for the fused cipher steps: sse_put_step and sse_get_step on
    the card against the same steps on CPU tensors (the plain versions),
    at config 2's block (1 MiB at 12+4, S = 87,382), B = 2. Returns the
    max abs err."""
    k, m, s, b = 12, 4, 87382, 2
    rng = np.random.default_rng(SEED + 4)
    x = torch.zeros((b, k * s), dtype=torch.uint8, device=dev)
    x[:, :1 << 20] = rand_u8(b, 1 << 20)
    x = x.view(b, k, s)
    keys = chacha20_cuda.words(rng.integers(0, 1 << 32, (b, 8),
                                            dtype=np.uint32), dev)
    nonces = chacha20_cuda.words(rng.integers(0, 1 << 32, (b, 16, 3),
                                              dtype=np.uint32), dev)
    rows, dig = pipeline.sse_put_step(x, keys, nonces, k, m, 65536)
    cpu_rows, cpu_dig = pipeline.sse_put_step(x.cpu(), keys.cpu(),
                                              nonces.cpu(), k, m, 65536)
    err = max(max_err(rows.cpu(), cpu_rows), max_err(dig.cpu(), cpu_dig))
    mask = sum(1 << i for i in range(k + m) if i not in (1, 5, 14))
    dm, used, missing = rs_matrix.missing_data_matrix(k, m, mask)
    surv = rows[:, list(used)].contiguous()
    data_src = tuple((0, used.index(j)) if j in used
                     else (1, missing.index(j)) for j in range(k))
    bits = rs_cuda.matrix_bits(dm, dev)
    got = pipeline.sse_get_step(surv, bits, keys, nonces, dm.shape[0], k,
                                data_src, 65536, s)
    want = pipeline.sse_get_step(surv.cpu(), bits.cpu(), keys.cpu(),
                                 nonces.cpu(), dm.shape[0], k, data_src,
                                 65536, s)
    err = max(err, *(max_err(g.cpu(), w) for g, w in zip(got, want)),
              max_err(got[0], x))
    if err:
        fail(f"sse_put_step/sse_get_step on the card disagree with the CPU "
             f"(max abs err {err})")
    return err


class LaunchCounts:
    """Every kernel's launch counter: set to 0 just before a path is
    driven, read just after."""

    def __init__(self, rs_cuda, hh, sha, chacha, scan):
        self.rs_cuda, self.hh, self.sha, self.chacha = rs_cuda, hh, sha, \
            chacha
        self.scan = scan

    def zero(self) -> None:
        self.rs_cuda.gf_matmul.launches = 0
        self.hh.hh256.launches = 0
        self.sha.sha256_rows.launches = 0
        self.chacha.keystream_xor.launches = 0
        self.scan.scan_eval.launches = 0

    def read(self) -> dict:
        return {"gf_matmul": self.rs_cuda.gf_matmul.launches,
                "hh256": self.hh.hh256.launches,
                "sha256": self.sha.sha256_rows.launches,
                "chacha20": self.chacha.keystream_xor.launches,
                "scan_eval": self.scan.scan_eval.launches}


def stage_report(stagetimer) -> dict:
    """Per stage: seconds and calls, p50/p99 ms; and the pipeline
    overlap (summed stage seconds over wall seconds per stream)."""
    pct = stagetimer.percentiles()
    return {"stages": {name: {**v, **pct.get(name, {})}
                       for name, v in stagetimer.report().items()},
            "overlap": stagetimer.overlap_report()}


def codec_steps(codec) -> dict:
    return {verb: {k: (round(x, 4) if isinstance(x, float) else x)
                   for k, x in v.items()}
            for verb, v in codec.step_seconds().items()}


def read_all_back(e, bucket, objects) -> float:
    """GET every object; bytes and the MD5 ETag must match."""
    t0 = time.perf_counter()
    for name, data in objects.items():
        info, it = e.get_object(bucket, name)
        if b"".join(it) != data:
            fail(f"GET {bucket}/{name}: bytes differ")
        if info.etag != hashlib.md5(data).hexdigest():
            fail(f"GET {bucket}/{name}: ETag {info.etag} is not the MD5")
    return time.perf_counter() - t0


def tree_files(root) -> dict:
    """relative path -> bytes of every file under root."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def part_files(root) -> dict:
    """object/part.N -> bytes under one drive's bucket dir (the data-dir
    uuid, which differs per write, left out of the key)."""
    out = {}
    for rel, data in tree_files(root).items():
        parts = rel.split(os.sep)
        if parts[-1].startswith("part."):
            out[os.sep.join(parts[:-2] + [parts[-1]])] = data
    return out


def run_main_path(eng_mod, hash_order, tmp, card, counts, stagetimer,
                  np) -> tuple[dict, dict]:
    from minio_tpu_torch.object import ErasureSetObjects, codec
    k, m = 12, 4
    rng = np.random.default_rng(SEED)
    sizes = {f"obj-{i}": MAIN_OBJECT for i in range(8)}
    sizes["obj-ragged"] = MAIN_OBJECT + 12345
    sizes["obj-small"] = 1024                       # below the size gate
    objects = {name: rng.bytes(n) for name, n in sizes.items()}
    total = sum(sizes.values())
    paths = [os.path.join(tmp, f"drive{i}") for i in range(k + m)]
    eng = eng_mod.from_reference_layout(paths, k, m,   # device: the card
                                        cls=ErasureSetObjects)
    eng.make_bucket("smoke")
    left = []
    eng.on_degraded_write = lambda *key: left.append(key)

    codec.reset_step_seconds()
    stagetimer.reset()
    stagetimer.enable()
    counts.zero()
    t0 = time.perf_counter()
    for name, data in objects.items():
        info = eng.put_object("smoke", name, data)
        if info.etag != hashlib.md5(data).hexdigest() or \
                info.size != len(data):
            fail(f"PUT {name}: bad ObjectInfo")
    put_s = time.perf_counter() - t0
    put_counts = counts.read()
    if min(put_counts["gf_matmul"], put_counts["hh256"]) <= 0:
        fail(f"PUT did not launch both kernels: {put_counts}")

    get_s = read_all_back(eng, "smoke", objects)
    healthy = counts.read()
    settled = heal_left_behind(eng, left)
    before_deg = counts.read()

    # 3 drives gone; the first one holds data shard 0 of obj-0
    dist = hash_order("smoke/obj-0", k + m)
    gone = [dist.index(1)]
    gone += [i for i in range(k + m) if i not in gone][:2]
    disks = [None if i in gone else d for i, d in enumerate(eng.disks)]
    degraded = eng_mod.ErasureObjects(disks, k, m)
    deg_s = read_all_back(degraded, "smoke", objects)
    final = counts.read()
    stagetimer.disable()
    deg_counts = {n: final[n] - before_deg[n] for n in final}
    if min(deg_counts["gf_matmul"], deg_counts["hh256"]) <= 0:
        fail(f"degraded GET did not launch both kernels: {deg_counts}")
    gib = total / (1 << 30)
    out = {"phase": "main_path", "objects": len(objects),
           "bytes": total, "drives": k + m, "ec": f"{k}+{m}",
           "block_size": eng.block_size, "missing_drives": gone,
           "put_s": round(put_s, 3), "put_gib_s": round(gib / put_s, 4),
           "get_s": round(get_s, 3), "get_gib_s": round(gib / get_s, 4),
           "degraded_get_s": round(deg_s, 3),
           "degraded_get_gib_s": round(gib / deg_s, 4),
           "codec_step_s": codec_steps(codec),
           "put_launches": put_counts,
           "healthy_get_launches": {
               n: healthy[n] - put_counts[n] for n in healthy},
           "left_behind": settled,
           "left_behind_heal_launches": {
               n: before_deg[n] - healthy[n] for n in healthy},
           "degraded_get_launches": deg_counts,
           "gf_matmul_launches": final["gf_matmul"],
           "hh256_launches": final["hh256"], "launches": final,
           "stagetimer": stage_report(stagetimer), "card": card}
    emit(out)
    return out, {"paths": paths, "objects": objects, "drive": gone[0]}


def device_busy(torch, run, counts) -> dict:
    """Run `run()` under torch.profiler (device activity only) and return
    its wall seconds, the device seconds the profiler recorded (summed by
    name; two streams' overlapping work counts twice), and the idle share
    they leave. The profiler can lose kernel records, so each kernel's
    launches it recorded stand beside those its wrapper counted in the
    run: "idle_share_at_least" is a lower bound only when it recorded
    every counted launch, and is None otherwise; "idle_share_scaled"
    charges each lost launch the mean of that kernel's recorded ones.
    Device fields are None when the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    before = counts.read()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = counts.read()
    by_name, recorded = {}, {n: [0, 0.0] for n in after}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            by_name[e.key] = round(us / 1e6, 6)
            for n in recorded:
                if f"{n}_kernel" in e.key:
                    recorded[n][0] += e.count
                    recorded[n][1] += us / 1e6
    busy = sum(by_name.values())
    launches = {n: {"counted": after[n] - before[n],
                    "recorded": recorded[n][0]} for n in after}
    complete = all(v["recorded"] >= v["counted"] for v in launches.values())
    scaled = busy
    for n, v in launches.items():
        lost = v["counted"] - v["recorded"]
        if lost > 0:
            scaled = None if not v["recorded"] or scaled is None else \
                scaled + lost * recorded[n][1] / v["recorded"]
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return {"wall_s": round(wall, 3),
            "device_s": round(busy, 6) if by_name else None,
            "kernel_launches": launches, "recorded_every_launch": complete,
            "idle_share_at_least": round(1 - busy / wall, 6)
            if by_name and complete else None,
            "idle_share_scaled": round(1 - scaled / wall, 6)
            if by_name and scaled is not None else None,
            "device_s_by_name": top}


def run_concurrent_put(eng_mod, sched, stagetimer, tmp, card, counts,
                       np) -> dict:
    """BASELINE.json config 2: 32 streams each PUT one 16 MiB object at
    once into a 16-drive 12+4 set with 1 MiB blocks, through the batch
    former and the pipelined PUT loop."""
    import threading

    import torch
    from minio_tpu_torch.object import codec
    from minio_tpu_torch.parallel import pipeline as pl
    k, m = 12, 4
    streams, size = CONCURRENT
    rng = np.random.default_rng(SEED + 5)
    objects = {f"put-{i:02d}": rng.bytes(size) for i in range(streams)}
    root = os.path.join(tmp, "concurrent")
    paths = [os.path.join(root, f"drive{i}") for i in range(k + m)]
    eng = eng_mod.from_reference_layout(paths, k, m, block_size=1 << 20,
                                        scheduler=sched)
    eng.make_bucket("smoke")
    before = sched.stats()
    codec.reset_step_seconds()
    stagetimer.reset()
    stagetimer.enable()
    counts.zero()
    errors, infos = [], {}

    def put_all(prefix="") -> float:
        """All streams at once; returns the wall seconds from the start
        barrier to the last PUT's return."""
        start = threading.Barrier(streams + 1)

        def put(name, data):
            try:
                start.wait()
                infos[prefix + name] = eng.put_object("smoke", prefix + name,
                                                      data)
            except Exception as e:  # noqa: BLE001 — failed below
                errors.append(f"{name}: {e!r}")

        threads = [threading.Thread(target=put, args=kv)
                   for kv in objects.items()]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        return time.perf_counter() - t0

    wall = put_all()
    stagetimer.disable()
    stages = stage_report(stagetimer)
    launched = counts.read()
    after = sched.stats()
    steps = codec_steps(codec)
    if errors:
        fail(f"concurrent PUT: {errors[:3]}")
    for name, data in objects.items():
        if infos[name].etag != hashlib.md5(data).hexdigest():
            fail(f"concurrent PUT {name}: ETag is not the MD5")
    enc = {key: after["verbs"]["encode"][key]
           - before["verbs"]["encode"][key]
           for key in after["verbs"]["encode"]}
    declined = after["declined"] - before["declined"]
    on_card = enc["batches"] - enc["host_routed"]
    if declined or enc["host_routed"]:
        fail(f"concurrent PUT: {declined} declined, {enc['host_routed']} "
             "dispatches routed to the host")
    if enc["coalesced"] <= 0:
        fail(f"concurrent PUT: the former never coalesced: {enc}")
    # each encode dispatch on the card is one put_step: one launch of
    # each kernel, counted exactly under the two dispatch threads
    if launched != {"gf_matmul": on_card, "hh256": on_card, "sha256": 0,
                    "chacha20": 0, "scan_eval": 0} \
            or steps["encode"]["calls"] != on_card:
        fail(f"concurrent PUT: launches {launched}, codec calls "
             f"{steps['encode']['calls']} != {on_card} dispatches")
    if enc["blocks"] != streams * size // (1 << 20):
        fail(f"concurrent PUT: {enc['blocks']} blocks dispatched")
    ring = pl.pool_pressure()
    get_s = read_all_back(eng, "smoke", objects)
    # the same PUTs again under the profiler: the device's idle share
    profiled = device_busy(torch, lambda: put_all("again/"), counts)
    if errors:
        fail(f"concurrent PUT under the profiler: {errors[:3]}")
    gib = streams * size / (1 << 30)
    out = {"phase": "concurrent_put", "config": "BASELINE.json config 2",
           "streams": streams, "object_bytes": size, "ec": f"{k}+{m}",
           "block_size": 1 << 20, "wall_s": round(wall, 3),
           "put_gib_s": round(gib / wall, 4),
           "get_back_s": round(get_s, 3),
           "encode": enc, "declined": declined,
           "codec_step_s": steps, "launches": launched,
           "staging_ring": {"buffers": pl.POOL_BUFFERS, **ring},
           "profiled_again": profiled, "stagetimer": stages, "card": card}
    emit(out)
    shutil.rmtree(root, ignore_errors=True)
    return out


def expected_recover_dispatches(objects, k, block_size) -> tuple[int, int]:
    """(dispatches on the card, dispatches the size gate keeps on the
    host) of healing each object once: heal groups of HEAL_BATCH_BLOCKS
    blocks, one dispatch per shard length in a group, on the card when
    its survivors pass DEVICE_MIN_BYTES."""
    from minio_tpu_torch.object import codec, healing
    card = host = 0
    for data in objects.values():
        lens = [min(block_size, len(data) - off)
                for off in range(0, len(data), block_size)]
        for g in range(0, len(lens), healing.HEAL_BATCH_BLOCKS):
            by_len: dict[int, int] = {}
            for n in lens[g:g + healing.HEAL_BATCH_BLOCKS]:
                sl = -(-n // k)
                by_len[sl] = by_len.get(sl, 0) + 1
            for sl, nb in by_len.items():
                if nb * k * sl >= codec.DEVICE_MIN_BYTES:
                    card += 1
                else:
                    host += 1
    return card, host


def run_heal(sched, state, tmp, card, counts, np) -> dict:
    """BASELINE.json config 4: heal one drive of the phase-3 set. The
    drive's bucket dir is deleted (its format.json stays) and every object
    is healed through the batch former's recover verb; the rebuilt part
    and xl.meta files must equal the deleted ones byte for byte. A second
    pass flips one byte of a survivor shard: heal must find it by its
    digest and still write the right bytes."""
    from minio_tpu_torch.object import open_erasure_set
    k, m = 12, 4
    paths, objects = state["paths"], state["objects"]
    drive = paths[state["drive"]]
    bucket_dir = os.path.join(drive, "smoke")
    saved = tree_files(bucket_dir)
    if not any(f.endswith("part.1") for f in saved):
        fail("heal: the chosen drive holds no shard files")
    shutil.rmtree(bucket_dir)
    eng = open_erasure_set(paths, k, m, scheduler=sched)
    rebuilt = []
    real_rebuild = eng._host_rebuild_block
    eng._host_rebuild_block = lambda *a, **kw: rebuilt.append(a[2]) or \
        real_rebuild(*a, **kw)
    before = sched.stats()
    counts.zero()
    t0 = time.perf_counter()
    healed = 0
    for name in objects:
        res = eng.heal_object("smoke", name)
        healed += res.disks_healed
    wall = time.perf_counter() - t0
    launched = counts.read()
    after = sched.stats()
    rec = {key: after["verbs"]["recover"][key]
           - before["verbs"]["recover"][key]
           for key in after["verbs"]["recover"]}
    want_card, want_host = expected_recover_dispatches(
        objects, k, eng.block_size)
    got = tree_files(bucket_dir)
    if got != saved:
        diff = sorted(set(got) ^ set(saved)) or \
            [f for f in saved if got[f] != saved[f]]
        fail(f"heal: rebuilt files differ from the deleted ones: {diff[:4]}")
    if healed != len(objects):
        fail(f"heal: {healed} drives healed for {len(objects)} objects")
    on_card = rec["batches"] - rec["host_routed"]
    if after["declined"] != before["declined"] or \
            (on_card, rec["host_routed"]) != (want_card, want_host):
        fail(f"heal: recover dispatches {rec} (card {on_card}), expected "
             f"{want_card} on the card and {want_host} by the size gate")
    if launched != {"gf_matmul": on_card, "hh256": on_card, "sha256": 0,
                    "chacha20": 0, "scan_eval": 0}:
        fail(f"heal: launches {launched} != {on_card} recover dispatches")
    if rebuilt:
        fail("heal: a host rebuild ran without bitrot")

    # second pass: a survivor with one flipped byte, and the drive's copy
    # of obj-0 gone again
    from minio_tpu_torch.storage.datatypes import hash_order
    name = "obj-0"
    dist = hash_order(f"smoke/{name}", k + m)
    survivor = dist.index(2)            # holds data shard 1 of obj-0
    if survivor == state["drive"]:
        fail("heal: the survivor is the healed drive")
    part = [p for p in tree_files(os.path.join(paths[survivor], "smoke",
                                               name))
            if p.endswith("part.1")][0]
    part = os.path.join(paths[survivor], "smoke", name, part)
    with open(part, "r+b") as fh:
        fh.seek(32 + 1000)              # a payload byte of block 0
        byte = fh.read(1)
        fh.seek(32 + 1000)
        fh.write(bytes([byte[0] ^ 0xFF]))
    shutil.rmtree(os.path.join(bucket_dir, name))
    counts.zero()
    eng.heal_object("smoke", name)
    second = counts.read()
    with open(part, "r+b") as fh:      # restore the survivor
        fh.seek(32 + 1000)
        fh.write(byte)
    again = tree_files(bucket_dir)
    if again != saved:
        fail("heal: with a flipped survivor byte the rebuilt files differ")
    if rebuilt != [0]:
        fail(f"heal: the flipped survivor byte was not found by its "
             f"digest (host rebuilds of blocks {rebuilt})")
    if min(second["gf_matmul"], second["hh256"]) <= 0:
        fail(f"heal: second pass launched {second}")
    total = sum(len(d) for d in objects.values())
    out = {"phase": "heal", "config": "BASELINE.json config 4",
           "objects": len(objects), "bytes": total,
           "healed_drive": state["drive"], "files": len(saved),
           "wall_s": round(wall, 3),
           "heal_gib_s": round(total / (1 << 30) / wall, 4),
           "recover": rec, "launches": launched,
           "flipped_byte_found": True, "second_pass_launches": second,
           "card": card}
    emit(out)
    return out


def run_mrf(sched, tmp, card, counts, np) -> dict:
    """PUT 4 objects of 64 MiB with one drive offline: the degraded-write
    hook queues each on the MRF healer; the drive comes back, the queue
    drains, and the drive's shard files equal a healthy PUT's."""
    from minio_tpu_torch.object import open_erasure_set
    k, m = 12, 4
    rng = np.random.default_rng(SEED + 7)
    count, size = MRF_OBJECTS
    objects = {f"mrf-{i}": rng.bytes(size) for i in range(count)}
    mk = lambda tag: [os.path.join(tmp, tag, f"drive{i}")  # noqa: E731
                      for i in range(k + m)]
    eng = open_erasure_set(mk("mrf"), k, m, scheduler=sched, mrf=True,
                           mrf_kw={"max_retries": 100})
    ref = open_erasure_set(mk("healthy"), k, m, scheduler=sched)
    ref_left = []
    ref.on_degraded_write = lambda *key: ref_left.append(key)
    try:
        for e in (eng, ref):
            e.make_bucket("smoke")
        slot = 5
        drive, eng.disks[slot] = eng.disks[slot], None
        counts.zero()
        for name, data in objects.items():
            eng.put_object("smoke", name, data)
        queued = eng.mrf.stats()["queued"]
        if queued != len(objects):
            fail(f"MRF: {queued} degraded PUTs queued, not {len(objects)}")
        eng.disks[slot] = drive
        eng.mrf.kick()
        t0 = time.perf_counter()
        if not eng.mrf.drain(timeout=300):
            fail(f"MRF: the queue did not drain: {eng.mrf.stats()}")
        drain_s = time.perf_counter() - t0
        launched = counts.read()
        st = eng.mrf.stats()
        if st["healed"] != len(objects) or st["failed"]:
            fail(f"MRF: {st}")
        for name, data in objects.items():
            ref.put_object("smoke", name, data)
        ref_settled = heal_left_behind(ref, ref_left)
        got = part_files(os.path.join(mk("mrf")[slot], "smoke"))
        want = part_files(os.path.join(mk("healthy")[slot], "smoke"))
        if len(want) != len(objects) or got != want:
            fail("MRF: the returned drive's shard files differ from a "
                 "healthy PUT's")
        if min(launched["gf_matmul"], launched["hh256"]) <= 0:
            fail(f"MRF: launches {launched}")
        read_all_back(eng, "smoke", objects)
    finally:
        eng.mrf.close()
    out = {"phase": "mrf", "objects": len(objects),
           "object_bytes": size, "offline_slot": slot,
           "mrf": st, "drain_s": round(drain_s, 3), "launches": launched,
           "healthy_left_behind": ref_settled, "card": card}
    emit(out)
    return out


def run_config5(tmp, card, counts, stagetimer, np) -> dict:
    """BASELINE.json config 5: multipart upload, 16+4 across 2 server
    sets, SHA-256 bitrot, cross-set shard batching. Two pools, each one
    erasure set of 20 temp-dir drives at EC 16+4 with 1 MiB blocks (shard
    blocks of 65,536 B, as bench.py:173-176) and sha256 bitrot, share one
    batch former. Eight objects of 4 parts x 64 MiB are uploaded with all
    32 part uploads in flight at once (the parts of one upload take its
    session lock in turn, as in the reference), then completed; every
    object is read back by bytes and multipart ETag, healthy and with 4
    of 20 drives gone in each pool.

    Cut from config 5: 2 GiB in 8 objects of 4 parts rather than one
    8 GiB object in 128 parts. Kept: the 64 MiB part size, the 16+4
    geometry, the 1 MiB block, the sha256 algorithm and the two pools.

    The uploads then run again under torch.profiler for the device's idle
    share. Fails unless nothing is declined or routed to the host, sha256
    launches equal the encode dispatches, every shard file's whole-file
    digest in xl.meta equals hashlib over that file, and a sample of each
    dispatch's device digests (one data and one parity row of every
    group) equals hashlib over those rows. Cross-pool coalescing is
    reported; it must occur when both pools hold objects (pool choice is
    random, weighted by free space, as in the reference)."""
    import threading

    import torch
    from minio_tpu_torch.bitrot import BitrotAlgorithm
    from minio_tpu_torch.object import codec, server_sets
    from minio_tpu_torch.object.multipart import CompletePart
    from minio_tpu_torch.parallel.scheduler import BatchScheduler
    from minio_tpu_torch.storage.xl_storage import XLStorage
    k, m = 16, 4
    n_obj, n_parts, part_size = CONFIG5
    rng = np.random.default_rng(SEED + 9)
    objects = {f"mp-{i}": [rng.bytes(part_size) for _ in range(n_parts)]
               for i in range(n_obj)}
    root = os.path.join(tmp, "config5")
    pools = [[os.path.join(root, f"pool{p}", f"drive{j}")
              for j in range(k + m)] for p in range(2)]
    sched = BatchScheduler()
    layer = server_sets.open_server_sets(
        pools, k + m, m, block_size=1 << 20,
        bitrot_algo=BitrotAlgorithm.SHA256, scheduler=sched,
        enable_mrf=False)
    engines = [z.sets[0] for z in layer.server_sets]
    pool_of = {id(e.codec(k, m)): p for p, e in enumerate(engines)}
    dispatch_pools, samples = [], [0, 0]
    real_run = sched._run_erasure

    def run_erasure(key, group, stage_cb):
        """The former's dispatch, watched: which pools' groups it holds,
        and its digests of one data and one parity row of every group
        against hashlib (the data is still the waiters' own: they are
        released only after this returns)."""
        out = real_run(key, group, stage_cb)
        if key[0] == "encode" and out is not None:
            dispatch_pools.append(sorted({pool_of[id(p.codec)]
                                          for p in group}))
            parity, digests = out
            at = 0
            for p in group:
                for row, dig in ((p.data[0, 0], digests[at, 0]),
                                 (parity[at, 0], digests[at, k])):
                    if hashlib.sha256(row.tobytes()).digest() != \
                            dig.tobytes():
                        fail("config 5: a device sha256 digest differs "
                             "from hashlib over its row")
                    samples[0] += 1
                at += p.blocks
            samples[1] += 1
        return out

    def upload_all(prefix=""):
        """Every object's session, all parts in flight at once, then the
        commits; returns (parts wall s, commits s, ObjectInfo by name)."""
        uploads = {name: layer.new_multipart_upload("smoke5",
                                                    prefix + name)
                   for name in objects}
        errors, etags = [], {}
        start = threading.Barrier(n_obj * n_parts + 1)

        def put_part(name, i):
            try:
                start.wait()
                etags[(name, i)] = layer.put_object_part(
                    "smoke5", prefix + name, uploads[name], i + 1,
                    objects[name][i]).etag
            except Exception as e:  # noqa: BLE001 — failed below
                errors.append(f"{name} part {i + 1}: {e!r}")

        threads = [threading.Thread(target=put_part, args=(name, i))
                   for name in objects for i in range(n_parts)]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        parts_s = time.perf_counter() - t0
        if errors:
            fail(f"config 5 part uploads: {errors[:3]}")
        t0 = time.perf_counter()
        infos = {name: layer.complete_multipart_upload(
            "smoke5", prefix + name, uploads[name],
            [CompletePart(i + 1, etags[(name, i)])
             for i in range(n_parts)]) for name in objects}
        return parts_s, time.perf_counter() - t0, infos

    sched._run_erasure = run_erasure
    codec.reset_step_seconds()
    stagetimer.reset()
    stagetimer.enable()
    try:
        layer.make_bucket("smoke5")
        before = sched.stats()
        counts.zero()
        parts_s, complete_s, infos = upload_all()
        launched = counts.read()
        after = sched.stats()
        steps = codec_steps(codec)
    finally:
        stagetimer.disable()
        sched._run_erasure = real_run
    stages = stage_report(stagetimer)
    enc = {key: after["verbs"]["encode"][key]
           - before["verbs"]["encode"][key]
           for key in after["verbs"]["encode"]}
    declined = after["declined"] - before["declined"]
    on_card = enc["batches"] - enc["host_routed"]
    if declined or enc["host_routed"]:
        fail(f"config 5: {declined} declined, {enc['host_routed']} "
             "dispatches routed to the host")
    if launched["sha256"] != on_card or launched["gf_matmul"] != on_card \
            or launched["hh256"] or launched["chacha20"]:
        fail(f"config 5: launches {launched} != {on_card} encode "
             "dispatches")
    if samples[1] != on_card:
        fail(f"config 5: {samples[1]} dispatches watched, {on_card} made")
    want_blocks = n_obj * n_parts * part_size // (1 << 20)
    if enc["blocks"] != want_blocks:
        fail(f"config 5: {enc['blocks']} blocks dispatched, "
             f"{want_blocks} expected")
    per_pool = [0, 0]
    for name, parts in objects.items():
        want = hashlib.md5(b"".join(
            hashlib.md5(p).digest() for p in parts)).hexdigest() \
            + f"-{n_parts}"
        if infos[name].etag != want:
            fail(f"config 5 {name}: ETag {infos[name].etag} != {want}")
        holders = [p for p, e in enumerate(engines)
                   if e.has_object_versions("smoke5", name)]
        if len(holders) != 1:
            fail(f"config 5 {name}: held by pools {holders}")
        per_pool[holders[0]] += 1
    cross = sum(1 for ps in dispatch_pools if len(ps) == 2)
    if min(per_pool) > 0 and cross == 0:
        fail("config 5: both pools hold objects, yet no dispatch held "
             "groups of both")
    # every shard file's whole-file digest in xl.meta, against hashlib
    files = 0
    for drives in pools:
        for path in drives:
            d = XLStorage(path)
            for name in objects:
                try:
                    fi = d.read_version("smoke5", name)
                except Exception:  # noqa: BLE001 — object in other pool
                    continue
                for part in fi.parts:
                    csum = fi.erasure.get_checksum_info(part.number)
                    with open(os.path.join(path, "smoke5", name,
                                           fi.data_dir,
                                           f"part.{part.number}"),
                              "rb") as fh:
                        got = hashlib.sha256(fh.read()).digest()
                    if csum is None or csum.algorithm != "sha256" or \
                            csum.hash != got:
                        fail(f"config 5 {path} {name} part "
                             f"{part.number}: xl.meta digest is not the "
                             "file's sha256")
                    files += 1
    if files != n_obj * n_parts * (k + m):
        fail(f"config 5: {files} shard files checked")

    def read_back() -> float:
        t0 = time.perf_counter()
        for name, parts in objects.items():
            info, it = layer.get_object("smoke5", name)
            if b"".join(it) != b"".join(parts):
                fail(f"config 5 GET {name}: bytes differ")
            if info.etag != infos[name].etag:
                fail(f"config 5 GET {name}: ETag {info.etag}")
        return time.perf_counter() - t0

    counts.zero()
    get_s = read_back()
    healthy = counts.read()
    # 4 of 20 drives gone in each pool: the drives of data shards 1-4 of
    # the pool's first object, so every degraded read reconstructs
    from minio_tpu_torch.storage.datatypes import hash_order
    gone = {}
    for p, e in enumerate(engines):
        name = next((n for n in objects
                     if e.has_object_versions("smoke5", n)), None)
        if name is None:
            continue
        dist = hash_order(f"smoke5/{name}", k + m)
        gone[p] = [dist.index(j) for j in range(1, 5)]
    saved = {p: list(engines[p].disks) for p in gone}
    for p, slots in gone.items():
        for i in slots:
            engines[p].disks[i] = None
    counts.zero()
    try:
        deg_s = read_back()
    finally:
        for p, disks in saved.items():
            engines[p].disks[:] = disks
    degraded = counts.read()
    if degraded["gf_matmul"] <= 0:
        fail(f"config 5 degraded GET launched {degraded}")
    # the same uploads again under the profiler: the device's idle share,
    # and the kernels' device time per encode dispatch (one sha256 launch
    # each)
    counts.zero()
    profiled = device_busy(torch, lambda: upload_all("again/"), counts)
    again = counts.read()["sha256"]
    profiled["dispatches"] = again
    if again and profiled["device_s"] is not None:
        kern = {n: t for n, t in profiled["device_s_by_name"].items()
                if not n.startswith("Memcpy")}
        profiled["kernel_ms_per_dispatch"] = sum(kern.values()) / again * 1e3
        profiled["sha256_ms_per_dispatch"] = sum(
            t for n, t in kern.items() if "sha256_kernel" in n) / again * 1e3
    layer.close()
    sched.close()
    total = n_obj * n_parts * part_size
    gib = total / (1 << 30)
    out = {"phase": "config5", "config": "BASELINE.json config 5",
           "objects": n_obj, "parts": n_parts, "part_bytes": part_size,
           "bytes": total, "ec": f"{k}+{m}", "pools": 2,
           "block_size": 1 << 20, "bitrot": "sha256",
           "objects_per_pool": per_pool,
           "parts_wall_s": round(parts_s, 3),
           "upload_gib_s": round(gib / parts_s, 4),
           "complete_s": round(complete_s, 3),
           "get_s": round(get_s, 3), "get_gib_s": round(gib / get_s, 4),
           "degraded_get_s": round(deg_s, 3),
           "degraded_get_gib_s": round(gib / deg_s, 4),
           "drives_gone": gone,
           "encode": enc, "declined": declined,
           "dispatches": on_card, "groups_coalesced": enc["coalesced"],
           "cross_pool_dispatches": cross,
           "digest_rows_sampled": samples[0],
           "shard_digests_checked": files,
           "launches": launched, "healthy_get_launches": healthy,
           "degraded_get_launches": degraded,
           "profiled_again": profiled,
           "codec_step_s": steps, "stagetimer": stages, "card": card}
    emit(out)
    shutil.rmtree(root, ignore_errors=True)
    return out


def run_sse(tmp, card, counts, stagetimer, np) -> dict:
    """BASELINE.json config 2 under SSE-S3 with ChaCha20-Poly1305: 8
    threads each PUT one 16 MiB object at once into a fresh 16-drive 12+4
    set with 1 MiB blocks (highwayhash256S, the batch former and the
    pipelined loop), wired as the S3 handlers wire it
    (minio_tpu/s3/handlers.py:1392-1420): setup_put_transforms with the
    ChaCha20 cipher and the set's device probe, then put_object with the
    DeviceSSE spec; StaticKMS with a 32-byte master key from the seed.
    Every object is read back through resolve_get_key and
    chacha_decrypt_ranged over a fetch that calls get_object
    (handlers.py:1529-1570, :1641-1650): bytes and MD5 ETag. Then three
    ranged reads that start mid-package and cross a 64-package batch,
    eight reads with 3 drives gone (one holds a data shard), the stored
    bytes of one object against ChaChaEncryptor and every trailer tag
    under open_detached, a fetch with one flipped ciphertext byte that
    must fail authentication before any plaintext, submit_decode(sse=)
    over survivors of an encrypted object's blocks, and one SSE-C object.
    The first SSE_PROFILED_STREAMS PUTs then run again at one barrier
    under torch.profiler for the idle share (half of the streams: the
    round is all host Poly1305, and the run's time budget).

    Cut: 128 MiB in 8 objects, a quarter of phase 5's 32 (the run's time:
    the phase is host Poly1305 at ~4 ms a 64 KiB package). Fails unless the former
    coalesced, declined nothing and routed nothing to the host, and
    chacha20 launched once per encrypted encode dispatch and once per GET
    decipher batch, counted per path."""
    import base64
    import io
    import threading

    import torch
    from minio_tpu_torch.bitrot import BitrotAlgorithm
    from minio_tpu_torch.features import crypto as sse
    from minio_tpu_torch.features import kms
    from minio_tpu_torch.object import codec
    from minio_tpu_torch.object.hash_reader import HashReader
    from minio_tpu_torch.ops import chacha20_ref, rs_matrix, rs_ref
    from minio_tpu_torch.parallel.scheduler import BatchScheduler
    from minio_tpu_torch.s3.s3errors import S3Error
    from minio_tpu_torch.storage.datatypes import hash_order
    from minio_tpu_torch.object import ErasureSetObjects
    from minio_tpu_torch.object import engine as eng_mod
    k, m, bs, pkg = 12, 4, 1 << 20, sse.PKG_SIZE
    streams, size = SSE_OBJECTS
    rng = np.random.default_rng(SEED + 11)
    objects = {f"enc-{i:02d}": rng.bytes(size) for i in range(streams)}
    store = kms.StaticKMS(rng.bytes(32))
    root = os.path.join(tmp, "sse")
    paths = [os.path.join(root, f"drive{i}") for i in range(k + m)]
    sched = BatchScheduler()
    eng = eng_mod.from_reference_layout(paths, k, m, block_size=bs,
                                        scheduler=sched,
                                        cls=ErasureSetObjects)
    eng.make_bucket("smoke9")
    left = []
    eng.on_degraded_write = lambda *key: left.append(key)
    no_headers = lambda name, default="": default      # noqa: E731
    mixed, real_run = [], sched._run_erasure

    def run_erasure(key, group, stage_cb):
        """The former's dispatch, watched: the encrypted encode dispatches
        holding rows of more than one object (told apart by key words)."""
        if key[0] == "encode" and group[0].payload is not None:
            mixed.append(len({p.payload[0][0].tobytes() for p in group}))
        return real_run(key, group, stage_cb)

    def put(name, data, prefix="", ssec=None):
        md = {}
        reader, stored, spec = sse.setup_put_transforms(
            key_name=prefix + name,
            raw_reader=HashReader(io.BytesIO(data), len(data)),
            raw_size=len(data), metadata=md, ssec_key=ssec,
            sse_s3=ssec is None, kms=store, compress=False,
            cipher=sse.CIPHER_CHACHA, device_sse=eng.supports_sse_device)
        if spec is None:
            fail(f"SSE PUT {name}: no DeviceSSE spec (the fused path "
                 "declined)")
        return eng.put_object("smoke9", prefix + name, reader, stored,
                              eng_mod.PutOptions(metadata=md, sse_spec=spec))

    def put_all(prefix="", n=None) -> float:
        """The first n objects (all of them by default) PUT at one
        barrier; wall seconds from it to the last return."""
        batch = dict(list(objects.items())[:n])
        start = threading.Barrier(len(batch) + 1, timeout=600)
        errors = []

        def run(name, data):
            try:
                start.wait()
                info = put(name, data, prefix)
                if info.etag != hashlib.md5(data).hexdigest():
                    errors.append(f"{name}: ETag is not the MD5")
            except Exception as e:  # noqa: BLE001 — failed below
                errors.append(f"{name}: {e!r}")

        threads = [threading.Thread(target=run, args=kv)
                   for kv in batch.items()]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        if errors:
            fail(f"SSE PUT: {errors[:3]}")
        return time.perf_counter() - t0

    def fetcher(layer, name, flip_at=None):
        def fetch(off, ln):
            _, it = layer.get_object("smoke9", name, off, ln)
            if flip_at is None or not off <= flip_at < off + ln:
                return it
            buf = bytearray(b"".join(it))
            buf[flip_at - off] ^= 0x01
            return iter([bytes(buf)])
        return fetch

    def get(layer, name, offset=0, length=-1, headers=no_headers):
        info = layer.get_object_info("smoke9", name)
        oek, base = sse.resolve_get_key(info.user_defined, headers, store)
        length = info.actual_size - offset if length < 0 else length
        out = b"".join(sse.chacha_decrypt_ranged(
            fetcher(layer, name), info.size, oek, base, offset, length))
        skip = offset % pkg
        return info, out[skip:skip + length]

    def batches(offset, length) -> int:
        """GET decipher batches of one ranged read."""
        npkg = (offset + length - 1) // pkg - offset // pkg + 1
        return -(-npkg // sse._GET_PKG_BATCH)

    def read_back(layer, names) -> tuple[float, int]:
        t0 = time.perf_counter()
        want = 0
        for name in names:
            info, got = get(layer, name)
            if got != objects[name]:
                fail(f"SSE GET {name}: bytes differ")
            if info.etag != hashlib.md5(objects[name]).hexdigest():
                fail(f"SSE GET {name}: ETag {info.etag} is not the MD5")
            want += batches(0, size)
        return time.perf_counter() - t0, want

    sched._run_erasure = run_erasure
    codec.reset_step_seconds()
    stagetimer.reset()
    stagetimer.enable()
    before = sched.stats()
    counts.zero()
    try:
        put_s = put_all()
    finally:
        stagetimer.disable()
        sched._run_erasure = real_run
    launched = {"put": counts.read()}
    after = sched.stats()
    stages = stage_report(stagetimer)
    steps = codec_steps(codec)
    enc = {key: after["verbs"]["encode"][key]
           - before["verbs"]["encode"][key]
           for key in after["verbs"]["encode"]}
    declined = after["declined"] - before["declined"]
    on_card = enc["batches"] - enc["host_routed"]
    if declined or enc["host_routed"]:
        fail(f"SSE PUT: {declined} declined, {enc['host_routed']} "
             "dispatches routed to the host")
    if enc["coalesced"] <= 0:
        fail(f"SSE PUT: the former never coalesced: {enc}")
    if launched["put"] != {"gf_matmul": on_card, "hh256": on_card,
                           "sha256": 0, "chacha20": on_card,
                           "scan_eval": 0} \
            or steps["encode"]["calls"] != on_card:
        fail(f"SSE PUT: launches {launched['put']}, codec calls "
             f"{steps['encode']['calls']} != {on_card} encode dispatches")
    if enc["blocks"] != streams * size // bs:
        fail(f"SSE PUT: {enc['blocks']} blocks dispatched")

    counts.zero()
    get_s, want = read_back(eng, objects)
    launched["get"] = counts.read()
    if launched["get"]["chacha20"] != want:
        fail(f"SSE GET: {launched['get']['chacha20']} chacha20 launches, "
             f"{want} decipher batches")
    name0 = "enc-00"
    ranges = ((5 * pkg + 777, 70 * pkg), (100 * pkg + 1, 64 * pkg),
              (190 * pkg + 12345, 65 * pkg))
    counts.zero()
    for off, ln in ranges:
        _, got = get(eng, name0, off, ln)
        if got != objects[name0][off:off + ln]:
            fail(f"SSE ranged GET {off}+{ln}: bytes differ")
    launched["ranged"] = counts.read()
    if launched["ranged"]["chacha20"] != sum(batches(*r) for r in ranges):
        fail(f"SSE ranged GET: launches {launched['ranged']}")
    counts.zero()
    settled = heal_left_behind(eng, left)
    launched["left_behind_heal"] = counts.read()

    # 3 drives gone; the first holds data shard 0 of enc-00
    dist = hash_order(f"smoke9/{name0}", k + m)
    gone = [dist.index(1)]
    gone += [i for i in range(k + m) if i not in gone][:2]
    degraded = eng_mod.ErasureObjects(
        [None if i in gone else d for i, d in enumerate(eng.disks)], k, m,
        block_size=bs, scheduler=sched)
    counts.zero()
    deg_names = list(objects)[:8]
    deg_s, want = read_back(degraded, deg_names)
    launched["degraded_get"] = counts.read()
    if launched["degraded_get"]["chacha20"] != want or \
            launched["degraded_get"]["gf_matmul"] <= 0:
        fail(f"SSE degraded GET: launches {launched['degraded_get']}, "
             f"{want} decipher batches")

    # the stored bytes against the host ChaChaEncryptor, every tag opened
    info = eng.get_object_info("smoke9", name0)
    oek, base = sse.resolve_get_key(info.user_defined, no_headers, store)
    stored = b"".join(eng.get_object("smoke9", name0)[1])
    oracle = sse.ChaChaEncryptor(oek, base)
    if stored != oracle.update(objects[name0]) + oracle.finalize():
        fail("SSE: stored bytes differ from ChaChaEncryptor's")
    ct_len, npkg = sse.chacha_ct_len(len(stored))
    for seq in range(npkg):
        got = chacha20_ref.open_detached(
            oek, sse._pkg_nonce(base, seq), sse._pkg_aad(seq),
            stored[seq * pkg:min((seq + 1) * pkg, ct_len)],
            stored[ct_len + seq * 16:ct_len + (seq + 1) * 16])
        if got != objects[name0][seq * pkg:(seq + 1) * pkg]:
            fail(f"SSE: package {seq} opens to other bytes")
    # one flipped ciphertext byte (package 10): an authentication error
    # before any plaintext, and no decipher launch
    counts.zero()
    yielded = []
    try:
        for chunk in sse.chacha_decrypt_ranged(
                fetcher(eng, name0, flip_at=10 * pkg + 99), info.size, oek,
                base, 0, size):
            yielded.append(chunk)
        fail("SSE: a flipped ciphertext byte was not found")
    except S3Error as e:
        if "authentication" not in str(e) or yielded:
            fail(f"SSE corruption: {e!r} after {len(yielded)} chunks")
    if counts.read()["chacha20"]:
        fail("SSE corruption: the batch was deciphered")

    # sse_get_step through the former: survivors of enc-01's first 8
    # encrypted blocks with 3 shards gone
    name1 = "enc-01"
    info1 = eng.get_object_info("smoke9", name1)
    oek1, base1 = sse.resolve_get_key(info1.user_defined, no_headers, store)
    ct = np.frombuffer(b"".join(eng.get_object("smoke9", name1, 0,
                                               8 * bs)[1]), np.uint8)
    cdc = eng.codec(k, m)
    s_len = cdc.shard_size
    full = np.stack([rs_ref.encode(cdc.split(ct[i * bs:(i + 1) * bs]), m)
                     for i in range(8)])
    mask = sum(1 << i for i in range(k + m) if i not in (1, 5, 14))
    _dm, used, _missing = rs_matrix.missing_data_matrix(k, m, mask)
    keys, nonces = sse.DeviceSSE(oek1, base1).batch_params(0, 8, bs)
    counts.zero()
    plain, _idx, _dig = sched.submit_decode(
        cdc, np.ascontiguousarray(full[:, list(used)]), mask, s_len,
        BitrotAlgorithm.HIGHWAYHASH256S, sse=(keys, nonces, pkg)).result()
    launched["sse_get_step"] = counts.read()
    if plain.reshape(8, -1)[:, :bs].tobytes() != objects[name1][:8 * bs]:
        fail("sse_get_step: deciphered blocks differ from the plaintext")
    if launched["sse_get_step"] != {"gf_matmul": 1, "hh256": 1,
                                    "sha256": 0, "chacha20": 1,
                                    "scan_eval": 0}:
        fail(f"sse_get_step: launches {launched['sse_get_step']}")

    # SSE-C: one object with a short tail (ciphered on the host)
    ckey = rng.bytes(32)
    hdr = {"x-amz-server-side-encryption-customer-algorithm": "AES256",
           "x-amz-server-side-encryption-customer-key":
               base64.b64encode(ckey).decode(),
           "x-amz-server-side-encryption-customer-key-md5":
               base64.b64encode(hashlib.md5(ckey).digest()).decode()}
    headers = lambda name, default="": hdr.get(name, default)  # noqa: E731
    # one full encode batch (8 blocks, over the codec's size gate) and a
    # short tail
    data_c = rng.bytes(8 * bs + 12345)
    before = sched.stats()["verbs"]["encode"]
    counts.zero()
    put("ssec", data_c, ssec=sse.parse_ssec_headers(headers))
    info_c, got = get(eng, "ssec", headers=headers)
    launched["ssec"] = counts.read()
    after = sched.stats()["verbs"]["encode"]
    enc_c = after["batches"] - before["batches"] \
        - (after["host_routed"] - before["host_routed"])
    if got != data_c or info_c.user_defined.get(sse.MK_SSE) != "C":
        fail("SSE-C: GET differs")
    if enc_c < 1 or launched["ssec"]["chacha20"] != \
            enc_c + batches(0, len(data_c)):
        fail(f"SSE-C: launches {launched['ssec']}, {enc_c} encode "
             "dispatches on the card")

    # Poly1305 on the host, timed apart on this thread (one core) over
    # 64 packages, against the phase's package count
    sample = [objects[name0][i * pkg:(i + 1) * pkg] for i in range(64)]
    t0 = time.perf_counter()
    for i, p in enumerate(sample):
        chacha20_ref.tag_detached(oek, sse._pkg_nonce(base, i),
                                  sse._pkg_aad(i), p)
    tag_ms = (time.perf_counter() - t0) * 1e3 / len(sample)
    put_pkgs = streams * size // pkg
    get_pkgs = put_pkgs + len(deg_names) * size // pkg

    # the profiled round at half of the streams (the run's time budget;
    # the idle share is that round's)
    profiled = device_busy(
        torch, lambda: put_all("again/", SSE_PROFILED_STREAMS), counts)
    profiled["streams"] = SSE_PROFILED_STREAMS
    sched.close()
    gib = streams * size / (1 << 30)
    totals = {n: sum(v[n] for v in launched.values())
              for n in launched["put"]}
    out = {"phase": "sse", "config": "BASELINE.json config 2 under SSE-S3 "
           "(ChaCha20-Poly1305 packages)",
           "streams": streams, "object_bytes": size, "ec": f"{k}+{m}",
           "block_size": bs, "package_bytes": pkg,
           "put_wall_s": round(put_s, 3),
           "upload_gib_s": round(gib / put_s, 4),
           "get_s": round(get_s, 3), "get_gib_s": round(gib / get_s, 4),
           "degraded_get_s": round(deg_s, 3),
           "degraded_get_gib_s": round(len(deg_names) * size / (1 << 30)
                                       / deg_s, 4),
           "missing_drives": gone, "left_behind": settled,
           "encode": enc, "declined": declined,
           "dispatches": on_card,
           "dispatches_with_several_objects": sum(1 for n in mixed
                                                  if n > 1),
           "objects_per_dispatch_max": max(mixed) if mixed else 0,
           "launches": totals, "launches_by_subpath": launched,
           "poly1305_ms_per_package_one_core": round(tag_ms, 4),
           "poly1305_host_s_put_packages": round(tag_ms * put_pkgs / 1e3,
                                                 3),
           "poly1305_host_s_get_packages": round(tag_ms * get_pkgs / 1e3,
                                                 3),
           "put_packages": put_pkgs, "get_packages": get_pkgs,
           "profiled_again": profiled, "codec_step_s": steps,
           "stagetimer": stages, "card": card}
    emit(out)
    shutil.rmtree(root, ignore_errors=True)
    return out


def at_barrier(jobs: dict) -> tuple[float, dict, list]:
    """Run every job of {name: fn()} on its own thread, released at one
    barrier; (wall seconds from the barrier to the last return, results,
    errors)."""
    import threading
    start = threading.Barrier(len(jobs) + 1, timeout=600)
    out, errors = {}, []

    def run(name, fn):
        try:
            start.wait()
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 — failed by the caller
            errors.append(f"{name}: {e!r}")

    threads = [threading.Thread(target=run, args=kv) for kv in jobs.items()]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, out, errors


def run_s3(tmp, card, counts, stagetimer, np) -> dict:
    """The port's server on the card, driven by signed HTTP requests from
    this process (see S3_* for the cuts): cluster.start_single over 16
    fresh drives at 12+4, 1 MiB blocks, highwayhash256S, the default edge
    transport, MINIO_SSE_MASTER_KEY and the ChaCha20 cipher set before
    boot. BASELINE.json config 2 over HTTP (32 concurrent signed PUTs of
    16 MiB, two rounds reported apart, then their GETs), a listing, three
    ranged GETs and a HEAD; one aws-chunked streaming-signed PUT; one
    multipart upload of 2 x 64 MiB + a 12,345-byte tail; config 3's shape
    cut (eight 4 MiB objects read back by 8 clients at once with the
    bucket gone from 3 drives) and one degraded 64 MiB GET whose decode
    batch passes the codec's gate alone; SSE-S3 and SSE-C objects and an
    SSE-S3 multipart object, read whole and then in ranges by clients
    released at one barrier, and one flipped ciphertext byte (its shard's
    frame digest rewritten, so only Poly1305 can see it) that must fail
    the GET before any plaintext; the 32-PUT round again under
    torch.profiler. Every kernel's launches must equal the former's
    dispatches of its verbs on the card (chacha20: the encrypted encode
    and decode ones, plus the GET decipher ones, which must have
    deciphered exactly the packages the GETs cover). Then the CLI,
    `python3 -m minio_tpu_torch server`, as a subprocess on the card: a
    signed ListBuckets, a 64 MiB PUT and GET, SIGTERM, exit 0."""
    import base64
    import collections
    import re
    import signal
    import socket
    import xml.etree.ElementTree as ET

    import torch
    from minio_tpu_torch import cluster
    from minio_tpu_torch.bitrot import BitrotAlgorithm, hash_shard
    from minio_tpu_torch.features import crypto as sse
    from minio_tpu_torch.parallel import pipeline as pl
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.storage.datatypes import hash_order
    k, m, bs = 12, 4, 1 << 20
    pkg = sse.PKG_SIZE
    rng = np.random.default_rng(SEED + 13)
    creds = Credentials("smokeadmin", "smokeadminsecret")
    os.environ["MINIO_SSE_MASTER_KEY"] = rng.bytes(32).hex()
    os.environ["MINIO_TPU_SSE_CIPHER"] = "chacha20"
    root = os.path.join(tmp, "s3")
    drives = [os.path.join(root, f"d{i}") for i in range(k + m)]
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    node = cluster.start_single(drives, creds=creds, parity=m,
                                set_drive_count=k + m, block_size=bs)
    boot_s = time.perf_counter() - t0
    if not node.s3.edge_enabled:
        fail("s3: the server did not take the edge transport")
    sched = node.scheduler
    c = S3Client(node.s3.port, creds)
    out = {"phase": "s3", "drives": k + m, "ec": f"{k}+{m}",
           "block_size": bs, "transport": "edge",
           "boot_s": round(boot_s, 3),
           "admission_capacity": node.s3.api.admission.capacity,
           "staging_buffers_per_ring": pl.POOL_BUFFERS}

    # on-card dispatches by (verb, encrypted); the counts must match them
    on_card = collections.Counter()
    real_run, real_decipher = sched._run_erasure, sched._run_decipher

    def run_erasure(key, group, stage_cb):
        res = real_run(key, group, stage_cb)
        if res is not None:
            on_card[(key[0], key[-1] is not None and "sse" in key[-1])] \
                += 1
        return res

    def run_decipher(key, group, stage_cb):
        res = real_decipher(key, group, stage_cb)
        on_card[("decipher", True)] += 1
        return res

    def ok(resp, what, status=200):
        if resp[0] != status:
            fail(f"s3 {what}: HTTP {resp[0]} {resp[2][:300]!r}")
        return resp

    def decode_stats() -> dict:
        return dict(sched.stats()["verbs"]["decode"])

    sched._run_erasure, sched._run_decipher = run_erasure, run_decipher
    counts.zero()
    before = sched.stats()
    get_packages = 0         # packages the SSE GETs must decipher

    def packages(offset, length) -> int:
        return (offset + length - 1) // pkg - offset // pkg + 1

    # -- BASELINE.json config 2 over HTTP ----------------------------------
    streams, size = S3_PUTS
    objects = {f"put-{i:02d}": rng.bytes(size) for i in range(streams)}
    ok(c.send("PUT", "/smoke"), "make bucket")

    def put_round(prefix) -> float:
        signed = {n: c.sign("PUT", f"/smoke/{prefix}{n}", body=d)
                  for n, d in objects.items()}
        wall, res, errors = at_barrier({
            n: (lambda n=n, d=d: c.send("PUT", f"/smoke/{prefix}{n}",
                                        body=d, signed=signed[n]))
            for n, d in objects.items()})
        if errors:
            fail(f"s3 PUT round {prefix!r}: {errors[:3]}")
        for n, d in objects.items():
            if res[n][0] != 200 or \
                    res[n][1].get("etag") != f'"{hashlib.md5(d).hexdigest()}"':
                fail(f"s3 PUT {prefix}{n}: {res[n][0]} {res[n][1]}")
        return wall

    gib = streams * size / (1 << 30)
    stagetimer.reset()
    stagetimer.enable()
    walls = [put_round("r1/"), put_round("r2/")]
    stagetimer.disable()
    out["config2"] = {
        "streams": streams, "object_bytes": size,
        "upload_wall_s": [round(w, 3) for w in walls],
        "upload_gib_s_first_round": round(gib / walls[0], 4),
        "upload_gib_s_second_round": round(gib / walls[1], 4),
        "stagetimer": stage_report(stagetimer)}
    wall, res, errors = at_barrier({
        n: (lambda n=n: c.send("GET", f"/smoke/r1/{n}"))
        for n in objects})
    if errors:
        fail(f"s3 GET: {errors[:3]}")
    for n, d in objects.items():
        st, h, body = res[n]
        if st != 200 or body != d or \
                h.get("etag") != f'"{hashlib.md5(d).hexdigest()}"':
            fail(f"s3 GET {n}: status {st}, bytes or ETag differ")
    out["config2"]["get_wall_s"] = round(wall, 3)
    out["config2"]["get_gib_s"] = round(gib / wall, 4)
    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    listing = ET.fromstring(ok(c.send("GET", "/smoke", query={
        "list-type": "2", "prefix": "r1/"}), "ListObjectsV2")[2])
    keys = [e.text for e in listing.iter(f"{ns}Key")]
    if keys != [f"r1/{n}" for n in sorted(objects)]:
        fail(f"s3 ListObjectsV2: {keys[:4]}...")
    d0 = objects["put-00"]
    for a, b in ((0, 0), (size // 16 + 5, size // 4 + 77),
                 (size - 12345, size - 1)):
        st, h, body = c.send("GET", "/smoke/r1/put-00",
                             headers={"range": f"bytes={a}-{b}"})
        if st != 206 or body != d0[a:b + 1] or \
                h.get("content-range") != f"bytes {a}-{b}/{size}":
            fail(f"s3 ranged GET {a}-{b}: {st} {h.get('content-range')}")
    st, h, _ = c.send("HEAD", "/smoke/r1/put-00")
    if st != 200 or h.get("content-length") != str(size) or \
            h.get("etag") != f'"{hashlib.md5(d0).hexdigest()}"':
        fail(f"s3 HEAD: {st} {h}")

    # -- one streaming-signed PUT; one multipart upload --------------------
    data_s = rng.bytes(size + 12345)
    ok(c.streaming_put("/smoke/streamed", data_s), "streaming PUT")
    if ok(c.send("GET", "/smoke/streamed"), "streamed GET")[2] != data_s:
        fail("s3 streaming PUT: bytes differ")
    n_full, part_bytes, tail = S3_PARTS
    parts = [rng.bytes(part_bytes) for _ in range(n_full)]
    parts.append(rng.bytes(tail))
    upload = re.search(rb"<UploadId>([^<]+)</UploadId>", ok(c.send(
        "POST", "/smoke/mp", query={"uploads": ""}), "create upload")[2])
    upload = upload[1].decode()
    etags = [ok(c.send("PUT", "/smoke/mp", body=p, query={
        "uploadId": upload, "partNumber": str(i + 1)}),
        f"part {i + 1}")[1]["etag"] for i, p in enumerate(parts)]
    done = ok(c.send("POST", "/smoke/mp", query={"uploadId": upload},
                     body=("<CompleteMultipartUpload>" + "".join(
                         f"<Part><PartNumber>{i + 1}</PartNumber>"
                         f"<ETag>{e}</ETag></Part>"
                         for i, e in enumerate(etags))
                         + "</CompleteMultipartUpload>").encode()),
              "complete upload")[2]
    want = hashlib.md5(b"".join(hashlib.md5(p).digest()
                                for p in parts)).hexdigest()
    if f"{want}-{len(parts)}".encode() not in done:
        fail(f"s3 multipart ETag: {done[:300]!r}")
    if ok(c.send("GET", "/smoke/mp"), "multipart GET")[2] != b"".join(parts):
        fail("s3 multipart GET: bytes differ")

    # -- config 3's shape, cut: degraded GETs --------------------------------
    n_deg, deg_size = S3_DEGRADED
    deg = {f"deg-{i}": rng.bytes(deg_size) for i in range(n_deg)}
    deg["big"] = rng.bytes(S3_BIG)
    ok(c.send("PUT", "/deg"), "make bucket deg")
    for n, d in deg.items():
        ok(c.send("PUT", f"/deg/{n}", body=d), f"PUT deg/{n}")
    # a shard write the quorum-ack lane left behind heals through MRF
    # before the drives go
    if not node.object_layer.drain_mrf(timeout=120):
        fail("s3: the MRF queue did not drain before the degraded GETs")
    gone = [0, 1, 2]
    for i in gone:
        shutil.rmtree(os.path.join(drives[i], "deg"))
    d_before = decode_stats()
    wall, res, errors = at_barrier({
        n: (lambda n=n: c.send("GET", f"/deg/{n}"))
        for n in deg if n != "big"})
    if errors or any(res[n][0] != 200 or res[n][2] != deg[n] for n in res):
        fail(f"s3 degraded GETs: {errors[:3]}")
    d_mid = decode_stats()
    groups = {key: d_mid[key] - d_before[key] for key in d_mid}
    gf_before = counts.read()["gf_matmul"]
    ok_big = ok(c.send("GET", "/deg/big"), "degraded GET big")
    d_after = decode_stats()
    big_card = (d_after["batches"] - d_mid["batches"]) - \
        (d_after["host_routed"] - d_mid["host_routed"])
    if ok_big[2] != deg["big"]:
        fail("s3 degraded GET of the 64 MiB object: bytes differ")
    if big_card <= 0 or counts.read()["gf_matmul"] <= gf_before:
        fail(f"s3 degraded 64 MiB GET: {big_card} decode dispatches on "
             "the card")
    out["degraded"] = {
        "objects": n_deg, "object_bytes": deg_size, "missing_drives": gone,
        "concurrent_get_wall_s": round(wall, 3),
        "concurrent_get_gib_s": round(n_deg * deg_size / (1 << 30) / wall,
                                      4),
        "decode_groups_on_card": groups["batches"] - groups["host_routed"],
        "decode_groups_on_host": groups["host_routed"],
        "decode_groups_coalesced": groups["coalesced"],
        "big_object_bytes": S3_BIG, "big_decode_dispatches_on_card":
            big_card}

    # -- SSE over HTTP -------------------------------------------------------
    n_enc, enc_size = S3_SSE
    ssec_key = rng.bytes(32)
    ssec = {"x-amz-server-side-encryption-customer-algorithm": "AES256",
            "x-amz-server-side-encryption-customer-key":
                base64.b64encode(ssec_key).decode(),
            "x-amz-server-side-encryption-customer-key-md5":
                base64.b64encode(hashlib.md5(ssec_key).digest()).decode()}
    s3h = {"x-amz-server-side-encryption": "AES256"}
    enc = {f"enc-{i}": (rng.bytes(enc_size), s3h) for i in range(n_enc)}
    enc["enc-c"] = (rng.bytes(enc_size), ssec)
    ok(c.send("PUT", "/enc"), "make bucket enc")
    t0 = time.perf_counter()
    for n, (d, h) in enc.items():
        got = ok(c.send("PUT", f"/enc/{n}", body=d, headers=h),
                 f"SSE PUT {n}")[1]
        if got.get("etag") != f'"{hashlib.md5(d).hexdigest()}"':
            fail(f"s3 SSE PUT {n}: ETag {got.get('etag')}")
    sse_put_s = time.perf_counter() - t0
    n_mp, mp_part = S3_SSE_PARTS
    mp_parts = [rng.bytes(mp_part) for _ in range(n_mp)]
    upload = re.search(rb"<UploadId>([^<]+)</UploadId>", ok(c.send(
        "POST", "/enc/mp", query={"uploads": ""}, headers=s3h),
        "SSE create upload")[2])[1].decode()
    etags = [ok(c.send("PUT", "/enc/mp", body=p, query={
        "uploadId": upload, "partNumber": str(i + 1)}),
        f"SSE part {i + 1}")[1]["etag"] for i, p in enumerate(mp_parts)]
    ok(c.send("POST", "/enc/mp", query={"uploadId": upload},
              body=("<CompleteMultipartUpload>" + "".join(
                  f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}"
                  "</ETag></Part>" for i, e in enumerate(etags))
                  + "</CompleteMultipartUpload>").encode()),
       "SSE complete upload")
    enc["mp"] = (b"".join(mp_parts), {})

    def mp_packages(offset, length) -> int:
        """Packages of a ranged read over the SSE parts (each part is its
        own package stream)."""
        total, start = 0, 0
        for p in mp_parts:
            lo, hi = max(offset, start), min(offset + length,
                                             start + len(p))
            if lo < hi:
                total += packages(lo - start, hi - lo)
            start += len(p)
        return total

    # every object read whole by its own client, then every range, each
    # set released at one barrier: their decipher groups meet in the former
    wall, res, errors = at_barrier({
        n: (lambda n=n, h=h: c.send("GET", f"/enc/{n}", headers=h))
        for n, (_d, h) in enc.items()})
    if errors:
        fail(f"s3 SSE GETs: {errors[:3]}")
    for n, (d, h) in enc.items():
        if res[n][0] != 200 or res[n][2] != d:
            fail(f"s3 SSE GET {n}: {res[n][0]}, bytes differ")
        get_packages += mp_packages(0, len(d)) if n == "mp" else \
            packages(0, len(d))
    sse_get_s = wall
    ranges = ((5 * pkg + 777, 70 * pkg), (100 * pkg + 1, 64 * pkg),
              (enc_size - 3 * pkg - 5, 3 * pkg + 5))
    ranged = {}
    for n in ("enc-0", "enc-c", "mp"):
        for i, (off, ln) in enumerate(ranges):
            if n == "mp":
                off, ln = mp_part - 2 * pkg - 9 + i * 7 * pkg, 4 * pkg
            ranged[(n, off, ln)] = enc[n][1]
    wall_r, res, errors = at_barrier({
        r: (lambda r=r, h=h: c.send("GET", f"/enc/{r[0]}", headers={
            **h, "range": f"bytes={r[1]}-{r[1] + r[2] - 1}"}))
        for r, h in ranged.items()})
    if errors:
        fail(f"s3 SSE ranged GETs: {errors[:3]}")
    for (n, off, ln) in ranged:
        d = enc[n][0]
        st, hh, body = res[(n, off, ln)]
        if st != 206 or body != d[off:off + ln] or \
                hh.get("content-range") != \
                f"bytes {off}-{off + ln - 1}/{len(d)}":
            fail(f"s3 SSE ranged GET {n} {off}+{ln}: {st}")
        get_packages += mp_packages(off, ln) if n == "mp" else \
            packages(off, ln)
    # one flipped ciphertext byte in package 10 of enc-1: its data shard's
    # frame digest is rewritten, so the erasure layer serves the flipped
    # byte and only the package's Poly1305 tag can see it
    name = "enc-1"
    at = 10 * pkg + 99
    shard = at // (-(-bs // k))
    dist = hash_order(f"enc/{name}", k + m)
    drive = drives[dist.index(shard + 1)]
    part = [os.path.join(dp, f) for dp, _d, fs in
            os.walk(os.path.join(drive, "enc", name))
            for f in fs if f.startswith("part.")][0]
    with open(part, "r+b") as fh:
        frame = bytearray(fh.read(32 + -(-bs // k)))
        frame[32 + at - shard * -(-bs // k)] ^= 0x01
        frame[:32] = hash_shard(bytes(frame[32:]),
                                BitrotAlgorithm.HIGHWAYHASH256S)
        fh.seek(0)
        fh.write(frame)
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", node.s3.port,
                                      timeout=120)
    conn.request("GET", f"/enc/{name}", headers=c.sign("GET",
                                                       f"/enc/{name}"))
    resp = conn.getresponse()
    try:
        leaked = resp.read()
    except http.client.IncompleteRead as e:
        leaked = e.partial
    else:
        fail("s3 SSE: a flipped ciphertext byte was served")
    finally:
        conn.close()
    if leaked:
        fail(f"s3 SSE: {len(leaked)} bytes left before the tag failed")
    out["sse"] = {
        "objects": {n: len(d) for n, (d, _h) in enc.items()},
        "put_s": round(sse_put_s, 3),
        "put_gib_s": round((n_enc + 1) * enc_size / (1 << 30) / sse_put_s,
                           4),
        "get_s": round(sse_get_s, 3),
        "get_gib_s": round(sum(len(d) for d, _h in enc.values())
                           / (1 << 30) / sse_get_s, 4),
        "clients": len(enc), "ranged_clients": len(ranged),
        "ranged_get_s": round(wall_r, 3),
        "flipped_byte": {"object": name, "offset": at,
                         "status": resp.status, "plaintext_bytes": 0}}

    # -- the 32-PUT round again under the profiler ---------------------------
    out["profiled_again"] = device_busy(torch, lambda: put_round("again/"), counts)
    if not node.object_layer.drain_mrf(timeout=120):
        fail("s3: the MRF queue did not drain")
    launched = counts.read()
    sched._run_erasure, sched._run_decipher = real_run, real_decipher
    after = sched.stats()
    node.shutdown()
    verbs = {v: {key: after["verbs"][v][key] - before["verbs"][v][key]
                 for key in after["verbs"][v]} for v in after["verbs"]}
    card_total = sum(on_card.values())
    if card_total != sum(v["batches"] - v["host_routed"]
                         for v in verbs.values()):
        fail(f"s3: watched dispatches {dict(on_card)} != {verbs}")
    sse_card = sum(n for (_v, enc_), n in on_card.items() if enc_)
    erasure_card = card_total - on_card[("decipher", True)]
    if launched != {"gf_matmul": erasure_card, "hh256": erasure_card,
                    "sha256": 0, "chacha20": sse_card, "scan_eval": 0} \
            or min(launched["gf_matmul"], launched["chacha20"],
                   on_card[("decipher", True)]) <= 0:
        fail(f"s3: launches {launched}; {card_total} dispatches on the card "
             f"({sse_card} encrypted, {on_card[('decipher', True)]} GET "
             "decipher)")
    if verbs["decipher"]["blocks"] != get_packages:
        fail(f"s3: the former deciphered {verbs['decipher']['blocks']} "
             f"packages; the SSE GETs cover {get_packages}")
    out.update({"verbs": verbs, "launches": launched,
                "dispatches_on_card": {f"{v}{'+sse' if e else ''}": n
                                       for (v, e), n in on_card.items()},
                "get_decipher_packages": get_packages})

    # -- the CLI -------------------------------------------------------------
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MINIO_ACCESS_KEY=creds.access_key,
               MINIO_SECRET_KEY=creds.secret_key)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch", "server",
         os.path.join(tmp, "cli", "e{1...16}"), "--address",
         f"127.0.0.1:{port}"], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cc = S3Client(port, creds)
        deadline = time.monotonic() + 180
        while True:
            if proc.poll() is not None:
                fail(f"s3 CLI exited {proc.returncode}: "
                     f"{proc.stderr.read()[-2000:]}")
            try:
                if cc.send("GET", "/")[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                fail("s3 CLI: no answer within 180 s")
            time.sleep(0.5)
        up_s = time.perf_counter() - t0
        big = rng.bytes(S3_BIG)
        ok(cc.send("PUT", "/cli"), "CLI make bucket")
        got = ok(cc.send("PUT", "/cli/big", body=big), "CLI PUT")[1]
        if got.get("etag") != f'"{hashlib.md5(big).hexdigest()}"' or \
                ok(cc.send("GET", "/cli/big"), "CLI GET")[2] != big:
            fail("s3 CLI: the 64 MiB object came back different")
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        fail(f"s3 CLI: exit {proc.returncode} after SIGTERM: "
             f"{stderr[-2000:]}")
    out["cli"] = {"banner": stdout.strip().splitlines(),
                  "answered_after_s": round(up_s, 3), "exit_code": 0}
    out["seconds"] = round(time.perf_counter() - t_phase, 3)
    out["card"] = card
    emit(out)
    shutil.rmtree(root, ignore_errors=True)
    return out


def select_oracle(expr: str, data: bytes, compression: str = "NONE"
                  ) -> tuple[bytes, float]:
    """The port's CPU evaluator's framed stream of a CSV Select
    (s3select.select.event_stream) and its seconds: phase 11's oracle, run
    in worker processes while the server works."""
    sys.path.insert(0, HERE)
    from minio_tpu_torch.s3select.select import event_stream
    from minio_tpu_torch.scripts import scan_cases
    t0 = time.perf_counter()
    body = b"".join(event_stream(
        scan_cases.request(expr, compression=compression), data))
    return body, time.perf_counter() - t0


def run_select(tmp, card, counts, stagetimer, np
               ) -> tuple[dict, bytes, bytes, bytes]:
    """S3 Select on the card over HTTP: the port's server (booted as in
    phase 10: cluster.start_single over 16 fresh drives at 12+4, 1 MiB
    blocks, the edge transport) holding TPC-H lineitem as CSV
    (scripts/scan_cases.lineitem_csv: the spec's column domains, 16
    columns; SELECT_ROWS rows under MINIO_TPU_SCAN_MAX_BYTES, the cut from
    SF 0.1's 600,572), queried as S3 Select pushdown runs TPC-H (PushdownDB,
    ICDE 2020): Q6's predicate with COUNT(*), and with a projection; a
    contains-LIKE over l_comment (MinIO's documented Select shape); eight
    clients released at one barrier, each running the COUNT on its own
    8,000-row object (4 pages each: the eight fit one batch of the
    former's 32 blocks), which must take fewer than 8 scan dispatches at
    the former's default window (printed beside the reference's 0.4 s); a 4
    MiB SSE-S3 object (chacha20 deciphers, then scan_eval scans); one
    query the plan declines (SUM, counted as "aggregate"). Every response
    must equal the host evaluator's framed stream over the same bytes
    (computed in worker processes meanwhile); scan_eval's launches must
    equal the former's scan dispatches, and the engine's device serves
    rise by the device-served count. Prints the Select walls, rows/s and
    CSV MiB/s, the stage seconds (GET, rows, pages, dispatch, emit) and a
    profiled COUNT round. Returns (the phase's line, the lineitem CSV, its
    first NS_SELECT_BYTES in whole rows, and the evaluator's framed stream
    of Q6's COUNT over those)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from minio_tpu_torch import cluster
    from minio_tpu_torch.ops import scan_cuda
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.scan import engine as scan_engine
    from minio_tpu_torch.scripts import scan_cases as sc
    k, m, bs = 12, 4, 1 << 20
    rng = np.random.default_rng(SEED + 17)
    os.environ["MINIO_SSE_MASTER_KEY"] = rng.bytes(32).hex()
    os.environ["MINIO_TPU_SSE_CIPHER"] = "chacha20"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    big = sc.lineitem_csv(SELECT_ROWS, SEED)
    small = {f"part-{i}": sc.lineitem_csv(SELECT_SMALL_ROWS, SEED + 1 + i)
             for i in range(SELECT_CLIENTS)}
    sse_data = sc.lineitem_csv(SELECT_SSE_ROWS, SEED + 99)
    head = big[:big.index(b"\n", NS_SELECT_BYTES) + 1]
    gen_s = time.perf_counter() - t0
    if len(big) > scan_engine.MAX_SCAN_BYTES:
        fail(f"select: {len(big)} B of lineitem exceed the device cap "
             f"{scan_engine.MAX_SCAN_BYTES}")
    queries = {"q6_count": sc.Q6_COUNT, "q6_rows": sc.Q6_ROWS,
               "like": sc.LIKE_QUERY}
    ctx = multiprocessing.get_context("spawn")
    root = os.path.join(tmp, "select")
    drives = [os.path.join(root, f"d{i}") for i in range(k + m)]
    creds = Credentials("smokeselect", "smokeselectsecret")
    with ProcessPoolExecutor(max_workers=4, mp_context=ctx) as pool:
        oracles = {n: pool.submit(select_oracle, e, big)
                   for n, e in queries.items()}
        oracles.update({n: pool.submit(select_oracle, sc.Q6_COUNT, d)
                        for n, d in small.items()})
        oracles["sse"] = pool.submit(select_oracle, sc.Q6_COUNT, sse_data)
        oracles["declined"] = pool.submit(select_oracle, sc.SUM_QUERY,
                                          small["part-0"])
        head_oracle = pool.submit(select_oracle, sc.Q6_COUNT, head)
        node = cluster.start_single(drives, creds=creds, parity=m,
                                    set_drive_count=k + m, block_size=bs)
        try:
            out = run_select_on(node, S3Client(node.s3.port, creds), big,
                                small, sse_data, queries, oracles, counts,
                                stagetimer, torch, scan_cuda)
        finally:
            node.shutdown()
        head_q6 = head_oracle.result()[0]
    out.update({"lineitem_rows": SELECT_ROWS, "lineitem_bytes": len(big),
                "device_cap_bytes": scan_engine.MAX_SCAN_BYTES,
                "generate_s": round(gen_s, 3),
                "seconds": round(time.perf_counter() - t_phase, 3),
                "card": card})
    emit(out)
    shutil.rmtree(root, ignore_errors=True)
    return out, big, head, head_q6


def run_select_on(node, c, big, small, sse_data, queries, oracles, counts,
                  stagetimer, torch, scan_cuda) -> dict:
    import re

    from minio_tpu_torch.scripts import scan_cases as sc
    sched, eng = node.scheduler, node.s3.api.scan
    sel_q = {"select": "", "select-type": "2"}

    def ok(resp, what, status=200):
        if resp[0] != status:
            fail(f"select {what}: HTTP {resp[0]} {resp[2][:300]!r}")
        return resp

    def select(key, expr):
        return c.send("POST", f"/lineitem/{key}", query=sel_q,
                      body=sc.select_xml(expr))

    def scan_stats() -> dict:
        return dict(sched.stats()["verbs"]["scan"])

    ok(c.send("PUT", "/lineitem"), "make bucket")
    t0 = time.perf_counter()
    ok(c.send("PUT", "/lineitem/big.csv", body=big), "PUT lineitem")
    put_s = time.perf_counter() - t0
    for n, d in small.items():
        ok(c.send("PUT", f"/lineitem/{n}.csv", body=d), f"PUT {n}")
    ok(c.send("PUT", "/lineitem/sse.csv", body=sse_data,
              headers={"x-amz-server-side-encryption": "AES256"}),
       "PUT SSE-S3")
    out = {"phase": "select", "drives": len(node.spec.drives),
           "ec": f"{node.set_drive_count - node.parity}+{node.parity}",
           "put_s": round(put_s, 3)}
    before, served0 = scan_stats(), eng.stats()
    counts.zero()
    stagetimer.reset()
    stagetimer.enable()
    walls, bodies = {}, {}
    for n, expr in queries.items():
        t0 = time.perf_counter()
        bodies[n] = ok(select("big.csv", expr), n)[2]
        walls[n] = time.perf_counter() - t0
    stagetimer.disable()
    stages = stage_report(stagetimer)["stages"]
    big_launches = counts.read()
    # eight clients at one barrier, each its own 8,000-row object: once at
    # the former's default grace window, then at the reference's own
    # coalescing setting (tests/test_scan.py: 0.4 s), where the bucket
    # dispatches as soon as the eight have filled its 32 blocks
    concurrent, rounds8 = {}, []
    for window in (sched.max_wait, SELECT_WINDOW_S):
        default_wait, sched.max_wait = sched.max_wait, window
        mid = scan_stats()
        wall8, res8, errors = at_barrier({
            n: (lambda n=n: select(f"{n}.csv", sc.Q6_COUNT))
            for n in small})
        sched.max_wait = default_wait
        if errors:
            fail(f"select concurrent: {errors[:3]}")
        after8 = scan_stats()
        concurrent[f"window_{window * 1e3:g}ms"] = {
            "clients": len(small), "wall_s": round(wall8, 3),
            "scan_dispatches": after8["batches"] - mid["batches"],
            "pages": after8["blocks"] - mid["blocks"],
            "coalesced": after8["coalesced"] - mid["coalesced"]}
        rounds8.append({n: r[2] for n, r in res8.items()})
    # the shipped window must coalesce; the reference's setting is printed
    # beside it
    dispatches8 = concurrent[f"window_{sched.max_wait * 1e3:g}ms"][
        "scan_dispatches"]
    if dispatches8 >= len(small):
        fail(f"select: {len(small)} concurrent Selects took {dispatches8} "
             f"scan dispatches at the former's default window")
    # the SSE object: chacha20 deciphers on the card, then scan_eval scans
    pre = counts.read()
    t0 = time.perf_counter()
    sse_body = ok(select("sse.csv", sc.Q6_COUNT), "SSE Select")[2]
    sse_s = time.perf_counter() - t0
    post = counts.read()
    sse_launches = {n: post[n] - pre[n] for n in post}
    if sse_launches["chacha20"] < 1 or sse_launches["scan_eval"] != 1:
        fail(f"select SSE: launches {sse_launches}")
    # a query the plan declines
    declined = ok(select("part-0.csv", sc.SUM_QUERY), "declined")[2]
    launched = counts.read()
    after = scan_stats()
    served = eng.stats()
    # oracles, computed by the worker processes meanwhile
    got = {**bodies, "sse": sse_body, "declined": declined}
    oracle_s = {}
    for n, fut in oracles.items():
        want, secs = fut.result()
        oracle_s[n] = round(secs, 3)
        for resp in [got.get(n)] + [r.get(n) for r in rounds8]:
            if resp is not None and resp != want:
                fail(f"select {n}: the response is not the evaluator's "
                     f"bytes ({len(resp)} B against {len(want)} B)")
    dispatches = after["batches"] - before["batches"]
    if launched["scan_eval"] != dispatches or dispatches < 1 or \
            after["host_routed"] != before["host_routed"]:
        fail(f"select: scan_eval launched {launched['scan_eval']} times "
             f"for {dispatches} scan dispatches")
    device_served = len(queries) + len(rounds8) * len(small) + 1
    if served["device_serves"] - served0["device_serves"] != \
            device_served or served["fallback_reasons"].get("aggregate", 0) \
            - served0["fallback_reasons"].get("aggregate", 0) != 1 or \
            served["fallbacks"] - served0["fallbacks"] != 1:
        fail(f"select: engine {served} (before {served0})")
    # one profiled COUNT round
    profiled = device_busy(torch, lambda: ok(
        select("big.csv", sc.Q6_COUNT), "profiled"), counts)
    rows = SELECT_ROWS
    mib = len(big) / (1 << 20)
    out.update({
        "select_wall_s": {n: round(w, 3) for n, w in walls.items()},
        "rows_per_s": {n: round(rows / w, 1) for n, w in walls.items()},
        "csv_mib_per_s": {n: round(mib / w, 3) for n, w in walls.items()},
        "stage_s": {n: v for n, v in stages.items()
                    if n.startswith("select.")},
        "big_launches": big_launches,
        "concurrent": concurrent,
        "sse": {"bytes": len(sse_data), "wall_s": round(sse_s, 3),
                "launches": sse_launches},
        "scan_dispatches": dispatches, "launches": launched,
        "device_serves": served["device_serves"] - served0["device_serves"],
        "fallback_reasons": {
            r: n - served0["fallback_reasons"].get(r, 0)
            for r, n in served["fallback_reasons"].items()
            if n != served0["fallback_reasons"].get(r, 0)},
        "oracle_s": oracle_s, "profiled": profiled,
        "q6_count": int(re.search(rb"octet-stream(\d+)\n",
                                  bodies["q6_count"])[1])})
    return out


def csv_objects(base: bytes, n: int, size: int, offset: int = 0
                ) -> list[bytes]:
    """`n` distinct CSV objects of exactly `size` bytes from one lineitem
    CSV: each keeps the header row and starts its rows at its own row of
    `base` (the rows rotated), so no two objects share their bytes."""
    header, rows = base.split(b"\n", 1)
    header += b"\n"
    if len(header) + len(rows) < size:
        fail(f"compress: {len(rows)} B of rows for {size} B objects")
    out = []
    for i in range(n):
        at = rows.index(b"\n", (offset + i * 7919) * 997 % len(rows)) + 1
        rot = rows[at:] + rows[:at]
        out.append(header + rot[:size - len(header)])
    return out


def run_compress(tmp, card, counts, stagetimer, np):
    """Inline compression on the card over HTTP: a fresh boot as
    `python -m minio_tpu_torch server` makes it (cluster.start_single over
    16 drives at 12+4, 1 MiB blocks, the edge transport) with
    MINIO_COMPRESS=on, so that every .csv PUT is stored S2-framed (the
    snappy block codec in the native host library; the phase fails
    without it). BASELINE.json config 2's shape over compressible text:
    32 concurrent signed PUTs of 16 MiB TPC-H lineitem CSV
    (scripts/scan_cases.lineitem_csv; MinIO compresses by extension and
    type), their GETs and four ranged GETs of the last MiB; four 64 MiB
    CSV objects, whole and last-MiB GETs, and their GETs again at one
    barrier with 3 drives' bucket gone (the MRF queue heals them back);
    two compress + SSE-S3 (ChaCha20-Poly1305) 64 MiB objects PUT at one
    barrier (the engine ciphers each compressed stream in its
    encode dispatch) and read back; an 8,000-row compressed Select (Q6's
    COUNT, held to the host evaluator's framed bytes); two zstd objects
    where `zstandard` imports; the 32-PUT round again under the profiler.
    Every GET must equal the PUT's bytes and MD5 ETag, every CSV object
    must be stored smaller than it came. Returns (the phase's line, the
    running node, what the autoheal phase needs)."""
    import torch
    from minio_tpu_torch import cluster
    from minio_tpu_torch.features import crypto as sse
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.s3select.select import event_stream
    from minio_tpu_torch.scripts import scan_cases as sc
    from minio_tpu_torch.utils import native
    k, m, bs = 12, 4, 1 << 20
    rng = np.random.default_rng(SEED + 29)
    snappy_native = native.snappy_available()
    if not snappy_native:
        fail("compress: the native snappy codec did not build or load")
    try:
        import zstandard  # noqa: F401
        zstd_import = True
    except ImportError:
        zstd_import = False
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    base = sc.lineitem_csv(COMPRESS_ROWS, SEED + 31)
    n_put, put_size = COMPRESS_PUTS
    n_big, big_size = COMPRESS_BIG
    n_sse, sse_size = COMPRESS_SSE
    objs = {"csv": dict(zip((f"put-{i:02d}.csv" for i in range(n_put)),
                            csv_objects(base, n_put, put_size))),
            "big": dict(zip((f"big-{i}.csv" for i in range(n_big)),
                            csv_objects(base, n_big, big_size, 101))),
            "sse": dict(zip((f"sse-{i}.csv" for i in range(n_sse)),
                            csv_objects(base, n_sse, sse_size, 211))),
            "sel": {"part.csv": sc.lineitem_csv(COMPRESS_SELECT_ROWS,
                                                SEED + 37)}}
    if zstd_import:
        objs["zst"] = dict(zip(("z-0.csv", "z-1.csv"),
                               csv_objects(base, 2, put_size, 307)))
    gen_s = time.perf_counter() - t0
    env = {"MINIO_COMPRESS": "on", "MINIO_COMPRESS_ALGORITHM": "s2",
           "MINIO_SSE_MASTER_KEY": rng.bytes(32).hex(),
           "MINIO_TPU_SSE_CIPHER": "chacha20"}
    saved_env = {n: os.environ.get(n) for n in env}
    os.environ.update(env)
    root = os.path.join(tmp, "compress")
    drives = [os.path.join(root, f"d{i}") for i in range(k + m)]
    creds = Credentials("smokecompress", "smokecompresssecret")
    t0 = time.perf_counter()
    node = cluster.start_single(drives, creds=creds, parity=m,
                                set_drive_count=k + m, block_size=bs)
    boot_s = time.perf_counter() - t0
    try:
        # compression's switches are read at boot; the cipher's and the
        # key's stay set, as phases 10 and 11 leave them
        for n in ("MINIO_COMPRESS", "MINIO_COMPRESS_ALGORITHM"):
            if saved_env[n] is None:
                os.environ.pop(n)
            else:
                os.environ[n] = saved_env[n]
        if not node.s3.api.compression_enabled or not node.s3.edge_enabled:
            fail("compress: the server did not boot with compression on "
                 "the edge transport")
        out = run_compress_on(node, S3Client(node.s3.port, creds), objs,
                              counts, stagetimer, torch, sse, sc,
                              event_stream)
    except BaseException:
        node.shutdown()
        raise
    out.update({"snappy_native": snappy_native, "zstd_import": zstd_import,
                "drives": k + m, "ec": f"{k}+{m}", "block_size": bs,
                "boot_s": round(boot_s, 3), "generate_s": round(gen_s, 3),
                "seconds": round(time.perf_counter() - t_phase, 3),
                "card": card})
    emit(out)
    return out, node, {"drives": drives, "objects": objs}


def run_compress_on(node, c, objs, counts, stagetimer, torch, sse, sc,
                    event_stream) -> dict:
    sched, layer = node.scheduler, node.object_layer
    etag = {name: f'"{hashlib.md5(d).hexdigest()}"'
            for b in objs.values() for name, d in b.items()}

    def ok(resp, what, status=200):
        if resp[0] != status:
            fail(f"compress {what}: HTTP {resp[0]} {resp[2][:300]!r}")
        return resp

    def put_all(bucket, prefix="", headers=None) -> float:
        signed = {n: c.sign("PUT", f"/{bucket}/{prefix}{n}", body=d,
                            headers=headers)
                  for n, d in objs[bucket].items()}
        wall, res, errors = at_barrier({
            n: (lambda n=n, d=d: c.send("PUT", f"/{bucket}/{prefix}{n}",
                                        body=d, headers=headers,
                                        signed=signed[n]))
            for n, d in objs[bucket].items()})
        if errors:
            fail(f"compress PUT {bucket}: {errors[:3]}")
        for n, r in res.items():
            if r[0] != 200 or r[1].get("etag") != etag[n]:
                fail(f"compress PUT {bucket}/{prefix}{n}: {r[0]} {r[1]}")
        return wall

    def get_all(bucket, headers=None) -> float:
        wall, res, errors = at_barrier({
            n: (lambda n=n: c.send("GET", f"/{bucket}/{n}",
                                   headers=headers))
            for n in objs[bucket]})
        if errors:
            fail(f"compress GET {bucket}: {errors[:3]}")
        for n, (st, h, body) in res.items():
            if st != 200 or body != objs[bucket][n] or h.get("etag") != \
                    etag[n]:
                fail(f"compress GET {bucket}/{n}: status {st}, bytes or "
                     "ETag differ")
        return wall

    def last_mib(bucket, names) -> None:
        for n in names:
            d = objs[bucket][n]
            a, b = len(d) - (1 << 20), len(d) - 1
            st, h, body = c.send("GET", f"/{bucket}/{n}",
                                 headers={"range": f"bytes={a}-{b}"})
            if st != 206 or body != d[a:] or \
                    h.get("content-range") != f"bytes {a}-{b}/{len(d)}":
                fail(f"compress ranged GET {bucket}/{n}: {st}")
            st, h, _ = c.send("HEAD", f"/{bucket}/{n}")
            if st != 200 or h.get("content-length") != str(len(d)):
                fail(f"compress HEAD {bucket}/{n}: {st} {h}")

    def stored(bucket, algo=sse.COMPRESS_S2) -> int:
        total = 0
        for n, d in objs[bucket].items():
            info = layer.get_object_info(bucket, n)
            if info.user_defined.get(sse.MK_COMPRESS) != algo or \
                    info.size >= len(d):
                fail(f"compress {bucket}/{n}: stored {info.size} B of "
                     f"{len(d)} under "
                     f"{info.user_defined.get(sse.MK_COMPRESS)!r}")
            total += info.size
        return total

    def verbs() -> dict:
        return {v: dict(s) for v, s in sched.stats()["verbs"].items()}

    def delta(a, b) -> dict:
        return {v: {k: b[v][k] - a[v][k] for k in b[v]} for v in b}

    for bucket in objs:
        ok(c.send("PUT", f"/{bucket}"), f"make bucket {bucket}")
    out = {"phase": "compress", "algorithm": sse.COMPRESS_S2}
    sub = {}
    before = verbs()
    counts.zero()

    def gib(bucket) -> float:
        return sum(len(d) for d in objs[bucket].values()) / (1 << 30)

    def since(pre) -> dict:
        now = counts.read()
        return {n: now[n] - pre[n] for n in now}

    # -- config 2's shape over CSV ------------------------------------------
    stagetimer.reset()
    stagetimer.enable()
    put_s = put_all("csv")
    stagetimer.disable()
    stages = stage_report(stagetimer)["stages"]
    get_s = get_all("csv")
    last_mib("csv", list(objs["csv"])[:4])
    sub["csv"] = counts.read()
    mark = counts.read()
    csv_raw = sum(len(d) for d in objs["csv"].values())
    csv_stored = stored("csv")
    out["csv"] = {
        "objects": len(objs["csv"]), "raw_bytes": csv_raw,
        "stored_bytes": csv_stored,
        "ratio": round(csv_stored / csv_raw, 6),
        "put_wall_s": round(put_s, 3), "get_wall_s": round(get_s, 3),
        "put_gib_s": round(gib("csv") / put_s, 4),
        "get_gib_s": round(gib("csv") / get_s, 4),
        "stage_s": {n: v for n, v in stages.items()
                    if n.startswith(("put.", "http"))}}

    # -- four 64 MiB objects, then read with 3 drives' bucket gone --------
    put_s = put_all("big")
    get_s = get_all("big")
    last_mib("big", objs["big"])
    big_raw = sum(len(d) for d in objs["big"].values())
    big_stored = stored("big")
    # a shard write the quorum-ack lane left behind heals through MRF
    # before the drives go
    if not node.object_layer.drain_mrf(timeout=120):
        fail("compress: the MRF queue did not drain before the degraded "
             "GETs")
    mid = verbs()
    for i in (0, 1, 2):
        shutil.rmtree(os.path.join(node.spec.drives[i], "big"))
    pre = counts.read()
    deg_s = get_all("big")
    deg = counts.read()
    dec = delta(mid, verbs())["decode"]
    if dec["batches"] - dec["host_routed"] <= 0 or \
            deg["gf_matmul"] <= pre["gf_matmul"]:
        fail(f"compress degraded GET: decode {dec}, launches {deg}")
    sub["big"] = since(mark)
    out["big"] = {
        "objects": len(objs["big"]), "raw_bytes": big_raw,
        "stored_bytes": big_stored, "ratio": round(big_stored / big_raw, 6),
        "put_wall_s": round(put_s, 3), "get_wall_s": round(get_s, 3),
        "put_gib_s": round(gib("big") / put_s, 4),
        "get_gib_s": round(gib("big") / get_s, 4),
        "degraded_get": {"missing_drives": [0, 1, 2],
                         "wall_s": round(deg_s, 3),
                         "gib_s": round(gib("big") / deg_s, 4),
                         "decode_groups_on_card":
                             dec["batches"] - dec["host_routed"],
                         "decode_groups_on_host": dec["host_routed"]}}

    # -- compress + SSE-S3: the cipher fused into the encode dispatch -------
    pre = counts.read()
    enc0 = verbs()
    hdr = {"x-amz-server-side-encryption": "AES256"}
    put_s = put_all("sse", headers=hdr)
    mid_counts = counts.read()
    get_s = get_all("sse")
    last_mib("sse", ["sse-0.csv"])
    post = counts.read()
    sse_raw = sum(len(d) for d in objs["sse"].values())
    sse_stored = stored("sse")
    enc = delta(enc0, verbs())["encode"]
    if mid_counts["chacha20"] <= pre["chacha20"] or \
            post["chacha20"] <= mid_counts["chacha20"]:
        fail(f"compress SSE: chacha20 launches {pre} -> {mid_counts} -> "
             f"{post}")
    for n in objs["sse"]:
        md = layer.get_object_info("sse", n).user_defined
        if md.get(sse.MK_CIPHER) != sse.CIPHER_CHACHA or \
                md.get(sse.MK_SSE) != "S3":
            fail(f"compress SSE {n}: metadata {sorted(md)}")
    sub["sse"] = since(pre)
    out["sse"] = {
        "objects": len(objs["sse"]), "raw_bytes": sse_raw,
        "stored_bytes": sse_stored, "ratio": round(sse_stored / sse_raw, 6),
        "put_wall_s": round(put_s, 3), "get_wall_s": round(get_s, 3),
        "put_gib_s": round(gib("sse") / put_s, 4),
        "get_gib_s": round(gib("sse") / get_s, 4),
        "put_launches": {n: mid_counts[n] - pre[n] for n in post},
        "get_launches": {n: post[n] - mid_counts[n] for n in post},
        "encode_groups_on_card": enc["batches"] - enc["host_routed"],
        "encode_groups_on_host": enc["host_routed"]}

    # -- a Select over a compressed CSV object ----------------------------
    served0 = node.s3.api.scan.stats()["device_serves"]
    ok(c.send("PUT", "/sel/part.csv", body=objs["sel"]["part.csv"]),
       "PUT select object")
    stored("sel")
    pre = counts.read()
    t0 = time.perf_counter()
    got = ok(c.send("POST", "/sel/part.csv",
                    query={"select": "", "select-type": "2"},
                    body=sc.select_xml(sc.Q6_COUNT)), "Select")[2]
    sel_s = time.perf_counter() - t0
    post = counts.read()
    want = b"".join(event_stream(sc.request(sc.Q6_COUNT),
                                 objs["sel"]["part.csv"]))
    served = node.s3.api.scan.stats()["device_serves"] - served0
    if got != want or served < 1 or post["scan_eval"] - pre["scan_eval"] < 1:
        fail(f"compress Select: {served} device serves, scan_eval "
             f"{post['scan_eval'] - pre['scan_eval']}, bytes "
             f"{'equal' if got == want else 'differ'}")
    out["select"] = {"rows": COMPRESS_SELECT_ROWS,
                     "raw_bytes": len(objs["sel"]["part.csv"]),
                     "wall_s": round(sel_s, 3), "device_serves": served,
                     "launches": {n: post[n] - pre[n] for n in post}}

    # -- zstd, where its package imports ----------------------------------
    if "zst" in objs:
        node.s3.api.compression_algorithm = "zstd"
        try:
            put_s = put_all("zst")
        finally:
            node.s3.api.compression_algorithm = "s2"
        get_s = get_all("zst")
        z_raw = sum(len(d) for d in objs["zst"].values())
        z_stored = stored("zst", sse.COMPRESS_ZSTD)
        out["zstd"] = {"objects": len(objs["zst"]), "raw_bytes": z_raw,
                       "stored_bytes": z_stored,
                       "ratio": round(z_stored / z_raw, 6),
                       "put_gib_s": round(gib("zst") / put_s, 4),
                       "get_gib_s": round(gib("zst") / get_s, 4)}

    launched = counts.read()
    if min(launched["gf_matmul"], launched["hh256"],
           launched["chacha20"], launched["scan_eval"]) <= 0:
        fail(f"compress: launches {launched}")
    out["encode"] = delta(before, verbs())
    # the 32-PUT round again, under the profiler (not in the launches)
    out["profiled_put_round"] = device_busy(
        torch, lambda: put_all("csv", prefix="r2/"), counts)
    objs["csv"].update({f"r2/{n}": d for n, d in list(objs["csv"].items())})
    out["launches"] = launched
    out["launches_by_subpath"] = sub
    return out


def run_autoheal(node, state, card, counts) -> dict:
    """The background plane of the compress phase's server, on the card.
    Its loops are stopped (their cadence would race the timed calls) and
    the MRF queue drained; then one drive's directory is emptied while
    the server runs, and the disk monitor's scan_once, timed, must admit
    it: format.json with its slot's UUID, and every file a manifest took
    before the wipe back byte for byte (the buckets' shards and journals;
    the sweep heals buckets, as the reference's does), rebuilt by heal
    steps on the card (gf_matmul and hh256 launch; groups under the
    codec's gate stay on the host and are reported). Then two HealScanner
    passes: a full one, and one after one object's copy on another drive
    is removed and marked in the tracker and one new object is PUT over
    HTTP, which must check only those two, heal the first, and skip every
    other bucket; one crawler pass, whose usage must equal the objects'
    stored sizes, and a quota refused from its cache (a PUT the cache does
    not know of yet still passes; after the next crawl it is counted)."""
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.storage.format import read_format_from
    from minio_tpu_torch.storage.xl_storage import XLStorage
    t_phase = time.perf_counter()
    sched, layer, sets = node.scheduler, node.object_layer, node.sets
    loops = (node.disk_monitor, node.heal_scanner, node.crawler)
    for loop in loops:
        loop.close()
        if loop._thread is not None:
            loop._thread.join(timeout=120)
            if loop._thread.is_alive():
                fail("autoheal: a background loop did not stop")
    if not sets.drain_mrf(600):
        fail("autoheal: the MRF queue did not drain")
    victim = AUTOHEAL_DRIVE
    path = node.spec.drives[victim]
    buckets = sorted(state["objects"])

    def manifest() -> dict:
        files = tree_files(path)
        return {rel: hashlib.sha256(data).hexdigest()
                for rel, data in files.items()
                if rel.split(os.sep)[0] in buckets
                or rel == os.path.join(".minio.sys", "format.json")}

    before = manifest()
    stored_bytes = sum(layer.get_object_info(b, n).size
                       for b, names in state["objects"].items()
                       for n in names)
    drive_bytes = sum(os.path.getsize(os.path.join(path, rel))
                      for rel in before)
    for entry in os.listdir(path):
        full = os.path.join(path, entry)
        if os.path.isdir(full):
            shutil.rmtree(full)
        else:
            os.unlink(full)
    mon = node.disk_monitor
    v0 = {v: dict(s) for v, s in sched.stats()["verbs"].items()}
    counts.zero()
    t0 = time.perf_counter()
    admitted = mon.scan_once()
    sweep_s = time.perf_counter() - t0
    launched = counts.read()
    rec = {k: sched.stats()["verbs"]["recover"][k] - v0["recover"][k]
           for k in v0["recover"]}
    after = manifest()
    want_uuid = sets.format_ref.sets[0][victim]
    if admitted != 1 or mon.healed_slots != [(0, victim)]:
        fail(f"autoheal: admitted {admitted}, healed {mon.healed_slots}")
    if read_format_from(XLStorage(path)).this != want_uuid:
        fail("autoheal: format.json does not hold the slot's UUID")
    if after != before:
        diff = sorted(set(after) ^ set(before)) or \
            [f for f in before if after[f] != before[f]]
        fail(f"autoheal: {len(diff)} files differ from the manifest: "
             f"{diff[:4]}")
    if min(launched["gf_matmul"], launched["hh256"]) <= 0 or \
            rec["batches"] - rec["host_routed"] != launched["gf_matmul"]:
        fail(f"autoheal: sweep launches {launched}, recover {rec}")
    out = {"phase": "autoheal", "drive": victim, "admitted": admitted,
           "files": len(before), "drive_bytes": drive_bytes,
           "objects": sum(len(v) for v in state["objects"].values()),
           "stored_bytes": stored_bytes, "sweep_s": round(sweep_s, 3),
           "heal_gib_s_stored": round(stored_bytes / (1 << 30) / sweep_s, 4),
           "heal_gib_s_drive": round(drive_bytes / (1 << 30) / sweep_s, 4),
           "recover_groups_on_card": rec["batches"] - rec["host_routed"],
           "recover_groups_on_host": rec["host_routed"],
           "launches": launched}

    # -- the hinted heal scanner: a full pass, then a hinted one -----------
    scanner, tracker = node.heal_scanner, node.update_tracker
    if scanner.last_cycle:
        fail("autoheal scanner: its loop ran a pass before the phase (it "
             "waits 300 s after boot)")
    c = S3Client(node.s3.port, node.creds)
    mgr = node.metacache
    if mgr is None or not mgr.drain(60):
        fail("autoheal: the boot attached no metacache, or its journal "
             "did not drain")
    counts.zero()
    w0 = walk_counts()
    t0 = time.perf_counter()
    full = scanner.scan_once()
    full_s = time.perf_counter() - t0
    full_walks = walk_counts(w0)
    # the index is the scanner's feed: every bucket read from it (the
    # first read of each builds it: the one walk, the metacache's own)
    if full != out["objects"] or scanner.healed or \
            full_walks.get("heal/index") != len(buckets) or \
            full_walks.get("heal/merge"):
        fail(f"autoheal scanner: full pass checked {full}, healed "
             f"{scanner.healed}, walks {full_walks}")
    full_segments = len(mgr.segment_objects())
    damaged = ("big", "big-1.csv")
    other = (victim + 5) % len(node.spec.drives)
    shutil.rmtree(os.path.join(node.spec.drives[other], *damaged))
    tracker.mark(*damaged)
    new = state["objects"]["sel"]["part.csv"][:100_000]
    if c.send("PUT", "/sel/new.csv", body=new)[0] != 200:
        fail("autoheal scanner: the PUT of a new object failed")
    # the PUT's delta is inside the index's 2 s staleness bound: settle
    if not mgr.drain(60):
        fail("autoheal scanner: the metacache journal did not drain")
    # a shard write of that PUT left behind heals through MRF, not the
    # scanner
    if not sets.drain_mrf(120):
        fail("autoheal: the MRF queue did not drain after the new PUT")
    skipped0 = scanner.skipped_buckets
    w0 = walk_counts()
    pre = counts.read()
    t0 = time.perf_counter()
    hinted = scanner.scan_once()
    hinted_s = time.perf_counter() - t0
    post = counts.read()
    skipped = scanner.skipped_buckets - skipped0
    hinted_walks = walk_counts(w0)
    if hinted != 2 or scanner.healed != 1 or skipped != len(buckets) - 2 \
            or hinted_walks.get("heal/merge") or \
            hinted_walks.get("heal/index") != 2:
        fail(f"autoheal scanner: hinted pass checked {hinted}, healed "
             f"{scanner.healed}, skipped {skipped} buckets, walks "
             f"{hinted_walks}")
    if not os.path.isdir(os.path.join(node.spec.drives[other], *damaged)):
        fail("autoheal scanner: the marked object was not healed")
    out["scanner"] = {"full_checked": full, "full_s": round(full_s, 3),
                      "hinted_checked": hinted,
                      "hinted_s": round(hinted_s, 3),
                      "healed_drives": scanner.healed,
                      "skipped_buckets": skipped,
                      "full_walks": full_walks,
                      "hinted_walks": hinted_walks,
                      "segment_objects_after_full": full_segments,
                      "segment_objects_after_hinted":
                          len(mgr.segment_objects()),
                      "full_launches": pre,
                      "hinted_launches": {n: post[n] - pre[n]
                                          for n in post}}

    # -- the crawler, and quota from its cache ----------------------------
    state["objects"]["sel"]["new.csv"] = new
    # the crawler's own loop may have run a pass during phase 12
    w0 = walk_counts()
    t0 = time.perf_counter()
    usage = node.crawler.scan_once()
    crawl_s = time.perf_counter() - t0
    crawl_walks = walk_counts(w0)
    if crawl_walks.get("crawler/merge") or \
            crawl_walks.get("crawler/index") != len(buckets):
        fail(f"autoheal crawler: walks {crawl_walks}")
    for b, names in state["objects"].items():
        want = {"objects": len(names),
                "size": sum(layer.get_object_info(b, n).size
                            for n in names)}
        if usage["buckets"].get(b) != want:
            fail(f"autoheal crawler: {b} {usage['buckets'].get(b)} != "
                 f"{want}")
    used = usage["buckets"]["sel"]["size"]
    node.s3.api.bucket_meta.update("sel", quota={"quota": used + 1000,
                                                 "quotatype": "hard"})
    quota = [c.send("PUT", "/sel/q-0.dat", body=b"q" * 2000)[0],
             c.send("PUT", "/sel/q-1.dat", body=b"q" * 600)[0],
             c.send("PUT", "/sel/q-2.dat", body=b"q" * 600)[0]]
    if not mgr.drain(60):
        fail("autoheal quota: the metacache journal did not drain")
    node.crawler.scan_once()
    quota.append(c.send("PUT", "/sel/q-3.dat", body=b"q" * 600)[0])
    if quota != [409, 200, 200, 409]:
        fail(f"autoheal quota: statuses {quota}")
    out["crawler"] = {"wall_s": round(crawl_s, 3),
                      "walks": crawl_walks,
                      "objects_total": usage["objects_total"],
                      "size_total": usage["size_total"],
                      "quota_statuses": quota}
    out.update({"seconds": round(time.perf_counter() - t_phase, 3),
                "card": card})
    emit(out)
    return out


def pct_ms(xs: list) -> dict:
    """p50 and p99 of a list of seconds, in ms (nearest rank)."""
    xs = sorted(xs)
    if not xs:
        return {"p50_ms": None, "p99_ms": None}
    return {"p50_ms": round(xs[len(xs) // 2] * 1e3, 3),
            "p99_ms": round(xs[max(0, -(-len(xs) * 99 // 100) - 1)] * 1e3,
                            3)}


def list_v2_pages(c, bucket: str, page: int) -> tuple[list, list]:
    """ListObjectsV2 over HTTP, paged by continuation token: (key lists
    per page, seconds per page)."""
    import xml.etree.ElementTree as ET
    pages, lat, token = [], [], None
    while True:
        q = {"list-type": "2", "max-keys": str(page)}
        if token:
            q["continuation-token"] = token
        t0 = time.perf_counter()
        st, _h, body = c.send("GET", f"/{bucket}", query=q)
        lat.append(time.perf_counter() - t0)
        if st != 200:
            fail(f"namespace ListObjectsV2 {bucket}: HTTP {st}")
        root = ET.fromstring(body)
        ns = root.tag[:root.tag.index("}") + 1] if "}" in root.tag else ""
        pages.append([e.findtext(f"{ns}Key")
                      for e in root.findall(f"{ns}Contents")])
        if root.findtext(f"{ns}IsTruncated") != "true":
            return pages, lat
        token = root.findtext(f"{ns}NextContinuationToken")


def list_versions_pages(c, bucket: str,
                        page: int) -> tuple[list, list, list]:
    """ListObjectVersions over HTTP, paged by key and version-id markers:
    ((key, version id) lists per page, seconds per page, the (key,
    version id) markers each page was asked with)."""
    import xml.etree.ElementTree as ET
    pages, lat, marks, km, vm = [], [], [], "", ""
    while True:
        marks.append((km, vm))
        q = {"versions": "", "max-keys": str(page)}
        if km:
            q.update({"key-marker": km, "version-id-marker": vm})
        t0 = time.perf_counter()
        st, _h, body = c.send("GET", f"/{bucket}", query=q)
        lat.append(time.perf_counter() - t0)
        if st != 200:
            fail(f"namespace ListObjectVersions {bucket}: HTTP {st}")
        root = ET.fromstring(body)
        ns = root.tag[:root.tag.index("}") + 1] if "}" in root.tag else ""
        pages.append([(e.findtext(f"{ns}Key"), e.findtext(f"{ns}VersionId"))
                      for e in root
                      if e.tag in (f"{ns}Version", f"{ns}DeleteMarker")])
        if root.findtext(f"{ns}IsTruncated") != "true":
            return pages, lat, marks
        km = root.findtext(f"{ns}NextKeyMarker")
        vm = root.findtext(f"{ns}NextVersionIdMarker")


def walk_first_pages(layer, bucket: str, page: int,
                     n: int) -> tuple[list, list]:
    """The first n ListObjects pages of the merge walk, paged one by one
    by the node's own layer with its index detached: (key lists, seconds
    per page)."""
    mc, layer.metacache = layer.metacache, None
    try:
        pages, lat, marker = [], [], ""
        for _ in range(n):
            t0 = time.perf_counter()
            o, _p, trunc = layer.list_objects(bucket, "", marker, "", page)
            lat.append(time.perf_counter() - t0)
            pages.append([x.name for x in o])
            if not trunc:
                break
            marker = o[-1].name
    finally:
        layer.metacache = mc
    return pages, lat


def ns_key(i: int) -> str:
    """bench_list_ab's key shape: dirN/ prefixes on three keys of four."""
    return f"dir{i % 4}/obj-{i:07d}" if i % 4 else f"obj-{i:07d}"


# the namespace phase's worker processes: each imports the port at start
# and opens its own object layer over the phase's drives at its first
# task (after the node has formatted them)
_NS: dict = {}


def _ns_init(drives: list, parity: int, block_size: int) -> None:
    from minio_tpu_torch.object import server_sets, sets  # noqa: F401
    _NS.update(drives=drives, parity=parity, block_size=block_size)


def _ns_layer():
    """The worker's ErasureServerSets over the drives, with no metacache
    (a walk is the merge walk); its engines code on the host, as the
    node's do for the seed's 16-byte objects (under the codec's gate)."""
    if "layer" not in _NS:
        from minio_tpu_torch.object.server_sets import ErasureServerSets
        from minio_tpu_torch.object.sets import ErasureSets
        drives = _NS["drives"]
        _NS["layer"] = ErasureServerSets([ErasureSets.from_drives(
            drives, 1, len(drives), _NS["parity"],
            block_size=_NS["block_size"], enable_mrf=False,
            device="cpu")], load_topology=False)
    return _NS["layer"]


def _ns_seed(args) -> int:
    """PUT keys lo..hi-1 into bucket list (an extra version every
    `every`th); returns the keys written."""
    from minio_tpu_torch.object.engine import PutOptions
    lo, hi, every, payload = args
    layer = _ns_layer()
    for i in range(lo, hi):
        layer.put_object("list", ns_key(i), payload)
        if every and i % every == 0:
            layer.put_object("list", ns_key(i), payload,
                             opts=PutOptions(versioned=True))
    return hi - lo


def _ns_put(args) -> None:
    """PUT one payload under each of the names into the bucket."""
    bucket, names, payload = args
    layer = _ns_layer()
    for name in names:
        layer.put_object(bucket, name, payload)


def _ns_walk(args) -> tuple:
    """One merge-walk page of bucket list from the given markers:
    (entries, seconds, truncated, the walk's own next markers)."""
    kind, km, vm, page = args
    layer = _ns_layer()
    t0 = time.perf_counter()
    if kind == "objects":
        o, _p, trunc = layer.list_objects("list", "", km, "", page)
        return ([x.name for x in o], time.perf_counter() - t0, trunc,
                (o[-1].name if o else "", ""))
    v, _p, nkm, nvm, trunc = layer.list_object_versions(
        "list", "", km, page, vm)
    return ([(x.name, x.version_id or "null") for x in v],
            time.perf_counter() - t0, trunc, (nkm, nvm))


WALK_PAIRS = [(con, src)
              for con in ("heal", "crawler", "lifecycle", "metacache")
              for src in ("merge", "index")]


def walk_counts(before: dict | None = None) -> dict:
    """minio_tpu_namespace_walks_total for each (consumer, source) pair
    the phases check, as "consumer/source"; with `before`, the pairs that
    moved since then and by how much."""
    from minio_tpu_torch.object.metacache import walks_counter
    c = walks_counter()
    now = {f"{con}/{src}": c.value(consumer=con, source=src)
           for con, src in WALK_PAIRS}
    if before is None:
        return now
    return {k: v - before[k] for k, v in now.items() if v != before[k]}


def run_namespace(tmp, card, counts, np, lineitem: bytes,
                  q6_oracle: bytes) -> dict:
    """The namespace plane on the card: a fresh cluster.start_single over
    8 drives at EC 6+2 with 1 MiB blocks (the layout of the reference's
    bench.py --ab-list, its pool on tmpfs too where /dev/shm has
    NS_SHM_MIN_BYTES free, else under tmp), MINIO_TPU_CACHE=on,
    MINIO_TPU_METACACHE_PERSIST_S short for the phase, index segments of
    NS_SEGMENT_KEYS (the default 5,000 cut with the keys, so that the
    index persists as two segments); the
    background loops stopped (each pass is driven here). Listing: NS_KEYS
    keys as bench_list_ab shapes them (dirN/ prefixes on three keys of
    four, an extra version every 20th, 16-byte payloads), seeded by
    NS_WORKERS processes, each through its own port object layer over the
    node's drives (a PUT costs ~30 ms of host work, so one process would
    take ~5 min), the index built by the node, ListObjectsV2 and
    ListObjectVersions paged over HTTP at NS_PAGE keys three times, every
    page name-identical to the merge walk's page: each walk page is
    computed by a worker's layer (no index) from the markers the walk's
    previous page gives, which are checked too, so the pages are the
    walk's own paging, computed in parallel; the first three ListObjects
    pages of the walk are also paged one by one by the node's layer with
    its index detached, for the walk's page time; no fallback, one
    crawler pass with no merge walk.
    Persist and reload: the index persisted (two segments), the node shut
    down, the .metacache directory of 2 drives removed, a new boot over
    the same drives (its MRF queue closed, so that only the scanner
    restores), the index reloaded through degraded reads, the pages equal
    again, and one scanner pass (no merge walk) restoring the removed
    segment shards file for file.
    Lifecycle: NS_LIFECYCLE objects, half under exp/, a rule expiring
    exp/ at a past Date, one crawler pass deleting exactly those; their
    GETs answer 404 and the index lists exactly the others. Read cache:
    four 64 MiB objects and one SSE-S3 64 MiB object PUT over HTTP, 2
    drives' bucket directory removed; three GETs of each plain object
    (admission is 2 GETs): two degraded reads with decode dispatches and
    gf_matmul launches, then a hit with neither; the SSE object GET until
    a GET is served from the cache (chacha20 deciphers it through the
    former's decipher verb, no decode dispatch); the first NS_SELECT_BYTES
    of phase 11's lineitem CSV Selected three times, the third from the cache (scan_eval launches,
    no decode dispatch, the response equal to the host evaluator's framed
    stream, computed in phase 11's workers). Bytes and ETags compared on
    every GET.
    Returns (the phase's line, the running node, what phase 15 needs)."""
    import torch

    from minio_tpu_torch import cluster
    from minio_tpu_torch.object import engine as eng_mod
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.scripts import scan_cases as sc
    from minio_tpu_torch.storage.datatypes import hash_order
    k, m, bs = 6, 2, 1 << 20
    n_keys, every, page = NS_KEYS, NS_VERSIONS_EVERY, NS_PAGE
    rng = np.random.default_rng(SEED + 41)
    env = {"MINIO_TPU_CACHE": "on", "MINIO_TPU_METACACHE": "on",
           "MINIO_TPU_METACACHE_PERSIST_S": "1",
           "MINIO_TPU_METACACHE_SEGMENT_KEYS": str(NS_SEGMENT_KEYS),
           "MINIO_SSE_MASTER_KEY": rng.bytes(32).hex(),
           "MINIO_TPU_SSE_CIPHER": "chacha20"}
    saved_env = {n: os.environ.get(n) for n in env}
    os.environ.update(env)
    # the drives on tmpfs where it has room, as bench_list_ab puts its pool
    shm = "/dev/shm"
    on_shm = os.path.isdir(shm) and \
        shutil.disk_usage(shm).free >= NS_SHM_MIN_BYTES
    root = tempfile.mkdtemp(prefix="chip_smoke_ns_",
                            dir=shm if on_shm else tmp)
    drives = [os.path.join(root, f"d{i}") for i in range(k + m)]
    state = {"root": root, "drives": drives, "saved_env": saved_env,
             "on_shm": on_shm}
    creds = Credentials("smokenamespace", "smokenamespacesecret")
    t_phase = time.perf_counter()
    out = {"phase": "namespace", "drives": k + m, "ec": f"{k}+{m}",
           "block_size": bs,
           "drives_on": "tmpfs (/dev/shm)" if on_shm else "the disk (tmp)"}
    counts.zero()

    def note(msg: str) -> None:
        """Progress on stderr (the phase's line comes at its end)."""
        print(f"[namespace {time.perf_counter() - t_phase:.1f} s] {msg}",
              file=sys.stderr, flush=True)

    def boot():
        t0 = time.perf_counter()
        node = cluster.start_single(drives, creds=creds, parity=m,
                                    set_drive_count=k + m, block_size=bs)
        for loop in (node.disk_monitor, node.heal_scanner, node.crawler):
            loop.close()
            if loop._thread is not None:
                loop._thread.join(timeout=120)
                if loop._thread.is_alive():
                    fail("namespace: a background loop did not stop")
        if node.metacache is None or node.read_cache is None:
            fail("namespace: the boot attached no metacache or no cache")
        return node, time.perf_counter() - t0

    def verbs(node):
        return {v: dict(s)
                for v, s in node.scheduler.stats()["verbs"].items()}

    def since(a, b, verb):
        return b[verb]["batches"] - a[verb]["batches"]

    pool = None
    try:
        # -- listing --------------------------------------------------------
        import multiprocessing
        pool = multiprocessing.get_context("spawn").Pool(
            NS_WORKERS, initializer=_ns_init, initargs=(drives, m, bs))
        node, boot_s = boot()
        try:
            layer, mgr = node.object_layer, node.metacache
            c = S3Client(node.s3.port, creds, timeout=300)
            if c.send("PUT", "/list")[0] != 200:
                fail("namespace: make bucket list")
            payload = rng.bytes(16)
            step = 125
            t0 = time.perf_counter()
            seeded = sum(pool.map(
                _ns_seed, [(lo, min(lo + step, n_keys), every, payload)
                           for lo in range(0, n_keys, step)], chunksize=1))
            seed_s = time.perf_counter() - t0
            if seeded != n_keys:
                fail(f"namespace: seeded {seeded} keys")
            note(f"seeded {n_keys} keys in {seed_s:.1f} s")
            versions = n_keys + len(range(0, n_keys, every))
            w0 = walk_counts()
            mgr._persist_s = 1e9        # the persist below is timed
            t0 = time.perf_counter()
            if not mgr.build("list"):
                fail("namespace: the index did not build")
            build_s = time.perf_counter() - t0
            build_walks = walk_counts(w0)
            note(f"built the index in {build_s:.1f} s")
            if not mgr.drain(60):
                fail("namespace: the journal did not drain")
            st0 = mgr.stats()
            idx_lat, ver_lat = [], []
            for rnd in range(3):
                p_, lat = list_v2_pages(c, "list", page)
                vp_, vlat, vmarks_ = list_versions_pages(c, "list", page)
                if rnd and (p_ != idx_pages or vp_ != ver_pages):
                    fail("namespace: the index's pages changed between "
                         "rounds")
                idx_pages, ver_pages, vmarks = p_, vp_, vmarks_
                idx_lat += lat
                ver_lat += vlat
            rounds = rnd + 1
            note("paged the index over HTTP")
            if sum(map(len, idx_pages)) != n_keys or \
                    sum(map(len, ver_pages)) != versions:
                fail(f"namespace: the index lists {sum(map(len, idx_pages))}"
                     f" keys, {sum(map(len, ver_pages))} versions")
            # the walk's oracle pages, in parallel: page i from the
            # markers of the walk's page i - 1 (= the index's, checked)
            omarks = [""] + [p_[-1] for p_ in idx_pages[:-1]]
            tasks = [("objects", mk, "", page) for mk in omarks] + \
                [("versions", km, vm, page) for km, vm in vmarks]
            t0 = time.perf_counter()
            walked = pool.map(_ns_walk, tasks, chunksize=1)
            walk_wall = time.perf_counter() - t0
            wobj, wver = walked[:len(omarks)], walked[len(omarks):]
            null = lambda mk: (mk[0], mk[1] or "null")      # noqa: E731
            for i, (got, _s, trunc, nxt) in enumerate(wobj):
                if got != idx_pages[i] or trunc != (i + 1 < len(wobj)):
                    fail(f"namespace: ListObjectsV2 page {i} differs from "
                         "the walk's")
            for i, (got, _s, trunc, nxt) in enumerate(wver):
                last = i + 1 == len(wver)
                if got != ver_pages[i] or trunc == last or \
                        (not last and null(nxt) != null(vmarks[i + 1])):
                    fail(f"namespace: ListObjectVersions page {i} or its "
                         "markers differ from the walk's")
            note(f"walked {len(tasks)} pages in {walk_wall:.1f} s")
            first, w_lat = walk_first_pages(layer, "list", page, 3)
            if first != idx_pages[:3]:
                fail("namespace: the walk's first pages differ")
            note(f"paged the walk's first 3 pages in {sum(w_lat):.1f} s")
            st1 = mgr.stats()
            served = st1["serves"] - st0["serves"]
            fallbacks = st1["fallbacks"] - st0["fallbacks"]
            if fallbacks or \
                    served != rounds * (len(idx_pages) + len(ver_pages)):
                fail(f"namespace: {fallbacks} fallbacks, {served} pages "
                     "served from the index")
            t0 = time.perf_counter()
            mgr._persist("list")
            persist_s = time.perf_counter() - t0
            mgr._persist_s = None
            segs = mgr._indexes["list"].segments
            per = mgr.segment_keys()
            if len(segs) < 2 or [s["count"] for s in segs] != \
                    [min(per, n_keys - i) for i in range(0, n_keys, per)]:
                fail(f"namespace: persisted segments {segs}")
            crawler = node.crawler
            w1 = walk_counts()
            t0 = time.perf_counter()
            usage = crawler.scan_once()
            crawl_s = time.perf_counter() - t0
            crawl_walks = walk_counts(w1)
            if usage["buckets"]["list"]["objects"] != n_keys or \
                    crawl_walks.get("crawler/merge") or \
                    crawl_walks.get("crawler/index") != 1:
                fail(f"namespace crawler: {usage['buckets']}, walks "
                     f"{crawl_walks}")
            out["listing"] = {
                "keys": n_keys, "versions": versions, "page": page,
                "boot_s": round(boot_s, 3), "seed_s": round(seed_s, 3),
                "build_s": round(build_s, 3),
                "persist_s": round(persist_s, 4),
                "segments": [s["count"] for s in segs],
                "index_pages": len(idx_pages),
                "index_version_pages": len(ver_pages),
                "index_rounds": rounds,
                "index_v2": pct_ms(idx_lat),
                "index_versions": pct_ms(ver_lat),
                "walk_v2_first_pages_one_by_one": {
                    "pages": len(w_lat),
                    "p50_ms": pct_ms(w_lat)["p50_ms"],
                    "max_ms": round(max(w_lat) * 1e3, 3)},
                "walk_oracle": {
                    "workers": NS_WORKERS, "pages": len(tasks),
                    "wall_s": round(walk_wall, 3),
                    "v2_page_s": [round(w[1], 3) for w in wobj],
                    "versions_page_s": [round(w[1], 3) for w in wver]},
                "served_from_index": served, "fallbacks": fallbacks,
                "build_walks": build_walks,
                "crawler": {"wall_s": round(crawl_s, 3),
                            "walks": crawl_walks}}
            # an index shard write the quorum-ack lane left behind heals
            # through MRF before 2 of the 6+2 drives lose their copies
            if not layer.drain_mrf(timeout=120):
                fail("namespace: the MRF queue did not drain")
            gone = [2, 5]
            mc_files = {}
            for j in gone:
                d = os.path.join(drives[j], ".minio.sys", "buckets", "list",
                                 ".metacache")
                mc_files[j] = {rel: hashlib.sha256(b).hexdigest()
                               for rel, b in tree_files(d).items()}
                if not mc_files[j]:
                    fail(f"namespace: drive {j} holds no index shards")
        finally:
            node.shutdown()

        # -- persist and reload ---------------------------------------------
        for j in gone:
            shutil.rmtree(os.path.join(drives[j], ".minio.sys", "buckets",
                                       "list", ".metacache"))
        node, boot2_s = boot()
        try:
            layer, mgr = node.object_layer, node.metacache
            # no MRF heal of the index objects the degraded reads below
            # report: only the scanner's segment sweep restores them
            node.sets.mrf.close()
            c = S3Client(node.s3.port, creds, timeout=300)
            t0 = time.perf_counter()
            if not mgr.build("list"):
                fail("namespace: the persisted index did not reload")
            reload_s = time.perf_counter() - t0
            note(f"rebooted in {boot2_s:.1f} s, reloaded in {reload_s:.1f} s")
            st0 = mgr.stats()
            if st0["builds"] != 1 or st0["reconciles"] != 1:
                fail(f"namespace reload: {st0}")
            again, again_lat = list_v2_pages(c, "list", page)
            vagain, _l, _m = list_versions_pages(c, "list", page)
            if again != idx_pages or vagain != ver_pages:
                fail("namespace: pages after the reload differ")
            if mgr.stats()["fallbacks"] != st0["fallbacks"]:
                fail("namespace: a page after the reload fell back")
            scanner = node.heal_scanner
            w1 = walk_counts()
            counts_pre = counts.read()
            t0 = time.perf_counter()
            checked = scanner.scan_once()
            scan_s = time.perf_counter() - t0
            scan_walks = walk_counts(w1)
            note(f"scanner pass in {scan_s:.1f} s")
            if checked != n_keys or scan_walks.get("heal/merge"):
                fail(f"namespace scanner: checked {checked}, walks "
                     f"{scan_walks}")
            for j in gone:
                d = os.path.join(drives[j], ".minio.sys", "buckets", "list",
                                 ".metacache")
                now = {rel: hashlib.sha256(b).hexdigest()
                       for rel, b in tree_files(d).items()}
                if now != mc_files[j]:
                    fail(f"namespace: drive {j}'s index shards were not "
                         f"restored file for file ({len(now)} of "
                         f"{len(mc_files[j])})")
            counts_post = counts.read()
            out["reload"] = {
                "removed_drives": gone,
                "files_restored": sum(len(v) for v in mc_files.values()),
                "boot_s": round(boot2_s, 3), "reload_s": round(reload_s, 3),
                "index_v2_after": pct_ms(again_lat),
                "scanner": {"checked": checked, "wall_s": round(scan_s, 3),
                            "walks": scan_walks,
                            "segment_objects": len(mgr.segment_objects()),
                            "launches": {n: counts_post[n] - counts_pre[n]
                                         for n in counts_post}}}

            # -- lifecycle --------------------------------------------------
            n_lc, n_exp = NS_LIFECYCLE
            if c.send("PUT", "/lcy")[0] != 200:
                fail("namespace: make bucket lcy")
            lc_names = [f"exp/{i:04d}" if i < n_exp else f"keep/{i:04d}"
                        for i in range(n_lc)]
            # PUT by the workers (below the node: its index of lcy is
            # built by the crawler's first feed read)
            pool.map(_ns_put, [("lcy", lc_names[i:i + 50], payload)
                               for i in range(0, n_lc, 50)], chunksize=1)
            pool.close()
            pool.join()
            doc = ("<LifecycleConfiguration><Rule><ID>past</ID>"
                   "<Status>Enabled</Status><Filter><Prefix>exp/</Prefix>"
                   "</Filter><Expiration><Date>2020-01-01T00:00:00Z</Date>"
                   "</Expiration></Rule></LifecycleConfiguration>")
            if c.send("PUT", "/lcy", query={"lifecycle": ""},
                      body=doc.encode())[0] != 200:
                fail("namespace: PUT lifecycle")
            if not mgr.drain(60):
                fail("namespace: the journal did not drain")
            w1 = walk_counts()
            t0 = time.perf_counter()
            usage = node.crawler.scan_once()
            lc_s = time.perf_counter() - t0
            lc_walks = walk_counts(w1)
            note(f"lifecycle crawl in {lc_s:.1f} s")
            if not mgr.drain(60):
                fail("namespace: the journal did not drain")
            statuses = [c.send("GET", f"/lcy/{n}")[0]
                        for n in lc_names[:n_exp]]
            fb0 = mgr.stats()["fallbacks"]
            left, _ = list_v2_pages(c, "lcy", page)
            left = [n for p in left for n in p]
            if set(statuses) != {404} or left != lc_names[n_exp:] or \
                    mgr.stats()["fallbacks"] != fb0 or \
                    lc_walks.get("crawler/merge"):
                fail(f"namespace lifecycle: statuses {set(statuses)}, "
                     f"{len(left)} listed, walks {lc_walks}")
            out["lifecycle"] = {"objects": n_lc, "expired": n_exp,
                                "crawler_wall_s": round(lc_s, 3),
                                "crawled": usage["buckets"]["lcy"],
                                "gets_404": len(statuses),
                                "listed_after": len(left),
                                "walks": lc_walks}

            # -- the read cache -------------------------------------------
            n_obj, size = NS_CACHE
            if c.send("PUT", "/hot")[0] != 200:
                fail("namespace: make bucket hot")
            plain = {f"obj-{i}": rng.bytes(size) for i in range(n_obj)}
            sse_data = rng.bytes(NS_SSE)
            sse_hdr = {"x-amz-server-side-encryption": "AES256"}
            for n, d in plain.items():
                if c.send("PUT", f"/hot/{n}", body=d)[0] != 200:
                    fail(f"namespace: PUT hot/{n}")
            if c.send("PUT", "/hot/sse", body=sse_data,
                      headers=sse_hdr)[0] != 200:
                fail("namespace: PUT hot/sse")
            if c.send("PUT", "/hot/lineitem.csv", body=lineitem)[0] != 200:
                fail("namespace: PUT hot/lineitem.csv")
            # two drives that hold a data shard of every object
            keys = [*plain, "sse", "lineitem.csv"]
            # the MRF queue is closed: a shard write the quorum-ack lane
            # left behind heals here, before 2 of the 6+2 drives go
            out["cache_left_behind"] = sum(
                layer.heal_object("hot", n).disks_healed for n in keys)
            pair = next(
                ((a, b) for a in range(1, k + m) for b in range(a + 1, k + m)
                 if all(min(hash_order(f"hot/{n}", k + m)[a],
                            hash_order(f"hot/{n}", k + m)[b]) <= k
                        for n in keys)), None)
            if pair is None:
                fail("namespace: no 2 drives hold a data shard of every "
                     "object")
            for j in pair:
                shutil.rmtree(os.path.join(drives[j], "hot"))
            cache = node.read_cache
            gets = {}
            note("cache objects PUT")

            def get(path, headers=None):
                v0, c0, s0 = verbs(node), counts.read(), \
                    eng_mod.GET_STREAMS.value()
                h0 = cache.hits
                t0 = time.perf_counter()
                r = c.send("GET", path, headers=headers)
                wall = time.perf_counter() - t0
                v1, c1 = verbs(node), counts.read()
                return r, {"wall_s": round(wall, 4),
                           "decode_dispatches": since(v0, v1, "decode"),
                           "decipher_dispatches": since(v0, v1,
                                                        "decipher"),
                           "erasure_streams":
                               eng_mod.GET_STREAMS.value() - s0,
                           "hit": cache.hits - h0,
                           "launches": {n: c1[n] - c0[n] for n in c1}}

            for n, d in plain.items():
                md5 = hashlib.md5(d).hexdigest()
                gets[n] = []
                for _round in range(3):
                    r, rec = get(f"/hot/{n}")
                    if r[0] != 200 or r[2] != d or \
                            r[1].get("etag", "").strip('"') != md5:
                        fail(f"namespace cache GET {n}: HTTP {r[0]}, bytes "
                             "or ETag differ")
                    gets[n].append(rec)
                miss = gets[n][:2]
                hit = gets[n][2]
                if any(g["decode_dispatches"] <= 0
                       or g["launches"]["gf_matmul"] <= 0 for g in miss) \
                        or hit["hit"] != 1 or hit["decode_dispatches"] \
                        or hit["launches"]["gf_matmul"] \
                        or hit["erasure_streams"]:
                    fail(f"namespace cache {n}: {gets[n]}")
            sse_gets, served = [], None
            for _round in range(6):
                r, rec = get("/hot/sse", sse_hdr)
                if r[0] != 200 or r[2] != sse_data:
                    fail(f"namespace cache SSE GET: HTTP {r[0]}")
                sse_gets.append(rec)
                if rec["hit"] and not rec["decode_dispatches"]:
                    served = rec
                    break
            if served is None or served["launches"]["chacha20"] <= 0 or \
                    served["decipher_dispatches"] <= 0 or \
                    served["erasure_streams"]:
                fail(f"namespace cache SSE: {sse_gets}")
            sels = []
            note("cache GETs done")
            for _round in range(3):
                v0, c0, h0 = verbs(node), counts.read(), cache.hits
                t0 = time.perf_counter()
                r = c.send("POST", "/hot/lineitem.csv",
                           query={"select": "", "select-type": "2"},
                           body=sc.select_xml(sc.Q6_COUNT))
                wall = time.perf_counter() - t0
                v1, c1 = verbs(node), counts.read()
                if r[0] != 200 or r[2] != q6_oracle:
                    fail(f"namespace cached Select {_round}: HTTP {r[0]}, "
                         f"{len(r[2])} B against the evaluator's "
                         f"{len(q6_oracle)} B: the responses differ")
                sels.append({"wall_s": round(wall, 4),
                             "decode_dispatches": since(v0, v1, "decode"),
                             "scan_dispatches": since(v0, v1, "scan"),
                             "hit": cache.hits - h0,
                             "launches": {n: c1[n] - c0[n] for n in c1}})
            if sels[2]["hit"] != 1 or sels[2]["decode_dispatches"] or \
                    sels[2]["launches"]["scan_eval"] < 1:
                fail(f"namespace cached Select: {sels}")
            gib = size / (1 << 30)
            out["cache"] = {
                "objects": n_obj, "object_bytes": size,
                "removed_drives": list(pair),
                "miss_gib_s": round(gib * n_obj / sum(
                    g[0]["wall_s"] for g in gets.values()), 4),
                "fill_gib_s": round(gib * n_obj / sum(
                    g[1]["wall_s"] for g in gets.values()), 4),
                "hit_gib_s": round(gib * n_obj / sum(
                    g[2]["wall_s"] for g in gets.values()), 4),
                "gets": gets, "sse_object_bytes": NS_SSE,
                "sse_gets": sse_gets, "select_bytes": len(lineitem),
                "selects": sels, "stats": cache.stats()}
            out["metacache"] = {k2: v for k2, v in mgr.stats().items()
                                if k2 != "buckets"}
        except BaseException:
            node.shutdown()
            raise
    except BaseException:
        end_namespace(state)
        raise
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    out.update({"launches": counts.read(),
                "seconds": round(time.perf_counter() - t_phase, 3),
                "card": card})
    emit(out)
    state.update(creds=creds, k=k, m=m, payload_hot=plain,
                 sse_data=sse_data, pair=list(pair))
    return out, node, state


def end_namespace(state: dict) -> None:
    """Phase 14's clean-up, after phase 15 rode its node: the environment
    back as it was, the drives (and the tier beside them) removed."""
    for n, v in state["saved_env"].items():
        if v is None:
            os.environ.pop(n, None)
        else:
            os.environ[n] = v
    shutil.rmtree(state["root"], ignore_errors=True)


def list_keys_sizes(c, bucket: str) -> dict:
    """ListObjectsV2 over HTTP, all pages: key -> size."""
    import xml.etree.ElementTree as ET
    out, token = {}, None
    while True:
        q = {"list-type": "2", "max-keys": "1000"}
        if token:
            q["continuation-token"] = token
        st, _h, body = c.send("GET", f"/{bucket}", query=q)
        if st != 200:
            fail(f"tier ListObjectsV2 {bucket}: HTTP {st}")
        root = ET.fromstring(body)
        ns = root.tag[:root.tag.index("}") + 1] if "}" in root.tag else ""
        for e in root.findall(f"{ns}Contents"):
            out[e.findtext(f"{ns}Key")] = int(e.findtext(f"{ns}Size"))
        if root.findtext(f"{ns}IsTruncated") != "true":
            return out
        token = root.findtext(f"{ns}NextContinuationToken")


def local_bytes(drives: list, buckets: tuple) -> int:
    """Bytes of every file under the buckets' directories on the drives
    (shards and xl.meta)."""
    n = 0
    for d in drives:
        for b in buckets:
            for dirpath, _dirs, files in os.walk(os.path.join(d, b)):
                n += sum(os.path.getsize(os.path.join(dirpath, f))
                         for f in files)
    return n


def data_dirs(drives: list, bucket: str, name: str) -> int:
    """Data directories of one object over every drive."""
    n = 0
    for d in drives:
        p = os.path.join(d, bucket, name)
        if os.path.isdir(p):
            n += sum(1 for e in os.scandir(p) if e.is_dir())
    return n


def file_stats(root: str) -> dict:
    """path -> (size, mtime_ns, inode) of every file under root."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            st = os.stat(os.path.join(dirpath, f))
            out[os.path.join(dirpath, f)] = (st.st_size, st.st_mtime_ns,
                                             st.st_ino)
    return out


def file_md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def run_tier(node, state, card, counts, np, lineitem: bytes,
             q6_oracle: bytes) -> dict:
    """The tier plane on the card, on phase 14's node before it shuts
    down (its read cache and metacache on, its background loops stopped,
    its MRF queue closed, 2 of its 8 drives still without bucket hot).
    An fs tier `cold` beside the drives (tmpfs where phase 14 put them),
    added through the node's TierManager and so persisted to the pool; a
    lifecycle document PUT over HTTP on bucket hot (Transition Days 1 to
    cold), which holds phase 14's four 64 MiB objects, its SSE-S3 64 MiB
    object, phase 14's lineitem CSV and a new 4 x 16 MiB multipart
    object; a versioned bucket tierv whose key ver has a 16 MiB
    noncurrent version under NoncurrentVersionTransition (NoncurrentDays
    1). The Days rules are made due by the crawler's clock, two days
    ahead (phase 14's past Date has no noncurrent form).
    Transition: one crawler pass of the boot's actions enqueues every
    version, the node's worker drains them, each read degraded (a decode
    on the card); every remote file equals the object's stored stream
    (ciphertext for the SSE object: its stored stream is read first), no
    drive keeps a stubbed version's data directory; over HTTP a GET
    answers 403 InvalidObjectState, a HEAD carries the tier as storage
    class, the index lists every key at its size, and the cache serves
    no hit. Restore: the bucket healed back onto its 2 drives, POST
    ?restore (Days 1) for every stub, 202 each; those of 64 MiB or more
    pulled by the worker (a HEAD while it runs shows ongoing-request),
    then every GET byte- and ETag-equal to before (the SSE object
    deciphered by chacha20, the multipart object with its 4 parts, its
    -4 ETag and a ranged GET across a part boundary, the noncurrent
    version by id), and Q6's COUNT over the restored lineitem
    equal to its evaluator stream. Reclaim: a crawler pass past the
    restores' expiry returns each copy to its stub, the remote files
    untouched. Delete: a DELETE of one stub and a DeleteObjects of two
    free their remote files. Heal: one stub's xl.meta removed from a
    drive comes back with no recover dispatch and no launch."""
    from minio_tpu_torch.object.background import DataUsageCrawler
    from minio_tpu_torch.object.engine import GetOptions
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.scripts import scan_cases as sc
    from minio_tpu_torch.storage import datatypes as dt
    from minio_tpu_torch.tier.config import TierConfig
    from minio_tpu_torch.tier.transition import (
        noncurrent_transition_action, restore_reclaim_action,
        transition_action)
    from minio_tpu_torch.utils import knobs
    t_phase = time.perf_counter()
    drives = state["drives"]
    layer, cache, worker = node.object_layer, node.read_cache, \
        node.transition_worker
    bmeta = node.s3.api.bucket_meta
    c = S3Client(node.s3.port, state["creds"], timeout=300)
    rng = np.random.default_rng(SEED + 53)
    n_parts, part_size = TIER_PARTS
    out = {"phase": "tier", "drives": len(drives),
           "tier_on": "tmpfs (/dev/shm)" if state["on_shm"]
           else "the disk (tmp)"}
    counts.zero()

    def note(msg: str) -> None:
        print(f"[tier {time.perf_counter() - t_phase:.1f} s] {msg}",
              file=sys.stderr, flush=True)

    def verbs():
        return {v: dict(s)
                for v, s in node.scheduler.stats()["verbs"].items()}

    def since(a, b, verb):
        return b[verb]["batches"] - a[verb]["batches"]

    v_phase = verbs()
    tier_root = os.path.join(state["root"], "tier")
    node.tiers.add(TierConfig("cold", "fs", {"path": tier_root}))
    # the objects: phase 14's in bucket hot, a multipart one, and a
    # versioned key in tierv
    data = dict(state["payload_hot"])
    data["sse"] = state["sse_data"]
    data["lineitem.csv"] = lineitem
    parts = [rng.bytes(part_size) for _ in range(n_parts)]
    data["mp"] = b"".join(parts)
    st, _h, body = c.send("POST", "/hot/mp", query={"uploads": ""})
    if st != 200:
        fail(f"tier: initiate multipart: HTTP {st}")
    uid = body.split(b"<UploadId>")[1].split(b"<")[0].decode()
    etags = []
    for i, p in enumerate(parts):
        st, h, _ = c.send("PUT", "/hot/mp", body=p,
                          query={"partNumber": str(i + 1), "uploadId": uid})
        if st != 200:
            fail(f"tier: part {i + 1}: HTTP {st}")
        etags.append(h["etag"])
    done = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
        for i, e in enumerate(etags)) + "</CompleteMultipartUpload>")
    if c.send("POST", "/hot/mp", query={"uploadId": uid},
              body=done.encode())[0] != 200:
        fail("tier: complete multipart")
    if c.send("PUT", "/tierv")[0] != 200 or c.send(
            "PUT", "/tierv", query={"versioning": ""},
            body=b"<VersioningConfiguration><Status>Enabled</Status>"
                 b"</VersioningConfiguration>")[0] != 200:
        fail("tier: make the versioned bucket")
    vers = [rng.bytes(TIER_VERSION_BYTES) for _ in range(2)]
    vids = []
    for d in vers:
        st, h, _ = c.send("PUT", "/tierv/ver", body=d)
        if st != 200:
            fail(f"tier: PUT tierv/ver: HTTP {st}")
        vids.append(h["x-amz-version-id"])
    lc_hot = ("<LifecycleConfiguration><Rule><ID>cold</ID><Status>Enabled"
              "</Status><Filter><Prefix></Prefix></Filter><Transition>"
              "<Days>1</Days><StorageClass>cold</StorageClass></Transition>"
              "</Rule></LifecycleConfiguration>")
    lc_ver = ("<LifecycleConfiguration><Rule><ID>nc</ID><Status>Enabled"
              "</Status><Filter><Prefix></Prefix></Filter>"
              "<NoncurrentVersionTransition><NoncurrentDays>1"
              "</NoncurrentDays><StorageClass>cold</StorageClass>"
              "</NoncurrentVersionTransition></Rule>"
              "</LifecycleConfiguration>")
    for b, doc in (("hot", lc_hot), ("tierv", lc_ver)):
        if c.send("PUT", f"/{b}", query={"lifecycle": ""},
                  body=doc.encode())[0] != 200:
            fail(f"tier: PUT lifecycle on {b}")
    hot_names = [*state["payload_hot"], "sse", "lineitem.csv", "mp"]
    before = {}
    for n in hot_names:
        st, h, _ = c.send("HEAD", f"/hot/{n}")
        if st != 200:
            fail(f"tier: HEAD hot/{n}: HTTP {st}")
        before[n] = h["etag"]
    # the SSE object's stored stream (its ciphertext) is what moves
    info, stream = layer.get_object("hot", "sse")
    sse_stored = hashlib.md5()
    stored_size = 0
    for chunk in stream:
        sse_stored.update(chunk)
        stored_size += len(chunk)
    want_md5 = {n: hashlib.md5(d).hexdigest() for n, d in data.items()}
    want_md5["sse"] = sse_stored.hexdigest()
    want_md5["ver@0"] = hashlib.md5(vers[0]).hexdigest()
    sizes = {n: len(d) for n, d in data.items()}
    sizes["sse"] = stored_size
    moved_bytes = sum(sizes.values()) + len(vers[0])
    if not node.metacache.drain(60):
        fail("tier: the journal did not drain")
    listed_before = list_keys_sizes(c, "hot")
    if sorted(listed_before) != sorted(hot_names):
        fail(f"tier: the index lists {sorted(listed_before)}")
    buckets = ("hot", "tierv")
    local = {"before_transition": local_bytes(drives, buckets)}
    note("objects in place")

    # -- transition -----------------------------------------------------------
    later = time.time() + 2 * 86400
    crawler = DataUsageCrawler(
        layer, persist=False,
        actions=[transition_action(bmeta, worker, now_fn=lambda: later)],
        bucket_actions=[noncurrent_transition_action(
            bmeta, worker, now_fn=lambda: later)])
    v0, c0 = verbs(), counts.read()
    t0 = time.perf_counter()
    crawler.scan_once()
    if not worker.drain(600):
        fail(f"tier: the worker did not drain: {worker.stats()}")
    transition_s = time.perf_counter() - t0
    v1, c1 = verbs(), counts.read()
    stats_t = worker.stats()
    if stats_t["moved"] != len(hot_names) + 1 or stats_t["failed"]:
        fail(f"tier: transitions {stats_t}")
    note(f"transitioned in {transition_s:.1f} s")
    remote = {}
    for n in hot_names:
        md = layer.get_object_info("hot", n).user_defined
        remote[n] = md.get(dt.TRANSITIONED_OBJECT_KEY, "")
    md = layer.get_object_info(
        "tierv", "ver", GetOptions(version_id=vids[0])).user_defined
    remote["ver@0"] = md.get(dt.TRANSITIONED_OBJECT_KEY, "")
    if layer.get_object_info("tierv", "ver").user_defined.get(
            dt.TRANSITION_STATUS_KEY):
        fail("tier: the current version of tierv/ver transitioned")
    for n, key in remote.items():
        p = os.path.join(tier_root, key)
        size = sizes.get(n, len(vers[0]))
        if not key or not os.path.isfile(p) or \
                os.path.getsize(p) != size or file_md5(p) != want_md5[n]:
            fail(f"tier: the remote copy of {n} is not its stored stream")
    for n in hot_names:
        if data_dirs(drives, "hot", n):
            fail(f"tier: a drive keeps a data directory of hot/{n}")
    if data_dirs(drives, "tierv", "ver") != len(drives):
        fail("tier: tierv/ver keeps more than its current version's data")
    local["after_transition"] = local_bytes(drives, buckets)
    h0 = cache.hits
    for n in hot_names:
        st, _h, body = c.send("GET", f"/hot/{n}")
        if st != 403 or b"InvalidObjectState" not in body:
            fail(f"tier: GET of the stub hot/{n}: HTTP {st}")
        st, h, _ = c.send("HEAD", f"/hot/{n}")
        if st != 200 or h.get("x-amz-storage-class") != "cold" or \
                h.get("etag") != before[n]:
            fail(f"tier: HEAD of the stub hot/{n}: {st} {h}")
    if cache.hits != h0:
        fail("tier: the read cache served a stub")
    if not node.metacache.drain(60):
        fail("tier: the journal did not drain")
    listed = list_keys_sizes(c, "hot")
    if listed != listed_before:
        fail(f"tier: the index lists {listed}, {listed_before} before")
    if not node.metacache.drain(60):
        fail("tier: the journal did not drain")
    out["transition"] = {
        "versions": len(remote), "moved_bytes": moved_bytes,
        "wall_s": round(transition_s, 3),
        "gib_s": round(moved_bytes / (1 << 30) / transition_s, 4),
        "decode_dispatches": since(v0, v1, "decode"),
        "launches": {k: c1[k] - c0[k] for k in c1},
        "worker": stats_t}

    # -- restore --------------------------------------------------------------
    layer.heal_bucket("hot")
    v0, c0 = verbs(), counts.read()
    t0 = time.perf_counter()
    body = b"<RestoreRequest><Days>1</Days></RestoreRequest>"
    posts, ongoing = {}, []
    for n in hot_names:
        posts[n] = c.send("POST", f"/hot/{n}", query={"restore": ""},
                          body=body)[0]
        # a pull the worker has not finished shows as ongoing
        if 'ongoing-request="true"' in c.send(
                "HEAD", f"/hot/{n}")[1].get("x-amz-restore", ""):
            ongoing.append(n)
    posts["ver@0"] = c.send("POST", "/tierv/ver",
                            query={"restore": "", "versionId": vids[0]},
                            body=body)[0]
    if set(posts.values()) != {202}:
        fail(f"tier: RestoreObject answered {posts}")
    if not worker.drain(600):
        fail(f"tier: the restores did not drain: {worker.stats()}")
    restore_s = time.perf_counter() - t0
    v1, c1 = verbs(), counts.read()
    stats_r = worker.stats()
    async_bytes = knobs.get_int("MINIO_TPU_RESTORE_ASYNC_BYTES")
    async_n = sum(1 for n in hot_names if sizes[n] >= async_bytes)
    if not ongoing or stats_r["restored"] != async_n or \
            stats_r["restore_failed"]:
        fail(f"tier: async restores {stats_r}, ongoing {ongoing}")
    note(f"restored in {restore_s:.1f} s")
    local["after_restore"] = local_bytes(drives, buckets)
    gets = {}
    for n in hot_names:
        v2, c2 = verbs(), counts.read()
        st, h, got = c.send("GET", f"/hot/{n}")
        c3 = counts.read()
        if st != 200 or got != data[n] or h.get("etag") != before[n] or \
                'ongoing-request="false"' not in h.get("x-amz-restore", ""):
            fail(f"tier: GET of the restored hot/{n}: HTTP {st}, bytes or "
                 "ETag differ")
        gets[n] = {"decipher_dispatches": since(v2, verbs(), "decipher"),
                   "launches": {k: c3[k] - c2[k] for k in c3}}
    if gets["sse"]["launches"]["chacha20"] <= 0:
        fail(f"tier: the restored SSE object was not deciphered on the "
             f"card: {gets['sse']}")
    mp = layer.get_object_info("hot", "mp")
    if [p.size for p in mp.parts] != [part_size] * n_parts or \
            not mp.etag.endswith(f"-{n_parts}"):
        fail(f"tier: the restored multipart object: {mp.parts} {mp.etag}")
    lo = part_size - 5
    st, _h, got = c.send("GET", "/hot/mp",
                         headers={"range": f"bytes={lo}-{lo + 9}"})
    if st != 206 or got != data["mp"][lo:lo + 10]:
        fail(f"tier: ranged GET across a part boundary: HTTP {st}")
    st, h, got = c.send("GET", "/tierv/ver", query={"versionId": vids[0]})
    if st != 200 or got != vers[0]:
        fail(f"tier: GET of the restored noncurrent version: HTTP {st}")
    c2 = counts.read()
    t1 = time.perf_counter()
    st, _h, got = c.send("POST", "/hot/lineitem.csv",
                         query={"select": "", "select-type": "2"},
                         body=sc.select_xml(sc.Q6_COUNT))
    select_s = time.perf_counter() - t1
    c3 = counts.read()
    if st != 200 or got != q6_oracle or c3["scan_eval"] <= c2["scan_eval"]:
        fail(f"tier: the Select over the restored lineitem: HTTP {st}, "
             f"{len(got)} B against the evaluator's {len(q6_oracle)} B")
    out["restore"] = {
        "restored_bytes": moved_bytes, "wall_s": round(restore_s, 3),
        "gib_s": round(moved_bytes / (1 << 30) / restore_s, 4),
        "posts": posts, "async": async_n, "seen_ongoing": ongoing,
        "encode_dispatches": since(v0, v1, "encode"),
        "launches": {k: c1[k] - c0[k] for k in c1},
        "worker": stats_r, "gets": gets,
        "select_wall_s": round(select_s, 3)}

    # -- reclaim --------------------------------------------------------------
    tier_stat = file_stats(tier_root)
    past = time.time() + 3 * 86400
    crawler = DataUsageCrawler(layer, persist=False, actions=[
        restore_reclaim_action(layer, node.tiers, now_fn=lambda: past)])
    t0 = time.perf_counter()
    crawler.scan_once()
    reclaim_s = time.perf_counter() - t0
    note(f"reclaimed in {reclaim_s:.1f} s")
    for n in hot_names:
        md = layer.get_object_info("hot", n).user_defined
        if dt.is_restored(md) or data_dirs(drives, "hot", n):
            fail(f"tier: hot/{n} was not returned to its stub")
    # the reclaim visits current versions only (the per-object action of
    # the crawler, as in the reference): the restored noncurrent version
    # keeps its local copy beside the current one
    if data_dirs(drives, "tierv", "ver") != 2 * len(drives):
        fail("tier: tierv/ver's versions lost or kept data")
    if file_stats(tier_root) != tier_stat:
        fail("tier: the reclaim touched the remote files")
    local["after_reclaim"] = local_bytes(drives, buckets)
    out["reclaim"] = {"wall_s": round(reclaim_s, 3)}

    # -- delete and heal ------------------------------------------------------
    one, two = hot_names[0], hot_names[1:3]
    if c.send("DELETE", f"/hot/{one}")[0] != 204:
        fail(f"tier: DELETE hot/{one}")
    body = ("<Delete>" + "".join(f"<Object><Key>{n}</Key></Object>"
                                 for n in two) + "</Delete>").encode()
    if c.send("POST", "/hot", query={"delete": ""}, body=body)[0] != 200:
        fail("tier: DeleteObjects")
    for n in [one, *two]:
        if os.path.exists(os.path.join(tier_root, remote[n])):
            fail(f"tier: the remote copy of deleted hot/{n} is still there")
    for n in hot_names[3:]:
        if not os.path.exists(os.path.join(tier_root, remote[n])):
            fail(f"tier: the remote copy of hot/{n} went with the deletes")
    victim = hot_names[3]
    meta_path = next(p for p in (os.path.join(d, "hot", victim, "xl.meta")
                                 for d in drives) if os.path.exists(p))
    os.remove(meta_path)
    v0, c0 = verbs(), counts.read()
    res = layer.heal_object("hot", victim)
    v1, c1 = verbs(), counts.read()
    heal = {"disks_healed": res.disks_healed,
            "recover_dispatches": since(v0, v1, "recover"),
            "launches": {k: c1[k] - c0[k] for k in c1}}
    if not os.path.exists(meta_path) or res.disks_healed != 1 or \
            heal["recover_dispatches"] or any(heal["launches"].values()):
        fail(f"tier: the stub heal {heal}")
    out["delete_heal"] = {"deleted": [one, *two], "stub_heal": heal}

    launches = counts.read()
    v_end = verbs()
    if any(launches[k] <= 0 for k in ("gf_matmul", "hh256", "chacha20",
                                      "scan_eval")):
        fail(f"tier: a kernel of the path was not launched: {launches}")
    out.update({"local_bytes": local,
                "dispatches": {v: since(v_phase, v_end, v)
                               for v in ("decode", "encode", "recover",
                                         "decipher", "scan")},
                "worker": worker.stats(), "launches": launches,
                "seconds": round(time.perf_counter() - t_phase, 3),
                "card": card})
    emit(out)
    return out


def pool_drives(root: str, pool: int, n: int) -> list:
    return [os.path.join(root, f"p{pool}d{i}") for i in range(n)]


def run_pools(tmp, card, counts, np) -> dict:
    """The pool plane on the card, bench.py's bench_rebalance_ab at
    card-sized objects: cluster.start_single over pool 0's 8 drives at EC
    6+2 with 1 MiB blocks (on tmpfs where /dev/shm has POOLS_SHM_MIN_BYTES
    free, else under tmp), the ChaCha20 SSE cipher, the metacache off (as
    in the bench: the rebalancer takes the merge walk, and its drain off
    the index feed is held on the CPU by tests/test_torch_pools.py; with
    the index on, a drain leaves pool 0's persisted manifest dangling, in
    the reference too, which fsck would count beside the planted faults),
    the heal
    scanner and the crawler stopped and pool 0's MRF queue closed, so that
    the drain's degraded reads stay degraded. Preload over signed HTTP,
    before pool 1 exists: POOLS_BIG 64 MiB objects and one 12,345 B
    longer, POOLS_SMALL 2 MiB objects (the bench's drain inventory, below
    the codec's 8 MiB gate: they move on the host), one SSE-S3 object, a
    versioned key (v1, a delete marker, v2) and a 4 x 16 MiB multipart
    session with two parts uploaded. Then 2 of pool 0's drives lose their
    buckets' directories, pool 1 (8 more drives) joins through
    node.add_pool (the CLI's --pool path), two rounds of 8 concurrent 16
    MiB PUTs into pool 1's engine are timed (the bench's foreground), the
    drain starts (start_decommission(0), the session given a grace past
    the phase so that the client's next part migrates it), rounds are
    timed during it until POOLS_DURING[0] of them each had a move of the
    walker in flight for half their window or more (the walker yields to
    a busy former; each move is timed from this process), parts 3 and 4
    are uploaded over HTTP (the first
    migrates the session to pool 1) and the upload completes. The drain
    must complete within POOLS_DRAIN_DEADLINE_S with no failed object;
    every object then GETs back over HTTP byte- and ETag-equal (chacha20
    deciphers the SSE object), the versioned key keeps its ids, mod times
    and marker, the multipart object its -4 ETag, and pool 0 holds
    nothing. fsck: six faults planted, one of each of missing_shards (a
    64 MiB object's data dir moved off 2 drives and kept aside),
    meta_missing, orphan_data, stale_tmp, torn_registry (pool 0's copy of
    the topology doc) and orphan_metacache_segment; run_fsck audits
    (counts equal to the planted), repairs (the 64 MiB object recovered
    through heal_step on the card, its shard files equal to the kept
    ones) and audits again (clean). Boot fsck: the node shut down, a stale
    tmp dir and an orphan data dir planted in pool 0 and a stale tmp dir
    in pool 1, the node booted again over pool 0 with
    MINIO_TPU_FSCK_BOOT=on (and the tmp age gate at 0: nothing is in
    flight at a boot) and pool 1 re-added as the CLI does; the boot's
    report repairs pool 0's two, an audit after the boot finds pool 1's
    (the boot's audit ran before the pool joined, as in the reference), a
    run_fsck repairs it and the next audit is clean, and the re-armed
    drain (pool 0 is still draining in the topology doc) completes moving
    nothing."""
    import concurrent.futures as cf

    from minio_tpu_torch import cluster
    from minio_tpu_torch.object.fsck import run_fsck
    from minio_tpu_torch.object.metacache import mc_prefix
    from minio_tpu_torch.object.rebalance import Rebalancer
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.storage.xl_storage import MINIO_META_BUCKET
    k, m, bs = 6, 2, 1 << 20
    n = k + m
    move_object = Rebalancer._move_object
    rng = np.random.default_rng(SEED + 61)
    env = {"MINIO_TPU_METACACHE": "off",
           "MINIO_SSE_MASTER_KEY": rng.bytes(32).hex(),
           "MINIO_TPU_SSE_CIPHER": "chacha20"}
    saved_env = {v: os.environ.get(v)
                 for v in (*env, "MINIO_TPU_FSCK_BOOT",
                           "MINIO_TPU_FSCK_TMP_AGE_S")}
    os.environ.update(env)
    shm = "/dev/shm"
    on_shm = os.path.isdir(shm) and \
        shutil.disk_usage(shm).free >= POOLS_SHM_MIN_BYTES
    root = tempfile.mkdtemp(prefix="chip_smoke_pools_",
                            dir=shm if on_shm else tmp)
    drives0, drives1 = pool_drives(root, 0, n), pool_drives(root, 1, n)
    creds = Credentials("smokepools", "smokepoolssecret")
    t_phase = time.perf_counter()
    out = {"phase": "pools", "pools": 2, "drives_per_pool": n,
           "ec": f"{k}+{m}", "block_size": bs,
           "drives_on": "tmpfs (/dev/shm)" if on_shm else "the disk (tmp)"}
    counts.zero()

    def note(msg: str) -> None:
        print(f"[pools {time.perf_counter() - t_phase:.1f} s] {msg}",
              file=sys.stderr, flush=True)

    def boot():
        node = cluster.start_single(drives0, creds=creds, parity=m,
                                    set_drive_count=n, block_size=bs)
        for loop in (node.heal_scanner, node.crawler):
            loop.close()
            if loop._thread is not None:
                loop._thread.join(timeout=120)
                if loop._thread.is_alive():
                    fail("pools: a background loop did not stop")
        return node

    def verbs(node):
        return {v: dict(s)
                for v, s in node.scheduler.stats()["verbs"].items()}

    def since(a, b, verb, key="batches"):
        return b[verb][key] - a[verb][key]

    def ok(resp, what):
        if resp[0] not in (200, 204):
            fail(f"pools: {what}: HTTP {resp[0]} {resp[2][:300]!r}")
        return resp

    node = boot()
    try:
        layer = node.object_layer
        c = S3Client(node.s3.port, creds, timeout=300)
        # -- preload pool 0 ---------------------------------------------------
        n_big, big = POOLS_BIG
        n_small, small = POOLS_SMALL
        data = {f"big-{i:02d}": rng.bytes(big) for i in range(n_big)}
        data["big-tail"] = rng.bytes(big + 12345)
        data.update({f"small-{i:02d}": rng.bytes(small)
                     for i in range(n_small)})
        sse_data = rng.bytes(POOLS_SSE)
        sse_hdrs = {"x-amz-server-side-encryption": "AES256"}
        for b in ("pools", "poolsv"):
            ok(c.send("PUT", f"/{b}"), f"make bucket {b}")
        ok(c.send("PUT", "/poolsv", query={"versioning": ""},
                  body=b"<VersioningConfiguration><Status>Enabled</Status>"
                       b"</VersioningConfiguration>"), "versioning")
        t0 = time.perf_counter()
        etags = {}

        def put(name):
            h = ok(c.send("PUT", f"/pools/{name}", body=data[name]),
                   f"PUT {name}")[1]
            return name, h["etag"]

        with cf.ThreadPoolExecutor(max_workers=8) as ex:
            etags.update(ex.map(put, sorted(data)))
        h = ok(c.send("PUT", "/pools/sse", body=sse_data,
                      headers=sse_hdrs), "PUT sse")[1]
        etags["sse"] = h["etag"]
        vers = [rng.bytes(POOLS_VERSION_BYTES) for _ in range(2)]
        vids = [ok(c.send("PUT", "/poolsv/ver", body=vers[0]),
                   "PUT v1")[1]["x-amz-version-id"]]
        ok(c.send("DELETE", "/poolsv/ver"), "DELETE (marker)")
        vids.append(ok(c.send("PUT", "/poolsv/ver", body=vers[1]),
                       "PUT v2")[1]["x-amz-version-id"])
        n_parts, part_size = POOLS_PARTS
        parts = [rng.bytes(part_size) for _ in range(n_parts)]
        st, _h, body = ok(c.send("POST", "/pools/mp",
                                 query={"uploads": ""}), "initiate")
        uid = body.split(b"<UploadId>")[1].split(b"<")[0].decode()
        part_etags = []

        def put_part(i):
            h = ok(c.send("PUT", "/pools/mp", body=parts[i], query={
                "partNumber": str(i + 1), "uploadId": uid}),
                f"part {i + 1}")[1]
            part_etags.append(h["etag"])

        for i in range(2):
            put_part(i)
        preload_s = time.perf_counter() - t0
        client_bytes = sum(map(len, data.values())) + len(sse_data) + \
            2 * POOLS_VERSION_BYTES + 2 * part_size
        versions_before = [(v.version_id, v.delete_marker, v.mod_time)
                           for v in layer.object_versions("poolsv", "ver")]
        if len(versions_before) != 3 or \
                [v[1] for v in versions_before] != [False, True, False]:
            fail(f"pools: the versioned key holds {versions_before}")
        note(f"preloaded {client_bytes} B in {preload_s:.1f} s")
        out["preload"] = {"client_bytes": client_bytes,
                          "objects": len(data) + 1, "wall_s":
                          round(preload_s, 3)}
        # -- degrade pool 0, add pool 1 ---------------------------------------
        # a shard write the quorum-ack lane left behind heals through MRF
        # before 2 of the 6+2 drives lose their buckets
        if not layer.drain_mrf(timeout=120):
            fail("pools: the MRF queue did not drain before the degrade")
        node.sets.mrf.close()
        for j in POOLS_GONE:
            for b in ("pools", "poolsv"):
                shutil.rmtree(os.path.join(drives0[j], b))
        t0 = time.perf_counter()
        if node.add_pool(drives1, set_drive_count=n, parity=m) != 1:
            fail("pools: add_pool did not return pool 1")
        out["add_pool_s"] = round(time.perf_counter() - t0, 3)
        if layer.topology.states != ["active", "active"] or \
                node.disk_monitor.pools[1] is not layer.server_sets[1]:
            fail(f"pools: after add_pool {layer.topology.to_dict()}")
        # -- foreground PUTs before and during the drain ----------------------
        fg_streams, fg_size = POOLS_FOREGROUND
        fg_payload = rng.bytes(fg_size)
        fg_etag = hashlib.md5(fg_payload).hexdigest()

        def put_round(prefix):
            def one(i):
                t = time.perf_counter()
                info = layer.server_sets[1].put_object(
                    "pools", f"{prefix}-{i}", fg_payload)
                if info.etag != fg_etag:
                    fail(f"pools: foreground PUT {prefix}-{i} ETag")
                return time.perf_counter() - t
            with cf.ThreadPoolExecutor(max_workers=fg_streams) as ex:
                return list(ex.map(one, range(fg_streams)))

        put_round("fg-warm")
        vb, cb = verbs(node), counts.read()
        base = put_round("fg-base") + put_round("fg-base2")
        v0, c0 = verbs(node), counts.read()
        # what two foreground rounds dispatch alone (the drain's window
        # below holds two such rounds besides the drain)
        fg_alone = {"encode": {"batches": since(vb, v0, "encode"),
                               "host_routed": since(vb, v0, "encode",
                                                    "host_routed")},
                    "launches": {k2: c0[k2] - cb[k2] for k2 in c0}}
        # the walker's own move seconds: each _move_object call (one
        # walker thread, so they never overlap) timed from this process
        moves, in_move = [], [None]

        def timed_move(self, *a, **kw):
            in_move[0] = time.perf_counter()
            try:
                return move_object(self, *a, **kw)
            finally:
                moves.append((in_move[0], time.perf_counter()))
                in_move[0] = None

        def move_overlap(t0, t1):
            spans = list(moves)
            if in_move[0] is not None:
                spans.append((in_move[0], t1))
            return sum(max(0.0, min(t1, b) - max(t0, a)) for a, b in spans)

        Rebalancer._move_object = timed_move
        t_drain = time.perf_counter()
        started = layer.start_decommission(0, mpu_grace_s=POOLS_MPU_GRACE_S)
        if started["status"] != "draining":
            fail(f"pools: start_decommission {started}")
        reb = layer._rebalancer
        # foreground rounds until POOLS_DURING[0] of them each had a move
        # in flight for half their window or more: the throttle makes the
        # walker yield to a busy former (up to BACKOFF_TRIES waits, then it
        # moves anyway), so a round may see no move at all
        need, most = POOLS_DURING
        during, rounds = [], []
        while len(rounds) < most and \
                sum(r["overlapped"] for r in rounds) < need and \
                reb.running():
            t0 = time.perf_counter()
            lat = put_round(f"fg-dr{len(rounds)}")
            t1 = time.perf_counter()
            share = move_overlap(t0, t1) / (t1 - t0)
            rounds.append({"wall_s": round(t1 - t0, 4),
                           "move_share": round(share, 4),
                           "overlapped": share >= 0.5})
            if share >= 0.5:
                during += lat
        at_measure = {k2: reb.status().get(k2) for k2 in
                      ("status", "objects_moved", "bytes_moved")}
        if layer._zone_index_of_upload("pools", "mp", uid) != 0:
            fail("pools: the session left pool 0 before its next part")
        for i in range(2, n_parts):
            put_part(i)
            if i == 2 and \
                    layer._zone_index_of_upload("pools", "mp", uid) != 1:
                fail("pools: part 3 did not migrate the session")
        done = ("<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag>"
            "</Part>" for i, e in enumerate(part_etags)) +
            "</CompleteMultipartUpload>")
        h = ok(c.send("POST", "/pools/mp", query={"uploadId": uid},
                      body=done.encode()), "complete")
        deadline = time.monotonic() + POOLS_DRAIN_DEADLINE_S
        while reb.running() and time.monotonic() < deadline:
            time.sleep(0.05)
        drain_s = time.perf_counter() - t_drain
        Rebalancer._move_object = move_object
        v1, c1 = verbs(node), counts.read()
        st = reb.status()
        if st["status"] != "complete" or st["objects_failed"] or \
                st["mpu_failed"]:
            fail(f"pools: the drain ended {st}")
        note(f"drained in {drain_s:.1f} s: {st['objects_moved']} objects")
        # -- read back --------------------------------------------------------
        data["mp"] = b"".join(parts)
        t0 = time.perf_counter()
        mp_head = ok(c.send("HEAD", "/pools/mp"), "HEAD mp")[1]
        if not mp_head["etag"].strip('"').endswith(f"-{n_parts}"):
            fail(f"pools: the multipart ETag {mp_head['etag']}")
        etags["mp"] = mp_head["etag"]
        for name, body_want in data.items():
            st_, h, got = c.send("GET", f"/pools/{name}")
            if st_ != 200 or got != body_want or h["etag"] != etags[name]:
                fail(f"pools: GET {name} after the drain: HTTP {st_}")
            if name != "mp" and \
                    h["etag"] != f'"{hashlib.md5(got).hexdigest()}"':
                fail(f"pools: {name}'s ETag is not its MD5")
        c2 = counts.read()
        st_, h, got = c.send("GET", "/pools/sse", headers=sse_hdrs)
        c3 = counts.read()
        if st_ != 200 or got != sse_data or h["etag"] != etags["sse"]:
            fail(f"pools: GET sse after the drain: HTTP {st_}")
        if c3["chacha20"] <= c2["chacha20"]:
            fail("pools: the SSE object was not deciphered on the card")
        for vid, want in zip(vids, vers):
            st_, _h, got = c.send("GET", "/poolsv/ver",
                                  query={"versionId": vid})
            if st_ != 200 or got != want:
                fail(f"pools: GET poolsv/ver?versionId={vid}: HTTP {st_}")
        versions_after = [(v.version_id, v.delete_marker, v.mod_time)
                          for v in layer.object_versions("poolsv", "ver")]
        if versions_after != versions_before:
            fail(f"pools: versions {versions_after} != {versions_before}")
        for p in ("fg-base", "fg-base2",
                  *(f"fg-dr{i}" for i in range(len(rounds)))):
            for i in range(fg_streams):
                st_, h, _ = c.send("HEAD", f"/pools/{p}-{i}")
                if st_ != 200 or h["etag"] != f'"{fg_etag}"':
                    fail(f"pools: HEAD of foreground {p}-{i}: HTTP {st_}")
        read_s = time.perf_counter() - t0
        src = layer.server_sets[0]
        for b in ("pools", "poolsv"):
            if src.list_object_versions(b, max_keys=10)[0]:
                fail(f"pools: pool 0 still lists objects in {b}")
        if src.list_all_multipart_uploads():
            fail("pools: pool 0 still holds a multipart session")
        if Rebalancer.load_checkpoint(layer, 0)["objects_moved"] != \
                st["objects_moved"]:
            fail("pools: the persisted checkpoint is not the drain's")
        moved = st["bytes_moved"]
        move_s = sum(b - a for a, b in moves)
        out["drain"] = {
            "wall_s": round(drain_s, 3), "bytes_moved": moved,
            # over the window: the walker's yields to the foreground, the
            # rounds, parts 3-4 and the complete included
            "gib_s": round(moved / (1 << 30) / drain_s, 4),
            # over the walker's own move seconds
            "walker_move_s": round(move_s, 3),
            "walker_gib_s": round(moved / (1 << 30) / max(move_s, 1e-9), 4),
            "walker_moves": len(moves),
            "objects_moved": st["objects_moved"],
            "objects_failed": st["objects_failed"],
            "mpu_migrated_by_the_walker": st["mpu_migrated"],
            "passes": st["passes"],
            # start_decommission to complete: the drain, the session's
            # migration, parts 3-4 and the foreground rounds
            "window_dispatches": {
                v: {"batches": since(v0, v1, v),
                    "host_routed": since(v0, v1, v, "host_routed")}
                for v in ("decode", "encode", "recover")},
            "window_launches": {k2: c1[k2] - c0[k2] for k2 in c1},
            "two_foreground_rounds_alone": fg_alone,
            "foreground_rounds_in_window": len(rounds),
            "status_at_measure": at_measure,
            "read_back_s": round(read_s, 3)}
        # "during" holds only the rounds that had a move in flight for
        # half their window or more; with none, the metric is not measured
        out["foreground"] = {
            "streams": fg_streams, "bytes": fg_size,
            "before": pct_ms(base), "rounds_during_drain": rounds,
            "during": pct_ms(during) if during else None,
            "put_p99_degradation_x": round(
                pct_ms(during)["p99_ms"] / max(pct_ms(base)["p99_ms"],
                                               1e-9), 3)
            if during else None}
        if since(v0, v1, "decode") - since(v0, v1, "decode",
                                           "host_routed") <= 0 or \
                since(v0, v1, "encode") - since(v0, v1, "encode",
                                                "host_routed") <= 0:
            fail(f"pools: the drain ran no decode or encode on the card: "
                 f"{out['drain']['window_dispatches']}")
        # -- fsck: plant one fault of six classes -----------------------------
        # pool 1's writes left behind heal through its MRF queue first: fsck
        # must find only what is planted
        if not layer.server_sets[1].drain_mrf(timeout=120):
            fail("pools: pool 1's MRF queue did not drain before fsck")
        eng1 = layer.server_sets[1].sets[0]
        victim, lost = "big-00", (2, 5)
        ddir = eng1.disks[0].read_versions("pools", victim)[0].data_dir
        aside = os.path.join(root, "aside")
        kept = {}
        for j in lost:
            p = os.path.join(drives1[j], "pools", victim, ddir)
            kept[j] = tree_files(p)
            shutil.move(p, os.path.join(aside, str(j)))
        os.remove(os.path.join(drives1[3], "pools", "small-00", "xl.meta"))
        orphan = os.path.join(drives1[4], "pools", "big-01",
                              "00000000-dead-0000-0000-000000000000")
        os.makedirs(orphan)
        with open(os.path.join(orphan, "part.1"), "wb") as f:
            f.write(b"junk")
        stale = os.path.join(drives1[6], ".minio.sys", "tmp", "crashed")
        os.makedirs(stale)
        with open(os.path.join(stale, "part.1"), "wb") as f:
            f.write(b"junk")
        layer.server_sets[0].put_object(MINIO_META_BUCKET,
                                        "topology/pools.json", b'{"epo')
        layer.server_sets[1].put_object(
            MINIO_META_BUCKET, mc_prefix("pools") + "seg-dead.json", b"[]")
        planted = {"missing_shards": 1, "meta_missing": 1,
                   "orphan_data": 1, "stale_tmp": 1, "torn_registry": 1,
                   "orphan_metacache_segment": 1}
        passes = {}
        reports = {}
        v0, c0 = verbs(node), counts.read()
        for label, repair in (("audit", False), ("repair", True),
                              ("again", False)):
            t0 = time.perf_counter()
            rep = run_fsck(layer, repair=repair, tiers=node.tiers,
                           tmp_age_s=0)
            passes[label] = round(time.perf_counter() - t0, 3)
            reports[label] = rep
        v1, c1 = verbs(node), counts.read()
        if reports["audit"].counts() != planted:
            fail(f"pools: fsck found {reports['audit'].counts()}, planted "
                 f"{planted}")
        if reports["repair"].repaired_counts() != planted or \
                reports["repair"].unrepaired:
            fail(f"pools: fsck repaired {reports['repair'].to_dict()}")
        if not reports["again"].clean:
            fail(f"pools: fsck after repair {reports['again'].to_dict()}")
        for j in lost:
            if tree_files(os.path.join(drives1[j], "pools", victim,
                                       ddir)) != kept[j]:
                fail(f"pools: the healed shards on drive {j} differ")
        recover_card = since(v0, v1, "recover") - \
            since(v0, v1, "recover", "host_routed")
        if recover_card <= 0:
            fail("pools: fsck's heal ran no recover dispatch on the card")
        if os.path.exists(stale) or os.path.exists(orphan):
            fail("pools: fsck left a planted leftover")
        st_, _h, got = c.send("GET", f"/pools/{victim}")
        if st_ != 200 or got != data[victim]:
            fail("pools: the healed object reads back different")
        out["fsck"] = {
            "planted": planted, "found": reports["audit"].counts(),
            "repaired": reports["repair"].repaired_counts(),
            "again_clean": True, "seconds": passes,
            "objects_scanned": reports["audit"].objects_scanned,
            "recover_dispatches": {"card": recover_card,
                                   "host": since(v0, v1, "recover",
                                                 "host_routed")},
            "launches": {k2: c1[k2] - c0[k2] for k2 in c1}}
        note(f"fsck passes {passes}")
        checkpoint = Rebalancer.load_checkpoint(layer, 0)
    finally:
        node.shutdown()
    # -- boot fsck ------------------------------------------------------------
    try:
        stale = os.path.join(drives0[0], ".minio.sys", "tmp", "crashed")
        os.makedirs(stale)
        with open(os.path.join(stale, "part.1"), "wb") as f:
            f.write(b"junk")
        orphan = os.path.join(drives0[1], "pools", "ghost",
                              "00000000-dead-0000-0000-000000000001")
        os.makedirs(orphan)
        with open(os.path.join(orphan, "part.1"), "wb") as f:
            f.write(b"junk")
        # one in pool 1 too, which joins only after the boot's audit (as
        # the CLI's --pool does, and the reference's): the boot misses it
        stale1 = os.path.join(drives1[2], ".minio.sys", "tmp", "crashed")
        os.makedirs(stale1)
        with open(os.path.join(stale1, "part.1"), "wb") as f:
            f.write(b"junk")
        os.environ.update({"MINIO_TPU_FSCK_BOOT": "on",
                           "MINIO_TPU_FSCK_TMP_AGE_S": "0"})
        t0 = time.perf_counter()
        node = boot()
        try:
            boot_s = time.perf_counter() - t0
            node.add_pool(drives1, set_drive_count=n, parity=m)
            rep = node.boot_fsck
            want = {"stale_tmp": 1, "orphan_data": 1}
            if rep is None or rep.counts() != want or \
                    rep.repaired_counts() != want:
                fail(f"pools: the boot fsck {rep and rep.to_dict()}")
            layer = node.object_layer
            reb = layer._rebalancer
            if reb is None:
                fail("pools: the reboot did not resume the drain")
            deadline = time.monotonic() + 120
            while reb.running() and time.monotonic() < deadline:
                time.sleep(0.05)
            status = layer.rebalance_status()
            resumed = status["rebalance"]
            if status["topology"]["pools"] != ["draining", "active"] or \
                    resumed["status"] != "complete" or \
                    resumed["objects_moved"] or resumed["objects_failed"]:
                fail(f"pools: the re-armed drain {status}")
            persisted = Rebalancer.load_checkpoint(layer, 0)
            if persisted["status"] != "complete" or \
                    persisted["objects_moved"] != resumed["objects_moved"]:
                fail(f"pools: the persisted checkpoint {persisted}")
            if not os.path.exists(stale1):
                fail("pools: the boot fsck reached a pool added after it")
            missed = run_fsck(layer, tiers=node.tiers, tmp_age_s=0)
            if missed.counts() != {"stale_tmp": 1} or \
                    [f.pool for f in missed.findings] != [1]:
                fail(f"pools: the audit after the boot {missed.to_dict()}")
            fixed = run_fsck(layer, repair=True, tiers=node.tiers,
                             tmp_age_s=0)
            if fixed.repaired_counts() != {"stale_tmp": 1} or \
                    fixed.unrepaired or os.path.exists(stale1):
                fail(f"pools: the repair after the boot {fixed.to_dict()}")
            after = run_fsck(layer, tiers=node.tiers, tmp_age_s=0)
            if not after.clean:
                fail(f"pools: the audit after the repair {after.to_dict()}")
            c = S3Client(node.s3.port, creds, timeout=300)
            st_, _h, got = c.send("GET", "/pools/big-tail")
            if st_ != 200 or got != data["big-tail"]:
                fail("pools: GET after the reboot")
        finally:
            node.shutdown()
        out["boot_fsck"] = {
            "boot_s": round(boot_s, 3), "found": rep.counts(),
            "repaired": rep.repaired_counts(),
            # the added pool's fault, which the boot's audit cannot see
            "audit_after_boot_found": missed.counts(),
            "audit_after_boot_found_in_pool": 1,
            "repair_after_boot": fixed.repaired_counts(),
            "audit_after_repair_clean": True,
            "first_drain_checkpoint": {
                k2: checkpoint.get(k2)
                for k2 in ("status", "objects_moved", "bytes_moved",
                           "passes")},
            "resumed_drain": {k2: resumed.get(k2)
                              for k2 in ("status", "objects_moved",
                                         "passes")}}
    finally:
        Rebalancer._move_object = move_object
        for v, val in saved_env.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val
        shutil.rmtree(root, ignore_errors=True)
    launches = counts.read()
    if any(launches[k2] <= 0 for k2 in ("gf_matmul", "hh256", "chacha20")):
        fail(f"pools: a kernel of the path was not launched: {launches}")
    out.update({"launches": launches,
                "seconds": round(time.perf_counter() - t_phase, 3),
                "card": card})
    emit(out)
    return out


def fs_traffic(c, root: str, rng, what: str) -> tuple:
    """Over the signed client c: FS_OBJECTS objects PUT and GET back
    byte- and ETag-equal (MD5), a multipart upload of FS_PARTS parts
    (ETag -N), a listing and a DELETE; the objects are plain files under
    root. Returns (PUT seconds, GET seconds)."""
    n_obj, size = FS_OBJECTS
    n_parts, part_size = FS_PARTS
    if c.send("PUT", "/fsb")[0] != 200:
        fail(f"fs ({what}): make bucket")
    objs = {f"o{i}": rng.bytes(size) for i in range(n_obj)}
    t0 = time.perf_counter()
    for name, body in objs.items():
        st, h, _ = c.send("PUT", f"/fsb/{name}", body=body)
        if st != 200 or h["etag"] != f'"{hashlib.md5(body).hexdigest()}"':
            fail(f"fs ({what}): PUT {name}: HTTP {st}")
    parts = [rng.bytes(part_size) for _ in range(n_parts)]
    st, _h, body = c.send("POST", "/fsb/mp", query={"uploads": ""})
    uid = body.split(b"<UploadId>")[1].split(b"<")[0].decode()
    etags = []
    for i, p in enumerate(parts):
        st, h, _ = c.send("PUT", "/fsb/mp", body=p, query={
            "partNumber": str(i + 1), "uploadId": uid})
        if st != 200:
            fail(f"fs ({what}): part {i + 1}: HTTP {st}")
        etags.append(h["etag"])
    done = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag>"
        "</Part>" for i, e in enumerate(etags)) +
        "</CompleteMultipartUpload>")
    st, _h, _b = c.send("POST", "/fsb/mp", query={"uploadId": uid},
                        body=done.encode())
    if st != 200:
        fail(f"fs ({what}): complete: HTTP {st}")
    up_wall = time.perf_counter() - t0
    want_mp = hashlib.md5(b"".join(
        bytes.fromhex(e.strip('"')) for e in etags)).hexdigest() + \
        f"-{n_parts}"
    objs["mp"] = b"".join(parts)
    t0 = time.perf_counter()
    for name, body in objs.items():
        st, h, got = c.send("GET", f"/fsb/{name}")
        want = want_mp if name == "mp" else hashlib.md5(body).hexdigest()
        if st != 200 or got != body or h["etag"] != f'"{want}"':
            fail(f"fs ({what}): GET {name}: HTTP {st}, bytes or ETag differ")
    down_wall = time.perf_counter() - t0
    st, _h, body = c.send("GET", "/fsb", query={"list-type": "2"})
    listed = sorted(k.decode() for k in
                    re.findall(rb"<Key>([^<]+)</Key>", body))
    if st != 200 or listed != sorted(objs):
        fail(f"fs ({what}): the listing {listed}")
    if c.send("DELETE", "/fsb/o0")[0] != 204 or \
            c.send("GET", "/fsb/o0")[0] != 404:
        fail(f"fs ({what}): DELETE")
    for name in list(objs)[1:]:
        with open(os.path.join(root, "fsb", name), "rb") as f:
            if f.read() != objs[name]:
                fail(f"fs ({what}): {name} is not a plain file of its bytes")
    return up_wall, down_wall


def run_fs(tmp, card, counts, np) -> dict:
    """The single-path FS backend, twice over fs_traffic's sequence.
    First cluster.start_fs in this process, its device the card, with
    the launch counts set to 0 just before and read just after: no kernel
    launches. Then `python -m minio_tpu_torch server <one path>` as a
    subprocess (the card is its default device), whose launches this
    process cannot count; its witness is the card's memory instead: in
    use (nvidia-smi) it rises by less than FS_CONTEXT_MIB between before
    the server starts and after its traffic, where a CUDA context takes
    several hundred MiB (this process does no device work meanwhile).
    SIGTERM, exit 0. GiB/s up and down for both."""
    import signal
    import socket

    from minio_tpu_torch import cluster
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    rng = np.random.default_rng(SEED + 67)
    creds = Credentials("smokefs", "smokefssecret")
    n_obj, size = FS_OBJECTS
    n_parts, part_size = FS_PARTS
    up_bytes = n_obj * size + n_parts * part_size

    def rates(up_wall, down_wall):
        return {"put_gib_s": round(up_bytes / (1 << 30) / up_wall, 4),
                "get_gib_s": round(up_bytes / (1 << 30) / down_wall, 4)}

    t_phase = time.perf_counter()
    # -- in this process: the path whose launches are counted --------------
    counts.zero()
    node = cluster.start_fs(os.path.join(tmp, "fs-node"), creds=creds)
    try:
        in_process = rates(*fs_traffic(
            S3Client(node.s3.port, creds, timeout=120),
            os.path.join(tmp, "fs-node"), rng, "start_fs"))
    finally:
        node.shutdown()
    launches = counts.read()
    if any(launches.values()):
        fail(f"fs: kernels launched by start_fs's traffic: {launches}")
    # -- the CLI's one-path boot as a subprocess ---------------------------
    root = os.path.join(tmp, "fs")
    t_cli = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MINIO_ACCESS_KEY=creds.access_key,
               MINIO_SECRET_KEY=creds.secret_key)
    used_before = card_memory_used_mib()
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch", "server", root,
         "--address", f"127.0.0.1:{port}"], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        c = S3Client(port, creds, timeout=120)
        deadline = time.monotonic() + 120
        while True:
            if proc.poll() is not None:
                fail(f"fs: the server exited {proc.returncode}: "
                     f"{proc.stderr.read()[-2000:]}")
            try:
                if c.send("GET", "/")[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                fail("fs: no answer within 120 s")
            time.sleep(0.2)
        up_s = time.perf_counter() - t_cli
        cli = rates(*fs_traffic(c, root, rng, "the CLI"))
        used_during = card_memory_used_mib()
        if used_during - used_before >= FS_CONTEXT_MIB:
            fail(f"fs: the card's memory in use rose from {used_before} to "
                 f"{used_during} MiB with the FS server up")
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        fail(f"fs: exit {proc.returncode} after SIGTERM: {stderr[-2000:]}")
    out = {"phase": "fs", "objects": n_obj, "object_bytes": size,
           "parts": n_parts, "part_bytes": part_size,
           # start_fs in this process, counts set to 0 just before
           "launches": launches, "start_fs": in_process,
           "cli": {**cli, "answered_after_s": round(up_s, 3),
                   "banner": stdout.strip().splitlines(), "exit_code": 0,
                   # the subprocess's witness of no device work
                   "card_memory_used_mib": {"before": used_before,
                                            "server_up": used_during}},
           "seconds": round(time.perf_counter() - t_phase, 3),
           "card": card}
    emit(out)
    return out


def run_distributed(tmp, card, counts, stagetimer, np) -> dict:
    """Phase 18: four nodes of a distributed cluster in this process on
    the card (cluster.ClusterNode over the internode storage, lock, peer
    and bootstrap RPC, dsync), 4 drives each on tmpfs where /dev/shm has
    DIST_SHM_MIN_BYTES free, one 12+4 set at the CLI's default 4 MiB
    blocks, driven by signed HTTP at DIST_CLIENTS concurrent requests:
    DIST_OBJECTS PUTs spread round-robin over the nodes, one 64 MiB SSE-S3
    object, each read back through a node other than its writer (bytes
    and ETag); node 3 shut down, every object read degraded and
    DIST_LOSS_PUTS PUTs at write quorum; node 3 rebooted on its drives,
    its bootstrap re-admitting it on the peers and their MRF queues
    healing its shards; node 0 shut down and every object written during
    the loss read through node 1; node 0 rebooted; DIST_LOCK rounds of
    same-key PUTs through nodes 0 and 2 (one body whole on every GET, the
    16 xl.meta agreeing). The launch counts are set to 0 just before and
    read just after. Then the CLI's `--node` boot as four subprocesses on
    the card: a PUT through node 0, a GET through node 3, SIGTERM, exit 0,
    each process's card memory. After the boot, within the counted path:
    a user added through node 0's admin router (madmin) signs a
    DIST_IAM_PUT PUT through node 2, and one ?cluster=1 scrape through
    node 1 carries all four nodes' minio_disks_online. One JSON line per
    step."""
    import collections
    import concurrent.futures
    import signal
    import socket
    import threading

    from minio_tpu_torch import cluster, madmin
    from minio_tpu_torch.distributed import transport
    from minio_tpu_torch.object import codec as codec_mod
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.storage.xl_meta import XLMetaV2
    from minio_tpu_torch.utils import promfed
    n_nodes, n_drives = DIST_NODES, DIST_DRIVES
    k, m = 12, 4
    rng = np.random.default_rng(SEED + 71)
    creds = Credentials("smokedist", "smokedistsecret")
    env = {"MINIO_SSE_MASTER_KEY": rng.bytes(32).hex(),
           "MINIO_TPU_SSE_CIPHER": "chacha20"}
    saved_env = {v: os.environ.get(v) for v in env}
    os.environ.update(env)
    shm = "/dev/shm"
    on_shm = os.path.isdir(shm) and \
        shutil.disk_usage(shm).free >= DIST_SHM_MIN_BYTES
    root = tempfile.mkdtemp(prefix="chip_smoke_dist_",
                            dir=shm if on_shm else tmp)
    t_phase = time.perf_counter()

    def note(msg: str) -> None:
        print(f"[distributed {time.perf_counter() - t_phase:.1f} s] {msg}",
              file=sys.stderr, flush=True)

    def free_ports(n: int) -> list:
        socks = [socket.socket() for _ in range(n)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        ports = [s.getsockname()[1] for s in socks]
        for s in socks:
            s.close()
        return ports

    ports = free_ports(n_nodes)
    specs = [cluster.NodeSpec("127.0.0.1", ports[i],
                              [os.path.join(root, f"n{i}d{j}")
                               for j in range(n_drives)])
             for i in range(n_nodes)]
    nodes: list = [None] * n_nodes

    def boot(i: int):
        return cluster.ClusterNode(specs, i, creds, parity=m,
                                   set_drive_count=k + m,
                                   format_timeout=120.0)

    def boot_all() -> float:
        t0 = time.perf_counter()
        errs = []

        def one(i):
            try:
                nodes[i] = boot(i)
            except Exception as e:  # noqa: BLE001 — failed below
                errs.append(f"node {i}: {e!r}")

        ts = [threading.Thread(target=one, args=(i,))
              for i in range(n_nodes)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            fail(f"distributed boot: {errs}")
        return time.perf_counter() - t0

    def client(i: int) -> S3Client:
        return S3Client(nodes[i].s3.port, creds, timeout=600)

    def md5(b: bytes) -> str:
        return hashlib.md5(b).hexdigest()

    def run_all(jobs: list, what: str) -> tuple:
        """[(name, fn)] at DIST_CLIENTS at once; (wall, {name: result})."""
        out = {}
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(DIST_CLIENTS) as ex:
            futs = {ex.submit(fn): name for name, fn in jobs}
            for f in concurrent.futures.as_completed(futs):
                try:
                    out[futs[f]] = f.result()
                except Exception as e:  # noqa: BLE001
                    fail(f"distributed {what}: {futs[f]}: {e!r}")
        return time.perf_counter() - t0, out

    def put_all(objs: dict, writer: dict, what: str,
                headers=None) -> float:
        def put(name):
            st, h, body = client(writer[name]).send(
                "PUT", f"/dist/{name}", body=objs[name], headers=headers)
            if st != 200 or h.get("etag") != f'"{md5(objs[name])}"':
                fail(f"distributed {what}: PUT {name} via node "
                     f"{writer[name]}: HTTP {st} {body[:200]!r}")
            return st
        wall, _ = run_all([(n, lambda n=n: put(n)) for n in objs], what)
        return wall

    def get_all(objs: dict, reader: dict, what: str) -> float:
        def get(name):
            st, h, body = client(reader[name]).send("GET", f"/dist/{name}")
            if st != 200 or body != objs[name] or \
                    h.get("etag") != f'"{md5(objs[name])}"':
                fail(f"distributed {what}: GET {name} via node "
                     f"{reader[name]}: HTTP {st}, bytes or ETag differ")
            return st
        wall, _ = run_all([(n, lambda n=n: get(n)) for n in objs], what)
        return wall

    def dispatches() -> dict:
        return {v: s["calls"] for v, s in codec_mod.step_seconds().items()}

    def diff(after: dict, before: dict) -> dict:
        return {v: after[v] - before.get(v, 0) for v in after
                if after[v] - before.get(v, 0)}

    def rpc_diff(before: dict) -> dict:
        now = transport.verb_stats()
        out = {}
        for verb, st in now.items():
            d = {k2: st[k2] - before.get(verb, {}).get(k2, 0) for k2 in st}
            if any(d.values()):
                out[verb] = d
        return dict(sorted(out.items()))

    def step(name: str, nbytes: int, wall: float, disp0: dict,
             rpc0: dict, **extra) -> dict:
        line = {"phase": "distributed", "step": name,
                "bytes": nbytes, "seconds": round(wall, 4),
                "gib_s": round(nbytes / (1 << 30) / wall, 4) if wall else None,
                "dispatches": diff(dispatches(), disp0),
                "launches_so_far": counts.read(),
                "rpc": rpc_diff(rpc0), **extra, "card": card}
        emit(line)
        return line

    summary = {"phase": "distributed", "step": "summary",
               "nodes": n_nodes, "drives_per_node": n_drives,
               "ec": f"{k}+{m}", "block_size": 1 << 22,
               "clients": DIST_CLIENTS,
               "drives_on": "tmpfs (/dev/shm)" if on_shm
               else "the disk (tmp)"}
    try:
        summary["boot_s"] = round(boot_all(), 3)
        if nodes[0].sets.sets[0].block_size != 1 << 22:
            fail("distributed: the boot's block size is not the CLI's")
        note("booted")
        # -- the path: counts set to 0 just before --------------------------
        counts.zero()
        codec_mod.reset_step_seconds()
        rpc_start = transport.verb_stats()
        if client(0).send("PUT", "/dist")[0] != 200:
            fail("distributed: make bucket")
        # a user made through node 0's admin router signs a PUT through
        # node 2 (the peers took the iam-delta); one ?cluster=1 scrape
        # through node 1 carries all four nodes
        disp0, rpc0 = dispatches(), transport.verb_stats()
        t0 = time.perf_counter()
        madmin.AdminClient("127.0.0.1", nodes[0].s3.port, creds.access_key,
                           creds.secret_key).add_user("distuser",
                                                      "distusersecret")
        madmin.AdminClient("127.0.0.1", nodes[0].s3.port, creds.access_key,
                           creds.secret_key).set_policy("readwrite",
                                                        "distuser")
        admin_s = time.perf_counter() - t0
        iam_body = rng.bytes(DIST_IAM_PUT)
        t0 = time.perf_counter()
        st, h, body = S3Client(nodes[2].s3.port, Credentials(
            "distuser", "distusersecret"), timeout=600).send(
            "PUT", "/dist/iam-user", body=iam_body)
        put_s = time.perf_counter() - t0
        if st != 200 or h.get("etag") != f'"{md5(iam_body)}"':
            fail(f"distributed: the admin-made user's PUT through node 2: "
                 f"HTTP {st} {body[:200]!r}")
        t0 = time.perf_counter()
        scrape = madmin.AdminClient(
            "127.0.0.1", nodes[1].s3.port, creds.access_key,
            creds.secret_key).cluster_metrics()
        scrape_s = time.perf_counter() - t0
        online = promfed.parse_exposition(scrape)["minio_disks_online"]
        by_node = {dict(labels)["node"]: v
                   for (_n, labels), v in online.samples.items()}
        if sorted(by_node) != sorted(sp.addr for sp in specs) or \
                set(by_node.values()) != {16}:
            fail(f"distributed: the ?cluster=1 scrape through node 1 "
                 f"carries {by_node}")
        summary["iam"] = step(
            "iam_user_put", DIST_IAM_PUT, put_s, disp0, rpc0,
            admin_s=round(admin_s, 4), scrape_s=round(scrape_s, 4),
            scrape_bytes=len(scrape), disks_online_by_node=by_node)
        # the tracing plane across nodes: a trace/cluster follow opened on
        # node 1 receives a PUT that node 2 serves, and that PUT's span
        # tree, read here, holds the remote drives' appendfile fragments
        summary["trace_follow"] = trace_across_nodes(
            nodes, creds, rng, step, dispatches, transport)
        n_obj, size = DIST_OBJECTS
        objs = {f"obj-{i:02d}": rng.bytes(size) for i in range(n_obj)}
        objs["obj-big"] = rng.bytes(size + 12345)
        objs["obj-small"] = rng.bytes(1024)
        writer = {n: i % n_nodes for i, n in enumerate(objs)}
        total = sum(len(d) for d in objs.values())
        disp0, rpc0 = dispatches(), transport.verb_stats()
        stagetimer.reset()
        stagetimer.enable()
        wall = put_all(objs, writer, "PUT")
        stagetimer.disable()
        summary["put"] = step("put", total, wall, disp0, rpc0,
                              objects=len(objs),
                              stages=stage_report(stagetimer)["stages"])
        note("PUTs")
        # the SSE-S3 object, through node 1, read through node 2
        sse = {"obj-sse": rng.bytes(DIST_SSE)}
        before = counts.read()["chacha20"]
        disp0, rpc0 = dispatches(), transport.verb_stats()
        wall = put_all(sse, {"obj-sse": 1}, "SSE PUT",
                       headers={"x-amz-server-side-encryption": "AES256"})
        wall += get_all(sse, {"obj-sse": 2}, "SSE GET")
        sse_launches = counts.read()["chacha20"] - before
        if sse_launches <= 0:
            fail("distributed: the SSE object launched no chacha20")
        summary["sse"] = step("sse_put_get", 2 * DIST_SSE, wall, disp0,
                              rpc0, chacha20_launches=sse_launches)
        objs.update(sse)
        writer["obj-sse"] = 1
        total += DIST_SSE
        # each object read back through a node other than its writer
        disp0, rpc0 = dispatches(), transport.verb_stats()
        wall = get_all(objs, {n: (w + 1) % n_nodes
                              for n, w in writer.items()}, "GET")
        summary["get"] = step("get", total, wall, disp0, rpc0,
                              objects=len(objs))
        note("GETs")
        # a shard write the quorum-ack lane left behind heals through its
        # writer's MRF queue before node 3's 4 drives (all the parity) go
        for i in range(n_nodes):
            if not nodes[i].sets.mrf.drain(120):
                fail(f"distributed: node {i}'s MRF queue did not drain "
                     "before node 3 went down")
        # -- node 3 lost -----------------------------------------------------
        nodes[3].shutdown()
        disp0, rpc0 = dispatches(), transport.verb_stats()
        wall = get_all(objs, {n: i % 3 for i, n in enumerate(objs)},
                       "degraded GET")
        summary["degraded_get"] = step(
            "degraded_get", total, wall, disp0, rpc0, objects=len(objs),
            node_down=3)
        if not summary["degraded_get"]["dispatches"].get("decode"):
            fail("distributed: the degraded GETs dispatched no decode")
        n_loss, lsize = DIST_LOSS_PUTS
        loss = {f"loss-{i}": rng.bytes(lsize) for i in range(n_loss)}
        lwriter = {n: i % 3 for i, n in enumerate(loss)}
        disp0, rpc0 = dispatches(), transport.verb_stats()
        wall = put_all(loss, lwriter, "PUT at quorum")
        summary["loss_put"] = step("put_at_quorum", n_loss * lsize, wall,
                                   disp0, rpc0, objects=n_loss,
                                   node_down=3)
        note("node 3 down: degraded GETs, PUTs at quorum")
        # -- node 3 rebooted; MRF brings it to full redundancy ----------------
        mrf0 = {i: nodes[i].sets.mrf.healed for i in range(3)}
        disp0, rpc0 = dispatches(), transport.verb_stats()
        t0 = time.perf_counter()
        nodes[3] = boot(3)
        reboot_s = time.perf_counter() - t0

        def n3_full() -> bool:
            return all(os.path.exists(os.path.join(
                root, f"n3d{j}", "dist", name, "xl.meta"))
                for j in range(n_drives) for name in loss)

        deadline = time.monotonic() + 120
        while not n3_full():
            if time.monotonic() > deadline:
                fail("distributed: node 3 not healed within 120 s")
            time.sleep(0.05)
        for i in range(n_nodes):
            if not nodes[i].sets.mrf.drain(120):
                fail(f"distributed: node {i}'s MRF queue did not drain")
        heal_s = time.perf_counter() - t0
        healed = {i: nodes[i].sets.mrf.healed - mrf0[i] for i in range(3)}
        summary["heal"] = step(
            "heal", n_loss * lsize, heal_s, disp0, rpc0,
            reboot_s=round(reboot_s, 3), mrf_healed_by_node=healed,
            mrf_failed=sum(nodes[i].sets.mrf.failed for i in range(3)))
        note("node 3 rebooted and healed")
        # -- node 0 lost: the loss objects read through node 1 ----------------
        nodes[0].shutdown()
        disp0, rpc0 = dispatches(), transport.verb_stats()
        wall = get_all(loss, {n: 1 for n in loss}, "GET with node 0 down")
        summary["second_loss_get"] = step(
            "get_with_node0_down", n_loss * lsize, wall, disp0, rpc0,
            objects=n_loss, node_down=0)
        nodes[0] = boot(0)
        note("node 0 down: loss objects read; node 0 rebooted")
        # -- lock check: same-key PUTs through nodes 0 and 2 -------------------
        rounds, lbytes = DIST_LOCK
        disp0, rpc0 = dispatches(), transport.verb_stats()
        t0 = time.perf_counter()
        winners = collections.Counter()
        for r in range(rounds):
            bodies = [rng.bytes(lbytes), rng.bytes(lbytes)]
            wall_r, res = run_all(
                [(i, lambda i=i, b=b: client(i).send(
                    "PUT", "/dist/race", body=b)[0])
                 for i, b in zip((0, 2), bodies)], "lock PUTs")
            if sorted(res.values()) != [200, 200]:
                fail(f"distributed lock round {r}: {res}")
            st, h, body = client(1).send("GET", "/dist/race")
            if st != 200 or body not in bodies or \
                    h.get("etag") != f'"{md5(body)}"':
                fail(f"distributed lock round {r}: GET is not one body "
                     "whole")
            winners[bodies.index(body)] += 1
            # a write the quorum-ack lane left behind heals through MRF
            # before the 16 xl.meta are read
            for i in range(n_nodes):
                if not nodes[i].sets.mrf.drain(120):
                    fail(f"distributed lock round {r}: node {i}'s MRF "
                         "queue did not drain")
            versions = set()
            for i in range(n_nodes):
                for j in range(n_drives):
                    with open(os.path.join(root, f"n{i}d{j}", "dist",
                                           "race", "xl.meta"), "rb") as f:
                        fis = XLMetaV2.loads(f.read()).list_file_infos(
                            "dist", "race")
                    versions.add(tuple((fi.version_id, fi.data_dir,
                                        fi.size, fi.metadata.get("etag"))
                                       for fi in fis))
            if len(versions) != 1 or \
                    next(iter(versions))[0][3] != md5(body):
                fail(f"distributed lock round {r}: the 16 xl.meta "
                     f"disagree ({len(versions)} forms)")
        summary["lock"] = step(
            "lock", rounds * 2 * lbytes, time.perf_counter() - t0, disp0,
            rpc0, rounds=rounds, put_bytes=lbytes,
            winner_through_node={"0": winners[0], "2": winners[1]})
        # -- read just after ---------------------------------------------------
        launches = counts.read()
        # each node's event loop parses S3 and RPC headers alike: its lag
        # (the sampler's ticks since the node's boot) says whether a
        # callback blocked it
        lags = [list(nodes[i].s3._edge.loops[0].lag_samples)
                for i in range(n_nodes)]
        summary["edge_loop_lag"] = {
            str(i): {**pct_ms(lags[i]),
                     "max_ms": round(max(lags[i], default=0.0) * 1e3, 3),
                     "ticks": len(lags[i])}
            for i in range(n_nodes)}
        summary["launches"] = launches
        summary["dispatches"] = dispatches()
        summary["rpc"] = rpc_diff(rpc_start)
        for kname in ("gf_matmul", "hh256", "chacha20"):
            if launches[kname] <= 0:
                fail(f"distributed: no {kname} launch on the path")
    finally:
        for n in nodes:
            if n is not None:
                try:
                    n.shutdown()
                except Exception:  # noqa: BLE001 — best effort
                    pass
    note("in-process path done")
    # -- the CLI's --node boot as four subprocesses on the card ---------------
    cli_ports = free_ports(n_nodes)
    node_args = []
    for i, p in enumerate(cli_ports):
        node_args += ["--node", f"127.0.0.1:{p}="
                      f"{os.path.join(root, 'cli', f'n{i}d')}"
                      f"{{1...{n_drives}}}"]
    penv = dict(os.environ, MINIO_ACCESS_KEY=creds.access_key,
                MINIO_SECRET_KEY=creds.secret_key)
    used_before = card_memory_used_mib()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch", "server", *node_args,
         "--this", str(i), "--parity", str(m)], cwd=HERE, env=penv,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n_nodes)]
    cli = {}
    try:
        cs = [S3Client(p, creds, timeout=600) for p in cli_ports]
        deadline = time.monotonic() + 300
        while True:
            for i, pr in enumerate(procs):
                if pr.poll() is not None:
                    fail(f"distributed CLI node {i} exited "
                         f"{pr.returncode}: {pr.stderr.read()[-2000:]}")
            try:
                if all(c.send("GET", "/")[0] == 200 for c in cs):
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                fail("distributed CLI: no answer within 300 s")
            time.sleep(0.25)
        cli["answered_after_s"] = round(time.perf_counter() - t0, 3)
        body = rng.bytes(DIST_CLI_OBJECT)
        if cs[0].send("PUT", "/cli")[0] != 200:
            fail("distributed CLI: make bucket")
        t1 = time.perf_counter()
        st, h, _ = cs[0].send("PUT", "/cli/o", body=body)
        put_s = time.perf_counter() - t1
        if st != 200 or h.get("etag") != f'"{md5(body)}"':
            fail(f"distributed CLI: PUT via node 0: HTTP {st}")
        t1 = time.perf_counter()
        st, h, got = cs[3].send("GET", "/cli/o")
        get_s = time.perf_counter() - t1
        if st != 200 or got != body or h.get("etag") != f'"{md5(body)}"':
            fail("distributed CLI: GET via node 3: bytes or ETag differ")
        cli.update({"object_bytes": len(body),
                    "put_s": round(put_s, 4), "get_s": round(get_s, 4),
                    "put_gib_s": round(len(body) / (1 << 30) / put_s, 4),
                    "get_gib_s": round(len(body) / (1 << 30) / get_s, 4)})
        cli["card_memory_used_mib"] = {"before": used_before,
                                       "cluster_up": card_memory_used_mib()}
        cli["card_memory_by_process_mib"] = card_memory_by_pid(
            [pr.pid for pr in procs])
        outs = []
        for pr in procs:
            pr.send_signal(signal.SIGTERM)
        for i, pr in enumerate(procs):
            out, err = pr.communicate(timeout=120)
            if pr.returncode != 0:
                fail(f"distributed CLI node {i}: exit {pr.returncode} "
                     f"after SIGTERM: {err[-2000:]}")
            outs.append(out.strip().splitlines())
        cli["banners"] = outs
        cli["exit_codes"] = [pr.returncode for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
        for v, old in saved_env.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old
        shutil.rmtree(root, ignore_errors=True)
    summary["cli"] = cli
    summary["seconds"] = round(time.perf_counter() - t_phase, 3)
    summary["card"] = card
    emit(summary)
    return summary


def trace_across_nodes(nodes, creds, rng, step, dispatches,
                       transport) -> dict:
    """Phase 18's tracing step: madmin.trace_follow on node 1 (its peers'
    trace-stream subscriptions grafted in) gets the record of a
    DIST_IAM_PUT PUT served by node 2, and the PUT's kept span tree (the
    process's one span sink) holds rpc.appendfile spans, each with the
    serving node's rpc.server.appendfile fragment grafted under it."""
    from minio_tpu_torch import madmin
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.utils import telemetry

    def pumps() -> int:
        return sum(t.name == "trace-follow-peer" and t.is_alive()
                   for t in threading.enumerate())

    was = (telemetry.SPANS.slow_s, telemetry.SPANS.sample)
    telemetry.SPANS.configure(sample=1.0)
    body = rng.bytes(DIST_IAM_PUT)
    got: list = []
    try:
        adm = madmin.AdminClient("127.0.0.1", nodes[1].s3.port,
                                 creds.access_key, creds.secret_key,
                                 timeout=120)
        t = threading.Thread(target=lambda: got.extend(adm.trace_follow(
            count=1, api="PutObject", timeout=120)), daemon=True)
        t.start()
        deadline = time.monotonic() + 15
        while pumps() < len(nodes) - 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        if pumps() < len(nodes) - 1:
            fail(f"distributed: trace/cluster follow armed {pumps()} peer "
                 "subscriptions")
        disp0, rpc0 = dispatches(), transport.verb_stats()
        t0 = time.perf_counter()
        st, _h, out = S3Client(nodes[2].s3.port, creds, timeout=600).send(
            "PUT", "/dist/traced", body=body)
        put_s = time.perf_counter() - t0
        if st != 200:
            fail(f"distributed: the traced PUT: HTTP {st} {out[:200]!r}")
        t.join(30)
        if t.is_alive() or len(got) != 1 or \
                got[0]["node"] != nodes[2].spec.addr or \
                got[0]["path"] != "/dist/traced" or got[0]["status"] != 200:
            fail(f"distributed: the follow on node 1 got {got}")
        trees = telemetry.SPANS.dump(trace_id=got[0]["trace_id"])
        if len(trees) != 1:
            fail("distributed: the traced PUT's tree was not kept")
        calls = find_spans(trees[0], "rpc.appendfile")
        grafted = [f for ca in calls for f in ca.get("children", ())
                   if f["name"] == "rpc.server.appendfile"
                   and f.get("remote")]
        if not calls or len(grafted) < len(calls):
            fail(f"distributed: {len(calls)} rpc.appendfile spans, "
                 f"{len(grafted)} grafted fragments")
    finally:
        telemetry.SPANS.configure(*was)
    deadline = time.monotonic() + 15
    while pumps() and time.monotonic() < deadline:
        time.sleep(0.05)
    if pumps():
        fail("distributed: the follow's peer subscriptions did not unwind")
    return step("trace_follow", DIST_IAM_PUT, put_s, disp0, rpc0,
                follow_node=got[0]["node"], appendfile_spans=len(calls),
                grafted_fragments=len(grafted),
                tree_spans=len(find_spans(trees[0])),
                spans_dropped=trees[0].get("spans_dropped", 0))


def find_spans(node: dict, name: str = "") -> list:
    """Every span of a dumped tree named `name` (every span when "")."""
    out = [node] if not name or node["name"] == name else []
    for ch in node.get("children", ()):
        out.extend(find_spans(ch, name))
    return out


def run_iam_admin(tmp, card, counts, stagetimer, np, lineitem_head: bytes,
                  q6_oracle: bytes) -> dict:
    """Phase 19: IAM, STS and the operator routers on the card. A fresh
    node as `python -m minio_tpu_torch server /d{1...16}` boots it
    (cluster.start_single, 12+4, 1 MiB blocks, IAM over the erasure-coded
    identity store, the admin, health and metrics routers), on tmpfs where
    /dev/shm has IAM_SHM_MIN_BYTES free; its background loops and IAM
    refresh stop before anything is timed. The launch counts are set to 0
    just before the phase's traffic and read just after it. Steps, one
    JSON line each:
      * the AES-256-GCM choice: whether ``cryptography`` imports, and
        config.kv.SEAL, before any config write (the phase fails where it
        does not import: the config is sealed with it);
      * admin, through madmin over signed HTTP, IAM_ADMIN_CLIENTS
        mutation at a time: IAM_USERS users, IAM_POLICIES custom policies (read-write on
        a bucket each; user u gets policy u mod 32), IAM_GROUPS groups of
        16 members (group g gets policy g), IAM_SVC service accounts;
        mutation p50/p99 and the records stored under
        .minio.sys/config/iam/;
      * user traffic: IAM_TRAFFIC users at once each PUT one object into
        their bucket and GET it back (bytes and ETag); one PUT into a
        bucket the user is denied answers 403 and stores nothing; an
        AssumeRole credential PUTs and GETs an IAM_SSE SSE-S3 object
        (chacha20 launches) and without its session token gets
        InvalidTokenId; an anonymous GET through a bucket policy; a user
        allowed s3:GetObject runs Q6's COUNT over the lineitem's first
        NS_SELECT_BYTES (phase 11's oracle, byte for byte) and one denied
        it gets 403 with no scan dispatch and no launch; the `auth`
        stage's p50 and p99 (stagetimer);
      * operator traffic: IAM_HEAL_DRIVE's bucket directories emptied and
        the admin heal sequence run to done (every object then read byte-
        and ETag-equal, the drive's xl.meta back); `fsck --repair`, `tier
        ls` and `decommission --status` as CLI subprocesses (a planted
        stale tmp file repaired); health live and ready; two Prometheus
        scrapes (16 drives online; the MRF gauges and the recover
        dispatches between the scrapes equal the node's own counts);
        set-config (compression), config-history and restore-config, each
        read back;
      * a reboot on the same drives: the boot's iam.load() timed on its
        own (IAMSys.last_load_s) with the records it read; a user's and
        the STS credential's requests still succeed."""
    import concurrent.futures
    import http.client
    import urllib.parse
    import xml.etree.ElementTree as ET

    from minio_tpu_torch import cluster, madmin
    from minio_tpu_torch.config import kv as config_kv
    from minio_tpu_torch.object import codec as codec_mod
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.scripts import scan_cases as sc
    from minio_tpu_torch.storage.xl_storage import MINIO_META_BUCKET
    from minio_tpu_torch.utils import promfed
    k, m, bs = 12, 4, 1 << 20
    rng = np.random.default_rng(SEED + 97)
    t_phase = time.perf_counter()

    def note(msg: str) -> None:
        print(f"[iam_admin {time.perf_counter() - t_phase:.1f} s] {msg}",
              file=sys.stderr, flush=True)

    # -- the config seal: cryptography's AES-256-GCM, named before any
    # config write ----------------------------------------------------------
    try:
        import cryptography
        crypto_version = cryptography.__version__
    except ImportError:
        crypto_version = None
    emit({"phase": "iam_admin", "step": "config_seal",
          "cryptography_imports": crypto_version is not None,
          "cryptography_version": crypto_version,
          "config_seal": config_kv.SEAL, "card": card})
    if crypto_version is None:
        fail("iam_admin: cryptography does not import, and the config "
             "is sealed with its AES-256-GCM")
    creds = Credentials("smokeiamroot", "smokeiamrootsecret")
    env = {"MINIO_SSE_MASTER_KEY": rng.bytes(32).hex(),
           "MINIO_TPU_SSE_CIPHER": "chacha20"}
    saved_env = {v: os.environ.get(v) for v in env}
    os.environ.update(env)
    shm = "/dev/shm"
    on_shm = os.path.isdir(shm) and \
        shutil.disk_usage(shm).free >= IAM_SHM_MIN_BYTES
    root = tempfile.mkdtemp(prefix="chip_smoke_iam_",
                            dir=shm if on_shm else tmp)
    drives = [os.path.join(root, f"d{i}") for i in range(k + m)]

    def boot():
        t0 = time.perf_counter()
        node = cluster.start_single(drives, creds=creds, parity=m,
                                    set_drive_count=k + m, block_size=bs)
        boot_s = time.perf_counter() - t0
        # the loops' cadence would race the timed calls; the IAM refresh
        # re-reads every record and stays out of every timed window
        node._iam_refresh_stop.set()
        for loop in (node.disk_monitor, node.heal_scanner, node.crawler,
                     node.transition_worker):
            loop.close()
            if getattr(loop, "_thread", None) is not None:
                loop._thread.join(timeout=120)
                if loop._thread.is_alive():
                    fail("iam_admin: a background loop did not stop")
        return node, boot_s

    def md5(b: bytes) -> str:
        return hashlib.md5(b).hexdigest()

    def dispatches() -> dict:
        return {v: s["calls"] for v, s in codec_mod.step_seconds().items()}

    def diff(after: dict, before: dict) -> dict:
        return {v: after[v] - before.get(v, 0) for v in after
                if after[v] - before.get(v, 0)}

    def auth_stage() -> dict:
        st = stage_report(stagetimer)["stages"].get("auth", {})
        return {k2: st.get(k2) for k2 in ("p50_ms", "p99_ms", "calls")}

    def step(name: str, nbytes: int, wall: float, disp0: dict, c0: dict,
             **extra) -> dict:
        c1 = counts.read()
        line = {"phase": "iam_admin", "step": name, "bytes": nbytes,
                "seconds": round(wall, 4),
                "gib_s": round(nbytes / (1 << 30) / wall, 4)
                if wall and nbytes else None,
                "dispatches": diff(dispatches(), disp0),
                "launches": {n: c1[n] - c0[n] for n in c1},
                **extra, "card": card}
        emit(line)
        return line

    def run_all(jobs: list, width: int, what: str) -> tuple:
        """[(name, fn)] at `width` at once; (wall, {name: result})."""
        out = {}
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(width) as ex:
            futs = {ex.submit(fn): name for name, fn in jobs}
            for f in concurrent.futures.as_completed(futs):
                try:
                    out[futs[f]] = f.result()
                except Exception as e:  # noqa: BLE001
                    fail(f"iam_admin {what}: {futs[f]}: {e!r}")
        return time.perf_counter() - t0, out

    def http_status(port: int, path: str) -> int:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("GET", path)
            r = conn.getresponse()
            r.read()
            return r.status
        finally:
            conn.close()

    def iam_records(layer) -> int:
        objs, _, _ = layer.list_objects(MINIO_META_BUCKET, "config/iam/",
                                        "", "", 100000)
        return len(objs)

    summary = {"phase": "iam_admin", "step": "summary", "drives": k + m,
               "ec": f"{k}+{m}", "block_size": bs,
               "drives_on": "tmpfs (/dev/shm)" if on_shm
               else "the disk (tmp)",
               "cryptography_imports": True,
               "cryptography_version": crypto_version,
               "config_seal": config_kv.SEAL}
    node = None
    try:
        node, summary["boot_s"] = boot()
        port = node.s3.port
        layer = node.object_layer
        root_c = S3Client(port, creds, timeout=600)
        adm = madmin.AdminClient("127.0.0.1", port, creds.access_key,
                                 creds.secret_key, timeout=120)
        note("booted")
        # -- the path: counts set to 0 just before ---------------------------
        counts.zero()
        codec_mod.reset_step_seconds()
        buckets = [f"iam-{j:02d}" for j in range(IAM_POLICIES)]
        for b in buckets + ["iam-pub", "iam-sel"]:
            if root_c.send("PUT", f"/{b}")[0] != 200:
                fail(f"iam_admin: make bucket {b}")
        # -- admin through madmin ------------------------------------------
        users = {f"user{u:03d}": f"user{u:03d}-secret-key"
                 for u in range(IAM_USERS)}
        names = sorted(users)
        lat: list = []

        def timed(fn, *a, **kw):
            c = madmin.AdminClient("127.0.0.1", port, creds.access_key,
                                   creds.secret_key, timeout=120)
            t0 = time.perf_counter()
            out = getattr(c, fn)(*a, **kw)
            lat.append(time.perf_counter() - t0)
            return out

        def policy(j: int) -> str:
            return json.dumps({"Version": "2012-10-17", "Statement": [{
                "Effect": "Allow", "Action": ["s3:*"],
                "Resource": [f"arn:aws:s3:::{buckets[j]}",
                             f"arn:aws:s3:::{buckets[j]}/*"]}]})

        n_groups, per_group = IAM_GROUPS
        disp0, c0 = dispatches(), counts.read()
        t_admin = time.perf_counter()
        w1, _ = run_all([(u, lambda u=u: timed("add_user", u, users[u]))
                         for u in names], IAM_ADMIN_CLIENTS, "add-user")
        w2, _ = run_all([(f"rw-{j}", lambda j=j: timed(
            "add_canned_policy", f"rw-{j:02d}", policy(j)))
            for j in range(IAM_POLICIES)], IAM_ADMIN_CLIENTS, "policy")
        w3, _ = run_all([(u, lambda i=i, u=u: timed(
            "set_policy", f"rw-{i % IAM_POLICIES:02d}", u))
            for i, u in enumerate(names)], IAM_ADMIN_CLIENTS, "attach")
        w4, _ = run_all([(f"g{g}", lambda g=g: (
            timed("update_group_members", f"group{g}",
                  names[g * per_group:(g + 1) * per_group]),
            timed("set_policy", f"rw-{g:02d}", f"group{g}",
                  is_group=True))) for g in range(n_groups)],
            IAM_ADMIN_CLIENTS, "groups")
        w5, svc = run_all([(f"s{i}", lambda i=i: timed(
            "add_service_account", names[i])) for i in range(IAM_SVC)],
            IAM_ADMIN_CLIENTS, "service accounts")
        admin_s = time.perf_counter() - t_admin
        iam = node.iam
        if len(iam.users) != IAM_USERS or len(iam.svc_accounts) != IAM_SVC \
                or len(iam.groups) != n_groups or \
                any(len(g["members"]) != per_group
                    for g in iam.groups.values()):
            fail("iam_admin: the IAM cache does not hold what the admin "
                 "made")
        records = iam_records(layer)
        summary["admin"] = step(
            "admin", 0, admin_s, disp0, c0, mutations=len(lat),
            mutation_ms=pct_ms(lat),
            walls_s={"users": round(w1, 3), "policies": round(w2, 3),
                     "attach": round(w3, 3), "groups": round(w4, 3),
                     "service_accounts": round(w5, 3)},
            clients=IAM_ADMIN_CLIENTS, records_stored=records)
        note(f"admin: {len(lat)} mutations, {records} records")
        # -- user traffic ------------------------------------------------------
        n_users, size = IAM_TRAFFIC
        objs = {names[i]: rng.bytes(size) for i in range(n_users)}
        ucl = {u: S3Client(port, Credentials(u, users[u]), timeout=600)
               for u in objs}
        bucket_of = {u: buckets[i % IAM_POLICIES]
                     for i, u in enumerate(names)}
        stagetimer.reset()
        stagetimer.enable()
        disp0, c0 = dispatches(), counts.read()

        def put(u):
            st, h, body = ucl[u].send("PUT", f"/{bucket_of[u]}/{u}",
                                      body=objs[u])
            if st != 200 or h.get("etag") != f'"{md5(objs[u])}"':
                fail(f"iam_admin: {u}'s PUT: HTTP {st} {body[:200]!r}")

        def get(u):
            st, h, body = ucl[u].send("GET", f"/{bucket_of[u]}/{u}")
            if st != 200 or body != objs[u] or \
                    h.get("etag") != f'"{md5(objs[u])}"':
                fail(f"iam_admin: {u}'s GET: HTTP {st}, bytes or ETag "
                     "differ")

        wall, _ = run_all([(u, lambda u=u: put(u)) for u in objs],
                          n_users, "user PUTs")
        summary["user_put"] = step("user_put", n_users * size, wall, disp0,
                                   c0, users=n_users, auth=auth_stage())
        disp0, c0 = dispatches(), counts.read()
        wall, _ = run_all([(u, lambda u=u: get(u)) for u in objs],
                          n_users, "user GETs")
        summary["user_get"] = step("user_get", n_users * size, wall, disp0,
                                   c0, users=n_users, auth=auth_stage())
        note("user PUTs and GETs")
        # a PUT into a bucket the user is denied stores nothing
        u0 = names[0]
        denied_bucket = bucket_of[names[1]]
        disp0, c0 = dispatches(), counts.read()
        t0 = time.perf_counter()
        st, _h, body = ucl[u0].send("PUT", f"/{denied_bucket}/denied",
                                    body=rng.bytes(IAM_DENIED))
        wall = time.perf_counter() - t0
        stored = [d for d in drives
                  if os.path.exists(os.path.join(d, denied_bucket,
                                                 "denied"))]
        if st != 403 or b"AccessDenied" not in body or stored or \
                root_c.send("HEAD", f"/{denied_bucket}/denied")[0] != 404:
            fail(f"iam_admin: the denied PUT: HTTP {st}, stored on "
                 f"{len(stored)} drives")
        summary["denied_put"] = step("denied_put", 0, wall, disp0, c0,
                                     status=st)
        # an AssumeRole credential's SSE-S3 object
        form = urllib.parse.urlencode({
            "Action": "AssumeRole", "Version": "2011-06-15",
            "DurationSeconds": "3600"}).encode()
        st, _h, body = ucl[u0].send("POST", "/", body=form)
        if st != 200:
            fail(f"iam_admin: AssumeRole: HTTP {st} {body[:200]!r}")
        ns = {"sts": "https://sts.amazonaws.com/doc/2011-06-15/"}
        ce = ET.fromstring(body).find(".//sts:Credentials", ns)
        sts = Credentials(
            access_key=ce.find("sts:AccessKeyId", ns).text,
            secret_key=ce.find("sts:SecretAccessKey", ns).text,
            session_token=ce.find("sts:SessionToken", ns).text)
        sts_c = S3Client(port, sts, timeout=600)
        sse_data = rng.bytes(IAM_SSE)
        sse_path = f"/{bucket_of[u0]}/sts-sse"
        disp0, c0 = dispatches(), counts.read()
        t0 = time.perf_counter()
        st, h, body = sts_c.send(
            "PUT", sse_path, body=sse_data,
            headers={"x-amz-server-side-encryption": "AES256"})
        if st != 200 or h.get("etag") != f'"{md5(sse_data)}"':
            fail(f"iam_admin: the STS SSE PUT: HTTP {st} {body[:200]!r}")
        st, h, body = sts_c.send("GET", sse_path)
        wall = time.perf_counter() - t0
        if st != 200 or body != sse_data or \
                h.get("etag") != f'"{md5(sse_data)}"':
            fail(f"iam_admin: the STS SSE GET: HTTP {st}, bytes or ETag "
                 "differ")
        naked = S3Client(port, Credentials(sts.access_key, sts.secret_key))
        st_naked, _h, body_naked = naked.send("GET", sse_path)
        if st_naked != 403 or b"InvalidTokenId" not in body_naked:
            fail(f"iam_admin: the STS credential without its token: HTTP "
                 f"{st_naked}")
        summary["sts_sse"] = step("sts_sse_put_get", 2 * IAM_SSE, wall,
                                  disp0, c0, without_token=st_naked)
        if summary["sts_sse"]["launches"]["chacha20"] <= 0:
            fail("iam_admin: the STS SSE object launched no chacha20")
        # an anonymous GET through a bucket policy
        pub = json.dumps({"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Principal": {"AWS": ["*"]},
            "Action": ["s3:GetObject"],
            "Resource": ["arn:aws:s3:::iam-pub/*"]}]}).encode()
        pub_body = rng.bytes(4096)
        if root_c.send("PUT", "/iam-pub/o", body=pub_body)[0] != 200 or \
                root_c.send("PUT", "/iam-pub", query={"policy": ""},
                            body=pub)[0] not in (200, 204):
            fail("iam_admin: the public bucket's object or policy")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/iam-pub/o")
        r = conn.getresponse()
        anon = (r.status, r.read())
        conn.close()
        if anon != (200, pub_body):
            fail(f"iam_admin: the anonymous GET: HTTP {anon[0]}")
        # an allowed and a denied Select
        sel_users = {"selallow": ("s3:GetObject", "selallow-secret"),
                     "seldeny": ("s3:PutObject", "seldeny-secret")}
        for u, (action, secret) in sel_users.items():
            adm.add_user(u, secret)
            adm.add_canned_policy(f"pol-{u}", json.dumps({
                "Version": "2012-10-17", "Statement": [{
                    "Effect": "Allow", "Action": [action],
                    "Resource": ["arn:aws:s3:::iam-sel/*"]}]}))
            adm.set_policy(f"pol-{u}", u)
        if root_c.send("PUT", "/iam-sel/lineitem.csv",
                       body=lineitem_head)[0] != 200:
            fail("iam_admin: the lineitem PUT")
        sel = {}
        for u, (_a, secret) in sel_users.items():
            scan0 = node.scheduler.stats()["verbs"]["scan"]["batches"]
            disp0, c0 = dispatches(), counts.read()
            t0 = time.perf_counter()
            st, _h, body = S3Client(port, Credentials(u, secret),
                                    timeout=600).send(
                "POST", "/iam-sel/lineitem.csv",
                query={"select": "", "select-type": "2"},
                body=sc.select_xml(sc.Q6_COUNT))
            wall = time.perf_counter() - t0
            scans = node.scheduler.stats()["verbs"]["scan"]["batches"] - \
                scan0
            sel[u] = step(f"select_{u}", len(lineitem_head), wall, disp0,
                          c0, status=st, scan_dispatches=scans)
            if u == "selallow" and (st != 200 or body != q6_oracle or
                                    sel[u]["launches"]["scan_eval"] <= 0):
                fail(f"iam_admin: the allowed Select: HTTP {st}, "
                     f"{len(body)} B against the oracle's "
                     f"{len(q6_oracle)} B")
            if u == "seldeny" and (st != 403 or scans or
                                   any(sel[u]["launches"].values())):
                fail(f"iam_admin: the denied Select: HTTP {st}, {scans} "
                     f"scan dispatches, {sel[u]['launches']}")
        stagetimer.disable()
        summary["select"] = sel
        summary["auth"] = auth_stage()
        note("STS, anonymous and Select")
        # -- operator traffic ------------------------------------------------
        metrics0 = promfed.parse_exposition(adm.metrics_text())
        rec0 = node.scheduler.stats()["verbs"]["recover"]
        victim = drives[IAM_HEAL_DRIVE]
        every = {f"/{bucket_of[u]}/{u}": objs[u] for u in objs}
        every[sse_path] = sse_data
        every["/iam-pub/o"] = pub_body
        every["/iam-sel/lineitem.csv"] = lineitem_head
        for b in buckets + ["iam-pub", "iam-sel"]:
            shutil.rmtree(os.path.join(victim, b), ignore_errors=True)
        disp0, c0 = dispatches(), counts.read()
        t0 = time.perf_counter()
        token = adm.heal_start()
        deadline = time.monotonic() + 300
        while True:
            hs = adm.heal_status(token)
            if hs["status"] != "running":
                break
            if time.monotonic() > deadline:
                fail("iam_admin: the heal sequence did not finish in 300 s")
            time.sleep(0.05)
        heal_s = time.perf_counter() - t0
        if hs["status"] != "done" or hs["failures"]:
            fail(f"iam_admin: the heal sequence: {hs}")
        missing = [p for p in every if not os.path.exists(
            os.path.join(victim, p.lstrip("/"), "xl.meta"))]
        if missing:
            fail(f"iam_admin: not healed onto the emptied drive: "
                 f"{missing[:4]}")
        rec1 = node.scheduler.stats()["verbs"]["recover"]
        summary["heal"] = step(
            "admin_heal", sum(len(v) for v in every.values()), heal_s,
            disp0, c0, heal_status=hs,
            recover_batches=rec1["batches"] - rec0["batches"],
            recover_host_routed=rec1["host_routed"] - rec0["host_routed"])
        disp0, c0 = dispatches(), counts.read()
        t0 = time.perf_counter()
        for p, data in every.items():
            cl = sts_c if p == sse_path else root_c
            st, h, body = cl.send("GET", p)
            if st != 200 or body != data or h.get("etag") != f'"{md5(data)}"':
                fail(f"iam_admin: {p} after the heal: HTTP {st}, bytes or "
                     "ETag differ")
        summary["read_after_heal"] = step(
            "read_after_heal", sum(len(v) for v in every.values()),
            time.perf_counter() - t0, disp0, c0, objects=len(every))
        note("heal")
        # the CLI's admin verbs as subprocesses
        stale = os.path.join(drives[3], MINIO_META_BUCKET, "tmp",
                             "chip-smoke-crash")
        os.makedirs(stale, exist_ok=True)
        with open(os.path.join(stale, "part.1"), "wb") as f:
            f.write(b"left by a crash")
        penv = dict(os.environ, MINIO_ROOT_USER=creds.access_key,
                    MINIO_ROOT_PASSWORD=creds.secret_key)
        url = f"127.0.0.1:{port}"
        verbs = {"fsck": ["fsck", "--repair", "--tmp-age", "0"],
                 "tier_ls": ["tier", "ls"],
                 "decommission_status": ["decommission", "--status"]}
        t0 = time.perf_counter()
        procs = {n: subprocess.Popen(
            [sys.executable, "-m", "minio_tpu_torch", *a, "--url", url],
            cwd=HERE, env=penv, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for n, a in verbs.items()}
        cli = {}
        for n, pr in procs.items():
            out, err = pr.communicate(timeout=300)
            if pr.returncode != 0:
                fail(f"iam_admin: `{' '.join(verbs[n])}` exited "
                     f"{pr.returncode}: {err[-2000:]}")
            cli[n] = json.loads(out)
        cli_s = time.perf_counter() - t0
        if cli["fsck"].get("repaired", {}).get("stale_tmp") != 1 or \
                os.path.exists(stale):
            fail(f"iam_admin: fsck --repair: {cli['fsck']}")
        health = {p: http_status(port, f"/minio/health/{p}")
                  for p in ("live", "ready")}
        if health != {"live": 200, "ready": 200}:
            fail(f"iam_admin: health {health}")
        metrics1 = promfed.parse_exposition(adm.metrics_text())
        mrf = layer.mrf_stats()

        def gauge(fams, name, **labels):
            fam = fams.get(name)
            want = tuple(sorted(labels.items()))
            return None if fam is None else fam.samples.get((name, want))

        recover_total = [gauge(f, "minio_tpu_sched_batches_total",
                               verb="recover") or 0
                         for f in (metrics0, metrics1)]
        checks = {
            "disks_online": [gauge(f, "minio_disks_online")
                             for f in (metrics0, metrics1)],
            "mrf_healed": (gauge(metrics1, "minio_heal_mrf_healed_total"),
                           mrf["healed"]),
            "mrf_pending": (gauge(metrics1, "minio_heal_mrf_pending"),
                            mrf["pending"]),
            "mrf_failed": (gauge(metrics1, "minio_heal_mrf_failed_total"),
                           mrf["failed"]),
            "recover_dispatches": (recover_total[1] - recover_total[0],
                                   rec1["batches"] - rec0["batches"])}
        if checks["disks_online"] != [16, 16] or any(
                a != b for n, (a, b) in checks.items()
                if n != "disks_online"):
            fail(f"iam_admin: the scrapes disagree with the node: {checks}")
        # config KV: set, history, restore, each read back
        t0 = time.perf_counter()
        adm.set_config("compression", enable="on")
        if adm.get_config()["compression"]["enable"] != "on" or \
                not node.s3.api.compression_enabled:
            fail("iam_admin: set-config compression did not read back")
        adm.set_config("compression", enable="off")
        hist = adm.config_history()
        if not hist:
            fail("iam_admin: config-history is empty after two writes")
        adm.restore_config(hist[-1])
        if adm.get_config()["compression"]["enable"] != "on" or \
                not node.s3.api.compression_enabled:
            fail("iam_admin: restore-config did not read back")
        adm.set_config("compression", enable="off")
        config_s = time.perf_counter() - t0
        summary["operator"] = step(
            "operator", 0, cli_s, dispatches(), counts.read(),
            cli={n: {"exit": 0, **({"repaired": v.get("repaired")}
                                  if n == "fsck" else {})}
                 for n, v in cli.items()},
            health=health, scrape_checks=checks,
            scrape_bytes=len(adm.metrics_text()),
            config={"seconds": round(config_s, 4),
                    "history_entries": len(hist)})
        note("operator verbs")
        # -- read just after --------------------------------------------------
        launches = counts.read()
        summary["launches"] = launches
        summary["dispatches"] = dispatches()
        for kname in ("gf_matmul", "hh256", "chacha20", "scan_eval"):
            if launches[kname] <= 0:
                fail(f"iam_admin: no {kname} launch on the path")
        # -- reboot on the same drives ------------------------------------
        node.shutdown()
        node = None
        node, reboot_s = boot()
        # the boot's own load, alone in the process (IAMSys.last_load_s)
        load_s = node.iam.last_load_s
        loaded = iam_records(node.object_layer)
        u = names[3]
        st_u = S3Client(node.s3.port, Credentials(u, users[u])).send(
            "GET", f"/{bucket_of[u]}/{u}")
        st_s = S3Client(node.s3.port, sts).send("HEAD", sse_path)
        if st_u[0] != 200 or st_u[2] != objs[u] or st_s[0] != 200 or \
                len(node.iam.users) != IAM_USERS + 2:
            fail(f"iam_admin: after the reboot: user HTTP {st_u[0]}, STS "
                 f"HTTP {st_s[0]}, {len(node.iam.users)} users")
        summary["reboot"] = {"boot_s": round(reboot_s, 3),
                             "iam_load_s": round(load_s, 4),
                             "iam_users": len(node.iam.users),
                             "records": loaded,
                             "user_get": st_u[0], "sts_head": st_s[0]}
        emit({"phase": "iam_admin", "step": "reboot", **summary["reboot"],
              "card": card})
    finally:
        stagetimer.disable()
        if node is not None:
            node.shutdown()
        for v, old in saved_env.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old
        shutil.rmtree(root, ignore_errors=True)
    summary["seconds"] = round(time.perf_counter() - t_phase, 3)
    summary["card"] = card
    emit(summary)
    return summary


def run_obs(tmp, card, counts, stagetimer, np, lineitem_head: bytes,
            q6_oracle: bytes) -> dict:
    """Phase 20: the tracing plane on the card, modelled on the reference
    bench's bench_obs_ab and bench_incident_ab at this node's size. A
    fresh node as `python -m minio_tpu_torch server /d{1...16}` boots it
    (cluster.start_single, 12+4, 1 MiB blocks, tmpfs where /dev/shm has
    OBS_SHM_MIN_BYTES free), its heal scanner, crawler, disk monitor and
    transition worker stopped; the tracing plane's own threads (journal
    flusher, SLO engine, flight recorder) run. Every trace is kept for
    the phase (SPANS sample 1.0, restored after). The launch counts are
    set to 0 just before the traffic and read just after it. Steps, one
    JSON line each:
      * rounds: OBS_ROUNDS x 3 conditions, interleaved A B C A B C ...,
        each round OBS_PUTS[0] signed clients PUTting OBS_PUTS[1] bytes
        at once: A the plane on with no subscriber, B a live
        trace?follow=1 subscriber through madmin.trace_follow (it gets
        every PUT of its round, api PutObject, status 200), C
        MINIO_TPU_EVENTLOG and MINIO_TPU_SLO off; an audit webhook set
        through config KV at a loopback receiver gets every PUT of the
        first A round (minio_tpu_audit_dropped_total 0); p50/p99 per
        condition, B/A and A/C;
      * spans: spans?sort=slowest&api=PutObject returns trees, each with
        engine.put_object holding pipeline.encode and sched.dispatch
        (verb encode; its batch is submitted where the PUT's feed runs,
        as in the reference) with its sched.queue/transfer/compute/fetch
        children; each
        sched.compute duration equals a codec compute_span_s of the run
        within 1 µs; spans per tree and spans dropped;
      * reads: OBS_PUTS[0] GETs, then OBS_DEGRADED GETs with 3 drives'
        bucket removed (their trees hold sched.dispatch verb decode, and
        the MRF heals they queue appear as mrf.enqueue / mrf.drain
        events); one OBS_SSE SSE-S3 PUT and GET (chacha20); one Q6 COUNT
        over phase 11's lineitem's first NS_SELECT_BYTES (phase 11's
        oracle, byte for byte; its tree holds scan.page);
      * profiling/start (cpu,mem) around one extra round, then stop: both
        texts non-empty, minio_tpu_profiler_running back to 0;
      * incident: one drive.probation record emitted directly, the
        seconds until its bundle lands under drive 0's
        .minio.sys/incidents/, listed with journal and span counts > 0;
        the SLO document's windows (OBS_SLO_WINDOWS_S, cut from the
        default 60,300 s to fit the phase) each with at least
        MINIO_TPU_SLO_MIN_SAMPLES samples; consolelog's `online` line;
      * reboot on the same drives: events replays every record persisted
        before it."""
    import concurrent.futures
    import http.server

    from minio_tpu_torch import cluster, madmin
    from minio_tpu_torch.object import codec as codec_mod
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.scripts import scan_cases as sc
    from minio_tpu_torch.utils import eventlog, telemetry
    k, m, bs = 12, 4, 1 << 20
    rng = np.random.default_rng(SEED + 101)
    t_phase = time.perf_counter()

    def note(msg: str) -> None:
        print(f"[obs {time.perf_counter() - t_phase:.1f} s] {msg}",
              file=sys.stderr, flush=True)

    creds = Credentials("smokeobsroot", "smokeobsrootsecret")
    env = {"MINIO_SSE_MASTER_KEY": rng.bytes(32).hex(),
           "MINIO_TPU_SSE_CIPHER": "chacha20",
           "MINIO_TPU_SLO_WINDOWS_S": OBS_SLO_WINDOWS_S,
           "MINIO_TPU_SLO_EVAL_S": "1", "MINIO_TPU_INCIDENT_DEBOUNCE_S": "0"}
    saved_env = {v: os.environ.get(v)
                 for v in list(env) + ["MINIO_TPU_EVENTLOG", "MINIO_TPU_SLO"]}
    os.environ.update(env)
    shm = "/dev/shm"
    on_shm = os.path.isdir(shm) and \
        shutil.disk_usage(shm).free >= OBS_SHM_MIN_BYTES
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_",
                            dir=shm if on_shm else tmp)
    drives = [os.path.join(root, f"d{i}") for i in range(k + m)]
    # every codec step's stage spans, to hold the trees' sched.compute to
    steps: list = []
    real_record = codec_mod._record_step

    def record_step(verb, stages):
        steps.append((verb, stages["compute_span_s"]))
        real_record(verb, stages)

    def boot():
        t0 = time.perf_counter()
        node = cluster.start_single(drives, creds=creds, parity=m,
                                    set_drive_count=k + m, block_size=bs)
        boot_s = time.perf_counter() - t0
        node._iam_refresh_stop.set()
        for loop in (node.disk_monitor, node.heal_scanner, node.crawler,
                     node.transition_worker):
            loop.close()
            if getattr(loop, "_thread", None) is not None:
                loop._thread.join(timeout=120)
                if loop._thread.is_alive():
                    fail("obs: a background loop did not stop")
        return node, boot_s

    def md5(b: bytes) -> str:
        return hashlib.md5(b).hexdigest()

    class Receiver(http.server.BaseHTTPRequestHandler):
        got: list = []

        def do_POST(self):
            n = int(self.headers.get("Content-Length", "0"))
            Receiver.got.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    audit = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Receiver)
    threading.Thread(target=audit.serve_forever, daemon=True,
                     name="obs-audit-receiver").start()
    audit_url = f"http://127.0.0.1:{audit.server_address[1]}/audit"
    was_sampling = (telemetry.SPANS.slow_s, telemetry.SPANS.sample)
    summary = {"phase": "obs", "step": "summary", "drives": k + m,
               "ec": f"{k}+{m}", "block_size": bs,
               "drives_on": "tmpfs (/dev/shm)" if on_shm
               else "the disk (tmp)", "rounds_per_condition": OBS_ROUNDS,
               "clients": OBS_PUTS[0], "put_bytes": OBS_PUTS[1],
               "slo_windows_s": OBS_SLO_WINDOWS_S}
    node = None
    try:
        node, summary["boot_s"] = boot()
        port = node.s3.port
        c = S3Client(port, creds, timeout=600)
        adm = madmin.AdminClient("127.0.0.1", port, creds.access_key,
                                 creds.secret_key, timeout=120)
        meta = os.path.join(drives[0], ".minio.sys")
        if eventlog.JOURNAL._dir != os.path.join(meta, "eventlog"):
            fail(f"obs: the journal is attached to {eventlog.JOURNAL._dir} "
                 "(a node of an earlier phase still holds the plane)")
        telemetry.SPANS.configure(sample=1.0)
        codec_mod._record_step = record_step
        note("booted")
        # -- the path: counts set to 0 just before ---------------------------
        counts.zero()
        codec_mod.reset_step_seconds()
        for b in ("obs", "obs-deg", "obs-sel"):
            if c.send("PUT", f"/{b}")[0] != 200:
                fail(f"obs: make bucket {b}")
        n_cl, size = OBS_PUTS
        bodies = [rng.bytes(size) for _ in range(n_cl)]
        ucl = [S3Client(port, creds, timeout=600) for _ in range(n_cl)]
        lat = {"A": [], "B": [], "C": []}
        follow_got: list = []

        def put_round(tag: str) -> list:
            def one(i):
                t0 = time.perf_counter()
                st, h, body = ucl[i].send("PUT", f"/obs/{tag}-{i}",
                                          body=bodies[i])
                dt = time.perf_counter() - t0
                if st != 200 or h.get("etag") != f'"{md5(bodies[i])}"':
                    fail(f"obs: PUT {tag}-{i}: HTTP {st} {body[:200]!r}")
                return dt
            with concurrent.futures.ThreadPoolExecutor(n_cl) as ex:
                return list(ex.map(one, range(n_cl)))

        adm.set_config("audit_webhook", enable="on", endpoint=audit_url)
        if node.s3.api.trace.audit_webhook != audit_url:
            fail("obs: the audit webhook did not reach the trace plane")
        # one untimed round first: the node's first PUTs allocate its
        # pinned staging and warm its paths, which would land on A alone
        put_round("warm")
        t_rounds = time.perf_counter()
        for r in range(OBS_ROUNDS):
            for cond in ("A", "B", "C"):
                tag = f"r{r}{cond}"
                if cond == "B":
                    got: list = []
                    t = threading.Thread(target=lambda got=got: got.extend(
                        adm.trace_follow(count=n_cl, api="PutObject",
                                         timeout=120)), daemon=True)
                    t.start()
                    deadline = time.monotonic() + 10
                    while node.s3.api.trace.hub.subscriber_count == 0 \
                            and time.monotonic() < deadline:
                        time.sleep(0.01)
                    if node.s3.api.trace.hub.subscriber_count == 0:
                        fail("obs: the follow subscriber never subscribed")
                if cond == "C":
                    os.environ["MINIO_TPU_EVENTLOG"] = "off"
                    os.environ["MINIO_TPU_SLO"] = "off"
                try:
                    lat[cond].extend(put_round(tag))
                finally:
                    for v in ("MINIO_TPU_EVENTLOG", "MINIO_TPU_SLO"):
                        os.environ.pop(v, None)
                if cond == "B":
                    t.join(60)
                    if t.is_alive() or sorted(e["path"] for e in got) != \
                            sorted(f"/obs/{tag}-{i}" for i in range(n_cl)) \
                            or any(e["api"] != "PutObject" or
                                   e["status"] != 200 for e in got):
                        fail(f"obs: the follow subscriber got "
                             f"{[(e['path'], e['status']) for e in got]}")
                    follow_got.extend(got)
                if r == 0 and cond == "A":
                    deadline = time.monotonic() + 30
                    want = {f"/obs/{tag}-{i}" for i in range(n_cl)}
                    while not want <= {e["path"] for e in Receiver.got} \
                            and time.monotonic() < deadline:
                        time.sleep(0.05)
                    shipped = [e for e in Receiver.got
                               if e["path"] in want]
                    adm.set_config("audit_webhook", enable="off")
                    if {e["path"] for e in shipped} != want or any(
                            e["api"] != "PutObject" or e["status"] != 200
                            for e in shipped):
                        fail(f"obs: the audit receiver got "
                             f"{sorted(e['path'] for e in shipped)}")
        rounds_s = time.perf_counter() - t_rounds
        dropped = telemetry.REGISTRY.counter(
            "minio_tpu_audit_dropped_total").value()
        if dropped or node.s3.api.trace.audit_dropped:
            fail(f"obs: {dropped} audit entries dropped")
        pcts = {cond: pct_ms(v) for cond, v in lat.items()}

        def ratio(a, b, q):
            return round(pcts[a][q] / pcts[b][q], 4) if pcts[b][q] else None

        summary["rounds"] = {
            "seconds": round(rounds_s, 3), "latency": pcts,
            "p50_b_over_a": ratio("B", "A", "p50_ms"),
            "p99_b_over_a": ratio("B", "A", "p99_ms"),
            "p50_a_over_c": ratio("A", "C", "p50_ms"),
            "p99_a_over_c": ratio("A", "C", "p99_ms"),
            "follow_records": len(follow_got),
            "audit_records": len(Receiver.got), "audit_dropped": dropped}
        emit({"phase": "obs", "step": "rounds", **summary["rounds"],
              "card": card})
        note("rounds")
        # -- spans ---------------------------------------------------------
        trees = adm.spans(count=4 * OBS_ROUNDS * n_cl, sort="slowest",
                          api="PutObject")["spans"]
        puts = [t for t in trees
                if t["attrs"]["path"].startswith("/obs/r")]
        if len(puts) < n_cl:
            fail(f"obs: spans returned {len(puts)} PutObject trees")
        computes = [cs for v, cs in steps if v == "encode"]
        n_disp = 0
        for t in puts:
            # the dispatch hangs under the span current where the PUT's
            # feed submits its batch (engine.put_object; the encode stage
            # waits for it later, in pipeline.encode), as in the reference
            eng = find_spans(t, "engine.put_object")
            enc = [e for x in eng for e in find_spans(x, "pipeline.encode")]
            disp = [d for x in eng for d in find_spans(x, "sched.dispatch")]
            if not eng or not enc or not disp:
                fail(f"obs: a PUT tree lacks engine.put_object with "
                     f"pipeline.encode and sched.dispatch: "
                     f"{json.dumps(t)[:600]}")
            for d in disp:
                kids = [ch["name"] for ch in d.get("children", ())]
                if d["attrs"]["verb"] != "encode" or kids != [
                        "sched.queue", "sched.transfer", "sched.compute",
                        "sched.fetch"]:
                    fail(f"obs: a dispatch of a PUT tree: {d['attrs']} "
                         f"{kids}")
                comp = d["children"][2]["duration_ms"]
                if not any(abs(comp - cs * 1e3) <= 1e-3 for cs in computes):
                    fail(f"obs: sched.compute {comp} ms equals no codec "
                         "compute_span_s of the run")
                n_disp += 1
        sizes = [len(find_spans(t)) for t in puts]
        summary["spans"] = {
            "put_trees": len(puts), "dispatch_spans_checked": n_disp,
            "spans_per_put_tree": {"min": min(sizes), "max": max(sizes),
                                   "mean": round(sum(sizes) / len(sizes),
                                                 1)},
            "spans_dropped": sum(t.get("spans_dropped", 0) for t in puts),
            "kept_total": telemetry.SPANS.kept_total,
            "codec_encode_steps": len(computes)}
        emit({"phase": "obs", "step": "spans", **summary["spans"],
              "card": card})
        note("spans")
        # -- reads -----------------------------------------------------------
        t0 = time.perf_counter()
        for i in range(n_cl):
            st, h, body = ucl[i].send("GET", f"/obs/r0A-{i}")
            if st != 200 or body != bodies[i]:
                fail(f"obs: GET r0A-{i}: HTTP {st}")
        get_s = time.perf_counter() - t0
        for i in range(OBS_DEGRADED):
            if c.send("PUT", f"/obs-deg/o{i}", body=bodies[i])[0] != 200:
                fail(f"obs: PUT obs-deg/o{i}")
        # a shard write the quorum-ack lane left behind heals through MRF
        # before the drives go
        if not node.object_layer.drain_mrf(timeout=120):
            fail("obs: the MRF queue did not drain before the degraded "
                 "GETs")
        gone = [0, 1, 2]
        for i in gone:
            shutil.rmtree(os.path.join(drives[i], "obs-deg"))
        seq0 = eventlog.JOURNAL.seq
        t0 = time.perf_counter()
        for i in range(OBS_DEGRADED):
            st, _h, body = c.send("GET", f"/obs-deg/o{i}")
            if st != 200 or body != bodies[i]:
                fail(f"obs: degraded GET o{i}: HTTP {st}")
        deg_s = time.perf_counter() - t0
        get_trees = [t for t in adm.spans(count=200, api="GetObject")[
            "spans"] if t["attrs"]["path"].startswith("/obs-deg/")]
        decodes = [d for t in get_trees for d in find_spans(t, "sched.dispatch")
                   if d["attrs"]["verb"] == "decode"]
        if len(get_trees) < OBS_DEGRADED or not decodes or not all(
                len(d.get("children", ())) == 4 for d in decodes):
            fail(f"obs: {len(get_trees)} degraded GET trees, "
                 f"{len(decodes)} decode dispatches on the card")
        if not node.sets.mrf.drain(120):
            fail("obs: the MRF queue did not drain")
        mrf_events = [e for e in adm.events(classes="mrf.enqueue,mrf.drain")
                      if e["seq"] > seq0]
        if {e["class"] for e in mrf_events} != {"mrf.enqueue", "mrf.drain"}:
            fail(f"obs: the degraded GETs' heals: {mrf_events[-4:]}")
        # SSE-S3: chacha20 on the encrypted PUT and GET
        sse_data = rng.bytes(OBS_SSE)
        c0 = counts.read()["chacha20"]
        st, _h, _b = c.send("PUT", "/obs/sse", body=sse_data, headers={
            "x-amz-server-side-encryption": "AES256"})
        st2, _h, body = c.send("GET", "/obs/sse")
        if st != 200 or st2 != 200 or body != sse_data or \
                counts.read()["chacha20"] <= c0:
            fail(f"obs: the SSE-S3 object: HTTP {st}/{st2}")
        # the Select: Q6's COUNT over the lineitem's head
        if c.send("PUT", "/obs-sel/lineitem.csv",
                  body=lineitem_head)[0] != 200:
            fail("obs: the lineitem PUT")
        st, _h, body = c.send("POST", "/obs-sel/lineitem.csv",
                              query={"select": "", "select-type": "2"},
                              body=sc.select_xml(sc.Q6_COUNT))
        if st != 200 or body != q6_oracle:
            fail(f"obs: the Q6 Select: HTTP {st}, {len(body)} B")
        sel = [t for t in adm.spans(count=50, api="PostObject")["spans"]
               if t["attrs"]["path"] == "/obs-sel/lineitem.csv"]
        if not sel or not find_spans(sel[0], "scan.page"):
            fail("obs: the Select's tree holds no scan.page")
        summary["reads"] = {
            "get_s": round(get_s, 3), "degraded_get_s": round(deg_s, 3),
            "degraded_trees": len(get_trees),
            "decode_dispatches": len(decodes),
            "mrf_events": {cl: sum(e["class"] == cl for e in mrf_events)
                           for cl in ("mrf.enqueue", "mrf.drain")},
            "select_scan_page_spans": len(find_spans(sel[0], "scan.page"))}
        emit({"phase": "obs", "step": "reads", **summary["reads"],
              "card": card})
        note("reads, SSE, Select")
        # -- profiling around one extra round ------------------------------
        started = adm.profiling_start("cpu,mem")
        t0 = time.perf_counter()
        put_round("prof")
        prof_round_s = time.perf_counter() - t0
        profiles = adm.profiling_stop("cpu,mem")
        running = telemetry.REGISTRY.render()
        if started != {"kinds": {"cpu": "started", "mem": "started"},
                       "peers": []} or len(profiles) != 2 or \
                not all(profiles.values()) or \
                'minio_tpu_profiler_running{kind="cpu"} 0' not in running \
                or 'minio_tpu_profiler_running{kind="mem"} 0' not in running:
            fail(f"obs: profiling: {started} {sorted(profiles)}")
        # -- read just after ---------------------------------------------
        launches = counts.read()
        summary["launches"] = launches
        for kname in ("gf_matmul", "hh256", "chacha20", "scan_eval"):
            if launches[kname] <= 0:
                fail(f"obs: no {kname} launch on the path")
        # -- the incident plane ------------------------------------------
        inc_dir = os.path.join(drives[0], ".minio.sys", "incidents")

        def bundles() -> set:
            # committed bundles only: the atomic write's staging file
            # appears in the directory first
            return {n for n in os.listdir(inc_dir)
                    if n.startswith("inc-") and n.endswith(".json")} \
                if os.path.isdir(inc_dir) else set()

        before = bundles()
        t0 = time.perf_counter()
        eventlog.emit("drive.probation", drive=drives[5], set=0)
        bundle = None
        while time.perf_counter() - t0 < 30:
            new = bundles() - before
            if new:
                bundle = sorted(new)[-1]
                break
            time.sleep(0.01)
        bundle_s = time.perf_counter() - t0
        if bundle is None:
            fail("obs: no incident bundle within 30 s")
        listed = [i for i in adm.incidents()
                  if i["id"] + ".json" == bundle]
        doc = adm.incident(bundle[:-5])
        if not listed or listed[0]["trigger"] != "drive.probation" or \
                listed[0]["events"] <= 0 or not doc.get("slow_spans"):
            fail(f"obs: the incident bundle: {listed}")
        # the SLO engine's windows: small PUTs keep the short window fed
        # while the long one fills (the engine evaluates every second)
        labels = [f"{int(float(w))}s" for w in OBS_SLO_WINDOWS_S.split(",")]
        minimum = int(os.environ.get("MINIO_TPU_SLO_MIN_SAMPLES", "10"))
        deadline = time.monotonic() + 40
        while True:
            for i in range(minimum + 2):
                if c.send("PUT", f"/obs/slo-{i}", body=b"s" * 1024)[0] != 200:
                    fail("obs: an SLO-feeding PUT")
            time.sleep(1.2)
            slo_doc = adm.slo()
            wr = {o["objective"]: o for o in slo_doc["objectives"]}[
                "write-latency"]["windows"]
            if all(wr.get(lb, {}).get("samples", 0) >= minimum
                   for lb in labels):
                break
            if time.monotonic() > deadline:
                fail(f"obs: the SLO windows: {wr}")
        console = [e["message"] for e in adm.console_log()]
        if f"node {node.spec.addr} online" not in console:
            fail("obs: consolelog lacks the node's online line")
        summary["incident"] = {
            "bundle_s": round(bundle_s, 4),
            "journal_events": listed[0]["events"],
            "slow_spans": len(doc["slow_spans"]),
            "providers": sorted(doc["state"]),
            "slo_write_latency_windows": wr,
            "console_lines": len(console),
            "profiling_round_s": round(prof_round_s, 3),
            "profile_bytes": {n: len(t) for n, t in profiles.items()}}
        emit({"phase": "obs", "step": "incident", **summary["incident"],
              "card": card})
        note("incident, SLO, console")
        # -- reboot: the journal replays its segments -------------------------
        persisted = {(e["class"], e["seq"]) for e in adm.events()}
        node.shutdown()
        node = None
        node, reboot_s = boot()
        replayed = {(e["class"], e["seq"]) for e in madmin.AdminClient(
            "127.0.0.1", node.s3.port, creds.access_key,
            creds.secret_key).events()}
        mine = {x for x in persisted if x in replayed}
        if not mine or ("drive.probation", max(
                s for cl, s in persisted if cl == "drive.probation")) \
                not in replayed:
            fail(f"obs: the reboot replayed {len(replayed)} records, none "
                 "of the phase's")
        summary["reboot"] = {"boot_s": round(reboot_s, 3),
                             "records_replayed": len(replayed),
                             "phase_records_replayed": len(mine)}
        emit({"phase": "obs", "step": "reboot", **summary["reboot"],
              "card": card})
    finally:
        codec_mod._record_step = real_record
        telemetry.SPANS.configure(*was_sampling)
        audit.shutdown()
        audit.server_close()
        if node is not None:
            node.shutdown()
        for v, old in saved_env.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old
        shutil.rmtree(root, ignore_errors=True)
    summary["seconds"] = round(time.perf_counter() - t_phase, 3)
    summary["card"] = card
    emit(summary)
    return summary


def run_gray(tmp, card, counts, np) -> dict:
    """Phase 21: the gray-failure plane on the card, modelled on the
    reference bench's bench_gray_ab. A fresh node as `python -m
    minio_tpu_torch server /d{1...16}` boots it (cluster.start_single,
    12+4, 1 MiB blocks, tmpfs where /dev/shm has GRAY_SHM_MIN_BYTES
    free), its heal scanner, crawler, transition worker and the disk
    monitor's loop stopped (the phase calls disk_monitor.scan_once
    itself); its MRF queue runs. Drive 0 of the set is wrapped in a
    NaughtyDisk (storage/naughty.py) stalling GRAY_STALL_S on every call
    of the bench's read and write verbs. Two passes, each in a bucket of
    its own, the tracker reset before each:
      * OFF: MINIO_TPU_HEDGE, MINIO_TPU_QUORUM_ACK and MINIO_TPU_QUARANTINE
        off: every PUT waits out the stalled drive's shard writes, every
        GET whose read plan holds it waits out its stalled shard read;
      * ON: the bench's tightened knobs (hedge ceiling a quarter of the
        stall, write-stall ceiling half of it, quarantine at 0.2 s, 4
        samples, no probation dwell, 2 probes).
    In each: GRAY_OBJECTS[0] signed PUTs of GRAY_OBJECTS[1] bytes over
    GRAY_STREAMS clients, the MRF queue drained (the ON pass's abandoned
    shard writes heal through recover on the card while the drive is
    still slow), GRAY_GETS GETs over GRAY_STREAMS clients (the ON pass's
    hedged and benign-missing data shards decode on the card); p50/p99 of
    each, hedges by trigger, laggards, stalls injected. The ON pass then
    walks the drive through the quarantine: scan_once convicts it
    (suspect), a probation probe still slow re-convicts it, the drive is
    disarmed, and probes pass until the heal-verified re-admission
    (readmit); drivehealth answers with the drive.* journal records.
    Each pass ends with the drive disarmed, MRF drained and every object
    read back byte- and ETag-equal (lost_after_mrf 0). The launch counts
    are set to 0 just before each pass and read just after; the ON pass
    must show decode and recover dispatches on the card and gf_matmul and
    hh256 launches."""
    import concurrent.futures

    from minio_tpu_torch import cluster, madmin
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.storage.naughty import FaultStats, NaughtyDisk
    from minio_tpu_torch.utils import healthtrack, stagetimer, telemetry
    k, m, bs = 12, 4, 1 << 20
    stall = GRAY_STALL_S
    read_stalls = ("read_file_stream", "read_file", "read_all")
    write_stalls = ("append_file", "create_file", "write_all",
                    "write_metadata", "rename_data")
    knobs_off = dict(PLANE_OFF)
    knobs_on = {"MINIO_TPU_HEDGE": "on", "MINIO_TPU_QUORUM_ACK": "on",
                "MINIO_TPU_QUARANTINE": "on",
                "MINIO_TPU_HEDGE_FLOOR_S": "0.05",
                "MINIO_TPU_HEDGE_CEIL_S": str(stall / 4),
                "MINIO_TPU_WRITE_STALL_FLOOR_S": "0.1",
                "MINIO_TPU_WRITE_STALL_CEIL_S": str(stall / 2),
                "MINIO_TPU_QUAR_LATENCY_S": str(stall / 2.5),
                "MINIO_TPU_QUAR_MIN_SAMPLES": "4",
                "MINIO_TPU_QUAR_PROBATION_S": "0",
                "MINIO_TPU_QUAR_PROBES": "2",
                # the bar is the larger of QUAR_LATENCY_S and the healthy
                # drives' p95 times QUAR_RATIO; on the card's path under 4
                # clients the healthy p95 reached 0.0923 s on an H100 80GB
                # HBM3 at 700 W (16 MiB objects, not the bench's 1 MiB on
                # the host), and 8 x 0.0923 s = 0.7386 s is above the
                # drive's 0.5768 s: ratio 8 would neither convict the
                # stalled drive nor fail its probe
                "MINIO_TPU_QUAR_RATIO": GRAY_QUAR_RATIO}
    rng = np.random.default_rng(SEED + 121)
    t_phase = time.perf_counter()

    def note(msg: str) -> None:
        print(f"[gray {time.perf_counter() - t_phase:.1f} s] {msg}",
              file=sys.stderr, flush=True)

    creds = Credentials("smokegrayroot", "smokegrayrootsecret")
    saved_env = {v: os.environ.get(v) for v in set(knobs_off) | set(knobs_on)}
    shm = "/dev/shm"
    on_shm = os.path.isdir(shm) and \
        shutil.disk_usage(shm).free >= GRAY_SHM_MIN_BYTES
    root = tempfile.mkdtemp(prefix="chip_smoke_gray_",
                            dir=shm if on_shm else tmp)
    drives = [os.path.join(root, f"d{i}") for i in range(k + m)]
    hedged = telemetry.REGISTRY.counter("minio_tpu_hedged_reads_total")
    laggards = telemetry.REGISTRY.counter("minio_tpu_write_laggards_total")
    n_obj, size = GRAY_OBJECTS
    summary = {"phase": "gray", "step": "summary", "drives": k + m,
               "ec": f"{k}+{m}", "block_size": bs,
               "drives_on": "tmpfs (/dev/shm)" if on_shm
               else "the disk (tmp)", "objects": n_obj, "object_bytes": size,
               "gets": GRAY_GETS, "streams": GRAY_STREAMS, "stall_s": stall,
               "stalled_read_verbs": list(read_stalls),
               "stalled_write_verbs": list(write_stalls),
               "knobs_on": knobs_on}

    def pct(xs: list) -> dict:
        s_ = sorted(xs)
        return {"p50_ms": round(s_[len(s_) // 2] * 1e3, 2),
                "p99_ms": round(s_[max(0, int(len(s_) * .99) - 1)] * 1e3,
                                2),
                "max_ms": round(s_[-1] * 1e3, 2), "n": len(s_)}

    def md5(b: bytes) -> str:
        return hashlib.md5(b).hexdigest()

    node = None
    try:
        node = cluster.start_single(drives, creds=creds, parity=m,
                                    set_drive_count=k + m, block_size=bs)
        node._iam_refresh_stop.set()
        mon = node.disk_monitor
        for loop in (mon, node.heal_scanner, node.crawler,
                     node.transition_worker):
            loop.close()
            if getattr(loop, "_thread", None) is not None:
                loop._thread.join(timeout=120)
                if loop._thread.is_alive():
                    fail("gray: a background loop did not stop")
        pool, sched = node.sets, node.scheduler
        slot = pool.sets[0].disks[0]            # the DiskIDCheck of drive 0
        nd = NaughtyDisk(slot.inner, enabled=False)
        slot.inner = nd
        key = healthtrack.disk_key(slot)
        port = node.s3.port
        adm = madmin.AdminClient("127.0.0.1", port, creds.access_key,
                                 creds.secret_key, timeout=120)
        clients = [S3Client(port, creds, timeout=600)
                   for _ in range(GRAY_STREAMS)]
        note("booted")

        def read_back(bucket: str, bodies: list) -> int:
            lost = 0
            for i, body in enumerate(bodies):
                st, h, got = clients[0].send("GET", f"/{bucket}/o-{i:04d}")
                if st != 200 or got != body or \
                        h.get("etag") != f'"{md5(body)}"':
                    lost += 1
            return lost

        def run_pass(tag: str, env: dict) -> tuple[dict, list]:
            os.environ.update(env)
            healthtrack.TRACKER.reset()
            bucket = f"gray-{tag}"
            if clients[0].send("PUT", f"/{bucket}")[0] != 200:
                fail(f"gray: make bucket {bucket}")
            bodies = [rng.bytes(size) for _ in range(n_obj)]
            nd.stats = FaultStats()
            nd.stall_verbs = {v: stall for v in read_stalls + write_stalls}
            nd.arm()
            h0 = {t: hedged.value(trigger=t) for t in ("latency", "error")}
            lag0 = sum(dict(laggards._series).values())
            before = sched.stats()
            stagetimer.reset()
            stagetimer.enable()
            counts.zero()
            t0 = time.perf_counter()

            def puts(w: int) -> list:
                out = []
                for i in range(w, n_obj, GRAY_STREAMS):
                    t1 = time.perf_counter()
                    st, h, body = clients[w].send(
                        "PUT", f"/{bucket}/o-{i:04d}", body=bodies[i])
                    out.append(time.perf_counter() - t1)
                    if st != 200 or h.get("etag") != f'"{md5(bodies[i])}"':
                        return [f"PUT o-{i:04d}: HTTP {st} {body[:200]!r}"]
                return out

            def gets(w: int) -> list:
                out = []
                for j in range(w, GRAY_GETS, GRAY_STREAMS):
                    i = j % n_obj
                    t1 = time.perf_counter()
                    st, _h, got = clients[w].send("GET",
                                                  f"/{bucket}/o-{i:04d}")
                    out.append(time.perf_counter() - t1)
                    if st != 200 or got != bodies[i]:
                        return [f"GET o-{i:04d}: HTTP {st}, bytes differ"]
                return out

            def fan(fn) -> list:
                with concurrent.futures.ThreadPoolExecutor(
                        GRAY_STREAMS) as ex:
                    res = [x for r in ex.map(fn, range(GRAY_STREAMS))
                           for x in r]
                errs = [x for x in res if isinstance(x, str)]
                if errs:
                    fail(f"gray {tag}: {errs[0]}")
                return res

            put_lat = fan(puts)
            put_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            # the ON pass's abandoned shard writes heal through MRF while
            # the drive is still slow; settle them before the GETs
            if not node.object_layer.drain_mrf(180.0):
                fail(f"gray {tag}: MRF did not drain before the GETs")
            mrf_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            get_lat = fan(gets)
            get_s = time.perf_counter() - t1
            stagetimer.disable()
            seconds = stagetimer.report()
            res = {"put": pct(put_lat), "get": pct(get_lat),
                   "put_wall_s": round(put_s, 3),
                   "mrf_drain_s": round(mrf_s, 3),
                   "get_wall_s": round(get_s, 3),
                   "stalls_injected": nd.stats.stalls,
                   "stalled_s": round(nd.stats.stall_s, 3),
                   "hedges": {t: hedged.value(trigger=t) - h0[t]
                              for t in h0},
                   "laggards": sum(dict(laggards._series).values()) - lag0,
                   # the PUTs', MRF heals' and GETs' stages (p50/p99 ms,
                   # calls, summed seconds)
                   "stages": {n_: {**v, "seconds": seconds.get(n_, {}).get(
                       "seconds")}
                              for n_, v in stagetimer.percentiles().items()}}
            if tag == "on":
                res["quarantine"] = round_trip()
            # the drive recovers: every acknowledged write must read back
            nd.stall_verbs = {}
            nd.disarm()
            if not node.object_layer.drain_mrf(180.0):
                fail(f"gray {tag}: MRF did not drain after the pass")
            res["lost_after_mrf"] = read_back(bucket, bodies)
            launched = counts.read()
            after = sched.stats()
            res["dispatches_on_card"] = {
                v: (after["verbs"][v]["batches"]
                    - before["verbs"][v]["batches"])
                - (after["verbs"][v]["host_routed"]
                   - before["verbs"][v]["host_routed"])
                for v in ("encode", "decode", "recover")}
            res["launches"] = launched
            res["mrf"] = node.object_layer.mrf_stats()
            res["seconds"] = round(time.perf_counter() - t0, 3)
            emit({"phase": "gray", "step": tag, **res, "card": card})
            note(f"pass {tag}")
            return res, bodies

        def round_trip() -> dict:
            """bench_gray_ab's quarantine round trip on the ON pass's
            drive: convicted, re-convicted by a slow probe, re-admitted
            after the drive recovers."""
            nd.stall_verbs["disk_info"] = stall
            n_ev = len(mon.quarantine_events)
            tr = healthtrack.TRACKER
            verbs = ("read", "write")
            evidence_at_scan = {
                "drive_p95_s": tr.percentile("drive", key, 0.95, verbs=verbs),
                "drive_samples": sum(
                    v["n"] for e in tr.snapshot("drive") if e["key"] == key
                    for vb, v in e["verbs"].items() if vb in verbs),
                "healthy_p95_s": tr.healthy_percentile(
                    "drive", 0.95, verbs=verbs, exclude=key),
                "threshold_s": tr.quarantine_threshold("drive", key)}
            mon.scan_once()
            states = [healthtrack.TRACKER.state_of("drive", key)]
            mon.scan_once()                 # probation probe: still slow
            states.append(healthtrack.TRACKER.state_of("drive", key))
            nd.stall_verbs = {}
            nd.disarm()                     # the gray spell ends
            for _ in range(4):
                mon.scan_once()
                states.append(healthtrack.TRACKER.state_of("drive", key))
                if states[-1] == healthtrack.STATE_OK:
                    break
            events = [e for k_, e in list(mon.quarantine_events)[n_ev:]
                      if k_ == key]
            evidence = {k_: round(v, 4) if isinstance(v, float) else v
                        for k_, v in evidence_at_scan.items()}
            health = adm.drive_health()
            journal = [{"class": e["class"], "attrs": e["attrs"]}
                       for e in health["journal"]
                       if e["class"].startswith("drive.")
                       and e["attrs"].get("drive") == key]
            out = {"states": states, "events": events,
                   "evidence_at_first_scan": evidence,
                   "drivehealth_journal": journal,
                   "drivehealth_events": [
                       e["event"] for e in health["events"]
                       if e["drive"] == key],
                   "drivehealth_state": {d["key"]: d["state"]
                                         for d in health["drives"]}.get(key)}
            return out

        summary["off"], _ = run_pass("off", knobs_off)
        for v in knobs_off:
            os.environ.pop(v, None)
        summary["on"], _ = run_pass("on", knobs_on)
        off, on = summary["off"], summary["on"]
        q = on["quarantine"]
        states, events = q["states"], q["events"]
        if states[0] != healthtrack.STATE_SUSPECT or \
                states[-1] != healthtrack.STATE_OK or \
                events[:1] != ["suspect"] or events[-1:] != ["readmit"] \
                or "probation" not in events:
            fail(f"gray: the quarantine round trip: {q}")
        classes = [j["class"] for j in q["drivehealth_journal"]]
        if classes[-1:] != ["drive.readmit"] or "drive.suspect" not in classes:
            fail(f"gray: drivehealth's journal: {q['drivehealth_journal']}")
        summary["get_p99_speedup_x"] = round(
            off["get"]["p99_ms"] / max(on["get"]["p99_ms"], 1e-9), 2)
        summary["put_p99_speedup_x"] = round(
            off["put"]["p99_ms"] / max(on["put"]["p99_ms"], 1e-9), 2)
        summary["lost_after_mrf"] = off["lost_after_mrf"] + \
            on["lost_after_mrf"]
        summary["launches"] = on["launches"]
        if summary["lost_after_mrf"]:
            fail(f"gray: {summary['lost_after_mrf']} acknowledged writes "
                 "lost after the MRF drain")
        disp = on["dispatches_on_card"]
        if disp["decode"] <= 0 or disp["recover"] <= 0:
            fail(f"gray: the ON pass dispatched {disp} on the card (decode "
                 "and recover must both run there)")
        if min(on["launches"]["gf_matmul"], on["launches"]["hh256"]) <= 0:
            fail(f"gray: the ON pass launched {on['launches']}")
        if on["hedges"]["latency"] <= 0 or on["laggards"] <= 0:
            fail(f"gray: the ON pass hedged {on['hedges']} and abandoned "
                 f"{on['laggards']} laggards")
        if off["stalls_injected"] <= 0 or on["stalls_injected"] <= 0:
            fail("gray: the drive stalled in neither pass")
    finally:
        if node is not None:
            node.shutdown()
        healthtrack.TRACKER.reset()
        for v, old in saved_env.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old
        shutil.rmtree(root, ignore_errors=True)
    summary["seconds"] = round(time.perf_counter() - t_phase, 3)
    summary["card"] = card
    emit(summary)
    return summary


def run_admission(tmp, card, counts, np) -> dict:
    """Phase 22: the admission plane on the card, modelled on the
    reference bench's bench_tenants_ab. A fresh node as `python -m
    minio_tpu_torch server /d{1...16}` boots it (cluster.start_single,
    12+4, 1 MiB blocks, tmpfs where /dev/shm has ADM_SHM_MIN_BYTES free)
    with MINIO_TPU_EDGE_WORKERS=ADM_EDGE_WORKERS edge loops, each with its
    own SO_REUSEPORT listener; its heal scanner, crawler, transition
    worker and disk monitor loops stopped; the admission gate at
    ADM_MAX_CLIENTS; two IAM users with `readwrite` at equal QoS shares.
    The launch counts are set to 0 just before the traffic and read just
    after:
      * isolation, MINIO_TPU_QOS off then on: the noisy tenant runs
        ADM_NOISY_STREAMS streams of signed ADM_OBJECT PUTs while the
        polite tenant issues ADM_POLITE_OPS PUTs one at a time (each
        retried until it lands); polite p50/p99 per mode and
        isolation_p99_x (off over on), the noisy tenant's sheds under
        reason=tenant (a refusal the client sees as a reset mid-body
        counts too) and the polite tenant's tenant sheds (must be 0);
      * the lone tenant's overhead: ADM_OVERHEAD_ROUNDS rounds of 8
        concurrent root PUTs a mode, put_p99_overhead_x (on over off; 8
        samples a mode: printed, not a verdict);
      * the edge loops: each loop's own accepts (every loop above 0),
        minio_tpu_edge_accepted_total and _requests_total, the pool
        gauges, each loop's lag p99;
      * object lock and POST: a bucket made with object lock and a
        default COMPLIANCE retention of one day takes an ADM_OBJECT PUT,
        whose version delete is refused (ObjectLocked); a legal hold set
        and read back; a GOVERNANCE object deleted with the bypass
        header; one ADM_OBJECT post-policy upload read back;
      * every acknowledged PUT read back, bytes and ETag; gf_matmul and
        hh256 launches above 0 and encode dispatches on the card."""
    import base64
    import concurrent.futures
    import datetime
    import hmac
    import http.client
    import urllib.parse

    from minio_tpu_torch import cluster
    from minio_tpu_torch.features import objectlock as olock
    from minio_tpu_torch.s3 import signature as sig
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.s3.qos import Budget
    from minio_tpu_torch.utils import telemetry
    k, m, bs = 12, 4, 1 << 20
    size = ADM_OBJECT
    region = "us-east-1"
    rng = np.random.default_rng(SEED + 122)
    t_phase = time.perf_counter()

    def note(msg: str) -> None:
        print(f"[admission {time.perf_counter() - t_phase:.1f} s] {msg}",
              file=sys.stderr, flush=True)

    def md5(b: bytes) -> str:
        return hashlib.md5(b).hexdigest()

    def pct(xs: list) -> dict:
        s_ = sorted(xs)
        return {"p50_ms": round(s_[len(s_) // 2] * 1e3, 2),
                "p99_ms": round(s_[min(int(len(s_) * .99), len(s_) - 1)]
                                * 1e3, 2), "n": len(s_)}

    creds = Credentials("smokeadmroot", "smokeadmrootsecret")
    noisy = Credentials("noisytenant123", "noisysecret1234")
    polite = Credentials("politetenant12", "politesecret123")
    env = {"MINIO_TPU_EDGE_WORKERS": str(ADM_EDGE_WORKERS),
           "MINIO_TPU_EDGE": "on"}
    saved_env = {v: os.environ.get(v) for v in
                 list(env) + ["MINIO_TPU_QOS"]}
    shm = "/dev/shm"
    on_shm = os.path.isdir(shm) and \
        shutil.disk_usage(shm).free >= ADM_SHM_MIN_BYTES
    root = tempfile.mkdtemp(prefix="chip_smoke_adm_",
                            dir=shm if on_shm else tmp)
    drives = [os.path.join(root, f"d{i}") for i in range(k + m)]
    payloads = [rng.bytes(size) for _ in range(ADM_PAYLOADS)]
    hashes = [hashlib.sha256(p).hexdigest() for p in payloads]
    etags = [f'"{md5(p)}"' for p in payloads]
    shed = telemetry.REGISTRY.counter("minio_tpu_requests_shed_total")
    tenant_shed = telemetry.REGISTRY.counter(
        "minio_tpu_qos_tenant_shed_total")
    accepted_c = telemetry.REGISTRY.counter("minio_tpu_edge_accepted_total")
    requests_c = telemetry.REGISTRY.counter("minio_tpu_edge_requests_total")
    summary = {"phase": "admission", "step": "summary", "drives": k + m,
               "ec": f"{k}+{m}", "block_size": bs,
               "drives_on": "tmpfs (/dev/shm)" if on_shm
               else "the disk (tmp)", "object_bytes": size,
               "edge_workers": ADM_EDGE_WORKERS,
               "max_clients": ADM_MAX_CLIENTS,
               "noisy_streams": ADM_NOISY_STREAMS,
               "polite_ops": ADM_POLITE_OPS,
               "overhead_rounds": ADM_OVERHEAD_ROUNDS}
    acked: dict = {}                       # (bucket, key) -> payload index
    acked_mu = threading.Lock()
    node = None
    try:
        os.environ.update(env)
        node = cluster.start_single(drives, creds=creds, parity=m,
                                    set_drive_count=k + m, block_size=bs)
        node._iam_refresh_stop.set()
        for loop in (node.disk_monitor, node.heal_scanner, node.crawler,
                     node.transition_worker):
            loop.close()
            if getattr(loop, "_thread", None) is not None:
                loop._thread.join(timeout=120)
                if loop._thread.is_alive():
                    fail("admission: a background loop did not stop")
        edge = node.s3._edge
        if edge is None or len(edge.loops) != ADM_EDGE_WORKERS:
            fail("admission: the edge did not start "
                 f"{ADM_EDGE_WORKERS} loops")
        api = node.s3.api
        api.set_max_clients(ADM_MAX_CLIENTS)
        for c in (noisy, polite):
            node.iam.add_user(c.access_key, c.secret_key)
            node.iam.attach_policy("readwrite", user=c.access_key)
        api.qos.registry.set_budget("tenant",
                                    Budget(noisy.access_key, share=1.0))
        api.qos.registry.set_budget("tenant",
                                    Budget(polite.access_key, share=1.0))
        port = node.s3.port
        sched = node.scheduler
        root_c = S3Client(port, creds, timeout=600)

        def put(cred, path, i, headers=None):
            """One signed PUT of payload i (its hash signed, not
            recomputed): (status, headers, body); a reset mid-body is
            a 503 the gate sent before reading the body."""
            hdrs = {"host": f"127.0.0.1:{port}"}
            hdrs.update(headers or {})
            signed = sig.sign_v4("PUT", urllib.parse.quote(path), {},
                                 hdrs, hashes[i], cred, region)
            try:
                st, h, body = S3Client(port, cred, timeout=600).send(
                    "PUT", path, body=payloads[i], signed=signed)
            except (OSError, http.client.HTTPException):
                return 503, {}, b""
            if st == 200:
                if h.get("etag") != etags[i]:
                    fail(f"admission: PUT {path}: ETag {h.get('etag')}")
                b_, _, key = path.lstrip("/").partition("/")
                with acked_mu:
                    acked[(b_, key, h.get("x-amz-version-id", ""))] = i
            return st, h, body

        for b_ in ("adm", "adm-lone"):
            if root_c.send("PUT", f"/{b_}")[0] != 200:
                fail(f"admission: make bucket {b_}")
        if put(creds, "/adm/warm", 0)[0] != 200:
            fail("admission: the warm-up PUT")
        note("booted")
        before = sched.stats()
        acc0, req0 = accepted_c.value(), requests_c.value()
        loop_acc0 = [lp.accepted for lp in edge.loops]
        counts.zero()
        t_traffic = time.perf_counter()

        # -- isolation, QoS off then on ------------------------------------
        def isolation(mode: str) -> dict:
            os.environ["MINIO_TPU_QOS"] = mode
            shed0 = shed.value(reason="tenant")
            polite0 = sum(tenant_shed.value(tenant=polite.access_key,
                                            kind=kd)
                          for kd in ("share", "rate", "bytes"))
            stop = threading.Event()
            mu = threading.Lock()
            tally = {"ok": 0, "shed": 0}

            def noisy_worker(w: int) -> None:
                i = 0
                while not stop.is_set():
                    st = put(noisy, f"/adm/n-{mode}-{w}-{i}",
                             (w + i) % ADM_PAYLOADS)[0]
                    with mu:
                        if st == 200:
                            tally["ok"] += 1
                        elif st == 503:
                            tally["shed"] += 1
                        else:
                            tally.setdefault(str(st), 0)
                            tally[str(st)] += 1
                    i += 1

            threads = [threading.Thread(target=noisy_worker, args=(w,),
                                        daemon=True)
                       for w in range(ADM_NOISY_STREAMS)]
            for t in threads:
                t.start()
            lat, retries = [], 0
            for i in range(ADM_POLITE_OPS):
                t0 = time.perf_counter()
                while True:
                    st = put(polite, f"/adm/p-{mode}-{i}",
                             i % ADM_PAYLOADS)[0]
                    if st == 200:
                        break
                    if st != 503:
                        fail(f"admission {mode}: polite PUT HTTP {st}")
                    retries += 1
                    time.sleep(0.002)
                lat.append(time.perf_counter() - t0)
            stop.set()
            for t in threads:
                t.join(timeout=120)
            return {"polite": pct(lat), "polite_retries": retries,
                    "polite_tenant_sheds": int(sum(
                        tenant_shed.value(tenant=polite.access_key, kind=kd)
                        for kd in ("share", "rate", "bytes")) - polite0),
                    "noisy_ok": tally["ok"], "noisy_shed": tally["shed"],
                    "noisy_other": {k_: v for k_, v in tally.items()
                                    if k_ not in ("ok", "shed")},
                    "shed_tenant_delta": int(shed.value(reason="tenant")
                                             - shed0)}

        iso = {}
        for mode in ("off", "on"):
            iso[mode] = isolation(mode)
            note(f"isolation {mode}")
        summary["isolation"] = iso
        summary["isolation_p99_x"] = round(
            iso["off"]["polite"]["p99_ms"]
            / max(iso["on"]["polite"]["p99_ms"], 1e-9), 3)
        summary["noisy_sheds"] = iso["on"]["shed_tenant_delta"]
        summary["polite_sheds"] = iso["on"]["polite_tenant_sheds"]
        summary["tenant_stats"] = {
            t: {"requests": v["requests"], "shed": v["shed"]}
            for t, v in api.qos.stats().items()}

        # -- the lone tenant's overhead -------------------------------------
        def overhead(mode: str) -> dict:
            os.environ["MINIO_TPU_QOS"] = mode
            lat, mu = [], threading.Lock()

            def one(i: int) -> None:
                t0 = time.perf_counter()
                while True:
                    st = put(creds, f"/adm-lone/o-{mode}-{i}",
                             i % ADM_PAYLOADS)[0]
                    if st == 200:
                        break
                    if st != 503:
                        fail(f"admission overhead {mode}: HTTP {st}")
                    time.sleep(0.01)
                with mu:
                    lat.append(time.perf_counter() - t0)

            for r in range(ADM_OVERHEAD_ROUNDS):
                with concurrent.futures.ThreadPoolExecutor(8) as ex:
                    list(ex.map(one, range(r * 8, (r + 1) * 8)))
            return pct(lat)

        summary["overhead"] = {mode: overhead(mode)
                               for mode in ("off", "on")}
        summary["put_p99_overhead_x"] = round(
            summary["overhead"]["on"]["p99_ms"]
            / max(summary["overhead"]["off"]["p99_ms"], 1e-9), 3)
        note("overhead")

        # -- object lock and POST --------------------------------------------
        os.environ["MINIO_TPU_QOS"] = "on"
        lock = {}
        if root_c.send("PUT", "/adm-lock", headers={
                "x-amz-bucket-object-lock-enabled": "true"})[0] != 200:
            fail("admission: make the object-lock bucket")
        cfg = (b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
               b"</ObjectLockEnabled><Rule><DefaultRetention><Mode>"
               b"COMPLIANCE</Mode><Days>1</Days></DefaultRetention></Rule>"
               b"</ObjectLockConfiguration>")
        lock["config"] = root_c.send("PUT", "/adm-lock",
                                     query={"object-lock": ""},
                                     body=cfg)[0]
        st, h, _ = put(creds, "/adm-lock/comp", 1)
        vid = h.get("x-amz-version-id", "")
        lock["put"] = st
        st, _, body = root_c.send("GET", "/adm-lock/comp",
                                  query={"retention": "", "versionId": vid})
        lock["retention"] = (st, b"COMPLIANCE" in body)
        st, _, body = root_c.send("DELETE", "/adm-lock/comp",
                                  query={"versionId": vid})
        lock["version_delete"] = (st, b"<Code>ObjectLocked</Code>" in body)
        lock["legal_hold_set"] = root_c.send(
            "PUT", "/adm-lock/comp",
            query={"legal-hold": "", "versionId": vid},
            body=b"<LegalHold><Status>ON</Status></LegalHold>")[0]
        st, _, body = root_c.send("GET", "/adm-lock/comp",
                                  query={"legal-hold": "", "versionId": vid})
        lock["legal_hold_read"] = (st, b"<Status>ON</Status>" in body)
        until = olock.iso(time.time() + 86400)
        st, h, _ = put(creds, "/adm-lock/gov", 2, headers={
            "x-amz-object-lock-mode": "GOVERNANCE",
            "x-amz-object-lock-retain-until-date": until})
        gvid = h.get("x-amz-version-id", "")
        lock["governance_put"] = st
        st, _, body = root_c.send("DELETE", "/adm-lock/gov",
                                  query={"versionId": gvid})
        lock["governance_delete"] = (st, b"<Code>ObjectLocked</Code>"
                                     in body)
        st = root_c.send("DELETE", "/adm-lock/gov",
                         query={"versionId": gvid}, headers={
                             "x-amz-bypass-governance-retention":
                             "true"})[0]
        lock["governance_bypass_delete"] = st
        if st == 204:
            with acked_mu:
                acked.pop(("adm-lock", "gov", gvid), None)
        if lock["config"] != 200 or lock["put"] != 200 or \
                lock["retention"] != (200, True) or \
                lock["version_delete"] != (400, True) or \
                lock["legal_hold_set"] != 200 or \
                lock["legal_hold_read"] != (200, True) or \
                lock["governance_put"] != 200 or \
                lock["governance_delete"] != (400, True) or \
                lock["governance_bypass_delete"] != 204:
            fail(f"admission: the object-lock verbs answered {lock}")
        # one post-policy upload of ADM_OBJECT bytes
        if root_c.send("PUT", "/adm-post")[0] != 200:
            fail("admission: make the POST bucket")
        t = datetime.datetime.now(datetime.timezone.utc)
        datestamp, amz_date = t.strftime("%Y%m%d"), \
            t.strftime("%Y%m%dT%H%M%SZ")
        credential = f"{creds.access_key}/{datestamp}/{region}/s3/" \
            "aws4_request"
        policy = base64.b64encode(json.dumps({
            "expiration": (t + datetime.timedelta(hours=1)).strftime(
                "%Y-%m-%dT%H:%M:%SZ"),
            "conditions": [{"bucket": "adm-post"},
                           ["starts-with", "$key", "up/"],
                           ["content-length-range", 1, 2 * size],
                           {"x-amz-credential": credential},
                           {"x-amz-date": amz_date}]}).encode()).decode()
        skey = sig.signing_key(creds.secret_key, datestamp, region)
        fields = {"key": "up/${filename}", "policy": policy,
                  "x-amz-credential": credential, "x-amz-date": amz_date,
                  "x-amz-signature": hmac.new(skey, policy.encode(),
                                              hashlib.sha256).hexdigest()}
        boundary = "admboundary22"
        form = b"".join(
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="{k_}"\r\n\r\n{v}\r\n'.encode()
            for k_, v in fields.items()) + (
            f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\";"
            f' filename="post.bin"\r\nContent-Type: '
            "application/octet-stream\r\n\r\n").encode() + payloads[3] + \
            f"\r\n--{boundary}--\r\n".encode()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/adm-post", body=form, headers={
            "Content-Type": f"multipart/form-data; boundary={boundary}",
            "Content-Length": str(len(form))})
        resp = conn.getresponse()
        resp.read()
        post_etag = resp.getheader("ETag")
        conn.close()
        lock["post_upload"] = resp.status
        if resp.status != 204 or post_etag != etags[3]:
            fail(f"admission: the POST upload answered {resp.status} "
                 f"{post_etag}")
        acked[("adm-post", "up/post.bin", "")] = 3
        summary["lock_and_post"] = lock
        note("object lock and POST")
        traffic_s = time.perf_counter() - t_traffic

        # -- read just after -------------------------------------------------
        launched = counts.read()
        after = sched.stats()
        summary["launches"] = launched
        summary["dispatches_on_card"] = {
            v: (after["verbs"][v]["batches"] - before["verbs"][v]["batches"])
            - (after["verbs"][v]["host_routed"]
               - before["verbs"][v]["host_routed"])
            for v in ("encode", "decode", "recover")}
        per_loop = [lp.accepted - a for lp, a in zip(edge.loops, loop_acc0)]
        telemetry.REGISTRY.render()          # runs the gauges' collector
        summary["edge"] = {
            "accepted_per_loop": per_loop,
            "requests_per_loop": [lp.requests for lp in edge.loops],
            "accepted_total_delta": int(accepted_c.value() - acc0),
            "requests_total_delta": int(requests_c.value() - req0),
            "gauges": {g: telemetry.REGISTRY.gauge(
                f"minio_tpu_edge_{g}").value()
                for g in ("open_conns", "pool_size", "pool_busy",
                          "pool_idle", "pool_pending")},
            "loop_lag": {lp.label: pct_ms(list(lp.lag_samples))
                         for lp in edge.loops}}
        if min(per_loop) <= 0:
            fail(f"admission: a loop accepted nothing: {per_loop}")
        if summary["edge"]["accepted_total_delta"] != sum(per_loop):
            fail(f"admission: minio_tpu_edge_accepted_total moved "
                 f"{summary['edge']['accepted_total_delta']}, the loops "
                 f"{per_loop}")

        # -- every acknowledged PUT read back (the plane off: 8 readers of
        # one tenant would pass its share while the others stay active) --
        os.environ["MINIO_TPU_QOS"] = "off"
        t1 = time.perf_counter()

        def read_one(item) -> list:
            (b_, key, vid_), i = item
            st, h, got = S3Client(port, creds, timeout=600).send(
                "GET", f"/{b_}/{key}",
                query={"versionId": vid_} if vid_ else None)
            if st == 200 and got == payloads[i] and \
                    h.get("etag") == etags[i]:
                return []
            return [{"object": f"{b_}/{key}", "version": vid_,
                     "status": st, "bytes": len(got),
                     "etag": h.get("etag"),
                     "body": got[:300].decode("latin-1")
                     if st != 200 else ""}]

        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            bad = [x for r in ex.map(read_one, sorted(acked.items()))
                   for x in r]
        lost = len(bad)
        summary["read_back"] = {"objects": len(acked), "lost": lost,
                                "seconds": round(time.perf_counter() - t1,
                                                 3), "first_lost": bad[:3]}
        summary["traffic_s"] = round(traffic_s, 3)
        if lost:
            fail(f"admission: {lost} of {len(acked)} acknowledged PUTs "
                 f"did not read back, e.g. {bad[:3]}")
        if summary["noisy_sheds"] <= 0:
            fail(f"admission: the noisy tenant was never shed under "
                 f"reason=tenant: {iso['on']}")
        if summary["polite_sheds"] != 0:
            fail(f"admission: the polite tenant was shed: {iso['on']}")
        if min(launched["gf_matmul"], launched["hh256"]) <= 0 or \
                summary["dispatches_on_card"]["encode"] <= 0:
            fail(f"admission: launched {launched}, dispatched "
                 f"{summary['dispatches_on_card']} on the card")
    finally:
        if node is not None:
            node.shutdown()
        for v, old in saved_env.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old
        shutil.rmtree(root, ignore_errors=True)
    summary["seconds"] = round(time.perf_counter() - t_phase, 3)
    summary["card"] = card
    emit(summary)
    return summary


def run_notify(tmp, card, counts, np) -> dict:
    """Phase 23: bucket event notification on the card's path, the
    reference bench's bench_notify_ab with every PUT encoding on the card.
    A fresh node as `python -m minio_tpu_torch server /d{1...16}` boots it
    (cluster.start_single, 12+4, 1 MiB blocks, tmpfs where /dev/shm has
    NOTIFY_SHM_MIN_BYTES free; its disk monitor, heal scanner and crawler
    loops stopped, the transition worker running). A webhook receiver in
    this process stalls every POST NOTIFY_WEBHOOK_DELAY_S; it is added with
    madmin.add_notify_target. The launch counts are set to 0 just before
    the traffic and read just after:
      * one warm round, NOTIFY_BASE_ROUNDS rounds with no notification
        configuration, a signed PUT ?notification wiring
        s3:ObjectCreated:* and s3:ObjectRemoved:* to the webhook, then
        NOTIFY_ON_ROUNDS rounds; each round NOTIFY_STREAMS concurrent
        signed NOTIFY_OBJECT PUTs over HTTP, no encode dispatch routed to
        the host in its window; p50/p99 per mode and
        put_p99_degradation_x (printed, not a verdict: 16 PUTs a mode);
      * after the plane's drain every key of the configured rounds at the
        webhook, each record's size and eTag the PUT's, duplicates
        printed; the plane's pending, backlog and dropped 0; the
        minio_tpu_notify_lag_seconds histogram;
      * a ListenBucketNotification subscriber over HTTP during the last
        round: one s3:ObjectCreated:Put record for each of its keys (the
        legacy notifier's records, which carry no size or eTag, as the
        reference's do);
      * a DELETE, a delete marker in a versioned bucket, a multipart
        complete of two 8 MiB parts; an fs tier on tmpfs, one object
        transitioned by a crawler pass and restored over HTTP (on the
        tier worker: MINIO_TPU_RESTORE_ASYNC_BYTES at the object's size),
        the restore's s3:ObjectRestore:Post from the handler, the plane's
        s3:ObjectTransition:Complete (the stub) and
        s3:ObjectRestore:Completed (the restored copy); the same pass
        expiring one object, its s3:ObjectRemoved:Lifecycle through a
        config-KV notify_webhook;
      * the receiver stopped for NOTIFY_OUTAGE_PUTS PUTs whose records
        wait in the plane's durable queue, the node rebooted on its
        drives, the receiver back: the backlog reaches it after the
        reboot;
      * every acknowledged PUT read back (bytes and ETag); gf_matmul and
        hh256 launches and the encode dispatches on the card."""
    import concurrent.futures
    import http.client
    import http.server
    import urllib.parse

    from minio_tpu_torch import cluster, madmin
    from minio_tpu_torch.s3 import signature as sig
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.tier.config import TierConfig
    from minio_tpu_torch.utils import telemetry
    k, m, bs = 12, 4, 1 << 20
    size = NOTIFY_OBJECT
    region = "us-east-1"
    rng = np.random.default_rng(SEED + 123)
    t_phase = time.perf_counter()

    def note(msg: str) -> None:
        print(f"[notify {time.perf_counter() - t_phase:.1f} s] {msg}",
              file=sys.stderr, flush=True)

    creds = Credentials("smokentfroot", "smokentfrootsecret")
    shm = "/dev/shm"
    on_shm = os.path.isdir(shm) and \
        shutil.disk_usage(shm).free >= NOTIFY_SHM_MIN_BYTES
    root = tempfile.mkdtemp(prefix="chip_smoke_ntf_",
                            dir=shm if on_shm else tmp)
    drives = [os.path.join(root, f"d{i}") for i in range(k + m)]
    payloads = [rng.bytes(size) for _ in range(NOTIFY_PAYLOADS)]
    half = [rng.bytes(size // 2) for _ in range(2)]
    hashes = [hashlib.sha256(p).hexdigest() for p in payloads]
    etags = [hashlib.md5(p).hexdigest() for p in payloads]

    # -- the webhook receiver ----------------------------------------------
    got: list = []                   # (path, eventName, key, size, eTag)
    got_mu = threading.Lock()

    class Hook(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
            time.sleep(NOTIFY_WEBHOOK_DELAY_S)
            rec = json.loads(body)["Records"][0]
            obj = rec["s3"]["object"]
            with got_mu:
                got.append((self.path, rec["eventName"],
                            urllib.parse.unquote(obj["key"]),
                            obj.get("size"), obj.get("eTag")))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    def serve(port: int = 0):
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Hook)
        srv.daemon_threads = True
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    hook = serve()
    hook_live = True
    hook_port = hook.server_address[1]
    url = f"http://127.0.0.1:{hook_port}"
    saved_env = {v: os.environ.get(v)
                 for v in ("MINIO_TPU_RESTORE_ASYNC_BYTES",
                           "MINIO_TPU_METACACHE_PERSIST_S")}
    # the metacache's segment writes (small objects, encoded on the host,
    # every MINIO_TPU_METACACHE_PERSIST_S) held off for the phase, so
    # that a window's encode dispatches are its PUTs' alone
    os.environ["MINIO_TPU_METACACHE_PERSIST_S"] = "3600"
    summary = {"phase": "notify", "step": "summary", "drives": k + m,
               "ec": f"{k}+{m}", "block_size": bs,
               "drives_on": "tmpfs (/dev/shm)" if on_shm
               else "the disk (tmp)", "object_bytes": size,
               "streams": NOTIFY_STREAMS,
               "base_rounds": NOTIFY_BASE_ROUNDS,
               "on_rounds": NOTIFY_ON_ROUNDS,
               "webhook_delay_s": NOTIFY_WEBHOOK_DELAY_S}
    acked: dict = {}                 # (bucket, key) -> body
    gone: set = set()
    acked_mu = threading.Lock()
    dispatch = {"batches": 0, "host_routed": 0, "blocks": 0}
    node = None

    def boot():
        n = cluster.start_single(drives, creds=creds, parity=m,
                                 set_drive_count=k + m, block_size=bs)
        n._iam_refresh_stop.set()
        for loop in (n.disk_monitor, n.heal_scanner, n.crawler):
            loop.close()
            if getattr(loop, "_thread", None) is not None:
                loop._thread.join(timeout=120)
                if loop._thread.is_alive():
                    fail("notify: a background loop did not stop")
        return n

    def encodes(n) -> dict:
        return dict(n.scheduler.stats()["verbs"]["encode"])

    def on_card(n, before: dict, what: str, blocks: int) -> None:
        """No encode dispatch of the window `what` went to the host, and
        the window's encode blocks cover its PUTs' blocks."""
        after = encodes(n)
        d = {key: after[key] - before[key]
             for key in ("batches", "host_routed", "blocks")}
        for key in d:
            dispatch[key] += d[key]
        if d["host_routed"] or d["batches"] <= d["host_routed"] or \
                d["blocks"] < blocks:
            fail(f"notify {what}: encode dispatches {d}, want {blocks} "
                 "blocks on the card")

    def put(c, port, path, body, digest=None):
        hdrs = {"host": f"127.0.0.1:{port}"}
        signed = sig.sign_v4("PUT", urllib.parse.quote(path), {}, hdrs,
                             digest or hashlib.sha256(body).hexdigest(),
                             creds, region)
        st, h, _ = c.send("PUT", path, body=body, signed=signed)
        if st != 200 or h.get("etag") != f'"{hashlib.md5(body).hexdigest()}"':
            fail(f"notify: PUT {path}: HTTP {st} {h.get('etag')}")
        b_, _, key = path.lstrip("/").partition("/")
        with acked_mu:
            acked[(b_, key)] = body
        return h

    def webhook(path_: str) -> list:
        with got_mu:
            return [g for g in got if g[0] == path_]

    try:
        node = boot()
        port = node.s3.port
        plane = node.notify_plane
        c = S3Client(port, creds, timeout=600)
        mc = madmin.AdminClient("127.0.0.1", port, creds.access_key,
                                creds.secret_key)
        arn = mc.add_notify_target(endpoint=url + "/plane", name="smoke",
                                   timeout=5.0)
        # the legacy notifier's config-KV webhook (its ARN is fixed)
        mc.set_config("notify_webhook", enable="on",
                      endpoint=url + "/legacy")
        legacy_arn = node.config.CONFIG_WEBHOOK_ARN
        if legacy_arn not in node.events.targets:
            fail("notify: the config-KV notify_webhook was not registered")
        for b_ in ("ntf", "ntf-ver", "ntf-tier"):
            if c.send("PUT", f"/{b_}")[0] != 200:
                fail(f"notify: make bucket {b_}")
        note("booted")

        def put_round(prefix: str) -> list:
            lat, mu = [], threading.Lock()
            before = encodes(node)

            def one(i: int) -> None:
                t0 = time.perf_counter()
                put(S3Client(port, creds, timeout=600), port,
                    f"/ntf/{prefix}{i}", payloads[i % NOTIFY_PAYLOADS],
                    hashes[i % NOTIFY_PAYLOADS])
                with mu:
                    lat.append(time.perf_counter() - t0)

            with concurrent.futures.ThreadPoolExecutor(NOTIFY_STREAMS) as ex:
                list(ex.map(one, range(NOTIFY_STREAMS)))
            on_card(node, before, f"round {prefix}",
                    NOTIFY_STREAMS * -(-size // bs))
            return lat

        counts.zero()
        sched_before = encodes(node)
        t_traffic = time.perf_counter()
        put_round("warm-")
        base = []
        for r in range(NOTIFY_BASE_ROUNDS):
            base += put_round(f"base{r}-")
        doc = ("<NotificationConfiguration><QueueConfiguration>"
               f"<Queue>{arn}</Queue><Event>s3:ObjectCreated:*</Event>"
               "<Event>s3:ObjectRemoved:*</Event></QueueConfiguration>"
               "</NotificationConfiguration>").encode()
        if c.send("PUT", "/ntf", query={"notification": ""},
                  body=doc)[0] != 200:
            fail("notify: PUT ?notification")
        st, _, body = c.send("GET", "/ntf", query={"notification": ""})
        if st != 200 or arn.encode() not in body:
            fail(f"notify: GET ?notification: HTTP {st}")
        during, listened = [], {}
        for r in range(NOTIFY_ON_ROUNDS):
            last = r == NOTIFY_ON_ROUNDS - 1
            if last:                 # a listener over the last round
                def listen():
                    """ND-JSON lines until the round's PUTs are all
                    heard (or the stream's idle window ends it; the
                    server's side ends at the node's shutdown, which
                    closes the event notifier's hub)."""
                    hdrs = {"host": f"127.0.0.1:{port}"}
                    q = {"events": ["s3:ObjectCreated:*"],
                         "prefix": [f"on{r}-"], "idle": ["60"]}
                    signed = sig.sign_v4(
                        "GET", "/ntf", q, hdrs,
                        hashlib.sha256(b"").hexdigest(), creds, region)
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=120)
                    conn.request("GET", "/ntf?" + urllib.parse.urlencode(
                        {k_: v[0] for k_, v in q.items()}), headers=signed)
                    resp = conn.getresponse()
                    listened["status"] = resp.status
                    lines = listened["lines"] = []
                    while len(lines) < NOTIFY_STREAMS:
                        line = resp.readline()
                        if not line:
                            break
                        if line.strip():
                            lines.append(line)
                    conn.close()

                lt = threading.Thread(target=listen, daemon=True)
                lt.start()
                deadline = time.monotonic() + 30
                while node.events.hub.subscriber_count == 0 and \
                        time.monotonic() < deadline:
                    time.sleep(0.01)
                if node.events.hub.subscriber_count == 0:
                    fail("notify: the listener never subscribed")
            during += put_round(f"on{r}-")
        summary["plane_at_measure"] = plane.stats()
        t_drain = time.perf_counter()
        if not plane.drain(180):
            fail(f"notify: the plane did not drain: {plane.stats()}")
        summary["drain_s"] = round(time.perf_counter() - t_drain, 3)
        lt.join(60)
        note("rounds")
        summary["baseline"] = pct_ms(base)
        summary["during_notify"] = pct_ms(during)
        summary["put_p99_degradation_x"] = round(
            summary["during_notify"]["p99_ms"]
            / max(summary["baseline"]["p99_ms"], 1e-9), 3)
        want = {f"on{r}-{i}": i % NOTIFY_PAYLOADS
                for r in range(NOTIFY_ON_ROUNDS)
                for i in range(NOTIFY_STREAMS)}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and \
                not set(want) <= {g[2] for g in webhook("/plane")}:
            time.sleep(0.05)
        hits = [g for g in webhook("/plane") if g[2] in want]
        keys = [g[2] for g in hits]
        summary["webhook"] = {
            "received": len(webhook("/plane")),
            "configured_keys": len(want),
            "delivered_keys": len(set(keys)),
            "duplicates": sorted({x for x in keys if keys.count(x) > 1})}
        if set(keys) != set(want):
            fail(f"notify: keys never delivered: "
                 f"{sorted(set(want) - set(keys))[:5]}")
        if any(g[1] != "s3:ObjectCreated:Put" or g[3] != size or
               g[4] != etags[want[g[2]]] for g in hits):
            fail(f"notify: a webhook record's name, size or eTag is not "
                 f"the PUT's: {hits[:2]}")
        if [g for g in webhook("/plane") if g[2].startswith(
                ("warm-", "base"))]:
            fail("notify: a PUT before the configuration was delivered")
        final = plane.stats()
        summary["plane_final"] = final
        if (final["pending"], final["backlog"], final["dropped"]) != \
                (0, 0, 0):
            fail(f"notify: pending/backlog/dropped after the drain: {final}")
        lag = telemetry.REGISTRY.histogram("minio_tpu_notify_lag_seconds")
        series = lag.series_snapshot()
        snap = series.get(tuple(sorted({"target": arn}.items())))
        if snap is None:
            snap = next(iter(series.values()), None)
        summary["lag_seconds"] = None if snap is None else {
            "buckets_s": list(lag.buckets), "counts": snap[0],
            "count": snap[2],
            "mean_s": round(snap[1] / max(snap[2], 1), 4)}
        lines = [json.loads(x) for x in listened.get("lines", [])]
        heard = [(d["Records"][0]["eventName"],
                  d["Records"][0]["s3"]["object"]["key"],
                  d["Records"][0]["s3"]["object"]["size"],
                  d["Records"][0]["s3"]["object"]["eTag"]) for d in lines]
        last_keys = {f"on{NOTIFY_ON_ROUNDS - 1}-{i}"
                     for i in range(NOTIFY_STREAMS)}
        summary["listener"] = {"status": listened.get("status"),
                               "records": len(heard),
                               "first": heard[:1]}
        if listened.get("status") != 200 or \
                sorted(h[1] for h in heard) != sorted(last_keys) or \
                {h[0] for h in heard} != {"s3:ObjectCreated:Put"}:
            fail(f"notify: the listener heard {heard[:3]} "
                 f"({len(heard)} records) for {len(last_keys)} PUTs")
        note("delivered")

        # -- the tail ----------------------------------------------------
        tail = {}
        if c.send("DELETE", "/ntf/on0-0")[0] != 204:
            fail("notify: DELETE")
        gone.add(("ntf", "on0-0"))
        vdoc = (b"<VersioningConfiguration><Status>Enabled</Status>"
                b"</VersioningConfiguration>")
        if c.send("PUT", "/ntf-ver", query={"versioning": ""},
                  body=vdoc)[0] != 200:
            fail("notify: versioning")
        if c.send("PUT", "/ntf-ver", query={"notification": ""},
                  body=doc)[0] != 200:
            fail("notify: PUT ?notification on the versioned bucket")
        # the window holds the PUTs' encodes only (a bucket's config is a
        # small object of its own, encoded on the host)
        before = encodes(node)
        vh = put(c, port, "/ntf-ver/doc", payloads[1], hashes[1])
        # the plane coalesces a key's pending events: the PUT's is
        # delivered before the marker's mutation
        if not plane.drain(180):
            fail(f"notify: the plane did not drain: {plane.stats()}")
        st, dh, _ = c.send("DELETE", "/ntf-ver/doc")
        if st != 204 or dh.get("x-amz-delete-marker") != "true":
            fail(f"notify: the delete marker: HTTP {st}")
        with acked_mu:        # the data version, read back by its id
            acked.pop(("ntf-ver", "doc"))
            acked[("ntf-ver", "doc", vh.get("x-amz-version-id"))] = \
                payloads[1]
        st, _, body = c.send("POST", "/ntf/mp", query={"uploads": ""})
        up = re.search(rb"<UploadId>([^<]+)</UploadId>", body)
        if st != 200 or up is None:
            fail(f"notify: create multipart: HTTP {st}")
        upload = up.group(1).decode()
        parts = []
        for pn, part in enumerate(half, 1):
            st, h, _ = c.send("PUT", "/ntf/mp", body=part, query={
                "partNumber": str(pn), "uploadId": upload})
            if st != 200:
                fail(f"notify: part {pn}: HTTP {st}")
            parts.append(h.get("etag"))
        cdoc = ("<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{pn}</PartNumber><ETag>{e}</ETag></Part>"
            for pn, e in enumerate(parts, 1))
            + "</CompleteMultipartUpload>").encode()
        st, _, body = c.send("POST", "/ntf/mp", query={"uploadId": upload},
                             body=cdoc)
        if st != 200:
            fail(f"notify: complete multipart: HTTP {st}")
        with acked_mu:
            acked[("ntf", "mp")] = half[0] + half[1]
        on_card(node, before, "tail", -(-size // bs) * 2)
        # the tier bucket: both webhooks, the plane's every class
        tdoc = ("<NotificationConfiguration><QueueConfiguration>"
                f"<Queue>{arn}</Queue><Event>s3:ObjectCreated:*</Event>"
                "<Event>s3:ObjectRemoved:*</Event>"
                "<Event>s3:ObjectRestore:*</Event>"
                "<Event>s3:ObjectTransition:*</Event></QueueConfiguration>"
                f"<QueueConfiguration><Queue>{legacy_arn}</Queue>"
                "<Event>s3:ObjectRemoved:*</Event>"
                "<Event>s3:ObjectRestore:*</Event></QueueConfiguration>"
                "</NotificationConfiguration>").encode()
        if c.send("PUT", "/ntf-tier", query={"notification": ""},
                  body=tdoc)[0] != 200:
            fail("notify: PUT ?notification on the tier bucket")
        node.tiers.add(TierConfig("cold", "fs",
                                  {"path": os.path.join(root, "tier")}))
        before = encodes(node)
        put(c, port, "/ntf-tier/cold/x", payloads[2], hashes[2])
        put(c, port, "/ntf-tier/exp/one", payloads[3 % NOTIFY_PAYLOADS],
            hashes[3 % NOTIFY_PAYLOADS])
        gone.add(("ntf-tier", "exp/one"))
        on_card(node, before, "tier PUTs", 2 * -(-size // bs))
        lc = ("<LifecycleConfiguration><Rule><ID>t</ID><Status>Enabled"
              "</Status><Filter><Prefix>cold/</Prefix></Filter><Transition>"
              "<Date>2020-01-01T00:00:00Z</Date><StorageClass>cold"
              "</StorageClass></Transition></Rule><Rule><ID>x</ID><Status>"
              "Enabled</Status><Filter><Prefix>exp/</Prefix></Filter>"
              "<Expiration><Date>2020-01-01T00:00:00Z</Date></Expiration>"
              "</Rule></LifecycleConfiguration>").encode()
        if c.send("PUT", "/ntf-tier", query={"lifecycle": ""},
                  body=lc)[0] != 200:
            fail("notify: PUT ?lifecycle")
        if not plane.drain(180):
            fail(f"notify: the plane did not drain: {plane.stats()}")
        if node.metacache is not None and not node.metacache.drain(30):
            fail("notify: the metacache did not drain")
        node.crawler.scan_once()
        if not node.transition_worker.drain(120):
            fail(f"notify: transitions {node.transition_worker.stats()}")
        if not plane.drain(180):
            fail(f"notify: the plane did not drain: {plane.stats()}")
        st, _, _ = c.send("GET", "/ntf-tier/cold/x")
        if st != 403:
            fail(f"notify: GET of the stub: HTTP {st}")
        os.environ["MINIO_TPU_RESTORE_ASYNC_BYTES"] = str(size)
        before = encodes(node)
        st = c.send("POST", "/ntf-tier/cold/x", query={"restore": ""},
                    body=b"<RestoreRequest><Days>1</Days></RestoreRequest>"
                    )[0]
        if st != 202:
            fail(f"notify: restore: HTTP {st}")
        if not node.transition_worker.drain(120):
            fail(f"notify: restore {node.transition_worker.stats()}")
        on_card(node, before, "restore", -(-size // bs))
        node.events.drain(30)
        if not plane.drain(180):
            fail(f"notify: the plane did not drain: {plane.stats()}")
        want_plane = {("s3:ObjectRemoved:Delete", "on0-0"),
                      ("s3:ObjectRemoved:DeleteMarkerCreated", "doc"),
                      ("s3:ObjectCreated:Put", "doc"),
                      ("s3:ObjectCreated:CompleteMultipartUpload", "mp"),
                      ("s3:ObjectCreated:Put", "cold/x"),
                      ("s3:ObjectTransition:Complete", "cold/x"),
                      ("s3:ObjectRestore:Completed", "cold/x"),
                      ("s3:ObjectRemoved:Delete", "exp/one")}
        want_legacy = {("s3:ObjectRemoved:Lifecycle", "exp/one"),
                       ("s3:ObjectRestore:Post", "cold/x")}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                want_plane <= {g[1:3] for g in webhook("/plane")}
                and want_legacy <= {g[1:3] for g in webhook("/legacy")}):
            time.sleep(0.05)
        tail["plane"] = sorted({g[1:3] for g in webhook("/plane")
                                if g[1] != "s3:ObjectCreated:Put"
                                or not g[2].startswith(("on", "warm",
                                                        "base"))})
        tail["legacy"] = sorted({g[1:3] for g in webhook("/legacy")})
        summary["tail"] = tail
        if not want_plane <= set(map(tuple, tail["plane"])) or \
                not want_legacy <= set(map(tuple, tail["legacy"])):
            fail(f"notify: the tail's records: {tail}; want plane "
                 f"{sorted(want_plane)}, legacy {sorted(want_legacy)}")
        note("tail")

        # -- the receiver down, the node rebooted --------------------------
        hook.shutdown()
        hook.server_close()
        hook_live = False
        before = encodes(node)
        outage = [f"down-{i}" for i in range(NOTIFY_OUTAGE_PUTS)]
        for i, key in enumerate(outage):
            put(c, port, f"/ntf/{key}", payloads[i % NOTIFY_PAYLOADS],
                hashes[i % NOTIFY_PAYLOADS])
        on_card(node, before, "outage PUTs",
                NOTIFY_OUTAGE_PUTS * -(-size // bs))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and \
                plane.stats()["backlog"] < NOTIFY_OUTAGE_PUTS:
            time.sleep(0.05)
        summary["outage"] = {"backlog_before_reboot":
                             plane.stats()["backlog"]}
        if plane.stats()["backlog"] < NOTIFY_OUTAGE_PUTS:
            fail(f"notify: the outage's records are not queued: "
                 f"{plane.stats()}")
        note("outage queued")
        launched = counts.read()
        first = encodes(node)
        node.shutdown()
        node = None
        note("node down")
        hook = serve(hook_port)
        hook_live = True
        t_reboot = time.perf_counter()
        node = boot()
        note("rebooted")
        port = node.s3.port
        c = S3Client(port, creds, timeout=600)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not set(outage) <= \
                {g[2] for g in webhook("/plane")}:
            time.sleep(0.05)
        summary["outage"]["delivered_after_reboot_s"] = round(
            time.perf_counter() - t_reboot, 3)
        if not set(outage) <= {g[2] for g in webhook("/plane")}:
            fail(f"notify: the backlog did not reach the receiver after "
                 f"the reboot: {node.notify_plane.stats()}")
        if not node.notify_plane.drain(60) or \
                node.notify_plane.stats()["backlog"]:
            fail(f"notify: backlog after the reboot: "
                 f"{node.notify_plane.stats()}")
        summary["outage"]["plane_after"] = node.notify_plane.stats()
        traffic_s = time.perf_counter() - t_traffic
        note("reboot")
        summary["launches"] = launched
        summary["dispatches_on_card"] = {
            "encode": first["batches"] - sched_before["batches"]
            - (first["host_routed"] - sched_before["host_routed"]),
            "encode_host_routed": first["host_routed"]
            - sched_before["host_routed"],
            "encode_blocks": first["blocks"] - sched_before["blocks"],
            "in_put_windows": dict(dispatch)}
        if min(launched["gf_matmul"], launched["hh256"]) <= 0 or \
                summary["dispatches_on_card"]["encode"] <= 0:
            fail(f"notify: launched {launched}, dispatched "
                 f"{summary['dispatches_on_card']} on the card")

        # -- every acknowledged PUT read back --------------------------------
        t1 = time.perf_counter()

        def read_one(item) -> list:
            ident, want_body = item
            b_, key = ident[0], ident[1]
            q = {"versionId": ident[2]} if len(ident) > 2 else None
            st, h, body = S3Client(port, creds, timeout=600).send(
                "GET", f"/{b_}/{key}", query=q)
            etag = h.get("etag", "").strip('"')
            want_etag = hashlib.md5(want_body).hexdigest() if \
                key != "mp" else None
            if st == 200 and body == want_body and \
                    (want_etag is None or etag == want_etag):
                return []
            return [{"object": f"{b_}/{key}", "status": st,
                     "bytes": len(body), "etag": etag}]

        items = [(i, b_) for i, b_ in acked.items()
                 if (i[0], i[1]) not in gone]
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            bad = [x for r in ex.map(read_one, items) for x in r]
        summary["read_back"] = {"objects": len(items), "lost": len(bad),
                                "seconds": round(time.perf_counter() - t1,
                                                 3), "first_lost": bad[:3]}
        summary["traffic_s"] = round(traffic_s, 3)
        if bad:
            fail(f"notify: {len(bad)} of {len(items)} acknowledged PUTs "
                 f"did not read back, e.g. {bad[:3]}")
    finally:
        if node is not None:
            node.shutdown()
        if hook_live:
            hook.shutdown()
            hook.server_close()
        for v, old in saved_env.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old
        shutil.rmtree(root, ignore_errors=True)
    summary["seconds"] = round(time.perf_counter() - t_phase, 3)
    summary["card"] = card
    emit(summary)
    return summary


def run_replicate(tmp, card, counts, np) -> dict:
    """Phase 24: active-active replication on the card's path, the
    reference bench's bench_replicate_ab with every version crossing the
    codec's size gate. Three port nodes are booted in this process as
    `python -m minio_tpu_torch server /d{1...16}` boots one
    (cluster.start_single, 12+4, 1 MiB blocks, tmpfs where /dev/shm has
    REPL_SHM_MIN_BYTES free; their disk monitor, heal scanner and crawler
    loops stopped), each with one versioned bucket; they share the card.
    The launch counts are set to 0 just before the traffic and read just
    after it:
      * site A takes REPL_PRELOAD versions of REPL_OBJECT bytes (cold-*,
        the resync's inventory), a warm round and REPL_BASE_ROUNDS
        baseline rounds of REPL_STREAMS concurrent signed PUTs over HTTP;
        then A->B and B->A are registered with madmin.add_replicate_target
        (wire targets: HTTPReplClient pushing into the peer's
        replication-apply branch), A's resync to B is started with
        madmin.start_replicate_resync, and REPL_ON_ROUNDS rounds run while
        it does; p50/p99 a mode and put_p99_degradation_x (printed, not a
        verdict: 16 PUTs a mode);
      * after the resync completes and both planes drain: A's and B's
        version listings equal (name, version id, mod time, ETag, delete
        marker); B serves the bytes and ETag of every preloaded version
        and of every PUT made during the resync; one PUT at B reaches A;
        a further sync cycle over every key writes no replica at either
        site (no ping-pong); a versioned DELETE at A leaves the same
        marker at B; each plane's pending, dropped and retry queue 0;
        the minio_tpu_repl_lag_seconds histogram and target_status();
      * the degraded reseed: REPL_GONE of A's drives taken away as phase
        3 takes them (offline to the set's engine), a third node C is
        registered as A's target for cold-* and resynced: every push
        reads through A's degraded GET (a version with a data shard on a
        gone drive decodes on the card), every replica write at C encodes
        on the card; C's cold-* listing and bytes equal A's; the drives
        back, what was written while they were gone healed through A's
        MRF queue;
      * each node's encode, decode and recover dispatches (on the card,
        host-routed, and host-routed dispatches at or past the codec's
        gate, which must be 0) beside the gf_matmul and hh256 launches."""
    import concurrent.futures
    import urllib.parse

    from minio_tpu_torch import cluster, madmin
    from minio_tpu_torch.object import codec
    from minio_tpu_torch.replicate import replica_writes_counter
    from minio_tpu_torch.storage.datatypes import hash_order
    from minio_tpu_torch.s3 import signature as sig
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.utils import telemetry
    k, m, bs = 12, 4, 1 << 20
    size = REPL_OBJECT
    blocks_each = -(-size // bs)
    region = "us-east-1"
    bucket = "repl"
    rng = np.random.default_rng(SEED + 124)
    t_phase = time.perf_counter()

    def note(msg: str) -> None:
        print(f"[replicate {time.perf_counter() - t_phase:.1f} s] {msg}",
              file=sys.stderr, flush=True)

    creds = Credentials("smokereplroot", "smokereplrootsecret")
    shm = "/dev/shm"
    on_shm = os.path.isdir(shm) and \
        shutil.disk_usage(shm).free >= REPL_SHM_MIN_BYTES
    root = tempfile.mkdtemp(prefix="chip_smoke_repl_",
                            dir=shm if on_shm else tmp)
    payloads = [rng.bytes(size) for _ in range(REPL_PAYLOADS)]
    hashes = [hashlib.sha256(p).hexdigest() for p in payloads]
    saved_env = {"MINIO_TPU_METACACHE_PERSIST_S":
                 os.environ.get("MINIO_TPU_METACACHE_PERSIST_S")}
    # the metacache's segment writes held off for the phase (gotcha 28)
    os.environ["MINIO_TPU_METACACHE_PERSIST_S"] = "3600"
    summary = {"phase": "replicate", "step": "summary", "drives": k + m,
               "ec": f"{k}+{m}", "block_size": bs,
               "drives_on": "tmpfs (/dev/shm)" if on_shm
               else "the disk (tmp)", "object_bytes": size,
               "preload": REPL_PRELOAD, "streams": REPL_STREAMS,
               "base_rounds": REPL_BASE_ROUNDS,
               "on_rounds": REPL_ON_ROUNDS, "drives_gone": REPL_GONE}
    nodes: dict = {}
    dispatch: dict = {}
    gate = codec.DEVICE_MIN_BYTES

    def boot(tag: str):
        drives = [os.path.join(root, tag, f"d{i}") for i in range(k + m)]
        n = cluster.start_single(drives, creds=creds, parity=m,
                                 set_drive_count=k + m, block_size=bs)
        n._iam_refresh_stop.set()
        for loop in (n.disk_monitor, n.heal_scanner, n.crawler):
            loop.close()
            if getattr(loop, "_thread", None) is not None:
                loop._thread.join(timeout=120)
                if loop._thread.is_alive():
                    fail("replicate: a background loop did not stop")
        # every erasure dispatch of the node's former, by verb: on the
        # card, host-routed, and host-routed at or past the size gate
        stats = {v: {"batches": 0, "blocks": 0, "host_routed": 0,
                     "host_routed_blocks": 0, "gated_host_routed": 0}
                 for v in ("encode", "decode", "recover")}
        mu = threading.Lock()
        sched = n.scheduler
        inner = sched._run_erasure

        def run(key, group, stage_cb):
            out = inner(key, group, stage_cb)
            nb = sum(p.blocks for p in group)
            with mu:
                s = stats[key[0]]
                s["batches"] += 1
                s["blocks"] += nb
                if out is None:
                    s["host_routed"] += 1
                    s["host_routed_blocks"] += nb
                    if nb * bs >= gate:
                        s["gated_host_routed"] += 1
            return out

        sched._run_erasure = run
        dispatch[tag] = (stats, mu)
        nodes[tag] = n
        c = S3Client(n.s3.port, creds, timeout=600)
        if c.send("PUT", f"/{bucket}")[0] != 200 or c.send(
                "PUT", f"/{bucket}", query={"versioning": ""},
                body=b"<VersioningConfiguration><Status>Enabled</Status>"
                     b"</VersioningConfiguration>")[0] != 200:
            fail(f"replicate: bucket on {tag}")
        return n

    def snap(tag: str) -> dict:
        stats, mu = dispatch[tag]
        with mu:
            return {v: dict(s) for v, s in stats.items()}

    def delta(tag: str, before: dict) -> dict:
        now = snap(tag)
        return {v: {x: now[v][x] - before[v][x] for x in now[v]}
                for v in now}

    def put(port, key, i, lat=None) -> str:
        body = payloads[i % REPL_PAYLOADS]
        path = f"/{bucket}/{key}"
        hdrs = {"host": f"127.0.0.1:{port}"}
        signed = sig.sign_v4("PUT", urllib.parse.quote(path), {}, hdrs,
                             hashes[i % REPL_PAYLOADS], creds, region)
        t0 = time.perf_counter()
        st, h, _ = S3Client(port, creds, timeout=600).send(
            "PUT", path, body=body, signed=signed)
        if lat is not None:
            lat.append(time.perf_counter() - t0)
        if st != 200 or h.get("etag") != \
                f'"{hashlib.md5(body).hexdigest()}"':
            fail(f"replicate: PUT {path}: HTTP {st} {h.get('etag')}")
        return h.get("x-amz-version-id", "")

    def put_round(port, prefix: str, n_: int = REPL_STREAMS) -> tuple:
        lat: list = []
        with concurrent.futures.ThreadPoolExecutor(REPL_STREAMS) as ex:
            vids = list(ex.map(lambda i: put(port, f"{prefix}{i}", i, lat),
                               range(n_)))
        return lat, {f"{prefix}{i}": (vids[i], i % REPL_PAYLOADS)
                     for i in range(n_)}

    def versions(n, prefix: str = "") -> list:
        if n.metacache is not None:
            n.metacache.drain()
        out, marker, vmarker = [], "", ""
        while True:
            page, _p, marker, vmarker, trunc = \
                n.object_layer.list_object_versions(bucket, prefix, marker,
                                                    1000, vmarker)
            out += [(v.name, v.version_id, v.mod_time, v.etag,
                     v.delete_marker) for v in page]
            if not trunc:
                return out

    def read_back(n, items: dict, what: str) -> dict:
        """GET every (key -> (version id, payload)) from node n over HTTP:
        bytes and ETag the PUT's."""
        port = n.s3.port

        def one(item) -> list:
            key, (vid, p) = item
            st, h, body = S3Client(port, creds, timeout=600).send(
                "GET", f"/{bucket}/{key}", query={"versionId": vid})
            etag = h.get("etag", "").strip('"')
            if st == 200 and body == payloads[p] and \
                    etag == hashlib.md5(payloads[p]).hexdigest():
                return []
            return [{"object": key, "status": st, "bytes": len(body),
                     "etag": etag}]

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            bad = [x for r in ex.map(one, items.items()) for x in r]
        out = {"versions": len(items), "lost": len(bad),
               "seconds": round(time.perf_counter() - t0, 3),
               "first_lost": bad[:3]}
        if bad:
            fail(f"replicate: {what}: {len(bad)} of {len(items)} versions "
                 f"did not read back, e.g. {bad[:3]}")
        return out

    def drain(*tags, timeout: float = 120.0) -> None:
        for _ in range(3):      # a replica apply re-fires the peer's feed
            for tag in tags:
                plane = nodes[tag].replication
                if not plane.drain(timeout):
                    fail(f"replicate: {tag}'s plane did not drain: "
                         f"{plane.stats()}")

    def admin(tag: str):
        n = nodes[tag]
        return madmin.AdminClient("127.0.0.1", n.s3.port, creds.access_key,
                                  creds.secret_key, timeout=600)

    def resync(tag: str, arn: str) -> dict:
        mc = admin(tag)
        mc.start_replicate_resync(arn)
        return mc

    def resync_done(mc, what: str, timeout: float = 300.0) -> dict:
        deadline = time.monotonic() + timeout
        while True:
            st = mc.replicate_resync_status()
            if not st.get("running") and st.get("status") != "pending":
                break
            if time.monotonic() > deadline:
                fail(f"replicate: {what} resync still running: {st}")
            time.sleep(0.05)
        if st.get("status") != "complete" or st.get("keys_failed"):
            fail(f"replicate: {what} resync: {st}")
        return st

    writes = replica_writes_counter()
    try:
        for tag in ("A", "B"):
            boot(tag)
        A, B = nodes["A"], nodes["B"]
        site = {t: nodes[t].repl_targets.site_id for t in ("A", "B")}
        note("booted A and B")
        counts.zero()
        before = {t: snap(t) for t in ("A", "B")}
        t_traffic = time.perf_counter()
        # -- preload, warm and baseline rounds: no target yet ------------
        _lat, cold = put_round(A.s3.port, "cold-", REPL_PRELOAD)
        _lat, warm = put_round(A.s3.port, "warm-")
        base, base_keys = [], {}
        for r in range(REPL_BASE_ROUNDS):
            lat, got = put_round(A.s3.port, f"base{r}-")
            base += lat
            base_keys.update(got)
        note("preload and baseline")
        # -- the pair, the resync, the rounds during it --------------------
        arns = {}
        for src, dst in (("A", "B"), ("B", "A")):
            arns[src] = admin(src).add_replicate_target(
                bucket, "127.0.0.1", nodes[dst].s3.port, bucket,
                creds.access_key, creds.secret_key)
        mc_a = resync("A", arns["A"])
        t_resync = time.perf_counter()
        during, during_keys, progress = [], {}, []
        for r in range(REPL_ON_ROUNDS):
            progress.append(mc_a.replicate_resync_status().get(
                "keys_scanned"))
            lat, got = put_round(A.s3.port, f"on{r}-")
            during += lat
            during_keys.update(got)
        progress.append(mc_a.replicate_resync_status().get("keys_scanned"))
        summary["resync_keys_at_each_round"] = progress
        summary["resync"] = resync_done(mc_a, "A->B")
        summary["resync_s"] = round(time.perf_counter() - t_resync, 3)
        t_drain = time.perf_counter()
        drain("A", "B")
        summary["drain_s"] = round(time.perf_counter() - t_drain, 3)
        note("resync and rounds")
        summary["baseline"] = pct_ms(base)
        summary["during_resync"] = pct_ms(during)
        summary["put_p99_degradation_x"] = round(
            summary["during_resync"]["p99_ms"]
            / max(summary["baseline"]["p99_ms"], 1e-9), 3)
        # -- convergence -----------------------------------------------------
        la, lb = versions(A), versions(B)
        if la != lb:
            fail(f"replicate: A's and B's listings differ: "
                 f"{len(la)} / {len(lb)} versions, first "
                 f"{[x for x in la if x not in lb][:2]} / "
                 f"{[x for x in lb if x not in la][:2]}")
        want = REPL_PRELOAD + REPL_STREAMS * (1 + REPL_BASE_ROUNDS
                                              + REPL_ON_ROUNDS)
        if len(la) != want:
            fail(f"replicate: {len(la)} versions, want {want}")
        summary["converged_versions"] = len(la)
        summary["read_back_b"] = read_back(B, {**cold, **during_keys},
                                           "B's preloaded and resync-time")
        vid = put(B.s3.port, "from-b", 1)
        drain("B", "A")
        summary["read_back_a_of_b"] = read_back(
            A, {"from-b": (vid, 1)}, "the PUT at B, at A")
        w0 = {t: writes.value(site=site[t]) for t in ("A", "B")}
        names = sorted({x[0] for x in versions(A)})
        for tag in ("A", "B"):
            for name in names:
                nodes[tag].replication.on_namespace_change(bucket, name)
        drain("A", "B")
        w1 = {t: writes.value(site=site[t]) for t in ("A", "B")}
        summary["ping_pong"] = {"keys": len(names), "replica_writes":
                                {t: w1[t] - w0[t] for t in w0}}
        if w1 != w0:
            fail(f"replicate: a further sync cycle wrote replicas: "
                 f"{summary['ping_pong']}")
        st, h, _ = S3Client(A.s3.port, creds, timeout=600).send(
            "DELETE", f"/{bucket}/warm-0")
        if st != 204 or h.get("x-amz-delete-marker") != "true":
            fail(f"replicate: the versioned DELETE at A: HTTP {st}")
        drain("A", "B")
        la, lb = versions(A, "warm-0"), versions(B, "warm-0")
        marker = [x for x in lb if x[4]]
        if la != lb or len(marker) != 1 or \
                marker[0][1] != h.get("x-amz-version-id"):
            fail(f"replicate: the marker at B: {lb} against {la}")
        if versions(A) != versions(B):
            fail("replicate: the listings differ after the marker")
        planes = {}
        for tag in ("A", "B"):
            stt = nodes[tag].replication.stats()
            planes[tag] = {"stats": stt,
                           "target_status":
                               nodes[tag].replication.target_status()}
            if (stt["pending"], stt["dropped"],
                    stt["retry"]["pending"]) != (0, 0, 0):
                fail(f"replicate: {tag}'s plane after the drain: {stt}")
        summary["planes"] = planes
        summary["replica_writes"] = {t: writes.value(site=site[t])
                                     for t in ("A", "B")}
        lag = telemetry.REGISTRY.histogram("minio_tpu_repl_lag_seconds")
        summary["lag_seconds"] = {
            dict(key).get("target", ""): {
                "buckets_s": list(lag.buckets), "counts": s_[0],
                "count": s_[2], "mean_s": round(s_[1] / max(s_[2], 1), 4)}
            for key, s_ in lag.series_snapshot().items()
            if dict(key).get("target") in arns.values()}
        summary["pair_dispatches"] = {t: delta(t, before[t])
                                      for t in ("A", "B")}
        summary["pair_s"] = round(time.perf_counter() - t_traffic, 3)
        note("converged")
        # -- the degraded reseed of C -------------------------------------
        # A's first REPL_GONE drives taken away as phase 3 takes them: the
        # set's engine sees them as offline (their files stay), so every
        # cold-* version whose data shards they hold decodes on the card
        C = boot("C")
        before["C"] = snap("C")
        tail_a = snap("A")
        eng_a = A.object_layer.server_sets[0].sets[0]
        gone = list(range(REPL_GONE))
        saved = [eng_a.disks[i] for i in gone]
        decoding = sum(1 for key in cold if any(
            hash_order(f"{bucket}/{key}", k + m)[i] <= k for i in gone))
        arns["C"] = admin("A").add_replicate_target(
            bucket, "127.0.0.1", C.s3.port, bucket, creds.access_key,
            creds.secret_key, prefix="cold-")
        t_reseed = time.perf_counter()
        for i in gone:
            eng_a.disks[i] = None
        try:
            summary["reseed"] = resync_done(resync("A", arns["C"]), "A->C")
            drain("A", "C")
        finally:
            for i, d in zip(gone, saved):
                eng_a.disks[i] = d
        summary["reseed_s"] = round(time.perf_counter() - t_reseed, 3)
        lc, la_cold = versions(C, "cold-"), versions(A, "cold-")
        if lc != la_cold or len(lc) != REPL_PRELOAD:
            fail(f"replicate: C's cold-* listing ({len(lc)}) is not A's "
                 f"({len(la_cold)})")
        summary["read_back_c"] = read_back(C, cold, "C's cold-*")
        reseed_a, reseed_c = delta("A", tail_a), delta("C", before["C"])
        summary["reseed_dispatches"] = {"A": reseed_a, "C": reseed_c,
                                        "versions_decoding": decoding}
        if reseed_a["decode"]["host_routed"] or \
                reseed_a["decode"]["blocks"] < decoding * blocks_each:
            fail(f"replicate: A's degraded reads: {reseed_a['decode']}, "
                 f"want {decoding * blocks_each} blocks decoded on the "
                 "card")
        if reseed_c["encode"]["blocks"] - \
                reseed_c["encode"]["host_routed_blocks"] < \
                REPL_PRELOAD * blocks_each:
            fail(f"replicate: C's replica writes: {reseed_c['encode']}, "
                 f"want {REPL_PRELOAD * blocks_each} blocks on the card")
        note("reseed")
        # -- A's drives back: what was written while they were gone (the
        # resync's checkpoints) heals through A's MRF queue ----------------
        t_heal = time.perf_counter()
        if not A.object_layer.drain_mrf(timeout=120):
            fail(f"replicate: A's MRF queue did not drain: "
                 f"{A.object_layer.mrf_stats()}")
        summary["heal"] = {"mrf": A.object_layer.mrf_stats(),
                           "seconds": round(time.perf_counter() - t_heal,
                                            3)}
        launched = counts.read()
        summary["traffic_s"] = round(time.perf_counter() - t_traffic, 3)
        note("A's drives back")
        summary["launches"] = launched
        summary["dispatches"] = {t: delta(t, before[t])
                                 for t in ("A", "B", "C")}
        gated = {t: sum(d["gated_host_routed"] for d in v.values())
                 for t, v in summary["dispatches"].items()}
        if any(gated.values()):
            fail(f"replicate: dispatches at or past the codec's gate went "
                 f"to the host: {gated}")
        if min(launched["gf_matmul"], launched["hh256"]) <= 0:
            fail(f"replicate: launched {launched}")
    finally:
        for n in nodes.values():
            n.shutdown()
        for v, old in saved_env.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old
        shutil.rmtree(root, ignore_errors=True)
    summary["seconds"] = round(time.perf_counter() - t_phase, 3)
    summary["card"] = card
    emit(summary)
    return summary


def card_memory_by_pid(pids: list) -> dict:
    """pid -> card memory in use (MiB) from nvidia-smi's compute apps; a
    pid it does not list (another PID namespace) maps to None."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    got = {}
    for line in out.stdout.splitlines():
        try:
            pid, mib = (int(x) for x in line.split(","))
        except ValueError:
            continue
        got[pid] = mib
    return {str(p): got.get(p) for p in pids}


def run_sse_timings(torch, dev, rand_u8, max_err, pipeline, chacha20_cuda,
                    chacha20_plain, chacha20_ref, rs_cuda, rs_matrix, hh,
                    kernels, sass, key, np) -> dict:
    """chacha20 at its two launch shapes — the encode launch (8 rows of a
    1 MiB span in 1,048,584-byte rows) and GET's 64 x 65,536 — read three
    ways (CUDA events around back-to-back wrapper calls, the kernel's own
    device time from the profiler, the wrapper's host µs per call), beside
    its byte and operation bounds and its two-pipe floor, its plain
    version and the host chacha20_ref.xor_stream over the same bytes, and
    its SASS summary; sse_put_step against put_step at config 2's shape
    (B = 32, 12+4, S = 87,382), in turns; and
    sse_put_step there and sse_get_step at a degraded-GET group (B = 8,
    3 data shards lost) beside the sum of their kernels' bounds, their
    plain composition (the kernels' plain versions, on the card, checked
    against the step) and the host cipher over the same packages."""
    rng = np.random.default_rng(SEED + 6)
    block = sass.keystream_block(kernels.library("chacha20"))
    if block["divide64"]:
        fail(f"chacha20's SASS still calls a subroutine: {block['calls']}")
    out = {"chacha20_ops_per_block": CHACHA20_OPS_PER_BLOCK,
           "chacha20_alu_ops_per_block": CHACHA20_ALU_OPS_PER_BLOCK,
           "chacha20_sass": block}
    shapes = {"encode": (8, 1048584, 1 << 20), "get": (64, 65536, 65536)}
    for name, (n, stride, span) in shapes.items():
        pkg = 65536
        p = span // pkg
        # eight input sets (8 x 8.4 MB or 8 x 4.2 MB) cycled, so repeated
        # launches find little of their rows in the 50 MB L2 cache
        sets = [rand_u8(n, stride) for _ in range(8 if n == 8 else 16)]
        kw = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint32)
        nw = rng.integers(0, 1 << 32, (n, p, 3), dtype=np.uint32)
        keys, nonces = chacha20_cuda.words(kw, dev), \
            chacha20_cuda.words(nw, dev)

        def call(i):
            x = sets[i % len(sets)]
            chacha20_cuda.keystream_xor(x, keys, nonces, pkg, span, out=x)

        ms = cuda_timed(torch, call, 50)
        device = kernel_device_ms(torch, call, 50, "chacha20_kernel")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(50):
            call(i)
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        x = sets[0]
        t0 = time.perf_counter()
        plain = chacha20_plain.keystream_xor(x, keys, nonces, pkg, span)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_err(chacha20_cuda.keystream_xor(x, keys, nonces, pkg,
                                                  span), plain)
        if err:
            fail(f"chacha20 disagrees at the {name} timing shape")
        host = x.cpu().numpy()
        t0 = time.perf_counter()
        for r in range(n):
            for j in range(p):
                chacha20_ref.xor_stream(
                    host[r, j * pkg:(j + 1) * pkg],
                    kw[r].astype("<u4").tobytes(),
                    nw[r, j].astype("<u4").tobytes())
        host_ms = (time.perf_counter() - t0) * 1e3
        blocks = n * -(-span // 64)
        nbytes = 2 * n * span
        ops = blocks * CHACHA20_OPS_PER_BLOCK
        t = {"rows": n, "row_bytes": stride, "span": span, "packages": n * p,
             "ms": ms, "device_ms": device["ms"],
             "device_graph_ms": device["graph_ms"],
             "device_launches": device["launches"],
             "device_launches_recorded": device["recorded"],
             "wrapper_host_us": host_us, "bytes": nbytes, "ops": ops,
             "byte_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "op_bound_ms": ops / INT32_OPS_PER_S * 1e3,
             "two_pipe_floor_ms": blocks * CHACHA20_ALU_OPS_PER_BLOCK
             / INT32_OPS_PER_S * 1e3,
             "plain_ms": plain_ms, "host_xor_stream_ms": host_ms,
             "max_abs_err": err, "library_ms": None}
        # the adds issue on the FMA pipe (IMAD.IADD), so the operations'
        # floor is the ALU pipe's share, not all 992 on one pipe
        t["bound_ms"] = max(t["byte_bound_ms"], t["two_pipe_floor_ms"])
        t["bound_by"] = ("bytes" if t["byte_bound_ms"]
                         >= t["two_pipe_floor_ms"] else "operations")
        out[f"chacha20_{name}"] = t
    # sse_put_step against put_step at config 2's shape, in turns
    k, m, s, b = 12, 4, 87382, 32
    datas = [rand_u8(b, k, s) for _ in range(2)]
    keys = chacha20_cuda.words(rng.integers(0, 1 << 32, (b, 8),
                                            dtype=np.uint32), dev)
    nonces = chacha20_cuda.words(rng.integers(0, 1 << 32, (b, 16, 3),
                                              dtype=np.uint32), dev)
    runs = {"put_step": [], "sse_put_step": []}
    for which in ("put_step", "sse_put_step", "sse_put_step", "put_step"):
        if which == "put_step":
            fn = lambda i: pipeline.put_step(datas[i % 2], k, m)  # noqa
        else:
            fn = lambda i: pipeline.sse_put_step(  # noqa: E731
                datas[i % 2], keys, nonces, k, m, 65536)
        runs[which].append(cuda_timed(torch, fn, 20))
    out["config2_steps_ms"] = runs
    out["sse_put_step_ms"] = sum(runs["sse_put_step"]) / 2
    out["put_step_ms_beside_sse"] = sum(runs["put_step"]) / 2
    out.update(time_sse_steps(torch, dev, rand_u8, max_err, pipeline,
                              chacha20_cuda, chacha20_plain, chacha20_ref,
                              rs_cuda, rs_matrix, hh, key, np, datas[0],
                              keys, nonces))
    return out


def time_sse_steps(torch, dev, rand_u8, max_err, pipeline, chacha20_cuda,
                   chacha20_plain, chacha20_ref, rs_cuda, rs_matrix, hh,
                   key, np, x, keys, nonces) -> dict:
    """The fused SSE steps beside the sum of their kernels' bounds (they
    run in sequence), their plain composition on the card, and the host
    chacha20_ref.xor_stream over their packages. x: (32, 12, 87,382)."""
    k, m, s, pkg, span = 12, 4, 87382, 65536, 1 << 20

    def cc_bound(n):
        return max(2 * n * span / HBM_BYTES_PER_S, n * span // 64
                   * CHACHA20_ALU_OPS_PER_BLOCK / INT32_OPS_PER_S) * 1e3

    def gf_bound(bits, nb):
        kk, r = bits.shape[1] // 8, bits.shape[0] // 8
        return max(nb * (kk + r) * s / HBM_BYTES_PER_S,
                   nb * s * int(bits.sum()) / 32 / INT32_OPS_PER_S) * 1e3

    def hh_bound(n):
        return max(n * (s + 32) / HBM_BYTES_PER_S,
                   n * hh256_rounds(s) * HH256_OPS_PER_ROUND
                   / INT32_OPS_PER_S) * 1e3

    def host_ms(n, kc, nc) -> float:
        rows = np.zeros((n, span), np.uint8)
        kw = kc.cpu().numpy().view(np.uint32)
        nw = nc.cpu().numpy().view(np.uint32)
        t0 = time.perf_counter()
        for r in range(n):
            for j in range(span // pkg):
                chacha20_ref.xor_stream(rows[r, j * pkg:(j + 1) * pkg],
                                        kw[r].astype("<u4").tobytes(),
                                        nw[r, j].astype("<u4").tobytes())
        return (time.perf_counter() - t0) * 1e3

    def plain_timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    out = {}
    b = x.shape[0]
    pbits = rs_cuda.matrix_bits(rs_matrix.parity_matrix(k, m), dev)

    def put_plain():
        ct = chacha20_plain.keystream_xor(x.reshape(b, k * s), keys, nonces,
                                          pkg, span).view(b, k, s)
        rows = torch.cat([ct, rs_cuda.gf_matmul_plain(pbits, ct)], 1)
        return rows, hh.hh256_plain(rows.reshape(b * (k + m), s), s,
                                    key).view(b, k + m, 32)

    got = pipeline.sse_put_step(x, keys, nonces, k, m, pkg)
    want, plain_ms = plain_timed(put_plain)
    err = max(max_err(g, w) for g, w in zip(got, want))
    out["sse_put_step"] = {
        "B": b, "ms": cuda_timed(torch, lambda i: pipeline.sse_put_step(
            x, keys, nonces, k, m, pkg), 20),
        "bound_ms": cc_bound(b) + gf_bound(pbits, b) + hh_bound(b * (k + m)),
        "plain_ms": plain_ms, "host_xor_stream_ms": host_ms(b, keys, nonces),
        "max_abs_err": err, "library_ms": None}
    # a degraded-GET group: 8 blocks, data shards 0, 5 and 9 lost
    nb = 8
    mask = ((1 << (k + m)) - 1) & ~(1 << 0 | 1 << 5 | 1 << 9)
    dm, used, missing = rs_matrix.missing_data_matrix(k, m, mask)
    bits = rs_cuda.matrix_bits(dm, dev)
    data_src = tuple((0, used.index(j)) if j in used
                     else (1, missing.index(j)) for j in range(k))
    surv = rand_u8(nb, k, s)
    kg, ng = keys[:nb].contiguous(), nonces[:nb].contiguous()

    def get_plain():
        rec = rs_cuda.gf_matmul_plain(bits, surv)
        dig = hh.hh256_plain(surv.reshape(nb * k, s), s, key).view(nb, k, 32)
        st = torch.stack([surv[:, i] if src == 0 else rec[:, i]
                          for src, i in data_src], 1)
        plain = chacha20_plain.keystream_xor(st.reshape(nb, k * s), kg, ng,
                                             pkg, span).view(nb, k, s)
        return plain, rec, dig

    got = pipeline.sse_get_step(surv, bits, kg, ng, dm.shape[0], k, data_src,
                                pkg, s)
    want, plain_ms = plain_timed(get_plain)
    err = max(err, *(max_err(g, w) for g, w in zip(got, want)))
    out["sse_get_step"] = {
        "B": nb, "r": dm.shape[0], "ms": cuda_timed(
            torch, lambda i: pipeline.sse_get_step(
                surv, bits, kg, ng, dm.shape[0], k, data_src, pkg, s), 20),
        "bound_ms": gf_bound(bits, nb) + hh_bound(nb * k) + cc_bound(nb),
        "plain_ms": plain_ms, "host_xor_stream_ms": host_ms(nb, kg, ng),
        "max_abs_err": err, "library_ms": None}
    if err:
        fail("an SSE step disagrees with its plain composition")
    return out


def run_scan_timings(torch, dev, np, big: bytes) -> dict:
    """scan_eval at TPC-H Q6's launch: phase 11's lineitem under Q6's plan
    (B = 254 pages of 2,048 rows, C = 3 slots of width 16), and at phase
    11's contains-LIKE launch (the same rows under the LIKE over
    l_comment, at the shape the pager gives it: C = 1, W = 64); each
    packed as the former packs it, three copies cycled (the Q6 pages are
    ~47 MB, the L2 cache 50 MB). CUDA events around back-to-back wrapper
    calls ("ms"), the kernel's own time (a CUDA graph's replay and
    torch.profiler), the plain version on the card, the byte bound (the
    page bytes the program needs of this data, scan_cases.must_move_bytes,
    read once and the mask and counts written once, over 3.35 TB/s) and
    the sector floor (the 32-byte sectors that hold those bytes,
    scan_cases.sector_floor_bytes). No PyTorch call computes a predicate
    program, so library_ms is None. The pages, their copies on the card
    and the bounds come from scripts/scan_ab.py's helpers, as its A/B
    launches do."""
    from minio_tpu_torch.scripts import scan_ab
    from minio_tpu_torch.scripts import scan_cases as sc
    rows = sc.rows_of(big, "CSV")
    out = {}
    for what, query, shape in (("q6", sc.Q6_COUNT, (254, 2048, 3, 16)),
                               ("like", sc.LIKE_QUERY, (254, 2048, 1, 64))):
        program, pages = scan_ab.pages_of(rows, query)
        if (pages.n_pages, *pages.shape_key()) != shape:
            fail(f"scan_eval timing: {what}'s pages are "
                 f"{(pages.n_pages, *pages.shape_key())}")
        out[f"scan_eval_{what}"] = time_scan(torch, dev, np, program, pages,
                                             what)
    return out


def time_scan(torch, dev, np, program, pages, what: str) -> dict:
    """One scan_eval launch's times and bounds (run_scan_timings)."""
    from minio_tpu_torch.ops import scan_cuda, scan_plain
    from minio_tpu_torch.scripts import scan_ab
    R, C, W = pages.shape_key()
    B = pages.n_pages
    views = scan_ab.card_copies(pages.arrays, dev, 3)

    def call(i):
        return scan_cuda.scan_eval(program, **views[i % 3])

    ms = cuda_timed(torch, call, 50)
    device = kernel_device_ms(torch, call, 50, "scan_eval_kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(50):
        call(i)
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()

    def plain(i):
        return scan_plain.scan_eval(program.prog, program.cspec,
                                    **views[i % 3])

    plain_ms = cuda_timed(torch, plain, 3)
    mask, counts = call(0)
    pm, pc = plain(0)
    err = max(int((mask.long() - pm.long()).abs().max()),
              int((counts.long() - pc.long()).abs().max())
              if counts.numel() else 0)
    if err:
        fail(f"scan_eval disagrees at the {what} launch (max abs err "
             f"{err})")
    # what the program needs of this data: at Q6 the three slots' ok and
    # null, two slots' numbers, l_shipdate's string bytes (a string
    # compare), rowvalid, the mask and the counts; at the LIKE
    # l_comment's null, length and bytes up to its length
    bound = scan_ab.bounds(program, pages.arrays, mask.cpu().numpy())
    # one operation per instruction of the program per row (compares,
    # pushes, ANDs): far below the bytes' time
    ops = pages.n_rows * program.parts[1]
    t = {"B": B, "R": R, "C": C, "W": W, "rows": pages.n_rows,
         "count": int(counts.sum()) if counts.numel() else None,
         "passed": int(mask.sum()), "ms": ms, "device_ms": device["ms"],
         "device_graph_ms": device["graph_ms"],
         "device_launches": device["launches"],
         "device_launches_recorded": device["recorded"],
         "wrapper_host_us": host_us, **bound, "ops": ops,
         "op_bound_ms": ops / INT32_OPS_PER_S * 1e3,
         "plain_ms": plain_ms, "max_abs_err": err, "library_ms": None}
    t["bound_ms"] = max(t["byte_bound_ms"], t["op_bound_ms"])
    t["bound_by"] = "bytes" if t["byte_bound_ms"] >= t["op_bound_ms"] \
        else "operations"
    return t


def hh256_rounds(length: int) -> int:
    """Packet rounds of one row: full packets, the remainder packet, and
    the ten finalisation rounds."""
    return length // 32 + (1 if length % 32 else 0) + 10


def sm_clocks(torch, launch) -> dict:
    """The SM clock nvidia-smi reports while hh256 runs, and its maximum:
    200 launches are queued first so the card is busy when it is read."""
    for i in range(200):
        launch(i)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.splitlines()[0]
    torch.cuda.synchronize()
    busy, top = (float(v) for v in out.split(","))
    return {"sm_clock_mhz": busy, "sm_clock_max_mhz": top}


def cuda_timed(torch, fn, iters: int) -> float:
    """ms per call of fn(i) over `iters` calls, CUDA events around them,
    after two warm-up calls."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(torch, fn, iters: int, kernel: str) -> dict:
    """The device time of one launch of the kernel whose name holds
    `kernel`, read two ways over `iters` calls of fn(i) (after two warm-up
    calls): the replay of a CUDA graph of the calls between CUDA events
    ("graph_ms", free of the host's cost per call), and torch.profiler's
    kernel durations ("ms", the mean over the launches it recorded). The
    profiler can lose kernel records (CUPTI's activity buffers; it kept
    27-30 of 50 late in this script and none once), so it is asked up to
    three times, with host activity on, until it records every launch;
    "recorded" says how many it kept, and "ms" is None when it kept none.
    The graph reading does not depend on it."""
    from minio_tpu_torch.scripts.ab import graph_timed, profiled
    graph_ms = graph_timed(fn, iters)
    best = {"ms": None, "recorded": 0, "attempts": 0}
    for attempt in range(1, 4):
        ms, n = profiled(fn, kernel, iters)
        if n > best["recorded"]:
            best = {"ms": ms, "recorded": n}
        best["attempts"] = attempt
        if n >= iters:
            break
    return {**best, "launches": iters, "graph_ms": graph_ms}


def sha256_compressions(length: int) -> int:
    """64-byte blocks one row of `length` bytes compresses, padding
    included."""
    return (length + 8) // 64 + 1


def run_config5_timings(torch, dev, rand_u8, max_err, rs_cuda, rs_matrix,
                        sha256_cuda, kernels, sass, sm_clock_mhz, c5,
                        c5_plain) -> dict:
    """sha256 at config 5's encode launch shapes (a full dispatch of 32
    blocks x 20 rows, and a quarter of one) beside its bounds and chain
    floor, its plain version and hashlib on the host over the same rows
    (c5, phase 2's 640 rows; c5_plain their plain digests and ms, from
    phase 2's worker process); gf_matmul at k = 16 for config 5's encode
    and degraded-GET decodes."""
    k, m, s = 16, 4, 65536
    loop = sass.block_loop(kernels.library("sha256"))    # raises if unread
    out = {"sha256_block_loop": loop,
           "sha256_ops_per_compression": SHA256_OPS_PER_COMPRESSION}
    sets = [c5] + [rand_u8(32 * (k + m), s) for _ in range(3)]
    for name, n in (("640", 32 * (k + m)), ("160", 8 * (k + m))):
        comp = sha256_compressions(s)
        nbytes = n * (s + 32)
        ops = n * comp * SHA256_OPS_PER_COMPRESSION
        t = {"rows": n, "length": s,
             "ms": cuda_timed(torch, lambda i: sha256_cuda.sha256_rows(
                 sets[i % 4][:n], s), 20),
             "bytes": nbytes, "ops": ops, "compressions": comp,
             "byte_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "op_bound_ms": ops / INT32_OPS_PER_S * 1e3,
             "chain_floor_ms": comp * loop["chain_cycles"]
             / (sm_clock_mhz * 1e3)}
        t["bound_ms"] = max(t["byte_bound_ms"], t["op_bound_ms"])
        out[f"sha256_{name}"] = t
    base = out["sha256_640"]
    rows = sets[0]
    plain, plain_ms = c5_plain
    host = rows.cpu().numpy()
    t0 = time.perf_counter()
    want = [hashlib.sha256(r.tobytes()).digest() for r in host]
    hashlib_ms = (time.perf_counter() - t0) * 1e3
    got = sha256_cuda.sha256_rows(rows, s).cpu()
    err = max_err(got, plain)
    if err or any(g.tobytes() != w for g, w in zip(got.numpy(), want)):
        fail("sha256 disagrees at the timing shape")
    out.update({"sha256_ms": base["ms"],
                "sha256_byte_bound_ms": base["byte_bound_ms"],
                "sha256_op_bound_ms": base["op_bound_ms"],
                "sha256_bound_ms": base["bound_ms"],
                "sha256_chain_floor_ms": base["chain_floor_ms"],
                "sha256_plain_ms": plain_ms,
                "sha256_plain_on": "host",
                "sha256_hashlib_ms": hashlib_ms,
                "sha256_max_abs_err": err})
    # gf_matmul at k = 16: a full encode dispatch (B=32), and the degraded
    # GET's decodes of a GET group (B=8) with 1 and 4 data shards lost
    full = (1 << (k + m)) - 1
    datas = [rand_u8(32, k, s) for _ in range(4)]
    shapes = {"encode": (rs_matrix.parity_matrix(k, m), 32)}
    for lost in ((3,), (0, 5, 9, 15)):
        shapes[f"decode_r{len(lost)}"] = (rs_matrix.recover_rows(
            k, m, full & ~sum(1 << i for i in lost), set(lost))[0], 8)
    for name, (mat, nb) in shapes.items():
        bits = rs_cuda.matrix_bits(mat, dev)
        r = bits.shape[0] // 8
        nbytes = nb * (k + r) * s
        ops = nb * s * int(bits.sum()) / 32
        t = {"B": nb, "r": r, "k": k, "S": s,
             "ms": cuda_timed(torch, lambda i: rs_cuda.gf_matmul(
                 bits, datas[i % 4][:nb]), 50),
             "bytes": nbytes, "ops": ops,
             "byte_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "op_bound_ms": ops / INT32_OPS_PER_S * 1e3,
             "max_abs_err": max_err(rs_cuda.gf_matmul(bits, datas[0][:nb]),
                                    rs_cuda.gf_matmul_plain(
                                        bits, datas[0][:nb]))}
        if t["max_abs_err"]:
            fail(f"gf_matmul config 5 {name} disagrees at the timing shape")
        t["bound_ms"] = max(t["byte_bound_ms"], t["op_bound_ms"])
        out[f"gf_matmul_config5_{name}"] = t
    return out


def run_timings(torch, dev, rand_u8, max_err, pipeline, rs_cuda, hh,
                rs_matrix, kernels, sass, key, b, k, m, s) -> dict:
    """put_step, each kernel and each plain version at BASELINE.json's
    shape (B blocks at k+m, S bytes per shard), and hh256 alone at the
    main path's own launch shapes, each beside its bounds."""
    # four input sets (4 x 45 MB) cycled so repeated launches do not run
    # out of the 50 MB L2 cache
    datas = [rand_u8(b, k, s) for _ in range(4)]
    m2 = rs_cuda.matrix_bits(rs_matrix.parity_matrix(k, m), dev)
    rows = [torch.cat([d, rs_cuda.gf_matmul_plain(m2, d)], 1).reshape(
        b * (k + m), s) for d in datas]
    shard = 349526                          # 4 MiB blocks at 12+4
    put_rows = [rand_u8(8 * (k + m), shard) for _ in range(4)]

    def timed(fn, iters: int) -> float:
        for i in range(2):
            fn(i)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    loop = sass.packet_loop(kernels.library("hh256"))    # raises if unread
    clocks = sm_clocks(torch, lambda i: hh.hh256(put_rows[i % 4], shard, key))
    # the plain hh256 once, on a CPU copy of the rows (on the card it is
    # one launch per operation, ~3x slower), its digests kept for the
    # check below
    host_rows = rows[0].cpu()
    t0 = time.perf_counter()
    hh_plain = hh.hh256_plain(host_rows, s, key)
    hh_plain_ms = (time.perf_counter() - t0) * 1e3
    out = {
        "put_step_ms": timed(lambda i: pipeline.put_step(datas[i % 4], k, m),
                             20),
        "gf_plain_ms": timed(
            lambda i: rs_cuda.gf_matmul_plain(m2, datas[i % 4]), 5),
        "hh_plain_ms": hh_plain_ms, "hh_plain_on": "host",
        "hh256_hot_loop": loop, **clocks,
        "int32_ops_per_s": INT32_OPS_PER_S,
        "hh256_ops_per_round": HH256_OPS_PER_ROUND,
    }
    # gf_matmul at BASELINE.json's shape and at the main path's own launch
    # shapes: PUT parity and degraded-GET decode with 1 and 3 data shards
    # lost, over batches of 8 blocks of 4 MiB
    survivors = [x[:8 * k].view(8, k, shard) for x in put_rows]
    full = (1 << (k + m)) - 1
    gf_shapes = {
        "baseline": (m2, datas),
        "put": (m2, survivors),
        "decode_r1": (rs_cuda.matrix_bits(rs_matrix.missing_data_matrix(
            k, m, full & ~(1 << 1))[0], dev), survivors),
        "decode_r3": (rs_cuda.matrix_bits(rs_matrix.missing_data_matrix(
            k, m, full & ~(1 << 0 | 1 << 5 | 1 << 9))[0], dev), survivors),
        # heal of one drive: one lost row rebuilt from 12 survivors
        "recover_r1": (rs_cuda.matrix_bits(rs_matrix.recover_rows(
            k, m, full & ~(1 << 1), {1})[0], dev), survivors)}
    for name, (bits, sets) in gf_shapes.items():
        nb, _, width = sets[0].shape
        nbytes = nb * (k + bits.shape[0] // 8) * width
        # bit-sliced GF(2) product: one 32-bit XOR per set matrix bit per
        # 32 byte columns, the lower bound on operations for any design
        ops = nb * width * int(bits.sum()) / 32
        t = {"B": nb, "r": bits.shape[0] // 8, "k": k, "S": width,
             "ms": timed(lambda i: rs_cuda.gf_matmul(bits, sets[i % 4]), 50),
             "bytes": nbytes, "ops": ops,
             "byte_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "op_bound_ms": ops / INT32_OPS_PER_S * 1e3}
        t["bound_ms"] = max(t["byte_bound_ms"], t["op_bound_ms"])
        t["bound_by"] = ("bytes" if t["byte_bound_ms"] >= t["op_bound_ms"]
                         else "operations")
        out[f"gf_matmul_{name}"] = t
    base = out["gf_matmul_baseline"]
    out.update({"gf_matmul_ms": base["ms"],
                "gf_matmul_byte_bound_ms": base["byte_bound_ms"],
                "gf_matmul_op_bound_ms": base["op_bound_ms"],
                "gf_matmul_bound_ms": base["bound_ms"]})
    shapes = {"baseline": (b * (k + m), s, rows),
              "put": (8 * (k + m), shard, put_rows),
              "degraded_get": (8 * k, shard, [x[:8 * k] for x in put_rows]),
              # heal: 8 blocks x (12 survivors + 1 rebuilt row)
              "heal": (8 * (k + 1), shard,
                       [x[:8 * (k + 1)] for x in put_rows])}
    for name, (n, length, sets) in shapes.items():
        nbytes = n * (length + 32)
        ops = n * hh256_rounds(length) * HH256_OPS_PER_ROUND
        out[f"hh256_{name}"] = {
            "rows": n, "length": length,
            "ms": timed(lambda i: hh.hh256(sets[i % 4], length, key), 20),
            "byte_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "op_bound_ms": ops / INT32_OPS_PER_S * 1e3,
            "rounds": hh256_rounds(length),
            "chain_floor_ms": hh256_rounds(length) * loop["chain_cycles"]
            / (clocks["sm_clock_mhz"] * 1e3),
            "bytes": nbytes, "ops": ops}
    base = out["hh256_baseline"]
    out.update({"hh256_ms": base["ms"],
                "hh256_byte_bound_ms": base["byte_bound_ms"],
                "hh256_op_bound_ms": base["op_bound_ms"],
                "hh256_bound_ms": max(base["byte_bound_ms"],
                                      base["op_bound_ms"])})
    out["gf_matmul_max_abs_err"] = max(
        max_err(rs_cuda.gf_matmul(bits, sets[0]),
                rs_cuda.gf_matmul_plain(bits, sets[0]))
        for bits, sets in gf_shapes.values())
    out["hh256_max_abs_err"] = max_err(hh.hh256(rows[0], s, key).cpu(),
                                       hh_plain)
    torch.cuda.synchronize()
    if out["gf_matmul_max_abs_err"] or out["hh256_max_abs_err"]:
        fail("kernel disagrees with its plain version at the timing shape")
    return out


if __name__ == "__main__":
    sys.exit(main())
