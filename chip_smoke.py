#!/usr/bin/env python3
"""Drive the PyTorch port's media paths on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; one card)
    python3 chip_smoke.py --parent ROOT
                                 (also times the GCM kernels, O, H-F8, K,
                                  L and R of the checkout at ROOT against
                                  this tree's, and compares the two
                                  trees' SASS)

Builds the port's CUDA kernels from `libjitsi_tpu_torch/csrc/`, checks
them on known answers and exactly against their plain PyTorch versions
at the main paths' shapes (timing both with CUDA events), then drives
each ported path, with the launch counters set to 0 just before it and
read just after, and shows that it ran on its kernels and on no plain
version:

  srtp_echo     the `SrtpStreamTable` protect/unprotect path with 10,240
                installed streams and a `MediaLoop` echo bridge over UDP
                loopback at pipeline depths 1, 2 and 3, each depth's
                wire equal to depth 1's, with echo tick and journey
                p50/p99 and the PhaseProfiler's phase shares (kernels C,
                D);
  conference    a 256-participant PCMU `ConferenceBridge` over UDP
                loopback, 30 ticks at 20 ms steps (kernels C, D, E, F,
                G), held byte for byte against the same run of the
                bridge on the CPU; then (outside the counts) a card
                bridge snapshots after tick 24 and a bridge restored on
                the card takes tick 24's wire again (rejected as a
                replay) and runs ticks 25-29, byte-equal to the
                uninterrupted CPU run;
  mixer_bridge  `MixerBridge(64, 64, 960)` for 200 ticks (kernel E);
  sfu           an `SfuBridge` of 100 conferences x 11 endpoints (1,100
                senders, 11,000 per-leg copies a 20 ms tick) over UDP
                loopback, 30 ticks with RRs, NACKs and SRTCP feedback
                (kernels D, H, I, J); its first ticks and its NACK tick
                are held byte for byte against the same bridge on the
                CPU, every copy the client received is authenticated
                under its leg's key, and none echoes or crosses a
                conference; then a `pipelined=True` bridge through 10
                ticks, every copy delivered once;
  srtp_profiles the rest of the SRTP table at 10,240 installed streams:
                `F8_128_HMAC_SHA1_80` and `NULL_HMAC_SHA1_80` tx/rx
                tables through 4,096-packet production-mix batches, a
                tampered and a replayed row, and an SRTCP round trip of
                1,100 rows (kernels K and L, the F8 instances of I and J,
                the NULL instances of C, D, I and J); an
                `AES_CM_128_HMAC_SHA1_80` table whose 1,024 kdr = 2**4
                streams cross a key epoch mid-batch (epoch waves); and a
                depth-2 pipeline of the dispatch-only seams, with a key
                install while a protect is pending.  The card's wire is
                held byte for byte against CPU tables restored from the
                card tables' snapshots, and the pipeline against the
                sync calls;
  sfu_profiles  the sfu path's bridge under NULL_HMAC_SHA1_80 and
                F8_128_HMAC_SHA1_80, 10 ticks each (D's and H's NULL and
                F8 instances), every copy authenticated by its leg's
                table and read back as its sender's bytes;
  srtp_gcm      AEAD_AES_128_GCM tx/rx tables of 10,240 streams (and a
                twin pair, the sync reference): 4 production-mix batches
                of 4,096, a tampered and a replayed row rejected, 1,100
                SRTCP rows, a depth-2 async pipeline equal to the sync
                calls, then the keystream cache (window 64, 256 bytes, a
                pool of 1,024): 4 audio batches all hits with `fill()`
                between, byte-equal to the stock path, and a batch with a
                950-byte payload that misses and falls back (kernels M,
                N, their cached instances, O);
  sfu_gcm       the sfu path's bridge under AEAD_AES_128_GCM, 10 ticks
                with RRs, NACKs and `emit_feedback` (N for the uplink
                and the RRs, H's GCM instance, M for the feedback), every
                copy opened by its leg's table as its sender's bytes;
  conference_mixed
                the mixed-rate conference: 256 participants, leg 0 on
                G.722 (joins first: a 16 kHz clock, 320-sample frames;
                its codec runs on the host), legs 1-191 PCMU and the
                rest PCMA at 8 kHz, 12 ticks (kernels C, D, E, F, G and
                R: 4 launches of R a tick, 2 deposit groups and 2 egress
                kinds), byte-equal to its CPU twin, every mix
                authenticated, leg 0 hearing leg 10's tone and leg 10
                leg 0's 1,800 Hz over 20x what each tone's own leg hears
                of it; then (outside the counts) a bridge snapshotted at
                tick 6 and restored on the card keeps the 16 kHz clock,
                names leg 0 degraded, and every later mix authenticates;
  conference_pipelined
                the conference path's bridge pipelined: 30 ticks at
                `pipeline_depth=2` and 10 at depth 3, with kernel
                arrival stamps (kernels C, D, E, F, G; the unprotect
                dispatched on the table's async seams, the mixes' protect
                on `send_media_async`, each tick's mixes leaving at the
                next tick's top and the last at the final `flush_sends`),
                every tick's wire byte-equal to the same pipelined bridge
                on the CPU and every mix authenticated; tick p50/p99
                beside the serial conference's;
  sfu_rings     the sfu path's bridge with `ingest_rings=2` and kernel
                stamps, 10 ticks from 16 client sockets with RRs, NACKs
                and `emit_feedback`, then 3 under torch.profiler
                (kernels D, H, I, J): both SO_REUSEPORT
                rings drain, their sum is what was sent, every copy
                authenticates at its leg's socket and none echoes or
                crosses a conference, every BWE arrival is a kernel stamp
                inside its tick's host window, and a snapshot restores
                with two rings;
  echo_batcher  the srtp_echo loop at depth 1 under an `AdaptiveBatcher`
                (kernels C, D): a 2,048-packet burst on a 512-packet cap,
                then calm ticks; the backlog signal fires and the cap and
                window come back to their base; the knob trajectory and
                tick p50/p99 printed;
  media_stream  the public stream API as the README's Quick start drives
                it: `init()` and `media_service()` on the card (1,024
                registry rows) and a second 1,024-row registry for the
                far ends; 512 SDES-keyed `AudioMediaStream` pairs under
                AES_CM_128_HMAC_SHA1_80 with a transport-cc and an
                abs-send-time engine, 4 ticks of one 160-byte PCMU frame
                a pair (one `send` and one `receive` a pair a tick:
                kernels C and D), 16 pairs sending a tone from tick 1 to
                tick 2 (its end packets to tick 4), 32 pairs losing tick
                2's packet, SR and RR exchanged at ticks 2 and 4 (RTT,
                loss, the BWE's estimate); one registry-wide ingest of every pair's next
                packet in one unprotect through a chain on the far
                registry's tables, a tampered and a replayed row beside
                them; a tampered and a replayed datagram through one
                stream's `receive`, refused and not counted; 8 pairs
                under AEAD_AES_128_GCM (kernels M, N) and 8 under
                AES_CM_128_HMAC_SHA1_32.  Every payload comes back as
                sent, and each pair's wire, stats, reports, BWE
                estimates, DTMF events, level and ingest row equal the
                same run with `device="cpu"` (in one process a core:
                the plain versions cost tens of ms a call); per-call
                send and receive p50/p99 on the host clock, the one-call
                ingest's ms and the card's busy ms on two profiled ticks
                are printed;
  srtp_echo_uring
                the echo cell's tables (10,240 streams, AES-CM) behind
                a `MediaLoop` on `UdpEngine(engine_mode="io_uring")`:
                10 ticks of one production-mix packet from each of 4,096
                streams, sent in 512-packet bursts (kernels C, D); every
                tick's replies byte-equal to the same traffic echoed
                through the recvmmsg engine (the reference, run and
                authenticated before the counts are reset), the ring's
                `syscall_enters` and `ring_reaps` beside recvmmsg's.  If
                the probe passes, the engine must take the ring and reap
                ring-side; where the host refuses `io_uring_setup`, the
                line "io_uring unavailable on this host: <errno>" comes
                first, the explicit request must fall back to recvmmsg
                with the `io_uring_unavailable_fallback` warning, and the
                echo runs on that engine;
  srtp_echo_tcp the same traffic from 64 RFC 4571 TCP clients (64
                streams' packets each) to a `MediaLoop` on
                `TcpMediaEngine` (kernels C, D), every tick's replies
                byte-equal to the UDP echo's, no send failure;
  conference_pumps
                libjitsi's own conference graph on the public API:
                `init()` and `media_service()` on the card, 256
                SDES-keyed PCMU stream pairs, each with a `SendPump` on a
                `ToneSource` at 8 kHz and a `ReceivePump` (jitter buffer,
                decode, PLC) into `svc.audio_mixer_device(160)`, 5 ticks
                of 20 ms on an injected clock, tick 1's packets of 16
                pairs lost (kernels C, D, E, F, G); every captured frame
                the exact clip of the other pairs' decoded frames (int64
                on the host), the loss concealed and skipped by the
                jitter buffer, and 16 pairs' wire and decoded frames equal
                to the same seeded graph on the CPU (in a process of its
                own beside the card's run); each pump call's p50/p99.
  sfu_dtls      the sfu cell's 1,100 endpoints (100 conferences x 11)
                joined by `add_endpoint_dtls`, each handshaking over UDP
                loopback from a socket of its own, 100 handshakes in
                flight at once (OpenSSL's DTLS where the `cryptography`
                package is installed, else `StubDtlsEndpoint`, printed
                either way): in 10 conferences two endpoints with the
                bridge as DTLS client, whose peer's Finished flight is
                held back while two media packets race it (held on the
                loop, replayed through D and H when the keys land), and
                one more join refused on its fingerprint and removed;
                then 10 ticks of the sfu cell's traffic under the keys
                the clients exported, from their own sockets, with RRs,
                NACKs and `emit_feedback` (D, H, I, J): every socket gets
                its own leg's copies only, each authenticated under the
                keys its endpoint exported and equal to what its sender
                sent, and a CPU twin keyed with the same keys forwards
                the same bytes for 3 conferences; and a conference of 11
                on a second bridge under AEAD_AES_128_GCM negotiated by
                `use_srtp` (N, H-GCM, M), every copy opened by its leg's
                exported keys;
  conference_dtls
                the conference path's 256 PCMU participants joined by
                `add_participant_dtls` over loopback, a `Recorder`
                attached, 25 ticks of its tones (C, D, E, F, G): every
                mix opened under the keys its participant exported equals
                tick by tick the SDES conference path's mix (payload and
                level extension), and the recorder's timeline names
                participant 10 after it becomes the loudest;
  stream_zrtp   512 `AudioMediaStream` pairs on `init()` and
                `media_service()` (1,024 rows) and a far registry, each
                pair started with its completed `ZrtpEndpoint`s: the
                default suite, 32 pairs at AES3 with HS80 and 16 with
                HS32, 16 by DH3k, 16 by Multistream off the DH3k pairs,
                16 whose second session keeps `secret_continuity` over a
                shared `ZidCache` (every pair by DH3k without the
                `cryptography` package); 2 ticks each way, both sides'
                SAS equal, every frame back as sent, C's and D's AES-256
                instances (`srtp_protect_cm nr=14`, `srtp_unprotect_cm
                nr=14`) required, 16 pairs of each suite equal on the
                wire to a CPU twin (in processes of their own beside the
                card's run); each call's p50/p99 at AES-128 and AES-256;
  sfu_video     BASELINE config #4's 720p30 3-layer VP8 simulcast
                (200 kbps 320x180, 700 kbps 640x360, 2.5 Mbps
                1280x720, 30 fps, 1,200-byte payloads, a keyframe four
                times a delta frame every 60th frame and after a PLI)
                published by each endpoint of the sfu cell (100 x 11,
                its audio row kept) through `add_video_track`, on a
                bridge of 32,768 rows: 8 ticks from 16 client sockets,
                the receivers' REMBs in thirds by conference (300 kbps,
                1.2 and 4 Mbps), a third's changed at tick 4 (up 0 -> 2
                and down 1 -> 0), 10 receivers NACKing 2 projected seqs
                at tick 6, `emit_feedback` every tick (kernels C, D, H, I,
                J); the clients' wire and RTCP are made on the card
                outside the counts, tick by tick, their keyframes
                answering the PLIs the bridge sent.  Every copy
                authenticates under its receiver's projection or RTX row
                and decrypts to what the bridge projected; each
                projected stream is gapless; none echoes or crosses a
                conference; a stream changes layer only on a keyframe's
                first packet and ends on the layer its REMB picks; each
                RTX copy decapsulates to the cached original; the
                client receives every datagram sent.  Then two profiled
                ticks split the host's time (`_forward_video`, precache
                inserts, C's call, egress), kernel C is timed at the
                largest projection launch's shape (its parts padded by
                `bucket_by_size`), and one conference of 11 runs 6
                ticks on the card and again with device="cpu",
                byte-equal (`sfu_video_hold`);
  sfu_svc       the same with one VP9 SVC track an endpoint (3 spatial x
                3 temporal layers at the simulcast layers' rates,
                `add_svc_track`) on 10 conferences x 11, and its hold;
  video_stream  config #4 itself: a `VideoMediaStream` pair a layer,
                one second (30 frames a layer) through `send` /
                `receive` (C, D), the receiver's `SimulcastReceiver` and
                a `FrameAssembler` a layer returning every frame as
                sent, a PLI and a FIR through SRTCP answered by
                keyframes, the top layer written with `WebmWriter` and
                read back; libvpx encodes where libvpx loads (else
                synthetic frames), and an H.264 pair (libx264 encode,
                libavcodec decode) where libavcodec does; it prints
                which fed it;
  sfu_lifecycle the operations plane on the sfu cell's width, in a child
                process of this script (`--lifecycle-child`; the wire is
                made here on the card first and handed over in a file),
                so no kernel instance has launched before the
                lifecycle's warm-ups: one `SfuBridge` (2,048 rows) under
                `BridgeSupervisor` + `StreamLifecycleManager` +
                `SloEngine(default_slos(1.0))` (a journey budget above
                this host's tick) + `CapacityModel` +
                `ObservabilityServer`; 1,089 endpoints join through
                `request_join` in install waves of 64 between ticks and a
                conference of 11 through `request_handshake` over
                loopback DTLS (OpenSSL where `cryptography` is there);
                each staged row scoped to its conference; 24 ticks (cut
                from the sfu path's 30) of one Opus-sized packet an
                endpoint, a late joiner's packets numbered from its
                first; a seeded `ChurnModel` offers ~5% joins and leaves
                from tick 2, and at least 40 churn joins are admitted, go
                live and are heard both ways (a copy to them and of them
                authenticated); at tick 5 one sender's next packet goes
                along four times with its tag flipped, and the
                supervisor convicts that sender alone and releases it
                after its backoff; an RR from every endpoint at tick 7,
                `emit_feedback` every 10 ticks; before tick 12 a
                checkpoint, the bridge closed and `recover(...)` on a
                fresh port on the card, whose snapshot equals the
                checkpoint's (ROC and replay windows included; the
                per-row BWE state and addresses on the endpoints' rows,
                which `restore` resets elsewhere); then 10 ticks of a
                GCM bridge of 1,100 endpoints with the keystream cache on
                both tables (O between ticks), under the stock
                `default_slos()`, whose 20 ms journey budget burns fast
                at this tick: a join offered after its ticks is refused
                `fast_burn`.  `assert_datapath_clean()`
                (no first launch inside a tick window) and no OpenSSL
                feed on the tick thread; every copy every receiver got
                authenticates under its leg's key (a card table a (leg,
                sender) pair; the DTLS legs' on the CPU under their
                exported keys) and is what its sender sent; none crosses
                a conference or echoes; both `/metrics` formats pass
                `validate_exposition`, `/healthz` answers 200 and
                `/debug/device` reports the card's bytes in use.  Prints
                tick p50/p99, the health state, rungs and phase
                attribution, admit-to-live, checkpoint and recover
                seconds; then one conference of 11 under the same plane,
                6 ticks recovered before tick 3, on the card and on the
                CPU, every datagram equal (`sfu_lifecycle_hold`);
  conference_supervised
                the conference path's 256 PCMU participants under a
                `BridgeSupervisor`: the deadline below the tick for 8
                ticks, so the ladder walks recv_window, degrade and two
                sheds of 8 by priority (the lower half first, newest sid
                first, never the dominant speaker), then raised, so it
                unwinds LIFO to level 0; a checkpoint before tick 18,
                the bridge closed and `recover(..., ConferenceBridge)`
                on the card, 4 more ticks (C, D, E, F, G); then 6 ticks
                recovered before tick 3 on the card and on the CPU, mix
                for mix equal.

Then `exposition` renders the registry of every bridge and loop the run
built (with the receive banks' metrics registered, and the batcher's),
plain and OpenMetrics, and fails unless `validate_exposition` finds
nothing.

Beside them, `sass` gives each kernel's instruction count, registers,
spills and static shared memory, the INT32-pipe and load counts of the
AES core's round loop (in kernel A and in the chain probe), and kernel E's
launch plans (cluster size, column stages and dynamic shared memory at
its main shapes and at the shapes its staged kernel takes), and fails
unless kernel A, the AES core alone, holds no shared memory and issues
no shared-memory load and no constant load at a register-held address
(the core is gather-free: `libjitsi_tpu_torch/csrc/aes.cuh`), kernel G
holds no shared memory and issues no shared-memory load (no table), and
kernel B, H's F8 instance and K and L at AES-128 spill nothing;
`latency_floor`
gives the cycles one SHA-1
compression and one pair of AES-128 and of AES-256 blocks take on a
lane that waits on each (the floors of the tile kernels' lanes), one
row's whole MAC on such a lane (kernel B's chain floor at its longest
row, 966 bytes) and the time of an empty kernel on the card
(`launch_floor_ms`, the floor of every kernel), and `profiler` how many
empty profiling windows were measured again.  The GCM kernels have
their own checks: `gcm_known_answers` (RFC 7714 §16.1.1 through M and
back through N, a tampered tag refused), `sass`'s `gcm` (no indexed
constant load, local memory only at spill slots, no memory load but
the staged row's inside the GHASH chain) and `latency_floor`'s
`ghash_step_cycles` (one Horner step on a waiting warp, its block read
from shared memory as the tiles read it), from which each GCM line's
`chain_floor_ms` is reckoned: the launch, the longest row's Horner steps
and one AES pair.  `gcm_phases` runs M's and N's tile with clock64
stamps (a probe build, `ljt_srtp_gcm_phases`; the shipped kernels carry
no stamp) at the mix batch's three launches and the SRTCP launch, and
prints each launch's split: set-up, keystream, hash (its working warps'
busy cycles apart from the cycles warps wait at the join), store;
`gcm_plans` times the same tile planned for 1-4 tiles an SM.
`fill_phases` runs kernel O's tiles with clock64 stamps (a probe build,
`ljt_gcm_ks_fill_phases`) at the fill's 65,536 slots: set-up (its loads
and run vote, its round keys), the AES passes, the tiles an SM ran and
at once, a second wave's share; O's `kernel_vs_plain` line also gives
its core floor (`core_floor_ms`: this run's AES pairs at the INT32-pipe
instructions a pair the shipped O's SASS holds, the `sass` line's
`gcm_ks_fill_core`).  `f8_fanout_phases` does the same for H's F8
instance (`ljt_srtp_fanout_f8_phases`) at 275 x 10 and 1,100 x 10:
set-up, IV', the chains, the hash's lag behind them, the store, and the
SM sub-partition (`%warpid` mod 4) of each chain and hashing warp.
`srtp_f8_phases` does the same for K and L (`ljt_srtp_f8_phases`, their
tile with clock64 stamps) at the mix batch's three launches: set-up
(thread 0's rows, its slicing, the rest), IV', the chains, K's hash end
and lag behind them (L's hash ends before its chains), the store, the
sub-partitions, tiles an SM at once and a second wave's share; and
`srtp_f8_plans` times the same tile planned for 1, 2 and 4 tiles an SM
at each launch.  Kernel R has its `resample` entry in the `sass` line
(its templated instances load no coefficient from memory), a library
time at its integer ratios (one cuDNN `conv1d`) and `r_phases` (its
probe build, `ljt_resample_phases`, at every RESAMPLE_SHAPES shape and a
conference_mixed tick's launches: set-up, span staging, taps and store a
walker, walkers at once an SM, a second wave's share).  I-NULL and
J-NULL have `kernel_vs_plain` lines (`profile_kernels`) at their three
launches on the paths (NULL_SHAPES) with their MAC floor and their
share of it and of their bound, `srtcp_null_phases` (their probe,
`ljt_srtcp_null_phases`: the id's round trip, the midstates, the hash
of lane 0 and of the warp, the copy's end, the stores after the hash,
the launch's span, tiles at once an SM, a second wave's share) and
`srtcp_null_plans` (their tiles at 1, 2 and 4 an SM).  With
`--parent ROOT`, the kernels of the checkout at ROOT (built by its own
sources) are timed against this tree's in turns (parent, this, this,
parent): every GCM shape (`gcm_turns`), O at the fill's shape
(`fill_turns`), H-F8 at both SFU shapes (`f8_turns`), K and L at each
launch of the mix batch and summed over it (`srtp_f8_turns`), R at each
of `r_phases`'s launches and over a mixed tick (`r_turns`, the two
trees' outputs equal) and I-NULL and J-NULL at NULL_SHAPES
(`srtcp_null_turns`, the two trees' outputs equal); the parent's phase
splits are printed too where it has the probes, and `sass_compare`
(`scripts/torch_sass_compare.py`) fails the run if a kernel outside
SASS_CHANGED (none in this tree) changed its SASS.

Every phase prints one JSON line; the card's `nvidia-smi` name and power
limit come before the last line, and the last line is
{"ok": true, "device": {...}}.  Any failure exits nonzero before that
line.  Without a CUDA device the script prints no result and exits 2.
It imports neither JAX nor the JAX package.

Times: in the `kernels` line `ms` is a kernel's time on the card (the
profiler's summed kernel duration per call), `call_ms` the time per
back-to-back call through its wrapper by CUDA events (the host's issue
time bounds it for kernels of a few microseconds), `plain_ms` and
`library_ms` the same per-call times of the plain version and of the
library call, and `plain_device_ms` / `library_device_ms` their device
work alone.

Bounds: `bound_ms` is the larger of the bytes the function must move
(each input read once, each output written once) over 3.35 TB/s and the
operations its work needs on this run's data over the INT32 pipe's rate,
16.7 Tops/s (132 SMs x 64 lanes x 1.98 GHz, H100 SXM), or for kernel R
its float32 FMAs (2 operations each) over 67 TFLOP/s, the FP32 rate
outside the tensor cores: R reads 2 bytes a sample in, writes 2 a
sample out and does 16 FMAs an output sample.  Operations are
the fewest sm_90 instructions of the kinds only that pipe runs (LOP3
logic, SHF shifts and rotates, PRMT byte moves); adds are left out
because they can issue as IMAD on the FP32 pipe, and with them counted
at the 128-lane issue rate the total still binds later.  Per unit:

  SHA-1 compression  432 = 80 rounds x 3 (rotl5, f as one LOP3, rotl30)
                         + 64 schedule words x 3 (two LOP3, rotl1)
  AES block          24*nr + 12 = 4 (first key XOR)
                         + (nr-1) rounds x 24 (16 table indices at one
                           instruction each, 8 LOP3 for the XORs)
                         + 32 (last round: 16 S-box indices, 12 PRMT to
                           pack the bytes, 4 key XORs)
  CTR window XOR     4 per 16-byte keystream block
  GHASH block        160 = 16 byte steps of Shoup's 8-bit table
                         method x (4 PRMT for the 128-bit shift by a
                         byte, 4 LOP3 folding in the table entry and
                         the reduction word, 2 for the two indexes)

The AES count is that of a T-table round, the fewest instructions this
card needs for a block, and it stays the bound on purpose: the bound
reads the work of the function, whatever implements it.  The port's
core is gather-free (a Boolean S-box circuit on bit-sliced pairs of
blocks, so no load depends on a key or a state byte) and issues several
times that count a block; the `sass` counts and each kernel's time
against its bound show what that costs.  Shared-memory loads and byte
swaps are not counted.  Kernels E, F and G do a few integer operations per
byte they move, so bytes bound them: E reads pcm and writes the mix
(2 + 2 bytes a sample) and reads the mask and writes the levels (1 + 1
a row); F reads 2 and writes 1 byte a sample, G reads 1 and writes 2.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_FLOPS_PER_S = 67e12
SHA1_BLOCK_OPS = 80 * 3 + 64 * 3
CTR_XOR_OPS = 4


def aes_block_ops(nr: int) -> int:
    return 4 + 24 * (nr - 1) + 32


N_STREAMS = 10_240
BATCH = 4096
MIX = ((100, 0.6), (400, 0.3), (950, 0.1))    # payload bytes, share
TAG = 10
HDR = 12
# packets 10,240 streams at 20 ms ptime send in the loop's 1 ms window
ECHO_BURST = N_STREAMS // 20
# timed rounds a depth (8 bursts each, so 80 full-burst ticks: p99 is
# not the maximum), none fenced; then one round whose every tick pays the
# PhaseProfiler's fences, out of the timed statistics
ECHO_ROUNDS = 10
CONF_PARTIES = 256         # PCMU participants of the conference bridge
CONF_TICKS = 30
CONF_PROFILED = 5          # further ticks under torch.profiler
CONF_SWITCH = 5            # tick from which participant 10 is loudest
# the conference restore check: the card bridge snapshots after this many
# ticks, and a bridge restored on the card runs the rest
CONF_RESUME = 25
MIXER_BRIDGE = (64, 64, 960)
# kernel E's timed shapes: AudioMixer, the conference bridge, MixerBridge
MIX_SHAPES = ((1, 256, 960), (1, CONF_PARTIES, 160), MIXER_BRIDGE)
# shapes E's first kernel did not take (its staged kernel runs them): a
# conference past 65,535 rows, a frame wider than a cluster of 16 blocks
# can stage one row of, and every column total past 2**31 - 1
MIX_STAGED = ((1, 65540, 8), (1, 3, 160008), (1, 131076, 1))
MIXER_TICKS = 200
# the SFU path: BASELINE config #5 (1k senders x 10k receiver legs)
SFU_CONFS, SFU_SIZE = 100, 11
SFU_N = SFU_CONFS * SFU_SIZE
SFU_TICKS = 30
SFU_PROFILED = 5
SFU_BURSTS = 4              # sends a 20 ms tick of media in 4 bursts
SFU_RR_TICKS = (7, 22)      # one RR a sender every 15 ticks
SFU_NACK_TICK = 20          # 10 receivers NACK 3 seqs each
SFU_FEEDBACK = 10           # emit_feedback every 10 ticks
SFU_CPU_TICKS = (0, 1, 2, 17, 18, 19, SFU_NACK_TICK)
SFU_PIPE_TICKS = 10         # the pipelined SfuBridge's run (sfu path)
# the sfu_profiles path: the SFU under NULL_HMAC_SHA1_80 and
# F8_128_HMAC_SHA1_80, at config #5's width
SFU_PROFILES = ("NULL_HMAC_SHA1_80", "F8_128_HMAC_SHA1_80")
SFU_PROFILE_TICKS = 10
# the echo loop's pipeline depths
ECHO_DEPTHS = (1, 2, 3)
# the srtp_profiles path: batches a profile, kdr streams and their rate,
# SRTCP rows, and the async pipeline's batches
PROFILE_BATCHES = 4
KDR_STREAMS, KDR = 1024, 2 ** 4
PROFILE_RTCP = SFU_N
ASYNC_BATCHES = 4
# the AEAD-GCM paths: srtp_gcm's keystream cache run (GCM_CACHE_BATCHES
# audio batches on GCM_CACHE, then one that misses) and O's timed fill;
# sfu_gcm's ticks, its RR and NACK ticks and its feedback period
GCM = "AEAD_AES_128_GCM"
GCM_CACHE = dict(window=64, ks_bytes=256, pool=1024)
GCM_CACHE_BATCHES = 4
GCM_FILL_SLOTS = 1024 * 64
GCM_BENCH = (128, 512)      # H-GCM at the fan-out bench's packets x legs
GCM_TICKS, GCM_RR_TICK, GCM_NACK_TICK, GCM_FEEDBACK = 10, 4, 7, 5
# GHASH in the bound: Shoup's 8-bit table method (a 4 KiB table a key and
# a shared reduction table), as the AES count takes the T-table form: 16
# byte steps a block, each the 128-bit shift by 8 (4 PRMT), the table
# entry and the reduction word folded in (4 LOP3) and the two indexes
# (2); its table loads are not counted, as the AES count leaves out the
# T-table's.  The port's form is table-free (`csrc/ghash.cuh`) and issues
# more; the bound reads the work.
GHASH_BLOCK_OPS = 16 * 10
# the GCM kernels (AES-128 only) and their SASS names
GCM_SASS = ("srtp_gcm_seal nr=10", "srtp_gcm_open nr=10",
            "srtp_gcm_seal_cached", "srtp_gcm_open_cached",
            "srtp_fanout_gcm nr=10", "gcm_ks_fill nr=10")
# kernel R's timed shapes (rows, rate in, rate out): the mixed
# conference's deposit and egress launches, BASELINE's 10,240 streams at
# the Opus clock both ways, 44.1k -> 48k (L = 160, M = 147) and a
# conference past 65,535 rows
RESAMPLE_SHAPES = ((CONF_PARTIES - 1, 8000, 16000),
                   (CONF_PARTIES - 1, 16000, 8000), (10_240, 8000, 48000),
                   (10_240, 48000, 8000), (256, 44100, 48000),
                   (65_540, 8000, 16000))
# the conference_mixed path: leg 0 (G.722, 16 kHz) joins first and sets
# the clock, legs 1-191 PCMU, the rest PCMA (8 kHz); counted ticks, ticks
# under the profiler, leg 0's tone, the tick of its snapshot, and R's
# launches a tick (2 deposit groups, 2 egress kinds)
MIXED_TICKS = 12
MIXED_PROFILED = 3
MIXED_PCMU = 192
MIXED_TONE = 1800.0
MIXED_SNAPSHOT = 6
MIXED_R_PER_TICK = 4
# the launches of R a conference_mixed tick makes (rows, rate in, rate
# out): a deposit group and an egress kind for its PCMU and its PCMA legs
MIXED_R_LAUNCHES = tuple((n, ri, ro) for ri, ro in ((8000, 16000),
                                                    (16000, 8000))
                         for n in (MIXED_PCMU - 1, CONF_PARTIES - MIXED_PCMU))
# kernel R's phase probe (`ljt_resample_phases`): clock64 words a walker
# (a block of PR 16's form, a warp of this one) and the walkers its
# stamps have room for
CONF_PIPE = ((2, CONF_TICKS), (3, 10))   # (pipeline_depth, ticks)
SFU_RINGS, SFU_RINGS_TICKS, SFU_RINGS_PROFILED = 2, 10, 3
SFU_RINGS_SOCKETS = 16      # client sockets: flows the kernel hashes
SFU_RINGS_RR, SFU_RINGS_NACK, SFU_RINGS_FEEDBACK = 3, 6, 5
BATCHER_BURST = 4 * ECHO_BURST   # one burst on the 512-packet cap
BATCHER_CALM = 32                # packets a calm tick
BATCHER_CALM_TICKS = 24
BATCHER_WINDOW_MS = 2
TICK_BUDGET_S = 0.04        # `_TickBudget`: slow_burn past it, fast_burn
                            # past 2.5x it (a 512-packet echo tick: ~20 ms)
# the public stream API (`init()` -> `media_service()` -> SDES-keyed
# AudioMediaStream pairs) at the JAX default registry width
MS_WIDTH = 1024             # libjitsi_tpu.stream_capacity's default
MS_PAIRS = 512
MS_TICKS = 4
MS_DTMF = (16, 1, 2)        # pairs sending a tone, its first and last tick
MS_RTCP_TICKS = (2, 4)
MS_LOST = (2, 32)           # at tick 2 the first 32 pairs' packets are lost
MS_PROFILED = (3, 4)        # ticks under torch.profiler
MS_OTHER = (("AEAD_AES_128_GCM", 8), ("AES_CM_128_HMAC_SHA1_32", 8))
MS_T0 = 2000.0              # the ticks' explicit clock, seconds
ENGINE_TICKS = 10           # srtp_echo_uring / _tcp: BATCH-packet ticks
TCP_PEERS = 64              # srtp_echo_tcp's clients, BATCH / 64 streams each
PUMP_PAIRS = 256            # conference_pumps: PCMU pairs through pumps
PUMP_TICKS = 5
PUMP_LOST = (1, 16)         # at tick 1 the first 16 pairs' packets are lost
PUMP_TWIN = tuple(range(8, 24))   # pairs held against a CPU run (8 lost)
PUMP_T0 = 3000.0            # the pumps' explicit clock, seconds
R_PHASE_SLOTS = 12
R_PHASE_WALKERS = 1 << 16
# DTLS-SRTP and ZRTP keying: sfu_dtls, conference_dtls, stream_zrtp
LOOPBACK_U32 = 0x7F000001
DTLS_WAVE = 100             # handshakes in flight at once in a join storm
DTLS_EARLY_CONFS = tuple(range(5, SFU_CONFS, 10))  # two early endpoints each
SFU_DTLS_TICKS = 10
SFU_DTLS_RR, SFU_DTLS_NACK, SFU_DTLS_FEEDBACK = 4, 7, 5
SFU_DTLS_TWIN_CONFS = 3     # conferences the CPU twin bridge holds
SFU_DTLS_GCM_TICKS = 5      # the GCM conference's ticks
CONF_DTLS_TICKS = 25         # participant 10 is named dominant ~15 ticks after CONF_SWITCH
ZRTP_TICKS = 2
ZRTP_SUITES = (("aes3_hs80", 32), ("aes3_hs32", 16), ("dh3k", 16),
               ("multistream", 16), ("continuity", 16))   # the rest default
ZRTP_TWIN = 16              # pairs of each suite held against a CPU run
ZRTP_INSTANCES = ("srtp_protect_cm nr=14", "srtp_unprotect_cm nr=14")
# the video plane: BASELINE config #4's 720p30 3-layer simulcast published
# by every endpoint of the sfu path's cut of config #5 (100 x 11)
VIDEO_CONFS = SFU_CONFS
VIDEO_CAPACITY = 32_768      # registry and table rows
VIDEO_LAYERS = ((320, 180, 200_000), (640, 360, 700_000),
                (1280, 720, 2_500_000))      # width, height, bits/s
VIDEO_FPS = 30
VIDEO_KEY_EVERY = 60         # every 60th frame of a layer is a keyframe
VIDEO_KEY_SCALE = 4          # ... four times a delta frame's size
VIDEO_PAYLOAD = 1200         # VP8/VP9 payload bytes a packet at most
VIDEO_DESC = 4               # the VP8 descriptor: X, I, 15-bit picture id
VIDEO_TAG = 8                # the origin tag closing every payload
VIDEO_REMB = (300_000, 1_200_000, 4_000_000)   # conference c's: c % 3
VIDEO_TICKS = 8
VIDEO_SWITCH_TICK = 4        # a third of the receivers changes its REMB
VIDEO_NACK_TICK = 6
VIDEO_NACKERS = 10           # receivers NACKing 2 projected seqs each
VIDEO_NACKED = 2             # (20 x 1,236 bytes: inside the RTX burst)
VIDEO_PROFILED = 1
VIDEO_SOCKETS = 16           # client sockets; endpoint k on k % 16
VIDEO_HOLD_CAPACITY = 512    # the one-conference hold's bridges
VIDEO_HOLD_TICKS = 6         # its REMBs at 0, switch at 2, NACKs at 4
RTX_SSRC_XOR = 0x00525458    # the bridge's RTX SSRC: out SSRC ^ "RTX"
# the sfu_svc path: one VP9 SVC track of 3 spatial x 3 temporal layers
# an endpoint, at the simulcast layers' rates, on 10 conferences x 11
SVC_CONFS = 10
SVC_TICKS = VIDEO_TICKS
SVC_LAYER_BPS = (200_000, 900_000, 3_400_000)  # cumulative per spatial
SVC_TIDS = (0, 2, 1, 2)      # the temporal layers' picture pattern
VS_FRAMES = 30               # video_stream: one second at 30 fps
VS_PROFILED = 6              # its last frame times, under the profiler
# the operations plane: sfu_lifecycle (run in a child process, so no
# kernel instance has launched before the lifecycle's warm-ups) and
# conference_supervised.  Ticks are cut to keep the two near 60 s on the
# card; the widths are the sfu and conference cells'.
LC_DTLS_CONF = SFU_CONFS - 1   # its 11 endpoints join by DTLS
LC_SDES = LC_DTLS_CONF * SFU_SIZE   # 1,089 SDES endpoints
LC_POOL = 64                   # endpoints the churn may add
LC_CAPACITY = 2048             # bridge rows: 1,100 + churn headroom
LC_WAVE = 64                   # install_batch: joins staged a window
LC_TICKS = 24                  # the CM run; cut from the sfu path's 30
LC_CKPT_TICK = 12              # checkpoint, close, recover before it
LC_RR_TICK = 7                 # an RR from every live SDES endpoint
LC_FEEDBACK = 10               # emit_feedback every 10 ticks
LC_TAMPER = (5, 6)             # the tick a sender's forged copies go along
LC_TAMPERED = 7                # that sender (conference 0)
LC_FORGED = 4                  # forged copies a tick
LC_CHURN_FROM = 2              # the churn starts at this tick
# ChurnModel: ~5% of 1,100 joins and leaves over the run's 0.48 s
LC_CHURN = dict(join_rate_hz=110.0, mean_hold_s=10.0, seed=31)
LC_DEADLINE_MS = 5000.0        # the ladder stays down
# the CM run's journey objective: a deployment's budget above this host's
# supervised SFU tick (p50 274-288 ms, p99 515-605 ms on the card), on a
# `packet_journey_seconds` bucket bound, so the churn's joins are judged
# by the plane and not refused for the host's tick; the GCM run keeps
# `default_slos()`'s 20 ms, and a join offered after its ticks must be
# refused `fast_burn`
LC_JOURNEY_BUDGET_S = 1.0
LC_CHURN_MIN = 40              # churn joins admitted, live and heard
LC_GCM_TICKS = 10
LC_GCM_CACHE = dict(window=64, ks_bytes=256, pool=LC_CAPACITY)
LC_HOLD_TICKS = 6              # the one-conference hold, recovered at 3
CS_OVERLOAD = 8                # conference_supervised: overrun ticks
CS_TICKS = 22                  # deadline raised at 8, level 0 by 16
CS_CKPT_TICK = 18
CS_SHED_STEP = 8
CS_PRIORITY = 128              # participants below this index: priority 1
CS_HOLD_TICKS = 6
SOURCES = {
    "aes_encrypt": ("libjitsi_tpu_torch/csrc/aes_encrypt.cu",
                    "libjitsi_tpu/kernels/aes_bitsliced.py:548"),
    "hmac_sha1": ("libjitsi_tpu_torch/csrc/hmac_sha1.cu",
                  "libjitsi_tpu/kernels/sha1.py:230"),
    "srtp_protect_cm": ("libjitsi_tpu_torch/csrc/srtp_cm.cu",
                        "libjitsi_tpu/transform/srtp/kernel.py:59"),
    "srtp_unprotect_cm": ("libjitsi_tpu_torch/csrc/srtp_cm.cu",
                          "libjitsi_tpu/transform/srtp/kernel.py:113"),
    "mix_minus": ("libjitsi_tpu_torch/csrc/mix_minus.cu",
                  "libjitsi_tpu/kernels/pallas_ops.py:57"),
    "g711_encode": ("libjitsi_tpu_torch/csrc/g711.cu",
                    "libjitsi_tpu/kernels/g711.py:62"),
    "g711_decode": ("libjitsi_tpu_torch/csrc/g711.cu",
                    "libjitsi_tpu/kernels/g711.py:51"),
    "srtp_fanout_cm": ("libjitsi_tpu_torch/csrc/srtp_fanout.cu",
                       "libjitsi_tpu/sfu/translator.py:65"),
    "srtcp_protect_cm": ("libjitsi_tpu_torch/csrc/srtcp_cm.cu",
                         "libjitsi_tpu/transform/srtp/kernel.py:164"),
    "srtcp_unprotect_cm": ("libjitsi_tpu_torch/csrc/srtcp_cm.cu",
                           "libjitsi_tpu/transform/srtp/kernel.py:193"),
    # AES-F8 (K7: the F8 keystream fused into each kernel) and the NULL
    # cipher's instances
    "srtp_protect_f8": ("libjitsi_tpu_torch/csrc/srtp_f8.cu",
                        "libjitsi_tpu/kernels/aes.py:351"),
    "srtp_unprotect_f8": ("libjitsi_tpu_torch/csrc/srtp_f8.cu",
                          "libjitsi_tpu/kernels/aes.py:351"),
    "srtcp_protect_f8": ("libjitsi_tpu_torch/csrc/srtcp_cm.cu",
                         "libjitsi_tpu/kernels/aes.py:430"),
    "srtcp_unprotect_f8": ("libjitsi_tpu_torch/csrc/srtcp_cm.cu",
                           "libjitsi_tpu/kernels/aes.py:430"),
    "srtp_protect_null": ("libjitsi_tpu_torch/csrc/srtp_cm.cu",
                          "libjitsi_tpu/transform/srtp/kernel.py:59"),
    "srtp_unprotect_null": ("libjitsi_tpu_torch/csrc/srtp_cm.cu",
                            "libjitsi_tpu/transform/srtp/kernel.py:113"),
    "srtcp_protect_null": ("libjitsi_tpu_torch/csrc/srtcp_null.cu",
                           "libjitsi_tpu/transform/srtp/kernel.py:164"),
    "srtcp_unprotect_null": ("libjitsi_tpu_torch/csrc/srtcp_null.cu",
                             "libjitsi_tpu/transform/srtp/kernel.py:193"),
    # kernel H's NULL and AES-F8 instances: the JAX fan-out launch runs
    # NULL with encrypt=False and F8 (its fault) as AES-CM
    "srtp_fanout_null": ("libjitsi_tpu_torch/csrc/srtp_fanout.cu",
                         "libjitsi_tpu/sfu/translator.py:65"),
    "srtp_fanout_f8": ("libjitsi_tpu_torch/csrc/srtp_fanout.cu",
                       "libjitsi_tpu/sfu/translator.py:65"),
    # AEAD-GCM (K9 with K8's GHASH fused in; K10; K11's GCM half)
    "srtp_gcm_seal": ("libjitsi_tpu_torch/csrc/srtp_gcm.cu",
                      "libjitsi_tpu/kernels/gcm.py:156"),
    "srtp_gcm_open": ("libjitsi_tpu_torch/csrc/srtp_gcm.cu",
                      "libjitsi_tpu/kernels/gcm.py:182"),
    "srtp_gcm_seal_cached": ("libjitsi_tpu_torch/csrc/srtp_gcm.cu",
                             "libjitsi_tpu/kernels/gcm.py:318"),
    "srtp_gcm_open_cached": ("libjitsi_tpu_torch/csrc/srtp_gcm.cu",
                             "libjitsi_tpu/kernels/gcm.py:340"),
    "srtp_fanout_gcm": ("libjitsi_tpu_torch/csrc/srtp_fanout.cu",
                        "libjitsi_tpu/sfu/translator.py:73"),
    "gcm_ks_fill": ("libjitsi_tpu_torch/csrc/gcm_fill.cu",
                    "libjitsi_tpu/transform/srtp/keystream.py:58"),
    # the polyphase resampler (K13b)
    "resample": ("libjitsi_tpu_torch/csrc/resample.cu",
                 "libjitsi_tpu/kernels/resample.py:38"),
}
PROFILE_KERNELS = ("srtp_protect_f8", "srtp_unprotect_f8", "srtcp_protect_f8",
                   "srtcp_unprotect_f8", "srtp_protect_null",
                   "srtp_unprotect_null", "srtcp_protect_null",
                   "srtcp_unprotect_null")
# the kernels each path must launch
PATHS = {"srtp_echo": ("srtp_protect_cm", "srtp_unprotect_cm"),
         "conference": ("srtp_protect_cm", "srtp_unprotect_cm", "mix_minus",
                        "g711_encode", "g711_decode"),
         "mixer_bridge": ("mix_minus",),
         "sfu": ("srtp_unprotect_cm", "srtp_fanout_cm", "srtcp_protect_cm",
                 "srtcp_unprotect_cm"),
         "srtp_profiles": PROFILE_KERNELS,
         "sfu_profiles": ("srtp_unprotect_null", "srtp_fanout_null",
                          "srtp_unprotect_f8", "srtp_fanout_f8"),
         "srtp_gcm": ("srtp_gcm_seal", "srtp_gcm_open",
                      "srtp_gcm_seal_cached", "srtp_gcm_open_cached",
                      "gcm_ks_fill"),
         "sfu_gcm": ("srtp_gcm_open", "srtp_fanout_gcm", "srtp_gcm_seal"),
         "conference_mixed": ("srtp_protect_cm", "srtp_unprotect_cm",
                              "mix_minus", "g711_encode", "g711_decode",
                              "resample"),
         "conference_pipelined": ("srtp_protect_cm", "srtp_unprotect_cm",
                                  "mix_minus", "g711_encode",
                                  "g711_decode"),
         "sfu_rings": ("srtp_unprotect_cm", "srtp_fanout_cm",
                       "srtcp_protect_cm", "srtcp_unprotect_cm"),
         "echo_batcher": ("srtp_protect_cm", "srtp_unprotect_cm"),
         "media_stream": ("srtp_protect_cm", "srtp_unprotect_cm",
                          "srtp_gcm_seal", "srtp_gcm_open"),
         "srtp_echo_uring": ("srtp_protect_cm", "srtp_unprotect_cm"),
         "srtp_echo_tcp": ("srtp_protect_cm", "srtp_unprotect_cm"),
         "conference_pumps": ("srtp_protect_cm", "srtp_unprotect_cm",
                              "mix_minus", "g711_encode", "g711_decode"),
         "sfu_dtls": ("srtp_unprotect_cm", "srtp_fanout_cm",
                      "srtcp_protect_cm", "srtcp_unprotect_cm",
                      "srtp_gcm_open", "srtp_fanout_gcm", "srtp_gcm_seal"),
         "conference_dtls": ("srtp_protect_cm", "srtp_unprotect_cm",
                             "mix_minus", "g711_encode", "g711_decode"),
         "stream_zrtp": ("srtp_protect_cm", "srtp_unprotect_cm"),
         "sfu_video": ("srtp_protect_cm", "srtp_unprotect_cm",
                       "srtp_fanout_cm", "srtcp_protect_cm",
                       "srtcp_unprotect_cm"),
         "sfu_svc": ("srtp_protect_cm", "srtp_unprotect_cm",
                     "srtp_fanout_cm", "srtcp_protect_cm",
                     "srtcp_unprotect_cm"),
         "video_stream": ("srtp_protect_cm", "srtp_unprotect_cm"),
         # C and M in the lifecycle's warm-ups, D / H / J in the ticks, I
         # in emit_feedback, N's cached instance and O under GCM
         "sfu_lifecycle": ("srtp_protect_cm", "srtp_unprotect_cm",
                           "srtp_fanout_cm", "srtcp_protect_cm",
                           "srtcp_unprotect_cm", "srtp_gcm_seal",
                           "srtp_gcm_open", "srtp_gcm_seal_cached",
                           "srtp_gcm_open_cached", "srtp_fanout_gcm",
                           "gcm_ks_fill"),
         "conference_supervised": ("srtp_protect_cm", "srtp_unprotect_cm",
                                   "mix_minus", "g711_encode",
                                   "g711_decode")}
# the kernel instances a path must launch, as `_kernel_key` names them
PATH_INSTANCES = {"stream_zrtp": ZRTP_INSTANCES}
FANOUT_INSTANCES = ("srtp_fanout_null", "srtp_fanout_f8")


# kernels beside KERNELS whose SASS and ptxas reports are read: the AES
# chain probe, kernel E's staged form and the GHASH step probe
EXTRA_KERNELS = ("aes_chain", "mix_minus_staged", "ghash_chain",
                 "resample_up", "resample_down", "resample_up_phases",
                 "resample_down_phases", "resample_phases")
# what a kernel's one template argument is, where it is not the AES
# rounds: R's instances take their L or M
TEMPLATE_ARG = {"resample_up": "l", "resample_up_phases": "l",
                "resample_down": "m", "resample_down_phases": "m"}


def _kernel_key(m) -> str:
    """'srtp_protect_cm nr=10', 'resample_up l=6': a kernel-name match's
    name and template argument."""
    arg = TEMPLATE_ARG.get(m.group(1), "nr")
    return m.group(1) + (f" {arg}={m.group(2)}" if m.group(2) else "")

T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line a phase; `at_s` is the script's time when it ends."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T_START}), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the PyTorch port's "
                                 "media paths on one NVIDIA GPU.")
    ap.add_argument("--parent", metavar="ROOT",
                    help="another checkout (the parent commit) whose GCM "
                         "kernels, O, H-F8, K, L, R, I-NULL and J-NULL are "
                         "timed against this tree's in turns, and whose "
                         "SASS is compared with this tree's")
    ap.add_argument("--lifecycle-child", metavar="WIRE",
                    help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from libjitsi_tpu_torch.kernels import build as kbuild

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if opts.lifecycle_child:
        return lifecycle_child(torch, dev, opts.lifecycle_child)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    kbuild.library()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0)

    known_answers(torch, dev)
    gcm_known_answers(torch, dev)
    fill_core = sass_counts(kbuild)
    floor_ms, b_chain_ms, chain = latency_floor(torch, dev, kbuild)
    parent_lib = parent_library(opts.parent) if opts.parent else None
    rows = kernels_vs_plain(torch, dev, kbuild, floor_ms, b_chain_ms)
    rows.update(mix_kernel(torch, dev, floor_ms))
    rows.update(g711_kernels(torch, dev, floor_ms))
    rows.update(sfu_kernels(torch, dev, floor_ms))
    rows.update(profile_kernels(torch, dev, floor_ms, chain, parent_lib))
    rows.update(sfu_profile_kernels(torch, dev, floor_ms, chain, parent_lib))
    rows.update(gcm_kernels(torch, dev, floor_ms, chain, parent_lib))
    rows.update(fill_kernel(torch, dev, floor_ms, chain, fill_core,
                            parent_lib))
    rows.update(resample_kernels(torch, dev, floor_ms))
    r_phases(torch, dev, kbuild.library(), "this tree")
    if parent_lib is not None:
        if hasattr(parent_lib, "ljt_resample_phases"):
            r_phases(torch, dev, parent_lib, "parent")
        resample_turns(torch, dev, parent_lib)
        sass_compare(opts.parent)

    counts = {}

    def path(name, fn, *args):
        kbuild.reset_counts()
        out = fn(*args)
        counts[name] = dict(kbuild.launches)
        plain = dict(kbuild.plain_calls)
        instances = dict(kbuild.instance_launches)
        emit("main_path_counts", path=name, launches=counts[name],
             plain_calls=plain, instances=instances)
        require(all(counts[name][k] > 0 for k in PATHS[name]),
                f"path {name} did not launch all of {PATHS[name]}")
        require(all(instances.get(k, 0) > 0
                    for k in PATH_INSTANCES.get(name, ())),
                f"path {name} did not launch all of {PATH_INSTANCES[name]}"
                if name in PATH_INSTANCES else "")
        require(sum(plain.values()) == 0,
                f"a plain version ran on the {name} path")
        return out

    table = path("srtp_echo", srtp_echo, torch, dev)
    # the client's wire is made (on kernels F and C) before the counts are
    # reset, so the conference counts hold the bridge's launches only
    setup = _conference_setup(torch, dev)
    conf = path("conference", conference_run, torch, dev, setup)
    cpu_ref = conference_check(torch, dev, conf)
    conference_restore_check(torch, dev, setup, cpu_ref)
    mb = path("mixer_bridge", mixer_bridge_run, torch, dev)
    mixer_bridge_check(torch, dev, mb)
    # the clients' wire and RTCP are made (on kernels C and I) before the
    # counts are reset, so the sfu counts hold the bridge's launches only
    sfu_in = _sfu_setup(torch, dev)
    sfu = path("sfu", sfu_path, torch, dev, sfu_in)
    sfu_check(torch, dev, sfu)
    profiles = path("srtp_profiles", srtp_profiles_run, torch, dev)
    srtp_profiles_check(torch, dev, profiles, table)
    # the clients' NULL and F8 wire is made (on C's NULL instance and K)
    # before the counts are reset
    sfu_p_in = {prof: _sfu_setup(torch, dev, prof, SFU_PROFILE_TICKS,
                                 with_rtcp=False) for prof in SFU_PROFILES}
    sfu_p = path("sfu_profiles", sfu_profiles_run, torch, dev, sfu_p_in)
    sfu_profiles_check(torch, dev, sfu_p)
    gcm = path("srtp_gcm", srtp_gcm_run, torch, dev)
    srtp_gcm_check(torch, dev, gcm)
    # the clients' GCM wire and RRs are made (on M) before the counts are
    # reset
    sfu_g_in = _sfu_setup(torch, dev, GCM, GCM_TICKS,
                          rr_ticks=(GCM_RR_TICK,), nack_tick=GCM_NACK_TICK)
    sfu_g = path("sfu_gcm", sfu_gcm_run, torch, dev, sfu_g_in)
    sfu_gcm_check(torch, dev, sfu_g)
    # the clients' wire (G.722 on the host, kernels F and C) is made
    # before the counts are reset
    mixed_in = _mixed_setup(torch, dev)
    mixed = path("conference_mixed", conference_mixed_run, torch, dev,
                 mixed_in)
    conference_mixed_check(torch, dev, mixed)
    # the host I/O plane: the pipelined conference on the conference
    # path's wire, the ringed SFU (its wire and RTCP made, on C and I,
    # before the counts are reset) and the echo loop's batcher (its wire
    # made first too)
    piped = path("conference_pipelined", conference_pipelined_run, torch,
                 dev, setup)
    conference_pipelined_check(torch, dev, piped, setup, conf)
    rings_in = _sfu_setup(torch, dev,
                          ticks=SFU_RINGS_TICKS + SFU_RINGS_PROFILED,
                          rr_ticks=(SFU_RINGS_RR,), nack_tick=SFU_RINGS_NACK)
    rings = path("sfu_rings", sfu_rings_run, torch, dev, rings_in)
    sfu_rings_check(torch, dev, rings, sfu)
    batcher_in = _batcher_setup(torch, dev, table)
    batcher = path("echo_batcher", echo_batcher_run, torch, dev, batcher_in)
    echo_batcher_check(torch, dev, batcher)
    # the public stream API: init(), media_service() and every pair's
    # SDES keying and start are done before the counts are reset
    ms_in = media_stream_setup(torch, dev)
    ms = path("media_stream", media_stream_run, torch, dev, ms_in)
    media_stream_check(torch, dev, ms, smi)
    # the ingest engines: the traffic (made on kernel C) and its recvmmsg
    # echo, the reference, come before the counts are reset
    engine_in = engine_echo_setup(torch, dev, table)
    uring = path("srtp_echo_uring", srtp_echo_uring_run, torch, dev,
                 engine_in)
    srtp_echo_uring_check(torch, dev, uring, engine_in, smi)
    tcp = path("srtp_echo_tcp", srtp_echo_tcp_run, torch, dev, engine_in)
    srtp_echo_tcp_check(torch, dev, tcp, engine_in, smi)
    # the media graph through pumps: every pair keyed, started and its
    # pumps built (and the CPU twin started) before the counts are reset
    pumps_in = conference_pumps_setup(torch, dev)
    pumps = path("conference_pumps", conference_pumps_run, torch, dev,
                 pumps_in)
    conference_pumps_check(torch, dev, pumps, pumps_in, smi)
    # DTLS-SRTP and ZRTP keying: every join's handshake, and the clients'
    # wire under the keys they exported (on kernels C, I, M and F), come
    # before the counts are reset
    dtls_in = sfu_dtls_setup(torch, dev)
    sfu_d = path("sfu_dtls", sfu_dtls_run, torch, dev, dtls_in)
    sfu_dtls_check(torch, dev, sfu_d, dtls_in, sfu["tick_ms"])
    with tempfile.TemporaryDirectory() as rec_dir:
        conf_d_in = conference_dtls_setup(torch, dev, rec_dir)
        conf_d = path("conference_dtls", conference_dtls_run, torch, dev,
                      conf_d_in)
        conference_dtls_check(torch, dev, conf_d, conf_d_in, conf)
    zrtp_in = stream_zrtp_setup(torch, dev)
    zrtp = path("stream_zrtp", stream_zrtp_run, torch, dev, zrtp_in)
    stream_zrtp_check(torch, dev, zrtp, zrtp_in)
    # the video plane: each cell's endpoints, bridge (every track
    # attached) and the checks' tables are made before the counts are
    # reset; the clients' wire and RTCP, and the checks' decrypts, are
    # made during the run but kept out of the counts (`_Uncounted`)
    video_in = video_setup(torch, dev, "simulcast", VIDEO_CONFS)
    video = path("sfu_video", video_run, torch, dev, video_in, VIDEO_TICKS)
    video_check(torch, dev, video_in, video, "sfu_video")
    emit("sfu_video_hold", **video_hold(torch, dev, "simulcast",
                                        VIDEO_HOLD_TICKS))
    svc_in = video_setup(torch, dev, "svc", SVC_CONFS)
    svc = path("sfu_svc", video_run, torch, dev, svc_in, SVC_TICKS)
    video_check(torch, dev, svc_in, svc, "sfu_svc")
    emit("sfu_svc_hold", **video_hold(torch, dev, "svc",
                                      VIDEO_HOLD_TICKS))
    vs_in = video_stream_setup(torch, dev)
    vs = path("video_stream", video_stream_run, torch, dev, vs_in)
    video_stream_check(torch, dev, vs)
    # the operations plane: the supervised, lifecycle-managed SFU runs in
    # a child process (its wire made here first); the child resets its
    # counts before its first join and hands them back
    lc_run = sfu_lifecycle_run(torch, dev)
    counts["sfu_lifecycle"] = lc_run["launches"]
    emit("main_path_counts", path="sfu_lifecycle", process="child",
         launches=lc_run["launches"], plain_calls=lc_run["plain_calls"],
         instances=lc_run["instances"])
    require(all(lc_run["launches"][k] > 0 for k in PATHS["sfu_lifecycle"]),
            f"path sfu_lifecycle did not launch all of "
            f"{PATHS['sfu_lifecycle']}")
    require(sum(lc_run["plain_calls"].values()) == 0,
            "a plain version ran on the sfu_lifecycle path")
    cs = path("conference_supervised", conference_supervised_run, torch,
              dev, setup)
    conference_supervised_check(torch, dev, cs)
    exposition(torch)
    per_unit = {"srtp_echo": ("launches_per_table_batch",
                              table["launches_per_batch"]),
                "conference": ("launches_per_conference_tick",
                               conf["launches_per_tick"]),
                "sfu": ("launches_per_sfu_tick", sfu["launches_per_tick"]),
                "srtp_profiles": ("launches_per_profile_batch",
                                  profiles["launches_per_batch"]),
                "sfu_profiles": ("launches_per_sfu_profile_tick",
                                 sfu_p["launches_per_tick"]),
                "srtp_gcm": ("launches_per_gcm_batch",
                             gcm["launches_per_batch"]),
                "sfu_gcm": ("launches_per_sfu_gcm_tick",
                            sfu_g["launches_per_tick"]),
                "conference_mixed": ("launches_per_mixed_tick",
                                     mixed["launches_per_tick"]),
                "conference_pipelined": (
                    "launches_per_pipelined_conference_tick",
                    piped["launches_per_tick"]),
                "sfu_rings": ("launches_per_ringed_sfu_tick",
                              rings["launches_per_tick"]),
                "echo_batcher": ("launches_per_batcher_tick",
                                 batcher["launches_per_tick"]),
                "media_stream": ("launches_per_media_stream_tick",
                                 ms["launches_per_tick"]),
                "srtp_echo_uring": ("launches_per_uring_echo_tick",
                                    uring["launches_per_tick"]),
                "srtp_echo_tcp": ("launches_per_tcp_echo_tick",
                                  tcp["launches_per_tick"]),
                "conference_pumps": ("launches_per_pumps_tick",
                                     pumps["launches_per_tick"]),
                "sfu_dtls": ("launches_per_dtls_sfu_tick",
                             sfu_d["launches_per_tick"]),
                "conference_dtls": ("launches_per_dtls_conference_tick",
                                    conf_d["launches_per_tick"]),
                "stream_zrtp": ("launches_per_zrtp_stream_tick",
                                zrtp["launches_per_tick"]),
                "sfu_video": ("launches_per_video_sfu_tick",
                              video["launches_per_tick"]),
                "sfu_svc": ("launches_per_svc_sfu_tick",
                            svc["launches_per_tick"]),
                # launches inside the bridge's ticks only; the off-tick
                # ones (warm-ups, keystream fill, emit_feedback) apart
                "sfu_lifecycle": ("launches_per_lifecycle_tick", {
                    k: lc_run["tick_launches"].get(k, 0) / lc_run["ticks"]
                    for k in lc_run["launches"]}),
                "conference_supervised": (
                    "launches_per_supervised_conference_tick", {
                        k: v / CS_TICKS for k, v in
                        counts["conference_supervised"].items()})}
    kernels = []
    for name, (src, ref) in SOURCES.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": ref,
            "launches": sum(c[name] for c in counts.values()),
            "launches_by_path": {p: c[name] for p, c in counts.items()
                                 if name in PATHS[p]},
            **{key: per[name] for p, (key, per) in per_unit.items()
               if name in PATHS[p] and name in per},
            **({"lifecycle_off_tick_launches":
                lc_run["launches"][name]
                - lc_run["tick_launches"].get(name, 0)}
               if name in PATHS["sfu_lifecycle"] else {}),
            "main_path": any(name in k for k in PATHS.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "launch_floor_ms": floor_ms, "library_ms": r.get("library_ms"),
            **{k: r[k] for k in ("plain_device_ms", "library_device_ms",
                                 "chain_floor_ms", "ptxas") if k in r},
            "shape": r["shape"]})
    emit("profiler", windows_measured_again=PROFILER_RETRIES,
         timed_by_cuda_events=PROFILER_FALLBACK)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(", ".join(smi), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------- helpers

def cuda_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call of `fn` over `reps` back-to-back calls,
    measured with CUDA events after `warm` untimed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# profiling windows of `device_ms` measured again, and the kernels it timed
# by CUDA events because no window recorded them
PROFILER_RETRIES: dict = {}
PROFILER_FALLBACK: list = []

# record_function spans, which the profiler mirrors on the device timeline
SPANS = ("ingress", "reverse_chain", "decode", "mixer", "recovery",
         "forward_chain", "egress", "resample")


def _is_span(name: str) -> bool:
    return name in SPANS or name.startswith("srtp.")


def device_ms(torch, fn, reps: int, match: str = "") -> float:
    """Milliseconds of device work per call of `fn`: the summed durations
    of the kernels and copies torch.profiler records on the card over
    `reps` calls, or, when `match` names a kernel launched once a call,
    the mean duration of its recorded launches.  Unlike `cuda_ms` it
    leaves out the host's time to issue the call, which bounds
    back-to-back calls of a kernel of a few microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # now and then a profiling window comes back without some or all of
    # the device events of a kernel that other windows record in full (seen
    # on the H100).  A recorded event is a true duration, so a kernel
    # launched once a call (`match` names it) is timed as the mean of every
    # launch recorded over up to five windows, stopping at a full one; the
    # summed device work of a call (no `match`) needs a window that
    # recorded some.  Each window measured again is counted.
    n_events, total_us = 0, 0.0
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not _is_span(e.name)
                  and match in e.name]
        us = sum(e.time_range.elapsed_us() for e in events)
        if match:
            n_events += len(events)
            total_us += us
            if len(events) >= reps:
                break
        elif us > 0:
            break
        PROFILER_RETRIES[match] = PROFILER_RETRIES.get(match, 0) + 1
    if match and n_events:
        return total_us / n_events / 1e3
    if match:
        # no window recorded the kernel: time whole calls by CUDA events
        # (host issue included) and say so in the `profiler` phase
        PROFILER_FALLBACK.append(match)
        return cuda_ms(torch, fn, reps)
    require(us > 0, "the profiler recorded no device work")
    return us / reps / 1e3


def bound(nbytes: float, ops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def bound_fp32(nbytes: float, fmas: float):
    """As `bound`, with float32 fused multiply-adds (2 operations each) over
    the FP32 rate outside the tensor cores."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 2 * fmas / FP32_FLOPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def max_abs_err(torch, outs_a, outs_b) -> int:
    err = 0
    for a, b in zip(outs_a, outs_b):
        require(a.shape == b.shape, "shape mismatch against plain version")
        err = max(err, int((a.long() - b.long()).abs().max().item())
                  if a.numel() else 0)
    return err


def production_lengths(rng, n: int) -> np.ndarray:
    sizes = np.array([m[0] for m in MIX])
    return sizes[rng.choice(len(MIX), n, p=[m[1] for m in MIX])]


# ------------------------------------------------------------ 2. answers

def known_answers(torch, dev) -> None:
    from libjitsi_tpu_torch.kernels import aes, sha1
    from libjitsi_tpu_torch.transform.srtp import kernel as sk
    from libjitsi_tpu_torch.transform.srtp.kdf import derive_session_keys

    def t(x):
        return torch.as_tensor(np.array(x)).to(dev)

    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       np.uint8)[None]
    fips = {}
    for name, key, ct in (
            ("C.1", "000102030405060708090a0b0c0d0e0f",
             "69c4e0d86a7b0430d8cdb78070b4c55a"),
            ("C.3", "000102030405060708090a0b0c0d0e0f"
             "101112131415161718191a1b1c1d1e1f",
             "8ea2b7ca516745bfeafc49904b496089")):
        got = aes.aes_encrypt(t(aes.expand_key(bytes.fromhex(key))[None]),
                              t(pt)).cpu().numpy()
        fips[name] = bytes(got[0]) == bytes.fromhex(ct)
    require(all(fips.values()), f"FIPS-197 through kernel A: {fips}")

    # RFC 3711 B.2: the AES-CM keystream is kernel C's ciphertext of zeros
    rk = aes.expand_key(bytes.fromhex("2B7E151628AED2A6ABF7158809CF4F3C"))
    iv = np.frombuffer(bytes.fromhex("F0F1F2F3F4F5F6F7F8F9FAFBFCFD0000"),
                       np.uint8)[None]
    width = HDR + 48 + TAG
    out, _ = sk.srtp_protect(
        t(rk[None]), t(np.zeros((1, 2, 5), np.int32)), t(np.zeros(1, np.int32)),
        t(np.zeros((1, width), np.uint8)), t(np.array([HDR + 48], np.int32)),
        t(np.array([HDR], np.int32)), t(iv), t(np.zeros(1, np.int32)), TAG)
    b2 = bytes(out.cpu().numpy()[0, HDR:HDR + 48]) == bytes.fromhex(
        "E03EAD0935C95E80E166B16DD92B4EB4D23513162B02D0F72A43A2FE4A5F97AB"
        "41E95B3BB0A2E8DD477901E4FCA894C0")
    require(b2, "RFC 3711 B.2 keystream through kernel C")
    # RFC 3711 B.3 key derivation (host NumPy AES)
    ks = derive_session_keys(bytes.fromhex("E1F97A0D3E018BE0D64FA32C06DE4139"),
                             bytes.fromhex("0EC675AD498AFEEBB6960B3AABE6"))
    b3 = (ks.rtp_enc.hex() == "c61e7a93744f39ee10734afe3ff7a087"
          and ks.rtp_salt.hex() == "30cbbc08863d8c85d49db34a9ae1"
          and ks.rtp_auth.hex() == "cebe321f6ff7716b6fd4ab49af256a156d38baa4")
    require(b3, "RFC 3711 B.3 key derivation")

    rfc2202 = [(b"\x0b" * 20, b"Hi There"),
               (b"Jefe", b"what do ya want for nothing?"),
               (b"\xaa" * 20, b"\xdd" * 50),
               (bytes(range(1, 26)), b"\xcd" * 50),
               (b"\x0c" * 20, b"Test With Truncation"),
               (b"\xaa" * 80,
                b"Test Using Larger Than Block-Size Key - Hash Key First"),
               (b"\xaa" * 80, b"Test Using Larger Than Block-Size Key and "
                              b"Larger Than One Block-Size Data")]
    want = ["b617318655057264e28bc0b6fb378c8ef146be00",
            "effcdf6ae5eb2fa2d27416d5f184df9c259a7c79",
            "125d7342b9ac11cd91a39af48aa17b4f63f175d3",
            "4c9007f4026250c6bc8414f9bf50c86c2d7235da",
            "4c1a03424b55e07fe7f27be1d58bb9324a9a5a04",
            "aa4ae5e15272d00e95705637ce8a3b55ed402112",
            "e8e99d0f45237d786d6bbaa7965c7808bbff1a91"]
    rng = np.random.default_rng(64)
    keys = [k for k, _ in rfc2202] + [rng.integers(0, 256, 20, np.uint8)
                                      .tobytes() for _ in range(64)]
    msgs = [m for _, m in rfc2202] + [rng.integers(0, 256, int(n), np.uint8)
                                      .tobytes()
                                      for n in rng.integers(0, 1504, 64)]
    data = np.zeros((len(msgs), 1504), np.uint8)
    for i, m in enumerate(msgs):
        data[i, :len(m)] = np.frombuffer(m, np.uint8)
    mid = np.stack([sha1.hmac_precompute(k) for k in keys]).view(np.int32)
    tags = sha1.hmac_sha1(t(mid), t(data), t(np.array([len(m) for m in msgs],
                                                      np.int32))).cpu().numpy()
    rfc_ok = [bytes(tags[i]).hex() == w for i, w in enumerate(want)]
    std_ok = [bytes(tags[i]) == hmac.new(keys[i], msgs[i], hashlib.sha1)
              .digest() for i in range(len(rfc2202), len(msgs))]
    require(all(rfc_ok), f"RFC 2202 through kernel B: {rfc_ok}")
    require(all(std_ok), "64 random rows of kernel B against stdlib hmac")
    emit("known_answers", fips197=fips, rfc3711_b2=b2, rfc3711_b3=b3,
         rfc2202=len(rfc_ok), stdlib_hmac_rows=len(std_ok))


def sass_counts(kbuild) -> dict:
    """Static count of the INT32-pipe instructions the bounds count
    (LOP3, SHF, PRMT) in each built kernel, read with `cuobjdump -sass`,
    and each kernel's registers, stack, spill bytes and static shared
    memory as ptxas reported them.  Kernel A's code holds every round of
    a pair of blocks at least once, so its count must not fall below
    the bound's count for a block; it is the AES core alone, so it must hold no shared
    memory and issue no shared-memory load (LDS) and no constant load
    whose address is in a register (LDC / ULDC with R or UR in the
    brackets): no lookup of any kind.  The chain probe runs the same
    core with its round keys sliced in shared memory, as the tile
    kernels keep them: its loads must be those keys' alone, 2 LDS.128 (8
    words) a round and no indexed constant load; the tile kernels issue
    no indexed constant load either.  Returns kernel O's INT32-pipe
    instructions a pair of blocks (`_pair_int32`), from which its core
    floor is reckoned."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", kbuild.build()], check=True,
                          capture_output=True, text=True,
                          timeout=120).stdout
    counts, lookups, code, cur = {}, {}, {}, None
    shared, indexed_ldc = {}, {}
    name = re.compile(r"(" + "|".join(kbuild.KERNELS + EXTRA_KERNELS)
                      + r")_kernel(?:ILi(\d+)E)?")
    insn = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9]*)(\S*)\s*([^;]*);")
    for line in sass.splitlines():
        if "Function : " in line:      # a kernel not listed counts nowhere
            m = name.search(line)
            cur = _kernel_key(m) if m else None
            if cur:
                counts[cur] = 0
                lookups[cur] = []
                code[cur] = []
                shared[cur] = []
                indexed_ldc[cur] = 0
            continue
        m = insn.match(line) if cur else None
        if not m:
            continue
        op, operands = m.group(2), m.group(4)
        code[cur].append((int(m.group(1), 16), op, operands))
        if op in ("LOP3", "SHF", "PRMT"):
            counts[cur] += 1
        indexed = re.search(r"c\[[^\]]*\]\s*\[[^\]]*\bU?R\d+", operands) \
            or re.search(r"c\[\s*U?R\d+", operands)
        if op in ("LDS", "LDSM") or (op in ("LDC", "ULDC") and indexed):
            lookups[cur].append(op + m.group(3) + " " + operands.strip())
        if op in ("LDS", "LDSM"):
            shared[cur].append(op + m.group(3))
        if op in ("LDC", "ULDC") and indexed:
            indexed_ldc[cur] += 1
    chains = [f"aes_chain nr={nr}" for nr in (10, 14)]
    require(all(k in counts for k in chains),
            f"no SASS for the AES chain probe: {sorted(counts)}")
    loops = {k: _innermost_loop(code[k]) for k in
             chains + ["aes_encrypt nr=10", "aes_encrypt nr=14"]}
    for k in chains:
        # round 0, the loop's round and the last: one round key each
        require(shared[k] == ["LDS.128"] * 6 and
                loops[k]["shared_loads"] == 2 and indexed_ldc[k] == 0,
                f"{k}: loads other than its round keys: {shared[k]}, "
                f"{indexed_ldc[k]} indexed LDC, loop {loops[k]}")
        counts.pop(k)
        lookups.pop(k)
    for nr in (10, 14):
        require(counts.get(f"aes_encrypt nr={nr}", 0) >= aes_block_ops(nr),
                f"kernel A (nr={nr}) issues fewer INT32-pipe instructions "
                f"than its bound counts: {counts}")
        require(f"aes_encrypt nr={nr}" in lookups and
                not lookups[f"aes_encrypt nr={nr}"],
                f"kernel A (nr={nr}) issues table lookups: {lookups}")
    ptxas = ptxas_usage(kbuild)
    for k in ("srtp_protect_cm", "srtp_unprotect_cm"):
        for nr in (10, 14):
            require(f"{k} nr={nr}" in ptxas, f"no ptxas report for {k} "
                                             f"nr={nr}: {sorted(ptxas)}")
    for k in ("srtp_fanout_cm", "srtcp_protect_cm", "srtcp_unprotect_cm",
              *PROFILE_KERNELS, *FANOUT_INSTANCES):
        for nr in (10, 14):
            require(f"{k} nr={nr}" in ptxas, f"no ptxas report for {k} "
                                             f"nr={nr}: {sorted(ptxas)}")
    for k in ("mix_minus", "mix_minus_staged", "g711_encode", "hmac_sha1",
              "g711_decode nr=0", "g711_decode nr=1"):
        require(k in ptxas, f"no ptxas report for {k}: {sorted(ptxas)}")
    # kernel B hashes from its staged rows with nothing spilled; kernel G
    # expands each code in registers: no shared memory, no LDS
    for k in ("hmac_sha1", "srtp_fanout_f8 nr=10", "srtp_protect_f8 nr=10",
              "srtp_unprotect_f8 nr=10"):
        require(ptxas[k].get("spill_store_bytes", 0) == 0
                and ptxas[k].get("spill_load_bytes", 0) == 0,
                f"{k} spills: {ptxas[k]}")
    # kernel B stages its tile, then hashes: the tightest loop around its
    # shared-memory loads (the hash chain over a row's blocks) holds no
    # global load
    b_code = code.get("hmac_sha1", [])
    b_ldg = [a for a, op, _ in b_code if op == "LDG"]
    b_lds = [a for a, op, _ in b_code if op == "LDS"]
    chain = min((sp for sp in _loop_spans(b_code)
                 if any(sp[1] <= a <= sp[2] for a in b_lds)), default=None)
    require(chain is not None and not any(chain[1] <= a <= chain[2]
                                          for a in b_ldg),
            f"kernel B loads from device memory inside its hash chain: "
            f"loop {chain}, LDG at {b_ldg}")
    for law in (0, 1):
        k = f"g711_decode nr={law}"
        require(ptxas[k].get("static_smem_bytes", 0) == 0 and k in shared
                and not shared[k],
                f"kernel G (law {law}) uses shared memory: {ptxas[k]}, "
                f"{shared.get(k)}")
    crypto = ("aes_encrypt", "srtp_protect_cm", "srtp_unprotect_cm",
              "srtp_fanout_cm", "srtcp_protect_cm", "srtcp_unprotect_cm",
              *PROFILE_KERNELS, *FANOUT_INSTANCES)
    static_smem = {f"{k} nr={nr}": ptxas.get(f"{k} nr={nr}", {}).get(
        "static_smem_bytes", 0) for k in crypto for nr in (10, 14)}
    for nr in (10, 14):
        require(f"aes_encrypt nr={nr}" in ptxas and
                static_smem[f"aes_encrypt nr={nr}"] == 0,
                f"kernel A (nr={nr}) holds shared memory: {static_smem}")
    ldc = {f"{k} nr={nr}": indexed_ldc.get(f"{k} nr={nr}")
           for k in crypto for nr in (10, 14)}
    ldc.update({k: indexed_ldc.get(k)
                for k in GCM_SASS + ("ghash_chain",)})
    require(all(v == 0 for v in ldc.values()),
            f"indexed constant loads: {ldc}")
    gcm = _gcm_sass(code, ptxas)
    # I-NULL and J-NULL: registers, spills and local memory
    srtcp_null = {
        k: dict(ptxas[k], local_loads=sum(op == "LDL" for _, op, _ in
                                          code.get(k, [])),
                local_stores=sum(op == "STL" for _, op, _ in
                                 code.get(k, [])))
        for k in (f"srtcp_{d}_null nr={nr}" for d in ("protect", "unprotect")
                  for nr in (10, 14))}
    fill_core = _pair_int32(code["gcm_ks_fill nr=10"], 10)
    r = _r_sass(code, indexed_ldc)
    # the AES core's round loop, once a round: in the chain probe the
    # core as the tiles run it (its key words loaded from shared memory),
    # in kernel A with both blocks' keys sliced in the loop (the four
    # rotations' key shifts all inside its body, one taken a round)
    emit("sass", int32_pipe_static=counts, ptxas=ptxas,
         static_smem_bytes=static_smem, aes_loops=loops,
         shared_or_indexed_constant_loads={k: len(v)
                                           for k, v in lookups.items()},
         mix_minus_plans={f"{c}x{n}x{f}": mix_plan(kbuild, c, n, f)
                          for c, n, f in MIX_SHAPES + MIX_STAGED},
         g711_decode_shared_loads={law: len(shared[f"g711_decode nr={law}"])
                                   for law in (0, 1)},
         hmac_sha1_loads=dict(global_loads=len(b_ldg),
                              shared_loads=len(b_lds), hash_loop=chain),
         gcm=gcm, gcm_ks_fill_core=fill_core, resample=r,
         srtcp_null=srtcp_null,
         bound_per_unit={"sha1_compression": SHA1_BLOCK_OPS,
                         "aes_block nr=10": aes_block_ops(10),
                         "aes_block nr=14": aes_block_ops(14),
                         "ghash_block": GHASH_BLOCK_OPS})
    return fill_core


def _r_sass(code, indexed_ldc) -> dict:
    """Kernel R's instances in the SASS: instructions, FFMAs and those
    with a uniform-register or constant-bank operand (the coefficient of
    the templated instances), shared, global and constant-indexed loads,
    conversions and stores.  The templated instances (L/1, 1/M) must load
    nothing from shared memory and index no constant: their bank is the
    kernel's parameters."""
    out = {}
    for k, rows in code.items():
        if not k.startswith("resample"):
            continue
        ops = [op for _, op, _ in rows]
        out[k] = dict(
            instructions=len(rows), ffma=ops.count("FFMA"),
            ffma_uniform_or_constant=sum(
                op == "FFMA" and bool(re.search(r"\bUR\d+|c\[0x0\]", a))
                for _, op, a in rows),
            lds=ops.count("LDS"), ldg=ops.count("LDG"),
            stg=ops.count("STG"), i2f_f2i=ops.count("I2F") + ops.count("F2I"),
            indexed_ldc=indexed_ldc.get(k, 0))
    shipped = [k for k in out if k.startswith(("resample_up ",
                                               "resample_down "))]
    require(len(shipped) == 6 and "resample" in out,
            f"R's instances missing from the SASS: {sorted(out)}")
    for k in shipped:
        require(out[k]["lds"] == 0 and out[k]["indexed_ldc"] == 0,
                f"{k} loads its bank from memory: {out[k]}")
    return out


def _pair_int32(code, nr: int) -> dict:
    """INT32-pipe instructions (LOP3, SHF, PRMT) a pair of blocks costs in
    a kernel that runs one AES pair an iteration of a loop around the
    core's round loop (kernel O): the round loop's (the shortest loop
    with 100 or more of them: one round an iteration, nr - 1 iterations a
    pair) and the rest of the loop around it (the first and last rounds,
    packing, the counter blocks, the stores)."""
    def int32(lo, hi, skip=None):
        return sum(op in ("LOP3", "SHF", "PRMT") for a, op, _ in code
                   if lo <= a <= hi and not (skip and skip[0] <= a <= skip[1]))

    spans = _loop_spans(code)
    rounds = min((sp for sp in spans if int32(sp[1], sp[2]) >= 100),
                 default=None)
    require(rounds is not None, "no AES round loop in O's SASS")
    outer = min((sp for sp in spans if sp[1] <= rounds[1] and
                 rounds[2] <= sp[2] and sp != rounds), default=None)
    require(outer is not None, "no loop around O's round loop")
    per_round = int32(rounds[1], rounds[2])
    rest = int32(outer[1], outer[2], rounds[1:])
    return dict(round_loop_int32=per_round, pair_loop_rest_int32=rest,
                int32_per_pair=per_round * (nr - 1) + rest)


def _loop_spans(code) -> list:
    """The loops of a kernel's SASS ((address, op, operands) rows): one
    (length, first address, last address) for each backward branch."""
    spans = []
    for addr, op, operands in code:
        m = re.match(r"(0x[0-9a-f]+)$", operands.strip())
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            spans.append((addr - int(m.group(1), 16), int(m.group(1), 16),
                          addr))
    return spans


def _innermost_loop(code) -> dict:
    """A kernel's innermost loop in its SASS ((address, op, operands)
    rows): the shortest span from a backward branch's target to the
    branch that lies inside another such span, or the shortest span if
    none is nested.  Its length and its INT32-pipe, shared-memory and
    global load instructions."""
    spans = _loop_spans(code)
    require(spans, "no loop in an AES kernel's SASS")
    nested = [sp for sp in spans if any(o[1] <= sp[1] and sp[2] <= o[2]
                                        and o != sp for o in spans)]
    _, lo, hi = min(nested or spans)
    body = [op for addr, op, _ in code if lo <= addr <= hi]
    return dict(instructions=len(body),
                int32_pipe=sum(op in ("LOP3", "SHF", "PRMT") for op in body),
                shared_loads=sum(op == "LDS" for op in body),
                global_loads=sum(op == "LDG" for op in body))


def ptxas_usage(kbuild) -> dict:
    """Registers, spill bytes, stack and static shared memory of each
    kernel as `ptxas -v` reported them in this build's log."""
    key = re.search(r"libljt_kernels_(\w+)\.so$", kbuild.build()).group(1)
    with open(f"{kbuild.BUILD_DIR}/build_{key}.log") as f:
        log = f.read()
    name = re.compile(r"(" + "|".join(kbuild.KERNELS + EXTRA_KERNELS)
                      + r")_kernel(?:ILi(\d+)E)?")
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line)
        if m:
            k = name.search(m.group(1))
            cur = _kernel_key(k) if k else None
            if cur:
                out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        for field, pat in (("registers", r"Used (\d+) registers"),
                           ("stack_bytes", r"(\d+) bytes stack frame"),
                           ("spill_store_bytes", r"(\d+) bytes spill stores"),
                           ("spill_load_bytes", r"(\d+) bytes spill loads"),
                           ("static_smem_bytes", r"(\d+) bytes smem")):
            v = re.search(pat, line)
            if v:
                out[cur][field] = int(v.group(1))
    return out


def mix_plan(kbuild, c: int, n: int, f: int) -> dict:
    """Kernel E's launch for [c, n, f] on this card, 16-byte aligned
    pcm and out (`ljt_mix_minus_plan`)."""
    plan = np.zeros(8, np.int32)
    kbuild.check(kbuild.library().ljt_mix_minus_plan(
        256, 256, c, n, f, plan.ctypes.data), "mix_minus_plan")
    keys = ("cluster", "block_columns", "staged_rows", "vec",
            "dynamic_smem_bytes", "column_stages", "staged_kernel",
            "row_groups")
    return {k: int(v) for k, v in zip(keys, plan)} | {"blocks": int(
        c * plan[0])}


B_LONGEST = "kernel B's longest message 966"


def latency_floor(torch, dev, kbuild) -> tuple:
    """The launch floor: the time on the card of an empty kernel (one
    warp, csrc/latency_probe.cu), by the same profiler reading as every
    kernel's `ms`, and per back-to-back call by CUDA events; the same
    profiler reading for an empty cluster of 8 and of 16 blocks (kernel
    E launches clusters).  Then the cycles of one SHA-1 compression,
    and of one pair of AES-128 and of AES-256 blocks through the
    gather-free core (its round keys sliced in shared memory, as a tile
    holds them), on a lane whose every step waits on the one before (one
    warp, clock64), and from them the floor a row's hash
    chain sets for kernels C and D: a packet of length L needs
    (L + 4 + 9 + 63) // 64 inner compressions and one outer, one after
    another on its lane; and the cycles one row's whole HMAC takes on a
    lane of a tile kernel's hashing warp (`hmac_row`: message words from
    shared memory, padding, the outer block) at the longest rows of the
    main paths.  Returns the launch floor in ms, kernel B's chain floor
    in ms, and the AES pair cycles with the clock they were read at
    (the F8 kernels' chain floors), and the cycles of one GHASH Horner
    step on a waiting warp (`ghash_step_cycles`, the GCM kernels' chain
    floors)."""
    from libjitsi_tpu_torch.kernels.aes import aes_encrypt_np, expand_key

    lib, n = kbuild.library(), 2000
    stream = kbuild.stream_handle(dev)

    def empty():
        kbuild.check(lib.ljt_probe_empty(stream), "probe_empty")

    floor_ms = device_ms(torch, empty, 200, "probe_empty_kernel")
    floor_call_ms = cuda_ms(torch, empty, 1000)
    clusters = {}
    for cs in (8, 16):
        def cluster(cs=cs):
            kbuild.check(lib.ljt_probe_cluster(cs, stream), "probe_cluster")

        clusters[f"cluster of {cs}"] = device_ms(torch, cluster, 200,
                                                 "cluster_probe_kernel")
    rng = np.random.default_rng(8)
    state = torch.as_tensor(rng.integers(0, 2 ** 32, (32, 21), np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)
    cycles = torch.zeros(32, dtype=torch.int64, device=dev)
    kbuild.check(lib.ljt_probe_sha1_chain(state.data_ptr(), cycles.data_ptr(),
                                          n, stream), "probe_sha1_chain")
    torch.cuda.synchronize()
    sha = float(cycles.double().mean()) / n
    aes_pair = {}
    for key_len in (16, 32):
        rk_np = expand_key(rng.integers(0, 256, key_len, np.uint8).tobytes())
        rk = torch.as_tensor(rk_np).to(dev)
        pairs = rng.integers(0, 256, (64, 16), np.uint8)
        blocks = torch.as_tensor(pairs).to(dev)
        reps = 200
        kbuild.check(lib.ljt_probe_aes_chain(
            rk.data_ptr(), blocks.data_ptr(), cycles.data_ptr(),
            len(rk_np) - 1, reps, stream), "probe_aes_chain")
        torch.cuda.synchronize()
        want = pairs
        for _ in range(reps):
            want = aes_encrypt_np(np.broadcast_to(rk_np, (64,) + rk_np.shape),
                                  want)
        require(np.array_equal(blocks.cpu().numpy(), want),
                f"the AES-{key_len * 8} chain differs from the host AES")
        aes_pair[f"aes{key_len * 8}"] = float(cycles.double().mean()) / reps
    # one row's MAC on its lane as the tile kernels' hashing lanes run it
    probe = lib.ljt_probe_hmac_row
    mid = torch.as_tensor(_key_tables(rng, 32)[1]).to(dev)
    digest = torch.zeros(32, dtype=torch.int32, device=dev)
    hmac_cycles = {}
    # the probe hashes `length` bytes || a 4-byte word on `lanes` lanes of
    # one warp: kernel B's longest message at its timed shapes, 950 + 12 +
    # 4 = 966 bytes, is 962 || 4, on a lane alone, on 8 (a tile of B at
    # 4,096 rows) and on a full warp
    for label, length, width, lanes in (
            ("bench packet 172", 160 + HDR, 224, 32),
            ("longest mix row 112", MIX[0][0] + HDR, 224, 32),
            ("longest mix row 412", MIX[1][0] + HDR, 544, 32),
            ("longest SFU copy 180", 180, 224, 32),
            ("longest SRTCP message 200", 200, 224, 32),
            (B_LONGEST + " on 1 lane", MIX[-1][0] + HDR, 1024, 1),
            (B_LONGEST + " on 8 lanes", MIX[-1][0] + HDR, 1024, 8),
            (B_LONGEST + " on 32 lanes", MIX[-1][0] + HDR, 1024, 32)):
        rows = torch.as_tensor(rng.integers(0, 256, (32, width),
                                            np.uint8)).to(dev)
        reps = 200
        for _ in range(2):
            kbuild.check(probe(mid.data_ptr(), rows.data_ptr(), length, width,
                               digest.data_ptr(), cycles.data_ptr(), reps,
                               lanes, stream), "probe_hmac_row")
        torch.cuda.synchronize()
        hmac_cycles[label] = dict(
            compressions=(length + 4 + 9 + 63) // 64 + 1, lanes=lanes,
            cycles=float(cycles[:lanes].double().mean()) / reps)
    # one GHASH Horner step on a waiting warp, the matrix in its registers
    # as the GCM tiles hold it (`ghash.cuh`): the step of a row's chain
    from libjitsi_tpu_torch.kernels import ghash

    h, x = (rng.integers(0, 256, 16, np.uint8) for _ in range(2))
    gm = torch.as_tensor(ghash.ghash_matrix_packed(h[None])[0]
                         .view(np.int32)).to(dev)
    blk = torch.as_tensor(x.view(">u4").astype(np.uint32).view(np.int32)
                          ).to(dev)
    y = torch.zeros(4, dtype=torch.int32, device=dev)
    reps = 2000
    kbuild.check(lib.ljt_probe_ghash_chain(
        gm.data_ptr(), blk.data_ptr(), y.data_ptr(), cycles.data_ptr(),
        reps, stream), "probe_ghash_chain")
    torch.cuda.synchronize()
    got = y.cpu().numpy().view(np.uint32).astype(">u4").tobytes()
    require(got == ghash.ghash_ref(bytes(h), bytes(x) * reps),
            "the GHASH chain differs from the host GHASH")
    ghash_step = float(cycles.double().mean()) / reps
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
        .stdout.split()[0])
    floors = {}
    for length in sorted({HDR + m[0] for m in MIX} | {160 + HDR}):
        blocks_ = (length + 4 + 9 + 63) // 64 + 1
        floors[f"len {length}"] = dict(compressions=blocks_,
                                       ms=blocks_ * sha / (mhz * 1e3))
    for v in hmac_cycles.values():
        v["ms"] = v["cycles"] / (mhz * 1e3)
    # kernel B cannot end before its longest row's MAC on a lane alone,
    # after the launch
    b_chain_ms = floor_ms + hmac_cycles[B_LONGEST + " on 1 lane"]["ms"]
    emit("latency_floor", launch_floor_ms=floor_ms,
         launch_floor_call_ms=floor_call_ms,
         cluster_launch_floor_ms=clusters,
         sha1_compression_cycles=sha,
         aes_pair_cycles=aes_pair, sm_clock_mhz=mhz,
         hash_chain_floor=floors, hmac_row=hmac_cycles,
         hmac_sha1_chain_floor_ms=b_chain_ms, ghash_step_cycles=ghash_step)
    return floor_ms, b_chain_ms, dict(aes_pair_cycles=aes_pair, mhz=mhz,
                                      hmac_row=hmac_cycles,
                                      ghash_step_cycles=ghash_step)


def mac_floor_ms(floor_ms: float, chain: dict, msg_len: int) -> float:
    """The MAC chain floor of a tile launch whose longest MAC message is
    `msg_len` bytes (packet || ROC or SRTCP word): the launch floor plus
    that row's HMAC on a lane of a full hashing warp, reckoned from
    `hmac_row`'s cycles a compression at the probed row with the fewest
    compressions not below this one's (the longest probed row past it)."""
    comps = (msg_len + 9 + 63) // 64 + 1
    probes = sorted((v["compressions"], v["cycles"])
                    for v in chain["hmac_row"].values() if v["lanes"] == 32)
    c, cyc = next(((c, cyc) for c, cyc in probes if c >= comps), probes[-1])
    return floor_ms + comps * cyc / c / (chain["mhz"] * 1e3)


# ------------------------------------------------- 3. kernels vs plain

def kernels_vs_plain(torch, dev, kbuild, floor_ms: float,
                     b_chain_ms: float) -> dict:
    from libjitsi_tpu_torch.core.packet import bucket_by_size
    from libjitsi_tpu_torch.kernels import aes, sha1
    from libjitsi_tpu_torch.transform.srtp import kernel as sk

    rng = np.random.default_rng(3)
    rows = {}

    def record(name, shape, outs_k, outs_p, fn, reps, plain_ms, nbytes, ops,
               main=True, **extra):
        err = max_abs_err(torch, outs_k, outs_p)
        require(err == 0, f"{name} {shape} differs from its plain version")
        b_ms, b_by = bound(nbytes, ops)
        line = dict(name=name, shape=shape, max_abs_err=err,
                    ms=device_ms(torch, fn, reps, name + "_kernel"),
                    call_ms=cuda_ms(torch, fn, reps),
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    bytes=nbytes, ops=ops, **extra)
        emit("kernel_vs_plain", **line)
        if main:
            rows[name] = line
        return line

    # A: 65,536 blocks, AES-128 (the table default) and AES-256
    for key_len in (16, 32):
        n = 65536
        rk = torch.as_tensor(aes.expand_keys_batch(
            rng.integers(0, 256, (n, key_len), np.uint8))).to(dev)
        blocks = torch.as_tensor(rng.integers(0, 256, (n, 16),
                                              np.uint8)).to(dev)
        nr = rk.shape[1] - 1
        k = aes.aes_encrypt(rk, blocks)
        p = aes.aes_encrypt_plain(rk, blocks)
        record("aes_encrypt", f"{n}x16 AES-{key_len * 8}", [k], [p],
               lambda: aes.aes_encrypt(rk, blocks), 200,
               cuda_ms(torch, lambda: aes.aes_encrypt_plain(rk, blocks), 5),
               n * (16 + (nr + 1) * 16 + 16), n * aes_block_ops(nr),
               main=key_len == 16)

    # B: 4,096 x 1,504, the production mix of MAC message lengths, and
    # the SFU's 1,100 rows
    for n, width in ((4096, 1504), (SFU_N, 1504)):
        lens = np.minimum(production_lengths(rng, n) + HDR + 4, width)
        lens[0] = MIX[-1][0] + HDR + 4      # the longest message, 966
        mid = torch.as_tensor(sha1.hmac_precompute_batch(
            rng.integers(0, 256, (n, 20), np.uint8)).view(np.int32)).to(dev)
        data = torch.as_tensor(rng.integers(0, 256, (n, width),
                                            np.uint8)).to(dev)
        ln = torch.as_tensor(lens.astype(np.int32)).to(dev)
        blocks = int(((lens + 9 + 63) // 64).sum()) + n
        tags = sha1.hmac_sha1(mid, data, ln)
        record("hmac_sha1", f"{n}x{width} mixed lengths",
               [tags], [sha1.hmac_sha1_plain(mid, data, ln)],
               lambda: sha1.hmac_sha1(mid, data, ln), 50,
               cuda_ms(torch, lambda: sha1.hmac_sha1_plain(mid, data, ln),
                       2, 1),
               int(lens.sum()) + n * (40 + 4 + 20),
               blocks * SHA1_BLOCK_OPS, main=n == 4096,
               chain_floor_ms=b_chain_ms, launch_floor_ms=floor_ms)

    # C and D: the bench headline shape, then the three launches the
    # table path makes for one 4,096-packet production-mix batch: the
    # parts `bucket_by_size` gives, row counts padded to a row class by
    # repeating real rows, each width its size class plus 32 bytes
    tab_rk = torch.as_tensor(aes.expand_keys_batch(
        rng.integers(0, 256, (N_STREAMS, 16), np.uint8))).to(dev)
    tab_mid = torch.as_tensor(sha1.hmac_precompute_batch(
        rng.integers(0, 256, (N_STREAMS, 20), np.uint8)).view(
            np.int32)).to(dev)
    n = 65536
    cases = [("65536x192 len 172 (bench headline)",
              rng.integers(0, N_STREAMS, n),
              rng.integers(0, 256, (n, 192), np.uint8),
              np.full(n, 160 + HDR, np.int32), False)]
    mix = _mix_batch(rng, rng.permutation(N_STREAMS)[:BATCH], 1000, 0)
    parts = []
    for _rows, part, n_real in bucket_by_size(mix):
        n = len(part.length)
        parts.append(f"{n}x{part.capacity} ({n_real} real rows)")
        cases.append((f"{n}x{part.capacity}, {n_real} real rows (table "
                      f"path)", part.stream, part.data, part.length, True))
    totals = {"srtp_protect_cm": [0.0, 0.0, 0.0, 0, 0],
              "srtp_unprotect_cm": [0.0, 0.0, 0.0, 0, 0]}
    for label, stream, raw, length, main in cases:
        n, width = raw.shape
        args = [tab_rk, tab_mid,
                torch.as_tensor(stream.astype(np.int32)).to(dev),
                torch.as_tensor(raw).to(dev),
                torch.as_tensor(length.astype(np.int32)).to(dev),
                torch.full((n,), HDR, dtype=torch.int32, device=dev),
                torch.as_tensor(rng.integers(0, 256, (n, 16),
                                             np.uint8)).to(dev),
                torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, n)
                                .astype(np.int32)).to(dev)]
        ks_blocks = int(((length - HDR + 15) // 16).sum())
        mac_blocks = int(((length + 4 + 9 + 63) // 64).sum()) + n
        ops = (ks_blocks * (aes_block_ops(10) + CTR_XOR_OPS)
               + mac_blocks * SHA1_BLOCK_OPS)
        keys = len(np.unique(stream)) * (11 * 16 + 40)
        nbytes = 2 * n * width + n * (5 * 4 + 16) + keys
        reps = 50 if n * width < 4e7 else 20
        kp = sk.srtp_protect(*args, TAG)
        pp = sk.srtp_protect_plain(*args, TAG)
        pms_p = cuda_ms(torch, lambda: sk.srtp_protect_plain(*args, TAG), 2, 1)
        lp = record("srtp_protect_cm", label, list(kp), list(pp),
                    lambda: sk.srtp_protect(*args, TAG), reps, pms_p,
                    nbytes, ops, main=False)
        uargs = args[:3] + [kp[0], kp[1]] + args[5:]
        ku = sk.srtp_unprotect(*uargs, TAG)
        pu = sk.srtp_unprotect_plain(*uargs, TAG)
        require(bool(ku[2].all()), f"kernel D rejected genuine rows ({label})")
        pms_u = cuda_ms(torch, lambda: sk.srtp_unprotect_plain(*uargs, TAG),
                        2, 1)
        lu = record("srtp_unprotect_cm", label, list(ku), list(pu),
                    lambda: sk.srtp_unprotect(*uargs, TAG), reps, pms_u,
                    nbytes, ops, main=False)
        if main:
            for name, line in (("srtp_protect_cm", lp),
                               ("srtp_unprotect_cm", lu)):
                acc = totals[name]
                acc[0] += line["ms"]
                acc[1] += line["call_ms"]
                acc[2] += line["plain_ms"]
                acc[3] += nbytes
                acc[4] += ops
    for name, (ms, call_ms, pms, nbytes, ops) in totals.items():
        b_ms, b_by = bound(nbytes, ops)
        rows[name] = dict(name=name, max_abs_err=0, ms=ms, call_ms=call_ms,
                          plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                          shape=f"one {BATCH}-packet production-mix batch "
                                f"as the table buckets it, "
                                f"{len(parts)} launches: "
                                + " + ".join(parts))
    return rows


# --------------------------------------------------------- 4. table path

def _mix_batch(rng, streams, seq: int, ts: int):
    from libjitsi_tpu_torch.rtp import header as rtp_header

    lens = production_lengths(rng, len(streams))
    payloads = [rng.integers(0, 256, int(k), np.uint8).tobytes()
                for k in lens]
    return rtp_header.build(payloads, [seq] * len(streams),
                            [ts] * len(streams), (0x10000 + streams).tolist(),
                            [96] * len(streams), stream=streams.tolist())


def profile_table(torch, tx, rx, batch) -> None:
    """One production-mix batch through protect, then unprotect, each
    under torch.profiler: its host-clock time, the table's spans
    (host work is the call's span less its upload, kernel and download
    spans) and the card's busy time by kernel and copy.  Device fields
    are null if the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    arg = batch
    for table, direction in ((tx, "protect_rtp"), (rx, "unprotect_rtp")):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = getattr(table, direction)(arg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans, device = {}, {}
        for e in prof.events():
            if e.name.startswith("srtp."):
                if e.device_type == DeviceType.CPU:
                    spans[e.name] = spans.get(e.name, 0.0) + \
                        e.cpu_time_total / 1e3
            elif e.device_type == DeviceType.CUDA:
                m = re.search(r"(\w+)_kernel", e.name)
                key = m.group(1) if m else e.name
                device[key] = device.get(key, 0.0) + \
                    e.time_range.elapsed_us() / 1e3
        parts = ("srtp.upload", "srtp.kernel", "srtp.download")
        busy = sum(device.values()) if device else None
        emit("profile", direction=direction, wall_ms=wall_ms,
             spans_ms=spans, host_ms=spans.get("srtp." + direction, 0.0)
             - sum(spans.get(k, 0.0) for k in parts),
             device_ms=device, device_busy_ms=busy,
             device_idle_share=None if busy is None else 1 - busy / wall_ms)
        if direction == "protect_rtp":
            arg = res
        else:
            require(res[1].all(), "a genuine row failed under the profiler")


def table_path(torch, dev) -> dict:
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.kernels.aes import ctr_keystream_np, expand_key
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.kdf import derive_session_keys

    rng = np.random.default_rng(9)
    mks = rng.integers(0, 256, (N_STREAMS, 16), np.uint8)
    mss = rng.integers(0, 256, (N_STREAMS, 14), np.uint8)
    t0 = time.perf_counter()
    tx = SrtpStreamTable(N_STREAMS, device=dev)
    rx = SrtpStreamTable(N_STREAMS, device=dev)
    tx.add_streams(np.arange(N_STREAMS), mks, mss)
    rx.add_streams(np.arange(N_STREAMS), mks, mss)
    install_s = time.perf_counter() - t0
    prot_s, unprot_s = [], []
    sent = []
    before = dict(kbuild.launches)
    for k in range(8):
        streams = rng.permutation(N_STREAMS)[:BATCH]
        batch = _mix_batch(rng, streams, 1000 + k, k * 960)
        t1 = time.perf_counter()
        wire = tx.protect_rtp(batch)
        t2 = time.perf_counter()
        dec, ok = rx.unprotect_rtp(wire)
        t3 = time.perf_counter()
        prot_s.append(t2 - t1)
        unprot_s.append(t3 - t2)
        require(ok.all(), f"batch {k}: {int((~ok).sum())} genuine rows failed")
        require(dec.to_payloads() == batch.to_payloads(),
                f"batch {k}: decrypted bytes differ from the sent packets")
        sent.append((batch, wire))
    per_batch = {k: (kbuild.launches[k] - before[k]) / len(sent)
                 for k in before}
    # independent oracle: tags and keystream of 16 wire packets from the
    # stdlib HMAC and the host NumPy AES with the derived session keys
    batch, wire = sent[0]
    for i in range(16):
        sid = int(batch.stream[i])
        ks = derive_session_keys(mks[sid].tobytes(), mss[sid].tobytes())
        n = int(wire.length[i])
        pkt = wire.data[i, :n].tobytes()
        tag = hmac.new(ks.rtp_auth, pkt[:-TAG] + bytes(4),
                       hashlib.sha1).digest()[:TAG]
        require(tag == pkt[-TAG:], "wire tag differs from stdlib HMAC")
        salt = np.zeros(16, np.uint8)
        salt[:14] = np.frombuffer(ks.rtp_salt, np.uint8)
        iv = salt.copy()
        iv[4:8] ^= np.frombuffer((0x10000 + sid).to_bytes(4, "big"), np.uint8)
        iv[12:14] ^= np.frombuffer(int(1000).to_bytes(2, "big"), np.uint8)
        stream_ = ctr_keystream_np(expand_key(ks.rtp_enc), iv, n - TAG - HDR)
        clear = np.frombuffer(pkt[HDR:-TAG], np.uint8) ^ stream_
        require(np.array_equal(clear, batch.data[i, HDR:n - TAG]),
                "wire ciphertext differs from the host NumPy AES-CM")
    profile_table(torch, tx, rx, _mix_batch(
        rng, rng.permutation(N_STREAMS)[:BATCH], 1500, 50 * 960))
    # a 1% tampered subset of a fresh batch: exactly those rows fail
    streams = rng.permutation(N_STREAMS)[:BATCH]
    batch = _mix_batch(rng, streams, 2000, 99 * 960)
    wire = tx.protect_rtp(batch)
    bad = rng.choice(BATCH, BATCH // 100, replace=False)
    tampered = PacketBatch(wire.data.copy(), wire.length.copy(),
                           wire.stream.copy())
    tampered.data[bad, HDR + 1] ^= 0x5A
    dec, ok = rx.unprotect_rtp(tampered)
    want = np.ones(BATCH, bool)
    want[bad] = False
    require(np.array_equal(ok, want), "tampered rows are not exactly the "
                                      "rows with ok=False")
    require(all(dec.to_bytes(int(i)) == tampered.to_bytes(int(i))
                for i in bad), "rejected rows did not keep their original "
                               "bytes")
    # the last genuine batch again: every row a replay
    _, ok = rx.unprotect_rtp(sent[-1][1])
    require(not ok.any(), "a replayed batch was accepted")
    pps = [BATCH / (a + b) for a, b in zip(prot_s, unprot_s)]
    host_ms = dict(protect_ms_p50=float(np.median(prot_s)) * 1e3,
                   protect_ms_p99=float(np.percentile(prot_s, 99)) * 1e3,
                   unprotect_ms_p50=float(np.median(unprot_s)) * 1e3,
                   unprotect_ms_p99=float(np.percentile(unprot_s, 99))
                   * 1e3)
    emit("table_path", streams=N_STREAMS, batches=len(prot_s), batch=BATCH,
         install_s=install_s, **host_ms,
         roundtrip_pps_p50=float(np.median(pps)),
         launches_per_batch=per_batch,
         tampered_rows=int(len(bad)), tampered_rejected=True,
         replay_rejected=BATCH)
    return {"mks": mks, "mss": mss, "launches_per_batch": per_batch,
            **host_ms}


def srtp_echo(torch, dev) -> dict:
    table = table_path(torch, dev)
    echo_loop(torch, dev, table)
    return table


# ---------------------------------------------------------- 5. echo loop

def echo_loop(torch, dev, keys) -> None:
    """The `MediaLoop` echo bridge over UDP loopback at each of
    ECHO_DEPTHS: 10,240 installed streams, ECHO_ROUNDS timed rounds of a
    4,096-packet production mix sent in ECHO_BURST-packet bursts, each
    burst ticked until the bridge took it, then one round with the
    PhaseProfiler fencing every tick; at depth > 1 the unprotect of a
    tick materializes depth - 1 ticks later and its replies leave on the
    tick after, and every round ends with `drain()`.  Every depth gets
    fresh tables with the same keys and the same client wire, and must
    echo every packet once, in each stream's order, authenticated by the
    client and with the sent payloads, its wire byte-equal to the depth-1
    run's.  Each depth prints the echo tick p50/p99 (the timed rounds'
    full-burst ticks, none fenced), the journey p50/p99 (exact, from the
    timed rounds' journey observations) beside its 1 ms budget, and the
    PhaseProfiler's phase shares over the fenced round's ticks."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.io.loop import MediaLoop
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.service.media_stream import StreamRegistry
    from libjitsi_tpu_torch.transform.engine import TransformEngineChain
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.engine import SrtpTransformEngine
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
    from libjitsi_tpu_torch.utils.perf import PHASES

    rng = np.random.default_rng(17)
    sids = np.arange(N_STREAMS)
    up_k, up_s = keys["mks"], keys["mss"]                 # client -> bridge
    dn_k = rng.integers(0, 256, (N_STREAMS, 16), np.uint8)  # bridge -> client
    dn_s = rng.integers(0, 256, (N_STREAMS, 14), np.uint8)
    c_tx = SrtpStreamTable(N_STREAMS, device=dev)
    c_tx.add_streams(sids, up_k, up_s)
    rounds = []
    for rnd in range(ECHO_ROUNDS + 1):
        streams = rng.permutation(N_STREAMS)[:BATCH]
        lens = production_lengths(rng, BATCH)
        payloads = [rng.integers(0, 256, int(k), np.uint8).tobytes()
                    for k in lens]
        plain = rtp_header.build(
            payloads, [7 + rnd] * BATCH, [rnd * 960] * BATCH,
            (0x20000 + streams).tolist(), [96] * BATCH,
            stream=streams.tolist())
        rounds.append((plain, c_tx.protect_rtp(plain)))

    with open("/proc/sys/net/core/rmem_max") as f:
        rmem_max = int(f.read())
    wire_of = {}
    for depth in ECHO_DEPTHS:
        reg = StreamRegistry(N_STREAMS, device=dev)
        b_tx, b_rx = reg.srtp_tables(SrtpProfile.AES_CM_128_HMAC_SHA1_80)
        b_rx.add_streams(sids, up_k, up_s)
        b_tx.add_streams(sids, dn_k, dn_s)
        for sid in sids:
            reg.map_ssrc(0x20000 + int(sid), int(sid))
        c_rx = SrtpStreamTable(N_STREAMS, device=dev)
        c_rx.add_streams(sids, dn_k, dn_s)
        chain = TransformEngineChain([SrtpTransformEngine(b_tx, b_rx)])
        tick_s, echoed, wires = [], 0, []
        journeys = []
        tick_launches = dict.fromkeys(kbuild.launches, 0)
        with UdpEngine(port=0, bind_ip="127.0.0.1",
                       max_batch=ECHO_BURST) as b_eng, \
                UdpEngine(port=0, bind_ip="127.0.0.1",
                          max_batch=ECHO_BURST) as client:
            bridge = _keep(f"srtp_echo depth {depth}", MediaLoop(
                b_eng, reg, on_media=_echo_rows, chain=chain,
                pipeline_depth=depth, phase_sample_every=0))
            note = bridge.note_journey_at

            def noted(origin, n, sids=None, note=note):
                dt = note(origin, n, sids=sids)
                if dt is not None:
                    journeys.append((dt, n))
                return dt

            bridge.note_journey_at = noted

            def collect(back, want, tries, timeout_ms):
                for _ in range(tries):
                    b, _, _ = client.recv_batch(timeout_ms=timeout_ms)
                    back += b.to_payloads()
                    if len(back) >= want or (timeout_ms == 0
                                             and not b.batch_size):
                        break

            for rnd, (plain, wire) in enumerate(rounds):
                timed = rnd < ECHO_ROUNDS
                if not timed:
                    # the fenced round: every tick pays the probes
                    n_journeys = len(journeys)
                    bridge.perf.sample_every = 1
                back = []
                for lo in range(0, BATCH, ECHO_BURST):
                    rows = np.arange(lo, min(lo + ECHO_BURST, BATCH))
                    require(client.send_rows(wire, rows, "127.0.0.1",
                                             b_eng.port) == len(rows),
                            "client send was short")
                    got = 0
                    for _ in range(200):
                        pre = dict(kbuild.launches)
                        t1 = time.perf_counter()
                        n = bridge.tick()
                        dt = time.perf_counter() - t1
                        if n and timed:
                            tick_s.append((n, dt))
                            for k in pre:
                                tick_launches[k] += (kbuild.launches[k]
                                                     - pre[k])
                        got += n
                        if got >= len(rows):
                            break
                    require(got == len(rows), "bridge did not receive a "
                            f"burst (net.core.rmem_max {rmem_max})")
                    collect(back, BATCH, 64, 0)
                bridge.drain()
                require(not bridge._rx_inflight and not bridge._inflight,
                        "the drain left work in flight")
                collect(back, BATCH, 400, 5)
                require(len(back) == BATCH, f"depth {depth} round {rnd}: "
                        f"echoed {len(back)} of {BATCH} packets")
                echo = PacketBatch.from_payloads(back, capacity=1536)
                hdr = rtp_header.parse(echo)
                require(len(set(zip(hdr.ssrc.tolist(), hdr.seq.tolist())))
                        == BATCH and bool((hdr.seq == 7 + rnd).all()),
                        f"depth {depth} round {rnd}: a packet was echoed "
                        "twice or out of its stream's order")
                echo.stream[:] = (hdr.ssrc - 0x20000).astype(np.int32)
                dec, ok = c_rx.unprotect_rtp(echo)
                require(ok.all(), "client could not authenticate the echo")
                require(sorted(dec.to_payloads())
                        == sorted(plain.to_payloads()),
                        "echoed payloads differ from the sent ones")
                wires.append(sorted(back))
                echoed += len(back)
        wire_of[depth] = wires
        require(wires == wire_of[ECHO_DEPTHS[0]],
                f"depth {depth}: the echo's wire differs from depth "
                f"{ECHO_DEPTHS[0]}'s")
        full = np.array([dt for n, dt in tick_s if n == ECHO_BURST])
        require(len(full), "no timed tick received a whole burst")
        journeys = journeys[:n_journeys]
        jd = np.array([dt for dt, n in journeys])
        jw = np.array([n for dt, n in journeys], dtype=np.float64)
        order = np.argsort(jd)
        cw = np.cumsum(jw[order]) / jw.sum()

        def jq(q):
            return float(jd[order][np.searchsorted(cw, q)]) * 1e3

        phases = bridge.perf.phase_totals
        total = sum(phases.values())
        emit("echo_loop", depth=depth, streams=N_STREAMS, burst=ECHO_BURST,
             packets=(ECHO_ROUNDS + 1) * BATCH, timed_rounds=ECHO_ROUNDS,
             echoed=echoed,
             ticks=bridge.ticks, busy_ticks=len(tick_s),
             full_burst_ticks=len(full),
             tick_ms_p50=float(np.median(full)) * 1e3,
             tick_ms_p99=float(np.percentile(full, 99)) * 1e3,
             journey_ms_p50=jq(0.5), journey_ms_p99=jq(0.99),
             journey_budget_ms=1.0, journeys_observed=int(jw.sum()),
             journey_p99_bucket_s=_journey_p99_bucket(bridge.journey_hist),
             fenced_ticks=bridge.perf.sampled_ticks,
             phase_share={p: phases.get(p, 0.0) / total for p in PHASES},
             phase_ms_per_fenced_tick={
                 p: phases.get(p, 0.0) / bridge.perf.sampled_ticks * 1e3
                 for p in PHASES},
             arena_grows=b_eng.arena_grows,
             launches_per_tick={k: v / len(tick_s)
                                for k, v in tick_launches.items()},
             rx_packets=bridge.rx_packets, tx_packets=bridge.tx_packets,
             rmem_max=rmem_max, wire_equal_to_depth1=True)


# ------------------------------------------- 6. mix and G.711 kernels

def timings(torch, fn, kernel, plain, library=None) -> dict:
    """A small kernel's time on the card (`ms`, the profiler's duration of
    `kernel`) and per back-to-back call through its wrapper (`call_ms`,
    CUDA events), beside its plain version's and the library call's, each
    per call and as device work alone."""
    out = dict(ms=device_ms(torch, fn, 50, kernel),
               call_ms=cuda_ms(torch, fn, 200),
               plain_ms=cuda_ms(torch, plain, 20),
               plain_device_ms=device_ms(torch, plain, 20))
    if library is not None:
        out.update(library_ms=cuda_ms(torch, library, 200),
                   library_device_ms=device_ms(torch, library, 50))
    return out


def _edge_frames(rng, c, n, f):
    """Random frames with an all-zero row, an inactive row, near-silent
    rows (1, 2 and 5 samples of ±1) and saturating rows, as far as the
    conference has rows."""
    pcm = rng.integers(-32768, 32768, (c, n, f)).astype(np.int16)
    active = rng.random((c, n)) < 0.8
    pcm[:, 0] = 0
    active[:, 1:2] = False
    for row, k in ((2, 1), (3, 2), (4, 5)):
        if row < n:
            k = min(k, f)
            pcm[:, row] = 0
            pcm[:, row, rng.choice(f, k, replace=False)] = rng.choice([-1, 1],
                                                                     k)
    pcm[:, 5:7] = 32767
    pcm[:, 7:8] = -32768
    active[:, [r for r in (0, 2, 3, 4, 5, 6, 7) if r < n]] = True
    return pcm, active


def mix_kernel(torch, dev, floor_ms: float) -> dict:
    """Kernel E against its plain version, both on the card, at the
    AudioMixer's, the conference bridge's and the MixerBridge's shapes
    (timed, with the launch plan), then at the shapes its staged kernel
    takes (timed, and on the CPU too), then byte for byte at ragged shapes,
    on views at an odd offset, at conferences taller than one stage of
    rows (a cluster of 16, clusters of 8) and at a frame too wide for one
    block, each with its plan, then the constant-amplitude sweep (32,767
    rows, also staged) on the card against the plain version on the
    CPU."""
    from libjitsi_tpu_torch.conference import mixer
    from libjitsi_tpu_torch.kernels import build as kbuild

    rng = np.random.default_rng(31)
    rows = {}
    for c, n, f in MIX_SHAPES:
        pcm, active = _edge_frames(rng, c, n, f)
        p, a = torch.as_tensor(pcm).to(dev), torch.as_tensor(active).to(dev)
        err = max_abs_err(torch, mixer.mix_minus_many(p, a),
                          mixer.mix_minus_many_plain(p, a))
        require(err == 0, f"kernel E {c}x{n}x{f} differs from its plain "
                          "version")
        nbytes = 2 * c * n * f * 2 + 2 * c * n
        b_ms, b_by = bound(nbytes, 0)
        line = dict(name="mix_minus", shape=f"{c}x{n}x{f}", max_abs_err=err,
                    **timings(torch, lambda: mixer.mix_minus_many(p, a),
                              "mix_minus_kernel",
                              lambda: mixer.mix_minus_many_plain(p, a)),
                    bound_ms=b_ms, bound_by=b_by, launch_floor_ms=floor_ms,
                    library_ms=None, bytes=nbytes,
                    plan=mix_plan(kbuild, c, n, f))
        emit("kernel_vs_plain", **line)
        if (c, n, f) == (1, CONF_PARTIES, 160):
            rows["mix_minus"] = dict(line, shape=f"{c}x{n}x{f} (the "
                                     "conference bridge's tick)")
    # the staged kernel: 65,540 rows, a frame wider than 16 blocks stage
    # one row of, and [1, 131,076, 1] with every column total past
    # 2**31 - 1 (all 32,767 but row 0: the exact clip is 32,767); the
    # tall conferences in row groups over a cluster of 16
    for c, n, f in MIX_STAGED:
        if f == 1:
            pcm = np.full((c, n, f), 32767, np.int16)
            pcm[:, 0] = 0
            active = np.ones((c, n), bool)
        else:
            pcm, active = _edge_frames(rng, c, n, f)
        p, a = torch.as_tensor(pcm).to(dev), torch.as_tensor(active).to(dev)
        got = mixer.mix_minus_many(p, a)
        err = max(max_abs_err(torch, got, mixer.mix_minus_many_plain(p, a)),
                  max_abs_err(torch, [x.cpu() for x in got],
                              mixer.mix_minus_many_plain(
                                  torch.as_tensor(pcm),
                                  torch.as_tensor(active))))
        require(err == 0, f"kernel E {c}x{n}x{f} differs from its plain "
                          "version")
        if f == 1:
            require(bool((got[0] == 32767).all()),
                    "kernel E: not the exact clip past 2**31 - 1")
        plan = mix_plan(kbuild, c, n, f)
        require(plan["staged_kernel"] == 1, f"kernel E {c}x{n}x{f}: not "
                                            "the staged kernel")
        require(n <= 65535 or plan["row_groups"] == 16,
                f"kernel E {c}x{n}x{f}: not in 16 row groups")
        nbytes = 2 * c * n * f * 2 + 2 * c * n
        b_ms, b_by = bound(nbytes, 0)
        emit("kernel_vs_plain", name="mix_minus", shape=f"{c}x{n}x{f}",
             max_abs_err=err,
             **timings(torch, lambda: mixer.mix_minus_many(p, a),
                       "mix_minus_staged_kernel",
                       lambda: mixer.mix_minus_many_plain(p, a)),
             bound_ms=b_ms, bound_by=b_by, launch_floor_ms=floor_ms,
             library_ms=None, bytes=nbytes, plan=plan,
             exact_clip_past_int32=f == 1)
    # ragged rows (the 2-byte path), pcm at an odd element offset, rows
    # in stages and a frame wider than one block stages
    edges = {}
    for c, n, f, off in ((1, 257, 161, 0), (3, 33, 70, 0), (1, 1, 1, 0),
                         (1, CONF_PARTIES, 160, 1), (64, 64, 960, 1),
                         (1, 2000, 960, 0), (20, 1000, 960, 0),
                         (300, 3, 12000, 0)):
        pcm, active = _edge_frames(rng, c, n, f)
        flat = torch.zeros(c * n * f + 8, dtype=torch.int16, device=dev)
        p = flat[off:off + c * n * f].view(c, n, f)
        p.copy_(torch.as_tensor(pcm))
        a = torch.as_tensor(active).to(dev)
        got = mixer.mix_minus_many(p, a)
        err = max(max_abs_err(torch, got, mixer.mix_minus_many_plain(p, a)),
                  max_abs_err(torch, [x.cpu() for x in got],
                              mixer.mix_minus_many_plain(
                                  torch.as_tensor(pcm),
                                  torch.as_tensor(active))))
        key = f"{c}x{n}x{f}" + (f" at offset {off}" if off else "")
        require(err == 0, f"kernel E {key} differs from its plain version")
        plan = mix_plan(kbuild, c, n, f)
        edges[key] = dict(max_abs_err=err, plan=dict(
            plan, vec=plan["vec"] if off == 0 else 0))
    for key, rows_, cs in (("1x2000x960", 2000, 16), ("20x1000x960", 1000, 8)):
        require(edges[key]["plan"]["staged_rows"] < rows_
                and edges[key]["plan"]["cluster"] == cs,
                f"kernel E {key}: not the staged plan it is there to run")
    require(edges["300x3x12000"]["plan"]["cluster"] > 1,
            "kernel E 300x3x12000: a frame one block cannot stage")
    emit("mix_edges", shapes=edges)
    sweep = {}
    for f in (960, 160):
        pcm = np.repeat(np.arange(1, 32768, dtype=np.int32)[:, None], f,
                        axis=1).astype(np.int16)[None]
        pcm[0, 1::2] *= -1
        card = mixer.mix_minus_many(torch.as_tensor(pcm).to(dev))
        host = mixer.mix_minus_many(torch.as_tensor(pcm))
        require(all(torch.equal(x.cpu(), y) for x, y in zip(card, host)),
                f"amplitude sweep at F={f}: card differs from the CPU")
        sweep[f] = [int(card[1][0, 0]), int(card[1][0, -1])]
    emit("mix_sweep", amplitudes="1..32767", levels_at_1_and_32767=sweep,
         plans={f: mix_plan(kbuild, 1, 32767, f) for f in (960, 160)},
         equal_to_cpu_plain=True)
    return rows


def g711_kernels(torch, dev, floor_ms: float) -> dict:
    """Kernels F and G against their plain versions on every int16 input
    and every code, both also at ragged lengths and on views at odd
    offsets (their one-sample and one-code paths; G's out too), then
    timed at the bridge's [256, 160] and at a 10,240-stream [10240, 160],
    each compared there, with `torch.take` as G's library call."""
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.kernels import g711

    pcm_all = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    codes_all = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    plain = {(g711.ULAW, "enc"): g711.ulaw_encode_plain,
             (g711.ALAW, "enc"): g711.alaw_encode_plain,
             (g711.ULAW, "dec"): g711.ulaw_decode_plain,
             (g711.ALAW, "dec"): g711.alaw_decode_plain}
    for law in (g711.ULAW, g711.ALAW):
        for kind, kern, x in (("enc", g711.encode, pcm_all),
                              ("dec", g711.decode, codes_all)):
            got = kern(x.to(dev), law)
            require(torch.equal(got, plain[law, kind](x.to(dev)))
                    and torch.equal(got.cpu(), plain[law, kind](x)),
                    f"G.711 law {law} {kind}: kernel differs from plain")
        want = plain[law, "enc"](pcm_all)
        for off, n in ((0, 65533), (1, 65536), (3, 65531)):
            flat = torch.zeros(65536 + 8, dtype=torch.int16, device=dev)
            flat[off:off + n] = pcm_all[:n].to(dev)
            got = g711.encode(flat[off:off + n], law)
            require(torch.equal(got.cpu(), want[:n]),
                    f"G.711 law {law} encode: length {n} at offset {off} "
                    "differs from plain")
        # G at a ragged length and on views off a 16-byte boundary (its
        # one-code path), codes and out
        want = plain[law, "dec"](codes_all.repeat(40))
        for off, n in ((0, 10237), (1, 10240), (3, 4099)):
            flat = torch.zeros(10240 + 32, dtype=torch.uint8, device=dev)
            flat[off:off + n] = codes_all.repeat(40)[:n].to(dev)
            got = g711.decode(flat[off:off + n], law)
            out = torch.full((10240 + 32,), -7, dtype=torch.int16,
                             device=dev)
            kbuild.check(kbuild.library().ljt_g711_decode(
                flat[off:].data_ptr(), out[5:].data_ptr(), n, law,
                kbuild.stream_handle(dev)), "g711_decode")
            require(torch.equal(got.cpu(), want[:n])
                    and torch.equal(out[5:5 + n].cpu(), want[:n])
                    and bool((out[:5] == -7).all())
                    and bool((out[5 + n:] == -7).all()),
                    f"G.711 law {law} decode: length {n} at offset {off} "
                    "differs from plain")
    u8060 = g711.ulaw_encode(torch.tensor([8060, -8060], dtype=torch.int16,
                                          device=dev)).tolist()
    require(u8060 == [159, 31], f"µ-law 8060, -8060 encode to {u8060}, "
                                "not the spec's 159, 31")
    emit("g711_exhaustive", pcm_inputs=65536, codes=256, laws=2,
         max_abs_err=0, encode_ragged_and_odd_offsets=[[0, 65533], [1, 65536],
                                                       [3, 65531]],
         decode_ragged_and_odd_offsets=[[0, 10237], [1, 10240], [3, 4099]],
         decode_out_offset=5,
         ulaw_8060=u8060)
    rng = np.random.default_rng(37)
    rows = {}
    for n in (CONF_PARTIES, 10_240):
        shape = f"{n}x160 µ-law"
        pcm = torch.as_tensor(rng.integers(-32768, 32768, (n, 160))
                              .astype(np.int16)).to(dev)
        codes = torch.as_tensor(rng.integers(0, 256, (n, 160))
                                .astype(np.uint8)).to(dev)
        lut = g711.decode_table(g711.ULAW, dev)
        b_ms, b_by = bound(n * 160 * 3, 0)
        err = {k: max_abs_err(torch, [fn(x)], [pl(x)]) for k, fn, pl, x in (
            ("enc", g711.ulaw_encode, g711.ulaw_encode_plain, pcm),
            ("dec", g711.ulaw_decode, g711.ulaw_decode_plain, codes))}
        require(err == {"enc": 0, "dec": 0},
                f"G.711 at {shape} differs from plain: {err}")
        enc = dict(name="g711_encode", shape=shape, max_abs_err=0,
                   **timings(torch, lambda: g711.ulaw_encode(pcm),
                             "g711_encode_kernel",
                             lambda: g711.ulaw_encode_plain(pcm)),
                   bound_ms=b_ms, bound_by=b_by, launch_floor_ms=floor_ms,
                   library_ms=None)
        dec = dict(name="g711_decode", shape=shape, max_abs_err=0,
                   **timings(torch, lambda: g711.ulaw_decode(codes),
                             "g711_decode_kernel",
                             lambda: g711.ulaw_decode_plain(codes),
                             lambda: torch.take(lut, codes.long())),
                   bound_ms=b_ms, bound_by=b_by, launch_floor_ms=floor_ms)
        for line in (enc, dec):
            emit("kernel_vs_plain", **line)
            if n == CONF_PARTIES:
                rows[line["name"]] = dict(line, shape=shape + " (the "
                                          "conference bridge's tick)")
    return rows


def _r_input(torch, dev, rng, b: int, rate_in: int):
    """R's input at a shape: 20 ms rows of noise, row 0 at +32,767 and row
    1 at -32,768 where there are rows."""
    x = rng.integers(-32768, 32768, (b, rate_in // 50)).astype(np.int16)
    x[:1], x[1:2] = 32767, -32768
    return torch.as_tensor(x).to(dev)


def _r_conv_yardstick(torch, x, l: int, m: int):
    """cuDNN's one-call form of R's sum at an integer ratio, or None at any
    other: `conv1d` over the row padded by replication (7 left, 8 right:
    the clamped edges) with the bank's rows flipped as its weight, L output
    channels at stride 1 for L/1, stride M for 1/M.  Returns the call (its
    input padded and float beforehand, outside the timing) and its output
    as R's int16 rows (interleaved, rounded and clamped)."""
    import torch.nn.functional as F

    from libjitsi_tpu_torch.kernels import resample as rs

    if l != 1 and m != 1:
        return None
    b, t = x.shape
    xp = F.pad(x.float()[:, None], (7, 8), mode="replicate")
    w = torch.as_tensor(rs.design(l, m)[:, ::-1].copy()).to(x.device)[:, None]

    def call():
        return F.conv1d(xp, w, stride=m)

    def as_r():
        y = call().transpose(1, 2).reshape(b, -1)[:, :t * l // m]
        return y.round().clamp(-32768, 32767).to(torch.int16)

    return call, as_r


def resample_kernels(torch, dev, floor_ms: float) -> dict:
    """Kernel R against its plain version at RESAMPLE_SHAPES (`_r_input`),
    each timed, with its bound: 2 bytes a sample in and out against 16
    FMAs an output sample.  At the integer ratios its library time is one
    cuDNN `conv1d` call that computes the same clamped-edge sum
    (`_r_conv_yardstick`, float32 with TF32 off), with its largest
    difference from R: a yardstick, not an equality (cuDNN sums the taps
    in its own order).  At 160/147 and 147/160 no single PyTorch call
    computes the polyphase sum, and `library_ms` is None."""
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.kernels import resample as rs

    rng = np.random.default_rng(43)
    ptx = {k: v for k, v in ptxas_usage(kbuild).items()
           if k.startswith("resample")}
    rows = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for b, ri, ro in RESAMPLE_SHAPES:
            x = _r_input(torch, dev, rng, b, ri)
            t = x.shape[1]
            l, m = rs.ratio(ri, ro)
            out_len = t * l // m
            got = rs.resample(x, ri, ro)
            err = max_abs_err(torch, [got], [rs.resample_plain(x, l, m)])
            shape = (f"[{b},{t}] -> [{b},{out_len}] ({ri} -> {ro} Hz, L/M "
                     f"{l}/{m})")
            require(err == 0, f"kernel R at {shape} differs from plain: "
                              f"{err}")
            nbytes, fmas = 2 * b * (t + out_len), 16 * b * out_len
            b_ms, b_by = bound_fp32(nbytes, fmas)
            conv = _r_conv_yardstick(torch, x, l, m)
            if conv is None:
                lib = dict(library="none: no single PyTorch call computes "
                                   "the polyphase sum at L/M "
                                   f"{l}/{m}")
            else:
                lib = dict(library="torch.nn.functional.conv1d (cuDNN, "
                                   "TF32 off) on the replicate-padded row",
                           library_max_abs_err_vs_r=max_abs_err(
                               torch, [conv[1]()], [got]))
            line = dict(name="resample", shape=shape, max_abs_err=err,
                        **timings(torch, lambda: rs.resample(x, ri, ro),
                                  "resample",
                                  lambda: rs.resample_plain(x, l, m),
                                  None if conv is None else conv[0]),
                        bound_ms=b_ms, bound_by=b_by,
                        launch_floor_ms=floor_ms, **lib, bytes=nbytes,
                        fmas=fmas, ptxas=ptx)
            line.setdefault("library_ms", None)
            emit("kernel_vs_plain", **line)
            if (b, ri, ro) == RESAMPLE_SHAPES[0]:
                rows["resample"] = dict(line, shape=shape + " (the mixed "
                                        "conference's deposit)")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return rows


def _r_split(s: np.ndarray, plan) -> dict:
    """R's split from its phase probe's stamps ([walkers, R_PHASE_SLOTS]
    clock64 words; a walker is a block of PR 16's form, plan[2] == 0, or a
    warp of this one, plan[2] > 0): medians over the walkers of set-up
    (its start to its first item: the bank staged, or the index arithmetic),
    and of each item's span staging (the window's loads and conversion),
    tap loop and store; the walker (median and slowest); the items a
    walker took; the walkers an SM ran, how many at once at most, and the
    share that started after another walker on their SM had ended (a
    second wave); and the launch's span on the global timer (ns)."""
    s = s.astype(np.int64)
    items = s[:, 5]
    busy = items > 0
    late, overlap = 0, [0]
    for sm in np.unique(s[:, 7]):
        on = s[s[:, 7] == sm]
        late += int((on[:, 0] > on[:, 6].min()).sum())
        cur = 0
        for _, d in sorted([(a, 1) for a in on[:, 0]]
                           + [(e, -1) for e in on[:, 6]]):
            cur += d
            overlap.append(cur)
    per_sm = np.bincount(s[:, 7])

    def med(v):
        return float(np.median(v)) if len(v) else 0.0

    def per_item(col):
        return med(s[busy, col] / items[busy])

    return dict(
        form=int(plan[2]), walkers=int(plan[0]), threads=int(plan[1]),
        idle_walkers=int((~busy).sum()),
        items_per_walker_median_max=[med(items), int(items.max())],
        setup_cycles=med(s[busy, 1] - s[busy, 0]),
        span_cycles_per_item=per_item(2), taps_cycles_per_item=per_item(3),
        store_cycles_per_item=per_item(4),
        walker_cycles=med(s[:, 6] - s[:, 0]),
        walker_cycles_max=int((s[:, 6] - s[:, 0]).max()),
        sms_used=int((per_sm > 0).sum()),
        walkers_per_sm_max=int(per_sm.max()),
        walkers_at_once_on_an_sm_max=int(max(overlap)),
        second_wave_share=late / len(s),
        launch_span_ns=int(s[:, 10].max() - s[:, 9].min()))


def _r_launch(lib, x, y, l: int, m: int, dev) -> None:
    """One launch of `lib`'s kernel R on x -> y at L/M, 16 taps: this
    tree's C entry, or PR 16's (the bank in device memory only, and its
    work items' outputs and staged span: 12 arguments)."""
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.kernels import resample as rs

    b, t = x.shape
    bank = rs.bank_tensor(l, m, 16, dev).data_ptr()
    if len(lib.ljt_resample.argtypes) == 12:
        span = 4096
        chunk = max(1, min(1024, (span - 17) * l // m + 1))
        rc = lib.ljt_resample(x.data_ptr(), bank, y.data_ptr(), b, t,
                              y.shape[1], l, m, 16, chunk, span,
                              kbuild.stream_handle(dev))
    else:
        rc = lib.ljt_resample(x.data_ptr(), bank,
                              rs.bank_host(l, m, 16).ctypes.data,
                              y.data_ptr(), b, t, y.shape[1], l, m, 16,
                              kbuild.stream_handle(dev))
    kbuild.check(rc, "resample")


def resample_turns(torch, dev, parent_lib) -> None:
    """The parent's kernel R against this tree's at every RESAMPLE_SHAPES
    shape and at a conference_mixed tick's launches, in turns (parent,
    this, this, parent), each turn the profiler's mean duration over 50
    launches; both trees' outputs must be equal.  Prints an `r_turns` line
    with each launch and the mixed tick's four summed."""
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.kernels import resample as rs

    rng = np.random.default_rng(53)
    out = {}
    for b, ri, ro in RESAMPLE_SHAPES + MIXED_R_LAUNCHES:
        x = _r_input(torch, dev, rng, b, ri)
        l, m = rs.ratio(ri, ro)
        ys = [torch.empty((b, x.shape[1] * l // m), dtype=torch.int16,
                          device=dev) for _ in range(2)]
        libs = (parent_lib, kbuild.library(), kbuild.library(), parent_lib)
        t = [device_ms(torch, lambda lib=lib, y=ys[i in (1, 2)]: _r_launch(
            lib, x, y, l, m, dev), 50, "resample")
             for i, lib in enumerate(libs)]
        require(max_abs_err(torch, [ys[0]], [ys[1]]) == 0,
                f"R differs from its parent at [{b},{x.shape[1]}] L/M "
                f"{l}/{m}")
        parent, new = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        out[f"[{b},{x.shape[1]}] L/M {l}/{m}"] = dict(
            turns_ms=t, parent_ms=parent, new_ms=new,
            parent_spread_ms=abs(t[0] - t[3]), new_spread_ms=abs(t[1] - t[2]),
            new_over_parent=new / parent)
    tick = [v for k, v in out.items()
            if any(k.startswith(f"[{n},{ri // 50}] ")
                   for n, ri, _ in MIXED_R_LAUNCHES)]
    t = [sum(v["turns_ms"][i] for v in tick) for i in range(4)]
    out["conference_mixed tick (4 launches)"] = dict(
        turns_ms=t, parent_ms=(t[0] + t[3]) / 2, new_ms=(t[1] + t[2]) / 2,
        new_over_parent=(t[1] + t[2]) / (t[0] + t[3]))
    emit("r_turns", order="parent, this tree, this tree, parent",
         launches=out)


# the kernels this tree changed against its parent: none (the public
# stream API adds host modules only)
SASS_CHANGED = ()


def sass_compare(root: str) -> None:
    """`scripts/torch_sass_compare.py` between the tree at `root` and this
    one: every kernel but SASS_CHANGED must be in both trees and
    identical.  Prints a `sass_compare` line."""
    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run(
        [sys.executable, os.path.join(here, "scripts",
                                      "torch_sass_compare.py"), root, here],
        capture_output=True, text=True, timeout=900)
    require(res.returncode == 0, f"torch_sass_compare failed: {res.stderr}")
    line = json.loads(res.stdout.strip().splitlines()[-1])
    report = line["sass_compare"]
    differ = sorted(k for k, v in report.items() if not v["identical"])
    alone = line["only_old"] + line["only_new"]
    emit("sass_compare", parent=root, kernels=len(report),
         identical=len(report) - len(differ), differ=differ,
         only_parent=line["only_old"], only_this=line["only_new"])
    require(set(differ + alone) <= set(SASS_CHANGED),
            f"kernels outside SASS_CHANGED changed their SASS: "
            f"{differ}, {alone}")


def r_phases(torch, dev, lib, which: str) -> None:
    """Kernel R's phase probe (`ljt_resample_phases` of `lib`: its form
    with clock64 stamps) at every RESAMPLE_SHAPES shape and at the
    launches of a conference_mixed tick: the probe's time, its output held
    against the plain version, and `_r_split`.  Prints an `r_phases` line
    named `which`."""
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.kernels import resample as rs

    rng = np.random.default_rng(47)
    stamps = torch.zeros((R_PHASE_WALKERS, R_PHASE_SLOTS), dtype=torch.int64,
                         device=dev)
    plan = np.zeros(4, np.int32)
    out = {}
    for b, ri, ro in RESAMPLE_SHAPES + MIXED_R_LAUNCHES:
        x = _r_input(torch, dev, rng, b, ri)
        t = x.shape[1]
        l, m = rs.ratio(ri, ro)
        want = rs.resample_plain(x, l, m)
        got = torch.empty_like(want)
        bank, host = rs.bank_tensor(l, m, 16, dev), rs.design(l, m)

        def probe():
            kbuild.check(lib.ljt_resample_phases(
                x.data_ptr(), bank.data_ptr(), host.ctypes.data,
                got.data_ptr(), b, t, want.shape[1], l, m, 16,
                stamps.data_ptr(), R_PHASE_WALKERS, plan.ctypes.data,
                kbuild.stream_handle(dev)), "resample_phases")

        probe_ms = device_ms(torch, probe, 20, "resample")
        stamps.zero_()
        probe()
        torch.cuda.synchronize()
        require(max_abs_err(torch, [got], [want]) == 0,
                f"R's phase probe ({which}) differs from plain at [{b},{t}] "
                f"L/M {l}/{m}")
        out[f"[{b},{t}] L/M {l}/{m}"] = dict(
            probe_ms=probe_ms,
            **_r_split(stamps[:int(plan[0])].cpu().numpy(), plan))
    emit("r_phases", tree=which, launches=out)


# ------------------------------------------------------ 7. conference

def _drain(engine, want: int) -> list:
    got = []
    for _ in range(200):
        b, _, _ = engine.recv_batch(timeout_ms=5)
        got += b.to_payloads()
        if len(got) >= want:
            break
    return got


def _conference_setup(torch, dev, keys=None,
                      ticks: int = CONF_TICKS + CONF_PROFILED):
    """Keys, SSRCs, fixed TX counters and the protected wire of every
    tick: participant k sends a tone of 150 + 11k Hz, the last six send
    silence, and from tick CONF_SWITCH participant 10 is the loudest.
    `keys` ({"rx": (keys, salts), "tx": ...}) replace the drawn ones (a
    DTLS join's exported keys), the rest of the draw unchanged."""
    from libjitsi_tpu_torch.kernels import g711
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    n = CONF_PARTIES
    rng = np.random.default_rng(23)
    drawn = {d: (rng.integers(0, 256, (n, 16), np.uint8),
                 rng.integers(0, 256, (n, 14), np.uint8))
             for d in ("rx", "tx")}
    keys = drawn if keys is None else keys
    ssrc = 0x30000000 + np.arange(n)
    up = SrtpStreamTable(n, device=dev)
    up.add_streams(np.arange(n), *keys["rx"])
    freqs = 150.0 + 11.0 * np.arange(n)
    amps = np.linspace(100.0, 600.0, n)
    amps[-6:] = 0.0
    wires = []
    for tick in range(ticks):
        a = amps.copy()
        if tick >= CONF_SWITCH:
            a[10] = 6000.0
        t = tick * 160 + np.arange(160)
        pcm = (a[:, None] * np.sin(2 * np.pi * freqs[:, None] * t / 8000)
               ).astype(np.int16)
        codes = g711.ulaw_encode(torch.as_tensor(pcm).to(dev)).cpu().numpy()
        plain = rtp_header.build(
            [c.tobytes() for c in codes], (1000 + tick) * np.ones(n, int),
            [tick * 160] * n, ssrc.tolist(), [0] * n,
            stream=list(range(n)),
            ext=[(0xBEDE, bytes([0x10, k % 128, 0, 0])) for k in range(n)])
        wires.append(up.protect_rtp(plain))
    return {"keys": keys, "ssrc": ssrc, "freqs": freqs, "wires": wires,
            "tx_seq": rng.integers(0, 1 << 16, n),
            "tx_ts": rng.integers(0, 1 << 32, n)}


def _conference_join(bridge, setup, codecs=None) -> None:
    """Join every participant (`codecs(k)` gives leg k's codec, None the
    bridge's default PCMU) with the setup's keys and TX counters."""
    n = CONF_PARTIES
    rx_k, rx_s = setup["keys"]["rx"]
    tx_k, tx_s = setup["keys"]["tx"]
    for k in range(n):
        sid = bridge.add_participant(int(setup["ssrc"][k]),
                                     (rx_k[k].tobytes(), rx_s[k].tobytes()),
                                     (tx_k[k].tobytes(), tx_s[k].tobytes()),
                                     codec=codecs(k) if codecs else None)
        require(sid == k, "rows are not handed out in join order")
    bridge._tx_seq[:] = setup["tx_seq"]     # both runs send the same seqs
    bridge._tx_ts[:] = setup["tx_ts"]


def _conference_ticks(bridge, setup, ticks, client, kbuild=None,
                      replay=None) -> dict:
    """Send each tick's wire from `client` and tick the bridge at explicit
    20 ms steps of `now`; before tick `replay[0]` the wire of tick
    `replay[1]` is sent again, in the same window."""
    n = CONF_PARTIES
    res = {"levels": [], "dominant": [], "replies": [], "tick_s": [],
           "launches": dict.fromkeys(kbuild.launches if kbuild else (), 0),
           "launches_min": {}, "launches_max": {}}
    for tick in ticks:
        rx_want = n
        if replay is not None and tick == replay[0]:
            client.send_batch(setup["wires"][replay[1]], "127.0.0.1",
                              bridge.port)
            rx_want = 2 * n
        client.send_batch(setup["wires"][tick], "127.0.0.1", bridge.port)
        time.sleep(0.002)
        pre = dict(kbuild.launches) if kbuild else {}
        t0 = time.perf_counter()
        stats = bridge.tick(now=1000.0 + 0.02 * tick)
        res["tick_s"].append(time.perf_counter() - t0)
        for k in pre:
            d = kbuild.launches[k] - pre[k]
            res["launches"][k] += d
            res["launches_min"][k] = min(res["launches_min"].get(k, d), d)
            res["launches_max"][k] = max(res["launches_max"].get(k, d), d)
        require(stats["rx"] == rx_want and stats["tx"] == n,
                f"conference tick {tick}: rx {stats['rx']} of {rx_want}, "
                f"tx {stats['tx']} of {n}")
        got = _drain(client, n)
        require(len(got) == n, f"conference tick {tick}: {len(got)} "
                               f"of {n} mixes came back")
        res["levels"].append(np.asarray(stats["levels"]).copy())
        res["dominant"].append(stats["dominant"])
        res["replies"].append(sorted(got))
    res["speaker_events"] = list(bridge.speaker_events)
    return res


def _conference_drive(bridge, setup, ticks, kbuild=None,
                      codecs=None) -> dict:
    """Join every participant, then run ticks 0..ticks-1 from one client
    socket."""
    from libjitsi_tpu_torch.io.udp import UdpEngine

    _conference_join(bridge, setup, codecs)
    with UdpEngine(port=0, bind_ip="127.0.0.1",
                   max_batch=2 * CONF_PARTIES) as client:
        return _conference_ticks(bridge, setup, range(ticks), client, kbuild)


def conference_run(torch, dev, setup) -> dict:
    """The main path of this slice: a 256-participant PCMU bridge on the
    card, driven as a user drives it; every tick must launch every kernel
    of the path."""
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.service.bridge import ConferenceBridge

    bridge = _keep("conference", ConferenceBridge(capacity=CONF_PARTIES,
                                                  device=dev))
    res = _conference_drive(bridge, setup, CONF_TICKS, kbuild)
    res["launches_per_tick"] = {k: v / CONF_TICKS
                                for k, v in res["launches"].items()}
    short = {k: res["launches_min"][k] for k in PATHS["conference"]
             if res["launches_min"][k] < 1}
    require(not short, f"a conference tick launched none of {short}")
    res.update(setup=setup, bridge=bridge)
    return res


def profiled_ticks(torch, tick, n, before=None, after=None) -> dict:
    """`n` calls of `tick(i)` under torch.profiler (`before(i)` and
    `after(i)` run outside it): per tick, the host time of each span and
    the card's busy time by kernel and copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spans, device, wall = {}, {}, 0.0
    for i in range(n):
        if before is not None:
            before(i)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tick(i)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
        if after is not None:
            after(i)
        for e in prof.events():
            if e.device_type == DeviceType.CPU and _is_span(e.name):
                spans[e.name] = spans.get(e.name, 0.0) + e.cpu_time_total / 1e3
            elif e.device_type == DeviceType.CUDA and not _is_span(e.name):
                m = re.search(r"(\w+)_kernel", e.name)
                key = m.group(1) if m else e.name
                device[key] = device.get(key, 0.0) + \
                    e.time_range.elapsed_us() / 1e3
    busy = sum(device.values()) / n if device else None
    wall_ms = wall * 1e3 / n
    return dict(ticks=n, wall_ms_per_tick=wall_ms,
                span_ms_per_tick={k: v / n for k, v in spans.items()},
                device_ms_per_tick={k: v / n for k, v in device.items()},
                device_busy_ms_per_tick=busy,
                device_idle_share=None if busy is None else 1 - busy / wall_ms)


def _profile_conference(torch, bridge, setup, start: int = CONF_TICKS,
                        n: int = CONF_PROFILED) -> dict:
    """`n` more ticks of the card's bridge, from tick `start`, under
    torch.profiler."""
    from libjitsi_tpu_torch.io.udp import UdpEngine

    with UdpEngine(port=0, bind_ip="127.0.0.1",
                   max_batch=2 * CONF_PARTIES) as client:
        def send(i):
            client.send_batch(setup["wires"][start + i], "127.0.0.1",
                              bridge.port)
            time.sleep(0.002)

        return profiled_ticks(
            torch, lambda i: bridge.tick(now=1000.0 + 0.02 * (start + i)),
            n, before=send, after=lambda i: _drain(client, CONF_PARTIES))


def conference_check(torch, dev, conf) -> dict:
    """The same run of the bridge on the CPU (plain versions, its own
    sockets) must give the card's bytes, levels and dominant speakers;
    the parties must authenticate every mix, and a loud party must not
    hear itself.  Returns the CPU run."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.kernels import g711
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.service.bridge import ConferenceBridge
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    setup, n = conf["setup"], CONF_PARTIES
    profiled = _profile_conference(torch, conf["bridge"], setup)
    conf["bridge"].close()
    cpu_bridge = _keep("conference cpu", ConferenceBridge(capacity=n,
                                                          device="cpu"))
    t0 = time.perf_counter()
    ref = _conference_drive(cpu_bridge, setup, CONF_TICKS)
    cpu_s = time.perf_counter() - t0
    cpu_bridge.close()
    for tick in range(CONF_TICKS):
        require(np.array_equal(conf["levels"][tick], ref["levels"][tick]),
                f"conference tick {tick}: levels differ from the CPU run")
        require(conf["dominant"][tick] == ref["dominant"][tick],
                f"conference tick {tick}: dominant speaker differs")
        require(conf["replies"][tick] == ref["replies"][tick],
                f"conference tick {tick}: wire bytes differ from the CPU run")
    require(conf["speaker_events"] == ref["speaker_events"],
            "speaker events differ from the CPU run")
    # every party authenticates and decrypts its mixes
    down = SrtpStreamTable(n, device=dev)
    down.add_streams(np.arange(n), *setup["keys"]["tx"])
    heard = {k: [] for k in range(n)}
    for tick in range(CONF_TICKS):
        batch = PacketBatch.from_payloads(conf["replies"][tick])
        hdr = rtp_header.parse(batch)
        batch.stream[:] = hdr.ssrc - 0x42000000
        dec, ok = down.unprotect_rtp(batch)
        require(ok.all(), f"conference tick {tick}: a mix failed to "
                          "authenticate")
        off = rtp_header.parse(dec).payload_off
        for i in range(n):
            heard[int(batch.stream[i])].append(
                dec.data[i, off[i]:dec.length[i]])
    lut = g711.decode_table(g711.ULAW, torch.device("cpu")).numpy()
    freqs = setup["freqs"]

    def power(sid, f_hz):
        pcm = lut[np.concatenate(heard[sid][CONF_SWITCH + 2:])]
        spec = np.abs(np.fft.rfft(pcm * np.hanning(len(pcm))))
        return float(spec[np.argmin(np.abs(np.fft.rfftfreq(len(pcm), 1 / 8000)
                                           - f_hz))])

    own, heard_by_9 = power(10, freqs[10]), power(9, freqs[10])
    require(own * 20 < heard_by_9, f"participant 10 hears its own tone: "
                                   f"{own} vs {heard_by_9} at participant 9")
    secs = np.array(conf["tick_s"])
    emit("conference", participants=n, ticks=CONF_TICKS, codec="PCMU",
         ptime_ms=20, tick_ms_p50=float(np.median(secs)) * 1e3,
         tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
         tick_ms_max=float(secs.max()) * 1e3,
         ptime_share_p50=float(np.median(secs)) / 0.02,
         launches_per_tick=conf["launches_per_tick"],
         launches_min_per_tick=conf["launches_min"],
         equal_to_cpu_run=True, mixes_authenticated=n * CONF_TICKS,
         own_tone_power=own, own_tone_heard_by_other=heard_by_9,
         speaker_events=conf["speaker_events"],
         dominant_last=conf["dominant"][-1], cpu_run_s=cpu_s,
         profile=profiled)
    return ref


def conference_restore_check(torch, dev, setup, ref) -> None:
    """A card bridge runs ticks 0..CONF_RESUME-1 and snapshots; a bridge
    restored from the snapshot on the card, on a fresh port, takes the
    last tick's wire again beside the next one (a replay, rejected) and
    runs the remaining ticks, whose wire bytes must equal the
    uninterrupted CPU run's."""
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.service.bridge import ConferenceBridge

    n = CONF_PARTIES
    bridge = _keep("conference_restore",
                   ConferenceBridge(capacity=n, device=dev))
    _conference_join(bridge, setup)
    with UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=4 * n) as client:
        _conference_ticks(bridge, setup, range(CONF_RESUME), client)
        t0 = time.perf_counter()
        snap = bridge.snapshot()
        bridge.close()
        back = _keep("conference_restore restored",
                     ConferenceBridge.restore(snap, device=dev))
        restore_s = time.perf_counter() - t0
        res = _conference_ticks(back, setup, range(CONF_RESUME, CONF_TICKS),
                                client, replay=(CONF_RESUME, CONF_RESUME - 1))
        replays = back.loop.reverse_dropped
        back.close()
    require(replays == n, f"restored bridge: {replays} of {n} replayed "
                          f"packets of tick {CONF_RESUME - 1} rejected")
    differ = [CONF_RESUME + i for i, r in enumerate(res["replies"])
              if r != ref["replies"][CONF_RESUME + i]]
    require(not differ, f"restored bridge: wire of ticks {differ} differs "
                        "from the uninterrupted CPU run")
    require(all(np.array_equal(a, ref["levels"][CONF_RESUME + i])
                for i, a in enumerate(res["levels"])),
            "restored bridge: levels differ from the uninterrupted CPU run")
    emit("conference_restore", participants=n, snapshot_after_ticks=CONF_RESUME,
         resumed_ticks=CONF_TICKS - CONF_RESUME, replayed_rejected=replays,
         equal_to_uninterrupted_cpu_run=True, snapshot_and_restore_s=restore_s)


def _mixed_codecs(dev):
    """Leg k's codec on a mixed-rate bridge on `dev`: G.722 for leg 0 (a
    fresh stateful leg a bridge), PCMU up to MIXED_PCMU, PCMA after."""
    from libjitsi_tpu_torch.service.pump import g711_codec, g722_codec

    return lambda k: (g722_codec() if k == 0
                      else g711_codec(k < MIXED_PCMU, device=dev))


def _mixed_setup(torch, dev):
    """The conference_mixed path's keys, SSRCs, TX counters and protected
    wire: as `_conference_setup`, but leg 0 speaks G.722 (a 1,800 Hz tone
    at 16 kHz, coded on the host), legs 1-191 PCMU and the rest PCMA.  Leg
    150, whose tone would be leg 0's 1,800 Hz, sends silence, so that the
    own-tone check reads leg 0 alone."""
    from libjitsi_tpu_torch.kernels import g711
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.service.pump import g722_codec
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    n, ticks = CONF_PARTIES, MIXED_TICKS + MIXED_PROFILED
    rng = np.random.default_rng(29)
    keys = {d: (rng.integers(0, 256, (n, 16), np.uint8),
                rng.integers(0, 256, (n, 14), np.uint8)) for d in ("rx", "tx")}
    ssrc = 0x31000000 + np.arange(n)
    up = SrtpStreamTable(n, device=dev)
    up.add_streams(np.arange(n), *keys["rx"])
    freqs = 150.0 + 11.0 * np.arange(n)
    freqs[0] = MIXED_TONE
    amps = np.linspace(100.0, 600.0, n)
    amps[-6:] = 0.0
    amps[150] = 0.0
    amps[0] = 6000.0
    sender = g722_codec()
    pt = np.where(np.arange(n) < MIXED_PCMU, 0, 8)
    pt[0] = sender.pt
    wires = []
    for tick in range(ticks):
        a = amps.copy()
        if tick >= CONF_SWITCH:
            a[10] = 6000.0
        t = tick * 160 + np.arange(160)
        pcm = torch.as_tensor((a[:, None] * np.sin(
            2 * np.pi * freqs[:, None] * t / 8000)).astype(np.int16)).to(dev)
        codes = torch.cat([g711.ulaw_encode(pcm[:MIXED_PCMU]),
                           g711.alaw_encode(pcm[MIXED_PCMU:])]).cpu().numpy()
        t16 = tick * 320 + np.arange(320)
        pay = [sender.encode((a[0] * np.sin(2 * np.pi * MIXED_TONE * t16
                                            / 16000)).astype(np.int16))]
        pay += [c.tobytes() for c in codes[1:]]
        plain = rtp_header.build(
            pay, (1000 + tick) * np.ones(n, int), [tick * 160] * n,
            ssrc.tolist(), pt.tolist(), stream=list(range(n)),
            ext=[(0xBEDE, bytes([0x10, k % 128, 0, 0])) for k in range(n)])
        wires.append(up.protect_rtp(plain))
    return {"keys": keys, "ssrc": ssrc, "freqs": freqs, "wires": wires,
            "tx_seq": rng.integers(0, 1 << 16, n),
            "tx_ts": rng.integers(0, 1 << 32, n)}


def conference_mixed_run(torch, dev, setup) -> dict:
    """The mixed-rate conference on the card: G.722 leg 0 sets a 16 kHz
    clock, 255 G.711 legs at 8 kHz resample to it on deposit and from it
    on egress; every tick must launch every kernel of the path, and R
    exactly MIXED_R_PER_TICK times."""
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.service.bridge import ConferenceBridge

    bridge = _keep("conference_mixed",
                   ConferenceBridge(capacity=CONF_PARTIES, device=dev))
    res = _conference_drive(bridge, setup, MIXED_TICKS, kbuild,
                            codecs=_mixed_codecs(dev))
    require((bridge._rate, bridge._frame_samples) == (16000, 320),
            f"mixed bridge clock {bridge._rate} Hz, {bridge._frame_samples}")
    res["launches_per_tick"] = {k: v / MIXED_TICKS
                                for k, v in res["launches"].items()}
    short = {k: res["launches_min"][k] for k in PATHS["conference_mixed"]
             if res["launches_min"][k] < 1}
    require(not short, f"a mixed conference tick launched none of {short}")
    r = (res["launches_min"]["resample"], res["launches_max"]["resample"])
    require(r == (MIXED_R_PER_TICK,) * 2,
            f"kernel R launched {r} (min, max) times a tick, not "
            f"{MIXED_R_PER_TICK}")
    res.update(setup=setup, bridge=bridge)
    return res


def _open_mixes(dev, setup, replies) -> dict:
    """Every party authenticates and decrypts its mixes: payloads by
    participant, in tick order."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    n = CONF_PARTIES
    down = SrtpStreamTable(n, device=dev)
    down.add_streams(np.arange(n), *setup["keys"]["tx"])
    heard = {k: [] for k in range(n)}
    for tick, wire in enumerate(replies):
        batch = PacketBatch.from_payloads(wire)
        batch.stream[:] = rtp_header.parse(batch).ssrc - 0x42000000
        dec, ok = down.unprotect_rtp(batch)
        require(ok.all(), f"mix {tick}: a mix failed to authenticate")
        off = rtp_header.parse(dec).payload_off
        for i in range(len(wire)):
            heard[int(batch.stream[i])].append(
                dec.data[i, off[i]:dec.length[i]].copy())
    return heard


def _tone_power(pcm: np.ndarray, rate: int, f_hz: float) -> float:
    """The Hann-windowed spectrum's magnitude at `f_hz`, per sample (so
    that mixes at 8 and 16 kHz compare)."""
    spec = np.abs(np.fft.rfft(pcm * np.hanning(len(pcm))))
    return float(spec[np.argmin(np.abs(np.fft.rfftfreq(len(pcm), 1 / rate)
                                       - f_hz))]) / len(pcm)


def _g722_host_ms(frames: int = 5) -> dict:
    """Milliseconds a 20 ms frame takes through one G.722 leg's host
    encode and decode on this machine's CPU."""
    from libjitsi_tpu_torch.service.pump import g722_codec

    leg = g722_codec()
    pcm = (6000 * np.sin(2 * np.pi * MIXED_TONE * np.arange(320) / 16000)
           ).astype(np.int16)
    t0 = time.perf_counter()
    codes = [leg.encode(pcm) for _ in range(frames)]
    t1 = time.perf_counter()
    for c in codes:
        leg.decode(c)
    t2 = time.perf_counter()
    return {"encode": (t1 - t0) * 1e3 / frames,
            "decode": (t2 - t1) * 1e3 / frames}


def conference_mixed_check(torch, dev, run) -> None:
    """The mixed conference's CPU twin must give the card's bytes, levels
    and dominant speakers; every party authenticates every mix; leg 0
    (16 kHz) hears leg 10's tone and leg 10 (8 kHz) leg 0's 1,800 Hz, each
    over 20x what the tone's own leg hears of it (mix-minus across rates;
    per-sample spectra from tick CONF_SWITCH + 2).  Then a card bridge
    snapshots at tick MIXED_SNAPSHOT and a bridge restored on the card
    keeps the 16 kHz clock, names leg 0 degraded, and every mix of the
    remaining ticks authenticates."""
    from libjitsi_tpu_torch.codecs.g722 import G722Decoder
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.kernels import g711
    from libjitsi_tpu_torch.service.bridge import ConferenceBridge

    setup, n = run["setup"], CONF_PARTIES
    profiled = _profile_conference(torch, run["bridge"], setup, MIXED_TICKS,
                                   MIXED_PROFILED)
    run["bridge"].close()
    cpu_bridge = _keep("conference_mixed cpu",
                       ConferenceBridge(capacity=n, device="cpu"))
    t0 = time.perf_counter()
    ref = _conference_drive(cpu_bridge, setup, MIXED_TICKS,
                            codecs=_mixed_codecs("cpu"))
    cpu_s = time.perf_counter() - t0
    cpu_bridge.close()
    for tick in range(MIXED_TICKS):
        require(np.array_equal(run["levels"][tick], ref["levels"][tick]),
                f"mixed tick {tick}: levels differ from the CPU twin")
        require(run["dominant"][tick] == ref["dominant"][tick],
                f"mixed tick {tick}: dominant speaker differs")
        require(run["replies"][tick] == ref["replies"][tick],
                f"mixed tick {tick}: wire bytes differ from the CPU twin")
    require(run["speaker_events"] == ref["speaker_events"],
            "mixed speaker events differ from the CPU twin")
    heard = _open_mixes(dev, setup, run["replies"])
    dec = G722Decoder(1)
    pcm0 = np.concatenate([dec.decode(p[None])[0] for p in heard[0]])
    lut = g711.decode_table(g711.ULAW, torch.device("cpu")).numpy()
    pcm10 = lut[np.concatenate(heard[10])]
    s = CONF_SWITCH + 2
    f10 = setup["freqs"][10]
    # each tone in its own leg's mix against the same tone in the other's
    own0, heard0 = (_tone_power(pcm0[s * 320:], 16000, MIXED_TONE),
                    _tone_power(pcm10[s * 160:], 8000, MIXED_TONE))
    own10, heard10 = (_tone_power(pcm10[s * 160:], 8000, f10),
                      _tone_power(pcm0[s * 320:], 16000, f10))
    require(own0 * 20 < heard0, f"leg 10 (PCMU) hears leg 0's tone at "
                                f"{heard0}, not over 20x leg 0's own {own0}")
    require(own10 * 20 < heard10, f"leg 0 (G.722) hears leg 10's tone at "
                                  f"{heard10}, not over 20x leg 10's own "
                                  f"{own10}")
    # snapshot mid-run, restore on the card
    bridge = _keep("conference_mixed snapshot",
                   ConferenceBridge(capacity=n, device=dev))
    _conference_join(bridge, setup, _mixed_codecs(dev))
    with UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=2 * n) as client:
        _conference_ticks(bridge, setup, range(MIXED_SNAPSHOT), client)
        snap = bridge.snapshot()
        bridge.close()
        back = _keep("conference_mixed restored",
                     ConferenceBridge.restore(snap, device=dev))
        clock = (back._rate, back._frame_samples)
        tail = _conference_ticks(back, setup,
                                 range(MIXED_SNAPSHOT, MIXED_TICKS), client)
        back.close()
    require(clock == (16000, 320) and snap["rate"] == 16000,
            f"restored mixed bridge clock {clock}, snapshot {snap['rate']}")
    require(snap["degraded_rows"] == [0],
            f"degraded rows {snap['degraded_rows']}, not [0]")
    _open_mixes(dev, setup, tail["replies"])
    g722 = _g722_host_ms()
    secs = np.array(run["tick_s"])
    emit("conference_mixed", participants=n, ticks=MIXED_TICKS,
         codecs={"G722": 1, "PCMU": MIXED_PCMU - 1, "PCMA": n - MIXED_PCMU},
         bridge_rate=16000, frame_samples=320, ptime_ms=20,
         tick_ms_p50=float(np.median(secs)) * 1e3,
         tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
         tick_ms_max=float(secs.max()) * 1e3,
         ptime_share_p50=float(np.median(secs)) / 0.02,
         resample_launches_per_tick=run["launches_per_tick"]["resample"],
         launches_per_tick=run["launches_per_tick"],
         launches_min_per_tick=run["launches_min"],
         equal_to_cpu_run=True, mixes_authenticated=n * MIXED_TICKS,
         leg0_tone_own_mix=own0, leg0_tone_heard_by_leg10=heard0,
         leg10_tone_own_mix=own10, leg10_tone_heard_by_leg0=heard10,
         g722_host_ms_per_frame=g722,
         speaker_events=run["speaker_events"], cpu_run_s=cpu_s,
         restore={"snapshot_tick": MIXED_SNAPSHOT, "rate": clock[0],
                  "degraded_rows": snap["degraded_rows"],
                  "mixes_authenticated": n * (MIXED_TICKS - MIXED_SNAPSHOT)},
         profile=profiled)


# ---------------------------------------------------- 8. mixer bridge

def mixer_bridge_run(torch, dev) -> dict:
    """`MixerBridge(64, 64, 960)` on the card for MIXER_TICKS ticks; tick
    time by host clock, the upload and read-back included."""
    from libjitsi_tpu_torch.conference.mixer import MixerBridge

    c, n, f = MIXER_BRIDGE
    rng = np.random.default_rng(41)
    mb = MixerBridge(c, n, f, device=dev)
    for _ in range(c):
        cid = mb.alloc_conference()
        for sid in range(n):
            mb.add_participant(cid, sid)
    pool = rng.integers(-8000, 8000, (4, c, n, f)).astype(np.int16)
    # the ticks held against the plain version: each pool slot's first
    # use, then the last tick, which has reused the host buffer throughout
    kept_ticks = {0, 1, 2, 3, MIXER_TICKS - 1}
    secs, kept = [], {}
    for tick in range(MIXER_TICKS):
        frames = pool[tick % 4]
        for cid in range(c):
            for sid in range(n):
                mb.push(cid, sid, frames[cid, sid])
        t0 = time.perf_counter()
        out, levels = mb.tick()
        secs.append(time.perf_counter() - t0)
        if tick in kept_ticks:
            kept[tick] = (out, levels)
    return {"secs": np.array(secs), "kept": kept, "bridge": mb,
            "pool": pool}


def mixer_bridge_check(torch, dev, mb) -> None:
    from libjitsi_tpu_torch.conference import mixer

    c, n, f = MIXER_BRIDGE
    bridge, pool = mb["bridge"], mb["pool"]
    active = torch.ones((c, n), dtype=torch.bool, device=dev)
    for tick, (out, levels) in sorted(mb["kept"].items()):
        want = mixer.mix_minus_many_plain(
            torch.as_tensor(pool[tick % 4]).to(dev), active)
        require(np.array_equal(out, want[0].cpu().numpy())
                and np.array_equal(levels, want[1].cpu().numpy()),
                f"MixerBridge tick {tick} differs from the plain version "
                "on the card")

    def push(i):
        for cid in range(c):
            for sid in range(n):
                bridge.push(cid, sid, pool[i % 4][cid, sid])

    profile = profiled_ticks(torch, lambda i: bridge.tick(), 5, before=push)
    secs = mb["secs"]
    emit("mixer_bridge", conferences=c, participants=n, frame_samples=f,
         ticks=MIXER_TICKS, tick_ms_p50=float(np.median(secs)) * 1e3,
         tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
         conference_mixes_per_s=c / float(np.median(secs)),
         ticks_equal_to_plain=sorted(mb["kept"]), profile=profile)


# ------------------------------------------------- 9. SFU kernels H, I, J

def _key_tables(rng, n: int):
    """Random AES-128 round keys [n, 11, 16] and HMAC midstates [n, 2, 5]."""
    from libjitsi_tpu_torch.kernels import aes, sha1

    return (aes.expand_keys_batch(rng.integers(0, 256, (n, 16), np.uint8)),
            sha1.hmac_precompute_batch(
                rng.integers(0, 256, (n, 20), np.uint8)).view(np.int32))


def _fanout_case(rng, p, legs, lens, width, n_tab):
    """P packets of `lens` bytes (12-byte header, 8-byte abs-send-time
    extension) each sent to `legs` receivers out of a table of n_tab."""
    tab_rk, tab_mid = _key_tables(rng, n_tab)
    tab_salt = rng.integers(0, 256, (n_tab, 16), np.uint8)
    tab_salt[:, 14:] = 0
    data = rng.integers(0, 256, (p, width), np.uint8)
    src = np.repeat(np.arange(p), legs).astype(np.int32)
    recv = rng.integers(0, n_tab, p * legs).astype(np.int32)
    return [tab_rk, tab_mid, tab_salt, data, lens.astype(np.int32),
            np.full(p, HDR + 8, np.int32),
            rng.integers(0, 2 ** 32, p, dtype=np.uint64).astype(
                np.uint32).view(np.int32),
            rng.integers(0, 2 ** 40, p, dtype=np.int64), src, recv]


def _crypto_times(torch, fn, kernel, plain) -> dict:
    """A crypto kernel's times as C's and D's are taken: its duration on
    the card by the profiler, per back-to-back call by CUDA events, and
    the plain version per call (two calls: it launches thousands of
    small kernels, too many for a profiler window)."""
    return dict(ms=device_ms(torch, fn, 50, kernel),
                call_ms=cuda_ms(torch, fn, 50),
                plain_ms=cuda_ms(torch, plain, 2, 1))


def sfu_kernels(torch, dev, floor_ms: float) -> dict:
    """Kernel H against its plain version at the fan-out bench shape (128
    packets x 512 receivers, 172-byte packets), at the SFU tick's (1,100
    packets x 10 receivers, 80-180-byte packets) and at the launch the
    sfu path makes once a burst (275 packets x 10 receivers); I and J at
    1,100 compound RTCP packets of 60-200 bytes, and J at the 275 of one
    RR burst, as the path launches it.  Each with its bound and beside
    the launch floor; the `kernels` line takes H's and J's path shapes.
    Then I at the shape of `_sfu_setup`'s launch: 1,100 32-byte RRs in
    rows of the default 1,504-byte capacity.
    No PyTorch call computes SRTP, so none has a library time."""
    from libjitsi_tpu_torch.transform.srtp import kernel as sk

    rng = np.random.default_rng(53)
    rows = {}
    burst = SFU_N // SFU_BURSTS
    for label, p, legs, lens, width in (
            ("128x512 len 172 (fan-out bench)", 128, 512,
             np.full(128, 172), 192),
            ("1100x10 len 80-180 (the SFU tick)", SFU_N, SFU_SIZE - 1,
             rng.integers(80, 181, SFU_N), 192),
            (f"{burst}x10 len 80-180 (one SFU burst)", burst, SFU_SIZE - 1,
             rng.integers(80, 181, burst), 192)):
        host = _fanout_case(rng, p, legs, lens, width, SFU_N)
        args = [torch.as_tensor(x).to(dev) for x in host]
        err = max_abs_err(torch, sk.srtp_fanout_protect(*args, TAG),
                          sk.srtp_fanout_protect_plain(*args, TAG))
        require(err == 0, f"kernel H {label} differs from its plain version")
        n = p * legs
        ks_blocks = int((((lens - HDR - 8 + 15) // 16) * legs).sum())
        mac_blocks = int((((lens + 4 + 9 + 63) // 64 + 1) * legs).sum())
        ops = (ks_blocks * (aes_block_ops(10) + CTR_XOR_OPS)
               + mac_blocks * SHA1_BLOCK_OPS)
        # a leg's round keys, midstate and salt read once, however many
        # copies it takes
        nbytes = (p * width + p * 20 + n * (width + 4 + 8)
                  + len(np.unique(host[-1])) * (176 + 40 + 16))
        b_ms, b_by = bound(nbytes, ops)
        line = dict(name="srtp_fanout_cm", shape=label, max_abs_err=err,
                    **_crypto_times(
                        torch, lambda: sk.srtp_fanout_protect(*args, TAG),
                        "srtp_fanout_cm_kernel",
                        lambda: sk.srtp_fanout_protect_plain(*args, TAG)),
                    bound_ms=b_ms, bound_by=b_by, launch_floor_ms=floor_ms,
                    library_ms=None, library="none", bytes=nbytes, ops=ops)
        emit("kernel_vs_plain", **line)
        if p == burst:
            rows["srtp_fanout_cm"] = line
    # I and J: compound RTCP packets of 60-200 bytes from every sender
    # (I's launch in emit_feedback), and J at one burst's (its launch on
    # an RR tick)
    tab_rk, tab_mid = _key_tables(rng, SFU_N)
    for n, label in ((SFU_N, ""), (burst, " (one RR burst)")):
        width = 224
        lens = rng.integers(60, 201, n).astype(np.int32)
        data = rng.integers(0, 256, (n, width), np.uint8)
        stream = rng.permutation(SFU_N)[:n].astype(np.int32)
        iv = rng.integers(0, 256, (n, 16), np.uint8)
        word = (np.uint64(1 << 31) | rng.integers(0, 2 ** 31, n, np.uint64)
                ).astype(np.uint32).view(np.int32)
        pa = [torch.as_tensor(x).to(dev) for x in (tab_rk, tab_mid, stream,
                                                    data, lens, iv, word)]
        wire, wlen = sk.srtcp_protect(*pa, TAG)
        require(max_abs_err(torch, (wire, wlen),
                            sk.srtcp_protect_plain(*pa, TAG)) == 0,
                "kernel I differs from its plain version")
        ua = pa[:3] + [wire, wlen, pa[5]]
        got = sk.srtcp_unprotect(*ua, TAG)
        require(bool(got[2].all()), "kernel J rejected genuine rows")
        require(max_abs_err(torch, got, sk.srtcp_unprotect_plain(*ua, TAG))
                == 0, "kernel J differs from its plain version")
        ks_blocks = int(((lens - 8 + 15) // 16).sum())
        mac_blocks = int(((lens + 4 + 9 + 63) // 64 + 1).sum())
        ops = (ks_blocks * (aes_block_ops(10) + CTR_XOR_OPS)
               + mac_blocks * SHA1_BLOCK_OPS)
        nbytes = 2 * n * width + n * (4 + 16 + 4 + 4) + n * (176 + 40)
        b_ms, b_by = bound(nbytes, ops)
        timed = [("srtcp_unprotect_cm", lambda: sk.srtcp_unprotect(*ua, TAG),
                  lambda: sk.srtcp_unprotect_plain(*ua, TAG))]
        if n == SFU_N:
            timed.insert(0, ("srtcp_protect_cm",
                             lambda: sk.srtcp_protect(*pa, TAG),
                             lambda: sk.srtcp_protect_plain(*pa, TAG)))
        for name, fn, plain in timed:
            line = dict(name=name,
                        shape=f"{n}x{width} RTCP 60-200 bytes{label}",
                        max_abs_err=0,
                        **_crypto_times(torch, fn, name + "_kernel", plain),
                        bound_ms=b_ms, bound_by=b_by,
                        launch_floor_ms=floor_ms, library_ms=None,
                        library="none", bytes=nbytes, ops=ops)
            emit("kernel_vs_plain", **line)
            rows[name] = line
    # I at the launch `_sfu_setup` makes for the clients' RRs: 1,100
    # receiver reports of 32 bytes in rows of the default 1,504-byte
    # capacity (`PacketBatch.from_payloads`)
    n, width = SFU_N, 1504
    lens = np.full(n, 32, np.int32)
    pa = [torch.as_tensor(x).to(dev) for x in (
        tab_rk, tab_mid, rng.permutation(SFU_N)[:n].astype(np.int32),
        rng.integers(0, 256, (n, width), np.uint8), lens,
        rng.integers(0, 256, (n, 16), np.uint8),
        (np.uint64(1 << 31) | rng.integers(0, 2 ** 31, n, np.uint64))
        .astype(np.uint32).view(np.int32))]
    err = max_abs_err(torch, sk.srtcp_protect(*pa, TAG),
                      sk.srtcp_protect_plain(*pa, TAG))
    require(err == 0, "kernel I at the setup's shape differs from its plain "
                      "version")
    ks_blocks = int(((lens - 8 + 15) // 16).sum())
    mac_blocks = int(((lens + 4 + 9 + 63) // 64 + 1).sum())
    ops = (ks_blocks * (aes_block_ops(10) + CTR_XOR_OPS)
           + mac_blocks * SHA1_BLOCK_OPS)
    nbytes = 2 * n * width + n * (4 + 16 + 4 + 4) + n * (176 + 40)
    b_ms, b_by = bound(nbytes, ops)
    emit("kernel_vs_plain", name="srtcp_protect_cm",
         shape=f"{n}x{width} RR 32 bytes (the SFU setup's launch)",
         max_abs_err=err,
         **_crypto_times(torch, lambda: sk.srtcp_protect(*pa, TAG),
                         "srtcp_protect_cm_kernel",
                         lambda: sk.srtcp_protect_plain(*pa, TAG)),
         bound_ms=b_ms, bound_by=b_by, launch_floor_ms=floor_ms,
         library_ms=None, library="none", bytes=nbytes, ops=ops)
    return rows


def sfu_profile_kernels(torch, dev, floor_ms: float, chain: dict,
                        parent_lib=None) -> dict:
    """Kernel H's NULL and AES-F8 instances against their plain versions
    at the sfu_profiles path's launch (one burst: 275 packets x 10 legs,
    80-180-byte packets with a 20-byte header) and at the whole tick's
    (1,100 x 10), each beside H (AES-CM) on the same inputs in the same
    run.  Each line has its bound and `chain_floor_ms`: the launch floor
    plus, under F8, the longest copy's dependent AES pair steps (its
    keystream blocks and IV') at `latency_floor`'s AES-128 pair cycles
    and clock, and under NULL the longest copy's MAC on a hashing lane
    (`mac_floor_ms`).  The `kernels` line takes the burst's lines.  No
    PyTorch call computes F8 or a NULL-cipher SRTP packet.  H-F8 is also
    held against its plain version under AES-256 keys at both shapes, its
    phase split printed (`f8_fanout_phases`, and the parent's where it
    has the probe) and, with a parent, timed against the parent's in
    turns (`f8_turns`)."""
    from libjitsi_tpu_torch.kernels import aes
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.transform.srtp import kernel as sk

    rng = np.random.default_rng(59)
    rows = {}
    burst = SFU_N // SFU_BURSTS
    pair_ms = chain["aes_pair_cycles"]["aes128"] / (chain["mhz"] * 1e3)
    tab_f8 = torch.as_tensor(aes.expand_keys_batch(
        rng.integers(0, 256, (SFU_N, 16), np.uint8))).to(dev)
    # AES-256 legs: both schedules of 15 rounds, for the equality checks
    rk256, f8_256 = (torch.as_tensor(aes.expand_keys_batch(
        rng.integers(0, 256, (SFU_N, 32), np.uint8))).to(dev)
        for _ in range(2))
    phase_cases, turn_specs = [], []
    for label, p in ((f"{burst}x10 len 80-180 (one SFU burst)", burst),
                     ("1100x10 len 80-180 (the SFU tick)", SFU_N)):
        legs = SFU_SIZE - 1
        lens = rng.integers(80, 181, p)
        host = _fanout_case(rng, p, legs, lens, 192, SFU_N)
        args = [torch.as_tensor(x).to(dev) for x in host]
        iv = torch.as_tensor(rng.integers(0, 256, (p, 16), np.uint8)).to(dev)
        n = p * legs
        ks_blocks = ((lens - HDR - 8 + 15) // 16) * legs
        mac_blocks = int((((lens + 4 + 9 + 63) // 64 + 1) * legs).sum())
        legs_read = len(np.unique(host[-1]))  # each leg's keys read once
        base = p * 192 + p * 20 + n * (192 + 4 + 8) + legs_read * 40
        for cipher in ("cm", "null", "f8"):
            f8, civ = (tab_f8, iv) if cipher == "f8" else (None, None)
            name = f"srtp_fanout_{cipher}"

            def fn(cipher=cipher, f8=f8, civ=civ):
                return sk.srtp_fanout_protect(*args, TAG, cipher, f8, civ)

            def plain(cipher=cipher, f8=f8, civ=civ):
                return sk.srtp_fanout_protect_plain(*args, TAG, cipher, f8,
                                                    civ)

            err = max_abs_err(torch, fn(), plain())
            require(err == 0, f"{name} {label} differs from its plain "
                              "version")
            ops = mac_blocks * SHA1_BLOCK_OPS
            nbytes = base
            if cipher == "cm":
                ops += int(ks_blocks.sum()) * (aes_block_ops(10)
                                               + CTR_XOR_OPS)
                nbytes += legs_read * (176 + 16)
                chain_ms = None
            elif cipher == "f8":
                ops += (int(ks_blocks.sum()) + n) * aes_block_ops(10) \
                    + int(ks_blocks.sum()) * CTR_XOR_OPS
                nbytes += legs_read * 2 * 176 + p * 16
                chain_ms = floor_ms + (int((lens - HDR - 8 + 15).max()
                                           // 16) + 1) * pair_ms
            else:
                chain_ms = mac_floor_ms(floor_ms, chain, int(lens.max()) + 4)
            line = _profile_line(
                name, label, _crypto_times(torch, fn, name + "_kernel",
                                           plain), nbytes, ops, floor_ms,
                chain_ms)
            line["max_abs_err"] = err
            emit("kernel_vs_plain", **line)
            if p == burst and cipher != "cm":
                rows[name] = line
        a256 = [rk256, *args[1:]]
        require(max_abs_err(
            torch, sk.srtp_fanout_protect(*a256, TAG, "f8", f8_256, iv),
            sk.srtp_fanout_protect_plain(*a256, TAG, "f8", f8_256, iv)) == 0,
            f"srtp_fanout_f8 {label} differs from its plain version under "
            f"AES-256")
        want = sk.srtp_fanout_protect_plain(*args, TAG, "f8", tab_f8, iv)
        phase_cases.append((label, args, tab_f8, iv, want))
        out = torch.empty((n, 192), dtype=torch.uint8, device=dev)
        out_len = torch.empty((n,), dtype=torch.int32, device=dev)
        ptr = [x.data_ptr() for x in args]
        turn_specs.append((label, (out, out_len, args, iv), (
            "srtp_fanout_f8", (ptr[0], tab_f8.data_ptr(), ptr[1], SFU_N,
                               ptr[3], ptr[4], ptr[5], iv.data_ptr(), ptr[7],
                               p, ptr[8], ptr[9], out.data_ptr(),
                               out_len.data_ptr(), n, 192, 10, TAG,
                               kbuild.stream_handle(dev)))))
    f8_fanout_phases(torch, dev, kbuild.library(), phase_cases, "this tree")
    if parent_lib is not None:
        if hasattr(parent_lib, "ljt_srtp_fanout_f8_phases"):
            f8_fanout_phases(torch, dev, parent_lib, phase_cases, "parent")
        kernel_turns(torch, dev, parent_lib, turn_specs, "f8_turns")
    return rows


# ---------------------------------------------------------- 10. SFU path

def _sfu_setup(torch, dev, profile: str = "AES_CM_128_HMAC_SHA1_80",
               ticks: int = SFU_TICKS + SFU_PROFILED,
               with_rtcp: bool = True, rr_ticks=SFU_RR_TICKS,
               nack_tick: int = SFU_NACK_TICK, keys=None,
               ssrc=None) -> dict:
    """Keys, SSRCs, conferences and every tick's client wire under
    `profile`: each endpoint sends one Opus-sized packet a tick (12-byte
    header, 8-byte abs-send-time extension, 60-160-byte payload; some
    senders' seqs wrap), in a seeded order cut into SFU_BURSTS bursts;
    with `with_rtcp`, one RR a sender at each of `rr_ticks` (the last
    reporting 5% loss) and, at `nack_tick`, a NACK from one receiver in
    each of 10 conferences for the previous tick's packets of three of
    its mates.  Master salts are the profile's length.  `keys` ({"rx":
    (keys, salts), "tx": ...}, what the bridge takes and sends under) and
    `ssrc` replace the drawn ones (a DTLS join's exported keys), the
    rest of the draw unchanged."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.rtp import rtcp
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    n = SFU_N
    rng = np.random.default_rng(29)
    salt = SrtpProfile[profile].master_salt_len
    drawn = {d: (rng.integers(0, 256, (n, 16), np.uint8),
                 rng.integers(0, 256, (n, salt), np.uint8))
             for d in ("rx", "tx")}
    keys = drawn if keys is None else keys
    drawn_ssrc = (0x51000000 + rng.permutation(1 << 20)[:n]).astype(np.int64)
    ssrc = drawn_ssrc if ssrc is None else np.asarray(ssrc, np.int64)
    conf = np.arange(n) // SFU_SIZE
    seq0 = rng.integers(0, 1 << 16, n)
    seq0[::7] = 65536 - 20                  # these wrap within the run
    order = rng.permutation(n)              # the client's send order
    bursts = np.array_split(order, SFU_BURSTS)
    up = SrtpStreamTable(n, SrtpProfile[profile], device=dev)
    up.add_streams(np.arange(n), *keys["rx"])
    payloads, wires, rtcp_wires = [], [], {}
    for t in range(ticks):
        pl = [rng.integers(0, 256, int(k), np.uint8).tobytes()
              for k in rng.integers(60, 161, n)]
        ast = int(round((1000.0 + 0.02 * t) * (1 << 18))) & 0xFFFFFF
        ext = (0xBEDE, bytes([0x32]) + ast.to_bytes(3, "big"))
        plain = rtp_header.build(pl, (seq0 + t) & 0xFFFF, t * 960,
                                 ssrc.tolist(), 111, ext=[ext] * n,
                                 stream=list(range(n)))
        payloads.append(pl)
        wires.append(up.protect_rtp(plain))
    nacked = {}
    if not with_rtcp:
        return dict(keys=keys, ssrc=ssrc, conf=conf, seq0=seq0,
                    bursts=bursts, payloads=payloads, wires=wires, rtcp={},
                    nacked=nacked, profile=profile)
    for t in rr_ticks:
        blobs = []
        for k in range(n):
            mate = conf[k] * SFU_SIZE + (k + 1) % SFU_SIZE
            lossy = t == rr_ticks[-1] and k == 0
            blobs.append(rtcp.build_compound([rtcp.build_rr(
                rtcp.ReceiverReport(int(ssrc[k]), [rtcp.ReportBlock(
                    int(ssrc[mate]), 13 if lossy else 0, 2 if lossy else 0,
                    int(seq0[mate] + t), 4, 0, 0)]))]))
        rtcp_wires[t] = up.protect_rtcp(PacketBatch.from_payloads(
            blobs, stream=list(range(n))))
    nackers = np.arange(min(10, SFU_CONFS)) * SFU_SIZE + 1
    blobs = []
    for r in nackers:
        mates = [r + 1, r + 2, r + 3]
        nacked[int(r)] = mates
        blobs.append(rtcp.build_compound([rtcp.build_nack(rtcp.Nack(
            int(ssrc[r]), int(ssrc[m]),
            [int(seq0[m] + nack_tick - 1) & 0xFFFF]))
            for m in mates]))
    rtcp_wires[nack_tick] = up.protect_rtcp(PacketBatch.from_payloads(
        blobs, stream=nackers.tolist()))
    return dict(keys=keys, ssrc=ssrc, conf=conf, seq0=seq0, bursts=bursts,
                payloads=payloads, wires=wires, rtcp=rtcp_wires,
                nacked=nacked, profile=profile)


def _sfu_bridge(torch, dev, setup, **kwargs):
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    (rk, rs), (tk, ts) = setup["keys"]["rx"], setup["keys"]["tx"]
    bridge = _keep(f"sfu {setup['profile']}", SfuBridge(
        capacity=SFU_N, profile=SrtpProfile[setup["profile"]], device=dev,
        **kwargs))
    sids = bridge.stage_endpoints(
        [(int(setup["ssrc"][k]), (rk[k].tobytes(), rs[k].tobytes()),
          (tk[k].tobytes(), ts[k].tobytes()), None) for k in range(SFU_N)],
        conferences=setup["conf"].tolist())
    require(sids == list(range(SFU_N)), "rows not handed out in spec order")
    bridge.commit_endpoints(sids)
    return bridge


class _Sends:
    """Every datagram a bridge's engine sends while `on` is set."""

    def __init__(self, bridge):
        self.on, self.ticks = None, {}
        eng = bridge.loop.engine
        orig = eng.send_batch

        def send_batch(batch, ip, port):
            if self.on is not None:
                self.ticks.setdefault(self.on, []).extend(
                    batch.to_bytes(i) for i in range(batch.batch_size))
            return orig(batch, ip, port)

        eng.send_batch = send_batch


def _sfu_tick(bridge, setup, t, client, latched=None) -> tuple:
    """One 20 ms tick of input: the media in SFU_BURSTS bursts, then the
    tick's RTCP in bursts of the same size, each burst sent and the
    bridge ticked (at now = 1000 + 0.02 t) until it has taken the burst
    in, so no burst outgrows a default-sized socket buffer.  Returns
    (bridge seconds, packets in, forwards expected): an accepted packet
    is forwarded to each mate whose address is latched, i.e. who has
    sent by then."""
    now = 1000.0 + 0.02 * t
    sends = [(setup["wires"][t], rows) for rows in setup["bursts"]]
    extra = setup["rtcp"].get(t)
    if extra is not None:
        step = len(setup["bursts"][0])
        sends += [(extra, np.arange(lo, min(lo + step, extra.batch_size)))
                  for lo in range(0, extra.batch_size, step)]
    secs, taken, expect = 0.0, 0, 0
    conf = setup["conf"]
    for b, (wire, rows) in enumerate(sends):
        client.send_rows(wire, rows, "127.0.0.1", bridge.port)
        if latched is not None and b < SFU_BURSTS:
            latched[rows] = True
            per_conf = np.bincount(conf[latched], minlength=SFU_CONFS)
            expect += int((per_conf[conf[rows]] - 1).sum())
        got = 0
        for _ in range(200):
            t0 = time.perf_counter()
            got += bridge.tick(now=now)["rx"]
            secs += time.perf_counter() - t0
            if got >= len(rows):
                break
        require(got == len(rows), f"sfu tick {t} burst {b}: the bridge "
                                  f"took {got} of {len(rows)} datagrams")
        taken += got
    return secs, taken, expect


def sfu_run(torch, dev, setup) -> dict:
    """The SFU path on the card, driven as a user drives it: stage and
    commit 1,100 endpoints in 100 conferences, then SFU_TICKS ticks of
    input from one client socket (drained by a thread), emit_feedback
    every SFU_FEEDBACK ticks.  The bridge's fan-out calls are logged
    (rows, legs) and its sends kept at SFU_CPU_TICKS; a snapshot is taken
    before the tick the CPU run resumes from."""
    import threading

    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.kernels import build as kbuild

    bridge = _sfu_bridge(torch, dev, setup)
    sends = _Sends(bridge)
    fanout = []
    emit_fanout = bridge._emit_fanout

    def logged(wire, recv, origin=None):
        ready = np.nonzero(bridge.loop.addr_port[recv] != 0)[0]
        fanout.append((wire.data[ready], np.asarray(wire.length)[ready],
                       recv[ready]))
        return emit_fanout(wire, recv, origin=origin)

    bridge._emit_fanout = logged
    client = UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=4096,
                       rcvbuf=64 << 20)
    got, stop = [], threading.Event()

    def drain():
        while not stop.is_set():
            b, _, _ = client.recv_batch(timeout_ms=5)
            got.extend(b.to_payloads())

    th = threading.Thread(target=drain, daemon=True)
    th.start()
    latched = np.zeros(SFU_N, dtype=bool)
    res = dict(tick_s=[], launches=dict.fromkeys(kbuild.launches, 0),
               expected=0, taken=0, feedback_sent=0, snap=None)
    try:
        for t in range(SFU_TICKS):
            if t == SFU_CPU_TICKS[3]:
                res["snap"] = bridge.snapshot()
            sends.on = t if t in SFU_CPU_TICKS else None
            secs, taken, expect = _sfu_tick(bridge, setup, t, client,
                                            latched)
            sends.on = None
            res["tick_s"].append(secs)
            res["taken"] += taken
            res["expected"] += expect
            if t == SFU_NACK_TICK:
                res["nack"] = dict(
                    retransmitted=bridge.retransmitted,
                    served=bridge.recovery.rtx_requests_served,
                    cache_miss=bridge.recovery.rtx_cache_miss)
            if t % SFU_FEEDBACK == SFU_FEEDBACK - 1:
                res["feedback_sent"] += bridge.emit_feedback(now=1000.0
                                                             + 0.02 * t
                                                             + 0.01)
    finally:
        time.sleep(0.05)
        stop.set()
        th.join()
    res["launches"] = dict(kbuild.launches)
    res["launches_per_tick"] = {k: v / SFU_TICKS
                                for k, v in res["launches"].items()}
    res.update(bridge=bridge, client=client, received=got, fanout=fanout,
               sends=sends.ticks, setup=setup)
    return res


def _sfu_cpu(torch, setup, sends, snap) -> list:
    """The same input through the bridge on the CPU (plain versions): a
    fresh bridge for the first ticks, and one restored from the card
    bridge's snapshot for the ticks up to the NACK tick.  Returns the
    ticks whose sends equal the card's."""
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge

    cpu = torch.device("cpu")
    equal = []
    with UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=64,
                   rcvbuf=1 << 16) as sink:
        for ticks, bridge in (
                (SFU_CPU_TICKS[:3], _sfu_bridge(torch, cpu, setup)),
                (SFU_CPU_TICKS[3:], _keep("sfu cpu restored",
                                          SfuBridge.restore(snap,
                                                            device=cpu)))):
            latched = bridge.loop.addr_port != 0
            bridge.loop.addr_ip[latched] = 0x7F000001
            bridge.loop.addr_port[latched] = sink.port
            kept = _Sends(bridge)
            for t in ticks:
                kept.on = t
                _sfu_tick(bridge, setup, t, sink)
                kept.on = None
                require(kept.ticks.get(t) == sends.get(t),
                        f"sfu tick {t}: the card's sends differ from the "
                        "CPU run's")
                equal.append(t)
            bridge.close()
    return equal


def _fanout_log(setup, fanout) -> tuple:
    """A bridge's fan-out log read back: the leg of each copy (keyed by
    its seq, SSRC and tag), its self-echo and cross-conference copies,
    and the copies logged."""
    from libjitsi_tpu_torch.rtp import header as rtp_header

    conf = setup["conf"]
    sid_of = {int(s): k for k, s in enumerate(setup["ssrc"])}
    leg_of, echo, cross, copies = {}, 0, 0, 0
    for data, length, recv in fanout:
        snd = np.array([sid_of[int(v)] for v in rtp_header.read_u32(
            data, 8)])
        echo += int((snd == recv).sum())
        cross += int((conf[snd] != conf[recv]).sum())
        copies += len(recv)
        for i in range(len(recv)):
            pkt = data[i, :length[i]].tobytes()
            leg_of[pkt[2:4] + pkt[8:12] + pkt[-TAG:]] = int(recv[i])
    return leg_of, echo, cross, copies


def _check_copies(torch, dev, setup, received, leg_of, ticks: int) -> dict:
    """Every (unique) media copy the client received authenticated under
    its leg's key, in a card table of the setup's profile with a row per
    (leg, sender), and its payload equal to what its sender sent in one
    of the first `ticks` ticks (under AES-F8 the copy decrypts to it,
    under NULL it carries it in clear).  Returns the counts."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    conf, ssrc = setup["conf"], setup["ssrc"]
    sid_of = {int(s): k for k, s in enumerate(ssrc)}
    got = [p for p in received if not 192 <= p[1] <= 223]
    uniq = list(dict.fromkeys(got))
    rows = {}
    for leg in range(SFU_N):
        mates = [m for m in range(conf[leg] * SFU_SIZE,
                                  conf[leg] * SFU_SIZE + SFU_SIZE)
                 if m != leg]
        for j, m in enumerate(mates):
            rows[(leg, m)] = leg * (SFU_SIZE - 1) + j
    down = SrtpStreamTable(len(rows), SrtpProfile[setup["profile"]],
                           device=dev)
    tk, ts = setup["keys"]["tx"]
    legs = np.repeat(np.arange(SFU_N), SFU_SIZE - 1)
    down.add_streams(np.arange(len(rows)), tk[legs], ts[legs])
    batch = PacketBatch.from_payloads(uniq, capacity=224)
    hdr = rtp_header.parse(batch)
    unknown = 0
    for i, p in enumerate(uniq):
        leg = leg_of.get(p[2:4] + p[8:12] + p[-TAG:])
        if leg is None:
            unknown += 1
            batch.stream[i] = -1
        else:
            batch.stream[i] = rows[(leg, sid_of[int(hdr.ssrc[i])])]
    require(unknown == 0, f"sfu: {unknown} received copies the bridge "
                          "never fanned out")
    # what each sender sent, [tick, sender, 160] zero-padded
    plen = np.array([[len(p) for p in tick] for tick in setup["payloads"]])
    pay = np.zeros(plen.shape + (160,), np.uint8)
    for t, tick in enumerate(setup["payloads"]):
        for k, p in enumerate(tick):
            pay[t, k, :len(p)] = np.frombuffer(p, np.uint8)
    by_ssrc = np.argsort(ssrc)
    authed = 0
    step = SFU_N * (SFU_SIZE - 1)
    for lo in range(0, batch.batch_size, step):      # in arrival order
        part = PacketBatch(batch.data[lo:lo + step],
                           batch.length[lo:lo + step],
                           batch.stream[lo:lo + step])
        dec, ok = down.unprotect_rtp(part)
        require(ok.all(), f"sfu: {int((~ok).sum())} received copies "
                          "failed authentication under their leg's key")
        authed += int(ok.sum())
        dh = rtp_header.parse(dec)
        k = by_ssrc[np.searchsorted(ssrc, dh.ssrc.astype(np.int64),
                                    sorter=by_ssrc)]
        t = (dh.seq.astype(np.int64) - setup["seq0"][k]) & 0xFFFF
        require(bool((t < ticks).all() and (dh.payload_off == HDR + 8)
                     .all()), "sfu: a copy's seq or header is not its "
                              "sender's")
        body = dec.data[:, HDR + 8:HDR + 8 + 160]
        n_pay = np.asarray(dec.length) - HDR - 8
        body = np.where(np.arange(160)[None, :] < n_pay[:, None], body, 0)
        require(bool((n_pay == plen[t, k]).all()
                     and (body == pay[t, k]).all()),
                "sfu: a decrypted copy differs from what its sender sent")
    return dict(copies_received=len(got), copies_unique=len(uniq),
                copies_authenticated=authed,
                feedback_received=len(received) - len(got))


def sfu_check(torch, dev, run) -> None:
    """Gates of the SFU path: no echo and no copy across conferences
    (from the bridge's fan-out log), `forwarded` equal to the accepted
    packets times their latched mates, every NACKed seq served, the
    card's sends equal to the CPU run's at SFU_CPU_TICKS, and every copy
    the client received authenticated under its leg's key and equal to
    what its sender sent.  Then SFU_PROFILED more ticks under
    torch.profiler, and the gates of the pipelined run
    (`sfu_pipelined_check`)."""
    setup, bridge = run["setup"], run["bridge"]
    require(int(bridge.rx_table.auth_fail.sum()) == 0
            and int(bridge.rx_table.replay_reject.sum()) == 0,
            "the bridge rejected genuine uplink packets")
    require(run["taken"] == SFU_TICKS * SFU_N + sum(
        w.batch_size for w in setup["rtcp"].values()),
        "the bridge did not take every datagram sent")
    leg_of, echo, cross, copies = _fanout_log(setup, run["fanout"])
    require(echo == 0 and cross == 0,
            f"sfu: {echo} self-echo and {cross} cross-conference copies")
    require(bridge.forwarded == copies == run["expected"],
            f"sfu: forwarded {bridge.forwarded}, logged {copies}, "
            f"expected {run['expected']}")
    nack = run["nack"]
    n_nacked = 3 * len(setup["nacked"])
    require(nack["retransmitted"] == nack["served"] == n_nacked
            and nack["cache_miss"] == 0, f"sfu NACK service: {nack}")
    t0 = time.perf_counter()
    equal = _sfu_cpu(torch, setup, run["sends"], run["snap"])
    cpu_s = time.perf_counter() - t0
    counts = _check_copies(torch, dev, setup, run["received"], leg_of,
                           SFU_TICKS)
    rcvbuf = run["client"].rcvbuf
    forwarded = bridge.forwarded
    prof = _sfu_profile(torch, bridge, setup, run["client"])
    bridge.close()
    run["client"].close()
    secs = np.array(run["tick_s"])
    run["tick_ms"] = (float(np.median(secs)) * 1e3,
                      float(np.percentile(secs, 99)) * 1e3)
    emit("sfu", conferences=SFU_CONFS, endpoints=SFU_N,
         legs_per_tick=SFU_N * (SFU_SIZE - 1), ticks=SFU_TICKS,
         bursts_per_tick=SFU_BURSTS,
         tick_ms_p50=float(np.median(secs)) * 1e3,
         tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
         tick_ms_max=float(secs.max()) * 1e3,
         ptime_share_p50=float(np.median(secs)) / 0.02,
         forwarded=forwarded, expected_forwarded=run["expected"],
         retransmitted=nack["retransmitted"], nacked=n_nacked,
         feedback_sent=run["feedback_sent"],
         client_rcvbuf_bytes=rcvbuf, **counts,
         self_echo=0, cross_conference=0, equal_to_cpu_ticks=equal,
         cpu_run_s=cpu_s, launches_per_tick=run["launches_per_tick"],
         profile=prof)
    sfu_pipelined_check(torch, dev, run["pipelined"])


def _sfu_drive(torch, dev, setup, ticks: int, feedback_every: int = 0,
               nack_tick: int = -1, **kwargs) -> dict:
    """A fresh bridge of the setup's profile (`kwargs` to SfuBridge)
    driven through the setup's first `ticks` ticks of input from one
    client socket (drained by a thread), with `emit_feedback` every
    `feedback_every` ticks where that is set and the NACK service read
    after `nack_tick`, then idle ticks, which ship a pipelined bridge's
    last fan-out.  Returns the bridge, its fan-out log, the client's
    datagrams, each tick's bridge seconds and the forwards a serial
    bridge makes."""
    import threading

    from libjitsi_tpu_torch.io.udp import UdpEngine

    bridge = _sfu_bridge(torch, dev, setup, **kwargs)
    fanout = []
    emit_fanout = bridge._emit_fanout

    def logged(wire, recv, origin=None):
        ready = np.nonzero(bridge.loop.addr_port[recv] != 0)[0]
        fanout.append((wire.data[ready], np.asarray(wire.length)[ready],
                       recv[ready]))
        return emit_fanout(wire, recv, origin=origin)

    bridge._emit_fanout = logged
    client = UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=4096,
                       rcvbuf=64 << 20)
    got, stop = [], threading.Event()

    def drain():
        while not stop.is_set():
            b, _, _ = client.recv_batch(timeout_ms=5)
            got.extend(b.to_payloads())

    th = threading.Thread(target=drain, daemon=True)
    th.start()
    latched = np.zeros(SFU_N, dtype=bool)
    res = dict(tick_s=[], expected=0, taken=0, feedback_sent=0)
    try:
        for t in range(ticks):
            secs, taken, expect = _sfu_tick(bridge, setup, t, client,
                                            latched)
            res["tick_s"].append(secs)
            res["taken"] += taken
            res["expected"] += expect
            if t == nack_tick:
                res["nack"] = dict(
                    retransmitted=bridge.retransmitted,
                    served=bridge.recovery.rtx_requests_served,
                    cache_miss=bridge.recovery.rtx_cache_miss)
            if feedback_every and t % feedback_every == feedback_every - 1:
                res["feedback_sent"] += bridge.emit_feedback(
                    now=1000.0 + 0.02 * t + 0.01)
        for _ in range(3):
            bridge.tick(now=1000.0 + 0.02 * ticks)
    finally:
        time.sleep(0.05)
        stop.set()
        th.join()
    res.update(bridge=bridge, client=client, received=got, fanout=fanout,
               setup=setup)
    return res


def _journey_p99_bucket(hist) -> float:
    """The `le` edge of the journey histogram's bucket that holds the
    99th percentile (inf if it overflowed)."""
    cum = np.cumsum(hist.bucket_counts)
    if cum[-1] == 0:
        return float("nan")
    i = int(np.searchsorted(cum, int(np.ceil(0.99 * cum[-1]))))
    return float(hist.uppers[i]) if i < len(hist.uppers) else float("inf")


def sfu_path(torch, dev, setup) -> dict:
    """The sfu path: the serial bridge's run (`sfu_run`), then a
    `pipelined=True` bridge through SFU_PIPE_TICKS ticks of the same
    input."""
    run = sfu_run(torch, dev, setup)
    run["pipelined"] = _sfu_drive(torch, dev, setup, SFU_PIPE_TICKS,
                                  pipelined=True)
    return run


def sfu_pipelined_check(torch, dev, run) -> None:
    """Gates of the pipelined SfuBridge: no fan-out left in flight, no
    echo and no copy across conferences, every logged copy delivered to
    the client exactly once (its fan-out ships a burst later, to every
    mate latched by then, so at least the serial bridge's forwards), each
    authenticated under its leg's key and equal to what its sender
    sent."""
    setup, bridge = run["setup"], run["bridge"]
    require(not bridge._pending_fanout, "a pipelined fan-out never shipped")
    leg_of, echo, cross, copies = _fanout_log(setup, run["fanout"])
    require(echo == 0 and cross == 0, f"sfu pipelined: {echo} self-echo "
                                      f"and {cross} cross-conference copies")
    counts = _check_copies(torch, dev, setup, run["received"], leg_of,
                           SFU_PIPE_TICKS)
    require(bridge.forwarded == copies == counts["copies_received"]
            == counts["copies_unique"] >= run["expected"],
            f"sfu pipelined: forwarded {bridge.forwarded}, logged {copies}, "
            f"received {counts}, serial forwards {run['expected']}")
    journey = bridge.loop.journey_hist
    require(journey.count == copies, "sfu pipelined: a copy's journey was "
                                     "not observed")
    secs = np.array(run["tick_s"])
    emit("sfu_pipelined", ticks=SFU_PIPE_TICKS,
         tick_ms_p50=float(np.median(secs)) * 1e3,
         tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
         forwarded=bridge.forwarded, serial_forwards=run["expected"],
         journey_p99_bucket_s=_journey_p99_bucket(journey),
         journey_mean_ms=journey.sum / max(journey.count, 1) * 1e3,
         **counts)
    bridge.close()
    run["client"].close()


def sfu_profiles_run(torch, dev, setups) -> dict:
    """The SFU under NULL_HMAC_SHA1_80 and F8_128_HMAC_SHA1_80 at config
    #5's width (100 conferences x 11 endpoints, 60-160-byte payloads
    with abs-send-time), SFU_PROFILE_TICKS ticks each, on the D and H
    instances of the profile's cipher."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    runs = {prof: _sfu_drive(torch, dev, setups[prof], SFU_PROFILE_TICKS)
            for prof in SFU_PROFILES}
    launches = dict(kbuild.launches)
    return dict(runs=runs, launches_per_tick={
        k: v / (SFU_PROFILE_TICKS * len(SFU_PROFILES))
        for k, v in launches.items()})


def sfu_profiles_check(torch, dev, out) -> None:
    """Per profile: every uplink packet authenticated, `forwarded` equal
    to the accepted packets times their latched mates and to the copies
    the client received, each once, no echo or cross-conference copy,
    and every copy authenticated under its leg's table of the profile
    with the sender's bytes (decrypted under AES-F8, in clear under
    NULL)."""
    for prof, run in out["runs"].items():
        setup, bridge = run["setup"], run["bridge"]
        require(int(bridge.rx_table.auth_fail.sum()) == 0
                and run["taken"] == SFU_PROFILE_TICKS * SFU_N,
                f"sfu {prof}: the bridge did not take every packet")
        leg_of, echo, cross, copies = _fanout_log(setup, run["fanout"])
        require(echo == 0 and cross == 0,
                f"sfu {prof}: {echo} self-echo, {cross} cross-conference")
        counts = _check_copies(torch, dev, setup, run["received"], leg_of,
                               SFU_PROFILE_TICKS)
        require(bridge.forwarded == copies == run["expected"]
                == counts["copies_received"] == counts["copies_unique"],
                f"sfu {prof}: forwarded {bridge.forwarded}, logged "
                f"{copies}, expected {run['expected']}, received {counts}")
        secs = np.array(run["tick_s"])
        emit("sfu_profile", profile=prof, ticks=SFU_PROFILE_TICKS,
             tick_ms_p50=float(np.median(secs)) * 1e3,
             tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
             forwarded=bridge.forwarded, **counts)
        bridge.close()
        run["client"].close()


def _sfu_profile(torch, bridge, setup, client) -> dict:
    """SFU_PROFILED more ticks of the card's bridge under torch.profiler:
    host time per span, the time outside every top-level span, and the
    card's busy and idle share."""
    return _outside_spans(profiled_ticks(
        torch, lambda i: _sfu_tick(bridge, setup, SFU_TICKS + i, client),
        SFU_PROFILED))


def _outside_spans(out: dict) -> dict:
    """A profiled SFU window with the host time outside every top-level
    span added."""
    top = ("ingress", "reverse_chain", "recovery", "forward_chain", "egress")
    spans = out["span_ms_per_tick"]
    out["outside_spans_ms_per_tick"] = out["wall_ms_per_tick"] - sum(
        spans.get(k, 0.0) for k in top)
    return out



# ------------------------------------------- 11. the rest of the SRTP table

def _profile_line(name, shape, times, nbytes, ops, floor_ms, chain_ms=None):
    b_ms, b_by = bound(nbytes, ops)
    line = dict(name=name, shape=shape, max_abs_err=0, **times,
                bound_ms=b_ms, bound_by=b_by, launch_floor_ms=floor_ms,
                library_ms=None, library="none", bytes=nbytes, ops=ops)
    if chain_ms is not None:
        line["chain_floor_ms"] = chain_ms
    return line


def profile_kernels(torch, dev, floor_ms: float, chain: dict,
                    parent_lib=None) -> dict:
    """K and L (AES-F8) and the NULL instances of C and D against their
    plain versions at the three launches the table makes for one 4,096-
    packet production-mix batch (the parts `bucket_by_size` gives), and
    the F8 and NULL instances of I and J at the path's SRTCP launch
    (1,100 compound packets of 60-200 bytes in 1,504-byte rows), I-NULL
    and J-NULL also at their other launches on the paths (NULL_SHAPES).
    Each line has its bound; the F8 lines also `chain_floor_ms`: per
    launch, the launch floor plus the longest row's dependent AES pair
    steps (its keystream blocks and IV') at `latency_floor`'s AES-128
    `aes_pair_cycles` and clock; the NULL SRTCP lines their MAC chain
    floor (`mac_floor_ms`) and their share of it and of their bound.  The
    `kernels` line takes the SRTP kernels' sums over the batch's three
    launches and the SRTCP kernels' path launch.  No PyTorch call
    computes SRTP, so none has a library time.  Then K's and L's phase
    split and plans at the batch's launches (`srtp_f8_phases`,
    `srtp_f8_plans`), I-NULL's and J-NULL's at NULL_SHAPES
    (`srtcp_null_phases`, `srtcp_null_plans`) and, with a parent, the
    turns of all four against the parent's (`srtp_f8_turns`,
    `srtcp_null_turns`)."""
    from libjitsi_tpu_torch.core.packet import bucket_by_size
    from libjitsi_tpu_torch.kernels import aes
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.transform.srtp import kernel as sk

    rng = np.random.default_rng(31)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev)

    rk_np, mid_np = _key_tables(rng, N_STREAMS)
    tab_rk, tab_mid = t(rk_np), t(mid_np)
    tab_f8 = t(aes.expand_keys_batch(rng.integers(0, 256, (N_STREAMS, 16),
                                                  np.uint8)))
    pair_ms = chain["aes_pair_cycles"]["aes128"] / (chain["mhz"] * 1e3)
    mix = _mix_batch(rng, rng.permutation(N_STREAMS)[:BATCH], 1000, 0)
    parts = bucket_by_size(mix)
    rows = {}
    f8_cases, null_cases = [], []
    for cipher in ("f8", "null"):
        f8 = tab_f8 if cipher == "f8" else None
        keys_per = 11 * 16 * (2 if cipher == "f8" else 0) + 40
        acc = {}
        labels = []
        for _rows, part, n_real in parts:
            n, width = part.data.shape
            length = part.length.astype(np.int64)
            label = f"{n}x{width} ({n_real} real rows)"
            labels.append(label)
            args = [tab_rk, tab_mid, t(part.stream.astype(np.int32)),
                    t(part.data), t(part.length.astype(np.int32)),
                    torch.full((n,), HDR, dtype=torch.int32, device=dev),
                    t(rng.integers(0, 256, (n, 16), np.uint8)),
                    t(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32))]
            kp = sk.srtp_protect(*args, TAG, cipher, f8)
            require(max_abs_err(torch, kp, sk.srtp_protect_plain(
                *args, TAG, cipher, f8)) == 0,
                f"srtp_protect_{cipher} {label} differs from its plain "
                f"version")
            uargs = args[:3] + [kp[0], kp[1]] + args[5:]
            ku = sk.srtp_unprotect(*uargs, TAG, cipher, f8)
            if cipher == "f8":
                f8_cases.append((label, args, uargs, f8, kp, ku))
            require(bool(ku[2].all()), f"srtp_unprotect_{cipher} rejected "
                                       f"genuine rows ({label})")
            require(max_abs_err(torch, ku, sk.srtp_unprotect_plain(
                *uargs, TAG, cipher, f8)) == 0,
                f"srtp_unprotect_{cipher} {label} differs from its plain "
                f"version")
            ks_blocks = (length - HDR + 15) // 16
            mac_blocks = int(((length + 4 + 9 + 63) // 64).sum()) + n
            ops = mac_blocks * SHA1_BLOCK_OPS
            if cipher == "f8":
                ops += (int(ks_blocks.sum()) + n) * aes_block_ops(10) \
                    + int(ks_blocks.sum()) * CTR_XOR_OPS
            nbytes = (2 * n * width + n * (5 * 4 + 16)
                      + len(np.unique(part.stream)) * keys_per)
            chain_ms = (floor_ms + (int(ks_blocks.max()) + 1) * pair_ms
                        if cipher == "f8" else
                        mac_floor_ms(floor_ms, chain, int(length.max()) + 4))
            for direction, fn, plain in (
                    ("protect", lambda: sk.srtp_protect(*args, TAG, cipher,
                                                        f8),
                     lambda: sk.srtp_protect_plain(*args, TAG, cipher, f8)),
                    ("unprotect", lambda: sk.srtp_unprotect(*uargs, TAG,
                                                            cipher, f8),
                     lambda: sk.srtp_unprotect_plain(*uargs, TAG, cipher,
                                                     f8))):
                name = f"srtp_{direction}_{cipher}"
                line = _profile_line(
                    name, label + " (table path)",
                    _crypto_times(torch, fn, name + "_kernel", plain),
                    nbytes, ops, floor_ms, chain_ms)
                emit("kernel_vs_plain", **line)
                a = acc.setdefault(name, dict(ms=0.0, call_ms=0.0,
                                              plain_ms=0.0, bytes=0, ops=0,
                                              chain_floor_ms=0.0))
                for k in ("ms", "call_ms", "plain_ms", "bytes", "ops"):
                    a[k] += line[k]
                a["chain_floor_ms"] += chain_ms
        for name, a in acc.items():
            times = {k: a[k] for k in ("ms", "call_ms", "plain_ms")}
            rows[name] = _profile_line(
                name, f"one {BATCH}-packet production-mix batch as the "
                      f"table buckets it, {len(labels)} launches: "
                      + " + ".join(labels), times, a["bytes"], a["ops"],
                floor_ms, a["chain_floor_ms"])
        # SRTCP at the path's launch: 1,100 compound packets in 1,504-byte
        # rows, E set under F8 and clear under NULL; NULL also at I-NULL's
        # and J-NULL's other launches on the paths
        for k, (label, n, lo, hi) in enumerate(
                NULL_SHAPES if cipher == "null" else NULL_SHAPES[:1]):
            width = 1504
            lens = rng.integers(lo, hi, n).astype(np.int32)
            e = 0 if cipher == "null" else 1 << 31
            pa = [tab_rk, tab_mid,
                  t(rng.permutation(N_STREAMS)[:n].astype(np.int32)),
                  t(rng.integers(0, 256, (n, width), np.uint8)), t(lens),
                  t(rng.integers(0, 256, (n, 16), np.uint8)),
                  t((rng.integers(0, 2 ** 31, n) | e).astype(np.uint32)
                    .view(np.int32))]
            kp = sk.srtcp_protect(*pa, TAG, cipher, f8)
            require(max_abs_err(torch, kp, sk.srtcp_protect_plain(
                *pa, TAG, cipher, f8)) == 0,
                f"srtcp_protect_{cipher} differs from its plain version at "
                f"{label}")
            ua = pa[:3] + [kp[0], kp[1], pa[5]]
            ku = sk.srtcp_unprotect(*ua, TAG, cipher, f8)
            require(bool(ku[2].all()), f"srtcp_unprotect_{cipher} rejected "
                                       f"genuine rows at {label}")
            require(max_abs_err(torch, ku, sk.srtcp_unprotect_plain(
                *ua, TAG, cipher, f8)) == 0,
                f"srtcp_unprotect_{cipher} differs from its plain version "
                f"at {label}")
            if cipher == "null":
                null_cases.append((label, pa, ua, kp, ku))
            ks_blocks = (lens.astype(np.int64) - 8 + 15) // 16
            mac_blocks = int(((lens + 4 + 9 + 63) // 64 + 1).sum())
            ops = mac_blocks * SHA1_BLOCK_OPS
            if cipher == "f8":
                ops += (int(ks_blocks.sum()) + n) * aes_block_ops(10) \
                    + int(ks_blocks.sum()) * CTR_XOR_OPS
            chain_ms = (floor_ms + (int(ks_blocks.max()) + 1) * pair_ms
                        if cipher == "f8" else
                        mac_floor_ms(floor_ms, chain, int(lens.max()) + 4))
            for direction, fn, plain in (
                    ("protect", lambda: sk.srtcp_protect(*pa, TAG, cipher,
                                                         f8),
                     lambda: sk.srtcp_protect_plain(*pa, TAG, cipher, f8)),
                    ("unprotect", lambda: sk.srtcp_unprotect(*ua, TAG,
                                                             cipher, f8),
                     lambda: sk.srtcp_unprotect_plain(*ua, TAG, cipher,
                                                      f8))):
                name = f"srtcp_{direction}_{cipher}"
                nbytes = 2 * n * width + n * (
                    SRTCP_ROW_BYTES[direction] + keys_per
                    + (16 if cipher == "f8" else 0))
                line = _profile_line(
                    name, label, _crypto_times(torch, fn, name + "_kernel",
                                               plain),
                    nbytes, ops, floor_ms, chain_ms)
                if cipher == "null":
                    line.update(share_of_mac_floor=chain_ms / line["ms"],
                                share_of_bound=line["bound_ms"] / line["ms"])
                emit("kernel_vs_plain", **line)
                if k == 0:
                    rows[name] = line
    lib = kbuild.library()
    srtp_f8_phases(torch, dev, lib, f8_cases, "this tree")
    srtp_f8_plans(torch, dev, lib, f8_cases)
    srtcp_null_phases(torch, dev, lib, null_cases, "this tree")
    srtcp_null_plans(torch, dev, lib, null_cases)
    if parent_lib is not None:
        if hasattr(parent_lib, "ljt_srtp_f8_phases"):
            srtp_f8_phases(torch, dev, parent_lib, f8_cases, "parent")
        srtp_f8_turns(torch, dev, parent_lib, f8_cases)
        if hasattr(parent_lib, "ljt_srtcp_null_phases"):
            srtcp_null_phases(torch, dev, parent_lib, null_cases, "parent")
        srtcp_null_turns(torch, dev, parent_lib, null_cases)
    return rows


def _rtcp_batch(rng, streams):
    """Compound-RTCP-sized packets of 60-200 bytes (an SR header, sender
    SSRC 0x10000 + stream, then random report bytes), one a stream."""
    from libjitsi_tpu_torch.core.packet import PacketBatch

    pkts = []
    for sid in streams:
        n = int(rng.integers(60, 201)) // 4 * 4
        pkts.append(bytes([0x80, 200, 0, n // 4 - 1])
                    + (0x10000 + int(sid)).to_bytes(4, "big")
                    + rng.integers(0, 256, n - 8, np.uint8).tobytes())
    return PacketBatch.from_payloads(pkts, stream=streams.tolist())


def _with_replay(wire, earlier, row: int, tamper: int):
    """`wire` with row `tamper` changed and row `row` of `earlier` (a
    packet already accepted) appended: the rows that must fail."""
    from libjitsi_tpu_torch.core.packet import PacketBatch

    cap = max(wire.capacity, earlier.capacity)
    data = np.zeros((wire.batch_size + 1, cap), np.uint8)
    data[:-1, :wire.capacity] = wire.data
    data[-1, :earlier.capacity] = earlier.data[row]
    data[tamper, HDR + 1] ^= 0x5A
    return PacketBatch(data, np.append(wire.length, earlier.length[row])
                       .astype(np.int32),
                       np.append(wire.stream, earlier.stream[row])
                       .astype(np.int32))


def _kdr_batch(rng, k: int):
    """A 4,096-packet mix batch in which each of the KDR_STREAMS kdr
    streams sends two packets whose indices straddle an epoch boundary
    (15 + 16k and 16 + 16k) and 2,048 other streams one each."""
    from libjitsi_tpu_torch.rtp import header as rtp_header

    others = KDR_STREAMS + rng.permutation(N_STREAMS - KDR_STREAMS)[
        :BATCH - 2 * KDR_STREAMS]
    streams = np.concatenate([np.arange(KDR_STREAMS)] * 2 + [others])
    seqs = np.concatenate([np.full(KDR_STREAMS, KDR - 1 + KDR * k),
                           np.full(KDR_STREAMS, KDR + KDR * k),
                           np.full(len(others), 1000 + k)])
    lens = production_lengths(rng, len(streams))
    payloads = [rng.integers(0, 256, int(n), np.uint8).tobytes()
                for n in lens]
    return rtp_header.build(payloads, seqs.tolist(), [k * 960] * len(seqs),
                            (0x10000 + streams).tolist(),
                            [96] * len(seqs), stream=streams.tolist())


def srtp_profiles_run(torch, dev) -> dict:
    """The srtp_profiles path on the card.  For F8_128_HMAC_SHA1_80 and
    NULL_HMAC_SHA1_80: tx and rx tables of 10,240 streams, PROFILE_BATCHES
    production-mix batches protected and unprotected (every row ok, its
    bytes back), a tampered row and a replayed one rejected, an SRTCP
    round trip of 1,100 rows.  Then an AES_CM_128_HMAC_SHA1_80 pair whose
    first 1,024 streams have kdr = 2**4, through batches that cross an
    epoch mid-batch; then, on the same tables, a depth-2 pipeline of
    `protect_rtp_async` / `unprotect_rtp_async` over the other streams
    (batch n + 1 dispatched before batch n's result), with a key install
    while a protect is pending.  Snapshots taken before each part let
    `srtp_profiles_check` replay it elsewhere."""
    from libjitsi_tpu_torch.core.rtp_math import chain_packet_indices
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    rng = np.random.default_rng(41)
    sids = np.arange(N_STREAMS)
    mks = rng.integers(0, 256, (N_STREAMS, 16), np.uint8)
    mss = rng.integers(0, 256, (N_STREAMS, 14), np.uint8)
    out = {"profiles": {}}
    per_batch = dict.fromkeys(PROFILE_KERNELS, 0)
    for profile in (SrtpProfile.F8_128_HMAC_SHA1_80,
                    SrtpProfile.NULL_HMAC_SHA1_80):
        tx = SrtpStreamTable(N_STREAMS, profile, device=dev)
        rx = SrtpStreamTable(N_STREAMS, profile, device=dev)
        tx.add_streams(sids, mks, mss)
        rx.add_streams(sids, mks, mss)
        run = dict(snap=(tx.snapshot(), rx.snapshot()), batches=[],
                   wires=[], prot_s=[], unprot_s=[])
        before = dict(kbuild.launches)
        for k in range(PROFILE_BATCHES):
            batch = _mix_batch(rng, rng.permutation(N_STREAMS)[:BATCH],
                               1000 + k, k * 960)
            t1 = time.perf_counter()
            wire = tx.protect_rtp(batch)
            t2 = time.perf_counter()
            dec, ok = rx.unprotect_rtp(wire)
            t3 = time.perf_counter()
            require(ok.all(), f"{profile.value} batch {k}: "
                              f"{int((~ok).sum())} genuine rows failed")
            require(dec.to_payloads() == batch.to_payloads(),
                    f"{profile.value} batch {k}: decrypted bytes differ")
            run["batches"].append(batch)
            run["wires"].append(wire)
            run["prot_s"].append(t2 - t1)
            run["unprot_s"].append(t3 - t2)
        for name in PROFILE_KERNELS:
            per_batch[name] += (kbuild.launches[name] - before[name]) \
                / PROFILE_BATCHES
        # a tampered row and a replayed one among a fresh batch's
        batch = _mix_batch(rng, rng.permutation(N_STREAMS)[:BATCH], 2000,
                           99 * 960)
        wire = tx.protect_rtp(batch)
        bad = _with_replay(wire, run["wires"][0], 3, 7)
        _, ok = rx.unprotect_rtp(bad)
        want = np.ones(BATCH + 1, bool)
        want[[7, BATCH]] = False
        require(np.array_equal(ok, want), f"{profile.value}: the tampered "
                "and the replayed row are not exactly the rejected ones")
        run["bad"] = (batch, wire, bad, ok)
        rtcp = _rtcp_batch(rng, rng.permutation(N_STREAMS)[:PROFILE_RTCP])
        wire_c = tx.protect_rtcp(rtcp)
        dec_c, ok_c = rx.unprotect_rtcp(wire_c)
        require(ok_c.all() and dec_c.to_payloads() == rtcp.to_payloads(),
                f"{profile.value}: the SRTCP round trip failed")
        run["rtcp"] = (rtcp, wire_c)
        out["profiles"][profile.value] = run
    # kdr: 1,024 streams re-keyed every 16 packets, crossing mid-batch
    kdr = np.zeros(N_STREAMS, np.int64)
    kdr[:KDR_STREAMS] = KDR
    ktx = SrtpStreamTable(N_STREAMS, device=dev)
    krx = SrtpStreamTable(N_STREAMS, device=dev)
    ktx.add_streams(sids, mks, mss, kdr=kdr)
    krx.add_streams(sids, mks, mss, kdr=kdr)
    kd = dict(snap=(ktx.snapshot(), krx.snapshot()), batches=[], wires=[],
              waves=[], prot_s=[], unprot_s=[])
    for k in range(2):
        batch = _kdr_batch(rng, k)
        stream = np.asarray(batch.stream, np.int64)
        waves, _ = ktx._epoch_plan(stream, chain_packet_indices(
            stream, rtp_header.parse(batch).seq, ktx.tx_ext), rtcp=False)
        t1 = time.perf_counter()
        wire = ktx.protect_rtp(batch)
        t2 = time.perf_counter()
        dec, ok = krx.unprotect_rtp(wire)
        t3 = time.perf_counter()
        require(waves is not None and len(waves) > 1,
                "the kdr batch did not cross an epoch")
        require(ok.all() and dec.to_payloads() == batch.to_payloads(),
                f"kdr batch {k}: genuine rows failed or differ")
        kd["batches"].append(batch)
        kd["wires"].append(wire)
        kd["waves"].append(len(waves))
        kd["prot_s"].append(t2 - t1)
        kd["unprot_s"].append(t3 - t2)
    require(np.all(ktx._epoch_rtp[:KDR_STREAMS] == 2)
            and np.all(krx._epoch_rtp[:KDR_STREAMS] == 2),
            "the kdr streams are not in epoch 2")
    out["kdr"] = kd
    # async at depth 2 over the kdr = 0 streams (kdr batches take the sync
    # path), a key install while a protect is pending
    pool = KDR_STREAMS + rng.permutation(N_STREAMS - KDR_STREAMS)
    installed = int(pool[0])           # carried by batch 1 alone
    batches = []
    for k in range(ASYNC_BATCHES):
        streams = rng.permutation(pool[1:])[:BATCH]
        if k == 1:
            streams[0] = installed
        batches.append(_mix_batch(rng, streams, 3000 + k, k * 960))
    asy = dict(snap=(ktx.snapshot(), krx.snapshot()), batches=batches,
               installed=installed)
    wires, results, pend_rx = [], [], []
    pend_tx = ktx.protect_rtp_async(batches[0])
    for k in range(1, ASYNC_BATCHES + 1):
        nxt = (ktx.protect_rtp_async(batches[k]) if k < ASYNC_BATCHES
               else None)
        if k == 2:
            # batch 1 is pending (its result not taken): a new key for a
            # stream it carries
            ktx.add_stream(installed, bytes(16), bytes(14))
        wire = pend_tx.result()
        wires.append(wire)
        pend_rx.append(krx.unprotect_rtp_async(wire))
        if len(pend_rx) == 2:
            results.append(pend_rx.pop(0).result())
        pend_tx = nxt
    krx.commit_inflight()
    results.append(pend_rx.pop(0).result())
    for k, (dec, ok) in enumerate(results):
        require(ok.all() and dec.to_payloads() == batches[k].to_payloads(),
                f"async batch {k}: genuine rows failed or differ")
    asy.update(wires=wires, results=results,
               state={f: getattr(krx, f).copy() for f in (
                   "rx_max", "rx_mask", "auth_fail", "replay_reject")})
    out["async"] = asy
    out["launches_per_batch"] = per_batch
    return out


def srtp_profiles_check(torch, dev, run, table) -> None:
    """The srtp_profiles path held elsewhere: F8, NULL and kdr tables on
    the CPU, restored from the card tables' snapshots, give the card's
    wire bytes and verdicts on the same batches (SRTCP too); the async
    pipeline's wire, bytes and final rx state equal the sync calls of
    card tables restored from the snapshot taken before it.  Emits each
    profile's batch protect and unprotect p50/p99 (host clock) beside
    the CM table's from `table_path`."""
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    t0 = time.perf_counter()
    lines = {}
    for name, prof in run["profiles"].items():
        tx, rx = (SrtpStreamTable.restore(s, "cpu") for s in prof["snap"])
        for k, (batch, wire) in enumerate(zip(prof["batches"],
                                              prof["wires"])):
            cpu_wire = tx.protect_rtp(batch)
            require(np.array_equal(cpu_wire.data, wire.data)
                    and np.array_equal(cpu_wire.length, wire.length),
                    f"{name} batch {k}: the card's wire differs from the "
                    f"CPU table's")
            rx.unprotect_rtp(cpu_wire)
        batch, wire, bad, ok = prof["bad"]
        require(np.array_equal(tx.protect_rtp(batch).data, wire.data),
                f"{name}: the card's wire differs from the CPU table's")
        _, cpu_ok = rx.unprotect_rtp(bad)
        require(np.array_equal(cpu_ok, ok), f"{name}: tampered/replayed "
                                            f"verdicts differ on the CPU")
        rtcp, wire_c = prof["rtcp"]
        cpu_c = tx.protect_rtcp(rtcp)
        require(np.array_equal(cpu_c.data, wire_c.data),
                f"{name}: the card's SRTCP wire differs from the CPU's")
        _, ok_c = rx.unprotect_rtcp(cpu_c)
        require(ok_c.all(), f"{name}: SRTCP failed on the CPU")
        lines[name] = {f"{d}_ms_{q}": float(np.percentile(
            prof[f"{'prot' if d == 'protect' else 'unprot'}_s"], pct)) * 1e3
            for d in ("protect", "unprotect")
            for q, pct in (("p50", 50), ("p99", 99))}
    kd = run["kdr"]
    tx, rx = (SrtpStreamTable.restore(s, "cpu") for s in kd["snap"])
    for k, (batch, wire) in enumerate(zip(kd["batches"], kd["wires"])):
        cpu_wire = tx.protect_rtp(batch)
        require(np.array_equal(cpu_wire.data, wire.data),
                f"kdr batch {k}: the card's wire differs from the CPU's")
        _, ok = rx.unprotect_rtp(cpu_wire)
        require(ok.all(), f"kdr batch {k}: failed on the CPU")
    asy = run["async"]
    stx, srx = (SrtpStreamTable.restore(s, dev) for s in asy["snap"])
    for k, batch in enumerate(asy["batches"]):
        wire = stx.protect_rtp(batch)
        require(wire.to_payloads() == asy["wires"][k].to_payloads(),
                f"async batch {k}: the pipeline's wire differs from the "
                f"sync call's")
        dec, ok = srx.unprotect_rtp(wire)
        a_dec, a_ok = asy["results"][k]
        require(np.array_equal(ok, a_ok) and np.array_equal(dec.data,
                                                            a_dec.data),
                f"async batch {k}: the pipeline's verdicts differ")
    for f, v in asy["state"].items():
        require(np.array_equal(getattr(srx, f), v),
                f"async: {f} differs from the sync calls'")
    cm = {k: table[k] for k in ("protect_ms_p50", "protect_ms_p99",
                                "unprotect_ms_p50", "unprotect_ms_p99")}
    emit("srtp_profiles", streams=N_STREAMS, batch=BATCH,
         batches_per_profile=PROFILE_BATCHES, host_ms=lines,
         cm_table_path_ms=cm, kdr_streams=KDR_STREAMS, kdr=KDR,
         kdr_waves=kd["waves"],
         kdr_protect_ms=[x * 1e3 for x in kd["prot_s"]],
         kdr_unprotect_ms=[x * 1e3 for x in kd["unprot_s"]],
         async_batches=ASYNC_BATCHES, async_depth=2,
         async_key_install_stream=asy["installed"],
         srtcp_rows=PROFILE_RTCP, tampered_and_replayed_rejected=True,
         equal_to_cpu=True, async_equal_to_sync=True,
         launches_per_batch=run["launches_per_batch"],
         cpu_check_s=time.perf_counter() - t0)


# ------------------------------------------------------ 12. AEAD-GCM

def gcm_known_answers(torch, dev) -> None:
    """RFC 7714 §16.1.1 (AEAD_AES_128_GCM SRTP) through kernel M, back
    through kernel N, and the same packet with its tag's last byte
    flipped refused by N.  The RFC's example uses its key and salt as
    session key and salt."""
    from libjitsi_tpu_torch.kernels import aes, gcm
    from libjitsi_tpu_torch.transform.srtp import kernel as sk
    from libjitsi_tpu_torch.transform.srtp.context import ghash_tables

    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    salt = bytes.fromhex("517569642070726f2071756f")
    pkt = bytes.fromhex("8040f17b8041f8d35501a0b247616c6c"
                        "696120657374206f6d6e697320646976"
                        "69736120696e207061727465732074726573")
    want = bytes.fromhex("8040f17b8041f8d35501a0b2f24de3a3"
                         "fb34de6cacba861c9d7e4bcabe633bd5"
                         "0d294e6f42a5f47a51c7d19b36de3adf"
                         "8833899d7f27beb16a9152cf765ee439"
                         "0cce")

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev)

    iv = gcm.srtp_gcm_iv(np.frombuffer(salt, np.uint8)[None],
                         [int.from_bytes(pkt[8:12], "big")],
                         [int.from_bytes(pkt[2:4], "big")])
    rk = aes.expand_key(key)[None]
    tabs = (t(rk), t(ghash_tables(rk).view(np.int32)),
            t(np.zeros(2, np.int32)))
    data = np.zeros((2, 128), np.uint8)
    data[:, :len(pkt)] = np.frombuffer(pkt, np.uint8)
    aad, ivs = t(np.full(2, 12, np.int32)), t(np.repeat(iv, 2, axis=0))
    out, out_len = sk.srtp_gcm_protect(*tabs, t(data),
                                       t(np.full(2, len(pkt), np.int32)),
                                       aad, ivs)
    sealed = bytes(out.cpu().numpy()[0, :int(out_len[0])])
    require(sealed == want, "RFC 7714 §16.1.1 through kernel M")
    wire = out.clone()
    wire[1, len(want) - 1] ^= 0x01
    dec, mlen, ok = sk.srtp_gcm_unprotect(*tabs, wire, out_len, aad, ivs)
    opened = bytes(dec.cpu().numpy()[0, :int(mlen[0])]) == pkt
    require(ok.cpu().tolist() == [True, False] and opened,
            "RFC 7714 §16.1.1 back through kernel N, the tampered tag "
            "refused")
    emit("gcm_known_answers", rfc7714_16_1_1=True, opened=opened,
         tampered_tag_refused=True)


def _gcm_sass(code: dict, ptxas: dict) -> dict:
    """The GCM kernels' checks on the SASS `sass_counts` parsed (AES-128):
    every local-memory access at the stack pointer plus a constant (a
    spill slot, never an array indexed at run time), and in the GHASH
    chain (the innermost loop around the ballots, `ghash.cuh`) no
    device-memory or local load: the matrix rows sit in registers.
    Counts the chain loop's instructions (and a step's: four ballots a
    step; the loop may hold several), ballots and loads, and the
    probe's (`ghash_chain`)."""
    require(all(k in code for k in GCM_SASS + ("ghash_chain",)),
            f"no SASS for a GCM kernel: {sorted(code)}")
    report = {}
    for k in GCM_SASS + ("ghash_chain",):
        ops = code[k]
        local = [o for _a, op, o in ops if op in ("LDL", "STL")]
        computed = [o for o in local if not re.search(
            r"\[R1(?:\+0x[0-9a-f]+)?\]", o)]
        votes = [a for a, op, _o in ops if op == "VOTE"]
        chain = min((sp for sp in _loop_spans(ops)
                     if any(sp[1] <= v <= sp[2] for v in votes)),
                    default=None)
        body = ([op for a, op, _o in ops if chain[1] <= a <= chain[2]]
                if chain else [])
        report[k] = dict(
            ptxas=ptxas.get(k, {}), local_accesses=len(local),
            local_at_computed_address=computed,
            ghash_chain_instructions=len(body),
            ghash_chain_instructions_per_step=len(body) / max(
                body.count("VOTE") / 4, 1),
            ghash_chain_ballots=body.count("VOTE"),
            ghash_chain_popc=body.count("POPC"),
            ghash_chain_shared_loads=body.count("LDS"),
            ghash_chain_global_or_local_loads=sum(
                op in ("LDG", "LDL", "STL", "LDC") for op in body))
        require(not computed, f"{k}: a local array: {computed}")
        if k != "gcm_ks_fill nr=10":
            require(chain is not None and report[k]["ghash_chain_ballots"]
                    >= 4 and report[k]["ghash_chain_global_or_local_loads"]
                    == 0, f"{k}: the GHASH chain loads from memory other "
                          f"than the staged row: {report[k]}")
    return report


def gcm_floor_ms(floor_ms: float, chain: dict, aad: int, ct: int) -> float:
    """The GCM chain floor of a launch whose longest row has an AAD of
    `aad` and `ct` ciphertext bytes: the launch, that row's Horner steps
    one after another on a warp at `latency_floor`'s `ghash_step_cycles`,
    and one AES-128 pair (its J0 and keystream blocks run beside)."""
    steps = (aad + 15) // 16 + (ct + 15) // 16 + 1
    cyc = steps * chain["ghash_step_cycles"] + chain["aes_pair_cycles"][
        "aes128"]
    return floor_ms + cyc / (chain["mhz"] * 1e3)


def _gcm_ops(aad, ct, aes: bool = True) -> int:
    """INT32-pipe operations of sealing or opening rows of `aad` and `ct`
    bytes (arrays): the keystream blocks' AES and XOR, J0's AES, and the
    GHASH blocks; without `aes` (the cached instances) the XOR and the
    GHASH only."""
    ks = (np.asarray(ct, np.int64) + 15) // 16
    gh = (np.asarray(aad, np.int64) + 15) // 16 + ks + 1
    ops = int(ks.sum()) * CTR_XOR_OPS + int(gh.sum()) * GHASH_BLOCK_OPS
    if aes:
        ops += int(ks.sum() + len(ks)) * aes_block_ops(10)
    return ops


def _gcm_launches(torch, dev, rng, tab_rk, tab_gm) -> list:
    """M's launches on the `srtp_gcm` path over 10,240-row tables: one
    4,096-packet production-mix batch as the table buckets it (3
    launches), then the path's SRTCP launch, 1,100 rows in the kernel
    layout hdr8 || E || index || 60-200-byte payload, AAD 12, 1,504-byte
    rows.  Each a dict: `label`, the seal's `args` (the wrapper's order),
    the rows' ciphertext bytes `ct` and the distinct `streams`."""
    from libjitsi_tpu_torch.core.packet import bucket_by_size

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev)

    out = []
    mix = _mix_batch(rng, rng.permutation(N_STREAMS)[:BATCH], 1000, 0)
    for _rows, part, n_real in bucket_by_size(mix):
        n, width = part.data.shape
        out.append(dict(
            label=f"{n}x{width} ({n_real} real rows)",
            args=[tab_rk, tab_gm, t(part.stream.astype(np.int32)),
                  t(part.data), t(part.length.astype(np.int32)),
                  torch.full((n,), HDR, dtype=torch.int32, device=dev),
                  t(rng.integers(0, 256, (n, 12), np.uint8))],
            ct=part.length.astype(np.int64) - HDR,
            streams=len(np.unique(part.stream))))
    n, width = PROFILE_RTCP, 1504
    plen = rng.integers(60, 201, n).astype(np.int64)
    out.append(dict(
        label=f"{n}x{width} SRTCP 60-200 bytes",
        args=[tab_rk, tab_gm,
              t(rng.permutation(N_STREAMS)[:n].astype(np.int32)),
              t(rng.integers(0, 256, (n, width), np.uint8)),
              t((plen + 4).astype(np.int32)),
              torch.full((n,), 12, dtype=torch.int32, device=dev),
              t(rng.integers(0, 256, (n, 12), np.uint8))],
        ct=plen - 8, streams=n))
    return out


def _phase_split(stamps: np.ndarray, plan) -> dict:
    """A launch's split from the phase probe's stamps ([tiles, 40] clock64
    words, `gcm_tile.cuh`): medians over the tiles of the cycles of set-up
    (start to the first stamp a warp takes after the set-up barrier), the
    keystream (to its barrier, or to the last keystream warp's end where
    the hash overlaps it), the hash (from its first warp's start to the
    join: the last warp's own end or the join barrier's stamp, whichever
    is later, since a clock read after a barrier may issue before the
    last warp arrives) and how long after set-up it starts, the store,
    the whole tile; of a hashing warp's busy cycles (its own stamps) and
    of the cycles each warp waits at the join after its own work; and the
    warps that hash no row."""
    s = stamps[:plan[2]].astype(np.int64)
    warps = s[:, 8:].reshape(len(s), 8, 4)
    used = (warps != 0).any(axis=2)
    hashing = warps[:, :, 2] != 0
    big = np.iinfo(np.int64).max
    starts = np.where(warps[:, :, [0, 2]] != 0, warps[:, :, [0, 2]], big)
    first = starts.min(axis=(1, 2))
    setup_end = np.where(first < big, first, s[:, 1])
    ks_end = np.where(used, warps[:, :, 1], 0).max(axis=1)
    ks_barrier = np.where(s[:, 2] != 0, s[:, 2], ks_end)
    h_start = np.where(hashing, warps[:, :, 2], big).min(axis=1)
    own_end = np.where(hashing, warps[:, :, 3],
                       np.where(warps[:, :, 1] != 0, warps[:, :, 1],
                                setup_end[:, None]))
    join = np.maximum(s[:, 3], np.where(used, own_end, 0).max(axis=1))
    busy = np.where(hashing, warps[:, :, 3] - warps[:, :, 2], 0)
    wait = np.where(used, join[:, None] - own_end, 0)

    def med(v):
        return float(np.median(v))

    tile = s[:, 4] - s[:, 0]
    per_sm = np.bincount(s[:, 7], minlength=1)
    return dict(
        tiles=int(plan[2]), rows_per_tile=int(plan[0]),
        sms_used=int((per_sm > 0).sum()),
        tiles_on_busiest_sm=int(per_sm.max()),
        start_spread_ns_p90_max=[float(np.percentile(s[:, 6] - s[:, 6].min(),
                                                     90)),
                                 int(s[:, 6].max() - s[:, 6].min())],
        tile_cycles_p90=float(np.percentile(tile, 90)),
        smem_bytes=int(plan[1]), warps_per_tile=int(used[0].sum()),
        setup_cycles=med(setup_end - s[:, 0]),
        keystream_cycles=med(ks_barrier - setup_end),
        hash_cycles=med(join - np.minimum(h_start, join)),
        hash_start_after_setup_cycles=med(np.minimum(h_start, join)
                                          - setup_end),
        store_cycles=med(s[:, 4] - join),
        tile_cycles=med(s[:, 4] - s[:, 0]),
        tile_cycles_max=int((s[:, 4] - s[:, 0]).max()),
        hash_warp_busy_cycles=med(busy.sum(1) / np.maximum(hashing.sum(1),
                                                           1)),
        warp_wait_at_join_cycles=med(wait.sum(1) / np.maximum(used.sum(1),
                                                              1)),
        idle_hash_warps=med((used & ~hashing).sum(1)))


def gcm_phases(torch, dev, lib, launches, which: str,
               per_sm: int = 0, quiet: bool = False) -> dict:
    """The phase probe (`ljt_srtp_gcm_phases`, M's and N's tile with
    clock64 stamps) of `lib` at `launches` (`_gcm_launches`), planned for
    `per_sm` tiles an SM (0: as the kernels plan): for each launch and
    for seal and open, the probe's time on the card and `_phase_split`.
    N opens what M's wrapper sealed.  Prints a `gcm_phases` line named
    `which`."""
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.transform.srtp import kernel as sk

    stream = kbuild.stream_handle(dev)
    out = {}
    for case in launches:
        args = case["args"]
        n, width = args[3].shape
        sealed, slen = sk.srtp_gcm_protect(*args)
        split = {}
        for name, is_open, data, length in (
                ("seal", 0, args[3], args[4]), ("open", 1, sealed, slen)):
            res = torch.empty_like(data)
            res_len = torch.empty_like(length)
            ok = torch.zeros(n, dtype=torch.bool, device=dev)
            stamps = torch.zeros((n, 40), dtype=torch.int64, device=dev)
            plan = np.zeros(3, np.int32)

            def probe():
                kbuild.check(lib.ljt_srtp_gcm_phases(
                    args[0].data_ptr(), args[1].data_ptr(),
                    args[2].data_ptr(), args[0].shape[0], data.data_ptr(),
                    length.data_ptr(), args[5].data_ptr(),
                    args[6].data_ptr(), res.data_ptr(), res_len.data_ptr(),
                    ok.data_ptr(), stamps.data_ptr(), plan.ctypes.data, n,
                    width, is_open, per_sm, stream), "srtp_gcm_phases")

            probe_ms = device_ms(torch, probe, 20,
                                 f"gcm_phases_{name}_kernel")
            probe()                  # the stamps of one warm launch
            torch.cuda.synchronize()
            want = sealed if not is_open else args[3]
            require(torch.equal(res, want) if not is_open
                    else bool(ok.all()), f"the phase probe's {name} differs "
                                         f"at {case['label']}")
            split[name] = dict(probe_ms=probe_ms,
                               **_phase_split(stamps.cpu().numpy(), plan))
        out[case["label"]] = split
    if not quiet:
        emit("gcm_phases", tree=which, tiles_per_sm=per_sm or "as shipped",
             launches=out)
    return out


GCM_PLANS = (1, 2, 3, 4)    # tiles an SM tried by `gcm_plans`


def gcm_plans(torch, dev, lib, launches) -> None:
    """M's and N's tile planned for each of GCM_PLANS tiles an SM (the
    phase probe, `gcm_phases`): its time on the card at each launch, the
    sums over the mix batch's launches, and the rows a tile, so the
    shipped plan (`kGcmTilesPerSm`) is read against the others.  Prints
    a `gcm_plans` line."""
    out = {}
    for k in GCM_PLANS:
        res = gcm_phases(torch, dev, lib, launches, "this tree", k, True)
        mix = [lab for lab in res if "SRTCP" not in lab]
        out[k] = dict(
            seal_mix_batch_ms=sum(res[lab]["seal"]["probe_ms"] for lab in mix),
            open_mix_batch_ms=sum(res[lab]["open"]["probe_ms"] for lab in mix),
            launches={lab: dict(rows_per_tile=v["seal"]["rows_per_tile"],
                                seal_ms=v["seal"]["probe_ms"],
                                open_ms=v["open"]["probe_ms"])
                      for lab, v in res.items()})
    emit("gcm_plans", tiles_per_sm=out)


def parent_library(root: str):
    """The kernel library of the tree at `root` (built by that tree's own
    `kernels.build`, in a subprocess run from `root`), loaded beside this
    tree's, with the argument types of every entry it has."""
    import ctypes

    from libjitsi_tpu_torch.kernels import build as kbuild

    out = subprocess.run(
        [sys.executable, "-c", "import json, sys; sys.path.insert(0, '.'); "
         "from libjitsi_tpu_torch.kernels import build; "
         "print(json.dumps({k: ['P' if a is build._P else 'I' for a in v] "
         "for k, v in build._SIGNATURES.items()})); print(build.build())"],
        cwd=root, check=True, capture_output=True, text=True,
        timeout=900).stdout.strip().splitlines()
    lib = ctypes.CDLL(out[-1])
    # the root's own argument types: an entry may differ between trees
    # (R's did in PR 17)
    types = {"P": kbuild._P, "I": kbuild._I}
    for name, args in json.loads(out[-2]).items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [types[a] for a in args]
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _recorded_launch(fn):
    """Run `fn`, one call of a GCM wrapper, and return its outputs and the
    C entry and arguments of the launch it made (`_gcm_launch`), which
    stay valid while the outputs live."""
    from libjitsi_tpu_torch.transform.srtp import kernel as sk

    seen, orig = [], sk._gcm_launch

    def rec(name, *args, **kw):
        seen.append((name, args))
        orig(name, *args, **kw)

    sk._gcm_launch = rec
    try:
        out = fn()
    finally:
        sk._gcm_launch = orig
    return out, seen[0]


def kernel_turns(torch, dev, parent_lib, specs, line: str,
                 sums=None) -> None:
    """The parent's kernels against this tree's on the same launches, in
    turns (parent, this, this, parent), each turn the profiler's mean
    kernel duration over 50 launches; `specs` are (label, outputs, (entry,
    args)): the C entry (without `ljt_`) and its arguments, which stay
    valid while the outputs live.  Prints a line named `line`: each
    side's mean, its two turns' spread and the ratio; `sums` (a name ->
    the labels of its launches) adds each name's turns summed over its
    launches."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    out = {}
    for label, _keep, (entry, args) in specs:
        def call(lib, entry=entry, args=args):
            kbuild.check(getattr(lib, "ljt_" + entry)(*args), entry)

        libs = (parent_lib, kbuild.library(), kbuild.library(), parent_lib)
        t = [device_ms(torch, lambda lib=lib: call(lib), 50,
                       entry + "_kernel") for lib in libs]
        parent, new = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        out[f"{entry} {label}"] = dict(
            turns_ms=t, parent_ms=parent, new_ms=new,
            parent_spread_ms=abs(t[0] - t[3]), new_spread_ms=abs(t[1] - t[2]),
            new_over_parent=new / parent)
    for name, labels in (sums or {}).items():
        t = [sum(out[k]["turns_ms"][i] for k in labels) for i in range(4)]
        parent, new = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        out[name] = dict(turns_ms=t, parent_ms=parent, new_ms=new,
                         new_over_parent=new / parent)
    emit(line, order="parent, this tree, this tree, parent", launches=out)


def gcm_kernels(torch, dev, floor_ms: float, chain: dict,
                parent_lib=None) -> dict:
    """M and N against their plain versions at the launches a 4,096-packet
    production-mix batch makes over 10,240-row tables (the parts
    `bucket_by_size` gives) and at 1,100 SRTCP rows (hdr8 || E || index ||
    60-200 bytes in 1,504-byte rows, AAD 12); their cached instances at
    4,096 audio rows (60-160-byte payloads) on slots of 256 bytes; H's
    GCM instance at 275 x 10, 1,100 x 10 and 128 x 512 copies, the
    shapes of H's rows (O: `fill_kernel`).  Each exact, with
    its bound (`GHASH_BLOCK_OPS` a GHASH block beside the AES count), its
    GCM chain floor and ptxas registers and spills.  No PyTorch call
    computes GCM, so none has a library time.  The `kernels` line takes
    the batch's sums for M and N, the audio rows for the cached
    instances and one burst for H-GCM."""
    from libjitsi_tpu_torch.kernels import aes, gcm
    from libjitsi_tpu_torch.transform.srtp import kernel as sk
    from libjitsi_tpu_torch.transform.srtp.context import ghash_tables

    rng = np.random.default_rng(61)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev)

    from libjitsi_tpu_torch.kernels import build as kbuild

    ptxas = ptxas_usage(kbuild)
    rk_np = aes.expand_keys_batch(rng.integers(0, 256, (N_STREAMS, 16),
                                               np.uint8))
    tab_rk, tab_gm = t(rk_np), t(ghash_tables(rk_np).view(np.int32))
    keys = 176 + 2048          # a stream's round keys and packed matrix
    rows, acc, specs = {}, {}, []

    def line_of(name, label, fn, plain, nbytes, ops, chain_ms):
        line = _profile_line(name, label, _crypto_times(
            torch, fn, name + "_kernel", plain), nbytes, ops, floor_ms,
            chain_ms)
        key = name + (" nr=10" if name in ("srtp_gcm_seal", "srtp_gcm_open",
                                            "srtp_fanout_gcm") else "")
        line["ptxas"] = ptxas.get(key, {})
        emit("kernel_vs_plain", **line)
        return line

    def check(name, got, want, label):
        require(max_abs_err(torch, got, want) == 0,
                f"{name} {label} differs from its plain version")

    # M and N: one production-mix batch as the table buckets it
    launches = _gcm_launches(torch, dev, rng, tab_rk, tab_gm)
    labels = []
    for case in launches[:-1]:
        label, args, ct = case["label"], case["args"], case["ct"]
        n, width = args[3].shape
        labels.append(label)
        kp, spec = _recorded_launch(lambda: sk.srtp_gcm_protect(*args))
        specs.append((label, kp, spec))
        check("srtp_gcm_seal", kp, sk.srtp_gcm_protect_plain(*args), label)
        uargs = args[:3] + [kp[0], kp[1]] + args[5:]
        ku, spec = _recorded_launch(lambda: sk.srtp_gcm_unprotect(*uargs))
        specs.append((label, ku, spec))
        require(bool(ku[2].all()), f"srtp_gcm_open rejected genuine rows "
                                   f"({label})")
        check("srtp_gcm_open", ku, sk.srtp_gcm_unprotect_plain(*uargs), label)
        nbytes = (2 * n * width + n * (4 + 4 + 12 + 4)
                  + case["streams"] * keys)
        ops = _gcm_ops(np.full(n, HDR), ct)
        chain_ms = gcm_floor_ms(floor_ms, chain, HDR, int(ct.max()))
        for name, fn, plain in (
                ("srtp_gcm_seal", lambda: sk.srtp_gcm_protect(*args),
                 lambda: sk.srtp_gcm_protect_plain(*args)),
                ("srtp_gcm_open", lambda: sk.srtp_gcm_unprotect(*uargs),
                 lambda: sk.srtp_gcm_unprotect_plain(*uargs))):
            line = line_of(name, label + " (table path)", fn, plain, nbytes,
                           ops, chain_ms)
            a = acc.setdefault(name, dict(ms=0.0, call_ms=0.0, plain_ms=0.0,
                                          bytes=0, ops=0,
                                          chain_floor_ms=0.0))
            for k in ("ms", "call_ms", "plain_ms", "bytes", "ops",
                      "chain_floor_ms"):
                a[k] += line[k]
    for name, a in acc.items():
        rows[name] = _profile_line(
            name, f"one {BATCH}-packet production-mix batch as the table "
                  f"buckets it, {len(labels)} launches: "
                  + " + ".join(labels),
            {k: a[k] for k in ("ms", "call_ms", "plain_ms")}, a["bytes"],
            a["ops"], floor_ms, a["chain_floor_ms"])
        rows[name]["ptxas"] = ptxas.get(name + " nr=10", {})
    # M and N at the SRTCP launch
    ca, ct = launches[-1]["args"], launches[-1]["ct"]
    n, width = ca[3].shape
    cp, spec = _recorded_launch(lambda: sk.srtp_gcm_protect(*ca))
    specs.append((launches[-1]["label"], cp, spec))
    check("srtp_gcm_seal", cp, sk.srtp_gcm_protect_plain(*ca), "SRTCP")
    cu = ca[:3] + [cp[0], cp[1]] + ca[5:]
    got, spec = _recorded_launch(lambda: sk.srtp_gcm_unprotect(*cu))
    specs.append((launches[-1]["label"], got, spec))
    require(bool(got[2].all()), "srtp_gcm_open rejected genuine SRTCP rows")
    check("srtp_gcm_open", got, sk.srtp_gcm_unprotect_plain(*cu), "SRTCP")
    for name, fn, plain in (
            ("srtp_gcm_seal", lambda: sk.srtp_gcm_protect(*ca),
             lambda: sk.srtp_gcm_protect_plain(*ca)),
            ("srtp_gcm_open", lambda: sk.srtp_gcm_unprotect(*cu),
             lambda: sk.srtp_gcm_unprotect_plain(*cu))):
        line_of(name, f"{n}x{width} SRTCP 60-200 bytes (the path's SRTCP "
                      f"launch)", fn, plain,
                2 * n * width + n * (4 + 4 + 12 + 4) + n * keys,
                _gcm_ops(np.full(n, 12), ct),
                gcm_floor_ms(floor_ms, chain, 12, int(ct.max())))
    gcm_phases(torch, dev, kbuild.library(), launches, "this tree")
    gcm_plans(torch, dev, kbuild.library(), launches)
    if parent_lib is not None and hasattr(parent_lib, "ljt_srtp_gcm_phases"):
        gcm_phases(torch, dev, parent_lib, launches, "parent")
    # the cached instances: 4,096 audio rows on 65,536 slots of 256 bytes
    n, width, ks_bytes, n_slots = BATCH, 192, 256, GCM_FILL_SLOTS + 1
    plen = rng.integers(60, 161, n).astype(np.int64)
    data = np.zeros((n, width), np.uint8)
    data[:, :HDR + 160] = rng.integers(0, 256, (n, HDR + 160), np.uint8)
    ks_tab = t(rng.integers(0, 256, (n_slots, ks_bytes), np.uint8))
    ek_tab = t(rng.integers(0, 256, (n_slots, 16), np.uint8))
    ka = [ks_tab, ek_tab, t(rng.permutation(n_slots - 1)[:n].astype(
        np.int32)), tab_gm, t(rng.permutation(N_STREAMS)[:n].astype(
            np.int32)), t(data), t((HDR + plen).astype(np.int32)),
          torch.full((n,), HDR, dtype=torch.int32, device=dev)]
    kp, spec = _recorded_launch(lambda: sk.srtp_gcm_protect_cached(*ka))
    specs.append((f"{n}x{width} audio", kp, spec))
    check("srtp_gcm_seal_cached", kp, sk.srtp_gcm_protect_cached_plain(*ka),
          "audio")
    kua = ka[:5] + [kp[0], kp[1], ka[7]]
    ku, spec = _recorded_launch(lambda: sk.srtp_gcm_unprotect_cached(*kua))
    specs.append((f"{n}x{width} audio", ku, spec))
    require(bool(ku[2].all()), "srtp_gcm_open_cached rejected genuine rows")
    check("srtp_gcm_open_cached", ku,
          sk.srtp_gcm_unprotect_cached_plain(*kua), "audio")
    nbytes = 2 * n * width + n * (4 + 4 + 4 + 4 + ks_bytes + 16) + n * 2048
    for name, fn, plain in (
            ("srtp_gcm_seal_cached", lambda: sk.srtp_gcm_protect_cached(*ka),
             lambda: sk.srtp_gcm_protect_cached_plain(*ka)),
            ("srtp_gcm_open_cached",
             lambda: sk.srtp_gcm_unprotect_cached(*kua),
             lambda: sk.srtp_gcm_unprotect_cached_plain(*kua))):
        steps = (HDR + 15) // 16 + (int(plen.max()) + 15) // 16 + 1
        rows[name] = line_of(
            name, f"{n}x{width} audio rows 60-160 bytes, slots of "
                  f"{ks_bytes} bytes", fn, plain, nbytes,
            _gcm_ops(np.full(n, HDR), plen, aes=False),
            floor_ms + steps * chain["ghash_step_cycles"]
            / (chain["mhz"] * 1e3))
    # H's GCM instance at the shapes of H's rows
    burst = SFU_N // SFU_BURSTS
    for label, p, legs, lens, width in (
            (f"{burst}x10 len 80-180 (one SFU burst)", burst, SFU_SIZE - 1,
             rng.integers(80, 181, burst), 208),
            ("1100x10 len 80-180 (the SFU tick)", SFU_N, SFU_SIZE - 1,
             rng.integers(80, 181, SFU_N), 208),
            (f"{GCM_BENCH[0]}x{GCM_BENCH[1]} len 172 (fan-out bench)",
             *GCM_BENCH, np.full(GCM_BENCH[0], 172), 192)):
        host = _fanout_case(rng, p, legs, lens, width, SFU_N)
        host[1] = ghash_tables(host[0]).view(np.int32)
        host[2][:, 12:] = 0
        args = [t(x) for x in host]
        got, spec = _recorded_launch(lambda: sk.srtp_fanout_gcm(*args))
        specs.append((label, got, spec))
        check("srtp_fanout_gcm", got, sk.srtp_fanout_gcm_plain(*args), label)
        n = p * legs
        ct = np.repeat(lens - HDR - 8, legs)
        line = line_of("srtp_fanout_gcm", label,
                       lambda: sk.srtp_fanout_gcm(*args),
                       lambda: sk.srtp_fanout_gcm_plain(*args),
                       p * width + p * 20 + n * (width + 4 + 8)
                       + len(np.unique(host[-1])) * (16 + keys),
                       _gcm_ops(np.full(n, HDR + 8), ct),
                       gcm_floor_ms(floor_ms, chain, HDR + 8, int(ct.max())))
        if p == burst:
            rows["srtp_fanout_gcm"] = line
    if parent_lib is not None:
        kernel_turns(torch, dev, parent_lib, specs, "gcm_turns")
    return rows


def fill_kernel(torch, dev, floor_ms: float, chain: dict, fill_core: dict,
                parent_lib=None) -> dict:
    """Kernel O against its plain version at a first fill of 1,024 rows x
    64 slots of 256 bytes (65,536 slots, the window's runs of one stream
    each, written to slots in random order), with its bound (the T-table
    AES count), its chain floor (launch + the AES pairs of one slot on a
    lane), its core floor (`core_floor_ms`: the pairs of this run at the
    INT32-pipe instructions a pair the shipped O's SASS holds,
    `fill_core`, over the INT32 rate) and ptxas registers and spills;
    then its phase split (`fill_phases`, and the parent's where it has
    the probe) and, with a parent, O's turns (`fill_turns`).  No PyTorch
    call computes AES, so none has a library time."""
    from libjitsi_tpu_torch.kernels import aes, gcm
    from libjitsi_tpu_torch.kernels import build as kbuild

    rng = np.random.default_rng(67)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev)

    n, ks_bytes, win = GCM_FILL_SLOTS, GCM_CACHE["ks_bytes"], \
        GCM_CACHE["window"]
    tab_rk = t(aes.expand_keys_batch(rng.integers(0, 256, (N_STREAMS, 16),
                                                  np.uint8)))
    ks_tab = torch.zeros((n + 1, ks_bytes), dtype=torch.uint8, device=dev)
    ek_tab = torch.zeros((n + 1, 16), dtype=torch.uint8, device=dev)
    ks2, ek2 = ks_tab.clone(), ek_tab.clone()
    fa = [tab_rk, t(np.repeat(rng.permutation(N_STREAMS)[:n // win], win)
                    .astype(np.int32)),
          t(rng.integers(0, 256, (n, 12), np.uint8)),
          t(rng.permutation(n).astype(np.int32))]
    gcm.gcm_ks_fill(ks_tab, ek_tab, *fa)
    gcm.gcm_ks_fill_plain(ks2, ek2, *fa)
    require(max_abs_err(torch, (ks_tab, ek_tab), (ks2, ek2)) == 0,
            "gcm_ks_fill differs from its plain version at 65,536 slots")
    blocks = ks_bytes // 16 + 1
    pairs = (n * blocks + 1) // 2
    label = f"{n} slots x {ks_bytes} bytes (a first fill of 1,024 rows x {win})"
    line = _profile_line(
        "gcm_ks_fill", label, _crypto_times(
            torch, lambda: gcm.gcm_ks_fill(ks_tab, ek_tab, *fa),
            "gcm_ks_fill_kernel",
            lambda: gcm.gcm_ks_fill_plain(ks2, ek2, *fa)),
        n * (ks_bytes + 16) + n * (4 + 12 + 4) + (n // win) * 176,
        n * blocks * aes_block_ops(10), floor_ms,
        floor_ms + (blocks + 1) // 2 * chain["aes_pair_cycles"]["aes128"]
        / (chain["mhz"] * 1e3))
    line["ptxas"] = ptxas_usage(kbuild).get("gcm_ks_fill nr=10", {})
    line["core"] = dict(fill_core, pairs=pairs)
    line["core_floor_ms"] = pairs * fill_core["int32_per_pair"] \
        / INT32_OPS_PER_S * 1e3
    emit("kernel_vs_plain", **line)
    args = [tab_rk, tab_rk.shape[0], *fa[1:], n + 1, ks_bytes]
    fill_phases(torch, dev, kbuild.library(), args, (ks2, ek2), label,
                "this tree")
    if parent_lib is not None:
        if hasattr(parent_lib, "ljt_gcm_ks_fill_phases"):
            fill_phases(torch, dev, parent_lib, args, (ks2, ek2), label,
                        "parent")
        kernel_turns(torch, dev, parent_lib, [(label, (ks_tab, ek_tab), (
            "gcm_ks_fill", (tab_rk.data_ptr(), tab_rk.shape[0],
                            fa[1].data_ptr(), fa[2].data_ptr(),
                            fa[3].data_ptr(), ks_tab.data_ptr(),
                            ek_tab.data_ptr(), n, n + 1, ks_bytes, 10,
                            kbuild.stream_handle(dev))))], "fill_turns")
    return {"gcm_ks_fill": line}


FILL_PHASE_SLOTS = 24      # `gcm_fill.cu` kFillPhaseSlots


def _fill_split(stamps: np.ndarray, plan) -> dict:
    """Kernel O's split from its phase probe's stamps ([tiles, 24] clock64
    words, `gcm_fill.cu`, four warps a tile): medians over the tiles of
    set-up (the tile's
    start to its set-up barrier), the AES passes with their stores (to
    the barrier after them), a warp's first pass, and the cycles the
    tile's barrier waits after its first warp's last pass; the tile
    (median and slowest); the schedules a tile sliced; the tiles an SM
    ran, how many ran on it at once at most, and the share of tiles that
    started after the first tile on their SM had ended (a second wave);
    the spread of the tiles' starts (global timer, ns); and the tiles a
    CTA took."""
    tiles = int(plan[3])
    s = stamps[:tiles].astype(np.int64)
    warps = s[:, 8:16].reshape(tiles, 4, 2)
    used = warps[:, :, 1] != 0
    big = np.iinfo(np.int64).max
    first_pass = np.where(used, warps[:, :, 0] - s[:, 1:2], 0)
    last_first = np.where(used, warps[:, :, 1], big).min(axis=1)
    late, overlap = 0, []
    for sm in np.unique(s[:, 3]):
        on = s[s[:, 3] == sm]
        late += int((on[:, 0] > on[:, 2].min()).sum())
        ev = sorted([(a, 1) for a in on[:, 0]] + [(b, -1) for b in on[:, 2]],
                    key=lambda e: (e[0], e[1]))
        cur = 0
        for _, d in ev:
            cur += d
            overlap.append(cur)
    per_sm = np.bincount(s[:, 3])
    per_cta = np.bincount(s[:, 7])
    start = s[:, 4] - s[:, 4].min()

    def med(v):
        return float(np.median(v))

    return dict(
        tiles=tiles, ctas=int(plan[2]), slots_per_tile=int(plan[0]),
        smem_bytes=int(plan[1]), sms_used=int((per_sm > 0).sum()),
        tiles_per_sm_max_median=[int(per_sm.max()),
                                 med(per_sm[per_sm > 0])],
        tiles_at_once_on_an_sm_max=int(max(overlap)),
        second_wave_share=late / tiles,
        tiles_per_cta_max=int(per_cta.max()),
        start_spread_ns_p50_p90_max=[med(start),
                                     float(np.percentile(start, 90)),
                                     int(start.max())],
        schedules_per_tile=med(s[:, 6]),
        setup_cycles=med(s[:, 1] - s[:, 0]),
        setup_to_vote_cycles=med(s[:, 16] - s[:, 0]),
        setup_keys_cycles=med(s[:, 17] - s[:, 16]),
        aes_cycles=med(s[:, 2] - s[:, 1]),
        first_pass_cycles=med(first_pass.sum(1) / np.maximum(used.sum(1),
                                                            1)),
        wait_after_first_warp_done_cycles=med(s[:, 2] - last_first),
        warps_per_tile=med(used.sum(1)),
        tile_cycles=med(s[:, 2] - s[:, 0]),
        tile_cycles_max=int((s[:, 2] - s[:, 0]).max()))


def fill_phases(torch, dev, lib, args, want, label: str, which: str) -> None:
    """Kernel O's phase probe (`ljt_gcm_ks_fill_phases`: the same tile
    with clock64 stamps) of `lib` on O's arguments `args` (table, its
    rows, stream, iv12, slot, slots, slot bytes): its time on the card and
    `_fill_split`, after checking it writes the plain version's tables
    (`want`).  Prints a `fill_phases` line named `which`."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    tab_rk, n_streams, stream, iv12, slot, n_slots, ks_bytes = args
    n = slot.shape[0]
    ks = torch.zeros((n_slots, ks_bytes), dtype=torch.uint8, device=dev)
    ek = torch.zeros((n_slots, 16), dtype=torch.uint8, device=dev)
    stamps = torch.zeros((n, FILL_PHASE_SLOTS), dtype=torch.int64,
                         device=dev)
    plan = np.zeros(4, np.int32)

    def probe():
        kbuild.check(lib.ljt_gcm_ks_fill_phases(
            tab_rk.data_ptr(), n_streams, stream.data_ptr(), iv12.data_ptr(),
            slot.data_ptr(), ks.data_ptr(), ek.data_ptr(), stamps.data_ptr(),
            plan.ctypes.data, n, n_slots, ks_bytes,
            kbuild.stream_handle(dev)), "gcm_ks_fill_phases")

    probe_ms = device_ms(torch, probe, 20, "gcm_fill_phases_kernel")
    stamps.zero_()
    probe()                  # the stamps of one warm launch
    torch.cuda.synchronize()
    require(max_abs_err(torch, (ks, ek), want) == 0,
            f"O's phase probe ({which}) differs from the plain version")
    emit("fill_phases", tree=which, shape=label, probe_ms=probe_ms,
         **_fill_split(stamps.cpu().numpy(), plan))


F8_PHASE_SLOTS = 40        # `srtp_fanout.cu` kF8PhaseSlots


def _f8_split(stamps: np.ndarray, plan) -> dict:
    """An F8 tile's split from its phase probe's stamps ([tiles, 40]
    clock64 words: H-F8's, `srtp_fanout.cu`, and K's and L's,
    `srtp_f8.cu`): medians over the tiles of set-up (and, where thread 0
    stamps them, its rows' loads, its slicing and the rest), IV' (where
    the form stamps it apart), the chains (set-up done to the last chain's
    end, IV' included), the hash after the chains (the last chain's end to
    the join: the tag's lag; the join is the later of the join barrier's
    stamp and the last warp's own end, since a clock read after a barrier
    may issue before the last warp arrives), the last hash's end less the
    last chain's (negative where the hash ends first), the store and the
    tile (median and slowest); the warps that walk chains and that hash a
    tile; the chain warps that share an SM sub-partition (`%warpid` mod
    4) with another chain warp: the most on one, and the share of chain
    warps that share one, and the share of hashing warps (that walk no
    chain) on the sub-partition of a chain warp of their SM; and the
    tiles an SM ran at once and the share of tiles that started after a
    tile on their SM had ended (a second wave)."""
    tiles = int(plan[2])
    s = stamps[:tiles].astype(np.int64)
    warps = s[:, 16:].reshape(tiles, 8, 3)
    chains = warps[:, :, 1] != 0
    hashes = warps[:, :, 2] != 0
    chain_end = np.where(chains, warps[:, :, 1], 0).max(axis=1)
    chain_end = np.where(s[:, 3] != 0, np.maximum(s[:, 3], chain_end),
                         chain_end)
    count = {}
    for i, w in zip(*np.nonzero(chains)):
        key = (int(s[i, 6]), int((warps[i, w, 0] - 1) % 4))
        count[key] = count.get(key, 0) + 1
    shared = sum(c for c in count.values() if c > 1)
    hash_on_chain_sp = sum(
        int(hashes[i, w] and not chains[i, w] and key in count)
        for i in range(tiles) for w in range(8)
        for key in [(int(s[i, 6]), int((warps[i, w, 0] - 1) % 4))])

    def med(v):
        return float(np.median(v))

    hash_end = np.where(hashes, warps[:, :, 2], 0).max(axis=1)
    join = np.maximum(s[:, 4], np.maximum(chain_end, hash_end))
    per_sm = np.bincount(s[:, 6])
    slow = int(np.argmax(s[:, 5] - s[:, 0]))
    extra = {}
    if s[:, 9].any():
        # thread 0's set-up stamps: its rows' loads, then its slicing
        rows_done = s[:, 9]
        sliced = np.where(s[:, 10] != 0, s[:, 10], rows_done)
        extra.update(setup_rows_cycles=med(rows_done - s[:, 0]),
                     setup_slicing_cycles=(med(s[:, 10] - rows_done)
                                           if s[:, 10].any() else
                                           "with the rows' loads"),
                     setup_rest_cycles=med(s[:, 1] - sliced))
    if hashes.any():
        ends = np.where(chains, warps[:, :, 1], 0).max(axis=1)
        extra["hash_end_after_chain_end_cycles"] = med(hash_end - ends)
    late, overlap = 0, [0]
    for sm in np.unique(s[:, 6]):
        on = s[s[:, 6] == sm]
        late += int((on[:, 0] > on[:, 5].min()).sum())
        cur = 0
        for _, d in sorted([(a, 1) for a in on[:, 0]]
                           + [(b, -1) for b in on[:, 5]]):
            cur += d
            overlap.append(cur)
    return dict(
        **extra, tiles_at_once_on_an_sm_max=int(max(overlap)),
        second_wave_share=late / tiles, tiles=tiles,
        rows_per_tile=int(plan[0]), smem_bytes=int(plan[1]),
        slowest_tile=dict(
            set_up=int(s[slow, 1] - s[slow, 0]),
            iv_prime=int(s[slow, 2] - s[slow, 1]) if s[slow, 2] else None,
            chains=int(chain_end[slow] - s[slow, 1]),
            hash_after_chains=int(join[slow] - chain_end[slow]),
            store=int(s[slow, 5] - join[slow])),
        chain_cycles_p10_p90=[float(np.percentile(chain_end - s[:, 1], q))
                              for q in (10, 90)],
        sms_used=int((per_sm > 0).sum()), tiles_per_sm_max=int(per_sm.max()),
        setup_cycles=med(s[:, 1] - s[:, 0]),
        iv_prime_cycles=(med(s[:, 2] - s[:, 1]) if s[:, 2].any()
                         else "not apart from the chain"),
        chain_cycles=med(chain_end - s[:, 1]),
        hash_after_chain_cycles=med(join - chain_end),
        store_cycles=med(s[:, 5] - join),
        tile_cycles=med(s[:, 5] - s[:, 0]),
        tile_cycles_max=int((s[:, 5] - s[:, 0]).max()),
        chain_warps_per_tile=med(chains.sum(1)),
        hash_warps_per_tile=med(hashes.sum(1)),
        chain_warps_on_one_sub_partition_max=max(count.values(), default=0),
        chain_warps_sharing_a_sub_partition=shared / max(int(chains.sum()),
                                                         1),
        hash_warps_on_a_chain_sub_partition=hash_on_chain_sp / max(
            int((hashes & ~chains).sum()), 1))


def f8_fanout_phases(torch, dev, lib, cases, which: str) -> None:
    """H-F8's phase probe (`ljt_srtp_fanout_f8_phases`: the same tile with
    clock64 stamps, AES-128) of `lib` at each of `cases` (label, the
    wrapper's arguments, tab_f8, iv, its plain outputs): its time on the
    card and `_f8_split`, after checking it writes the plain version's
    copies.  Prints an `f8_fanout_phases` line named `which`."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    out = {}
    for label, args, tab_f8, iv, want in cases:
        tab_rk, tab_mid, _salt, data, length, off, _ssrc, index, src, \
            recv = args
        n, (p, width) = src.shape[0], data.shape
        res = torch.empty((n, width), dtype=torch.uint8, device=dev)
        res_len = torch.empty((n,), dtype=torch.int32, device=dev)
        stamps = torch.zeros((n, F8_PHASE_SLOTS), dtype=torch.int64,
                             device=dev)
        plan = np.zeros(3, np.int32)

        def probe():
            kbuild.check(lib.ljt_srtp_fanout_f8_phases(
                tab_rk.data_ptr(), tab_f8.data_ptr(), tab_mid.data_ptr(),
                tab_rk.shape[0], data.data_ptr(), length.data_ptr(),
                off.data_ptr(), iv.data_ptr(), index.data_ptr(), p,
                src.data_ptr(), recv.data_ptr(), res.data_ptr(),
                res_len.data_ptr(), stamps.data_ptr(), plan.ctypes.data, n,
                width, TAG, kbuild.stream_handle(dev)),
                "srtp_fanout_f8_phases")

        probe_ms = device_ms(torch, probe, 20, "fanout_f8_phases_kernel")
        stamps.zero_()
        probe()
        torch.cuda.synchronize()
        require(max_abs_err(torch, (res, res_len), want) == 0,
                f"H-F8's phase probe ({which}) differs from the plain "
                f"version at {label}")
        out[label] = dict(probe_ms=probe_ms,
                          **_f8_split(stamps.cpu().numpy(), plan))
    emit("f8_fanout_phases", tree=which, launches=out)


def srtp_f8_phases(torch, dev, lib, cases, which: str, per_sm: int = 0,
                   quiet: bool = False) -> dict:
    """K's and L's phase probe (`ljt_srtp_f8_phases`: their tile with
    clock64 stamps, AES-128) of `lib` at each of `cases` (label, the
    protect arguments, the unprotect arguments, tab_f8, K's and L's
    outputs from their wrappers), planned for `per_sm` tiles an SM (0: as
    the shipped kernels plan): for protect and unprotect, the probe's
    time on the card and `_f8_split` (set-up: thread 0's rows, its
    slicing, the rest; IV'; the chains; the hash's end and lag behind
    them; the store; the sub-partition of chain and hashing warps; tiles
    an SM at once and a second wave's share), after checking it writes
    what the shipped kernel wrote.  Prints an `srtp_f8_phases` line named
    `which` unless `quiet`."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    out = {}
    for label, args, uargs, tab_f8, kp, ku in cases:
        split = {}
        for name, unprotect, a, want in (("protect", 0, args, kp),
                                         ("unprotect", 1, uargs, ku)):
            tab_rk, tab_mid, stream, data, length, off, iv, roc = a
            n, width = data.shape
            res = torch.empty_like(data)
            res_len = torch.empty_like(length)
            ok = torch.zeros(n, dtype=torch.bool, device=dev)
            stamps = torch.zeros((n, F8_PHASE_SLOTS), dtype=torch.int64,
                                 device=dev)
            plan = np.zeros(4, np.int32)

            def probe():
                kbuild.check(lib.ljt_srtp_f8_phases(
                    tab_rk.data_ptr(), tab_f8.data_ptr(), tab_mid.data_ptr(),
                    stream.data_ptr(), tab_rk.shape[0], data.data_ptr(),
                    length.data_ptr(), off.data_ptr(), iv.data_ptr(),
                    roc.data_ptr(), res.data_ptr(), res_len.data_ptr(),
                    ok.data_ptr(), stamps.data_ptr(), plan.ctypes.data, n,
                    width, TAG, unprotect, per_sm,
                    kbuild.stream_handle(dev)), "srtp_f8_phases")

            probe_ms = device_ms(torch, probe, 20, "srtp_f8_phases_kernel")
            stamps.zero_()
            probe()                  # the stamps of one warm launch
            torch.cuda.synchronize()
            got = (res, res_len, ok) if unprotect else (res, res_len)
            require(max_abs_err(torch, got, want) == 0,
                    f"the F8 phase probe ({which}, {per_sm or 'shipped'} "
                    f"tiles an SM) differs from {name} at {label}")
            split[name] = dict(probe_ms=probe_ms, threads=int(plan[3]),
                               **_f8_split(stamps.cpu().numpy(), plan))
        out[label] = split
    if not quiet:
        emit("srtp_f8_phases", tree=which,
             tiles_per_sm=per_sm or "as shipped", launches=out)
    return out


F8_PLANS = (1, 2, 4)        # tiles an SM tried by `srtp_f8_plans`


def srtp_f8_plans(torch, dev, lib, cases) -> None:
    """K's and L's tile planned for each of F8_PLANS tiles an SM (the
    phase probe, `srtp_f8_phases`): its time on the card at each of the
    mix batch's launches, their sums, and the rows and threads a tile, so
    the shipped plan is read against the others.  Prints an
    `srtp_f8_plans` line."""
    out = {}
    for k in F8_PLANS:
        res = srtp_f8_phases(torch, dev, lib, cases, "this tree", k, True)
        out[k] = dict(
            protect_mix_batch_ms=sum(v["protect"]["probe_ms"]
                                     for v in res.values()),
            unprotect_mix_batch_ms=sum(v["unprotect"]["probe_ms"]
                                       for v in res.values()),
            launches={lab: dict(rows_per_tile=v["protect"]["rows_per_tile"],
                                threads=v["protect"]["threads"],
                                tiles=v["protect"]["tiles"],
                                protect_ms=v["protect"]["probe_ms"],
                                unprotect_ms=v["unprotect"]["probe_ms"])
                      for lab, v in res.items()})
    emit("srtp_f8_plans", tiles_per_sm=out)


def srtp_f8_turns(torch, dev, parent_lib, cases) -> None:
    """K and L of the parent against this tree's at each of the mix
    batch's launches and summed over the batch, in turns
    (`kernel_turns`).  Prints an `srtp_f8_turns` line."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    specs, sums = [], {}
    for label, args, uargs, tab_f8, _kp, _ku in cases:
        for entry, a in (("srtp_protect_f8", args),
                         ("srtp_unprotect_f8", uargs)):
            tab_rk, tab_mid, stream, data, length, off, iv, roc = a
            n, width = data.shape
            res = torch.empty_like(data)
            res_len = torch.empty_like(length)
            ok = torch.zeros(n, dtype=torch.bool, device=dev)
            outs = [res.data_ptr(), res_len.data_ptr()]
            if entry == "srtp_unprotect_f8":
                outs.append(ok.data_ptr())
            specs.append((label, (res, res_len, ok, a), (entry, (
                tab_rk.data_ptr(), tab_f8.data_ptr(), tab_mid.data_ptr(),
                stream.data_ptr(), tab_rk.shape[0], data.data_ptr(),
                length.data_ptr(), off.data_ptr(), iv.data_ptr(),
                roc.data_ptr(), *outs, n, width, 10, TAG,
                kbuild.stream_handle(dev)))))
            sums.setdefault(f"{entry} mix batch", []).append(
                f"{entry} {label}")
    kernel_turns(torch, dev, parent_lib, specs, "srtp_f8_turns", sums)


# ------------------------------------- I-NULL and J-NULL (SRTCP, NULL)

NULL_PHASE_SLOTS = 46      # `phases.cuh` ljt_null_phase::kSlots
NULL_PLANS = (1, 2, 4)     # tiles an SM tried by `srtcp_null_plans`
# the SRTCP launches `profile_kernels` times, in 1,504-byte rows: label,
# rows, payload lengths [lo, hi).  The first is the path's (srtp_profiles'
# launch of I's and J's F8 and NULL instances); the others are I-NULL's
# and J-NULL's launches on the sfu path
NULL_SHAPES = ((f"{PROFILE_RTCP}x1504 RTCP 60-200 bytes (the path's SRTCP "
                f"launch)", PROFILE_RTCP, 60, 201),
               ("275x1504 RTCP 60-200 bytes (an RR burst: J on the sfu "
                "path)", 275, 60, 201),
               ("1100x1504 32-byte RRs (emit_feedback: I on the sfu path)",
                1100, 32, 33))
# the bytes an SRTCP row moves beside the row itself, each read or written
# once: I its length, stream id, E || index word and new length; J its
# length, stream id, mlen, auth_ok, E bit and index (the F8 instances also
# read a 16-byte IV; the keys are counted apart)
SRTCP_ROW_BYTES = {"protect": 4 + 4 + 4 + 4,
                   "unprotect": 4 + 4 + 4 + 1 + 4 + 4}


def _null_split(stamps: np.ndarray, plan) -> dict:
    """A tile's split from the SRTCP NULL probe's stamps ([tiles,
    NULL_PHASE_SLOTS] clock64 words, `phases.cuh`): medians over the
    tiles of thread 0's round trips (its stream id with the loads that
    share that trip, then its midstates), the hash from the midstates in
    hand to lane 0's end and to the slowest lane's (the warp's), the copy's
    end (the last copying warp's stores drained, from the tile's start)
    and whether it ended before the hash did, the stores and drain after
    the hash (to the tile's end), and the tile; the span of the launch on
    the global timer (first tile's start to last tile's end, ns); and the
    tiles an SM ran at once and the share that started after a tile on
    their SM had ended (a second wave)."""
    tiles = int(plan[1])
    s = stamps[:tiles].astype(np.int64)

    def med(v):
        return float(np.median(v))

    lane_end = s[:, 14:46].max(axis=1)
    copy_end = s[:, 10:14].max(axis=1)
    per_sm = np.bincount(s[:, 1])
    late, overlap = 0, [0]
    for sm in np.unique(s[:, 1]):
        on = s[s[:, 1] == sm]
        late += int((on[:, 0] > on[:, 6].min()).sum())
        cur = 0
        for _, d in sorted([(a, 1) for a in on[:, 0]]
                           + [(b, -1) for b in on[:, 6]]):
            cur += d
            overlap.append(cur)
    slow = int(np.argmax(s[:, 6] - s[:, 0]))
    return dict(
        tiles=tiles, rows_per_tile=int(plan[0]), threads=int(plan[2]),
        setup_id_cycles=med(s[:, 4] - s[:, 0]),
        setup_midstates_cycles=med(s[:, 5] - s[:, 4]),
        hash_lane0_cycles=med(s[:, 14] - s[:, 5]),
        hash_warp_cycles=med(lane_end - s[:, 5]),
        hash_end_cycles=med(lane_end - s[:, 0]),
        copy_end_cycles=med(copy_end - s[:, 0]),
        copy_ends_before_hash_share=float((copy_end <= lane_end).mean()),
        store_after_hash_cycles=med(s[:, 6] - lane_end),
        tile_cycles=med(s[:, 6] - s[:, 0]),
        tile_cycles_max=int((s[:, 6] - s[:, 0]).max()),
        slowest_tile=dict(id=int(s[slow, 4] - s[slow, 0]),
                          hash_start=int(s[slow, 5] - s[slow, 0]),
                          hash_end=int(lane_end[slow] - s[slow, 0]),
                          end=int(s[slow, 6] - s[slow, 0])),
        launch_span_ns=int(s[:, 7].max() - s[:, 2].min()),
        sms_used=int((per_sm > 0).sum()), tiles_per_sm_max=int(per_sm.max()),
        tiles_at_once_on_an_sm_max=int(max(overlap)),
        second_wave_share=late / tiles)


def srtcp_null_phases(torch, dev, lib, cases, which: str, per_sm: int = 0,
                      quiet: bool = False) -> dict:
    """The SRTCP NULL phase probe (`ljt_srtcp_null_phases` of `lib`: I-NULL
    and J-NULL with clock64 stamps) at each of `cases` (`profile_kernels`'
    NULL_SHAPES launches: label, I's arguments, J's, I's outputs, J's),
    planned for `per_sm` tiles an SM (0: as shipped): for protect and
    unprotect, the probe's time on the card and `_null_split`, after
    checking it writes what the shipped kernels wrote.  Prints an
    `srtcp_null_phases` line named `which` unless `quiet`."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    out = {}
    for label, pa, ua, kp, ku in cases:
        split = {}
        for name, unprotect, a, want in (("protect", 0, pa, kp),
                                         ("unprotect", 1, ua, ku)):
            tab_rk, tab_mid, stream, data, length = a[:5]
            n, width = data.shape
            res = torch.empty_like(data)
            res_len = torch.empty_like(length)
            ok = torch.zeros(n, dtype=torch.bool, device=dev)
            e_bit = torch.empty_like(length)
            idx = torch.empty_like(length)
            stamps = torch.zeros((n, NULL_PHASE_SLOTS), dtype=torch.int64,
                                 device=dev)
            plan = np.zeros(3, np.int32)
            word = None if unprotect else a[6].data_ptr()

            def probe():
                kbuild.check(lib.ljt_srtcp_null_phases(
                    tab_mid.data_ptr(), stream.data_ptr(), tab_rk.shape[0],
                    data.data_ptr(), length.data_ptr(), word,
                    res.data_ptr(), res_len.data_ptr(), ok.data_ptr(),
                    e_bit.data_ptr(), idx.data_ptr(), stamps.data_ptr(),
                    plan.ctypes.data, n, width, TAG, unprotect, per_sm,
                    kbuild.stream_handle(dev)), "srtcp_null_phases")

            probe_ms = device_ms(torch, probe, 20, "_phases_kernel")
            stamps.zero_()
            probe()              # the stamps of one warm launch
            torch.cuda.synchronize()
            got = (res, res_len, ok, e_bit, idx) if unprotect else (
                res, res_len)
            require(max_abs_err(torch, got, want) == 0,
                    f"the SRTCP NULL probe ({which}, {per_sm or 'shipped'} "
                    f"tiles an SM) differs from {name} at {label}")
            split[name] = dict(probe_ms=probe_ms, **_null_split(
                stamps.cpu().numpy(), plan))
        out[label] = split
    if not quiet:
        emit("srtcp_null_phases", tree=which,
             tiles_per_sm=per_sm or "as shipped", launches=out)
    return out


def srtcp_null_plans(torch, dev, lib, cases) -> None:
    """I-NULL's and J-NULL's tiles planned for each of NULL_PLANS tiles an
    SM (`srtcp_null_phases`): the probe's time on the card at each of
    `cases`, with the rows a tile and the tiles, so the shipped plan is
    read against the others.  Prints an `srtcp_null_plans` line."""
    out = {}
    for k in NULL_PLANS:
        res = srtcp_null_phases(torch, dev, lib, cases, "this tree", k, True)
        out[k] = {lab: dict(rows_per_tile=v["protect"]["rows_per_tile"],
                            tiles=v["protect"]["tiles"],
                            protect_ms=v["protect"]["probe_ms"],
                            unprotect_ms=v["unprotect"]["probe_ms"])
                  for lab, v in res.items()}
    emit("srtcp_null_plans", tiles_per_sm=out)


def srtcp_null_turns(torch, dev, parent_lib, cases) -> None:
    """I-NULL and J-NULL of the parent against this tree's at each of
    `cases` (as `srtcp_null_phases` takes them), in turns (`kernel_turns`),
    after checking the parent's outputs equal this tree's.  Prints an
    `srtcp_null_turns` line."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    specs = []
    for label, pa, ua, kp, ku in cases:
        for entry, a, want in (("srtcp_protect_null", pa, kp),
                               ("srtcp_unprotect_null", ua, ku)):
            tab_rk = a[0]
            n, width = a[3].shape
            outs = tuple(torch.empty_like(w) for w in want)
            args = (tuple(x.data_ptr() for x in a[:3]) + (tab_rk.shape[0],)
                    + tuple(x.data_ptr() for x in a[3:])
                    + tuple(o.data_ptr() for o in outs)
                    + (n, width, tab_rk.shape[1] - 1, TAG,
                       kbuild.stream_handle(dev)))
            kbuild.check(getattr(parent_lib, "ljt_" + entry)(*args), entry)
            torch.cuda.synchronize()
            require(max_abs_err(torch, outs, want) == 0,
                    f"the parent's {entry} differs from this tree's at "
                    f"{label}")
            specs.append((label, outs, (entry, args)))
    kernel_turns(torch, dev, parent_lib, specs, "srtcp_null_turns")


def _audio_batch(rng, streams, seq0: int, lens=None):
    """GCM_CACHE's traffic: 4 packets a stream (seqs seq0 .. seq0 + 3),
    60-160-byte payloads behind a 12-byte header, SSRC 0x20000 + stream."""
    from libjitsi_tpu_torch.rtp import header as rtp_header

    st = np.repeat(streams, 4)
    seqs = np.tile(np.arange(4), len(streams)) + seq0
    lens = rng.integers(60, 161, len(st)) if lens is None else lens
    payloads = [rng.integers(0, 256, int(k), np.uint8).tobytes()
                for k in lens]
    return rtp_header.build(payloads, seqs.tolist(), [seq0 * 160] * len(st),
                            (0x20000 + st).tolist(), [111] * len(st),
                            stream=st.tolist())


def srtp_gcm_run(torch, dev) -> dict:
    """The srtp_gcm path: AEAD_AES_128_GCM tx / rx tables of 10,240 streams
    (A), and a second pair with the same keys fed the same traffic (B, the
    sync reference).  On A and B: PROFILE_BATCHES production-mix batches
    over streams 1,024 and up (every row ok, its bytes back, A's wire equal
    to B's), a tampered and a replayed row rejected, 1,100 SRTCP rows
    sealed and opened.  Then a depth-2 pipeline of the async seams over
    ASYNC_BATCHES batches on A against B's sync calls.  Then the cache run
    on A (B stock): `enable_keystream_cache(window=64, ks_bytes=256,
    pool=1,024)` on both of A's tables, primed for streams 0-1,023, and
    GCM_CACHE_BATCHES audio batches over them with `fill()` between, each
    all hits and byte-equal to B; then a batch carrying a 950-byte payload,
    whose part misses and falls back, byte-equal too."""
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    rng = np.random.default_rng(43)
    prof = SrtpProfile[GCM]
    sids = np.arange(N_STREAMS)
    mks = rng.integers(0, 256, (N_STREAMS, 16), np.uint8)
    mss = rng.integers(0, 256, (N_STREAMS, 12), np.uint8)
    t0 = time.perf_counter()
    tabs = []
    for _ in range(2):
        pair = (SrtpStreamTable(N_STREAMS, prof, device=dev),
                SrtpStreamTable(N_STREAMS, prof, device=dev))
        for tab in pair:
            tab.add_streams(sids, mks, mss)
        tabs.append(pair)
    out = dict(install_s=(time.perf_counter() - t0) / 4, prot_s=[],
               unprot_s=[])
    (tx, rx), (btx, brx) = tabs
    pool = np.arange(GCM_CACHE["pool"])     # the cache run's streams
    live = len(pool) + rng.permutation(N_STREAMS - len(pool))
    before = dict(kbuild.launches)
    first = None
    for k in range(PROFILE_BATCHES):
        batch = _mix_batch(rng, rng.permutation(live)[:BATCH], 1000 + k,
                           k * 960)
        t1 = time.perf_counter()
        wire = tx.protect_rtp(batch)
        t2 = time.perf_counter()
        dec, ok = rx.unprotect_rtp(wire)
        t3 = time.perf_counter()
        require(ok.all() and dec.to_payloads() == batch.to_payloads(),
                f"srtp_gcm batch {k}: genuine rows failed or differ")
        bw = btx.protect_rtp(batch)
        require(np.array_equal(bw.data, wire.data)
                and np.array_equal(brx.unprotect_rtp(bw)[1], ok),
                f"srtp_gcm batch {k}: the two tables differ")
        out["prot_s"].append(t2 - t1)
        out["unprot_s"].append(t3 - t2)
        first = wire if first is None else first
    out["launches_per_batch"] = {
        k: (kbuild.launches[k] - before[k]) / (2 * PROFILE_BATCHES)
        for k in ("srtp_gcm_seal", "srtp_gcm_open")}
    batch = _mix_batch(rng, rng.permutation(live)[:BATCH], 2000, 99 * 960)
    wire = tx.protect_rtp(batch)
    require(np.array_equal(btx.protect_rtp(batch).data, wire.data),
            "srtp_gcm: the two tables differ")
    bad = _with_replay(wire, first, 3, 7)
    want = np.ones(BATCH + 1, bool)
    want[[7, BATCH]] = False
    for r in (rx, brx):
        _, ok = r.unprotect_rtp(bad)
        require(np.array_equal(ok, want), "srtp_gcm: the tampered and the "
                "replayed row are not exactly the rejected ones")
    rtcp = _rtcp_batch(rng, rng.permutation(live)[:PROFILE_RTCP])
    wire_c = tx.protect_rtcp(rtcp)
    dec_c, ok_c = rx.unprotect_rtcp(wire_c)
    require(ok_c.all() and dec_c.to_payloads() == rtcp.to_payloads()
            and np.array_equal(btx.protect_rtcp(rtcp).data, wire_c.data)
            and brx.unprotect_rtcp(wire_c)[1].all(),
            "srtp_gcm: the SRTCP round trip failed")
    out["srtcp_wire_bytes"] = int(np.asarray(wire_c.length).sum())
    # depth-2 pipeline of the async seams on A, B's sync calls beside
    batches = [_mix_batch(rng, rng.permutation(live)[:BATCH], 3000 + k,
                          k * 960) for k in range(ASYNC_BATCHES)]
    results, refs, pend_rx = [], [], []
    pend_tx = tx.protect_rtp_async(batches[0])
    for k in range(1, ASYNC_BATCHES + 1):
        nxt = (tx.protect_rtp_async(batches[k]) if k < ASYNC_BATCHES
               else None)
        wire = pend_tx.result()
        bw = btx.protect_rtp(batches[k - 1])
        require(np.array_equal(wire.data, bw.data),
                f"srtp_gcm async batch {k - 1}: the pipeline's wire differs "
                f"from the sync call's")
        pend_rx.append(rx.unprotect_rtp_async(wire))
        refs.append(brx.unprotect_rtp(bw))
        if len(pend_rx) == 2:
            results.append(pend_rx.pop(0).result())
        pend_tx = nxt
    rx.commit_inflight()
    results.append(pend_rx.pop(0).result())
    for k, ((dec, ok), (rdec, rok)) in enumerate(zip(results, refs)):
        require(ok.all() and np.array_equal(ok, rok)
                and np.array_equal(dec.data, rdec.data)
                and dec.to_payloads() == batches[k].to_payloads(),
                f"srtp_gcm async batch {k}: differs from the sync calls")
    for f in ("rx_max", "rx_mask", "auth_fail", "replay_reject"):
        require(np.array_equal(getattr(rx, f), getattr(brx, f)),
                f"srtp_gcm async: {f} differs from the sync calls'")
    # the keystream cache on A, B stock, streams 0-1,023
    caches = (tx.enable_keystream_cache(**GCM_CACHE),
              rx.enable_keystream_cache(**GCM_CACHE))
    for c in caches:
        c.prime(pool, 0x20000 + pool)
    hits = []
    for k in range(GCM_CACHE_BATCHES + 1):
        lens = None
        if k == GCM_CACHE_BATCHES:          # one 950-byte payload: a miss
            lens = rng.integers(60, 161, 4 * len(pool))
            lens[5] = 950
        batch = _audio_batch(rng, pool, 4 * k, lens)
        h0 = [(c.hits, c.misses) for c in caches]
        wire = tx.protect_rtp(batch)
        dec, ok = rx.unprotect_rtp(wire)
        bw = btx.protect_rtp(batch)
        bdec, bok = brx.unprotect_rtp(bw)
        require(np.array_equal(wire.data, bw.data) and ok.all() and bok.all()
                and np.array_equal(dec.data, bdec.data)
                and dec.to_payloads() == batch.to_payloads(),
                f"srtp_gcm cache batch {k}: differs from the stock path")
        d = [(c.hits - h[0], c.misses - h[1]) for c, h in zip(caches, h0)]
        hits.append(d)
        if k < GCM_CACHE_BATCHES:
            require(all(m == 0 and hh >= batch.batch_size for hh, m in d),
                    f"srtp_gcm cache batch {k}: not every row hit: {d}")
            for c in caches:
                c.fill()
        else:
            require(all(m > 0 for _hh, m in d),
                    f"srtp_gcm cache: the 950-byte batch did not miss: {d}")
    out.update(cache_hits_misses=hits,
               cache_stats=[c.stats() for c in caches])
    return out


def srtp_gcm_check(torch, dev, run) -> None:
    emit("srtp_gcm", streams=N_STREAMS, batch=BATCH,
         batches=PROFILE_BATCHES, install_s_per_table=run["install_s"],
         protect_ms_p50=float(np.median(run["prot_s"])) * 1e3,
         protect_ms_p99=float(np.percentile(run["prot_s"], 99)) * 1e3,
         unprotect_ms_p50=float(np.median(run["unprot_s"])) * 1e3,
         unprotect_ms_p99=float(np.percentile(run["unprot_s"], 99)) * 1e3,
         tampered_and_replayed_rejected=True, srtcp_rows=PROFILE_RTCP,
         async_batches=ASYNC_BATCHES, async_depth=2,
         async_equal_to_sync=True, cache=GCM_CACHE,
         cache_batches_hit=GCM_CACHE_BATCHES,
         cache_hits_misses_per_batch=run["cache_hits_misses"],
         cache_stats=run["cache_stats"],
         launches_per_batch=run["launches_per_batch"])


def sfu_gcm_run(torch, dev, setup) -> dict:
    """The SfuBridge under AEAD_AES_128_GCM at config #5's width (100 x 11,
    60-160-byte payloads with abs-send-time), GCM_TICKS ticks with an RR a
    sender at GCM_RR_TICK, 30 NACKs at GCM_NACK_TICK and `emit_feedback`
    every GCM_FEEDBACK ticks: N for the uplink and the RRs, H's GCM
    instance for the fan-out, M for the feedback."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    run = _sfu_drive(torch, dev, setup, GCM_TICKS,
                     feedback_every=GCM_FEEDBACK, nack_tick=GCM_NACK_TICK)
    run["launches_per_tick"] = {k: v / GCM_TICKS
                                for k, v in kbuild.launches.items()}
    return run


def sfu_gcm_check(torch, dev, run) -> None:
    """Every uplink packet and RR authenticated, `forwarded` equal to the
    accepted packets times their latched mates and to the unique copies
    the client received, the NACKed seqs served, no echo or
    cross-conference copy, and every copy opened by its leg's GCM table
    (kernel N) and equal to its sender's bytes."""
    setup, bridge = run["setup"], run["bridge"]
    require(int(bridge.rx_table.auth_fail.sum()) == 0
            and int(bridge.rx_table.replay_reject.sum()) == 0
            and run["taken"] == GCM_TICKS * SFU_N + sum(
                w.batch_size for w in setup["rtcp"].values()),
            "sfu_gcm: the bridge did not take every datagram")
    leg_of, echo, cross, copies = _fanout_log(setup, run["fanout"])
    require(echo == 0 and cross == 0,
            f"sfu_gcm: {echo} self-echo, {cross} cross-conference")
    nack = run["nack"]
    n_nacked = 3 * len(setup["nacked"])
    require(nack["retransmitted"] == nack["served"] == n_nacked
            and nack["cache_miss"] == 0, f"sfu_gcm NACK service: {nack}")
    counts = _check_copies(torch, dev, setup, run["received"], leg_of,
                           GCM_TICKS)
    require(bridge.forwarded == copies == run["expected"]
            == counts["copies_unique"]
            and counts["copies_received"] == counts["copies_unique"]
            + n_nacked and run["feedback_sent"] > 0,
            f"sfu_gcm: forwarded {bridge.forwarded}, logged {copies}, "
            f"expected {run['expected']}, received {counts}, feedback "
            f"{run['feedback_sent']}")
    secs = np.array(run["tick_s"])
    emit("sfu_gcm", profile=GCM, ticks=GCM_TICKS,
         tick_ms_p50=float(np.median(secs)) * 1e3,
         tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
         forwarded=bridge.forwarded, retransmitted=nack["retransmitted"],
         feedback_sent=run["feedback_sent"],
         launches_per_tick=run["launches_per_tick"], **counts)
    bridge.close()
    run["client"].close()


# ------------------------------------------------- the host I/O plane

#: every bridge and loop the run builds, for `exposition`
KEPT: list = []


def _keep(name: str, obj):
    """Note a bridge or loop the run built (its registry is rendered at
    the end); returns it."""
    KEPT.append((name, obj))
    return obj


def _conference_pipe_ticks(bridge, setup, ticks: int, client, kbuild
                           ) -> dict:
    """Drive a pipelined conference bridge through ticks 0..ticks-1 as
    `_conference_ticks` drives the serial one: tick k's mixes leave at
    the top of tick k + 1, so after tick k the client drains tick k - 1's
    (none after tick 0), and the last tick's leave at the final
    `flush_sends`."""
    n = CONF_PARTIES
    res = {"replies": [], "tick_s": []}
    for tick in range(ticks):
        client.send_batch(setup["wires"][tick], "127.0.0.1", bridge.port)
        time.sleep(0.002)
        t0 = time.perf_counter()
        stats = bridge.tick(now=1000.0 + 0.02 * tick)
        res["tick_s"].append(time.perf_counter() - t0)
        require(stats["rx"] == n and stats["tx"] == n,
                f"pipelined conference tick {tick}: rx {stats['rx']}, tx "
                f"{stats['tx']} of {n}")
        want = n if tick else 0
        got = _drain(client, want) if want else []
        require(len(got) == want, f"pipelined conference tick {tick}: "
                                  f"{len(got)} of {want} mixes came back")
        res["replies"].append(sorted(got))
    require(bridge.loop.flush_sends() == n,
            "the final flush_sends did not send the last tick's mixes")
    last = _drain(client, n)
    require(len(last) == n, f"after the final flush_sends {len(last)} of "
                            f"{n} mixes came back")
    res["replies"].append(sorted(last))
    return res


def _conference_pipe_drive(dev, setup, depth: int, ticks: int, kbuild=None,
                           name: str = "") -> dict:
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.service.bridge import ConferenceBridge

    bridge = _keep(name, ConferenceBridge(
        capacity=CONF_PARTIES, pipeline_depth=depth, kernel_timestamps=True,
        device=dev))
    require(bridge.loop.pipelined and bridge.loop.use_kernel_ts,
            f"{name}: not pipelined or no kernel stamps")
    _conference_join(bridge, setup)
    with UdpEngine(port=0, bind_ip="127.0.0.1",
                   max_batch=2 * CONF_PARTIES) as client:
        res = _conference_pipe_ticks(bridge, setup, ticks, client, kbuild)
    bridge.close()
    return res


def conference_pipelined_run(torch, dev, setup) -> dict:
    """The conference path's bridge pipelined on the card, with kernel
    arrival stamps: CONF_PIPE's (depth, ticks) runs on the conference
    wire, each a fresh bridge."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    runs = {depth: _conference_pipe_drive(
        dev, setup, depth, ticks, kbuild,
        f"conference_pipelined depth {depth}") for depth, ticks in CONF_PIPE}
    total = sum(t for _d, t in CONF_PIPE)
    return dict(runs=runs, launches_per_tick={
        k: v / total for k, v in kbuild.launches.items()})


def conference_pipelined_check(torch, dev, piped, setup, conf) -> None:
    """Each depth's run again on the CPU (plain versions): every tick's
    wire equal; every mix authenticates at its party; tick p50/p99
    beside the serial conference's of this run."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    n = CONF_PARTIES
    serial = np.array(conf["tick_s"])
    lines = {}
    for depth, ticks in CONF_PIPE:
        run = piped["runs"][depth]
        t0 = time.perf_counter()
        ref = _conference_pipe_drive(torch.device("cpu"), setup, depth,
                                     ticks, name=f"conference_pipelined "
                                                 f"depth {depth} cpu")
        cpu_s = time.perf_counter() - t0
        for tick, (a, b) in enumerate(zip(run["replies"], ref["replies"])):
            require(a == b, f"pipelined conference depth {depth}, egress "
                            f"after tick {tick}: the card's wire differs "
                            "from the CPU run's")
        down = SrtpStreamTable(n, device=dev)
        down.add_streams(np.arange(n), *setup["keys"]["tx"])
        authed = 0
        for tick, wire in enumerate(run["replies"]):
            if not wire:
                continue
            batch = PacketBatch.from_payloads(wire)
            batch.stream[:] = rtp_header.parse(batch).ssrc - 0x42000000
            _dec, ok = down.unprotect_rtp(batch)
            require(ok.all(), f"pipelined conference depth {depth}: a mix "
                              f"sent after tick {tick} failed to "
                              "authenticate")
            authed += int(ok.sum())
        require(authed == n * ticks, f"depth {depth}: {authed} mixes")
        secs = np.array(run["tick_s"])
        lines[depth] = dict(
            ticks=ticks, tick_ms_p50=float(np.median(secs)) * 1e3,
            tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
            mixes_authenticated=authed, equal_to_cpu_run=True,
            last_mixes_after_final_flush=n, cpu_run_s=cpu_s)
    emit("conference_pipelined", participants=n, kernel_timestamps=True,
         depths=lines,
         serial_tick_ms_p50=float(np.median(serial)) * 1e3,
         serial_tick_ms_p99=float(np.percentile(serial, 99)) * 1e3,
         launches_per_tick=piped["launches_per_tick"])


class _Fan:
    """SFU_RINGS_SOCKETS client sockets standing in for the endpoints:
    endpoint k sends from socket k mod SFU_RINGS_SOCKETS (so its copies
    come back there), so the flows spread over the bridge's rings."""

    def __init__(self):
        from libjitsi_tpu_torch.io.udp import UdpEngine

        self.socks = [UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=4096,
                                rcvbuf=16 << 20)
                      for _ in range(SFU_RINGS_SOCKETS)]

    def send_rows(self, wire, rows, ip, port) -> int:
        rows = np.asarray(rows)
        ep = np.asarray(wire.stream)[rows] % len(self.socks)
        return sum(s.send_rows(wire, rows[ep == j], ip, port)
                   for j, s in enumerate(self.socks) if (ep == j).any())

    def close(self) -> None:
        for s in self.socks:
            s.close()


def sfu_rings_run(torch, dev, setup, rings: int = SFU_RINGS) -> dict:
    """The sfu path's bridge with `rings` SO_REUSEPORT ingest rings and
    kernel stamps, SFU_RINGS_TICKS ticks of the setup's input from
    SFU_RINGS_SOCKETS sockets (drained by a thread), `emit_feedback`
    every SFU_RINGS_FEEDBACK ticks, then SFU_RINGS_PROFILED ticks under
    torch.profiler; each ring's datagrams are counted and every BWE
    arrival is held to the host window of its tick."""
    import threading

    from libjitsi_tpu_torch.kernels import build as kbuild

    bridge = _sfu_bridge(torch, dev, setup, ingest_rings=rings,
                         kernel_timestamps=True)
    per_ring = [0] * len(bridge.loop.rings)
    for i, eng in enumerate(bridge.loop.rings):
        def counted(ms, orig=eng.recv_batch_ts, i=i):
            out = orig(ms)
            per_ring[i] += out[0].batch_size
            return out
        eng.recv_batch_ts = counted
    window = [0.0]
    arrivals = dict(n=0, outside=0, lead=float("inf"), lag=0.0)
    incoming = bridge.bwe.incoming_batch

    def held(tids, arrival_ms, ast24, sizes):
        a = np.asarray(arrival_ms)
        hi = time.time() * 1e3
        arrivals["n"] += len(a)
        arrivals["outside"] += int(((a < window[0]) | (a > hi)).sum())
        # the earliest stamp after its tick's first send, and the oldest
        # a feed's newest stamp was when the BWE read it
        arrivals["lead"] = min(arrivals["lead"], float(a.min() - window[0]))
        arrivals["lag"] = max(arrivals["lag"], float(hi - a.max()))
        return incoming(tids, arrival_ms, ast24, sizes)

    bridge.bwe.incoming_batch = held
    fanout = []
    emit_fanout = bridge._emit_fanout

    def logged(wire, recv, origin=None):
        ready = np.nonzero(bridge.loop.addr_port[recv] != 0)[0]
        fanout.append((wire.data[ready], np.asarray(wire.length)[ready],
                       recv[ready]))
        return emit_fanout(wire, recv, origin=origin)

    bridge._emit_fanout = logged
    fan = _Fan()
    got, stop = [], threading.Event()

    def drain():
        while not stop.is_set():
            for j, s in enumerate(fan.socks):
                b, _, _ = s.recv_batch(timeout_ms=1)
                got.extend((j, p) for p in b.to_payloads())

    th = threading.Thread(target=drain, daemon=True)
    th.start()
    res = dict(tick_s=[], taken=0, feedback_sent=0)
    try:
        for t in range(SFU_RINGS_TICKS):
            window[0] = time.time() * 1e3
            secs, taken, _ = _sfu_tick(bridge, setup, t, fan)
            res["tick_s"].append(secs)
            res["taken"] += taken
            if t == 0:
                res["forwarded_tick0"] = bridge.forwarded
            if t == SFU_RINGS_NACK:
                res["nack"] = dict(
                    retransmitted=bridge.retransmitted,
                    served=bridge.recovery.rtx_requests_served,
                    cache_miss=bridge.recovery.rtx_cache_miss)
            if t % SFU_RINGS_FEEDBACK == SFU_RINGS_FEEDBACK - 1:
                res["feedback_sent"] += bridge.emit_feedback(
                    now=1000.0 + 0.02 * t + 0.01)

        def profiled(i):
            window[0] = time.time() * 1e3
            res["taken"] += _sfu_tick(bridge, setup, SFU_RINGS_TICKS + i,
                                      fan)[1]

        res["profile"] = _outside_spans(profiled_ticks(
            torch, profiled, SFU_RINGS_PROFILED))
    finally:
        time.sleep(0.1)
        stop.set()
        th.join()
    res.update(bridge=bridge, fan=fan, received=got, fanout=fanout,
               setup=setup, per_ring=per_ring, arrivals=arrivals,
               launches_per_tick={
                   k: v / (SFU_RINGS_TICKS + SFU_RINGS_PROFILED)
                   for k, v in kbuild.launches.items()})
    return res


def sfu_rings_check(torch, dev, run, serial) -> None:
    """Gates of the ringed SFU: both rings drained datagrams and together
    all that was sent; `loop_ingest_rings` reads SFU_RINGS; no echo and
    no copy across conferences; from tick 1 (every address latched) each
    packet went to its 10 mates; every copy came back at its leg's
    socket and authenticates under its leg's key as its sender's bytes;
    the NACKs were served; every BWE arrival was a kernel stamp inside
    its tick's host window; a snapshot restores with SFU_RINGS rings."""
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge

    setup, bridge = run["setup"], run["bridge"]
    ticks = SFU_RINGS_TICKS + SFU_RINGS_PROFILED
    sent = ticks * SFU_N + sum(w.batch_size for w in setup["rtcp"].values())
    rings = run["per_ring"]
    require(len(rings) == SFU_RINGS and min(rings) > 0
            and sum(rings) == sent == run["taken"],
            f"sfu_rings: rings drained {rings}, sent {sent}, taken "
            f"{run['taken']}")
    require(bridge.loop.metrics.sample_total("loop_ingest_rings")
            == SFU_RINGS, "sfu_rings: loop_ingest_rings")
    require(int(bridge.rx_table.auth_fail.sum()) == 0
            and int(bridge.rx_table.replay_reject.sum()) == 0,
            "sfu_rings: the bridge rejected genuine uplink packets")
    leg_of, echo, cross, copies = _fanout_log(setup, run["fanout"])
    require(echo == 0 and cross == 0, f"sfu_rings: {echo} self-echo and "
                                      f"{cross} cross-conference copies")
    later = bridge.forwarded - run["forwarded_tick0"]
    require(bridge.forwarded == copies
            and later == (ticks - 1) * SFU_N * (SFU_SIZE - 1),
            f"sfu_rings: forwarded {bridge.forwarded}, logged {copies}, "
            f"{later} after tick 0")
    media = [(j, p) for j, p in run["received"] if not 192 <= p[1] <= 223]
    astray = sum(1 for j, p in media
                 if leg_of.get(p[2:4] + p[8:12] + p[-TAG:], -1)
                 % SFU_RINGS_SOCKETS != j)
    require(astray == 0, f"sfu_rings: {astray} copies reached another "
                         "socket than their leg's")
    counts = _check_copies(torch, dev, setup,
                           [p for _j, p in run["received"]], leg_of, ticks)
    nack = run["nack"]
    n_nacked = 3 * len(setup["nacked"])
    require(nack["retransmitted"] == nack["served"] == n_nacked
            and nack["cache_miss"] == 0
            and counts["copies_unique"] == bridge.forwarded
            and counts["copies_received"] == bridge.forwarded + n_nacked
            and run["feedback_sent"] > 0,
            f"sfu_rings: NACKs {nack}, copies {counts}, feedback "
            f"{run['feedback_sent']}")
    arr = run["arrivals"]
    require(all(e.kernel_timestamps for e in bridge.loop.rings)
            and arr["n"] == ticks * SFU_N and arr["outside"] == 0,
            f"sfu_rings: BWE arrivals {arr}")
    snap = bridge.snapshot()
    back = _keep("sfu_rings restored", SfuBridge.restore(snap, device=dev))
    restored = (back.ingest_rings, len(back.loop.rings),
                len({e.port for e in back.loop.rings}))
    back.close()
    require(snap["ingest_rings"] == SFU_RINGS
            and restored == (SFU_RINGS, SFU_RINGS, 1),
            f"sfu_rings: restored as {restored}")
    bridge.close()
    run["fan"].close()
    secs, ser = np.array(run["tick_s"]), np.array(serial["tick_s"])
    emit("sfu_rings", rings=SFU_RINGS, client_sockets=SFU_RINGS_SOCKETS,
         ticks=SFU_RINGS_TICKS, profiled_ticks=SFU_RINGS_PROFILED,
         per_ring=rings, sent=sent,
         tick_ms_p50=float(np.median(secs)) * 1e3,
         tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
         serial_tick_ms_p50=float(np.median(ser)) * 1e3,
         serial_tick_ms_p99=float(np.percentile(ser, 99)) * 1e3,
         forwarded=bridge.forwarded, retransmitted=nack["retransmitted"],
         feedback_sent=run["feedback_sent"], bwe_arrivals=arr["n"],
         bwe_stamp_after_tick_start_min_ms=arr["lead"],
         bwe_newest_stamp_age_at_feed_max_ms=arr["lag"],
         restored_rings=restored[1], profile=run["profile"],
         launches_per_tick=run["launches_per_tick"], **counts)


class _TickBudget:
    """The burn state an `AdaptiveBatcher` follows here (any object with
    `.state()`): the last tick's wall time, `slow_burn` over
    TICK_BUDGET_S (twice the 20 ms ptime) and `fast_burn` over 2.5 times
    that."""

    def __init__(self):
        self.last_s = 0.0

    def state(self) -> str:
        if self.last_s > 2.5 * TICK_BUDGET_S:
            return "fast_burn"
        return "slow_burn" if self.last_s > TICK_BUDGET_S else "ok"


def _batcher_setup(torch, dev, keys) -> dict:
    """The client's wire for `echo_batcher`, under the echo path's keys:
    one BATCHER_BURST-packet burst, then BATCHER_CALM_TICKS ticks of
    BATCHER_CALM packets, each packet from a stream of its own."""
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    rng = np.random.default_rng(37)
    streams = rng.permutation(N_STREAMS)
    c_tx = SrtpStreamTable(N_STREAMS, device=dev)
    c_tx.add_streams(np.arange(N_STREAMS), keys["mks"], keys["mss"])
    cuts = [BATCHER_BURST] + [BATCHER_CALM] * BATCHER_CALM_TICKS
    wires, lo = [], 0
    for k in cuts:
        sids = streams[lo:lo + k]
        lo += k
        lens = production_lengths(rng, k)
        plain = rtp_header.build(
            [rng.integers(0, 256, int(x), np.uint8).tobytes() for x in lens],
            [9] * k, [0] * k, (0x20000 + sids).tolist(), [96] * k,
            stream=sids.tolist())
        wires.append(c_tx.protect_rtp(plain))
    dn = (rng.integers(0, 256, (N_STREAMS, 16), np.uint8),
          rng.integers(0, 256, (N_STREAMS, 14), np.uint8))
    return dict(keys=keys, down=dn, burst=wires[0], calm=wires[1:])


def echo_batcher_run(torch, dev, setup) -> dict:
    """The srtp_echo loop at depth 1 under an `AdaptiveBatcher` (cap
    ECHO_BURST, window BATCHER_WINDOW_MS, the burn state `_TickBudget`):
    the burst sent at once and ticked in, then each calm tick's packets,
    then idle ticks until both knobs are at their base (at most
    BATCHER_CALM_TICKS).  Every tick's knobs are recorded."""
    from libjitsi_tpu_torch.io.batching import AdaptiveBatcher
    from libjitsi_tpu_torch.io.loop import MediaLoop
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.service.media_stream import StreamRegistry
    from libjitsi_tpu_torch.transform.engine import TransformEngineChain
    from libjitsi_tpu_torch.transform.srtp.engine import SrtpTransformEngine
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    sids = np.arange(N_STREAMS)
    reg = StreamRegistry(N_STREAMS, device=dev)
    b_tx, b_rx = reg.srtp_tables(SrtpProfile.AES_CM_128_HMAC_SHA1_80)
    b_rx.add_streams(sids, setup["keys"]["mks"], setup["keys"]["mss"])
    b_tx.add_streams(sids, *setup["down"])
    for sid in sids:
        reg.map_ssrc(0x20000 + int(sid), int(sid))
    bad = [0]

    def on_media(batch, ok):
        bad[0] += int((~ok).sum())
        return _echo_rows(batch, ok)

    b_eng = UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=ECHO_BURST,
                      rcvbuf=32 << 20)
    client = UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=4096,
                       rcvbuf=32 << 20)
    loop = _keep("echo_batcher", MediaLoop(
        b_eng, reg, on_media=on_media,
        chain=TransformEngineChain([SrtpTransformEngine(b_tx, b_rx)]),
        recv_window_ms=BATCHER_WINDOW_MS, phase_sample_every=0))
    budget = _TickBudget()
    batcher = AdaptiveBatcher(loop, slo=budget)
    batcher.register_metrics(loop.metrics)
    traj, echoed, busy = [], [0], []

    def step(phase):
        t0 = time.perf_counter()
        n = loop.tick()
        budget.last_s = time.perf_counter() - t0
        if n:
            busy.append(budget.last_s)
        batcher.on_tick()
        traj.append(dict(phase=phase, rx=n, ms=budget.last_s * 1e3,
                         state=budget.state(),
                         window_ms=loop.recv_window_ms, cap=b_eng.max_batch))
        while True:
            b, _, _ = client.recv_batch(timeout_ms=0)
            echoed[0] += b.batch_size
            if not b.batch_size:
                return n

    def take(wire, phase):
        require(client.send_batch(wire, "127.0.0.1", b_eng.port)
                == wire.batch_size, "echo_batcher: a short send")
        got = 0
        for _ in range(400):
            got += step(phase)
            if got >= wire.batch_size:
                break
        require(got == wire.batch_size, f"echo_batcher {phase}: the loop "
                                        f"took {got} of {wire.batch_size}")

    take(setup["burst"], "burst")
    polls = batcher.backlog_polls
    for wire in setup["calm"]:
        time.sleep(0.002)
        take(wire, "calm")
    for _ in range(BATCHER_CALM_TICKS):
        if (b_eng.max_batch == batcher.base_batch
                and loop.recv_window_ms == batcher.base_window_ms):
            break
        step("idle")
    for _ in range(100):
        if echoed[0] >= loop.rx_packets:
            break
        b, _, _ = client.recv_batch(timeout_ms=5)
        echoed[0] += b.batch_size
    client.close()
    b_eng.close()
    return dict(loop=loop, batcher=batcher, traj=traj, busy=busy,
                polls_after_burst=polls, echoed=echoed[0], bad=bad[0],
                launches_per_tick={k: v / len(traj)
                                   for k, v in kbuild.launches.items()})


def echo_batcher_check(torch, dev, run) -> None:
    """Gates of the batcher path: the burst raised the backlog signal at
    least once, the cap and window ended at their base, every packet was
    authenticated and echoed."""
    loop, b = run["loop"], run["batcher"]
    sent = BATCHER_BURST + BATCHER_CALM * BATCHER_CALM_TICKS
    require(run["polls_after_burst"] >= 1,
            "echo_batcher: the burst never raised the backlog signal")
    require(loop.engine.max_batch == b.base_batch == ECHO_BURST
            and loop.recv_window_ms == b.base_window_ms
            == BATCHER_WINDOW_MS,
            f"echo_batcher: ended at cap {loop.engine.max_batch}, window "
            f"{loop.recv_window_ms}")
    require(loop.rx_packets == sent == run["echoed"] and run["bad"] == 0,
            f"echo_batcher: rx {loop.rx_packets}, echoed {run['echoed']}, "
            f"rejected {run['bad']} of {sent}")
    busy = np.array(run["busy"])
    emit("echo_batcher", cap=ECHO_BURST, window_ms=BATCHER_WINDOW_MS,
         burst=BATCHER_BURST, calm_ticks=BATCHER_CALM_TICKS,
         calm_packets=BATCHER_CALM, ticks=len(run["traj"]),
         backlog_polls=b.backlog_polls, burn_shrinks=b.burn_shrinks,
         recoveries=b.recoveries, polls_after_burst=run["polls_after_burst"],
         tick_ms_p50=float(np.median(busy)) * 1e3,
         tick_ms_p99=float(np.percentile(busy, 99)) * 1e3,
         trajectory=run["traj"], launches_per_tick=run["launches_per_tick"])


def exposition(torch) -> None:
    """Render the registry of every bridge and loop the run built (a
    conference bridge's receive bank registered on it first), plain and
    OpenMetrics; fail unless `validate_exposition` finds nothing."""
    from libjitsi_tpu_torch.utils.metrics import (count_exemplars,
                                                  validate_exposition)

    out, banks = {}, 0
    for name, obj in KEPT:
        reg = getattr(obj, "loop", obj).metrics
        bank = getattr(obj, "bank", None)
        if bank is not None:
            if not reg.has_metric("bank_decoded_frames"):
                bank.register_metrics(reg)
            banks += 1
        texts = [reg.render(openmetrics=om) for om in (False, True)]
        errs = [validate_exposition(t, openmetrics=om)
                for t, om in zip(texts, (False, True))]
        require(errs == [[], []], f"exposition of {name}: {errs}")
        require(bank is None or "bank_jitter_seconds_bucket" in texts[0],
                f"exposition of {name}: the bank's metrics are missing")
        out[name] = dict(families=len(reg.families()),
                         lines=texts[0].count("\n"),
                         exemplars=count_exemplars(texts[1]))
    require(banks >= 1, "exposition: no receive bank was registered")
    emit("exposition", registries=len(out), banks_registered=banks,
         valid=True, by_registry=out)


# --------------------------------------------- the public stream API

class _MsClock:
    """The transport-cc and abs-send-time engines' clock: the tick's
    explicit time, so the card run and its CPU twin stamp alike."""

    t = MS_T0

    def __call__(self) -> float:
        return self.t


def _ms_claim(reg, row: int) -> None:
    """Reserve every free row below `row`, so the next stream the
    registry allocates lands on `row` (a twin process that runs only
    some pairs gives each the row it has in the whole run)."""
    below = [r for r in range(row) if r not in reg.streams]
    if below:
        reg.reserve_many(below, None)


def _ms_pair(svc, far, profile: str, base_ssrc: int, k: int, row: int,
             clock):
    """Pair k of a profile: the near end on the service's own registry (a
    transport-cc and an abs-send-time engine beside the levels and
    DTMF), the far end on `far`, both at `row`; keyed by SDES offer and
    answer from the pair's own seeded generator, which draws its seq and
    ts too; the near end's level source fixed."""
    from libjitsi_tpu_torch.control.sdes import SdesControl
    from libjitsi_tpu_torch.transform.header_ext import (AbsSendTimeEngine,
                                                         TransportCCEngine)
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    prof = SrtpProfile(profile)
    rng = np.random.default_rng([base_ssrc, k])
    _ms_claim(svc.registry, row)
    near = svc.create_media_stream(
        "audio", profile=prof, local_ssrc=base_ssrc + 2 * k,
        extra_engines=[TransportCCEngine(5, clock=clock),
                       AbsSendTimeEngine(3, clock=clock)])
    _ms_claim(far, row)
    far_s = svc.create_media_stream("audio", registry=far, profile=prof,
                                    local_ssrc=base_ssrc + 2 * k + 1)
    require(near.sid == far_s.sid == row, f"media_stream: pair {k} of "
            f"{profile} took rows {near.sid}, {far_s.sid}, not {row}")
    for s in (near, far_s):
        s.sdes = SdesControl(profiles=[prof], rng=rng.bytes)
        s._tx_seq = int(rng.integers(0, 1 << 16))
        s._tx_ts = int(rng.integers(0, 1 << 32))
        s.add_dynamic_rtp_payload_type(0, "PCMU", 8000)
    near.sdes.accept_answer(far_s.sdes.create_answer(near.sdes.create_offer()))
    near.set_remote_ssrc(far_s.local_ssrc)
    far_s.set_remote_ssrc(near.local_ssrc)
    near.start()
    far_s.start()
    near.set_level_source(
        lambda sids, lv=k % 128: np.full(len(sids), lv, np.uint8))
    events = []
    far_s.add_dtmf_listener(lambda sid, e: events.append(
        (sid, e.event, e.end, e.duration)))
    return near, far_s, events


MS_MAIN = "AES_CM_128_HMAC_SHA1_80"


def _ms_build(svc, far, main=range(MS_PAIRS), others: bool = True) -> dict:
    """Pairs `main` of the main profile (rows k) and, with `others`, every
    MS_OTHER pair (rows after them) on `svc` and `far`; the frames."""
    clock = _MsClock()
    groups = {MS_MAIN: {k: _ms_pair(svc, far, MS_MAIN, 0x10000000, k, k,
                                    clock) for k in main}}
    row = MS_PAIRS
    for i, (profile, n) in enumerate(MS_OTHER if others else ()):
        groups[profile] = {k: _ms_pair(svc, far, profile,
                                       0x20000000 + 0x1000 * i, k, row + k,
                                       clock) for k in range(n)}
        row += n
    frames = np.random.default_rng(61).integers(
        0, 256, (MS_PAIRS, 4, 160), np.uint8)
    return dict(svc=svc, far=far, clock=clock, groups=groups, frames=frames)


def media_stream_setup(torch, dev) -> dict:
    """The Quick start on the card: `init()` (no device: the card) and
    `media_service()`, a second 1,024-row registry for the far ends,
    and every profile's pairs keyed and started."""
    import libjitsi_tpu_torch
    from libjitsi_tpu_torch.service.media_stream import StreamRegistry

    libjitsi_tpu_torch.stop()
    libjitsi_tpu_torch.init({"libjitsi_tpu.stream_capacity": MS_WIDTH})
    svc = libjitsi_tpu_torch.media_service()
    require(svc.device == dev and svc.registry.capacity == MS_WIDTH,
            f"media_service() built on {svc.device}, "
            f"{svc.registry.capacity} rows")
    t0 = time.perf_counter()
    setup = _ms_build(svc, StreamRegistry(MS_WIDTH, device=dev))
    setup["setup_s"] = time.perf_counter() - t0
    return setup


def _ms_drive(torch, setup, timed: bool) -> dict:
    """MS_TICKS 20 ms ticks of every profile's pairs: each near end sends
    one 160-byte PCMU frame and its far end receives it (tick MS_LOST's
    packets of the first pairs lost), the first MS_DTMF pairs send a
    tone, and at each RTCP tick the near end's SR goes to the far end
    and the far end's report back.  Then the next packet of every main
    pair in one registry-wide unprotect (with a tampered copy of pair
    5's and a replay of pair 7's last), and a tampered and a replayed
    datagram through pair 0's own receive.  `timed`: per-call host
    times, the main profile's launches a tick and MS_PROFILED under
    torch.profiler.  Returns, pair by pair, what the card run and its
    CPU twin must agree on."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.engine import TransformEngineChain
    from libjitsi_tpu_torch.transform.srtp.engine import SrtpTransformEngine
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    clock, frames, far = setup["clock"], setup["frames"], setup["far"]
    regs = (setup["svc"].registry, far)
    per = {(p, k): {"wire": [], "reports": [], "bwe": []}
           for p, g in setup["groups"].items() for k in g}
    times = {"send": [], "receive": []}
    prof_lines = []

    def tick(profile, pairs, t):
        main = profile == MS_MAIN
        now = MS_T0 + 0.02 * t
        clock.t = now
        for k, (near, far_s, _) in pairs.items():
            if main and k < MS_DTMF[0]:
                if t == MS_DTMF[1]:
                    near.start_sending_dtmf("0123456789*#ABCD"[k % 16])
                if t == MS_DTMF[2]:
                    near.stop_sending_dtmf()
            frame = frames[k, t % 4].tobytes()
            t0 = time.perf_counter()
            wire = near.send([frame], pt=0, ts_step=160)
            t1 = time.perf_counter()
            per[profile, k]["wire"].append(wire[0])
            if t == MS_LOST[0] and k < MS_LOST[1]:
                continue
            got, ok = far_s.receive(wire, arrival=now + 0.0005 * (k % 8))
            t2 = time.perf_counter()
            if main and timed:
                times["send"].append(t1 - t0)
                times["receive"].append(t2 - t1)
            tone = main and k < MS_DTMF[0] and \
                MS_DTMF[1] <= t <= MS_DTMF[2] + 2
            if tone:        # telephone-events are consumed, not passed on
                require(not ok[0], f"media_stream: pair {k} tick {t}'s "
                                   "event reached the decoder")
                continue
            off = int(rtp_header.parse(got).payload_off[0])
            require(bool(ok[0]) and got.to_bytes(0)[off:] == frame,
                    f"media_stream: {profile} pair {k} tick {t}'s payload "
                    "did not come back as sent")
        if t in MS_RTCP_TICKS:
            for k, (near, far_s, _) in pairs.items():
                sr = near.make_rtcp_report(now=now + 0.005)
                far_s.handle_rtcp(sr, now=now + 0.006)
                rr = far_s.make_rtcp_report(now=now + 0.007)
                near.handle_rtcp(rr, now=now + 0.008)
                per[profile, k]["reports"] += [sr, rr]
                per[profile, k]["bwe"].append(
                    (near.bwe.estimate_bps, near.bwe.loss_estimate,
                     near.stats["rtt_seconds"]))

    for r in regs:
        r.stats2.poll(now=MS_T0)
    for profile, pairs in setup["groups"].items():
        pre = dict(kbuild.launches)
        for t in range(1, MS_TICKS + 1):
            if profile == MS_MAIN and timed and t in MS_PROFILED:
                prof_lines.append(profiled_ticks(
                    torch, lambda _i, t=t: tick(profile, pairs, t), 1))
            else:
                tick(profile, pairs, t)
        if profile == MS_MAIN:
            launches = {k: (kbuild.launches[k] - pre[k]) / MS_TICKS
                        for k in pre}
    now = MS_T0 + 0.02 * (MS_TICKS + 1)
    clock.t = now
    for r in regs:
        r.stats2.poll(now=now)

    # one registry-wide ingest of every main pair's next packet, with a
    # tampered copy of pair 5's and a replay of pair 7's last beside them
    prof = SrtpProfile(MS_MAIN)
    pairs = setup["groups"][MS_MAIN]
    keys = sorted(pairs)
    out = {"pairs": per, "ingest_extra": []}
    if not keys:                    # a twin process of the other profiles
        return _ms_finish(setup, out)
    wire = [pairs[k][0].send([frames[k, 0].tobytes()], pt=0,
                             ts_step=160)[0] for k in keys]
    extra = []
    if 5 in pairs:
        bad = bytearray(wire[keys.index(5)])
        bad[-3] ^= 0x10
        extra.append(bytes(bad))
    if 7 in pairs:
        extra.append(per[MS_MAIN, 7]["wire"][-1])
    batch = PacketBatch.from_payloads(wire + extra)
    sids = far.demux(batch)
    require(np.array_equal(sids[:len(keys)], keys),
            "media_stream: the far registry's demux missed a stream")
    chain = TransformEngineChain(
        [SrtpTransformEngine(*far.srtp_tables(prof))])
    t0 = time.perf_counter()
    got, ok = chain.rtp_transformer.reverse_transform(batch)
    ingest_s = time.perf_counter() - t0
    require(ok[:len(keys)].all() and not ok[len(keys):].any(),
            f"media_stream ingest: {ok[:len(keys)].sum()} of {len(keys)} "
            f"genuine rows, {ok[len(keys):].tolist()} for the tampered and "
            "the replayed")
    hdr = rtp_header.parse(got)
    for i, k in enumerate(keys):
        row = got.to_bytes(i)
        require(row[int(hdr.payload_off[i]):] == frames[k, 0].tobytes(),
                f"media_stream ingest: pair {k}'s payload did not come "
                "back as sent")
        per[MS_MAIN, k]["ingest"] = row
    out["ingest_extra"] = ok[len(keys):].tolist()

    # a tampered and a replayed datagram through pair 0's own receive
    if 0 in pairs:
        near, far_s, _ = pairs[0]
        wire = near.send([frames[0, 1].tobytes()], pt=0, ts_step=160)
        bad = bytearray(wire[0])
        bad[-1] ^= 0x01
        before = far_s.stats["rx_packets"]
        _, ok = far_s.receive([bytes(bad), wire[0], wire[0]], arrival=now)
        require(ok.tolist() == [False, True, False]
                and far_s.stats["rx_packets"] == before + 1,
                f"media_stream: tampered and replayed datagrams gave "
                f"{ok.tolist()}, rx_packets {before} -> "
                f"{far_s.stats['rx_packets']}")
        out["tamper"] = ok.tolist()
    if timed:
        out.update(times=times, ingest_s=ingest_s, profiled=prof_lines,
                   launches_per_tick=launches)
    return _ms_finish(setup, out)


def _ms_finish(setup, out) -> dict:
    """Each pair's stats, DTMF events and level into its record."""
    for (p, k), rec in out["pairs"].items():
        near, far_s, events = setup["groups"][p][k]
        rec.update(stats=(near.stats, far_s.stats,
                          dataclasses.asdict(near.send_stats()),
                          dataclasses.asdict(far_s.receive_stats())),
                   events=list(events), level=far_s.last_received_level)
    return out


def media_stream_run(torch, dev, setup) -> dict:
    """The Quick start's streams on the card, counted: every profile's
    ticks and the registry-wide ingest."""
    res = _ms_drive(torch, setup, timed=True)
    res["setup"] = setup
    return res


def _ms_twin_part(main_lo: int, main_hi: int, others: bool) -> dict:
    """One process of the CPU twin: main pairs [main_lo, main_hi) (and the
    other profiles' pairs with `others`) on a `MediaService` and far
    registry with `device="cpu"`, one PyTorch thread."""
    import torch

    from libjitsi_tpu_torch.core.config import ConfigurationService
    from libjitsi_tpu_torch.service.media_service import MediaService
    from libjitsi_tpu_torch.service.media_stream import StreamRegistry

    torch.set_num_threads(1)
    svc = MediaService(ConfigurationService(
        {"libjitsi_tpu.stream_capacity": MS_WIDTH}), device="cpu")
    setup = _ms_build(svc, StreamRegistry(MS_WIDTH, device="cpu"),
                      range(main_lo, main_hi), others)
    return _ms_drive(torch, setup, timed=False)


def _ms_twin(workers: int) -> dict:
    """The CPU twin of the whole run in `workers` processes (the plain
    versions cost tens of ms a call on the host): the main pairs split
    over all but one, the other profiles' pairs in that one; every pair
    exactly as on the card, each process's ingest over its own pairs
    (row by row the same unprotect).  Returns the merged per-pair results, the
    tamper verdicts and the ingest's extra rows (pairs 5 and 7 in one
    process)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    cuts = np.linspace(0, MS_PAIRS, max(workers - 1, 1) + 1).astype(int)
    ranges = [(int(lo), int(hi), False) for lo, hi in zip(cuts[:-1], cuts[1:])]
    merged = {"pairs": {}, "ingest_extra": []}
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        parts = [ex.submit(_ms_twin_part, lo, hi, others)
                 for lo, hi, others in ranges + [(0, 0, True)]]
        for f in parts:
            res = f.result()
            merged["pairs"].update(res["pairs"])
            merged["ingest_extra"] += res["ingest_extra"]
            if "tamper" in res:
                merged["tamper"] = res["tamper"]
    return merged


def media_stream_check(torch, dev, run, smi) -> None:
    """The same run on the CPU (`_ms_twin`): every pair's wire bytes,
    stats, report bytes, BWE estimates and RTT, DTMF events, level and
    ingest row, and the tamper verdicts, equal to the card's.  Prints the
    `media_stream` line."""
    workers = max(1, min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    twin = _ms_twin(workers)
    twin_s = time.perf_counter() - t0
    require(set(twin["pairs"]) == set(run["pairs"]),
            "media_stream: the CPU twin ran other pairs")
    for key, rec in run["pairs"].items():
        for field, val in rec.items():
            require(twin["pairs"][key][field] == val,
                    f"media_stream: {key}'s {field} on the card differs "
                    "from the CPU run's")
    require(twin["tamper"] == run["tamper"]
            and twin["ingest_extra"] == run["ingest_extra"],
            "media_stream: the refusals differ from the CPU run's")
    setup = run["setup"]
    main = [rec for (p, _k), rec in run["pairs"].items() if p == MS_MAIN]
    send, recv = (np.array(run["times"][k]) * 1e3
                  for k in ("send", "receive"))
    bwe = [b for rec in main for b in rec["bwe"]]
    emit("media_stream", nvidia_smi=smi, registry_rows=MS_WIDTH,
         pairs=MS_PAIRS, ticks=MS_TICKS,
         other_profiles={p: n for p, n in MS_OTHER},
         setup_s=setup["setup_s"],
         send_ms_p50=float(np.median(send)),
         send_ms_p99=float(np.percentile(send, 99)),
         receive_ms_p50=float(np.median(recv)),
         receive_ms_p99=float(np.percentile(recv, 99)),
         calls_timed=len(send), ingest_rows=MS_PAIRS + 2,
         ingest_batch_ms=run["ingest_s"] * 1e3,
         profiled_ticks={
             "ticks": list(MS_PROFILED),
             "wall_ms": [p["wall_ms_per_tick"] for p in run["profiled"]],
             "device_busy_ms": [p["device_busy_ms_per_tick"]
                                for p in run["profiled"]],
             "device_idle_share": [p["device_idle_share"]
                                   for p in run["profiled"]],
             "device_ms_by_kernel": [p["device_ms_per_tick"]
                                     for p in run["profiled"]]},
         launches_per_tick={k: v for k, v in run["launches_per_tick"].items()
                            if v},
         rtt_ms_median=float(np.median([b[2] for b in bwe])) * 1e3,
         cumulative_lost_total=int(sum(r["stats"][1]["cumulative_lost"]
                                       for r in main)),
         bwe_estimate_bps=[min(b[0] for b in bwe), max(b[0] for b in bwe)],
         dtmf_events=sum(len(r["events"]) for r in main),
         tamper_and_replay=run["tamper"],
         ingest_tampered_and_replayed=run["ingest_extra"],
         cpu_twin_equal=True, cpu_twin_s=twin_s, cpu_twin_workers=workers)


# ---------------------------- the io_uring engine, TCP and the pumps

def _echo_rows(batch, ok):
    """The echo bridges' sink: every authenticated row back to its
    sender."""
    from libjitsi_tpu_torch.core.packet import PacketBatch

    rows = np.nonzero(ok)[0]
    return PacketBatch(batch.data[rows], batch.length[rows],
                       batch.stream[rows])


def engine_echo_setup(torch, dev, keys) -> dict:
    """The engine paths' traffic and reference: ENGINE_TICKS ticks of one
    production-mix packet from each of BATCH fixed streams of the echo
    cell (protected by the client's table, kernel C), then the same
    traffic echoed through the recvmmsg engine, its replies
    authenticated by the client.  All of it before the counts are
    reset: the paths' replies are held against these."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    rng = np.random.default_rng(23)
    sids = np.arange(N_STREAMS)
    streams = rng.permutation(N_STREAMS)[:BATCH]
    setup = dict(up_k=keys["mks"], up_s=keys["mss"], streams=streams,
                 dn_k=rng.integers(0, 256, (N_STREAMS, 16), np.uint8),
                 dn_s=rng.integers(0, 256, (N_STREAMS, 14), np.uint8))
    c_tx = SrtpStreamTable(N_STREAMS, device=dev)
    c_tx.add_streams(sids, setup["up_k"], setup["up_s"])
    setup["ticks"] = []
    for t in range(ENGINE_TICKS):
        lens = production_lengths(rng, BATCH)
        payloads = [rng.integers(0, 256, int(k), np.uint8).tobytes()
                    for k in lens]
        plain = rtp_header.build(
            payloads, [40 + t] * BATCH, [t * 960] * BATCH,
            (0x20000 + streams).tolist(), [96] * BATCH,
            stream=streams.tolist())
        setup["ticks"].append((plain, c_tx.protect_rtp(plain)))
    ref = _echo_udp(torch, dev, setup, "recvmmsg")
    c_rx = SrtpStreamTable(N_STREAMS, device=dev)
    c_rx.add_streams(sids, setup["dn_k"], setup["dn_s"])
    for (plain, _), back in zip(setup["ticks"], ref["replies"]):
        echo = PacketBatch.from_payloads(back, capacity=1536)
        echo.stream[:] = (rtp_header.parse(echo).ssrc
                          - 0x20000).astype(np.int32)
        dec, ok = c_rx.unprotect_rtp(echo)
        require(ok.all() and sorted(dec.to_payloads())
                == sorted(plain.to_payloads()),
                "engine echo: the recvmmsg reference's replies are not "
                "the sent packets under the client's keys")
    setup["ref"] = ref
    return setup


def _echo_bridge(dev, setup, engine, name: str):
    """An echo bridge over `engine` on the echo cell's tables: 10,240
    streams, AES-CM, every stream's keys and SSRC installed."""
    from libjitsi_tpu_torch.io.loop import MediaLoop
    from libjitsi_tpu_torch.service.media_stream import StreamRegistry
    from libjitsi_tpu_torch.transform.engine import TransformEngineChain
    from libjitsi_tpu_torch.transform.srtp.engine import SrtpTransformEngine
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    sids = np.arange(N_STREAMS)
    reg = StreamRegistry(N_STREAMS, device=dev)
    b_tx, b_rx = reg.srtp_tables(SrtpProfile.AES_CM_128_HMAC_SHA1_80)
    b_rx.add_streams(sids, setup["up_k"], setup["up_s"])
    b_tx.add_streams(sids, setup["dn_k"], setup["dn_s"])
    for sid in sids:
        reg.map_ssrc(0x20000 + int(sid), int(sid))
    chain = TransformEngineChain([SrtpTransformEngine(b_tx, b_rx)])
    return _keep(name, MediaLoop(engine, reg, on_media=_echo_rows,
                                 chain=chain, pipeline_depth=1,
                                 phase_sample_every=0))


def _tick_until(bridge, want: int, tick_s: list, what: str) -> None:
    """Tick the bridge until it took `want` packets; each tick that took
    some goes into `tick_s` as (packets, seconds)."""
    got = 0
    for _ in range(400):
        t0 = time.perf_counter()
        n = bridge.tick()
        dt = time.perf_counter() - t0
        if n:
            tick_s.append((n, dt))
        got += n
        if got >= want:
            break
    require(got == want, f"{what}: the bridge took {got} of {want} packets")


def _tick_ms(tick_s: list) -> dict:
    dts = np.array([dt for _n, dt in tick_s]) * 1e3
    return dict(busy_ticks=len(dts), tick_ms_p50=float(np.median(dts)),
                tick_ms_p99=float(np.percentile(dts, 99)),
                packets_per_busy_tick=float(np.mean([n for n, _ in tick_s])))


def _echo_udp(torch, dev, setup, mode: str) -> dict:
    """The engine paths' traffic through an echo bridge on a UDP engine
    in `mode`, sent in ECHO_BURST-packet bursts from one client socket,
    each burst ticked until the bridge took it; every tick's replies
    (sorted) and the engine's telemetry."""
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.kernels import build as kbuild

    replies, tick_s = [], []
    pre = dict(kbuild.launches)
    with UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=ECHO_BURST,
                   engine_mode=mode) as b_eng, \
            UdpEngine(port=0, bind_ip="127.0.0.1",
                      max_batch=ECHO_BURST) as client:
        bridge = _echo_bridge(dev, setup, b_eng, f"srtp_echo {mode}")
        for t, (_plain, wire) in enumerate(setup["ticks"]):
            back = []
            for lo in range(0, BATCH, ECHO_BURST):
                rows = np.arange(lo, min(lo + ECHO_BURST, BATCH))
                require(client.send_rows(wire, rows, "127.0.0.1",
                                         b_eng.port) == len(rows),
                        "engine echo: a client send was short")
                _tick_until(bridge, len(rows), tick_s, f"{mode} tick {t}")
                for _ in range(64):
                    b, _, _ = client.recv_batch(timeout_ms=0)
                    back += b.to_payloads()
                    if not b.batch_size:
                        break
            for _ in range(400):
                if len(back) >= BATCH:
                    break
                b, _, _ = client.recv_batch(timeout_ms=5)
                back += b.to_payloads()
            require(len(back) == BATCH, f"{mode} tick {t}: echoed "
                    f"{len(back)} of {BATCH} packets")
            replies.append(sorted(back))
        telemetry = dict(engine_mode=b_eng.engine_mode,
                         syscall_enters=b_eng.syscall_enters,
                         ring_reaps=b_eng.ring_reaps,
                         arena_grows=b_eng.arena_grows,
                         loop_engine_io_uring=bridge.metrics.sample_total(
                             "loop_engine_io_uring"))
    return dict(replies=replies, tick_s=tick_s, **telemetry,
                launches_per_tick={k: (kbuild.launches[k] - pre[k])
                                   / ENGINE_TICKS for k in pre})


def _uring_errno() -> str:
    """Why this host gives no ring: io_uring_setup's errno, or the build's
    stubs (no <linux/io_uring.h> where the engine was built)."""
    import ctypes
    import errno

    from libjitsi_tpu_torch.io.udp import _load, _uring_env_disabled

    if _uring_env_disabled():
        return "disabled by LIBJITSI_TPU_NO_IOURING / ENGINE_MODE"
    libc = ctypes.CDLL(None, use_errno=True)
    params = ctypes.create_string_buffer(120)   # struct io_uring_params
    fd = libc.syscall(425, 4, params)           # __NR_io_uring_setup
    if fd >= 0:
        os.close(fd)
        if not _load().udp_uring_supported():
            return "ENOSYS (engine built without <linux/io_uring.h>)"
        return "none"
    e = ctypes.get_errno()
    return f"{errno.errorcode.get(e, e)} ({os.strerror(e)})"


def srtp_echo_uring_run(torch, dev, setup) -> dict:
    """The echo cell's traffic through an echo bridge on
    `UdpEngine(engine_mode="io_uring")`.  Where the host refuses the ring
    the line says why, and the explicit request must fall back to
    recvmmsg with the `io_uring_unavailable_fallback` warning; the echo
    then runs on that engine."""
    import logging

    from libjitsi_tpu_torch.io.udp import UdpEngine, uring_available

    out = dict(uring_available=uring_available(), uring_errno=None,
               fallback_warned=None)
    if not out["uring_available"]:
        out["uring_errno"] = _uring_errno()
        print(f"io_uring unavailable on this host: {out['uring_errno']}",
              flush=True)
        seen = []

        class _Seen(logging.Handler):
            def emit(self, record):
                seen.append(record.getMessage())

        log = logging.getLogger("libjitsi_tpu_torch.io.udp")
        handler = _Seen(logging.WARNING)
        log.addHandler(handler)
        try:
            with UdpEngine(port=0, engine_mode="io_uring") as eng:
                mode = eng.engine_mode
        finally:
            log.removeHandler(handler)
        out["fallback_warned"] = any("io_uring_unavailable_fallback" in m
                                     for m in seen)
        require(mode == "recvmmsg" and out["fallback_warned"],
                f"srtp_echo_uring: an explicit io_uring request without a "
                f"ring ran {mode}, warned {seen}")
    out.update(_echo_udp(torch, dev, setup, "io_uring"))
    return out


def srtp_echo_uring_check(torch, dev, run, setup, smi) -> None:
    """The ring's replies byte-equal to the recvmmsg reference's; where the
    probe passed, the engine took the ring and reaped ring-side."""
    if run["uring_available"]:
        require(run["engine_mode"] == "io_uring" and run["ring_reaps"] > 0
                and run["loop_engine_io_uring"] == 1.0,
                f"srtp_echo_uring: the probe passed but the engine ran "
                f"{run['engine_mode']} with {run['ring_reaps']} reaps")
    require(run["replies"] == setup["ref"]["replies"],
            "srtp_echo_uring: the replies differ from the recvmmsg "
            "engine's for the same traffic")
    ref = setup["ref"]
    emit("srtp_echo_uring", nvidia_smi=smi, streams=N_STREAMS,
         ticks=ENGINE_TICKS, batch=BATCH, burst=ECHO_BURST,
         uring_available=run["uring_available"],
         uring_errno=run["uring_errno"],
         fallback_warned=run["fallback_warned"],
         engine_mode=run["engine_mode"],
         syscall_enters=run["syscall_enters"], ring_reaps=run["ring_reaps"],
         arena_grows=run["arena_grows"], **_tick_ms(run["tick_s"]),
         launches_per_tick={k: v for k, v in
                            run["launches_per_tick"].items() if v},
         recvmmsg=dict(syscall_enters=ref["syscall_enters"],
                       ring_reaps=ref["ring_reaps"],
                       **_tick_ms(ref["tick_s"])),
         replies_equal_to_recvmmsg=True)


def srtp_echo_tcp_run(torch, dev, setup) -> dict:
    """The same traffic from TCP_PEERS RFC 4571 clients over loopback,
    each carrying BATCH / TCP_PEERS streams' packets, to an echo bridge
    on `TcpMediaEngine`; every tick's replies (sorted), gathered from
    every client."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.io.tcp import TcpConnector, TcpMediaEngine
    from libjitsi_tpu_torch.kernels import build as kbuild

    per = BATCH // TCP_PEERS
    srv = TcpConnector(listen=True, max_batch=BATCH, mtu=1536)
    engine = TcpMediaEngine(srv)
    bridge = _echo_bridge(dev, setup, engine, "srtp_echo tcp")
    clients = [TcpConnector(max_batch=BATCH, mtu=1536)
               for _ in range(TCP_PEERS)]
    replies, tick_s = [], []
    pre = dict(kbuild.launches)
    try:
        dsts = [c.connect("127.0.0.1", srv.port) for c in clients]
        for t, (_plain, wire) in enumerate(setup["ticks"]):
            for p, (c, dst) in enumerate(zip(clients, dsts)):
                rows = np.arange(p * per, (p + 1) * per)
                c.send_batch(PacketBatch(wire.data[rows], wire.length[rows],
                                         wire.stream[rows]), dst)
            _tick_until(bridge, BATCH, tick_s, f"tcp tick {t}")
            back = []
            for _ in range(200):
                for c in clients:
                    b, _ = c.recv_batch(timeout_ms=0)
                    back += b.to_payloads()
                if len(back) >= BATCH:
                    break
                time.sleep(0.002)
            require(len(back) == BATCH, f"tcp tick {t}: echoed {len(back)} "
                    f"of {BATCH} packets")
            replies.append(sorted(back))
    finally:
        for c in clients:
            c.close()
        engine.close()
    return dict(replies=replies, tick_s=tick_s,
                send_failures=engine.send_failures,
                dropped_oversize=srv.dropped_oversize,
                launches_per_tick={k: (kbuild.launches[k] - pre[k])
                                   / ENGINE_TICKS for k in pre})


def srtp_echo_tcp_check(torch, dev, run, setup, smi) -> None:
    require(run["send_failures"] == 0 and run["dropped_oversize"] == 0,
            f"srtp_echo_tcp: {run['send_failures']} send failures, "
            f"{run['dropped_oversize']} oversize drops")
    require(run["replies"] == setup["ref"]["replies"],
            "srtp_echo_tcp: the replies differ from the UDP echo of the "
            "same traffic")
    emit("srtp_echo_tcp", nvidia_smi=smi, streams=N_STREAMS,
         ticks=ENGINE_TICKS, batch=BATCH, peers=TCP_PEERS,
         streams_per_peer=BATCH // TCP_PEERS, **_tick_ms(run["tick_s"]),
         send_failures=run["send_failures"],
         launches_per_tick={k: v for k, v in
                            run["launches_per_tick"].items() if v},
         replies_equal_to_udp=True)


def _pump_pair(svc, k: int):
    """Pair k: two audio streams on the service's registry, keyed by SDES
    offer and answer from the pair's own seeded generator, which draws
    their seq and ts too."""
    from libjitsi_tpu_torch.control.sdes import SdesControl
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    prof = SrtpProfile.AES_CM_128_HMAC_SHA1_80
    rng = np.random.default_rng([0x30000000, k])
    a = svc.create_media_stream("audio", local_ssrc=0x30000000 + 2 * k)
    b = svc.create_media_stream("audio", local_ssrc=0x30000001 + 2 * k)
    for s in (a, b):
        s.sdes = SdesControl(profiles=[prof], rng=rng.bytes)
        s._tx_seq = int(rng.integers(0, 1 << 16))
        s._tx_ts = int(rng.integers(0, 1 << 32))
    a.sdes.accept_answer(b.sdes.create_answer(a.sdes.create_offer()))
    a.set_remote_ssrc(b.local_ssrc)
    b.set_remote_ssrc(a.local_ssrc)
    a.start()
    b.start()
    return a, b


def _pumps_build(svc, pairs, dev) -> dict:
    """Pairs `pairs` of the conference through pumps: pair k's near end
    sends a PCMU tone (300 + 7k Hz) through a `SendPump`, its far end's
    `ReceivePump` deposits into row k of `svc.audio_mixer_device(160)`,
    and row k's mix-minus is captured."""
    from libjitsi_tpu_torch.device import ToneSource
    from libjitsi_tpu_torch.service.pump import (ReceivePump, SendPump,
                                                 g711_codec)

    mixdev = svc.audio_mixer_device(frame_samples=160)
    pumps = {}
    for k in pairs:
        a, b = _pump_pair(svc, k)
        tx = SendPump(a, ToneSource(300.0 + 7 * k, amplitude=0.02,
                                    sample_rate=8000),
                      g711_codec(device=dev))
        rx = ReceivePump(b, g711_codec(device=dev), mixer=mixdev,
                         mixer_sid=k)
        mixdev.add_participant(k)
        pumps[k] = (tx, rx)
    return dict(svc=svc, mixdev=mixdev, pumps=pumps,
                caps={k: mixdev.capture_for(k) for k in pairs})


def _pumps_drive(setup, timed: bool) -> dict:
    """PUMP_TICKS 20 ms ticks on an injected clock: every pair's send
    pump ticks, its datagram goes to the far end's receive pump (tick
    PUMP_LOST's of the first pairs lost), the receive pump ticks, then
    the mixer device; then each row's captured mix-minus.  `timed`: the
    calls' host times."""
    pumps, mixdev = setup["pumps"], setup["mixdev"]
    wire = {k: [] for k in pumps}
    decoded = {k: [] for k in pumps}
    times = {"send": [], "receive": [], "tick": [], "mix": []}
    for t in range(PUMP_TICKS):
        now = PUMP_T0 + 0.02 * t
        for k, (tx, rx) in pumps.items():
            t0 = time.perf_counter()
            w = tx.tick()
            t1 = time.perf_counter()
            wire[k].append(w[0])
            if not (t == PUMP_LOST[0] and k < PUMP_LOST[1]):
                rx.push(w, now=now)
            t2 = time.perf_counter()
            decoded[k].append(rx.tick(now=now))
            t3 = time.perf_counter()
            times["send"].append(t1 - t0)
            times["receive"].append(t2 - t1)
            times["tick"].append(t3 - t2)
        t0 = time.perf_counter()
        mixdev.tick()
        times["mix"].append(time.perf_counter() - t0)
    out = dict(wire=wire, decoded=decoded,
               captured={k: setup["caps"][k].read(160 * PUMP_TICKS)
                         for k in pumps},
               counters={k: (rx.decoded_frames, rx.lost_frames,
                             rx.plc_frames, rx.decode_errors, rx.jb.lost,
                             rx.jb.late_dropped)
                         for k, (_tx, rx) in pumps.items()})
    if timed:
        out["times"] = times
    return out


def _pumps_twin() -> dict:
    """The CPU twin of pairs PUMP_TWIN: the same seeded graph on a
    `MediaService` with `device="cpu"`, one PyTorch thread, in a process
    of its own."""
    import torch

    from libjitsi_tpu_torch.core.config import ConfigurationService
    from libjitsi_tpu_torch.service.media_service import MediaService

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    svc = MediaService(ConfigurationService(), device="cpu")
    res = _pumps_drive(_pumps_build(svc, PUMP_TWIN, "cpu"), timed=False)
    return dict(wire=res["wire"], counters=res["counters"],
                decoded={k: [f.tobytes() for f in v]
                         for k, v in res["decoded"].items()},
                seconds=time.perf_counter() - t0)


def conference_pumps_setup(torch, dev) -> dict:
    """`init()` and `media_service()` on the card, every pair keyed and
    started and its pumps built; the CPU twin starts in a process of its
    own, to run beside the card's."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import libjitsi_tpu_torch

    libjitsi_tpu_torch.stop()
    libjitsi_tpu_torch.init()
    svc = libjitsi_tpu_torch.media_service()
    require(svc.device == dev, f"media_service() built on {svc.device}")
    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    twin = pool.submit(_pumps_twin)
    t0 = time.perf_counter()
    setup = _pumps_build(svc, range(PUMP_PAIRS), dev)
    setup.update(setup_s=time.perf_counter() - t0, pool=pool, twin=twin)
    return setup


def conference_pumps_run(torch, dev, setup) -> dict:
    from libjitsi_tpu_torch.kernels import build as kbuild

    pre = dict(kbuild.launches)
    res = _pumps_drive(setup, timed=True)
    res["launches_per_tick"] = {k: (kbuild.launches[k] - pre[k]) / PUMP_TICKS
                                for k in pre}
    return res


def conference_pumps_check(torch, dev, run, setup, smi) -> None:
    """Every captured frame is the exact clip of the other pairs' decoded
    frames (summed in int64 on the host); the lost pairs concealed their
    gap; the PUMP_TWIN pairs' wire and decoded frames equal the CPU
    twin's."""
    dec = {k: np.stack(v).astype(np.int64) for k, v in run["decoded"].items()}
    total = sum(dec.values())
    for k, frames in dec.items():
        want = np.clip(total - frames, -32768, 32767).reshape(-1)
        require(np.array_equal(run["captured"][k].astype(np.int64), want),
                f"conference_pumps: pair {k}'s capture is not the exact "
                "mix-minus of the others' decoded frames")
    lost = [run["counters"][k] for k in range(PUMP_LOST[1])]
    require(all(c[1] >= 1 and c[4] == 1 for c in lost)
            and all(run["counters"][k][1] == 0 and run["counters"][k][4] == 0
                    for k in range(PUMP_LOST[1], PUMP_PAIRS)),
            f"conference_pumps: the loss path ran otherwise: {lost[:2]}")
    t0 = time.perf_counter()
    try:
        twin = setup["twin"].result(timeout=600)
    finally:
        setup["pool"].shutdown()
    wait_s = time.perf_counter() - t0
    for k in PUMP_TWIN:
        require(twin["wire"][k] == run["wire"][k]
                and twin["decoded"][k] == [f.tobytes()
                                           for f in run["decoded"][k]]
                and twin["counters"][k] == run["counters"][k],
                f"conference_pumps: pair {k} on the card differs from the "
                "CPU run")
    times = {k: np.array(v) * 1e3 for k, v in run["times"].items()}
    emit("conference_pumps", nvidia_smi=smi, pairs=PUMP_PAIRS,
         ticks=PUMP_TICKS, registry_rows=setup["svc"].registry.capacity,
         setup_s=setup["setup_s"],
         **{f"{k}_ms_p50": float(np.median(v)) for k, v in times.items()},
         **{f"{k}_ms_p99": float(np.percentile(v, 99))
            for k, v in times.items()},
         tick_wall_ms=float(sum(v.sum() for v in times.values())
                            / PUMP_TICKS),
         launches_per_tick={k: v for k, v in run["launches_per_tick"].items()
                            if v},
         lost_pairs=PUMP_LOST[1],
         lost_frames=int(sum(c[1] for c in run["counters"].values())),
         jb_lost=int(sum(c[4] for c in run["counters"].values())),
         mix_minus_exact=True, cpu_twin_pairs=len(PUMP_TWIN),
         cpu_twin_equal=True, cpu_twin_s=twin["seconds"],
         cpu_twin_wait_s=wait_s)


# ------------------------------------------- DTLS-SRTP and ZRTP keying

class _Socks:
    """One non-blocking loopback UDP socket per remote endpoint (a DTLS
    association is bound to its peer's 5-tuple)."""

    def __init__(self, n: int):
        import socket

        self.socks = []
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind(("127.0.0.1", 0))
            s.setblocking(False)
            self.socks.append(s)
        self.port = [s.getsockname()[1] for s in self.socks]
        self.k_of_port = {p: k for k, p in enumerate(self.port)}

    def addr(self, k: int) -> tuple:
        return (LOOPBACK_U32, self.port[k])

    def send(self, k: int, datagrams, port: int) -> None:
        for d in datagrams:
            self.socks[k].sendto(d, ("127.0.0.1", port))

    def recv(self, k: int) -> list:
        out = []
        while True:
            try:
                out.append(self.socks[k].recv(2048))
            except BlockingIOError:
                return out

    def close(self) -> None:
        for s in self.socks:
            s.close()


def _dtls_kind():
    """The DTLS endpoint the keying phases run: OpenSSL's where the
    `cryptography` package is installed, else the JAX package's own seam
    for that case, the dependency-free `StubDtlsEndpoint`."""
    from libjitsi_tpu_torch.control import dtls

    if dtls.HAVE_CRYPTOGRAPHY:
        return dtls.DtlsSrtpEndpoint, "OpenSSL DtlsSrtpEndpoint"
    return dtls.StubDtlsEndpoint, "StubDtlsEndpoint"


def _dtls_storm(bridge, kind, n: int, join, socks, now: float,
                early=(), profile=None) -> dict:
    """Join endpoints 0..n-1 by DTLS over loopback, DTLS_WAVE handshakes
    in flight at once: `join(k, fingerprint, addr, role)` calls the
    bridge's entry point; endpoint k's peer (a `kind` endpoint) talks from
    socket k, and the bridge is ticked at `now` between the flights.  The
    bridge is the DTLS server, but for the endpoints in `early`, where it
    is the client: their peer completes first, and its Finished flight is
    held back (returned, not sent).  Returns the peers, the rows, each
    join's seconds to its installed keys, the held flights and the
    storm's seconds."""
    from libjitsi_tpu_torch.core.packet import PacketBatch

    table = bridge._dtls
    install = table.install
    installed_at = {}

    def timed(sid, ep):
        install(sid, ep)
        installed_at[sid] = time.perf_counter()

    table.install = timed
    kw = {} if profile is None else {"profiles": [profile]}
    peers, sids, joined_at, held = {}, {}, {}, {}
    early = set(early)
    t0 = time.perf_counter()
    for lo in range(0, n, DTLS_WAVE):
        out = {}
        for k in range(lo, min(lo + DTLS_WAVE, n)):
            role = "client" if k in early else "server"
            peer = kind("server" if k in early else "client", **kw)
            joined_at[k] = time.perf_counter()
            sid, ep = join(k, peer.local_fingerprint, socks.addr(k), role)
            peer.remote_fingerprint = ep.local_fingerprint
            peers[k], sids[k] = peer, sid
            if k in early:          # the bridge's ClientHello, its socket
                bridge.loop.engine.send_batch(
                    PacketBatch.from_payloads(ep.handshake_packets()),
                    "127.0.0.1", socks.port[k])
                out[k] = []
            else:
                out[k] = peer.handshake_packets()
        wave = set(out)
        deadline = time.perf_counter() + 60.0
        while wave:
            require(time.perf_counter() < deadline,
                    f"dtls storm: {len(wave)} handshakes of wave {lo} "
                    "did not complete in 60 s")
            for k in wave:
                socks.send(k, out[k], bridge.port)
                out[k] = []
            for _ in range(2):
                bridge.tick(now=now)
            for k in list(wave):
                for d in socks.recv(k):
                    out[k] += peers[k].feed(d)
                if k in early and peers[k].complete:
                    held[k] = out.pop(k)
                    wave.discard(k)
                elif peers[k].complete and sids[k] not in table.pending:
                    wave.discard(k)
    storm_s = time.perf_counter() - t0
    table.install = install
    join_s = np.array([installed_at[sids[k]] - joined_at[k]
                       for k in range(n) if k not in early])
    return dict(peers=peers, sids=sids, held=held, storm_s=storm_s,
                join_s=join_s)


def _exported(peers, n: int) -> dict:
    """The keys each peer exported, as the bridge takes them: "rx" what it
    receives (the peer's tx), "tx" what it sends (the peer's rx)."""
    keys = [peers[k].srtp_keys() for k in range(n)]

    def stack(i):
        return np.stack([np.frombuffer(kk[i], np.uint8) for kk in keys])

    return {"rx": (stack(1), stack(2)), "tx": (stack(3), stack(4))}


def _refused_join(bridge, kind, join, socks, k: int, now: float) -> int:
    """One join whose peer presents a certificate the signaling did not
    pin: the bridge must refuse it and forget the row.  Returns the row."""
    peer = kind("client")
    sid, ep = join(k, "AB:" * 31 + "CD", socks.addr(k), "server")
    peer.remote_fingerprint = ep.local_fingerprint
    out = peer.handshake_packets()
    for _ in range(50):
        socks.send(k, out, bridge.port)
        bridge.tick(now=now)
        out = [r for d in socks.recv(k) for r in peer.feed(d)]
        if bridge._dtls.rejected:
            break
    require(bridge._dtls.rejected == 1 and sid not in bridge._dtls.pending
            and socks.addr(k) not in bridge._dtls.addr_of,
            "dtls: a mismatched fingerprint was not refused and forgotten")
    return sid


def _early_wire(dev, keys, ssrc, seq0, rows, profile: str) -> dict:
    """Two packets a row of `rows`, seqs seq0 - 2 and seq0 - 1 (before the
    traffic's first), protected under the row's exported keys."""
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    rows = list(rows)
    up = SrtpStreamTable(len(rows), SrtpProfile[profile], device=dev)
    up.add_streams(np.arange(len(rows)), keys["rx"][0][rows],
                   keys["rx"][1][rows])
    pl = [b"early %d %d" % (k, j) for k in rows for j in range(2)]
    b = rtp_header.build(pl, [(int(seq0[k]) - 2 + j) & 0xFFFF
                              for k in rows for j in range(2)],
                         [0] * len(pl), [int(ssrc[k]) for k in rows
                                         for j in range(2)], 111,
                         stream=[i for i in range(len(rows))
                                 for _ in range(2)])
    wire = up.protect_rtp(b).to_payloads()
    return {k: wire[2 * i:2 * i + 2] for i, k in enumerate(rows)}


def _gcm_conf_setup(dev, keys, ssrc, ticks: int) -> dict:
    """The GCM conference's traffic: each of SFU_SIZE endpoints sends one
    Opus-sized packet (abs-send-time extension) a tick, and one RR at
    tick 1, protected under its exported AEAD_AES_128_GCM keys."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.rtp import rtcp
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    n = SFU_SIZE
    rng = np.random.default_rng(41)
    up = SrtpStreamTable(n, SrtpProfile[GCM], device=dev)
    up.add_streams(np.arange(n), *keys["rx"])
    seq0 = rng.integers(0, 1 << 16, n)
    payloads, wires = [], []
    for t in range(ticks):
        pl = [rng.integers(0, 256, int(m), np.uint8).tobytes()
              for m in rng.integers(60, 161, n)]
        ast = int(round((1000.0 + 0.02 * t) * (1 << 18))) & 0xFFFFFF
        ext = (0xBEDE, bytes([0x32]) + ast.to_bytes(3, "big"))
        plain = rtp_header.build(pl, (seq0 + t) & 0xFFFF, t * 960,
                                 ssrc.tolist(), 111, ext=[ext] * n,
                                 stream=list(range(n)))
        payloads.append(pl)
        wires.append(up.protect_rtp(plain).to_payloads())
    blobs = [rtcp.build_compound([rtcp.build_rr(rtcp.ReceiverReport(
        int(ssrc[k]), [rtcp.ReportBlock(int(ssrc[(k + 1) % n]), 0, 0,
                                        int(seq0[(k + 1) % n]), 4, 0, 0)]))])
        for k in range(n)]
    rr = up.protect_rtcp(PacketBatch.from_payloads(
        blobs, stream=list(range(n)))).to_payloads()
    return dict(keys=keys, ssrc=ssrc, seq0=seq0, payloads=payloads,
                wires=wires, rr=rr)


def sfu_dtls_setup(torch, dev) -> dict:
    """The sfu cell's 1,100 endpoints (100 conferences x 11) joined to an
    `SfuBridge` on the card by `add_endpoint_dtls`, each handshaking over
    loopback from a socket of its own (`_dtls_storm`); in DTLS_EARLY
    conferences two endpoints with the bridge as DTLS client, their
    Finished flight held back; one more join refused on its fingerprint
    and removed; then the traffic built under the exported keys (kernels
    C and I, before the counts are reset): `_sfu_setup`'s ticks, the
    early endpoints' early media, and a conference of 11 joined to a
    second bridge under AEAD_AES_128_GCM (`use_srtp` offers GCM only)."""
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    kind, kind_name = _dtls_kind()
    n = SFU_N
    rng = np.random.default_rng(53)
    ssrc = (0x52000000 + rng.permutation(1 << 20)[:n]).astype(np.int64)
    conf = np.arange(n) // SFU_SIZE
    early = [c * SFU_SIZE + m for c in DTLS_EARLY_CONFS for m in (2, 7)]
    socks = _Socks(n + 1 + SFU_SIZE)
    bridge = _keep("sfu dtls", SfuBridge(capacity=n + 1, device=dev))
    bridge._dtls.endpoint_factory = kind

    def join(k, fp, addr, role):
        sid, ep = bridge.add_endpoint_dtls(int(ssrc[k]), role=role,
                                           remote_fingerprint=fp,
                                           remote_addr=addr)
        bridge.set_conference(sid, int(conf[k]))
        return sid, ep

    storm = _dtls_storm(bridge, kind, n, join, socks, 999.0, early)
    require(storm["sids"] == {k: k for k in range(n)},
            "sfu_dtls: rows not handed out in join order")
    rejected = _refused_join(bridge, kind,
                             lambda k, fp, addr, role: bridge.
                             add_endpoint_dtls(0x5F000000, role=role,
                                               remote_fingerprint=fp,
                                               remote_addr=addr),
                             socks, n, 999.0)
    bridge.remove_endpoint(rejected)
    require(not bridge._dtls.pending.keys() - set(early),
            "sfu_dtls: a row is pending that should not be")
    live = [s for s in bridge.translator._routes]
    require(not set(early) & set(live) and rejected not in live,
            "sfu_dtls: a pending or refused row is in the routes")
    require(not set(early) & set(bridge.snapshot()["ssrc_of"]),
            "sfu_dtls: a pending row is in the snapshot")
    # the early peers exported at their completion; the bridge has not
    keys = _exported(storm["peers"], n)
    traffic = _sfu_setup(torch, dev, ticks=SFU_DTLS_TICKS,
                         rr_ticks=(SFU_DTLS_RR,), nack_tick=SFU_DTLS_NACK,
                         keys=keys, ssrc=ssrc)
    early_wire = _early_wire(dev, keys, ssrc, traffic["seq0"], early,
                             "AES_CM_128_HMAC_SHA1_80")
    # the GCM conference, on a bridge of its own
    g_socks = _Socks(SFU_SIZE)
    g_bridge = _keep("sfu dtls gcm", SfuBridge(
        capacity=SFU_SIZE, profile=SrtpProfile[GCM], device=dev))
    g_bridge._dtls.endpoint_factory = kind
    g_ssrc = 0x53000000 + np.arange(SFU_SIZE, dtype=np.int64)
    g_storm = _dtls_storm(
        g_bridge, kind, SFU_SIZE,
        lambda k, fp, addr, role: g_bridge.add_endpoint_dtls(
            int(g_ssrc[k]), role=role, remote_fingerprint=fp,
            remote_addr=addr),
        g_socks, 999.0, profile=SrtpProfile[GCM])
    g_names = {g_storm["peers"][k].selected_profile.name
               for k in range(SFU_SIZE)}
    require(g_names == {GCM}, f"sfu_dtls: use_srtp selected {g_names}")
    gcm = _gcm_conf_setup(dev, _exported(g_storm["peers"], SFU_SIZE),
                          g_ssrc, SFU_DTLS_GCM_TICKS)
    emit("dtls_endpoint", path="sfu_dtls", endpoint=kind_name,
         key_agreement=("ECDHE-ECDSA P-256 (OpenSSL DTLS 1.2)"
                        if kind_name.startswith("OpenSSL")
                        else "stub hash of the hello randoms"))
    return dict(bridge=bridge, socks=socks, traffic=traffic, early=early,
                early_wire=early_wire, held=storm["held"], storm=storm,
                rejected=rejected, g_bridge=g_bridge, g_socks=g_socks,
                gcm=gcm, g_storm=g_storm, kind=kind_name)


def _sfu_dtls_tick(bridge, setup, t, socks, recv) -> tuple:
    """One tick of the sfu cell's traffic, each endpoint's datagrams from
    its own socket: the media in SFU_BURSTS bursts, then the tick's
    RTCP, each burst sent and the bridge ticked (now = 1000 + 0.02 t)
    until it has taken the burst in; then every socket drained into
    `recv[k]`.  Returns (bridge seconds, datagrams taken)."""
    now = 1000.0 + 0.02 * t
    wire = setup["wires"][t]
    sends = [[(int(k), wire.to_bytes(int(k))) for k in rows]
             for rows in setup["bursts"]]
    extra = setup["rtcp"].get(t)
    if extra is not None:
        sends.append([(int(extra.stream[i]), extra.to_bytes(i))
                      for i in range(extra.batch_size)])
    secs, taken = 0.0, 0
    for b, burst in enumerate(sends):
        for k, d in burst:
            socks.socks[k].sendto(d, ("127.0.0.1", bridge.port))
        got = 0
        for _ in range(200):
            t0 = time.perf_counter()
            got += bridge.tick(now=now)["rx"]
            secs += time.perf_counter() - t0
            if got >= len(burst):
                break
        require(got == len(burst), f"sfu_dtls tick {t} burst {b}: the "
                                   f"bridge took {got} of {len(burst)}")
        taken += got
    for k in range(len(recv)):
        recv[k] += socks.recv(k)
    return secs, taken


def sfu_dtls_run(torch, dev, setup) -> dict:
    """The DTLS-keyed SFU on the card, counted: the early media (held on
    the loop), the held Finished flights (the keys land, the held media
    replays through D and H), SFU_DTLS_TICKS ticks of the sfu cell's
    traffic from the endpoints' own sockets with an RR tick, a NACK tick
    and `emit_feedback` every SFU_DTLS_FEEDBACK ticks (D, H, I, J), and
    the GCM conference's ticks with one `emit_feedback` (N, H-GCM, M)."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    bridge, socks, traffic = setup["bridge"], setup["socks"], setup["traffic"]
    n, early = SFU_N, setup["early"]
    fanout = {"early": [], "ticks": []}
    log = fanout["early"]
    emit_fanout = bridge._emit_fanout

    def logged(wire, recv, origin=None):
        ready = np.nonzero(bridge.loop.addr_port[recv] != 0)[0]
        log.append((wire.data[ready], np.asarray(wire.length)[ready],
                    recv[ready]))
        return emit_fanout(wire, recv, origin=origin)

    bridge._emit_fanout = logged
    sends = _SendsTo(bridge, socks.k_of_port)
    release = bridge.loop.release_stream
    replayed = []

    def counted(sid):
        replayed.append(release(sid))
        return replayed[-1]

    bridge.loop.release_stream = counted
    res = dict(tick_s=[], taken=0, feedback_sent=0)
    # stale retransmissions of the bridge's client flights, unread
    for k in early:
        socks.recv(k)
    for k in early:
        socks.send(k, setup["early_wire"][k], bridge.port)
    got = 0
    for _ in range(200):
        got += bridge.tick(now=999.5)["rx"]
        if got >= 2 * len(early):
            break
    held = sum(len(bridge.loop._hold_q.get(s, ())) for s in early)
    require(held == 2 * len(early), f"sfu_dtls: {held} early packets held "
                                    f"of {2 * len(early)}")
    for k in early:
        socks.send(k, setup["held"][k], bridge.port)
    for _ in range(200):
        bridge.tick(now=999.6)
        if not bridge._dtls.pending:
            break
    require(not bridge._dtls.pending, "sfu_dtls: an early endpoint's keys "
                                      "never landed")
    res["replayed"] = sum(replayed)
    bridge.loop.release_stream = release
    res["early_recv"] = [socks.recv(k) for k in range(n)]
    recv = [[] for _ in range(n)]
    log = fanout["ticks"]
    for t in range(SFU_DTLS_TICKS):
        sends.on = t
        secs, taken = _sfu_dtls_tick(bridge, traffic, t, socks, recv)
        sends.on = None
        res["tick_s"].append(secs)
        res["taken"] += taken
        if t == SFU_DTLS_NACK:
            res["nack"] = dict(retransmitted=bridge.retransmitted,
                               served=bridge.recovery.rtx_requests_served,
                               cache_miss=bridge.recovery.rtx_cache_miss)
        if t % SFU_DTLS_FEEDBACK == SFU_DTLS_FEEDBACK - 1:
            sends.on = t
            res["feedback_sent"] += bridge.emit_feedback(
                now=1000.0 + 0.02 * t + 0.01)
            sends.on = None
    for k in range(n):
        recv[k] += socks.recv(k)
    bridge._emit_fanout = emit_fanout
    # the early endpoints' sockets also hold the bridge's last DTLS flight
    # retransmissions (its client flights, answered late on purpose)
    res["stale_dtls"] = 0
    for got in res["early_recv"] + recv:
        dtls = [d for d in got if 20 <= d[0] <= 63]
        res["stale_dtls"] += len(dtls)
        got[:] = [d for d in got if not 20 <= d[0] <= 63]
    # the GCM conference
    g, g_socks, gcm = setup["g_bridge"], setup["g_socks"], setup["gcm"]
    g_recv = [[] for _ in range(SFU_SIZE)]
    g_fb = 0
    for t in range(SFU_DTLS_GCM_TICKS):
        for k in range(SFU_SIZE):
            g_socks.send(k, [gcm["wires"][t][k]]
                         + ([gcm["rr"][k]] if t == 1 else []), g.port)
        want = SFU_SIZE * (2 if t == 1 else 1)
        got = 0
        for _ in range(200):
            got += g.tick(now=1000.0 + 0.02 * t)["rx"]
            if got >= want:
                break
        require(got == want, f"sfu_dtls gcm tick {t}: {got} of {want}")
        if t == 2:
            g_fb = g.emit_feedback(now=1000.05)
        for k in range(SFU_SIZE):
            g_recv[k] += g_socks.recv(k)
    res["launches"] = dict(kbuild.launches)
    res["launches_per_tick"] = {k: v / SFU_DTLS_TICKS
                                for k, v in res["launches"].items()}
    res.update(recv=recv, fanout=fanout, sends=sends.ticks, g_recv=g_recv,
               g_feedback=g_fb)
    return res


class _SendsTo:
    """Every datagram a bridge's engine sends while `on` is set, with the
    endpoint it went to (by the socket's port)."""

    def __init__(self, bridge, k_of_port):
        self.on, self.ticks = None, {}
        eng = bridge.loop.engine
        orig = eng.send_batch

        def send_batch(batch, ip, port):
            if self.on is not None:
                ports = np.broadcast_to(np.asarray(port), (batch.batch_size,))
                self.ticks.setdefault(self.on, []).extend(
                    (batch.to_bytes(i), k_of_port.get(int(ports[i]), -1))
                    for i in range(batch.batch_size))
            return orig(batch, ip, port)

        eng.send_batch = send_batch


def _sfu_dtls_twin(torch, setup, run) -> list:
    """The first SFU_DTLS_TWIN_CONFS conferences' endpoints on an
    `SfuBridge(device="cpu")` keyed with the same exported keys by
    `stage_endpoints`, fed the same datagrams at the same clock: each
    tick its sends must equal the card bridge's sends to those
    endpoints.  Returns the ticks compared."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge

    traffic = setup["traffic"]
    m = SFU_DTLS_TWIN_CONFS * SFU_SIZE
    (rk, rs), (tk, ts) = traffic["keys"]["rx"], traffic["keys"]["tx"]
    twin = SfuBridge(capacity=m, device="cpu")
    sids = twin.stage_endpoints(
        [(int(traffic["ssrc"][k]), (rk[k].tobytes(), rs[k].tobytes()),
          (tk[k].tobytes(), ts[k].tobytes()), None) for k in range(m)],
        conferences=traffic["conf"][:m].tolist())
    twin.commit_endpoints(sids)
    kept = _Sends(twin)
    compared = []
    thread_n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=4 * m,
                       rcvbuf=8 << 20) as sink:
            twin.loop.addr_ip[:m] = LOOPBACK_U32
            twin.loop.addr_port[:m] = sink.port
            for t in range(SFU_DTLS_TICKS):
                now = 1000.0 + 0.02 * t
                parts = [(traffic["wires"][t], np.arange(m))]
                extra = traffic["rtcp"].get(t)
                if extra is not None:
                    parts.append((extra, np.nonzero(
                        np.asarray(extra.stream) < m)[0]))
                kept.on = t
                want = 0
                for wire, rows in parts:
                    sink.send_batch(PacketBatch(
                        wire.data[rows], np.asarray(wire.length)[rows],
                        wire.stream[rows]), "127.0.0.1", twin.port)
                    want += len(rows)
                got = 0
                for _ in range(200):
                    got += twin.tick(now=now)["rx"]
                    if got >= want:
                        break
                require(got == want, f"sfu_dtls twin tick {t}: {got} of "
                                     f"{want}")
                if t % SFU_DTLS_FEEDBACK == SFU_DTLS_FEEDBACK - 1:
                    twin.emit_feedback(now=now + 0.01)
                kept.on = None
                card = [d for d, k in run["sends"].get(t, []) if 0 <= k < m]
                require(sorted(kept.ticks.get(t, [])) == sorted(card),
                        f"sfu_dtls tick {t}: the card bridge's sends to "
                        "the twin's conferences differ from the CPU twin's")
                compared.append(t)
                while sink.recv_batch(timeout_ms=0)[0].batch_size:
                    pass
    finally:
        torch.set_num_threads(thread_n)
        twin.close()
    return compared


def sfu_dtls_check(torch, dev, run, setup, sfu_tick_ms) -> None:
    """Gates of the DTLS-keyed SFU: every early packet held and replayed,
    its copies at its mates' sockets; no echo and no copy across
    conferences; each socket got its own leg's copies only, every one
    authenticated under the keys its endpoint exported and equal to what
    its sender sent; `forwarded` equal to the accepted packets times ten;
    every NACKed seq served; the CPU twin's sends equal to the card's for
    its conferences; the GCM conference's copies opened by each leg's
    exported keys as their senders' bytes.  Prints the `sfu_dtls` line
    beside the SDES `sfu` path's tick times."""
    bridge, traffic = setup["bridge"], setup["traffic"]
    early, n = setup["early"], SFU_N
    require(int(bridge.rx_table.auth_fail.sum()) == 0
            and int(bridge.rx_table.replay_reject.sum()) == 0,
            "sfu_dtls: the bridge rejected genuine uplink packets")
    require(run["replayed"] == 2 * len(early),
            f"sfu_dtls: {run['replayed']} held packets replayed")
    # the early copies: at each mate's socket, opened under its keys
    leg_e, echo, cross, copies_e = _fanout_log(traffic,
                                               run["fanout"]["early"])
    # a conference's two early endpoints land one after the other: the
    # first one's replay reaches 9 mates, the second's all 10
    want_e = len(early) * (2 * (SFU_SIZE - 1) - 1)
    require(copies_e == want_e and echo == 0 and cross == 0,
            f"sfu_dtls: {copies_e} early copies of {want_e}, {echo} "
            f"echoes, {cross} across conferences")
    early_got = 0
    for k, got in enumerate(run["early_recv"]):
        for p in got:
            require(leg_e.get(p[2:4] + p[8:12] + p[-TAG:]) == k,
                    f"sfu_dtls: socket {k} got another leg's early copy")
        early_got += len(got)
    require(early_got == copies_e, f"sfu_dtls: {early_got} early copies "
                                   f"arrived of {copies_e}")
    _check_early(dev, traffic, run["early_recv"], setup["early_wire"])
    # the ticks
    leg_of, echo, cross, copies = _fanout_log(traffic, run["fanout"]["ticks"])
    require(echo == 0 and cross == 0, f"sfu_dtls: {echo} self-echo and "
                                      f"{cross} cross-conference copies")
    rtcp_n = sum(w.batch_size for w in traffic["rtcp"].values())
    require(run["taken"] == SFU_DTLS_TICKS * n + rtcp_n,
            "sfu_dtls: the bridge did not take every datagram sent")
    expected = SFU_DTLS_TICKS * n * (SFU_SIZE - 1) + copies_e
    require(bridge.forwarded == copies + copies_e == expected,
            f"sfu_dtls: forwarded {bridge.forwarded}, logged "
            f"{copies + copies_e}, expected {expected}")
    every = []
    for k, got in enumerate(run["recv"]):
        for p in got:
            require(192 <= p[1] <= 223
                    or leg_of.get(p[2:4] + p[8:12] + p[-TAG:]) == k,
                    f"sfu_dtls: socket {k} got a copy of another leg")
        every += got
    counts = _check_copies(torch, dev, traffic, every, leg_of,
                           SFU_DTLS_TICKS)
    nack = run["nack"]
    n_nacked = 3 * len(traffic["nacked"])
    require(nack["retransmitted"] == nack["served"] == n_nacked
            and nack["cache_miss"] == 0, f"sfu_dtls NACK service: {nack}")
    require(counts["copies_unique"] == copies
            and counts["copies_received"] == copies + n_nacked
            and counts["feedback_received"] == run["feedback_sent"],
            f"sfu_dtls: {counts} against {copies} copies, {n_nacked} "
            f"retransmissions and {run['feedback_sent']} feedback")
    t0 = time.perf_counter()
    twin_ticks = _sfu_dtls_twin(torch, setup, run)
    twin_s = time.perf_counter() - t0
    g_counts = _check_gcm_conf(dev, setup, run)
    storm = setup["storm"]
    secs = np.array(run["tick_s"])
    bridge.close()
    setup["g_bridge"].close()
    setup["socks"].close()
    setup["g_socks"].close()
    emit("sfu_dtls", endpoint=setup["kind"], conferences=SFU_CONFS,
         endpoints=n, ticks=SFU_DTLS_TICKS,
         storm_s=storm["storm_s"], joins_per_s=n / storm["storm_s"],
         handshakes_in_flight=DTLS_WAVE,
         join_to_keys_ms_p50=float(np.median(storm["join_s"])) * 1e3,
         join_to_keys_ms_p99=float(np.percentile(storm["join_s"], 99))
         * 1e3,
         retransmits_total=bridge._dtls.retransmits_total,
         handshakes_completed=bridge._dtls.handshakes_completed,
         rejected=bridge._dtls.rejected, early_endpoints=len(early),
         early_held=2 * len(early), early_replayed=run["replayed"],
         early_copies=copies_e, stale_dtls_datagrams=run["stale_dtls"],
         tick_ms_p50=float(np.median(secs)) * 1e3,
         tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
         sdes_sfu_tick_ms_p50=sfu_tick_ms[0],
         sdes_sfu_tick_ms_p99=sfu_tick_ms[1],
         forwarded=bridge.forwarded, feedback_sent=run["feedback_sent"],
         retransmitted=nack["retransmitted"], **counts,
         cpu_twin_conferences=SFU_DTLS_TWIN_CONFS,
         cpu_twin_equal_ticks=twin_ticks, cpu_twin_s=twin_s,
         gcm=g_counts, launches_per_tick=run["launches_per_tick"])


def _check_early(dev, traffic, early_recv, early_wire) -> None:
    """Each early copy opens under its receiving endpoint's exported keys
    and carries its sender's early payload."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    sent = {b"early %d %d" % (k, j) for k in early_wire for j in range(2)}
    tk, ts = traffic["keys"]["tx"]
    for k, got in enumerate(early_recv):
        if not got:
            continue
        down = SrtpStreamTable(len(got), device=dev)
        down.add_streams(np.arange(len(got)), tk[[k] * len(got)],
                         ts[[k] * len(got)])
        dec, ok = down.unprotect_rtp(PacketBatch.from_payloads(
            got, stream=list(range(len(got)))))
        require(bool(np.asarray(ok).all()), f"sfu_dtls: an early copy at "
                                            f"socket {k} failed to open")
        hdr = rtp_header.parse(dec)
        for i in range(len(got)):
            body = dec.to_bytes(i)[int(hdr.payload_off[i]):]
            require(body in sent, f"sfu_dtls: socket {k}'s early copy is "
                                  "not what was sent")


def _check_gcm_conf(dev, setup, run) -> dict:
    """The GCM conference: every media copy at leg k's socket opens under
    leg k's exported GCM keys and is what its sender sent that tick."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    gcm, g = setup["gcm"], setup["g_bridge"]
    tk, ts = gcm["keys"]["tx"]
    ssrc = gcm["ssrc"]
    copies, feedback = 0, 0
    for k, got in enumerate(run["g_recv"]):
        media = [p for p in got if not 192 <= p[1] <= 223]
        feedback += len(got) - len(media)
        down = SrtpStreamTable(SFU_SIZE, SrtpProfile[GCM], device=dev)
        down.add_streams(np.arange(SFU_SIZE), tk[[k] * SFU_SIZE],
                         ts[[k] * SFU_SIZE])
        b = PacketBatch.from_payloads(media)
        b.stream[:] = rtp_header.parse(b).ssrc - ssrc[0]
        dec, ok = down.unprotect_rtp(b)
        require(bool(np.asarray(ok).all()) and len(media)
                == SFU_DTLS_GCM_TICKS * (SFU_SIZE - 1),
                f"sfu_dtls gcm: leg {k} got {len(media)} copies, "
                f"{int((~np.asarray(ok)).sum())} failed to open")
        hdr = rtp_header.parse(dec)
        for i in range(dec.batch_size):
            j = int(hdr.ssrc[i] - ssrc[0])
            t = (int(hdr.seq[i]) - int(gcm["seq0"][j])) & 0xFFFF
            require(j != k and dec.to_bytes(i)[int(hdr.payload_off[i]):]
                    == gcm["payloads"][t][j], f"sfu_dtls gcm: leg {k}'s "
                                              "copy differs from what was "
                                              "sent")
        copies += len(media)
    require(run["g_feedback"] > 0 and feedback == run["g_feedback"],
            f"sfu_dtls gcm: feedback sent {run['g_feedback']}, "
            f"received {feedback}")
    return dict(endpoints=SFU_SIZE, ticks=SFU_DTLS_GCM_TICKS,
                copies_opened=copies, feedback=feedback,
                forwarded=g.forwarded)


def conference_dtls_setup(torch, dev, rec_dir: str) -> dict:
    """CONF_PARTIES PCMU participants joined to a `ConferenceBridge` on the
    card by `add_participant_dtls`, each handshaking over loopback from a
    socket of its own, a `Recorder` attached; then CONF_DTLS_TICKS ticks
    of the conference cell's tones under the exported keys (kernels F
    and C, before the counts are reset).  A participant hears the mix
    from its keys' landing on, at its handshake's address: what reached
    each socket in the storm is kept (`storm_mixes`)."""
    from libjitsi_tpu_torch.recording import Recorder
    from libjitsi_tpu_torch.service.bridge import ConferenceBridge

    kind, kind_name = _dtls_kind()
    n = CONF_PARTIES
    socks = _Socks(n)
    rec = Recorder(rec_dir)
    bridge = _keep("conference dtls", ConferenceBridge(
        capacity=n, recorder=rec, device=dev))
    bridge._dtls.endpoint_factory = kind
    ssrc = 0x30000000 + np.arange(n)

    def join(k, fp, addr, role):
        return bridge.add_participant_dtls(int(ssrc[k]), role=role,
                                           remote_fingerprint=fp,
                                           remote_addr=addr)

    storm = _dtls_storm(bridge, kind, n, join, socks, 990.0)
    require(storm["sids"] == {k: k for k in range(n)},
            "conference_dtls: rows not handed out in join order")
    keys = _exported(storm["peers"], n)
    setup = _conference_setup(torch, dev, keys=keys, ticks=CONF_DTLS_TICKS)
    require(np.array_equal(setup["ssrc"], ssrc), "conference_dtls: SSRCs")
    setup["storm_mixes"] = [socks.recv(k) for k in range(n)]
    emit("dtls_endpoint", path="conference_dtls", endpoint=kind_name,
         key_agreement=("ECDHE-ECDSA P-256 (OpenSSL DTLS 1.2)"
                        if kind_name.startswith("OpenSSL")
                        else "stub hash of the hello randoms"))
    setup.update(bridge=bridge, socks=socks, storm=storm, rec=rec,
                 kind=kind_name, ticks0=bridge.ticks)
    return setup


def conference_dtls_run(torch, dev, setup) -> dict:
    """The DTLS-keyed conference on the card, counted: CONF_DTLS_TICKS
    ticks from one client socket (kernels C, D, E, F, G)."""
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.kernels import build as kbuild

    with UdpEngine(port=0, bind_ip="127.0.0.1",
                   max_batch=2 * CONF_PARTIES) as client:
        res = _conference_ticks(setup["bridge"], setup,
                                range(CONF_DTLS_TICKS), client, kbuild)
    res["launches_per_tick"] = {k: v / CONF_DTLS_TICKS
                                for k, v in res["launches"].items()}
    short = {k: res["launches_min"][k] for k in PATHS["conference_dtls"]
             if res["launches_min"][k] < 1}
    require(not short, f"a conference_dtls tick launched none of {short}")
    return res


def _open_replies(dev, keys, replies, heard=None) -> list:
    """Each tick's mixes opened under the participants' tx keys (rows by
    the bridge's TX SSRC), after the mixes each row `heard` before them:
    per tick, each row's marker and payload type byte and everything
    after the fixed header (its level extension and its payload), by
    row."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    n = CONF_PARTIES
    down = SrtpStreamTable(n, device=dev)
    down.add_streams(np.arange(n), *keys)
    before = [(k, d) for k, got in enumerate(heard or ()) for d in got]
    if before:
        _dec, ok = down.unprotect_rtp(PacketBatch.from_payloads(
            [d for _k, d in before], stream=[k for k, _d in before]))
        require(bool(np.asarray(ok).all()), "a mix heard in the join storm "
                                            "failed to open")
    out = []
    for tick in replies:
        b = PacketBatch.from_payloads(tick)
        b.stream[:] = rtp_header.parse(b).ssrc - 0x42000000
        dec, ok = down.unprotect_rtp(b)
        require(bool(np.asarray(ok).all()), "a conference mix failed to "
                                            "open under its leg's keys")
        out.append({int(b.stream[i]): d[1:2] + d[12:]
                    for i, d in enumerate(dec.to_payloads())})
    return out


def conference_dtls_check(torch, dev, run, setup, conf) -> None:
    """Gates: each participant's mixes, opened under the keys it exported,
    equal tick by tick the SDES-keyed conference path's mixes opened
    under its keys (the same plaintext in; payload and level extension,
    the TX counters being each bridge's own); the recorder's timeline
    names participant 10 from CONF_SWITCH on.  Prints the
    `conference_dtls` line."""
    bridge, rec = setup["bridge"], setup["rec"]
    mine = _open_replies(dev, setup["keys"]["tx"], run["replies"],
                         setup["storm_mixes"])
    sdes = _open_replies(dev, conf["setup"]["keys"]["tx"],
                         conf["replies"][:CONF_DTLS_TICKS])
    for t in range(CONF_DTLS_TICKS):
        require(mine[t] == sdes[t], f"conference_dtls tick {t}: the "
                                    "mixes differ from the SDES bridge's")
    changes = [e for e in rec._events if e["type"] == "SPEAKER_CHANGED"]
    after = [(tk, sid) for tk, sid in bridge.speaker_events
             if tk - setup["ticks0"] >= CONF_SWITCH]
    require(after and after[-1][1] == 10 and changes
            and changes[-1]["ssrc"] == int(setup["ssrc"][10]),
            f"conference_dtls: the recorder's timeline {changes[-3:]} does "
            "not name participant 10")
    storm = setup["storm"]
    secs = np.array(run["tick_s"])
    meta = rec.close()
    bridge.close()
    setup["socks"].close()
    emit("conference_dtls", endpoint=setup["kind"],
         participants=CONF_PARTIES, ticks=CONF_DTLS_TICKS,
         storm_s=storm["storm_s"],
         joins_per_s=CONF_PARTIES / storm["storm_s"],
         join_to_keys_ms_p50=float(np.median(storm["join_s"])) * 1e3,
         join_to_keys_ms_p99=float(np.percentile(storm["join_s"], 99))
         * 1e3,
         retransmits_total=bridge._dtls.retransmits_total,
         tick_ms_p50=float(np.median(secs)) * 1e3,
         tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
         mixes_equal_to_sdes_ticks=CONF_DTLS_TICKS,
         mixes_heard_in_storm=sum(map(len, setup["storm_mixes"])),
         recorder_speaker_changes=len(changes),
         recorder_metadata=os.path.basename(meta),
         launches_per_tick=run["launches_per_tick"])


def _zrtp_run(a, b) -> None:
    """a initiates after the Hello exchange (in memory, as the endpoints
    would over the media port)."""
    wire = [(b, p) for p in a.hello_packets()] + \
        [(a, p) for p in b.hello_packets()]
    started = False
    for _ in range(30):
        if a.complete and b.complete:
            return
        wire = [(a if dst is b else b, r) for dst, p in wire
                for r in dst.feed(p)]
        if not started and b"Hello   " in a._peer:
            wire += [(b, p) for p in a.initiate()]
            started = True
    require(a.complete and b.complete, "stream_zrtp: an exchange did not "
                                       "complete")


def _zrtp_suites(have_ec: bool) -> list:
    """The suite of each of MS_PAIRS pairs: ZRTP_SUITES' counts, the rest
    the default; without the `cryptography` package every pair agrees by
    DH3k (the default pairs are DH3k pairs then)."""
    suites = []
    for name, cnt in ZRTP_SUITES:
        suites += [name] * cnt
    suites += ["default"] * (MS_PAIRS - len(suites))
    if not have_ec:
        suites = ["dh3k" if s == "default" else s for s in suites]
    return suites


def _zrtp_controls(suites, have_ec: bool) -> list:
    """Each pair's completed (near, far) ZRTP endpoints.  Multistream
    pairs key off the DH3k pairs' associations in order; the continuity
    pairs share a `ZidCache` a side with a first session, and key by the
    second, whose `secret_continuity` must hold."""
    from libjitsi_tpu_torch.control.zrtp import (CIPHER_AES3, AUTH_HS32,
                                                 KA_DH3K, ZidCache,
                                                 ZrtpEndpoint)

    ka = {} if have_ec else {"ka": (KA_DH3K,)}
    algs = {"default": ka, "aes3_hs80": dict(ka, cipher=(CIPHER_AES3,)),
            "aes3_hs32": dict(ka, cipher=(CIPHER_AES3,), auth=(AUTH_HS32,)),
            "dh3k": {"ka": (KA_DH3K,)}, "continuity": ka}
    dh_parents = []
    ctls = []
    for k, suite in enumerate(suites):
        s1, s2 = 0x60000000 + 2 * k, 0x60000000 + 2 * k + 1
        if suite == "multistream":
            pa, pb = dh_parents.pop(0)
            a = ZrtpEndpoint(ssrc=s1, multistream_from=pa)
            b = ZrtpEndpoint(ssrc=s2, multistream_from=pb)
        elif suite == "continuity":
            ca, cb = ZidCache(), ZidCache()
            za, zb = os.urandom(12), os.urandom(12)
            _zrtp_run(ZrtpEndpoint(zid=za, ssrc=s1, cache=ca,
                                   algorithms=algs[suite]),
                      ZrtpEndpoint(zid=zb, ssrc=s2, cache=cb))
            a = ZrtpEndpoint(zid=za, ssrc=s1, cache=ca,
                             algorithms=algs[suite])
            b = ZrtpEndpoint(zid=zb, ssrc=s2, cache=cb)
        else:
            a = ZrtpEndpoint(ssrc=s1, algorithms=algs[suite])
            b = ZrtpEndpoint(ssrc=s2)
        _zrtp_run(a, b)
        require(a.sas == b.sas, f"stream_zrtp: pair {k}'s SAS differ")
        require(suite != "continuity" or (a.secret_continuity
                                          and b.secret_continuity),
                f"stream_zrtp: pair {k}'s second session lost continuity")
        if suite == "dh3k":
            dh_parents.append((a, b))
        ctls.append((a, b))
    return ctls


def _zrtp_streams(svc, far, ctls, pairs) -> dict:
    """Pair k's two `AudioMediaStream`s (near on `svc`'s registry, far on
    `far`, both at row k), started with its ZRTP controls; TX counters
    from a seeded generator."""
    out = {}
    for k in pairs:
        a, b = ctls[k]
        prof = a.srtp_keys()[0]
        _ms_claim(svc.registry, k)
        near = svc.create_media_stream("audio", profile=prof,
                                       local_ssrc=a.ssrc)
        _ms_claim(far, k)
        far_s = svc.create_media_stream("audio", registry=far, profile=prof,
                                        local_ssrc=b.ssrc)
        require(near.sid == far_s.sid == k, f"stream_zrtp: pair {k} took "
                                            f"rows {near.sid}, {far_s.sid}")
        rng = np.random.default_rng([0x2B7, k])
        for s in (near, far_s):
            s._tx_seq = int(rng.integers(0, 1 << 16))
            s._tx_ts = int(rng.integers(0, 1 << 32))
        near.set_remote_ssrc(far_s.local_ssrc)
        far_s.set_remote_ssrc(near.local_ssrc)
        near.start(srtp_control=a)
        far_s.start(srtp_control=b)
        out[k] = (near, far_s)
    return out


def stream_zrtp_setup(torch, dev) -> dict:
    """`init()` and `media_service()` on the card (MS_WIDTH rows) and a far
    registry of MS_WIDTH rows; MS_PAIRS pairs keyed by ZRTP (suites by
    `_zrtp_suites`), each stream started with its completed control."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import libjitsi_tpu_torch
    from libjitsi_tpu_torch.control import zrtp
    from libjitsi_tpu_torch.service.media_stream import StreamRegistry

    have_ec = zrtp.HAVE_CRYPTOGRAPHY
    suites = _zrtp_suites(have_ec)
    t0 = time.perf_counter()
    ctls = _zrtp_controls(suites, have_ec)
    exchange_s = time.perf_counter() - t0
    libjitsi_tpu_torch.stop()
    libjitsi_tpu_torch.init({"libjitsi_tpu.stream_capacity": MS_WIDTH})
    svc = libjitsi_tpu_torch.media_service()
    far = StreamRegistry(MS_WIDTH, device=dev)
    streams = _zrtp_streams(svc, far, ctls, range(MS_PAIRS))
    frames = np.random.default_rng(67).integers(0, 256, (MS_PAIRS, 2, 160),
                                                np.uint8)
    # the CPU twin: ZRTP_TWIN pairs of each suite, a process a suite,
    # started now to run beside the card's
    twin_pairs = {s: [k for k, x in enumerate(suites) if x == s][:ZRTP_TWIN]
                  for s in sorted(set(suites))}
    pool = ProcessPoolExecutor(
        len(twin_pairs), mp_context=multiprocessing.get_context("spawn"))
    twins = [pool.submit(_zrtp_twin, {k: tuple(_Exported(c) for c in ctls[k])
                                      for k in ks}, frames)
             for ks in twin_pairs.values()]
    emit("zrtp_key_agreement", path="stream_zrtp",
         key_agreement="EC25 (P-256) and DH3k" if have_ec else
         "DH3k only (no cryptography package)",
         suites={s: suites.count(s) for s in sorted(set(suites))},
         exchange_s=exchange_s)
    return dict(svc=svc, far=far, suites=suites, ctls=ctls,
                streams=streams, frames=frames, have_ec=have_ec, pool=pool,
                twins=twins)


def _zrtp_drive(streams, frames, timed: bool, receive: bool = True
                ) -> dict:
    """ZRTP_TICKS ticks: each near end sends one 160-byte frame and (with
    `receive`) its far end receives it, then the far end answers the
    same way; returns every wire and, `timed`, each call's seconds by
    the pair's key length."""
    from libjitsi_tpu_torch.rtp import header as rtp_header

    wire = {k: [] for k in streams}
    times = {}
    for t in range(ZRTP_TICKS):
        for k, (near, far_s) in streams.items():
            key = 256 if "AES_256" in near.profile.name else 128
            for src, dst, j in ((near, far_s, 0), (far_s, near, 1)):
                frame = frames[k, j].tobytes()
                t0 = time.perf_counter()
                w = src.send([frame], pt=0, ts_step=160)
                t1 = time.perf_counter()
                wire[k].append(w[0])
                if not receive:
                    continue
                got, ok = dst.receive(w)
                t2 = time.perf_counter()
                off = int(rtp_header.parse(got).payload_off[0])
                require(bool(ok[0]) and got.to_bytes(0)[off:] == frame,
                        f"stream_zrtp: pair {k} tick {t}: the frame did "
                        "not come back as sent")
                if timed:
                    times.setdefault(f"send_aes{key}", []).append(t1 - t0)
                    times.setdefault(f"receive_aes{key}", []).append(t2 - t1)
    return dict(wire=wire, times=times)


class _Exported:
    """A completed control's exported keys and SSRC, picklable: what
    `MediaStream.start(srtp_control=...)` reads of it."""

    def __init__(self, ctl):
        prof, *keys = ctl.srtp_keys()
        self.ssrc, self.keys = ctl.ssrc, (prof.name, *keys)

    def srtp_keys(self):
        from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

        return (SrtpProfile[self.keys[0]], *self.keys[1:])


def _zrtp_twin(ctls: dict, frames) -> dict:
    """The CPU twin of some pairs (`ctls`: pair -> exported keys of both
    ends): the same streams on a `MediaService` and far registry with
    `device="cpu"`, one PyTorch thread, in a process of its own; their
    sends' wire."""
    import torch

    from libjitsi_tpu_torch.core.config import ConfigurationService
    from libjitsi_tpu_torch.service.media_service import MediaService
    from libjitsi_tpu_torch.service.media_stream import StreamRegistry

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    svc = MediaService(ConfigurationService(
        {"libjitsi_tpu.stream_capacity": MS_WIDTH}), device="cpu")
    far = StreamRegistry(MS_WIDTH, device="cpu")
    streams = _zrtp_streams(svc, far, ctls, sorted(ctls))
    res = _zrtp_drive(streams, frames, timed=False, receive=False)
    return dict(wire=res["wire"], seconds=time.perf_counter() - t0)


def stream_zrtp_run(torch, dev, setup) -> dict:
    """The ZRTP-keyed streams on the card, counted: ZRTP_TICKS ticks both
    ways (kernels C and D, AES-128 and AES-256 instances)."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    res = _zrtp_drive(setup["streams"], setup["frames"], timed=True)
    res["launches_per_tick"] = {k: v / ZRTP_TICKS
                                for k, v in kbuild.launches.items()}
    res["instances"] = dict(kbuild.instance_launches)
    return res


def stream_zrtp_check(torch, dev, run, setup) -> None:
    """Gates: the AES-256 instances of C and D launched; ZRTP_TWIN pairs
    of each suite put the same wire on the line as their CPU twin (the
    same streams on `device="cpu"`, started with the same exported keys
    and counters).  Prints the `stream_zrtp` line with each call's
    p50/p99 by key length."""
    inst = run["instances"]
    for name in ZRTP_INSTANCES:
        require(inst.get(name, 0) > 0, f"stream_zrtp did not launch {name}")
    suites = setup["suites"]
    t0 = time.perf_counter()
    try:
        twins = [f.result() for f in setup["twins"]]
    finally:
        setup["pool"].shutdown()
    wait_s = time.perf_counter() - t0
    n_twin = 0
    for twin in twins:
        for k, wire in twin["wire"].items():
            require(wire == run["wire"][k], f"stream_zrtp: pair {k} "
                    f"({suites[k]}) on the card differs from the CPU twin")
            n_twin += 1
    times = {k: np.array(v) * 1e3 for k, v in run["times"].items()}
    emit("stream_zrtp", pairs=MS_PAIRS, registry_rows=MS_WIDTH,
         ticks=ZRTP_TICKS, suites={s: suites.count(s)
                                   for s in sorted(set(suites))},
         key_agreement="EC25 and DH3k" if setup["have_ec"] else "DH3k",
         sas_equal=True, continuity_held=True,
         **{f"{k}_ms_p50": float(np.median(v)) for k, v in times.items()},
         **{f"{k}_ms_p99": float(np.percentile(v, 99))
            for k, v in times.items()},
         instances={k: v for k, v in inst.items() if v},
         cpu_twin_pairs=n_twin, cpu_twin_equal=True,
         cpu_twin_s=max(t["seconds"] for t in twins),
         cpu_twin_wait_s=wait_s, launches_per_tick={
             k: v for k, v in run["launches_per_tick"].items() if v})


# ------------------------------------------------------- the video plane

class _Uncounted:
    """Launches the harness makes around a counted path (the clients'
    wire and RTCP, the checks' decrypts) put the counters back as they
    were, so a path's counts hold the bridge's launches only."""

    def __init__(self, kbuild):
        self.k = kbuild

    def __enter__(self):
        self.saved = [dict(d) for d in (self.k.launches, self.k.plain_calls,
                                        self.k.instance_launches)]

    def __exit__(self, *exc):
        for d, s in zip((self.k.launches, self.k.plain_calls,
                         self.k.instance_launches), self.saved):
            d.clear()
            d.update(s)


def _layer_want(layer_bps, bw: float) -> int:
    """The bridge's pick: the highest layer whose nominal rate fits."""
    want = 0
    for layer, bps in enumerate(layer_bps):
        if bps <= bw:
            want = layer
    return want


def _force_rcvbuf(fd: int, nbytes: int) -> None:
    """SO_RCVBUFFORCE (SO_RCVBUF where not permitted) on a socket the
    harness owns, through a duplicate of its descriptor."""
    import socket

    s = socket.fromfd(fd, socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, 33, nbytes)       # SO_RCVBUFFORCE
    except OSError:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, nbytes)
    finally:
        s.close()


class _VideoClient:
    """The endpoints of a video SFU cell, made from a seed: keys, SSRCs,
    conferences, the receivers' REMB thirds, each sender's 30 fps frame
    clock (its phase in ms drawn), keyframe phase, picture ids and
    per-layer RTP state; their uplink SRTP table on the card (a row for
    each audio and layer SSRC) and VIDEO_SOCKETS client sockets, endpoint
    k sending and receiving on socket k % VIDEO_SOCKETS.

    `kind` "simulcast": three VP8 layers a sender, one SSRC each, built
    by `vp8.packetize`; "svc": one VP9 SSRC of three spatial layers, the
    temporal layers in SVC_TIDS order.  Frame sizes are the layer's rate
    over 30 fps, four times that on a keyframe (the first frame, every
    VIDEO_KEY_EVERY-th at the sender's phase, and the next frame of a
    layer a PLI named).  The last VIDEO_TAG bytes of every packet's
    payload say where it came from: key flag, sender, layer, frame
    number, fragment.  Each endpoint also sends one Opus-sized packet a
    tick with an abs-send-time extension (the audio row, kernel H)."""

    def __init__(self, torch, dev, kind: str, confs: int, seed: int):
        from libjitsi_tpu_torch.io.udp import UdpEngine
        from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

        n = confs * SFU_SIZE
        rng = np.random.default_rng(seed)
        self.kind, self.n, self.confs = kind, n, confs
        self.nl = 3 if kind == "simulcast" else 1       # SSRCs a sender
        self.keys = {d: (rng.integers(0, 256, (n, 16), np.uint8),
                         rng.integers(0, 256, (n, 14), np.uint8))
                     for d in ("rx", "tx")}
        perm = rng.permutation(1 << 20)
        self.ssrc = (0x54000000 + perm[:n]).astype(np.int64)
        self.lssrc = (0x64000000 + (perm[n:2 * n, None] << 2)
                      + np.arange(self.nl)).astype(np.int64)
        self.conf = np.arange(n) // SFU_SIZE
        self.remb = np.array([VIDEO_REMB[c % 3] for c in self.conf])
        self.audio_seq = rng.integers(0, 1 << 16, n)
        self.seq = rng.integers(0, 1 << 16, (n, self.nl))
        self.seq[::7] = 65536 - 20                      # these wrap
        self.ts0 = rng.integers(0, 1 << 32, n)
        self.pid0 = rng.integers(0x80, 0x8000, n)
        self.phase_ms = rng.integers(0, 33, n)
        self.key_phase = rng.integers(1, VIDEO_KEY_EVERY, n)
        self.next_frame = np.zeros(n, np.int64)
        self.tl0 = np.zeros(n, np.int64)
        self.force_key = np.zeros((n, 3), bool)
        self.pool = rng.integers(0, 256, 1 << 16, np.uint8).tobytes()
        self.sizes = [bps // VIDEO_FPS // 8 for _, _, bps in VIDEO_LAYERS]
        rows = n * (1 + self.nl)
        self.up = SrtpStreamTable(rows, device=dev)
        owner = np.concatenate([np.arange(n), np.repeat(np.arange(n),
                                                         self.nl)])
        self.up.add_streams(np.arange(rows), self.keys["rx"][0][owner],
                            self.keys["rx"][1][owner])
        self.owner = owner                  # up-table row -> endpoint
        self.socks = [UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=4096,
                                rcvbuf=64 << 20)
                      for _ in range(min(VIDEO_SOCKETS, n))]
        self.stats = dict(frames=0, keyframes=0, pli_keyframes=0,
                          packets=0, audio=0)
        self.made_s = 0.0                   # making and protecting wire

    def _fragments(self, k: int, layer: int, f: int, size: int,
                   key: bool, chunk: int) -> list:
        out = []
        for j in range(-(-size // chunk)):
            flen = min(chunk, size - j * chunk)
            off = (k * 7919 + f * 104729 + layer * 31 + j * 613) % (
                len(self.pool) - 1400)
            body = self.pool[off:off + flen - VIDEO_TAG]
            if j == 0:          # the VP8 payload header's P bit
                body = bytes([0x10 if key else 0x11]) + body[1:]
            out.append(body + bytes([int(key), k >> 8, k & 0xFF, layer,
                                     (f >> 16) & 0xFF, (f >> 8) & 0xFF,
                                     f & 0xFF, j & 0xFF]))
        return out

    def media(self, t: int):
        """Tick t's datagrams: (plain PacketBatch on up-table rows,
        endpoint of each row)."""
        from libjitsi_tpu_torch.codecs import vp8, vp9
        from libjitsi_tpu_torch.rtp import header as rtp_header

        n = self.n
        pls, seqs, tss, ssrcs, pts, marks, rows, exts = ([] for _ in
                                                          range(8))
        ast = int(round((1000.0 + 0.02 * t) * (1 << 18))) & 0xFFFFFF
        ext = (0xBEDE, bytes([0x32]) + ast.to_bytes(3, "big"))
        for k in range(n):
            off = (k * 131 + t * 977) % (len(self.pool) - 200)
            pls.append(self.pool[off:off + 60 + (k * 7 + t) % 101])
            seqs.append(int(self.audio_seq[k] + t) & 0xFFFF)
            tss.append(t * 960)
            ssrcs.append(int(self.ssrc[k]))
            pts.append(111)
            marks.append(0)
            rows.append(k)
            exts.append(ext)
        self.stats["audio"] += n
        due = np.nonzero((self.next_frame * 100 + 3 * self.phase_ms) // 60
                         == t)[0]
        for k in due:
            k = int(k)
            f = int(self.next_frame[k])
            self.next_frame[k] += 1
            periodic = f == 0 or f % VIDEO_KEY_EVERY == self.key_phase[k]
            pid = 0x80 + (int(self.pid0[k]) - 0x80 + f) % (0x8000 - 0x80)
            ts = (int(self.ts0[k]) + f * 3000) & 0xFFFFFFFF
            if self.kind == "simulcast":
                for layer in range(3):
                    key = periodic or bool(self.force_key[k, layer])
                    self._count(key, periodic, layer, k)
                    size = self.sizes[layer] * (VIDEO_KEY_SCALE if key
                                                else 1)
                    frame = b"".join(self._fragments(
                        k, layer, f, size, key, VIDEO_PAYLOAD - VIDEO_DESC))
                    p = vp8.packetize(frame, picture_id=pid,
                                      max_payload=VIDEO_PAYLOAD)
                    self._rtp(k, layer, p, ts, [0] * (len(p) - 1) + [1],
                              pls, seqs, tss, ssrcs, pts, marks, rows, exts)
                continue
            key = periodic or bool(self.force_key[k, 0])
            self._count(key, periodic, 0, k)
            tid = 0 if key else SVC_TIDS[f % len(SVC_TIDS)]
            if tid == 0:
                self.tl0[k] += 1
            for s in range(3):
                size = self.sizes[s] * (VIDEO_KEY_SCALE if key else 1)
                descs = []
                probe = vp9.build_descriptor(
                    begin=True, picture_id=pid, tid=tid, sid=s,
                    tl0picidx=int(self.tl0[k]) & 0xFF,
                    inter_predicted=not key,
                    ss_sizes=[(w, h) for w, h, _ in VIDEO_LAYERS]
                    if key and s == 0 else None)
                frags = self._fragments(k, s, f, size, key,
                                        VIDEO_PAYLOAD - len(probe))
                for j, frag in enumerate(frags):
                    descs.append(vp9.build_descriptor(
                        begin=j == 0, end=j == len(frags) - 1,
                        picture_id=pid, tid=tid, sid=s,
                        tl0picidx=int(self.tl0[k]) & 0xFF,
                        inter_predicted=not key,
                        ss_sizes=[(w, h) for w, h, _ in VIDEO_LAYERS]
                        if key and s == 0 and j == 0 else None) + frag)
                self._rtp(k, 0, descs, ts,
                          [0] * (len(descs) - 1) + [int(s == 2)],
                          pls, seqs, tss, ssrcs, pts, marks, rows, exts)
        b = rtp_header.build(pls, seqs, tss, ssrcs, pts, marker=marks,
                             stream=rows, ext=exts)
        self.stats["packets"] += len(pls)
        return b, self.owner[np.asarray(rows)]

    def _count(self, key, periodic, layer, k):
        self.stats["frames"] += 1
        self.stats["keyframes"] += int(key)
        self.stats["pli_keyframes"] += int(key and not periodic)
        self.force_key[k, layer] = False

    def _rtp(self, k, layer, payloads, ts, marker, pls, seqs, tss, ssrcs,
             pts, marks, rows, exts):
        m = len(payloads)
        s0 = int(self.seq[k, layer])
        self.seq[k, layer] += m
        pls += payloads
        seqs += [(s0 + i) & 0xFFFF for i in range(m)]
        tss += [ts] * m
        ssrcs += [int(self.lssrc[k, layer])] * m
        pts += [96 if self.kind == "simulcast" else 98] * m
        marks += marker
        rows += [self.n + k * self.nl + layer] * m
        exts += [None] * m

    def rtcp(self, blobs_of: dict):
        """Receivers' compound RTCP {endpoint: [packets]} protected on
        their audio rows: (wire, endpoint of each row)."""
        from libjitsi_tpu_torch.core.packet import PacketBatch
        from libjitsi_tpu_torch.rtp import rtcp

        eps = sorted(blobs_of)
        wire = self.up.protect_rtcp(PacketBatch.from_payloads(
            [rtcp.build_compound(blobs_of[k]) for k in eps], stream=eps))
        return wire, np.asarray(eps, np.int64)

    def rembs(self, who) -> dict:
        """A REMB from each receiver in `who` at its current rate, naming
        its conference mates' SSRCs."""
        from libjitsi_tpu_torch.rtp import rtcp

        out = {}
        for k in who:
            c = self.conf[k]
            mates = [int(self.ssrc[m]) for m in range(c * SFU_SIZE,
                                                      (c + 1) * SFU_SIZE)
                     if m != k]
            out[int(k)] = [rtcp.build_remb(rtcp.Remb(
                int(self.ssrc[k]), int(self.remb[k]), mates))]
        return out

    def send(self, wire, eps, rows, port: int) -> None:
        s = len(self.socks)
        for i, sock in enumerate(self.socks):
            mine = rows[eps[rows] % s == i]
            if len(mine):
                sock.send_rows(wire, mine, "127.0.0.1", port)

    def close(self) -> None:
        for sock in self.socks:
            sock.close()


def _video_bridge(torch, dev, client, capacity: int):
    """An SfuBridge of the client's endpoints in their conferences, every
    endpoint a video track's sender (3-layer simulcast, or one SVC SSRC)
    and, in its conference, every other's receiver; its receive buffer
    forced to 64 MB.  The setup's launches (none: keys derive on the
    host) are not the path's."""
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge

    (rk, rs), (tk, ts) = client.keys["rx"], client.keys["tx"]
    bridge = _keep(f"sfu {client.kind}", SfuBridge(capacity=capacity,
                                                   device=dev))
    n = client.n
    sids = bridge.stage_endpoints(
        [(int(client.ssrc[k]), (rk[k].tobytes(), rs[k].tobytes()),
          (tk[k].tobytes(), ts[k].tobytes()), None) for k in range(n)],
        conferences=client.conf.tolist())
    require(sids == list(range(n)), "rows not handed out in spec order")
    bridge.commit_endpoints(sids)
    bps = [b for _, _, b in VIDEO_LAYERS]
    for k in range(n):
        if client.kind == "simulcast":
            bridge.add_video_track(k, client.lssrc[k].tolist(), bps)
        else:
            bridge.add_svc_track(k, int(client.lssrc[k, 0]), SVC_LAYER_BPS)
    _force_rcvbuf(bridge.loop.engine._fd, 64 << 20)
    return bridge


class _VideoLog:
    """The bridge's tx-table calls of a tick, as its users' checks read
    them: every `protect_rtp` (projections and RTX: the rows, the
    plaintext and the wire) and `protect_rtcp` (the feedback's rows and
    compounds), and a hash of every datagram the engine sends."""

    def __init__(self, bridge):
        import collections

        self.rtp, self.rtcp, self.sent = [], [], collections.Counter()
        tx = bridge.tx_table
        prot, prot_c = tx.protect_rtp, tx.protect_rtcp
        eng = bridge.loop.engine
        send = eng.send_batch

        def protect_rtp(batch):
            wire = prot(batch)
            self.rtp.append((np.asarray(batch.stream).copy(), batch, wire))
            return wire

        def protect_rtcp(batch):
            self.rtcp.append((np.asarray(batch.stream).copy(),
                              batch.to_payloads()))
            return prot_c(batch)

        def send_batch(batch, ip, port):
            self.sent.update(hash(p) for p in batch.to_payloads())
            return send(batch, ip, port)

        tx.protect_rtp, tx.protect_rtcp = protect_rtp, protect_rtcp
        eng.send_batch = send_batch

    def take(self):
        rtp, rtcp_, self.rtp, self.rtcp = self.rtp, self.rtcp, [], []
        return rtp, rtcp_


def _video_rows(bridge, n: int, cap: int) -> dict:
    """The bridge's tx rows of the video plane read back from its tracks:
    each row's receiver, sender and kind (0 projection, 1 RTX)."""
    recv = np.full(cap, -1, np.int64)
    send = np.full(cap, -1, np.int64)
    kind = np.full(cap, -1, np.int64)
    for track in bridge._tracks():
        for k, d in ((0, track.tx_sid), (1, track.rtx_sid)):
            for r, row in d.items():
                recv[row], send[row], kind[row] = r, track.sender_sid, k
    return dict(recv=recv, send=send, kind=kind)


def _video_down(dev, client, rows: dict, cap: int):
    """The receivers' side of every projection and RTX row: a card table
    keyed row for row with the receiver's leg key."""
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    live = np.nonzero(rows["recv"] >= 0)[0]
    down = SrtpStreamTable(cap, device=dev)
    tk, ts = client.keys["tx"]
    down.add_streams(live, tk[rows["recv"][live]], ts[rows["recv"][live]])
    return down


def _video_tags(data: np.ndarray, length: np.ndarray) -> np.ndarray:
    """The VIDEO_TAG bytes at each row's end: [rows, VIDEO_TAG]."""
    idx = length.astype(np.int64)[:, None] - VIDEO_TAG + np.arange(VIDEO_TAG)
    return np.take_along_axis(data, idx, axis=1).astype(np.int64)


class _VideoChecks:
    """The semantic checks of a video cell, a tick at a time on the
    bridge's log: every copy authenticates under its receiver's
    projection or RTX row (a card table keyed row for row) and decrypts
    to the plaintext the bridge projected; each projected stream is
    gapless in seq; no copy echoes to its sender or crosses a
    conference, and each carries its track's SSRC; a simulcast stream
    changes layer only on a keyframe's first packet; the streams' layers
    at the end are what each receiver's REMB picks; each RTX copy
    decapsulates to the cached original of the seq its receiver
    NACKed."""

    def __init__(self, torch, dev, bridge, client, cap: int):
        self.client, self.bridge, self.cap = client, bridge, cap
        self.rows = _video_rows(bridge, client.n, cap)
        self.down = _video_down(dev, client, self.rows, cap)
        self.last_seq = np.full(cap, -1, np.int64)
        self.layer = np.full(cap, -1, np.int64)
        self.counts = dict(copies=0, rtx=0, switches=0, feedback=0,
                           plis=0)
        self.recent = {}        # (row, seq) -> plaintext of the last tick
        self.nacked = {}        # (receiver, out ssrc) -> [seqs]
        self.last_tick_layers = set()
        self.max_rows = (0, None)

    def tick(self, rtp_log, rtcp_log, keep_recent: bool) -> None:
        from libjitsi_tpu_torch.core.packet import PacketBatch
        from libjitsi_tpu_torch.rtp import header as rtp_header
        from libjitsi_tpu_torch.rtp import rtcp
        from libjitsi_tpu_torch.sfu import rtx as rtx_mod

        c, r = self.client, self.rows
        self.recent = {} if keep_recent else self.recent
        tick_layers = set()
        for stream, plain, wire in rtp_log:
            if len(stream) > self.max_rows[0]:
                self.max_rows = (len(stream), (stream, plain))
            dec, ok = self.down.unprotect_rtp(PacketBatch(
                wire.data, np.asarray(wire.length), stream))
            require(bool(np.asarray(ok).all()), f"{c.kind}: "
                    f"{int((~np.asarray(ok)).sum())} copies failed "
                    "authentication under their receiver's row")
            pl, w = np.asarray(plain.length), plain.data.shape[1]
            inside = np.arange(w)[None, :] < pl[:, None]
            require(bool((np.asarray(dec.length) == pl).all() and (
                (dec.data[:, :w] == plain.data) | ~inside).all()),
                f"{c.kind}: a copy decrypts to other bytes than the "
                "bridge projected")
            recv, send, kind = (r["recv"][stream], r["send"][stream],
                                r["kind"][stream])
            require(bool((recv >= 0).all()), f"{c.kind}: a copy on a row "
                    "that is no track's")
            require(bool((send != recv).all() and (c.conf[send]
                                                   == c.conf[recv]).all()),
                    f"{c.kind}: a copy echoed or crossed a conference")
            hdr = rtp_header.parse(dec)
            proj = kind == 0
            self._gapless(stream[proj], hdr.seq[proj].astype(np.int64))
            self._gapless(stream[~proj], hdr.seq[~proj].astype(np.int64))
            out_ssrc = c.ssrc[send] if c.kind == "simulcast" \
                else c.lssrc[send, 0]
            rtx_ssrc = out_ssrc ^ RTX_SSRC_XOR
            require(bool((hdr.ssrc.astype(np.int64)
                          == np.where(proj, out_ssrc, rtx_ssrc)).all()),
                    f"{c.kind}: a copy's SSRC is not its track's")
            tags = _video_tags(dec.data, np.asarray(dec.length))
            pi = np.nonzero(proj)[0]
            require(bool(((tags[pi, 1] << 8 | tags[pi, 2])
                          == send[pi]).all()),
                    f"{c.kind}: a copy carries another sender's media")
            ri = np.nonzero(~proj)[0]
            if len(ri):
                self._rtx(dec, ri, stream, recv, out_ssrc, rtx_mod)
            self.counts["copies"] += len(pi)
            if not len(pi):
                continue
            order = pi[np.argsort(stream[pi], kind="stable")]
            rs, ls = stream[order], tags[order, 3]
            first = np.r_[True, rs[1:] != rs[:-1]]
            prev = np.where(first, self.layer[rs], np.r_[-1, ls[:-1]])
            if c.kind == "simulcast":
                change = (prev >= 0) & (ls != prev)
                require(bool(((tags[order, 0] == 1) & (tags[order, 7] == 0))
                             [change].all()), f"{c.kind}: a stream "
                        "changed layer off a keyframe's first packet")
                self.counts["switches"] += int(change.sum())
            last = np.r_[rs[1:] != rs[:-1], True]
            self.layer[rs[last]] = ls[last]
            tick_layers.update(rs[last].tolist())
            if keep_recent:
                for i in pi:
                    self.recent[(int(stream[i]), int(hdr.seq[i]))] = \
                        plain.to_bytes(int(i))
        if tick_layers:
            self.last_tick_layers = tick_layers
        for stream, blobs in rtcp_log:
            self.counts["feedback"] += len(blobs)
            for k, blob in zip(stream, blobs):
                for p in rtcp.parse_compound(blob):
                    if isinstance(p, rtcp.Pli):
                        hit = np.nonzero(c.lssrc[int(k)] == p.media_ssrc)[0]
                        require(len(hit) == 1, f"{c.kind}: a PLI for an "
                                "SSRC its sender does not send")
                        c.force_key[int(k), int(hit[0]) if c.nl > 1 else 0] \
                            = True
                        self.counts["plis"] += 1

    def _gapless(self, rows: np.ndarray, seqs: np.ndarray) -> None:
        if not len(rows):
            return
        order = np.argsort(rows, kind="stable")
        rows, seqs = rows[order], seqs[order]
        first = np.r_[True, rows[1:] != rows[:-1]]
        prev = np.where(first, self.last_seq[rows], np.r_[-1, seqs[:-1]])
        ok = (prev < 0) | (seqs == ((prev + 1) & 0xFFFF))
        require(bool(ok.all()), f"{self.client.kind}: a projected stream "
                f"skipped a seq ({int((~ok).sum())} gaps)")
        last = np.r_[rows[1:] != rows[:-1], True]
        self.last_seq[rows[last]] = seqs[last]

    def _rtx(self, dec, ri, stream, recv, out_ssrc, rtx_mod) -> None:
        from libjitsi_tpu_torch.core.packet import PacketBatch

        sub = PacketBatch(dec.data[ri], np.asarray(dec.length)[ri],
                          dec.stream[ri])
        for i, j in enumerate(ri):
            one = PacketBatch(sub.data[i:i + 1], sub.length[i:i + 1],
                              sub.stream[i:i + 1])
            orig, osn = rtx_mod.decapsulate_batch(
                one, int(out_ssrc[j]), 98 if self.client.kind == "svc"
                else 96)
            key = (int(recv[j]), int(out_ssrc[j]))
            require(int(osn[0]) in self.nacked.get(key, ()),
                    f"{self.client.kind}: an RTX copy of a seq its "
                    "receiver did not NACK")
            want = self.nack_orig[(key, int(osn[0]))]
            require(orig.to_bytes(0) == want, f"{self.client.kind}: an "
                    "RTX copy does not decapsulate to the cached original")
            self.counts["rtx"] += 1

    def pick_nacks(self, nackers) -> dict:
        """Each NACKer's NACK for the last VIDEO_NACKED seqs one of its
        streams carried in the tick just checked: {endpoint: [Nack]}."""
        from libjitsi_tpu_torch.rtp import rtcp

        c, r = self.client, self.rows
        by_row = {}
        for (row, seq), pkt in self.recent.items():
            by_row.setdefault(row, []).append((seq, pkt))
        out, self.nack_orig = {}, {}
        for k in nackers:
            cands = [row for row in by_row if r["recv"][row] == k]
            require(cands, f"{c.kind}: NACKer {k} got no copy to NACK")
            row = max(cands, key=lambda x: (len(by_row[x]), -x))
            got = sorted(by_row[row], key=lambda sp: (
                (sp[0] - by_row[row][0][0]) & 0xFFFF))[-VIDEO_NACKED:]
            snd = int(r["send"][row])
            out_ssrc = int(c.ssrc[snd] if c.kind == "simulcast"
                           else c.lssrc[snd, 0])
            seqs = [s for s, _ in got]
            self.nacked[(int(k), out_ssrc)] = seqs
            for s, pkt in got:
                self.nack_orig[((int(k), out_ssrc), s)] = pkt
            out[int(k)] = [rtcp.build_nack(rtcp.Nack(int(c.ssrc[k]),
                                                     out_ssrc, seqs))]
        return out

    def final(self, bridge) -> dict:
        """The end state: every forwarder at the layer its receiver's REMB
        picks, and so is every stream that carried media in the last
        tick (simulcast: its one layer; SVC: its top spatial layer)."""
        c, r = self.client, self.rows
        bps = [b for _, _, b in VIDEO_LAYERS] if c.kind == "simulcast" \
            else list(SVC_LAYER_BPS)
        for track in bridge._tracks():
            for rv, fwd in track.fwd.items():
                want = _layer_want(bps, float(c.remb[rv]))
                cur = fwd.current_layer if c.kind == "simulcast" \
                    else fwd.current_sid
                require(cur == want, f"{c.kind}: receiver {rv}'s stream of "
                        f"{track.sender_sid} at layer {cur}, its REMB "
                        f"picks {want}")
        wrong = 0
        for row in self.last_tick_layers:
            want = _layer_want(bps, float(c.remb[r["recv"][row]]))
            wrong += int(self.layer[row] != want)
        require(wrong == 0, f"{c.kind}: {wrong} streams carried another "
                "layer than their REMB picks in the last tick")
        return dict(streams_checked=len(self.last_tick_layers),
                    **self.counts)


def video_setup(torch, dev, kind: str, confs: int) -> dict:
    """A video cell's endpoints and bridge (`_VideoClient`,
    `_video_bridge`), the bridge's tx calls logged, the checks' tables
    keyed and the client's drain thread started, all before the counts
    are reset."""
    import collections
    import threading

    client = _VideoClient(torch, dev, kind, confs,
                          seed=71 if kind == "simulcast" else 73)
    bridge = _video_bridge(torch, dev, client, VIDEO_CAPACITY)
    log = _VideoLog(bridge)
    checks = _VideoChecks(torch, dev, bridge, client, VIDEO_CAPACITY)
    got, stop = collections.Counter(), threading.Event()

    def drain():
        while not stop.is_set():
            for sock in client.socks:
                b, _, _ = sock.recv_batch(timeout_ms=1)
                if b.batch_size:
                    got.update(hash(p) for p in b.to_payloads())

    th = threading.Thread(target=drain, daemon=True)
    th.start()
    return dict(kind=kind, confs=confs, client=client, bridge=bridge,
                log=log, checks=checks, got=got, stop=stop, thread=th,
                rcvbuf=bridge.loop.engine.rcvbuf,
                client_rcvbuf=client.socks[0].rcvbuf)


def _video_tick(bridge, client, t: int, extra=None, replay=None) -> tuple:
    """One 20 ms tick of a video cell: the receivers' RTCP of the tick
    (`extra`, {endpoint: [packets]}: REMBs, NACKs) first, then the media,
    both made by the client on the card outside the counts (or, with
    `replay`, a tick's datagrams as an earlier call returned them) and
    sent from each endpoint's socket in bursts the bridge's receive
    buffer holds, the bridge ticked (now = 1000 + 0.02 t) until it has
    taken each in; then `emit_feedback`.  Returns (bridge seconds,
    datagrams taken, the datagrams sent: (endpoints, wire) a part)."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.kernels import build as kbuild

    now = 1000.0 + 0.02 * t
    t_client = time.perf_counter()
    if replay is not None:
        sends = [(PacketBatch.from_payloads(wire), eps)
                 for eps, wire in replay]
    else:
        sends = []
        with _Uncounted(kbuild):
            if extra:
                sends.append(client.rtcp(extra))
            plain, eps = client.media(t)
            sends.append((client.up.protect_rtp(plain), eps))
    client.made_s += time.perf_counter() - t_client
    # a datagram takes about twice its bytes of the receive buffer
    per_burst = max(256, bridge.loop.engine.rcvbuf // 3200)
    secs, taken = 0.0, 0
    sent = [(eps, wire.to_payloads()) for wire, eps in sends]
    for wire, eps in sends:
        for lo in range(0, wire.batch_size, per_burst):
            rows = np.arange(lo, min(lo + per_burst, wire.batch_size))
            client.send(wire, eps, rows, bridge.port)
            got = 0
            for _ in range(400):
                t0 = time.perf_counter()
                got += bridge.tick(now=now)["rx"]
                secs += time.perf_counter() - t0
                if got >= len(rows):
                    break
            require(got == len(rows), f"{client.kind} tick {t}: the bridge "
                                      f"took {got} of {len(rows)}")
            taken += got
    t0 = time.perf_counter()
    bridge.emit_feedback(now=now + 0.01)
    secs += time.perf_counter() - t0
    return secs, taken, sent


def _video_extra(client, checks, t: int, ticks: int):
    """The receivers' RTCP at tick t: everyone's REMB at tick 0 (the
    receivers of conference c at VIDEO_REMB[c % 3]: thirds by
    conference); at VIDEO_SWITCH_TICK a third of the receivers changes
    (in the conferences c with c // 3 even, 300 kbps goes to 4 Mbps and
    1.2 Mbps to 300 kbps), so each switch asks for a keyframe of a layer
    no PLI has named yet, inside the bridge's 0.5 s PLI interval; at
    VIDEO_NACK_TICK a NACK from one receiver in each of VIDEO_NACKERS
    conferences."""
    switch = min(VIDEO_SWITCH_TICK, ticks - 4)
    nack = min(VIDEO_NACK_TICK, ticks - 2)
    if t == 0:
        return client.rembs(range(client.n))
    if t == switch:
        moved = (client.conf // 3) % 2 == 0
        up = np.nonzero(moved & (client.remb == VIDEO_REMB[0]))[0]
        down = np.nonzero(moved & (client.remb == VIDEO_REMB[1]))[0]
        client.remb[up] = VIDEO_REMB[2]
        client.remb[down] = VIDEO_REMB[0]
        return client.rembs(np.r_[up, down])
    if t == nack:
        nackers = np.arange(min(VIDEO_NACKERS, client.confs)) * SFU_SIZE + 1
        return checks.pick_nacks(nackers)
    return None


def video_run(torch, dev, setup, ticks: int) -> dict:
    """A video cell on the card, counted: `ticks` ticks of `_video_tick`,
    each tick's log checked (outside the counts and the tick's time)."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    bridge, client, checks = setup["bridge"], setup["client"], \
        setup["checks"]
    nack = min(VIDEO_NACK_TICK, ticks - 2)
    res = dict(tick_s=[], taken=0, check_s=0.0, wall_s=0.0)
    wall = time.perf_counter()
    for t in range(ticks):
        extra = _video_extra(client, checks, t, ticks)
        secs, taken, _ = _video_tick(bridge, client, t, extra)
        res["tick_s"].append(secs)
        res["taken"] += taken
        if t == nack:
            res["nack"] = dict(retransmitted=bridge.retransmitted,
                               served=bridge.recovery.rtx_requests_served,
                               cache_miss=bridge.recovery.rtx_cache_miss)
        t0 = time.perf_counter()
        with _Uncounted(kbuild):
            checks.tick(*setup["log"].take(), keep_recent=t == nack - 1)
        res["check_s"] += time.perf_counter() - t0
        if t % 10 == 9:
            emit(f"{client.kind}_progress", tick=t,
                 tick_s=res["tick_s"][-10:], client_s=client.made_s,
                 check_s=res["check_s"])
    res["wall_s"] = time.perf_counter() - wall
    res["launches"] = dict(kbuild.launches)
    res["launches_per_tick"] = {k: v / ticks for k, v in
                                res["launches"].items() if v}
    res["ticks"] = ticks
    return res


def _video_host_split(torch, setup, t0: int, n: int) -> dict:
    """`n` more ticks under torch.profiler with the host's time of the
    video plane split: `_forward_video` whole, the tracks' precache
    inserts in it, the projections' `protect_rtp` (kernel C's call) and
    their `send_batch` (egress)."""
    bridge, client, checks = setup["bridge"], setup["client"], \
        setup["checks"]
    acc = dict(forward_video=0.0, precache_insert=0.0, protect_c=0.0,
               egress=0.0)

    def timed(name, fn):
        def wrapped(*a, **k):
            t0_ = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[name] += time.perf_counter() - t0_
        return wrapped

    saved = (bridge._forward_video, bridge.tx_table.protect_rtp,
             bridge.loop.engine.send_batch)
    bridge._forward_video = timed("forward_video", saved[0])
    bridge.tx_table.protect_rtp = timed("protect_c", saved[1])
    bridge.loop.engine.send_batch = timed("egress", saved[2])
    for track in bridge._tracks():
        track.precache.insert = timed("precache_insert",
                                      track.precache.insert)
    try:
        prof = _outside_spans(profiled_ticks(
            torch, lambda i: _video_tick(bridge, client, t0 + i),
            n, after=lambda i: checks.tick(*setup["log"].take(),
                                           keep_recent=False)))
    finally:
        bridge._forward_video, bridge.tx_table.protect_rtp, \
            bridge.loop.engine.send_batch = saved
        for track in bridge._tracks():
            del track.precache.insert
    acc = {k: v * 1e3 / n for k, v in acc.items()}
    acc["forward_loop"] = acc["forward_video"] - acc["precache_insert"] \
        - acc["protect_c"] - acc["egress"]
    prof["video_host_ms_per_tick"] = acc
    return prof


def _projection_c(torch, dev, stream, plain) -> dict:
    """Kernel C at the largest projection launch's shape: the batch the
    bridge handed `protect_rtp` (`plain`, its rows `stream`), as the table
    buckets it, each part timed on the card against its plain version on
    random keys; the row counts before and after padding, and the bytes
    and operations bound."""
    from libjitsi_tpu_torch.core.packet import bucket_by_size
    from libjitsi_tpu_torch.kernels import aes, sha1
    from libjitsi_tpu_torch.transform.srtp import kernel as sk

    rng = np.random.default_rng(79)
    wb = plain
    n_tab = int(stream.max()) + 1
    tab_rk = torch.as_tensor(aes.expand_keys_batch(
        rng.integers(0, 256, (n_tab, 16), np.uint8))).to(dev)
    tab_mid = torch.as_tensor(sha1.hmac_precompute_batch(
        rng.integers(0, 256, (n_tab, 20), np.uint8)).view(np.int32)).to(dev)
    parts, ms, call_ms, plain_ms, nbytes, ops, err = [], 0.0, 0.0, 0.0, \
        0, 0, 0
    for _rows, part, n_real in bucket_by_size(wb):
        n, width = part.data.shape
        length = np.asarray(part.length)
        args = [tab_rk, tab_mid,
                torch.as_tensor(part.stream.astype(np.int32)).to(dev),
                torch.as_tensor(part.data).to(dev),
                torch.as_tensor(length.astype(np.int32)).to(dev),
                torch.full((n,), HDR, dtype=torch.int32, device=dev),
                torch.as_tensor(rng.integers(0, 256, (n, 16),
                                             np.uint8)).to(dev),
                torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, n)
                                .astype(np.int32)).to(dev)]
        kp = sk.srtp_protect(*args, TAG)
        pp = sk.srtp_protect_plain(*args, TAG)
        err = max(err, max_abs_err(torch, list(kp), list(pp)))
        ms += device_ms(torch, lambda: sk.srtp_protect(*args, TAG), 20,
                        "srtp_protect_cm_kernel")
        call_ms += cuda_ms(torch, lambda: sk.srtp_protect(*args, TAG), 20)
        plain_ms += cuda_ms(torch, lambda: sk.srtp_protect_plain(*args, TAG),
                            2, 1)
        ks_blocks = int(((length - HDR + 15) // 16).sum())
        mac_blocks = int(((length + 4 + 9 + 63) // 64).sum()) + n
        ops += (ks_blocks * (aes_block_ops(10) + CTR_XOR_OPS)
                + mac_blocks * SHA1_BLOCK_OPS)
        keys = len(np.unique(part.stream)) * (11 * 16 + 40)
        nbytes += 2 * n * width + n * (5 * 4 + 16) + keys
        parts.append(dict(rows=n, real_rows=int(n_real), width=width))
    require(err == 0, "kernel C differs from its plain version at the "
                      "projection launch's shape")
    b_ms, b_by = bound(nbytes, ops)
    line = dict(name="srtp_protect_cm", shape=f"projection launch, "
                f"{len(stream)} rows in {len(parts)} parts", parts=parts,
                real_rows=len(stream), padded_rows=sum(p["rows"]
                                                      for p in parts),
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops,
                share_of_bound=b_ms / ms if ms else None)
    emit("kernel_vs_plain", **line)
    return line


def video_check(torch, dev, setup, run, name: str) -> dict:
    """A video cell's gates after its counted run: every datagram taken,
    the NACKed seqs served as RTX, the checks' end state, every datagram
    the bridge sent received by the client; then VIDEO_PROFILED more
    ticks profiled with the host split, and kernel C at the largest
    projection launch's shape."""
    bridge, client, checks = setup["bridge"], setup["client"], \
        setup["checks"]
    nack = run["nack"]
    n_nacked = sum(len(v) for v in checks.nacked.values())
    require(nack["served"] == n_nacked and nack["cache_miss"] == 0
            and nack["retransmitted"] == n_nacked
            and bridge.recovery.rtx_budget_dropped == 0,
            f"{name} NACK service: {nack}, {n_nacked} NACKed")
    require(checks.counts["rtx"] == n_nacked, f"{name}: {checks.counts['rtx']}"
            f" RTX copies checked of {n_nacked}")
    require(int(bridge.rx_table.auth_fail.sum()) == 0
            and int(bridge.rx_table.replay_reject.sum()) == 0,
            f"{name}: the bridge rejected genuine uplink packets")
    final = checks.final(bridge)
    time.sleep(0.2)
    want = setup["log"].sent
    missing = sum((want - setup["got"]).values())
    require(missing == 0 and sum(want.values()) > 0, f"{name}: the client "
            f"did not receive {missing} of {sum(want.values())} datagrams")
    prof = _video_host_split(torch, setup, run["ticks"], VIDEO_PROFILED)
    c_line = _projection_c(torch, dev, *checks.max_rows[1])
    setup["stop"].set()
    setup["thread"].join()
    bridge.close()
    client.close()
    secs = np.array(run["tick_s"])
    out = dict(conferences=setup["confs"], endpoints=client.n,
               ticks=run["ticks"], tick_ms_p50=float(np.median(secs)) * 1e3,
               tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
               tick_ms_max=float(secs.max()) * 1e3,
               ingress_per_tick=run["taken"] / run["ticks"],
               run_s=run["wall_s"], client_wire_s=client.made_s,
               checks_s=run["check_s"],
               copies_per_tick=final["copies"] / run["ticks"],
               forwarded=bridge.forwarded, retransmitted=nack["retransmitted"],
               datagrams_received=sum(want.values()),
               bridge_rcvbuf=setup["rcvbuf"],
               client_rcvbuf=setup["client_rcvbuf"], client=client.stats,
               rows_used=VIDEO_CAPACITY - bridge.registry.free_slots,
               launches={k: v for k, v in run["launches"].items() if v},
               launches_per_tick=run["launches_per_tick"],
               device_idle_share=prof["device_idle_share"],
               profile=prof, projection_c=c_line, **final)
    emit(name, **out)
    return out


def video_hold(torch, dev, kind: str, ticks: int) -> dict:
    """The byte-for-byte hold of a video cell: one conference of 11 on a
    card bridge through `ticks` ticks (the REMBs at tick 0, the changed
    third's at `ticks` - 4, the NACKs at `ticks` - 2), then the same
    bridge with device="cpu" fed the card run's datagrams tick by tick;
    every datagram each sends, tick by tick, equal.  The layer end state
    is not held here (the switch is inside the PLI interval): the full
    cell checks it."""
    cpu = torch.device("cpu")
    client = _VideoClient(torch, dev, kind, 1,
                          seed=81 if kind == "simulcast" else 83)
    card = _video_bridge(torch, dev, client, VIDEO_HOLD_CAPACITY)
    sends = _Sends(card)
    log = _VideoLog(card)
    checks = _VideoChecks(torch, dev, card, client, VIDEO_HOLD_CAPACITY)
    nack = min(VIDEO_NACK_TICK, ticks - 2)
    inputs = []
    for t in range(ticks):
        extra = _video_extra(client, checks, t, ticks)
        sends.on = t
        inputs.append(_video_tick(card, client, t, extra)[2])
        sends.on = None
        checks.tick(*log.take(), keep_recent=t == nack - 1)
    require(card.retransmitted > 0, f"{kind} hold: no RTX served")
    t0 = time.perf_counter()
    host = _video_bridge(torch, cpu, client, VIDEO_HOLD_CAPACITY)
    kept = _Sends(host)
    for t in range(ticks):
        kept.on = t
        _video_tick(host, client, t, replay=inputs[t])
        kept.on = None
        require(kept.ticks.get(t) == sends.ticks.get(t), f"{kind} hold: "
                f"tick {t}'s sends on the card differ from the CPU run's")
    cpu_s = time.perf_counter() - t0
    out = dict(conferences=1, ticks=ticks, equal_ticks=ticks,
               datagrams_compared=sum(len(v) for v in sends.ticks.values()),
               retransmitted=card.retransmitted, cpu_run_s=cpu_s,
               **checks.counts)
    for b in (card, host):
        b.close()
    client.close()
    return out


def _vs_pair(svc, reg_near, reg_far, ssrc: int, seed: int):
    """A VideoMediaStream pair for one SSRC: the sender on `reg_near`,
    the receiver on `reg_far`, SDES-keyed from a seeded generator and
    started."""
    from libjitsi_tpu_torch.control.sdes import SdesControl
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    prof = SrtpProfile.AES_CM_128_HMAC_SHA1_80
    rng = np.random.default_rng(seed)
    near = svc.create_media_stream("video", registry=reg_near, profile=prof,
                                   local_ssrc=ssrc)
    far = svc.create_media_stream("video", registry=reg_far, profile=prof,
                                  local_ssrc=ssrc ^ 0xFFFF)
    for s in (near, far):
        s.sdes = SdesControl(profiles=[prof], rng=rng.bytes)
        s.add_dynamic_rtp_payload_type(96, "VP8", 90000)
    near.sdes.accept_answer(far.sdes.create_answer(near.sdes.create_offer()))
    near.set_remote_ssrc(far.local_ssrc)
    far.set_remote_ssrc(ssrc)
    near.start()
    far.start()
    return near, far


def _vs_frames(vpx_ok: bool):
    """Per layer, a frame source: libvpx encodes of a moving test picture
    at the layer's resolution where libvpx loads (a PLI restarts the
    encoder, whose first frame is a keyframe), else synthetic VP8
    frames of the layer's size, a keyframe on request."""
    from libjitsi_tpu_torch.codecs import vpx

    sizes = [bps // VIDEO_FPS // 8 for _, _, bps in VIDEO_LAYERS]
    pool = np.random.default_rng(89).integers(0, 256, 1 << 16,
                                              np.uint8).tobytes()

    class Source:
        def __init__(self, layer):
            self.layer, self.enc = layer, None
            self.w, self.h, _ = VIDEO_LAYERS[layer]

        def frame(self, f: int, key: bool) -> tuple:
            if not vpx_ok:
                key = key or f == 0
                size = sizes[self.layer] * (VIDEO_KEY_SCALE if key else 1)
                off = (f * 977 + self.layer * 31) % (len(pool) - 50000)
                return (bytes([0x10 if key else 0x11])
                        + pool[off:off + size - 1], key)
            if self.enc is None or key:
                self.enc = vpx.VpxEncoder(self.w, self.h, "vp8")
            y = ((np.add.outer(np.arange(self.h), np.arange(self.w)) * 2
                  + f * 5) % 256).astype(np.uint8)
            u = np.full((self.h // 2, self.w // 2), 90 + f, np.uint8)
            v = np.full((self.h // 2, self.w // 2), 150 - f, np.uint8)
            pkts = self.enc.encode(y, u, v)
            return b"".join(p for p, _ in pkts), any(k for _, k in pkts)

    return [Source(layer) for layer in range(3)]


def video_stream_setup(torch, dev) -> dict:
    """BASELINE config #4: a VideoMediaStream pair per simulcast layer
    (720p30, three SSRCs) on two registries of the card, from the public
    API (`media_service().create_media_stream("video")`), the receiver's
    first stream tracking the layers (`set_simulcast_layers`); with
    libavcodec, an H.264 pair beside them."""
    import libjitsi_tpu_torch
    from libjitsi_tpu_torch.codecs import avcodec, vpx
    from libjitsi_tpu_torch.service.media_stream import StreamRegistry

    svc = libjitsi_tpu_torch.media_service()
    near, far = StreamRegistry(16, device=dev), StreamRegistry(16, device=dev)
    ssrcs = [0x76000000 + 16 * layer for layer in range(3)]
    pairs = [_vs_pair(svc, near, far, s, 91 + i) for i, s in enumerate(ssrcs)]
    pairs[0][1].set_simulcast_layers(ssrcs)
    h264_ok = avcodec.h264_available()
    h264 = _vs_pair(svc, near, far, 0x76000100, 97) if h264_ok else None
    vpx_ok = vpx.vpx_available()
    emit("video_stream_feed", vp8="libvpx encodes" if vpx_ok
         else "synthetic VP8 frames (libvpx not on this host)",
         h264="libx264 encode, libavcodec decode" if h264_ok
         else "no H.264 leg (libavcodec/libx264 not on this host)")
    return dict(pairs=pairs, ssrcs=ssrcs, near=near, far=far, h264=h264,
                vpx_ok=vpx_ok, sources=_vs_frames(vpx_ok))


def _srtcp(stream, blob: bytes):
    """A compound RTCP blob through the stream's registry's SRTCP table."""
    from libjitsi_tpu_torch.core.packet import PacketBatch

    tx, _ = stream.registry.srtp_tables(stream.profile)
    return tx.protect_rtcp(PacketBatch.from_payloads([blob],
                                                     stream=[stream.sid]))


def _unsrtcp(stream, wire) -> bytes:
    from libjitsi_tpu_torch.core.packet import PacketBatch

    _, rx = stream.registry.srtp_tables(stream.profile)
    dec, ok = rx.unprotect_rtcp(PacketBatch(
        wire.data, wire.length, np.full(wire.batch_size, stream.sid,
                                        np.int32)))
    require(bool(np.asarray(ok).all()), "video_stream: an SRTCP packet "
                                        "failed authentication")
    return dec.to_bytes(0)


def video_stream_run(torch, dev, setup) -> dict:
    """One second of config #4 through `send` / `receive` (kernels C and
    D): 30 frames a layer, each layer's frame packetized (`vp8.packetize`,
    1,200-byte payloads) and sent by its pair, the receiver's
    `SimulcastReceiver.ingest` and a `FrameAssembler` a layer on what
    arrives; a PLI (layer 2, frame 10) and a FIR (layer 1, frame 20)
    from the receivers, through SRTCP, make their senders' next frame a
    keyframe; the H.264 pair sends the same second encoded by libx264."""
    from libjitsi_tpu_torch.codecs import avcodec, h264, vp8
    from libjitsi_tpu_torch.rtp import rtcp

    pairs, sources = setup["pairs"], setup["sources"]
    sent = [[] for _ in pairs]
    got = [[] for _ in pairs]
    fas = [vp8.FrameAssembler(max_pending=64) for _ in pairs]
    main = pairs[0][1]
    want_key = [False] * 3
    times, fb, answered = [], [], {}
    h264_out = None

    def frame_time(f: int) -> None:
        t0 = time.perf_counter()
        for layer, (near, far) in enumerate(pairs):
            frame, key = sources[layer].frame(f, want_key[layer])
            if not frame:           # the encoder dropped the frame
                continue
            if want_key[layer]:
                answered[layer] = key
            want_key[layer] = False
            sent[layer].append((frame, key))
            pls = vp8.packetize(frame, picture_id=0x100 + f,
                                max_payload=VIDEO_PAYLOAD)
            wire = near.send(pls, pt=96, ts_step=0,
                             marker=[0] * (len(pls) - 1) + [1])
            near._tx_ts = (near._tx_ts + 3000) & 0xFFFFFFFF
            dec, ok = far.receive(wire)
            require(bool(np.asarray(ok).all()), f"video_stream: layer "
                    f"{layer} frame {f} failed authentication")
            main.simulcast.ingest(dec)
            fas[layer].push_batch(dec)
            got[layer] += fas[layer].pop_frames()
        for layer, use_fir, at in ((2, False, 10), (1, True, 20)):
            if f == at:
                far = pairs[layer][1]
                blob = rtcp.build_compound([far.request_keyframe(use_fir)])
                pkts = pairs[layer][0].handle_rtcp(
                    _unsrtcp(pairs[layer][0], _srtcp(far, blob)))
                kinds = {type(p).__name__ for p in pkts}
                fb.append((layer, sorted(kinds)))
                want_key[layer] = bool({"Pli", "Fir"} & kinds)
        times.append(time.perf_counter() - t0)

    for f in range(VS_FRAMES - VS_PROFILED):
        frame_time(f)
    # the last frame times in one torch.profiler window, the busy share
    # (a window of one 14 ms frame time held no device events on the
    # H100)
    prof = profiled_ticks(torch, lambda _i: [
        frame_time(f) for f in range(VS_FRAMES - VS_PROFILED, VS_FRAMES)],
        1)
    if setup["h264"] is not None:
        near, far = setup["h264"]
        enc = avcodec.H264Encoder(640, 360, fps=VIDEO_FPS)
        dec_v = avcodec.H264Decoder()
        depack = h264.H264Depacketizer()
        n_aus, decoded = 0, []
        for f in range(VS_FRAMES):
            y = ((np.add.outer(np.arange(360), np.arange(640)) + 3 * f)
                 % 256).astype(np.uint8)
            u = np.full((180, 320), 80 + f, np.uint8)
            v = np.full((180, 320), 170 - f, np.uint8)
            for au in enc.encode(y, u, v):
                n_aus += 1
                decoded += _h264_leg(near, far, depack, dec_v, au)
        for au in enc.flush():
            n_aus += 1
            decoded += _h264_leg(near, far, depack, dec_v, au)
        decoded += dec_v.flush()
        h264_out = dict(access_units=n_aus, decoded=len(decoded),
                        shape=list(decoded[0][0].shape) if decoded else None,
                        keyframe_seen=depack.keyframe_seen)
        enc.close()
        dec_v.close()
    return dict(sent=sent, got=got, times=times, feedback=fb,
                answered=answered, vpx=setup["vpx_ok"], profile=prof,
                simulcast=main.simulcast, h264=h264_out,
                stats=[p[1].stats for p in pairs])


def _h264_leg(near, far, depack, dec, au: bytes) -> list:
    """One access unit through the H.264 pair: RFC 6184 payloads sent and
    received (C, D), depacketized and decoded."""
    from libjitsi_tpu_torch.codecs import h264
    from libjitsi_tpu_torch.rtp import header as rtp_header

    pls = h264.packetize(h264.split_annexb(au), mtu=VIDEO_PAYLOAD)
    wire = near.send(pls, pt=100, ts_step=0,
                     marker=[0] * (len(pls) - 1) + [1])
    near._tx_ts = (near._tx_ts + 3000) & 0xFFFFFFFF
    back, ok = far.receive(wire)
    require(bool(np.asarray(ok).all()), "video_stream: an H.264 packet "
                                        "failed authentication")
    off = rtp_header.parse(back).payload_off
    nals = []
    for i in range(back.batch_size):
        nals += depack.push(back.to_bytes(i)[int(off[i]):])
    return dec.decode(b"".join(b"\x00\x00\x00\x01" + n for n in nals))


def _webm_blocks(blob: bytes) -> list:
    """The SimpleBlocks of a WebM file, read back by walking its EBML
    elements: (frame bytes, keyframe flag) in order."""
    def vint(pos, keep_marker=False):
        b = blob[pos]
        n = 8 - b.bit_length() + 1
        v = b if keep_marker else b & ((1 << (8 - n)) - 1)
        for i in range(1, n):
            v = (v << 8) | blob[pos + i]
        return v, pos + n

    out, pos = [], 0
    containers = {0x18538067, 0x1F43B675}          # Segment, Cluster
    while pos < len(blob):
        eid, p = vint(pos, keep_marker=True)
        size, p = vint(p)
        if eid in containers:
            pos = p
            continue
        if eid == 0xA3:                            # SimpleBlock
            body = blob[p:p + size]
            out.append((body[4:], bool(body[3] & 0x80)))
        pos = p + size
    return out


def video_stream_check(torch, dev, run) -> None:
    """Config #4's gates: every frame of every layer assembled equal to the
    one sent, in order; the receiver's SimulcastReceiver counted every
    frame a layer and saw each layer's keyframe; the PLI and the FIR each
    reached its sender and made its next frame a keyframe; the top layer
    written with WebmWriter reads back frame for frame; the H.264 leg
    decoded every access unit."""
    from libjitsi_tpu_torch.recording.webm import WebmWriter

    for layer in range(3):
        frames = [f for f, _ in run["sent"][layer]]
        got = [d for _ts, _pid, _key, d in run["got"][layer]]
        same = sum(a == b for a, b in zip(got, frames))
        require(got == frames, f"video_stream: layer {layer} assembled "
                f"{len(got)} frames, {same} equal, of {len(frames)} sent")
        keys = [k for _, _, k, _ in run["got"][layer]]
        require(keys == [k for _, k in run["sent"][layer]],
                f"video_stream: layer {layer}'s keyframe flags differ")
    sim = run["simulcast"]
    require(sim.frames.tolist() == [len(s) for s in run["sent"]]
            and bool(sim.keyframe_seen.all()),
            f"video_stream: SimulcastReceiver counted {sim.frames.tolist()}")
    require(run["feedback"] == [(2, ["Pli"]), (1, ["Fir"])],
            f"video_stream: feedback {run['feedback']}")
    require(run["answered"] == {2: True, 1: True},
            f"video_stream: the frames after the PLI and the FIR were "
            f"keyframes: {run['answered']}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "layer2.webm")
        w = WebmWriter(path, width=1280, height=720)
        for ts, _pid, key, data in run["got"][2]:
            w.write_frame(data, (ts - run["got"][2][0][0]) // 90, key)
        w.close()
        with open(path, "rb") as fh:
            blocks = _webm_blocks(fh.read())
    require(blocks == [(d, k) for _ts, _pid, k, d in run["got"][2]],
            "video_stream: the WebM file does not read back frame for frame")
    h = run["h264"]
    if h is not None:
        require(h["decoded"] == h["access_units"] == VS_FRAMES
                and h["shape"] == [360, 640] and h["keyframe_seen"],
                f"video_stream: the H.264 leg {h}")
    times = np.array(run["times"]) * 1e3
    emit("video_stream", frames_per_layer=VS_FRAMES,
         layers=[f"{w}x{h_}" for w, h_, _ in VIDEO_LAYERS],
         frame_bytes=[int(np.mean([len(f) for f, _ in s]))
                      for s in run["sent"]],
         frames_sent=[len(s) for s in run["sent"]],
         packets_received=[st["rx_packets"] for st in run["stats"]],
         frame_ms_p50=float(np.median(times)),
         frame_ms_p99=float(np.percentile(times, 99)),
         simulcast_frames=sim.frames.tolist(),
         keyframes=[sum(k for _, k in s) for s in run["sent"]],
         feedback=run["feedback"], webm_blocks=len(blocks), h264=h,
         vp8_source="libvpx" if run["vpx"] else "synthetic",
         device_idle_share=run["profile"]["device_idle_share"],
         profile=run["profile"])


# ------------------------------------------------ the operations plane

def _same(a, b) -> bool:
    """Deep equality of two snapshots (dicts, sequences, arrays)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype \
            and bool(np.array_equal(a, b))
    return a == b


def _same_restored(restored: dict, snap: dict) -> bool:
    """An SfuBridge snapshot taken right after `restore` against the one
    it rose from: every field equal (the SRTP tables' ROC and replay
    windows included), except the per-row BWE state, its fed mask and
    the latched addresses, which `restore` copies onto the endpoints'
    rows only (other rows come back reset): those compare on the
    endpoints' rows."""
    rows = sorted(snap["ssrc_of"])
    per_row = ("bwe", "bwe_fed", "addr_ip", "addr_port")

    def rowwise(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(rowwise(a[k], b[k])
                                                for k in a)
        a, b = np.asarray(a), np.asarray(b)
        if a.ndim and a.shape[0] == snap["capacity"]:
            return _same(a[rows], b[rows])
        return _same(a, b)

    return (restored.keys() == snap.keys()
            and all(rowwise(restored[k], snap[k]) if k in per_row
                    else _same(restored[k], snap[k]) for k in snap))


def _lifecycle_wire(torch, dev, profile: str, n: int, ticks: int, seed: int,
                    rr_tick: int = -1) -> dict:
    """Keys, SSRCs and every tick's wire of `n` SDES endpoints under
    `profile` (made on the card's tables, before any count): one
    Opus-sized packet an endpoint a tick with an abs-send-time extension,
    and at `rr_tick` an RR from each."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.rtp import rtcp
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    rng = np.random.default_rng(seed)
    salt = SrtpProfile[profile].master_salt_len
    keys = {d: (rng.integers(0, 256, (n, 16), np.uint8),
                rng.integers(0, 256, (n, salt), np.uint8))
            for d in ("rx", "tx")}
    ssrc = (0x61000000 + (seed << 20)
            + rng.permutation(1 << 20)[:n]).astype(np.int64)
    seq0 = rng.integers(0, 1 << 16, n)
    seq0[::9] = 65536 - 6                     # these wrap within the run
    up = SrtpStreamTable(n, SrtpProfile[profile], device=dev)
    up.add_streams(np.arange(n), *keys["rx"])
    data, length, pay, plen = [], [], [], []
    for t in range(ticks):
        lens = rng.integers(60, 161, n)
        pl = [rng.integers(0, 256, int(k), np.uint8).tobytes()
              for k in lens]
        ast = int(round((1000.0 + 0.02 * t) * (1 << 18))) & 0xFFFFFF
        ext = (0xBEDE, bytes([0x32]) + ast.to_bytes(3, "big"))
        plain = rtp_header.build(pl, (seq0 + t) & 0xFFFF, t * 960,
                                 ssrc.tolist(), 111, ext=[ext] * n,
                                 stream=list(range(n)))
        w = up.protect_rtp(plain)
        data.append(w.data[:, :224].copy())
        length.append(np.asarray(w.length).copy())
        pp = np.zeros((n, 160), np.uint8)
        for k, p in enumerate(pl):
            pp[k, :len(p)] = np.frombuffer(p, np.uint8)
        pay.append(pp)
        plen.append(lens)
    out = dict(rx_key=keys["rx"][0], rx_salt=keys["rx"][1],
               tx_key=keys["tx"][0], tx_salt=keys["tx"][1], ssrc=ssrc,
               seq0=seq0, data=np.stack(data), length=np.stack(length),
               pay=np.stack(pay), plen=np.stack(plen))
    if rr_tick >= 0:
        blobs = [rtcp.build_compound([rtcp.build_rr(rtcp.ReceiverReport(
            int(ssrc[k]), [rtcp.ReportBlock(
                int(ssrc[(k + 1) % n]), 0, 0, int(seq0[(k + 1) % n]
                                                  + rr_tick), 4, 0, 0)]))])
            for k in range(n)]
        rr = up.protect_rtcp(PacketBatch.from_payloads(
            blobs, stream=list(range(n))))
        out.update(rr_data=rr.data[:, :128].copy(),
                   rr_length=np.asarray(rr.length).copy())
    return out


def sfu_lifecycle_setup(torch, dev, wire_dir: str) -> str:
    """The clients' wire of the sfu_lifecycle path, made on the card in
    this process and written for the child: the 1,089 SDES endpoints
    and the churn's pool of 64 under AES-CM (LC_TICKS ticks, an RR at
    LC_RR_TICK), and 1,100 endpoints under AEAD-GCM (LC_GCM_TICKS).
    Returns the file."""
    cm = _lifecycle_wire(torch, dev, "AES_CM_128_HMAC_SHA1_80",
                         LC_SDES + LC_POOL, LC_TICKS + 1, 1, LC_RR_TICK)
    gcm = _lifecycle_wire(torch, dev, GCM, SFU_N, LC_GCM_TICKS, 2)
    path = os.path.join(wire_dir, "lifecycle_wire.npz")
    np.savez(path, **{f"cm_{k}": v for k, v in cm.items()},
             **{f"gcm_{k}": v for k, v in gcm.items()})
    return path


def sfu_lifecycle_run(torch, dev) -> dict:
    """The sfu_lifecycle path: the wire made here, then a child process
    of this script (`--lifecycle-child`) drives the supervised bridge
    with its launch counts set to 0 before its first join; its lines are
    relayed, and its last one carries the counts and the summary.  Fails
    when the child fails."""
    with tempfile.TemporaryDirectory() as wire_dir:
        wire = sfu_lifecycle_setup(torch, dev, wire_dir)
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--lifecycle-child", wire], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        last = None
        try:
            for line in proc.stdout:
                if line.startswith('{"lifecycle_child":'):
                    last = json.loads(line)["lifecycle_child"]
                    continue
                print(line.rstrip("\n"), flush=True)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    require(rc == 0 and last is not None,
            f"sfu_lifecycle: the child process failed (rc {rc})")
    return last


class _LcClients:
    """The SDES endpoints' side of the sfu_lifecycle run: one client
    socket for all (drained by a thread), the card-made wire of every
    tick, and which endpoints send (committed and not left)."""

    def __init__(self, w: dict, prefix: str):
        import threading

        from libjitsi_tpu_torch.io.udp import UdpEngine

        self.w = {k[len(prefix):]: w[k] for k in w.files
                  if k.startswith(prefix)}
        self.n = len(self.w["ssrc"])
        self.idx_of = {int(s): k for k, s in enumerate(self.w["ssrc"])}
        self.engine = UdpEngine(port=0, bind_ip="127.0.0.1",
                                max_batch=4096, rcvbuf=64 << 20)
        self.got, self._stop = [], threading.Event()
        self._th = threading.Thread(target=self._drain, daemon=True)
        self._th.start()

    def _drain(self):
        while not self._stop.is_set():
            b, _, _ = self.engine.recv_batch(timeout_ms=5)
            self.got.extend(b.to_payloads())

    def keys(self, k: int):
        w = self.w
        return ((w["rx_key"][k].tobytes(), w["rx_salt"][k].tobytes()),
                (w["tx_key"][k].tobytes(), w["tx_salt"][k].tobytes()))

    def batch(self, j, rows, rr: bool = False):
        """Packet number `j` (a scalar or one a row) of each endpoint in
        `rows`, or their RRs: an endpoint's packets are numbered from its
        first send, so a late joiner starts at its seq0, ROC 0."""
        from libjitsi_tpu_torch.core.packet import PacketBatch

        rows = np.asarray(rows, np.int64)
        if rr:
            d, ln = self.w["rr_data"][rows], self.w["rr_length"][rows]
        else:
            j = np.broadcast_to(np.asarray(j, np.int64), rows.shape)
            d, ln = self.w["data"][j, rows], self.w["length"][j, rows]
        return PacketBatch(d, ln, np.zeros(len(rows), np.int32))

    def close(self):
        time.sleep(0.05)
        self._stop.set()
        self._th.join()
        self.engine.close()


def _lc_logged(bridge, log: list) -> None:
    """Log every fan-out the bridge emits as (rows, lengths, each copy's
    leg SSRC): legs are named by SSRC, since the churn recycles rows."""
    emit_fanout = bridge._emit_fanout

    def logged(wire, recv, origin=None):
        ready = np.nonzero(bridge.loop.addr_port[recv] != 0)[0]
        legs = np.array([bridge._ssrc_of.get(int(r), -1)
                         for r in recv[ready]], np.int64)
        log.append((wire.data[ready], np.asarray(wire.length)[ready],
                    legs))
        return emit_fanout(wire, recv, origin=origin)

    bridge._emit_fanout = logged


def _lc_count_ticks(bridge, into: dict) -> None:
    """Add the launches made inside the bridge's ticks into `into`: the
    rest of a lifecycle run's launches are off-tick (the warm-ups, the
    keystream fill between ticks, `emit_feedback`)."""
    from libjitsi_tpu_torch.kernels import build as kbuild

    tick = bridge.tick

    def counted(*args, **kw):
        before = dict(kbuild.launches)
        try:
            return tick(*args, **kw)
        finally:
            for k, v in kbuild.launches.items():
                into[k] = into.get(k, 0) + v - before[k]

    bridge.tick = counted


def _lc_supervise(bridge, cfg, lcfg, registry=None, sup=None,
                  journey_budget_s=None):
    """Wire a bridge's operations plane as a user does: supervisor, SLO
    engine (`default_slos`, its journey budget `journey_budget_s` where
    given), lifecycle manager and capacity model on the bridge's
    registry (`sup` a recovered supervisor to attach to)."""
    from libjitsi_tpu_torch.service.lifecycle import StreamLifecycleManager
    from libjitsi_tpu_torch.service.supervisor import BridgeSupervisor
    from libjitsi_tpu_torch.utils.capacity import CapacityModel
    from libjitsi_tpu_torch.utils.slo import SloEngine, default_slos

    reg = bridge.loop.metrics if registry is None else registry
    slo = SloEngine(reg, default_slos() if journey_budget_s is None
                    else default_slos(journey_budget_s))
    if sup is None:
        sup = BridgeSupervisor(bridge, cfg, metrics=reg, slo=slo)
    else:
        # a recovered plane's engine starts from the restored counters:
        # `restore` brings back the per-stream ones (auth failures
        # included) while the loop's histograms start empty, so a fresh
        # engine's first window would count the whole run's failures
        # against one tick's datagrams (the JAX engine reads the same)
        for spec in slo.specs:
            cum = slo._read(spec)
            if cum is not None:
                slo._last[spec.name] = cum
        slo.flight = sup.flight
        sup.slo = slo
        sup.register_metrics(reg)
    lc = StreamLifecycleManager(bridge, supervisor=sup, config=lcfg,
                                metrics=reg)
    CapacityModel().attach(sup, registry=reg)
    return sup, lc


def _lc_scope(bridge, conf_of: dict) -> None:
    """Scope each staged row to its endpoint's conference before the
    commit barrier flips it live.  Without placement the lifecycle plane
    stages joins without a conference, as the JAX plane does (placement
    is ROADMAP Queue 1 item 12), so the caller scopes them with the
    port's `SfuBridge.set_conference`."""
    for sid in list(bridge._staged):
        if sid not in bridge._conf_of:
            bridge.set_conference(sid, conf_of[bridge._ssrc_of[sid]])


def _lc_tick(sup, sends, now: float, pump=None) -> tuple:
    """One 20 ms tick of input: each (client, batch) sent in turn and the
    supervised bridge ticked until it has taken it (at least one tick).
    Returns (seconds, datagrams taken, supervised ticks)."""
    secs, taken, n = 0.0, 0, 0
    for client, batch in sends or [(None, None)]:
        want = 0
        if batch is not None and batch.batch_size:
            client.send_batch(batch, "127.0.0.1", sup.bridge.port)
            want = batch.batch_size
        got = 0
        for _ in range(400):
            t0 = time.perf_counter()
            got += sup.tick(now=now)["rx"]
            secs += time.perf_counter() - t0
            n += 1
            if pump is not None:
                pump()
            if got >= want:
                break
        require(got >= want, f"lifecycle: the bridge took {got} of {want}")
        taken += got
    return secs, taken, n


def _lc_dtls_join(bridge, lc, socks, kind, ssrc) -> dict:
    """The DTLS conference's 11 joins through `request_handshake` over
    loopback (the bridge as server, each peer on its own socket)."""
    peers = {}
    for k, s in enumerate(ssrc):
        peer = kind("client")
        ok, why, _retry = lc.request_handshake(
            int(s), role="server", remote_fingerprint=peer.local_fingerprint,
            remote_addr=socks.addr(k))
        require(ok, f"lifecycle: DTLS join {k} refused: {why}")
        sid = next(x for x, v in bridge._ssrc_of.items() if v == int(s))
        peer.remote_fingerprint = bridge._dtls.pending[sid] \
            .local_fingerprint
        peers[k] = peer
        socks.send(k, peer.handshake_packets(), bridge.port)
    return peers


def _lc_pump(socks, peers, port: int, media: dict) -> None:
    """The DTLS peers' side between ticks: feed handshake datagrams,
    send their replies, keep media copies (first byte 0x80-0xBF)."""
    for k, peer in peers.items():
        out = []
        for d in socks.recv(k):
            if 128 <= d[0] < 192:
                media.setdefault(k, []).append(d)
            elif not peer.complete:
                out += peer.feed(d)
        if out:
            socks.send(k, out, port)


def _lc_check_copies(torch, dev, setups, received, log, profile: str,
                     ticks: int) -> dict:
    """Every unique media copy the SDES client received: its leg (from
    the fan-out log, by seq, SSRC and tag), authenticated under the
    leg's key in a card table with a row per (leg, sender), and its
    payload what the sender sent.  `setups` maps an endpoint index's
    SSRC to its (keys, seq0, payloads) through `_LcClients`; copies of
    the DTLS conference are checked by `_lc_check_dtls`.  No copy may
    cross a conference (`conf_of` by SSRC) or echo."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile

    cl, conf_of = setups
    leg_of, cross, echo = {}, 0, 0
    for data, length, legs in log:
        snd = (data[:, 8].astype(np.int64) << 24 | data[:, 9].astype(
            np.int64) << 16 | data[:, 10].astype(np.int64) << 8
            | data[:, 11].astype(np.int64))
        for i in range(len(legs)):
            cross += int(conf_of.get(int(snd[i])) != conf_of.get(
                int(legs[i])))
            echo += int(snd[i] == legs[i])
            pkt = data[i, :length[i]].tobytes()
            leg_of[pkt[2:4] + pkt[8:12] + pkt[-TAG:]] = int(legs[i])
    uniq = list(dict.fromkeys(p for p in received
                              if not 192 <= p[1] <= 223))
    pairs, streams, unknown = {}, [], 0
    for p in uniq:
        leg = leg_of.get(p[2:4] + p[8:12] + p[-TAG:])
        snd = int.from_bytes(p[8:12], "big")
        if leg is None or leg not in cl.idx_of:
            unknown += 1
            streams.append(-1)
            continue
        streams.append(pairs.setdefault((cl.idx_of[leg], snd), len(pairs)))
    require(unknown == 0, f"lifecycle: {unknown} received copies the "
                          "bridge never fanned out")
    down = SrtpStreamTable(max(1, len(pairs)), SrtpProfile[profile],
                           device=dev)
    legs = np.array([leg for leg, _s in pairs], np.int64)
    if len(pairs):
        down.add_streams(np.arange(len(pairs)), cl.w["tx_key"][legs],
                         cl.w["tx_salt"][legs])
    batch = PacketBatch.from_payloads(uniq, capacity=224,
                                      stream=streams)
    # a leg that joined after its sender's seq wrapped first hears it at
    # ROC 1: each row starts just below its first copy's index (the
    # sender's seq0 + tick), as a receiver's context learns it
    first = {}
    for i, row in enumerate(streams):
        first.setdefault(row, i)
    hdr0 = rtp_header.parse(batch)
    for row, i in first.items():
        k = cl.idx_of[int(hdr0.ssrc[i])]
        t = (int(hdr0.seq[i]) - int(cl.w["seq0"][k])) & 0xFFFF
        down.rx_max[row] = int(cl.w["seq0"][k]) + t - 1
    authed = 0
    step = 8192
    for lo in range(0, batch.batch_size, step):      # in arrival order
        part = PacketBatch(batch.data[lo:lo + step],
                           batch.length[lo:lo + step],
                           batch.stream[lo:lo + step])
        dec, ok = down.unprotect_rtp(part)
        bad = [(int(legs[part.stream[i]]), int.from_bytes(
            part.to_bytes(int(i))[8:12], "big"), int.from_bytes(
            part.to_bytes(int(i))[2:4], "big"))
            for i in np.nonzero(~ok)[0][:6]]
        require(ok.all(), f"lifecycle: {int((~ok).sum())} received copies "
                          "failed authentication under their leg's key "
                          f"(leg, sender SSRC, seq: {bad})")
        authed += int(ok.sum())
        dh = rtp_header.parse(dec)
        k = np.array([cl.idx_of[int(s)] for s in dh.ssrc], np.int64)
        t = (dh.seq.astype(np.int64) - cl.w["seq0"][k]) & 0xFFFF
        require(bool((t < ticks).all()), "lifecycle: a copy's seq is not "
                                         "its sender's")
        n_pay = np.asarray(dec.length) - HDR - 8
        body = dec.data[:, HDR + 8:HDR + 8 + 160]
        body = np.where(np.arange(160)[None, :] < n_pay[:, None], body, 0)
        require(bool((n_pay == cl.w["plen"][t, k]).all()
                     and (body == cl.w["pay"][t, k]).all()),
                "lifecycle: a decrypted copy differs from what its sender "
                "sent")
    # every copy authenticated: an endpoint is heard as a leg and as a
    # sender where some copy to it and some copy of it arrived
    heard = ({leg for leg, _s in pairs}
             & {cl.idx_of[snd] for _l, snd in pairs if snd in cl.idx_of})
    return dict(copies_received=len(uniq), copies_authenticated=authed,
                cross_conference=cross, self_echo=echo,
                copies_logged=sum(len(x[2]) for x in log), heard=heard)


def _lc_check_dtls(peers, media: dict, conf_ssrcs: dict) -> int:
    """Every media copy a DTLS peer received opens under the keys its
    own handshake exported (a CPU table a peer, a row per sender), and
    comes from its conference.  Returns the copies."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable

    total = 0
    for k, pkts in media.items():
        prof, _tk, _ts, rk, rs = peers[k].srtp_keys()
        senders = sorted({int.from_bytes(p[8:12], "big") for p in pkts})
        require(set(senders) <= conf_ssrcs[k], "lifecycle: a DTLS leg "
                                               "heard another conference")
        row = {s: i for i, s in enumerate(senders)}
        tab = SrtpStreamTable(len(senders), prof, device="cpu")
        for i in range(len(senders)):
            tab.add_stream(i, rk, rs)
        pkts = list(dict.fromkeys(pkts))
        b = PacketBatch.from_payloads(pkts, capacity=224, stream=[
            row[int.from_bytes(p[8:12], "big")] for p in pkts])
        _dec, ok = tab.unprotect_rtp(b)
        require(bool(ok.all()), f"lifecycle: DTLS leg {k}: "
                                f"{int((~ok).sum())} copies failed "
                                "authentication")
        total += len(pkts)
    return total


def lifecycle_child(torch, dev, wire_path: str) -> int:
    """The sfu_lifecycle path, run alone in this process (see
    `sfu_lifecycle_run`).  Its last line carries the counts."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.kernels import build as kbuild
    from libjitsi_tpu_torch.rtp import header as rtp_header
    from libjitsi_tpu_torch.service.lifecycle import LifecycleConfig
    from libjitsi_tpu_torch.service.obs_server import ObservabilityServer
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
    from libjitsi_tpu_torch.service.supervisor import (BridgeSupervisor,
                                                       SupervisorConfig)
    from libjitsi_tpu_torch.transform.srtp.context import SrtpStreamTable
    from libjitsi_tpu_torch.transform.srtp.policy import SrtpProfile
    from libjitsi_tpu_torch.utils.compile_cache import compile_stats
    from libjitsi_tpu_torch.utils.faults import ChurnModel
    from libjitsi_tpu_torch.utils.metrics import validate_exposition

    kbuild.library()
    w = np.load(wire_path)
    kind, kind_name = _dtls_kind()
    cl = _LcClients(w, "cm_")
    rng = np.random.default_rng(37)
    dtls_ssrc = 0x7D000000 + np.arange(SFU_SIZE)
    conf_of = {int(cl.w["ssrc"][k]): k // SFU_SIZE for k in range(LC_SDES)}
    conf_of.update({int(cl.w["ssrc"][LC_SDES + j]): j % LC_DTLS_CONF
                    for j in range(LC_POOL)})
    conf_of.update({int(s): LC_DTLS_CONF for s in dtls_ssrc})
    ckpt_dir = tempfile.mkdtemp()
    cfg = SupervisorConfig(deadline_ms=LC_DEADLINE_MS, quarantine_window=50,
                           quarantine_auth_threshold=LC_FORGED,
                           quarantine_backoff_ticks=8,
                           checkpoint_path=os.path.join(ckpt_dir, "ckpt"))
    lcfg = LifecycleConfig(install_batch=LC_WAVE, max_pending=4096)
    bridge = SfuBridge(capacity=LC_CAPACITY, device=dev)
    bridge._dtls.endpoint_factory = kind
    sup, lc = _lc_supervise(bridge, cfg, lcfg,
                            journey_budget_s=LC_JOURNEY_BUDGET_S)
    tick_launches: dict = {}
    _lc_count_ticks(bridge, tick_launches)
    obs = ObservabilityServer(bridge.loop.metrics, supervisor=sup).start()
    log: list = []
    _lc_logged(bridge, log)
    socks = _Socks(SFU_SIZE)
    cm = ChurnModel(**LC_CHURN)
    kbuild.reset_counts()
    compile0 = compile_stats().compile_events
    # ---- the counted run: joins, churn, forgeries, checkpoint, recover
    t_join = time.perf_counter()
    for k in range(LC_SDES):
        rk, tk = cl.keys(k)
        ok, why = lc.request_join(int(cl.w["ssrc"][k]), rk, tk,
                                  conference=k // SFU_SIZE)
        require(ok, f"lifecycle: join {k} refused: {why}")
    peers = _lc_dtls_join(bridge, lc, socks, kind, dtls_ssrc)
    media, dtls_live, dtls_wire = {}, {}, {}
    pool_next, joined, left = 0, set(range(LC_SDES)), set()
    sent_n = np.zeros(cl.n, np.int64)         # packets each endpoint sent
    live_at = None
    ever_live: set = set()
    base_ssrcs = {int(s) for s in cl.w["ssrc"][:LC_SDES]} | {
        int(s) for s in dtls_ssrc}
    dtls_tabs = {}
    tick_s, sup_ticks, ckpt = [], 0, {}
    lcs = [lc]

    def pump():
        _lc_scope(sup.bridge, conf_of)
        _lc_pump(socks, peers, sup.bridge.port, media)

    for t in range(LC_TICKS):
        now = 1000.0 + 0.02 * t
        if t == LC_CKPT_TICK:
            t0 = time.perf_counter()
            path = sup.save_checkpoint()
            ckpt["save_s"] = time.perf_counter() - t0
            blob = BridgeSupervisor.load_checkpoint(path)
            sup.bridge.close()
            t0 = time.perf_counter()
            sup = BridgeSupervisor.recover(path, SfuBridge, port=0,
                                           device=dev,
                                           supervisor_config=cfg)
            ckpt["recover_s"] = time.perf_counter() - t0
            ckpt["equal"] = _same_restored(sup.bridge.snapshot(),
                                           blob["snap"])
            require(ckpt["equal"], "lifecycle: the recovered bridge's "
                                   "snapshot differs from the checkpoint's")
            sup.bridge._dtls.endpoint_factory = kind
            sup, lc2 = _lc_supervise(sup.bridge, None, lcfg, sup=sup,
                                     journey_budget_s=LC_JOURNEY_BUDGET_S)
            _lc_count_ticks(sup.bridge, tick_launches)
            ckpt["equal_after_reconcile"] = _same_restored(
                sup.bridge.snapshot(), blob["snap"])
            lcs.append(lc2)
            lc = lc2
            obs.supervisor, obs.metrics = sup, sup.bridge.loop.metrics
            _lc_logged(sup.bridge, log)
        b = sup.bridge
        if t >= LC_CHURN_FROM:
            joins, leaves = cm.step(0.02, now, len(joined - left))
            for _ in range(joins):
                if pool_next < LC_POOL:
                    k = LC_SDES + pool_next
                    pool_next += 1
                    rk, tk = cl.keys(k)
                    if lc.request_join(int(cl.w["ssrc"][k]), rk, tk,
                                       conference=(k - LC_SDES)
                                       % LC_DTLS_CONF)[0]:
                        joined.add(k)
            live = sorted(k for k in joined - left if k != LC_TAMPERED)
            for k in rng.permutation(live)[:leaves]:
                if lc.request_leave(ssrc=int(cl.w["ssrc"][k])):
                    left.add(int(k))
        committed = {v for s, v in b._ssrc_of.items() if s not in b._staged}
        rows = [k for k in sorted(joined - left)
                if int(cl.w["ssrc"][k]) in committed]
        ever_live |= committed
        gone = {int(cl.w["ssrc"][k]) for k in left}
        if live_at is None and base_ssrcs - gone <= ever_live:
            live_at = time.perf_counter() - t_join
        sends = [(cl.engine, cl.batch(sent_n[part], part))
                 for part in np.array_split(rows, SFU_BURSTS) if len(part)]
        if LC_TAMPER[0] <= t < LC_TAMPER[1] and LC_TAMPERED in rows:
            # the sender's next packet, its tag flipped: never seen, so
            # it fails authentication (a seen one would fail replay)
            forged = cl.batch(sent_n[LC_TAMPERED] + 1,
                              [LC_TAMPERED] * LC_FORGED)
            ln = np.asarray(forged.length)
            forged.data[np.arange(LC_FORGED), ln - 1] ^= 0x5A
            sends.append((cl.engine, forged))
        if t == LC_RR_TICK:
            rr_rows = [k for k in rows if k < LC_SDES]
            sends.append((cl.engine, cl.batch(0, rr_rows, rr=True)))
        sent_n[rows] += 1
        for k, peer in peers.items():
            if not peer.complete:
                continue
            sid = b._sid_of_ssrc(int(dtls_ssrc[k]))
            if sid is None or sid in b._staged:
                continue
            if k not in dtls_tabs:
                prof, tk_, ts_, _rk, _rs = peer.srtp_keys()
                dtls_tabs[k] = SrtpStreamTable(1, prof, device="cpu")
                dtls_tabs[k].add_stream(0, tk_, ts_)
                dtls_live[k] = t
            with _Uncounted(kbuild):
                pl = [bytes([k, t]) * 40]
                wire = dtls_tabs[k].protect_rtp(rtp_header.build(
                    pl, [100 + t], [t * 960], [int(dtls_ssrc[k])], 111,
                    stream=[0]))
            socks.send(k, wire.to_payloads(), b.port)
            dtls_wire[k] = dtls_wire.get(k, 0) + 1
        secs, _taken, n = _lc_tick(sup, sends, now, pump)
        tick_s.append(secs)
        sup_ticks += n
        if t % LC_FEEDBACK == LC_FEEDBACK - 1:
            b.emit_feedback(now=now + 0.01)
    # ---- then the same plane under GCM with the keystream cache
    g = _LcClients(w, "gcm_")
    gb = SfuBridge(capacity=LC_CAPACITY, profile=SrtpProfile[GCM],
                   device=dev)
    caches = [tab.enable_keystream_cache(**LC_GCM_CACHE)
              for tab in (gb.rx_table, gb.tx_table)]
    gsup, glc = _lc_supervise(gb, SupervisorConfig(
        deadline_ms=LC_DEADLINE_MS), LifecycleConfig(install_batch=SFU_N,
                                                     max_pending=4096))
    _lc_count_ticks(gb, tick_launches)
    glog: list = []
    _lc_logged(gb, glog)
    for k in range(SFU_N):
        rk, tk = g.keys(k)
        require(glc.request_join(int(g.w["ssrc"][k]), rk, tk,
                                 conference=k // SFU_SIZE)[0],
                "lifecycle: a GCM join was refused")
    g_conf = {int(s): k // SFU_SIZE for k, s in enumerate(g.w["ssrc"])}
    for _ in range(2):                       # stage, then commit
        gsup.tick(now=2000.0)
        _lc_scope(gb, g_conf)
    fill0 = sum(c.filled_slots for c in caches)
    gtick_s = []
    for t in range(LC_GCM_TICKS):
        sends = [(g.engine, g.batch(t, part)) for part in
                 np.array_split(np.arange(SFU_N), SFU_BURSTS)]
        gtick_s.append(_lc_tick(gsup, sends, 2000.02 + 0.02 * t,
                                lambda: _lc_scope(gb, g_conf))[0])
    launches = dict(kbuild.launches)
    plain = dict(kbuild.plain_calls)
    instances = dict(kbuild.instance_launches)
    # ---- the checks, outside the counts
    # the stock journey budget (20 ms) burns fast at this host's tick: a
    # join offered now is refused, typed
    late = glc.request_join(0x7E000000, *g.keys(0), conference=0)
    require(late == (False, "fast_burn"), f"lifecycle: under "
            f"default_slos() a join after the GCM ticks gave {late}, not "
            "a typed fast_burn refusal")
    for one in lcs + [glc]:
        one.assert_datapath_clean()
        require(one.tick_thread_handshake_feeds == 0,
                "lifecycle: an OpenSSL feed ran on the tick thread")
    require(len(dtls_live) == SFU_SIZE, f"lifecycle: {len(dtls_live)} of "
                                        f"{SFU_SIZE} DTLS joins went live")
    for _ in range(20):
        pump()
        time.sleep(0.01)
    cl.close()
    g.close()
    with _Uncounted(kbuild):
        counts = _lc_check_copies(torch, dev, (cl, conf_of), cl.got, log,
                                  "AES_CM_128_HMAC_SHA1_80", LC_TICKS)
        gcounts = _lc_check_copies(torch, dev, (g, g_conf), g.got, glog,
                                   GCM, LC_GCM_TICKS)
        conf_ssrcs = {k: {int(s) for s in dtls_ssrc} - {int(dtls_ssrc[k])}
                      for k in peers}
        dtls_copies = _lc_check_dtls(peers, media, conf_ssrcs)
    require(counts["cross_conference"] == counts["self_echo"] == 0
            and gcounts["cross_conference"] == gcounts["self_echo"] == 0,
            f"lifecycle: copies crossed a conference or echoed: {counts}")
    require(counts["copies_received"] > 0 and gcounts["copies_received"]
            > 0 and dtls_copies > 0, "lifecycle: no media was forwarded")
    heard = counts.pop("heard")
    gcounts.pop("heard")
    churn_in = sorted(k for k in joined if k >= LC_SDES)
    churn_live = [k for k in churn_in if int(cl.w["ssrc"][k]) in ever_live]
    churn_heard = [k for k in churn_live if k in heard]
    require(len(churn_heard) >= LC_CHURN_MIN, f"lifecycle: of "
            f"{cm.joins_offered} churn joins offered, {len(churn_in)} "
            f"admitted, {len(churn_live)} went live and {len(churn_heard)} "
            f"were heard both ways, fewer than {LC_CHURN_MIN} "
            f"(refusals {[x.admit_rejected for x in lcs]})")
    events = []
    for one_sup in (lcs[0].supervisor, sup):
        d = one_sup.flight.dump_all()
        for evs in d["streams"].values():
            events += [e for e in evs if e["kind"].startswith("quarantine")]
    convicted = {e["sid"] for e in events if e["kind"] == "quarantine"}
    released = {e["sid"] for e in events if e["kind"] == "quarantine_release"}
    tampered_sid = lcs[0].bridge._sid_of_ssrc(
        int(cl.w["ssrc"][LC_TAMPERED]))
    require(convicted == released == {tampered_sid},
            f"lifecycle: quarantine convicted {convicted} and released "
            f"{released}, not the forging sender {tampered_sid} alone")
    require(not sup.health()["quarantined"], "lifecycle: a sender is still "
                                             "quarantined at the end")
    import urllib.request

    scrape = {}
    for om in (False, True):
        req = urllib.request.Request(
            f"http://127.0.0.1:{obs.port}/metrics", headers={
                "Accept": "application/openmetrics-text"} if om else {})
        with urllib.request.urlopen(req, timeout=10) as r:
            text = r.read().decode()
        errs = validate_exposition(text, openmetrics=om)
        require(errs == [], f"lifecycle: /metrics (om={om}): {errs[:3]}")
        scrape["openmetrics" if om else "text"] = len(text)
    with urllib.request.urlopen(f"http://127.0.0.1:{obs.port}/healthz",
                                timeout=10) as r:
        require(r.status == 200, "lifecycle: /healthz did not answer 200")
        health = json.loads(r.read())
    with urllib.request.urlopen(
            f"http://127.0.0.1:{obs.port}/debug/device", timeout=10) as r:
        device_doc = json.loads(r.read())["devices"]
    require(device_doc and device_doc[0]["device"] == str(sup.bridge.device)
            and device_doc[0]["bytes_in_use"] > 0,
            f"lifecycle: /debug/device: {device_doc}")
    obs.stop()
    hits = sum(c.hits for c in caches)
    ran = launches if dev.type == "cuda" else plain   # a CPU rehearsal
    require(ran.get("gcm_ks_fill", 0) > 0 and hits > 0,
            "lifecycle: the GCM keystream cache was not filled between "
            "ticks and hit")
    secs = np.array(tick_s)
    attribution = sup.phase_attribution()
    emit("sfu_lifecycle", conferences=SFU_CONFS, endpoints=SFU_N,
         sdes=LC_SDES, dtls=SFU_SIZE, dtls_endpoint=kind_name,
         ticks=LC_TICKS, supervised_ticks=sup_ticks,
         install_wave=LC_WAVE, admits=sum(x.admits for x in lcs),
         evicts=sum(x.evicts for x in lcs),
         churn_joins=len(churn_in), churn_joins_live=len(churn_live),
         churn_joins_heard=len(churn_heard), churn_leaves=len(left),
         journey_budget_s=LC_JOURNEY_BUDGET_S,
         churn_offered=(cm.joins_offered, cm.leaves_offered),
         admit_rejected=[x.admit_rejected for x in lcs],
         gcm_admit_rejected=glc.admit_rejected,
         gcm_slo_states={x.name: gsup.slo.state(x.name)
                         for x in gsup.slo.specs},
         slo_states=[{x.name: one.slo.state(x.name) for x in one.slo.specs}
                     for one in (lcs[0].supervisor, sup)],
         admit_to_live_s=live_at,
         checkpoint_s=ckpt["save_s"], recover_s=ckpt["recover_s"],
         recovered_snapshot_equal=ckpt["equal"],
         recovered_snapshot_equal_after_reconcile=ckpt[
             "equal_after_reconcile"],
         quarantined_sid=tampered_sid,
         tick_ms_p50=float(np.median(secs)) * 1e3,
         tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
         gcm_tick_ms_p50=float(np.median(gtick_s)) * 1e3,
         gcm_tick_ms_p99=float(np.percentile(gtick_s, 99)) * 1e3,
         health_state=health["state"], level=health["level"],
         rungs=health["rungs"], phase_attribution=attribution,
         datapath_first_launches=sum(x.datapath_recompiles
                                     for x in lcs + [glc]),
         first_launches_in_run=compile_stats().compile_events - compile0,
         tick_thread_handshake_feeds=0, copies=counts, gcm_copies=gcounts,
         dtls_copies=dtls_copies, dtls_live_tick=dtls_live,
         keystream=dict(hits=hits, misses=sum(c.misses for c in caches),
                        filled_slots=sum(c.filled_slots for c in caches)
                        - fill0,
                        fill_seconds=sum(c.fill_seconds for c in caches)),
         scrape_bytes=scrape, bytes_in_use=device_doc[0]["bytes_in_use"])
    sup.bridge.close()
    gb.close()
    socks.close()
    hold = {d: _lc_hold(torch, d, w) for d in (dev, torch.device("cpu"))}
    differ = [t for t in range(LC_HOLD_TICKS)
              if hold[dev][t] != hold[torch.device("cpu")][t]]
    require(not differ and all(hold[dev]), f"lifecycle hold: the card's "
            f"datagrams differ from the CPU run's at ticks {differ}")
    emit("sfu_lifecycle_hold", endpoints=SFU_SIZE, ticks=LC_HOLD_TICKS,
         recovered_before_tick=LC_HOLD_TICKS // 2,
         datagrams=[len(x) for x in hold[dev]], equal_to_cpu=True)
    print(json.dumps({"lifecycle_child": dict(
        launches=launches, plain_calls=plain, instances=instances,
        tick_launches=tick_launches,
        ticks=LC_TICKS + LC_GCM_TICKS + 2)}), flush=True)
    return 0


def _lc_hold(torch, d, w) -> list:
    """One conference (the first 11 SDES endpoints) under the supervisor
    and the lifecycle plane on `d`: joined in one wave, 6 ticks of the
    card-made wire, checkpointed, closed and recovered before tick 3.
    Returns every datagram the bridges sent, tick by tick."""
    from libjitsi_tpu_torch.core.packet import PacketBatch
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.service.lifecycle import LifecycleConfig
    from libjitsi_tpu_torch.service.sfu_bridge import SfuBridge
    from libjitsi_tpu_torch.service.supervisor import (BridgeSupervisor,
                                                       SupervisorConfig)

    cfg = SupervisorConfig(deadline_ms=LC_DEADLINE_MS)
    lcfg = LifecycleConfig(install_batch=LC_WAVE)
    bridge = SfuBridge(capacity=64, device=d)
    sup, lc = _lc_supervise(bridge, cfg, lcfg)
    n = SFU_SIZE
    for k in range(n):
        lc.request_join(int(w["cm_ssrc"][k]),
                        (w["cm_rx_key"][k].tobytes(),
                         w["cm_rx_salt"][k].tobytes()),
                        (w["cm_tx_key"][k].tobytes(),
                         w["cm_tx_salt"][k].tobytes()), conference=0)
    lc.run_between_ticks()
    lc.run_between_ticks()
    out = []
    with tempfile.TemporaryDirectory() as tmp, \
            UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=256) as sink:
        for t in range(LC_HOLD_TICKS):
            if t == LC_HOLD_TICKS // 2:
                path = sup.save_checkpoint(os.path.join(tmp, "hold"))
                sup.bridge.close()
                sup = BridgeSupervisor.recover(path, SfuBridge, device=d,
                                               supervisor_config=cfg)
                sup, lc = _lc_supervise(sup.bridge, None, lcfg, sup=sup)
            sends = _Sends(sup.bridge)
            sends.on = t
            wire = PacketBatch(w["cm_data"][t, :n], w["cm_length"][t, :n],
                               np.zeros(n, np.int32))
            _lc_tick(sup, [(sink, wire)], 1000.0 + 0.02 * t)
            sends.on = None
            out.append(sends.ticks.get(t, []))
            _drain(sink, 0)
        sup.bridge.close()
    return out


# ------------------------------------------------ conference_supervised

def _cs_ticks(sup, setup, ticks, client, res) -> None:
    """Send each tick's wire and tick the supervised bridge (20 ms steps
    of `now`), keeping the mixes that came back."""
    n = CONF_PARTIES
    for tick in ticks:
        client.send_batch(setup["wires"][tick], "127.0.0.1",
                          sup.bridge.port)
        time.sleep(0.002)
        t0 = time.perf_counter()
        stats = sup.tick(now=1000.0 + 0.02 * tick)
        res["tick_s"].append(time.perf_counter() - t0)
        require(stats["rx"] == n, f"conference_supervised tick {tick}: rx "
                                  f"{stats['rx']} of {n}")
        res["replies"].append(sorted(_drain(client, stats["tx"])))
        res["levels_seen"].append(sup.level)
        res["degraded"].append(bool(sup.bridge.degraded))
        res["dominant"].append(int(stats["dominant"]))


def conference_supervised_run(torch, dev, setup) -> dict:
    """The conference cell's 256 PCMU participants under a
    BridgeSupervisor: the deadline below the measured tick for
    CS_OVERLOAD ticks, so the ladder walks recv_window, degrade and two
    sheds by priority; then raised, so it unwinds LIFO; a checkpoint
    before tick CS_CKPT_TICK, the bridge closed and recovered on the
    card (`recover(..., ConferenceBridge)`), and the rest of the ticks."""
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.service.bridge import ConferenceBridge
    from libjitsi_tpu_torch.service.supervisor import (BridgeSupervisor,
                                                       SupervisorConfig)

    n = CONF_PARTIES
    bridge = _keep("conference_supervised",
                   ConferenceBridge(capacity=n, device=dev))
    _conference_join(bridge, setup)
    prios = {k: int(k < CS_PRIORITY) for k in range(n)}
    tmp = tempfile.mkdtemp()
    cfg = SupervisorConfig(deadline_ms=1e-6, overload_after=2,
                           overload_exit=2, stall_after=1000,
                           shed_step=CS_SHED_STEP,
                           checkpoint_path=os.path.join(tmp, "conf.ckpt"))
    sup = BridgeSupervisor(bridge, cfg, metrics=bridge.loop.metrics,
                           priorities=prios)
    res = dict(tick_s=[], replies=[], levels_seen=[], degraded=[],
               dominant=[])
    with UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=2 * n) as client:
        _cs_ticks(sup, setup, range(CS_OVERLOAD), client, res)
        res["peak"] = sup.health()
        res["shed_order"] = list(sup._shed)
        cfg.deadline_ms = 10_000.0
        sup.watchdog.deadline_s = 10.0
        _cs_ticks(sup, setup, range(CS_OVERLOAD, CS_CKPT_TICK), client, res)
        res["unwound"] = sup.health()
        events = [e for e in sup.flight.dump_all()["global"]
                  if e["kind"].startswith("ladder_")]
        t0 = time.perf_counter()
        path = sup.save_checkpoint()
        blob = BridgeSupervisor.load_checkpoint(path)
        sup.bridge.close()
        sup = BridgeSupervisor.recover(path, ConferenceBridge, device=dev,
                                       supervisor_config=cfg)
        res["recover_s"] = time.perf_counter() - t0
        res["snapshot_equal"] = _same(sup.bridge.snapshot(), blob["snap"])
        sup.priorities = prios
        sup.register_metrics(_keep("conference_supervised recovered",
                                   sup.bridge).loop.metrics)
        _cs_ticks(sup, setup, range(CS_CKPT_TICK, CS_TICKS), client, res)
    res.update(events=events, final=sup.health(), setup=setup,
               recovered_ticks=sup.ticks)
    sup.bridge.close()
    return res


def _cs_hold(torch, d, setup) -> list:
    """The conference under a supervisor on `d`: ticks 0-2, a checkpoint,
    the bridge closed and recovered on `d`, ticks 3-5; the mixes of each
    tick."""
    from libjitsi_tpu_torch.io.udp import UdpEngine
    from libjitsi_tpu_torch.service.bridge import ConferenceBridge
    from libjitsi_tpu_torch.service.supervisor import (BridgeSupervisor,
                                                       SupervisorConfig)

    n = CONF_PARTIES
    bridge = ConferenceBridge(capacity=n, device=d)
    _conference_join(bridge, setup)
    cfg = SupervisorConfig(deadline_ms=LC_DEADLINE_MS)
    sup = BridgeSupervisor(bridge, cfg)
    res = dict(tick_s=[], replies=[], levels_seen=[], degraded=[],
               dominant=[])
    with tempfile.TemporaryDirectory() as tmp, \
            UdpEngine(port=0, bind_ip="127.0.0.1", max_batch=2 * n) as client:
        half = CS_HOLD_TICKS // 2
        _cs_ticks(sup, setup, range(half), client, res)
        path = sup.save_checkpoint(os.path.join(tmp, "hold"))
        sup.bridge.close()
        sup = BridgeSupervisor.recover(path, ConferenceBridge, device=d,
                                       supervisor_config=cfg)
        _cs_ticks(sup, setup, range(half, CS_HOLD_TICKS), client, res)
        sup.bridge.close()
    return res["replies"]


def conference_supervised_check(torch, dev, run) -> None:
    """Gates: the ladder walked recv_window, degrade and two sheds (the
    lowest priority, newest sids first, never the dominant speaker) and
    unwound LIFO to level 0; every shed sid restored; the recovered
    bridge's snapshot equals the checkpoint's; and a 6-tick hold across
    a recovery equals the same script on the CPU, mix for mix."""
    up = [e["rung"] for e in run["events"]
          if e["kind"] == "ladder_escalate"]
    down = [e["rung"] for e in run["events"]
            if e["kind"] == "ladder_deescalate"]
    want = ["recv_window", "degrade", "shed_streams", "shed_streams"]
    require(up == want and down == want[::-1],
            f"conference_supervised: ladder up {up}, down {down}")
    # the lowest priority, newest sid first; the dominant speaker of the
    # moment is passed over
    shed = run["shed_order"]
    dominant = set(run["dominant"][:CS_OVERLOAD])
    passed = [k for k in range(min(shed, default=0), CONF_PARTIES)
              if k not in shed]
    require(len(shed) == 2 * CS_SHED_STEP and shed == sorted(shed)[::-1]
            and min(shed) >= CS_PRIORITY and set(passed) <= dominant,
            f"conference_supervised: shed {shed}, passed over {passed} "
            f"(dominant {sorted(dominant)})")
    require(run["peak"]["level"] == 4 and run["peak"]["state"]
            == "overloaded" and any(run["degraded"]),
            f"conference_supervised: peak {run['peak']}")
    require(run["unwound"]["level"] == 0 and not run["unwound"]["shed"]
            and not run["degraded"][-1],
            f"conference_supervised: not unwound: {run['unwound']}")
    require(run["snapshot_equal"], "conference_supervised: the recovered "
                                   "bridge's snapshot differs from the "
                                   "checkpoint's")
    t0 = time.perf_counter()
    card = _cs_hold(torch, dev, run["setup"])
    cpu = _cs_hold(torch, torch.device("cpu"), run["setup"])
    hold_s = time.perf_counter() - t0
    differ = [t for t in range(CS_HOLD_TICKS) if card[t] != cpu[t]]
    require(not differ, f"conference_supervised hold: the card's mixes "
                        f"differ from the CPU run's at ticks {differ}")
    secs = np.array(run["tick_s"])
    emit("conference_supervised", participants=CONF_PARTIES,
         ticks=CS_TICKS, overrun_ticks=CS_OVERLOAD,
         ladder_up=up, ladder_down=down, shed=shed,
         peak_level=run["peak"]["level"], peak_state=run["peak"]["state"],
         phase_attribution_bound=run["peak"]["bound"],
         levels_by_tick=run["levels_seen"],
         checkpoint_and_recover_s=run["recover_s"],
         recovered_snapshot_equal=True,
         final_state=run["final"]["state"], final_level=run["final"]["level"],
         tick_ms_p50=float(np.median(secs)) * 1e3,
         tick_ms_p99=float(np.percentile(secs, 99)) * 1e3,
         hold_ticks=CS_HOLD_TICKS, hold_equal_to_cpu=True, hold_s=hold_s)

if __name__ == "__main__":
    sys.exit(main())
