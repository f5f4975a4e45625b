"""SrtpStreamTable — batched SRTP/SRTCP crypto contexts for S streams.

Counterpart: `libjitsi_tpu/transform/srtp/context.py`.

The reference allocates one mutable `SRTPCryptoContext` per SSRC
(org.jitsi.impl.neomedia.transform.srtp.SRTPTransformer keeps a
Map<ssrc, context>) and runs per packet.  Here the contexts of all
streams are dense struct-of-arrays:

- key tables on `self.device`: AES round keys `[S, R, 16]` uint8 (and,
  for AES-F8, the schedules of k_e XOR m), and HMAC midstates
  `[S, 2, 5]` or, under AEAD-GCM, packed GHASH matrices `[S, 128, 4]`
  (uint32 bit patterns in int32; `kernels.ghash`), uploaded from the host
  master copies whenever a mutation marks them stale; the kernels
  gather rows by per-packet stream id themselves;
- host NumPy arrays: session salts (IV construction), ROC / highest
  index, replay windows, failure counters, key derivation rate epochs
  — the tiny sequential state machine (RFC 3711 Appendix A estimation,
  §3.3.2 replay, §4.3 re-keying) that stays on the host exactly as in
  the JAX package.

The snapshot format is the JAX package's, so `from_jax_state` adopts a
JAX table's `snapshot()` (plain NumPy arrays) and both tables then
process the next batch identically.

Ported: the AES-CM, AES-F8 and NULL + HMAC-SHA1 profiles (kernels C/D,
K/L and C's/D's NULL instances for RTP; I/J and their F8 and NULL
instances for SRTCP) and AEAD_AES_128_GCM (RFC 7714: kernels M and N for
RTP and SRTCP, with the host reshuffle between SRTCP's wire layout and
the kernels'; the optional keystream cache, `enable_keystream_cache`,
serves M's and N's cached instances); synchronous `protect_rtp` /
`unprotect_rtp`
(with `return_index`, the authenticated 48-bit estimates the SFU
fan-out re-uses) with size-class bucketing, and SRTCP `protect_rtcp` /
`unprotect_rtcp`; key derivation rate epochs (`add_stream(s)(kdr=...)`:
a batch crossing an epoch runs in waves, keys re-derived before each);
the dispatch-only seams `protect_rtp_async` / `unprotect_rtp_async`
with `commit_inflight` (`PendingProtect`, `PendingUnprotect`); installs,
removals, `move_rows`, snapshot and restore.  A GCM table keeps its
GHASH matrices packed (2 KB a stream); its snapshot gives them in the
JAX package's [S, 128, 128] int8 form, expanded for the active rows only
(the rest of the array is zero pages never touched), and `restore` packs
them again.

On the card the dispatch-only seams launch on the current CUDA stream,
copy each result back without blocking into pinned host tensors the
pending object owns and record a `torch.cuda.Event` after the copies;
nothing reads those buffers before the event.  Everything stays on one
stream, so a key table freed by a mutation is reused by the caching
allocator only for work queued after the kernels that read it.

`protect_rtp` and `unprotect_rtp` run inside `record_function` spans
(`srtp.protect_rtp`, `srtp.unprotect_rtp`, and for each size class
`srtp.upload`, `srtp.kernel`, `srtp.download`), as do `protect_rtcp`
and `unprotect_rtcp` (`srtp.protect_rtcp`, `srtp.unprotect_rtcp`), so
a profiler trace splits a call into host work, copies and kernels.

`warmup_rtp` / `warmup_rtcp` (the lifecycle plane's warm-ups) run the
RTP and SRTCP calls for a row class on a throwaway table of the same
capacity, profile and device, so the live table's tx indices and replay
windows are untouched.  The port compiles nothing per shape: what they
pay in advance is each kernel instance's first launch in the process,
the first allocation of the buffers a call of that size takes, and under
a keystream cache the cached path's prime and fill.

A "stream" row is one direction of one SSRC: use separate tables for tx
and rx, as the reference keeps separate forward/reverse context maps.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device, to_device
from libjitsi_tpu_torch.core.packet import PacketBatch, bucket_by_size, unbucket
from libjitsi_tpu_torch.core.rtp_math import (chain_packet_indices,
                                              estimate_packet_index,
                                              segment_ranks)
from libjitsi_tpu_torch.kernels import gcm
from libjitsi_tpu_torch.kernels.aes import aes_encrypt_np, expand_keys_batch
from libjitsi_tpu_torch.kernels.ghash import (ghash_matrix_packed,
                                              pack_matrices, unpack_matrices)
from libjitsi_tpu_torch.kernels.sha1 import hmac_precompute_batch
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.transform.srtp import kernel, replay
from libjitsi_tpu_torch.transform.srtp.kdf import derive_session_keys_batch
from libjitsi_tpu_torch.transform.srtp.policy import (Cipher, SrtpPolicy,
                                                      SrtpProfile)

#: the kernel wrappers' name for each ported cipher
CIPHER_NAME = {Cipher.AES_CM: "cm", Cipher.AES_F8: "f8", Cipher.NULL: "null",
               Cipher.AES_GCM: "gcm"}


def ghash_tables(rk: np.ndarray) -> np.ndarray:
    """Packed GHASH matrices [n, 128, 4] uint32 for [n, R, 16] round
    keys: H = E(K, 0^128) on the host, then M_H (RFC 7714; SP 800-38D)."""
    h = aes_encrypt_np(rk, np.zeros((rk.shape[0], 16), np.uint8))
    return ghash_matrix_packed(h)


def f8_schedules(enc: np.ndarray, salt: np.ndarray) -> np.ndarray:
    """AES-F8's second schedules, of k_e XOR m with m = salt || 0x55..
    (RFC 3711 §4.1.2.2, `kernels.aes.f8_m`), for [n, key] session keys
    and [n, salt] session salts."""
    m = np.full(enc.shape, 0x55, dtype=np.uint8)
    m[:, :salt.shape[1]] = salt
    return expand_keys_batch(enc ^ m)


def f8_rtp_iv(hdr, roc: np.ndarray) -> np.ndarray:
    """RFC 3711 §4.1.2.1: IV = 0x00 || M,PT || SEQ || TS || SSRC || ROC."""
    n = len(hdr.seq)
    iv = np.zeros((n, 16), dtype=np.uint8)
    iv[:, 1] = ((np.asarray(hdr.marker) << 7) | np.asarray(hdr.pt)
                ).astype(np.uint8)
    iv[:, 2] = (hdr.seq >> 8) & 0xFF
    iv[:, 3] = hdr.seq & 0xFF
    ts = np.asarray(hdr.ts, dtype=np.int64)
    ssrc = np.asarray(hdr.ssrc, dtype=np.int64)
    roc = np.asarray(roc, dtype=np.int64)
    for k in range(4):
        sh = 8 * (3 - k)
        iv[:, 4 + k] = (ts >> sh) & 0xFF
        iv[:, 8 + k] = (ssrc >> sh) & 0xFF
        iv[:, 12 + k] = (roc >> sh) & 0xFF
    return iv


class Download:
    """Device results on their way to the host.  On the card: pinned host
    tensors filled by non-blocking copies, and an event recorded after
    them; on the CPU: the tensors themselves."""

    def __init__(self, device: torch.device, *tensors: torch.Tensor):
        if device.type != "cuda":
            self._host, self._event = tensors, None
            return
        self._host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True) for t in tensors)
        for h, t in zip(self._host, tensors):
            h.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(device))

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def numpy(self):
        """The results as NumPy arrays, after the copies are done."""
        self.wait()
        return tuple(h.numpy() for h in self._host)


class SrtpStreamTable:
    """Batched crypto contexts for up to `capacity` streams of one profile.

    `device` None means the card; tests pass device="cpu".
    """

    def __init__(self, capacity: int = 1024,
                 profile: SrtpProfile = SrtpProfile.AES_CM_128_HMAC_SHA1_80,
                 device: DeviceLike = None):
        policy: SrtpPolicy = profile.policy
        self.profile = profile
        self.policy = policy
        self.cipher = CIPHER_NAME[policy.cipher]
        self._f8 = policy.cipher == Cipher.AES_F8
        self._gcm = policy.cipher == Cipher.AES_GCM
        self.capacity = capacity
        self.device = resolve_device(device)
        rounds = {16: 11, 32: 15}[policy.enc_key_len]

        s = capacity
        self.active = np.zeros(s, dtype=bool)
        # key material: host master copies, uploaded when `_dev` is None
        self._rk_rtp = np.zeros((s, rounds, 16), dtype=np.uint8)
        self._mid_rtp = np.zeros((s, 2, 5), dtype=np.uint32)
        self._rk_rtcp = np.zeros((s, rounds, 16), dtype=np.uint8)
        self._mid_rtcp = np.zeros((s, 2, 5), dtype=np.uint32)
        if self._f8:
            # the second schedule per stream: k_e XOR m, for IV' (RFC 3711
            # §4.1.2.2; reference SRTPCipherF8)
            self._rk_f8_rtp = np.zeros((s, rounds, 16), dtype=np.uint8)
            self._rk_f8_rtcp = np.zeros((s, rounds, 16), dtype=np.uint8)
        if self._gcm:
            # packed GHASH matrices of H = E(K, 0^128) per stream and
            # plane (RFC 7714), in place of the midstates on the card
            self._gm_rtp = np.zeros((s, 128, 4), dtype=np.uint32)
            self._gm_rtcp = np.zeros((s, 128, 4), dtype=np.uint32)
        self._dev = None
        self._dev_rtcp = None
        # host-side IV salts (16B, low 2 bytes zero)
        self._salt_rtp = np.zeros((s, 16), dtype=np.uint8)
        self._salt_rtcp = np.zeros((s, 16), dtype=np.uint8)
        # sequential per-stream state
        self.tx_ext = np.full(s, -1, dtype=np.int64)  # last sent ext index
        self.rx_max = np.full(s, -1, dtype=np.int64)  # highest authed index
        self.rx_mask = np.zeros(s, dtype=np.uint64)
        self.rtcp_tx_index = np.full(s, -1, dtype=np.int64)
        self.rtcp_rx_max = np.full(s, -1, dtype=np.int64)
        self.rtcp_rx_mask = np.zeros(s, dtype=np.uint64)
        # per-stream receive-failure accounting, as in the JAX table:
        # bucket padding can double-count an auth failure; replay_reject
        # counts only window-based rejects
        self.auth_fail = np.zeros(s, dtype=np.int64)
        self.replay_reject = np.zeros(s, dtype=np.int64)
        # key derivation rate re-keying (reference:
        # BaseSRTPCryptoContext.keyDerivationRate): kdr > 0 streams keep
        # their master key and salt, and their session keys are derived
        # again when a packet index crosses an index DIV kdr epoch
        self.kdr = np.zeros(s, dtype=np.int64)
        self._epoch_rtp = np.zeros(s, dtype=np.int64)
        self._epoch_rtcp = np.zeros(s, dtype=np.int64)
        self._masters: Dict[int, Tuple[bytes, bytes]] = {}
        # the one outstanding dispatch-only unprotect, whose replay and
        # counter commit is forced before anything reads or mutates RX
        # state
        self._inflight_unprotect: "PendingUnprotect | None" = None
        # the optional keystream cache (GCM; `enable_keystream_cache`)
        self._ks_cache = None

    def enable_keystream_cache(self, window: int = 64, ks_bytes: int = 256,
                               pool=None, debug: bool = False):
        """Attach a keystream cache (AEAD-GCM only): protect and unprotect
        then serve M's and N's cached instances when every row of a part
        hits its window, and fall back to the stock kernels, byte for
        byte, on a miss.  `fill()` runs between ticks.  Returns the
        cache."""
        if not self._gcm:
            raise ValueError("keystream cache requires an AEAD-GCM profile")
        from libjitsi_tpu_torch.transform.srtp.keystream import \
            KeystreamCache
        self._ks_cache = KeystreamCache(self, window=window,
                                        ks_bytes=ks_bytes, pool=pool,
                                        debug=debug)
        return self._ks_cache

    # -------------------------------------------------------------- warmup
    def warmup_rtp(self, batch_size: int, packets_per_stream: int = 4,
                   payload_len: int = 160) -> None:
        """Run RTP protect and unprotect at `batch_size` rows off the
        media path, on a throwaway table of the same shape and device
        (the live table's state is untouched), so the data path meets
        no first launch.  With a keystream cache it also runs the
        cached twin: priming scratch caches launches O, and their hits
        serve M's and N's cached instances.  (The JAX method also runs
        the kernel registry's GCM provider measurement here; the port's
        registry is ROADMAP Queue 1 item 11.)"""
        scratch = SrtpStreamTable(self.capacity, self.profile, self.device)
        n = max(1, min(self.capacity,
                       batch_size // max(packets_per_stream, 1)))
        rng = np.random.default_rng(0)
        sids = np.arange(n)
        mks = rng.integers(0, 256, (n, self.policy.enc_key_len),
                           dtype=np.uint8)
        mss = rng.integers(0, 256, (n, self.policy.salt_len),
                           dtype=np.uint8)
        scratch.add_streams(sids, mks, mss)
        pp = -(-batch_size // n)
        streams = np.repeat(sids, pp)[:batch_size]
        seqs = segment_ranks(streams) + 1
        pls = [b"\x00" * payload_len] * batch_size
        b = rtp_header.build(pls, seqs.tolist(), [0] * batch_size,
                             (0x4000 + streams).tolist(),
                             [96] * batch_size, stream=streams.tolist())
        wire = scratch.protect_rtp(b)
        scratch.unprotect_rtp(wire)
        src = self._ks_cache
        if src is not None and pp < src.window:
            # the cached twin; the rx leg runs on a second table with the
            # same keys, since protect consumes the tx cache's slots
            cw = dict(window=src.window, ks_bytes=src.ks_bytes,
                      pool=src.pool)
            ssrcs = 0x4000 + sids
            ctx = scratch.enable_keystream_cache(**cw)
            ctx.prime(sids, ssrcs)
            b2 = rtp_header.build(pls, ((seqs + pp) & 0xFFFF).tolist(),
                                  [0] * batch_size,
                                  (0x4000 + streams).tolist(),
                                  [96] * batch_size, stream=streams.tolist())
            wire2 = scratch.protect_rtp(b2)
            scratch_rx = SrtpStreamTable(self.capacity, self.profile,
                                         self.device)
            scratch_rx.add_streams(sids, mks, mss)
            crx = scratch_rx.enable_keystream_cache(**cw)
            crx.prime(sids, ssrcs, start=1 + pp)
            scratch_rx.unprotect_rtp(wire2)

    def warmup_rtcp(self, batch_size: int = 1) -> None:
        """Run SRTCP protect and unprotect at `batch_size` rows (one empty
        receiver report each) on a throwaway table, as `warmup_rtp`."""
        scratch = SrtpStreamTable(self.capacity, self.profile, self.device)
        scratch.add_stream(0, b"\x00" * self.policy.enc_key_len,
                           b"\x00" * self.policy.salt_len)
        blob = bytes([0x80, 201, 0, 1]) + (0x4000).to_bytes(4, "big")
        b = PacketBatch.from_payloads([blob] * max(1, batch_size),
                                      stream=[0] * max(1, batch_size))
        wire = scratch.protect_rtcp(b)
        scratch.unprotect_rtcp(wire)

    # ------------------------------------------------------ commit barrier
    def _commit_inflight_unprotect(self) -> None:
        """Ordering barrier of the pipelined receive path: the host replay
        state of the outstanding `unprotect_rtp_async` lands before
        anything reads or mutates per-stream RX state."""
        p = self._inflight_unprotect
        if p is not None:
            p.commit()

    def commit_inflight(self) -> None:
        """Public commit barrier: wait for the outstanding async
        unprotect's verdicts and land its replay-window update now,
        instead of inside the next dispatch."""
        self._commit_inflight_unprotect()

    def _cow_tables(self) -> None:
        """The barrier every key-table mutation passes first.

        It commits the pending unprotect (whose replay state must not land
        in rows a mutation is about to recycle) and drops the device
        tables, so the next launch uploads the new keys.  The JAX table
        also re-points its host tables at fresh copies here, because XLA
        on the CPU may alias them; `to_device` always copies
        (`core/device.py`), so a dispatched kernel never sees a later
        host write, and the device tables it reads stay alive and unused
        until it is done (one CUDA stream)."""
        self._commit_inflight_unprotect()
        if self._ks_cache is not None:
            # keys change somewhere in the table: drop every cached window
            # (the per-stream served high-water stays)
            self._ks_cache.invalidate()
        self._dev = None
        self._dev_rtcp = None

    # ------------------------------------------------------------------ keys
    def add_stream(self, sid: int, master_key: bytes, master_salt: bytes,
                   kdr: int = 0) -> None:
        """Derive session keys and install them at row `sid`.

        Reference: SRTPContextFactory + SRTPCryptoContext.deriveSrtpKeys.
        """
        p = self.policy
        if len(master_key) != p.enc_key_len:
            raise ValueError(
                f"master key must be {p.enc_key_len}B for {self.profile.value}")
        if len(master_salt) != p.salt_len:
            raise ValueError(f"master salt must be {p.salt_len}B")
        self.add_streams([sid], np.frombuffer(bytes(master_key), np.uint8),
                         np.frombuffer(bytes(master_salt), np.uint8), kdr)

    def add_streams(self, sids, master_keys, master_salts, kdr=0) -> None:
        """Vectorized bulk install: `add_stream` for many rows at once
        (the KDF, key schedules and HMAC midstates run as single
        vectorized passes — a 10k-stream bootstrap)."""
        sids = np.asarray(sids, dtype=np.int64)
        mks = np.atleast_2d(np.asarray(master_keys, dtype=np.uint8))
        mss = np.atleast_2d(np.asarray(master_salts, dtype=np.uint8))
        s = len(sids)
        p = self.policy
        if mks.shape != (s, p.enc_key_len):
            raise ValueError(
                f"master keys must be [{s}, {p.enc_key_len}] for "
                f"{self.profile.value}, got {mks.shape}")
        if mss.shape != (s, p.salt_len):
            raise ValueError(f"master salts must be [{s}, {p.salt_len}]")
        kdr_arr = np.broadcast_to(np.asarray(kdr, dtype=np.int64), (s,))
        self._install_keys_batch(sids, derive_session_keys_batch(
            mks, mss, enc_key_len=p.enc_key_len,
            auth_key_len=p.auth_key_len, salt_len=p.salt_len))
        self._reset_rows(sids)
        self.kdr[sids] = kdr_arr
        for i, sid in enumerate(sids):
            if kdr_arr[i]:
                self._masters[int(sid)] = (mks[i].tobytes(),
                                           mss[i].tobytes())
            else:
                self._masters.pop(int(sid), None)
        self.active[sids] = True
        if self._ks_cache is not None:
            self._ks_cache.forget(sids)

    def _install_keys_batch(self, sids: np.ndarray, ksb) -> None:
        """Pack many streams' derived session keys (a
        `derive_session_keys_batch` result, row i for sids[i]) into the
        key tables in vectorized passes: add_streams, and the kdr epochs'
        re-derivation of every stream a wave moves."""
        p = self.policy
        self._cow_tables()
        self._rk_rtp[sids] = expand_keys_batch(ksb.rtp_enc)
        self._rk_rtcp[sids] = expand_keys_batch(ksb.rtcp_enc)
        if self._gcm:
            self._gm_rtp[sids] = ghash_tables(self._rk_rtp[sids])
            self._gm_rtcp[sids] = ghash_tables(self._rk_rtcp[sids])
        else:
            self._mid_rtp[sids] = hmac_precompute_batch(ksb.rtp_auth)
            self._mid_rtcp[sids] = hmac_precompute_batch(ksb.rtcp_auth)
        if self._f8:
            self._rk_f8_rtp[sids] = f8_schedules(ksb.rtp_enc, ksb.rtp_salt)
            self._rk_f8_rtcp[sids] = f8_schedules(ksb.rtcp_enc,
                                                  ksb.rtcp_salt)
        self._salt_rtp[sids] = 0
        self._salt_rtp[sids, :p.salt_len] = ksb.rtp_salt
        self._salt_rtcp[sids] = 0
        self._salt_rtcp[sids, :p.salt_len] = ksb.rtcp_salt

    def remove_stream(self, sid: int) -> None:
        self.remove_streams([sid])

    def remove_streams(self, sids) -> None:
        """Bulk teardown: key material is zeroed (a recycled row must
        never authenticate under a departed stream's keys) and all
        sequential state, the kdr epochs included, is reset so the row is
        immediately reusable."""
        sids = np.asarray(sids, dtype=np.int64)
        if sids.size == 0:
            return
        self.active[sids] = False
        self._cow_tables()
        for tab in self._key_tables():
            tab[sids] = 0
        for sid in sids:
            self._masters.pop(int(sid), None)
        self._reset_rows(sids)
        self.kdr[sids] = 0
        if self._ks_cache is not None:
            self._ks_cache.forget(sids)

    def _key_tables(self):
        """The per-stream key material: round keys, midstates, salts."""
        tabs = [self._rk_rtp, self._rk_rtcp, self._mid_rtp, self._mid_rtcp,
                self._salt_rtp, self._salt_rtcp]
        if self._f8:
            tabs += [self._rk_f8_rtp, self._rk_f8_rtcp]
        if self._gcm:
            tabs += [self._gm_rtp, self._gm_rtcp]
        return tabs

    def _reset_rows(self, sids) -> None:
        self.tx_ext[sids] = -1
        self.rx_max[sids] = -1
        self.rx_mask[sids] = 0
        self.rtcp_tx_index[sids] = -1
        self.rtcp_rx_max[sids] = -1
        self.rtcp_rx_mask[sids] = 0
        self.auth_fail[sids] = 0
        self.replay_reject[sids] = 0
        self._epoch_rtp[sids] = 0
        self._epoch_rtcp[sids] = 0
        self._dev = None
        self._dev_rtcp = None

    def move_rows(self, src_sids, dst_sids) -> None:
        """Relocate live streams to new rows bit for bit — the crypto half
        of a placement move: every row's keys, rollover counters, replay
        windows, counters and kdr epochs go along unchanged, so no packet
        in flight before the move authenticates differently after it.
        The source rows are then torn down through `remove_streams`'s
        zeroing (a vacated row keeps no departed key material).  Callers
        sequence this between ticks behind the commit barrier."""
        src = np.asarray(src_sids, dtype=np.int64)
        dst = np.asarray(dst_sids, dtype=np.int64)
        if src.size != dst.size:
            raise ValueError("src/dst length mismatch")
        if src.size == 0:
            return
        if not self.active[src].all():
            raise ValueError("cannot move inactive rows")
        if self.active[dst].any():
            raise ValueError("destination rows occupied")
        self._cow_tables()
        for tab in self._key_tables() + [
                self.tx_ext, self.rx_max, self.rx_mask, self.rtcp_tx_index,
                self.rtcp_rx_max, self.rtcp_rx_mask, self.auth_fail,
                self.replay_reject, self.kdr, self._epoch_rtp,
                self._epoch_rtcp]:
            tab[dst] = tab[src]
        for s, d in zip(src, dst):
            m = self._masters.pop(int(s), None)
            if m is not None:
                self._masters[int(d)] = m
        self.active[dst] = True
        if self._ks_cache is not None:
            # dst inherits src's served high-water: the same keys under a
            # new row id, and never-serve-twice holds across the rename
            self._ks_cache.move(src, dst)
        # masters already relocated; remove_streams zeroes the rest
        self.remove_streams(src)

    def _device_tables(self):
        """(round keys, midstates or under GCM packed GHASH matrices, F8
        schedules or None) of the RTP plane on `self.device`, uploaded
        again after any key mutation."""
        if self._dev is None:
            aux = self._gm_rtp if self._gcm else self._mid_rtp
            self._dev = (
                to_device(self._rk_rtp, self.device),
                to_device(aux.view(np.int32), self.device),
                to_device(self._rk_f8_rtp, self.device) if self._f8
                else None)
        return self._dev

    def _device_tables_rtcp(self):
        """The same for the RTCP plane (kernel I and J instances, or M
        and N under GCM)."""
        if self._dev_rtcp is None:
            aux = self._gm_rtcp if self._gcm else self._mid_rtcp
            self._dev_rtcp = (
                to_device(self._rk_rtcp, self.device),
                to_device(aux.view(np.int32), self.device),
                to_device(self._rk_f8_rtcp, self.device) if self._f8
                else None)
        return self._dev_rtcp

    def _require_active(self, stream: np.ndarray) -> None:
        """Protect-path guard: every row must map to an installed stream."""
        bad = (stream < 0) | (stream >= self.capacity) | ~self.active[
            np.clip(stream, 0, self.capacity - 1)]
        if np.any(bad):
            raise KeyError(
                f"protect on unmapped/inactive stream ids "
                f"{np.unique(stream[bad]).tolist()}")

    # ------------------------------------------------------------------ IVs
    def _cm_iv(self, salt16: np.ndarray, ssrc: np.ndarray,
               index: np.ndarray) -> np.ndarray:
        """RFC 3711 §4.1.1: IV = (salt << 16) ^ (ssrc << 64) ^ (index << 16)."""
        iv = salt16.copy()
        ssrc = np.asarray(ssrc, dtype=np.int64)
        index = np.asarray(index, dtype=np.int64)
        for k in range(4):
            iv[:, 4 + k] ^= ((ssrc >> (8 * (3 - k))) & 0xFF).astype(np.uint8)
        for k in range(6):
            iv[:, 8 + k] ^= ((index >> (8 * (5 - k))) & 0xFF).astype(np.uint8)
        return iv

    @staticmethod
    def _f8_rtcp_iv(data: np.ndarray, index_word: np.ndarray) -> np.ndarray:
        """RFC 3711 §4.1.2.4: IV = 0..0(32) || E||index || first 8 bytes of
        the RTCP packet (V,P,RC,PT,length,SSRC)."""
        n = len(index_word)
        iv = np.zeros((n, 16), dtype=np.uint8)
        w = np.asarray(index_word, dtype=np.int64)
        for k in range(4):
            iv[:, 4 + k] = (w >> (8 * (3 - k))) & 0xFF
        iv[:, 8:16] = data[:, :8]
        return iv

    def _gcm_rtcp_iv(self, srow: np.ndarray, ssrc: np.ndarray,
                     index: np.ndarray) -> np.ndarray:
        """RFC 7714 §9.1: IV = (00 00 || SSRC || 00 00 || index) XOR
        salt."""
        return gcm.srtcp_gcm_iv(self._salt_rtcp[srow], ssrc, index)

    def _rtp_iv(self, stream, hdr, idx) -> np.ndarray:
        if self._f8:
            return f8_rtp_iv(hdr, idx >> 16)
        return self._cm_iv(self._salt_rtp[stream], hdr.ssrc, idx)

    # ------------------------------------------------------ kdr epochs
    @staticmethod
    def _row_subset(batch: PacketBatch, rows: np.ndarray) -> PacketBatch:
        return PacketBatch(batch.data[rows].copy(),
                           np.asarray(batch.length)[rows].copy(),
                           np.asarray(batch.stream)[rows].copy())

    def _kdr_active(self, stream: np.ndarray) -> bool:
        valid = (stream >= 0) & (stream < self.capacity)
        return bool((self.kdr[np.clip(stream, 0, self.capacity - 1)]
                     * valid > 0).any())

    def _epoch_plan(self, stream: np.ndarray, idx: np.ndarray, rtcp: bool):
        """kdr re-keying plan (RFC 3711 §4.3; reference
        keyDerivationRate): group rows into sequential waves such that
        within a wave each kdr stream sits in one key epoch r = index DIV
        kdr.  Unmapped rows and kdr = 0 streams ride wave 0.  Returns
        (waves, r): `waves` is None when one wave suffices (the caller
        applies the epochs and processes the whole batch), else a list of
        row-index arrays to process in order, epochs applied before each.

        On the receive side the epoch comes from the index estimate, before
        authentication (keys must exist before tags can be checked): forged
        wild seqs can move the epoch, and the next genuine batch derives
        the right keys again from the retained master key.
        """
        n = len(stream)
        valid = (stream >= 0) & (stream < self.capacity)
        kdr = np.where(valid, self.kdr[np.clip(stream, 0,
                                               self.capacity - 1)], 0)
        active = kdr > 0
        r = np.where(active, idx // np.maximum(kdr, 1), 0)
        if not active.any():
            return None, r
        waves = []
        remaining = np.ones(n, dtype=bool)
        first_wave = True
        while remaining.any():
            act = np.nonzero(remaining & active)[0]
            wave = (remaining & ~active if first_wave
                    else np.zeros(n, dtype=bool))
            if len(act):
                s_act = stream[act]
                uniq, first_pos = np.unique(s_act, return_index=True)
                fr = np.full(self.capacity, -1, dtype=np.int64)
                fr[uniq] = r[act[first_pos]]
                wave[act[r[act] == fr[s_act]]] = True
            waves.append(np.nonzero(wave)[0])
            remaining &= ~wave
            first_wave = False
        if len(waves) == 1:
            return None, r
        return waves, r

    def _apply_epochs(self, stream: np.ndarray, r: np.ndarray,
                      rtcp: bool) -> None:
        """Derive the session keys again for every kdr stream whose stored
        epoch differs from its rows' (single) epoch in this wave."""
        valid = (stream >= 0) & (stream < self.capacity)
        kdr = np.where(valid, self.kdr[np.clip(stream, 0,
                                               self.capacity - 1)], 0)
        act = np.nonzero(kdr > 0)[0]
        if not len(act):
            return
        p = self.policy
        uniq, first_pos = np.unique(stream[act], return_index=True)
        epochs = self._epoch_rtcp if rtcp else self._epoch_rtp
        ri = r[act[first_pos]]
        move = (ri != epochs[uniq]) & np.isin(uniq, list(self._masters))
        sids, ri = uniq[move], ri[move]
        if not len(sids):
            return
        # one batched derivation for every stream the wave moves (the JAX
        # table derives them one by one: the same keys); the other plane
        # (RTP or RTCP) keeps its stored epoch, and both planes' keys are
        # installed in one go
        masters = [self._masters[int(sid)] for sid in sids]
        ksb = derive_session_keys_batch(
            np.stack([np.frombuffer(mk, np.uint8) for mk, _ in masters]),
            np.stack([np.frombuffer(ms, np.uint8) for _, ms in masters]),
            enc_key_len=p.enc_key_len, auth_key_len=p.auth_key_len,
            salt_len=p.salt_len,
            r=self._epoch_rtp[sids] if rtcp else ri,
            rc=ri if rtcp else self._epoch_rtcp[sids])
        self._install_keys_batch(sids, ksb)
        epochs[sids] = ri

    @staticmethod
    def _merge_row_results(total: int, parts):
        """Merge [(rows, PacketBatch, ok or None, idx or None)] back into
        one (batch, ok, idx) in row order (the epoch waves' results)."""
        need = max(o.capacity for _, o, _, _ in parts)
        out = PacketBatch.empty(total, need)
        ok = np.zeros(total, dtype=bool)
        idx = np.zeros(total, dtype=np.int64)
        for rows, o, okp, idxp in parts:
            out.data[rows, :o.capacity] = o.data
            out.length[rows] = o.length
            out.stream[rows] = o.stream
            if okp is not None:
                ok[rows] = okp
            if idxp is not None:
                idx[rows] = idxp
        return out, ok, idx

    def _estimate_rx_indices(self, stream: np.ndarray,
                             seq: np.ndarray) -> np.ndarray:
        """Receive-side 48-bit index estimation: established streams
        estimate against the last authenticated state (RFC 3711 App A,
        immune to forged packets earlier in the batch); fresh streams
        chain within the batch so a wrap right after the initial seq
        still indexes correctly."""
        base = self.rx_max[np.maximum(stream, 0)]
        s_l = np.where(base >= 0, base & 0xFFFF, -1)
        roc = np.where(base >= 0, base >> 16, 0)
        _, idx_est = estimate_packet_index(seq, s_l, roc)
        idx_chain = chain_packet_indices(stream, seq, self.rx_max)
        return np.where(base >= 0, idx_est, idx_chain)

    def _kernel_args(self, stream, batch, hdr, iv, v, length):
        """Upload one part's per-row arrays next to the key tables."""
        d = self.device
        tab_rk, tab_mid, _ = self._device_tables()
        return (tab_rk, tab_mid,
                to_device(stream.astype(np.int32), d),
                to_device(batch.data, d),
                to_device(np.asarray(length, dtype=np.int32), d),
                to_device(hdr.payload_off.astype(np.int32), d),
                to_device(iv, d),
                to_device((v & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
                          d))

    def _gcm_rtp_call(self, stream, srow, batch, hdr, idx, length,
                      opening: bool):
        """One part's AEAD-GCM launch (RFC 7714 §8: AAD = the RTP header):
        M's or N's cached instance when the keystream cache serves every
        row of the part, else M or N with each row's IV built on the host.
        Returns the device results (data, length') or (data, mlen,
        auth_ok).  On unprotect the claimed slots are consumed even if
        authentication fails, so a replayed twin finds its slot taken."""
        d = self.device
        _, tab_gm, _ = self._device_tables()
        off = np.asarray(hdr.payload_off, dtype=np.int32)
        got = None
        if self._ks_cache is not None:
            aad = _uniform_off(off, batch.capacity)
            ct = (np.asarray(length, dtype=np.int64)
                  - (gcm.TAG_LEN if opening else 0)
                  - (aad if aad is not None else 0))
            got = self._ks_cache.claim(stream, hdr.ssrc, idx, ct,
                                       aad is not None)
        with record_function("srtp.upload"):
            rows = (to_device(srow.astype(np.int32), d),
                    to_device(batch.data, d),
                    to_device(np.asarray(length, dtype=np.int32), d),
                    to_device(off, d))
            if got is None:
                iv12 = to_device(gcm.srtp_gcm_iv(self._salt_rtp[srow],
                                                 hdr.ssrc, idx), d)
            else:
                ks_tab, ek_tab, slot = got
                slot = to_device(slot, d)
        with record_function("srtp.kernel"):
            if got is not None:
                fn = (kernel.srtp_gcm_unprotect_cached if opening
                      else kernel.srtp_gcm_protect_cached)
                return fn(ks_tab, ek_tab, slot, tab_gm, *rows)
            fn = kernel.srtp_gcm_unprotect if opening \
                else kernel.srtp_gcm_protect
            return fn(self._device_tables()[0], tab_gm, *rows, iv12)

    # ------------------------------------------------------------------ RTP
    def protect_rtp(self, batch: PacketBatch) -> PacketBatch:
        """Encrypt + tag a batch of outgoing RTP (rows in send order).

        Mixed-size batches are split into width/row size classes at this
        device boundary; padding rows repeat a real row (duplicate
        index: tx max unchanged) and are dropped on reassembly.  A batch
        that crosses a kdr epoch runs in waves.
        Reference: SRTPTransformer.transform → SRTPCryptoContext.transformPacket.
        """
        if batch.batch_size == 0:
            return batch
        stream0 = np.asarray(batch.stream, dtype=np.int64)
        if self._kdr_active(stream0):
            hdr0 = rtp_header.parse(batch)
            idx0 = chain_packet_indices(stream0, hdr0.seq, self.tx_ext)
            waves, r = self._epoch_plan(stream0, idx0, rtcp=False)
            if waves is not None:
                done = [(w, self.protect_rtp(self._row_subset(batch, w)),
                         None, None) for w in waves]
                out, _, _ = self._merge_row_results(batch.batch_size, done)
                return out
            self._apply_epochs(stream0, r, rtcp=False)
        with record_function("srtp.protect_rtp"):
            done = []
            for rows, part, n in bucket_by_size(batch):
                data, length, stream = self._protect_dispatch(part)
                with record_function("srtp.download"):
                    data, length = data.cpu().numpy(), length.cpu().numpy()
                done.append((rows, PacketBatch(data, length, stream), n))
            out, _ = unbucket(done, batch.batch_size, batch.capacity)
        return out

    def protect_rtp_async(self, batch: PacketBatch) -> "PendingProtect":
        """Dispatch-only protect: the kernels are launched and the host TX
        state is fully updated, but the results are not waited for —
        `.result()` does that.  Protect's host state (chain index, tx max)
        depends only on its inputs, so dispatching batch n + 1 before
        batch n's result is state-safe at any depth, and a key mutation
        while parts are pending leaves the dispatched ones on the old
        keys.  kdr batches take the sync path (epoch waves are
        sequential)."""
        if batch.batch_size == 0:
            return PendingProtect([], 0, batch.capacity, done=batch)
        stream0 = np.asarray(batch.stream, dtype=np.int64)
        if self._kdr_active(stream0):
            return PendingProtect([], 0, batch.capacity,
                                  done=self.protect_rtp(batch))
        pend = []
        for rows, part, n in bucket_by_size(batch):
            data, length, stream = self._protect_dispatch(part)
            pend.append((rows, (Download(self.device, data, length),
                                stream), n))
        return PendingProtect(pend, batch.batch_size, batch.capacity)

    def _protect_dispatch(self, batch: PacketBatch):
        """One part's launch and host state update: returns the device
        tensors (data, length) and the part's stream ids, not waited
        for."""
        hdr = rtp_header.parse(batch)
        stream = np.asarray(batch.stream, dtype=np.int64)
        self._require_active(stream)
        max_len = int(np.max(batch.length, initial=0))
        if max_len + self.policy.auth_tag_len > batch.capacity:
            raise ValueError(
                f"packet of {max_len}B + {self.policy.auth_tag_len}B tag "
                f"exceeds batch capacity {batch.capacity}")
        idx = chain_packet_indices(stream, hdr.seq, self.tx_ext)
        if self._gcm:
            data, length = self._gcm_rtp_call(stream, stream, batch, hdr,
                                              idx, batch.length, False)
        else:
            iv = self._rtp_iv(stream, hdr, idx)
            with record_function("srtp.upload"):
                args = self._kernel_args(stream, batch, hdr, iv, idx >> 16,
                                         batch.length)
            with record_function("srtp.kernel"):
                data, length = kernel.srtp_protect(
                    *args, self.policy.auth_tag_len, self.cipher,
                    self._device_tables()[2])
        np.maximum.at(self.tx_ext, stream, idx)
        return data, length, batch.stream

    def unprotect_rtp(self, batch: PacketBatch, return_index: bool = False):
        """Auth-check, replay-check and decrypt incoming RTP.

        Returns (batch', ok) — or (batch', ok, index) with each row's
        estimated 48-bit packet index when `return_index` (the SFU
        translator re-uses the authenticated sender index for every
        fan-out leg).  Rows with ok=False
        keep their original bytes (the reference drops them; callers
        filter by the mask).  Size-class bucketed like protect_rtp; the
        repeated padding rows are exact duplicates, which the replay
        dedup kills while the real copy (earlier in its part) survives.
        Reference: SRTPTransformer.reverseTransform →
        SRTPCryptoContext.reverseTransformPacket.
        """
        self._commit_inflight_unprotect()
        if batch.batch_size == 0:
            ok0 = np.zeros(0, dtype=bool)
            if return_index:
                return batch, ok0, np.zeros(0, dtype=np.int64)
            return batch, ok0
        stream0 = np.asarray(batch.stream, dtype=np.int64)
        if self._kdr_active(stream0):
            hdr0 = rtp_header.parse(batch)
            idx0 = self._estimate_rx_indices(stream0, hdr0.seq)
            waves, r = self._epoch_plan(stream0, idx0, rtcp=False)
            if waves is not None:
                done = []
                for w in waves:
                    o, okp, idxp = self.unprotect_rtp(
                        self._row_subset(batch, w), True)
                    done.append((w, o, okp, idxp))
                out, ok, idx = self._merge_row_results(batch.batch_size,
                                                       done)
                return (out, ok, idx) if return_index else (out, ok)
            self._apply_epochs(stream0, r, rtcp=False)
        with record_function("srtp.unprotect_rtp"):
            parts = []
            for rows, part, n in bucket_by_size(batch):
                rec = self._unprotect_dispatch(part)
                with record_function("srtp.download"):
                    rec["res"] = Download(torch.device("cpu"), *(
                        t.cpu() for t in rec["res"]))
                parts.append((rows, rec, n, self._commit_part(rec)))
            res = _assemble_unprotect(parts, batch, return_index)
        return res

    def unprotect_rtp_async(self, batch: PacketBatch,
                            return_index: bool = False
                            ) -> "PendingUnprotect":
        """Dispatch-only unprotect: the kernels are launched, their
        results not waited for — the pipelined receive seam.

        Unprotect's host state (replay window, failure counters) depends
        on the kernels' verdicts, so nothing host-side commits at
        dispatch; `PendingUnprotect.commit()` does, and the table forces
        the outstanding pending's commit before any new unprotect (sync or
        async), any key-table mutation and any snapshot, so successive
        batches always replay-check against a current window, in dispatch
        order.  kdr batches take the sync path.  `.result()` returns
        (batch, ok[, index]) exactly like `unprotect_rtp`; failed rows
        keep their original bytes, read from `batch` at materialization
        time, so a caller keeps `batch` unchanged until then.
        """
        self._commit_inflight_unprotect()
        if batch.batch_size == 0:
            ok0 = np.zeros(0, dtype=bool)
            done = ((batch, ok0, np.zeros(0, dtype=np.int64))
                    if return_index else (batch, ok0))
            return PendingUnprotect(self, [], batch, return_index, done=done)
        stream0 = np.asarray(batch.stream, dtype=np.int64)
        if self._kdr_active(stream0):
            return PendingUnprotect(self, [], batch, return_index,
                                    done=self.unprotect_rtp(batch,
                                                            return_index))
        pend = []
        for rows, part, n in bucket_by_size(batch):
            rec = self._unprotect_dispatch(part)
            rec["res"] = Download(self.device, *rec["res"])
            pend.append((rows, rec, n))
        p = PendingUnprotect(self, pend, batch, return_index)
        self._inflight_unprotect = p
        return p

    def _unprotect_dispatch(self, batch: PacketBatch) -> dict:
        """One part's header parse, index estimation and launch; no host
        RX state is read beyond `rx_max` (current, thanks to the commit
        barrier) and none is written.  `res` holds the device results
        (data, mlen, auth_ok)."""
        p = self.policy
        hdr = rtp_header.parse(batch)
        stream = np.asarray(batch.stream, dtype=np.int64)
        length = np.asarray(batch.length, dtype=np.int32)
        # hdr.valid is deliberately not used: its padding-length check
        # reads the last byte, which is still ciphertext/tag here
        srow = np.clip(stream, 0, self.capacity - 1)
        valid = ((hdr.version == 2)
                 & (length >= hdr.header_len + p.auth_tag_len)
                 & self.active[srow] & (stream >= 0)
                 & (stream < self.capacity))
        idx = self._estimate_rx_indices(stream, hdr.seq)
        if self._gcm:
            res = self._gcm_rtp_call(stream, srow, batch, hdr, idx, length,
                                     True)
        else:
            iv = self._rtp_iv(srow, hdr, idx)
            with record_function("srtp.upload"):
                args = self._kernel_args(srow, batch, hdr, iv, idx >> 16,
                                         length)
            with record_function("srtp.kernel"):
                res = kernel.srtp_unprotect(*args, p.auth_tag_len,
                                            self.cipher,
                                            self._device_tables()[2])
        return {"part": batch, "stream": stream, "srow": srow,
                "length": length, "valid": valid, "idx": idx, "res": res}

    def _commit_part(self, rec: dict) -> np.ndarray:
        """The replay verdict chain of one dispatched part, in order:
        check against the current window, count, accept, dedup, update.
        Returns the part's ok mask."""
        stream, srow, idx, valid = (rec["stream"], rec["srow"], rec["idx"],
                                    rec["valid"])
        auth_ok = rec["res"].numpy()[2]
        not_replayed = replay.check(self.rx_max, self.rx_mask, srow, idx)
        np.add.at(self.auth_fail, srow, valid & not_replayed & ~auth_ok)
        np.add.at(self.replay_reject, srow, valid & ~not_replayed)
        ok = valid & not_replayed & auth_ok
        # in-batch duplicate indices: keep the first *authenticated*
        # occurrence (a forged front-runner fails auth and must not block
        # the genuine copy later in the batch)
        ok &= ~replay.dedup_first(stream, idx, ok)
        replay.update(self.rx_max, self.rx_mask, stream, idx, ok)
        return ok

    # ----------------------------------------------------------------- RTCP
    def protect_rtcp(self, batch: PacketBatch) -> PacketBatch:
        """Encrypt + index + tag outgoing compound RTCP (kernel I and its
        F8 and NULL instances).

        The SRTCP index is assigned sequentially per stream in batch
        order; the E bit is set when the session encrypts (RFC 3711 §3.4:
        always under CM and F8, never under NULL).
        Reference: SRTCPTransformer.transform → SRTCPCryptoContext.
        """
        stream = np.asarray(batch.stream, dtype=np.int64)
        self._require_active(stream)
        max_len = int(np.max(batch.length, initial=0))
        if max_len + 4 + self.policy.auth_tag_len > batch.capacity:
            raise ValueError(
                f"packet of {max_len}B + index/tag exceeds capacity "
                f"{batch.capacity}")
        if batch.batch_size == 0:
            return batch
        index = self.rtcp_tx_index[stream] + 1 + segment_ranks(stream)
        if self._kdr_active(stream):
            waves, r = self._epoch_plan(stream, index, rtcp=True)
            if waves is not None:
                done = [(w, self.protect_rtcp(self._row_subset(batch, w)),
                         None, None) for w in waves]
                out, _, _ = self._merge_row_results(batch.batch_size, done)
                return out
            self._apply_epochs(stream, r, rtcp=True)
        with record_function("srtp.protect_rtcp"):
            if self._gcm:
                out = self._protect_rtcp_gcm(batch, stream, index)
                np.maximum.at(self.rtcp_tx_index, stream, index)
                return out
            e = np.int64(0 if self.cipher == "null" else 1 << 31)
            index_word = index | e
            ssrc = rtp_header.read_u32(batch.data, 4)
            if self._f8:
                iv = self._f8_rtcp_iv(batch.data, index_word)
            else:
                iv = self._cm_iv(self._salt_rtcp[stream], ssrc, index)
            d = self.device
            tab_rk, tab_mid, tab_f8 = self._device_tables_rtcp()
            data, length = kernel.srtcp_protect(
                tab_rk, tab_mid, to_device(stream.astype(np.int32), d),
                to_device(batch.data, d),
                to_device(np.asarray(batch.length, dtype=np.int32), d),
                to_device(iv, d),
                to_device((index_word & 0xFFFFFFFF).astype(np.uint32)
                          .view(np.int32), d),
                self.policy.auth_tag_len, self.cipher, tab_f8)
            data, length = data.cpu().numpy(), length.cpu().numpy()
            np.maximum.at(self.rtcp_tx_index, stream, index)
        return PacketBatch(data, length, batch.stream)

    def unprotect_rtcp(self, batch: PacketBatch):
        """Auth-check, replay-check and decrypt incoming SRTCP (kernel J
        and its F8 and NULL instances).

        The host parses the E || index trailer before the launch to build
        the IVs and keeps the replay window; rows with E = 0 pass through
        undecrypted (under NULL every row does).  Returns (batch', ok);
        rows with ok=False keep their original bytes.
        Reference: SRTCPTransformer.reverseTransform.
        """
        p = self.policy
        stream = np.asarray(batch.stream, dtype=np.int64)
        length = np.asarray(batch.length, dtype=np.int32)
        if batch.batch_size == 0:
            return batch, np.zeros(0, dtype=bool)
        srow = np.clip(stream, 0, self.capacity - 1)
        valid = ((length >= 8 + 4 + p.auth_tag_len) & self.active[srow]
                 & (stream >= 0) & (stream < self.capacity))
        # the trailer's E || index word sits before the tag (after it
        # under GCM, RFC 7714 §9)
        tpos = np.maximum(length - (4 if self._gcm
                                    else p.auth_tag_len + 4), 0)
        word = np.zeros(len(stream), dtype=np.int64)
        for k in range(4):
            col = np.minimum(tpos + k, batch.capacity - 1)
            word = (word << 8) | np.take_along_axis(
                batch.data, col[:, None].astype(np.int64), axis=1)[:, 0]
        index = word & 0x7FFFFFFF
        if self._kdr_active(stream):
            waves, r = self._epoch_plan(stream, index, rtcp=True)
            if waves is not None:
                done = []
                for w in waves:
                    o, okp = self.unprotect_rtcp(self._row_subset(batch, w))
                    done.append((w, o, okp, None))
                out, ok, _ = self._merge_row_results(batch.batch_size, done)
                return out, ok
            self._apply_epochs(stream, r, rtcp=True)
        with record_function("srtp.unprotect_rtcp"):
            ssrc = rtp_header.read_u32(batch.data, 4)
            not_replayed = replay.check(self.rtcp_rx_max, self.rtcp_rx_mask,
                                        srow, index)
            if self._gcm:
                data, mlen, auth_ok = self._unprotect_rtcp_gcm(
                    batch, srow, ssrc, index, word, length)
            else:
                if self._f8:
                    iv = self._f8_rtcp_iv(batch.data, word)
                else:
                    iv = self._cm_iv(self._salt_rtcp[srow], ssrc, index)
                d = self.device
                tab_rk, tab_mid, tab_f8 = self._device_tables_rtcp()
                res = kernel.srtcp_unprotect(
                    tab_rk, tab_mid, to_device(srow.astype(np.int32), d),
                    to_device(batch.data, d), to_device(length, d),
                    to_device(iv, d), p.auth_tag_len, self.cipher, tab_f8)
                data, mlen, auth_ok = (t.cpu().numpy() for t in res[:3])
            np.add.at(self.auth_fail, srow, valid & not_replayed & ~auth_ok)
            np.add.at(self.replay_reject, srow, valid & ~not_replayed)
            ok = valid & not_replayed & auth_ok
            ok &= ~replay.dedup_first(stream, index, ok)
            replay.update(self.rtcp_rx_max, self.rtcp_rx_mask, stream, index,
                          ok)
            out_data = np.where(ok[:, None], data, batch.data)
            out_len = np.where(ok, mlen, length).astype(np.int32)
        return PacketBatch(out_data, out_len, batch.stream), ok

    def _rtcp_gcm_call(self, srow, kin, klen, iv12, opening: bool):
        """M or N over SRTCP rows in the kernels' layout, hdr8 || E ||
        index || payload (the AAD is the first 12 bytes)."""
        d = self.device
        tab_rk, tab_gm, _ = self._device_tables_rtcp()
        fn = kernel.srtp_gcm_unprotect if opening else kernel.srtp_gcm_protect
        res = fn(tab_rk, tab_gm, to_device(srow.astype(np.int32), d),
                 to_device(kin, d), to_device(klen.astype(np.int32), d),
                 to_device(np.full(len(klen), 12, np.int32), d),
                 to_device(iv12, d))
        return tuple(t.cpu().numpy() for t in res)

    @staticmethod
    def _word_bytes(word: np.ndarray) -> np.ndarray:
        w = np.asarray(word, dtype=np.int64)
        return np.stack([(w >> (8 * (3 - k))) & 0xFF for k in range(4)],
                        axis=1).astype(np.uint8)

    def _protect_rtcp_gcm(self, batch: PacketBatch, stream: np.ndarray,
                          index: np.ndarray) -> PacketBatch:
        """RFC 7714 §9: AAD = RTCP header (8) || E || index; on the wire
        the index word follows the ciphertext and tag.  The host moves
        the word in front of the payload for kernel M and back after it
        (RTCP is low-rate)."""
        cap = batch.capacity
        length = np.asarray(batch.length, dtype=np.int64)
        plen = length - 8
        wb = self._word_bytes(index | (1 << 31))       # E always set: AEAD
        cols = np.arange(cap, dtype=np.int64)[None, :]
        kin = np.zeros_like(batch.data)
        kin[:, :8] = batch.data[:, :8]
        kin[:, 8:12] = wb
        shifted = np.take_along_axis(batch.data,
                                     np.clip(cols - 4, 0, cap - 1), axis=1)
        sel = (cols >= 12) & (cols < (12 + plen)[:, None])
        kin = np.where(sel, shifted, kin).astype(np.uint8)
        ssrc = rtp_header.read_u32(batch.data, 4)
        iv12 = self._gcm_rtcp_iv(stream, ssrc, index)
        out, _ = self._rtcp_gcm_call(stream, kin, 12 + plen, iv12, False)
        # wire: hdr8 || ct || tag || word
        wire = np.zeros_like(out)
        wire[:, :8] = out[:, :8]
        unshift = np.take_along_axis(out, np.minimum(cols + 4, cap - 1),
                                     axis=1)
        sel2 = (cols >= 8) & (cols < (8 + plen + 16)[:, None])
        wire = np.where(sel2, unshift, wire).astype(np.uint8)
        wpos = 8 + plen + 16
        for k in range(4):
            np.put_along_axis(wire, (wpos + k)[:, None], wb[:, k][:, None],
                              axis=1)
        return PacketBatch(wire, (wpos + 4).astype(np.int32), batch.stream)

    def _unprotect_rtcp_gcm(self, batch: PacketBatch, srow, ssrc, index,
                            word, length):
        """Reverse of `_protect_rtcp_gcm`: the wire's hdr8 || ct || tag ||
        word into the kernel's hdr8 || word || ct || tag, kernel N, and
        hdr8 || plaintext out.  Returns (data, mlen, auth_ok)."""
        cap = batch.capacity
        ctlen = np.maximum(np.asarray(length, np.int64) - 8 - 16 - 4, 0)
        cols = np.arange(cap, dtype=np.int64)[None, :]
        kin = np.zeros_like(batch.data)
        kin[:, :8] = batch.data[:, :8]
        kin[:, 8:12] = self._word_bytes(word)
        shifted = np.take_along_axis(batch.data,
                                     np.clip(cols - 4, 0, cap - 1), axis=1)
        sel = (cols >= 12) & (cols < (12 + ctlen + 16)[:, None])
        kin = np.where(sel, shifted, kin).astype(np.uint8)
        iv12 = self._gcm_rtcp_iv(srow, ssrc, index)
        dec, _, auth_ok = self._rtcp_gcm_call(srow, kin, 12 + ctlen + 16,
                                              iv12, True)
        out = np.zeros_like(dec)
        out[:, :8] = dec[:, :8]
        unshift = np.take_along_axis(dec, np.minimum(cols + 4, cap - 1),
                                     axis=1)
        sel2 = (cols >= 8) & (cols < (8 + ctlen)[:, None])
        out = np.where(sel2, unshift, out).astype(np.uint8)
        return out, (8 + ctlen).astype(np.int32), auth_ok

    # ------------------------------------------------------------ checkpoint
    _SNAP_ARRAYS = ("active", "rk_rtp", "mid_rtp", "rk_rtcp", "mid_rtcp",
                    "salt_rtp", "salt_rtcp", "tx_ext", "rx_max", "rx_mask",
                    "rtcp_tx_index", "rtcp_rx_max", "rtcp_rx_mask",
                    "auth_fail", "replay_reject")
    _SNAP_F8 = ("rk_f8_rtp", "rk_f8_rtcp")
    _SNAP_GCM = ("gm_rtp", "gm_rtcp")
    _SNAP_KDR = ("kdr", "epoch_rtp", "epoch_rtcp")
    _PRIVATE = {"rk_rtp", "mid_rtp", "rk_rtcp", "mid_rtcp", "salt_rtp",
                "salt_rtcp", "rk_f8_rtp", "rk_f8_rtcp", "epoch_rtp",
                "epoch_rtcp"}

    def _attr(self, key: str) -> str:
        return "_" + key if key in self._PRIVATE else key

    def _snap_keys(self):
        return self._SNAP_ARRAYS + (self._SNAP_F8 if self._f8 else ())

    def snapshot(self) -> dict:
        """Serializable crypto-state snapshot (ROC/replay survive
        restarts), in the JAX package's format."""
        self._commit_inflight_unprotect()
        snap = {"profile": self.profile.value}
        for key in self._snap_keys() + self._SNAP_KDR:
            snap[key] = getattr(self, self._attr(key)).copy()
        if self._gcm:
            # the JAX package's [S, 128, 128] int8 form, for the active
            # rows; the zeros of the others stay untouched pages
            rows = np.nonzero(self.active)[0]
            for key in self._SNAP_GCM:
                full = np.zeros((self.capacity, 128, 128), dtype=np.int8)
                full[rows] = unpack_matrices(getattr(self, "_" + key)[rows])
                snap[key] = full
        snap["masters"] = dict(self._masters)
        return snap

    @classmethod
    def restore(cls, snap: dict, device: DeviceLike = None
                ) -> "SrtpStreamTable":
        """Build a table from a snapshot of either package (same format);
        snapshots older than the kdr fields restore with kdr 0."""
        t = cls(capacity=len(snap["active"]),
                profile=SrtpProfile(snap["profile"]), device=device)
        keys = t._snap_keys() + (t._SNAP_KDR if "kdr" in snap else ())
        for key in keys:
            have = getattr(t, t._attr(key))
            val = np.asarray(snap[key])
            if val.shape != have.shape:
                raise ValueError(f"snapshot {key}: shape {val.shape}, "
                                 f"expected {have.shape}")
            setattr(t, t._attr(key), val.astype(have.dtype, copy=True))
        if t._gcm:
            for key in t._SNAP_GCM:
                val = np.asarray(snap[key])
                if val.shape != (t.capacity, 128, 128):
                    raise ValueError(f"snapshot {key}: shape {val.shape}, "
                                     f"expected {(t.capacity, 128, 128)}")
                setattr(t, "_" + key, pack_matrices(val))
        t._masters = {int(k): (bytes(v[0]), bytes(v[1]))
                      for k, v in snap.get("masters", {}).items()}
        return t

    @classmethod
    def from_jax_state(cls, snap: dict, device: DeviceLike = None
                       ) -> "SrtpStreamTable":
        """Adopt the JAX table's `snapshot()` — a dict of NumPy arrays —
        including ROC, tx index, replay state and kdr epochs, so both
        tables process the next batch identically."""
        return cls.restore(snap, device)


def _uniform_off(payload_off: np.ndarray, width: int) -> "int | None":
    """The one payload offset of a part whose rows all agree, inside the
    row; None otherwise (the keystream cache serves such parts only)."""
    off = np.asarray(payload_off)
    if off.size and np.all(off == off.flat[0]):
        v = int(off.flat[0])
        if 0 <= v < width:
            return v
    return None


def _assemble_unprotect(parts, batch: PacketBatch, return_index: bool):
    """The output of an unprotect from its committed parts [(rows, rec, n,
    ok)]: accepted rows decrypted, every other row with its original
    bytes and length."""
    done, masks = [], []
    idx = np.zeros(batch.batch_size, dtype=np.int64)
    for rows, rec, n, ok in parts:
        data, mlen, _ = rec["res"].numpy()
        out_data = np.where(ok[:, None], data, rec["part"].data)
        out_len = np.where(ok, mlen, rec["length"]).astype(np.int32)
        done.append((rows, PacketBatch(out_data, out_len,
                                       rec["part"].stream), n))
        masks.append(ok)
        idx[rows] = rec["idx"][:n]
    out, okall = unbucket(done, batch.batch_size, batch.capacity, masks)
    # ok=False rows keep their original bytes (contract above)
    out.data[~okall, :] = 0
    take = min(out.capacity, batch.capacity)
    out.data[~okall, :take] = batch.data[~okall, :take]
    out.length[~okall] = np.asarray(batch.length)[~okall]
    return (out, okall, idx) if return_index else (out, okall)


class PendingProtect:
    """An in-flight `protect_rtp_async` call.

    Host state is already committed; `result()` waits for the parts'
    copies and reassembles the batch.  Single-shot: result() caches and
    returns the same batch again.
    """

    def __init__(self, parts, batch_size: int, capacity: int,
                 done: "PacketBatch | None" = None):
        self._parts = parts
        self._batch_size = batch_size
        self._capacity = capacity
        self._done = done

    def block_until_ready(self) -> "PendingProtect":
        """Wait for the dispatched work and its copies, without
        reassembling."""
        for _rows, (dl, _stream), _n in self._parts:
            dl.wait()
        return self

    def result(self) -> PacketBatch:
        if self._done is None:
            done = []
            for rows, (dl, stream), n in self._parts:
                data, length = dl.numpy()
                done.append((rows, PacketBatch(data, length, stream), n))
            self._done, _ = unbucket(done, self._batch_size, self._capacity)
            self._parts = []
        return self._done


class PendingUnprotect:
    """An in-flight `unprotect_rtp_async` call.

    The kernels are launched; the host RX state is not touched: the
    replay verdict chain (check → dedup → update) must run in dispatch
    order against current windows, so it waits for `commit()`, which the
    owning table forces before any newer unprotect, key mutation or
    snapshot can see stale state.  `result()` commits, then assembles the
    output: failed rows keep their original bytes, read from the
    dispatched batch.  Single-shot: result() caches.
    """

    def __init__(self, table: SrtpStreamTable, parts, batch: PacketBatch,
                 return_index: bool, done=None):
        self._table = table
        self._parts = parts
        self._batch = batch
        self._return_index = return_index
        self._committed = done is not None
        self._ok_parts = None
        self._done = done

    def block_until_ready(self) -> "PendingUnprotect":
        """Wait for the dispatched work and its copies, without
        committing."""
        for _rows, rec, _n in self._parts:
            rec["res"].wait()
        return self

    def commit(self) -> None:
        """Wait for the verdicts and commit host replay state and failure
        counters part by part, in order (each part's replay check sees
        the previous part's update, exactly like the sync path)."""
        if self._committed:
            return
        self._committed = True
        t = self._table
        if t._inflight_unprotect is self:
            t._inflight_unprotect = None
        self._ok_parts = [t._commit_part(rec) for _r, rec, _n in self._parts]

    def result(self):
        """(batch, ok) — or (batch, ok, index) when dispatched with
        `return_index` — matching `unprotect_rtp`'s contract."""
        if self._done is None:
            self.commit()
            parts = [(rows, rec, n, ok) for (rows, rec, n), ok
                     in zip(self._parts, self._ok_parts)]
            self._done = _assemble_unprotect(parts, self._batch,
                                             self._return_index)
            self._parts, self._batch, self._ok_parts = [], None, None
        return self._done
