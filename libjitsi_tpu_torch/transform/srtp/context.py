"""SrtpStreamTable — batched SRTP crypto contexts for S streams (CM path).

Counterpart: `libjitsi_tpu/transform/srtp/context.py`.

The reference allocates one mutable `SRTPCryptoContext` per SSRC
(org.jitsi.impl.neomedia.transform.srtp.SRTPTransformer keeps a
Map<ssrc, context>) and runs per packet.  Here the contexts of all
streams are dense struct-of-arrays:

- key tables on `self.device`: AES round keys `[S, R, 16]` uint8 and
  HMAC midstates `[S, 2, 5]` (uint32 bit patterns in int32), uploaded
  from the host master copies whenever a mutation marks them dirty;
  kernels C and D gather rows by per-packet stream id themselves;
- host NumPy arrays: session salts (IV construction), ROC / highest
  index, replay windows, failure counters — the tiny sequential state
  machine (RFC 3711 Appendix A estimation, §3.3.2 replay) that stays on
  the host exactly as in the JAX package.

The snapshot format is the JAX package's, so `from_jax_state` adopts a
JAX table's `snapshot()` (plain NumPy arrays) and both tables then
process the next batch identically.

Ported: the AES-CM + HMAC-SHA1 profiles, synchronous `protect_rtp` /
`unprotect_rtp` (with `return_index`, the authenticated 48-bit
estimates the SFU fan-out re-uses) with size-class bucketing, SRTCP
`protect_rtcp` / `unprotect_rtcp` (kernels I and J), installs and
removals, snapshot and restore.  Not yet ported, each raising
`NotImplementedError`: the dispatch-only (async) seams, key derivation
rate epochs and `move_rows` (ROADMAP Queue 1, item 5), AEAD-GCM (item
8) and AES-F8 / NULL ciphers (item 5).

`protect_rtp` and `unprotect_rtp` run inside `record_function` spans
(`srtp.protect_rtp`, `srtp.unprotect_rtp`, and for each size class
`srtp.upload`, `srtp.kernel`, `srtp.download`), as do `protect_rtcp`
and `unprotect_rtcp` (`srtp.protect_rtcp`, `srtp.unprotect_rtcp`), so
a profiler trace splits a call into host work, copies and kernels.

A "stream" row is one direction of one SSRC: use separate tables for tx
and rx, as the reference keeps separate forward/reverse context maps.
"""

from __future__ import annotations

import numpy as np
from torch.profiler import record_function

from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device, to_device
from libjitsi_tpu_torch.core.packet import PacketBatch, bucket_by_size, unbucket
from libjitsi_tpu_torch.core.rtp_math import (chain_packet_indices,
                                              estimate_packet_index,
                                              segment_ranks)
from libjitsi_tpu_torch.kernels.aes import expand_key, expand_keys_batch
from libjitsi_tpu_torch.kernels.sha1 import (hmac_precompute,
                                             hmac_precompute_batch)
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.transform.srtp import kernel, replay
from libjitsi_tpu_torch.transform.srtp.kdf import (derive_session_keys,
                                                   derive_session_keys_batch)
from libjitsi_tpu_torch.transform.srtp.policy import (Auth, Cipher,
                                                      SrtpPolicy, SrtpProfile)

_ITEM5 = "ROADMAP Queue 1, item 5"
_CIPHER_ITEM = {Cipher.AES_GCM: "ROADMAP Queue 1, item 8 (AEAD-GCM)",
                Cipher.AES_F8: f"{_ITEM5} (AES-F8)",
                Cipher.NULL: f"{_ITEM5} (NULL cipher)"}


def _not_ported(what: str, item: str = _ITEM5):
    return NotImplementedError(f"{what} is not ported yet ({item})")


class SrtpStreamTable:
    """Batched crypto contexts for up to `capacity` streams of one profile.

    `device` None means the card; tests pass device="cpu".
    """

    def __init__(self, capacity: int = 1024,
                 profile: SrtpProfile = SrtpProfile.AES_CM_128_HMAC_SHA1_80,
                 device: DeviceLike = None):
        policy: SrtpPolicy = profile.policy
        if policy.cipher != Cipher.AES_CM or policy.auth != Auth.HMAC_SHA1:
            raise _not_ported(f"profile {profile.value}",
                              _CIPHER_ITEM[policy.cipher])
        self.profile = profile
        self.policy = policy
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

    # ------------------------------------------------------------------ keys
    def add_stream(self, sid: int, master_key: bytes, master_salt: bytes,
                   kdr: int = 0) -> None:
        """Derive session keys and install them at row `sid`.

        Reference: SRTPContextFactory + SRTPCryptoContext.deriveSrtpKeys.
        """
        p = self.policy
        if kdr:
            raise _not_ported("key derivation rate epochs")
        if len(master_key) != p.enc_key_len:
            raise ValueError(
                f"master key must be {p.enc_key_len}B for {self.profile.value}")
        if len(master_salt) != p.salt_len:
            raise ValueError(f"master salt must be {p.salt_len}B")
        ks = derive_session_keys(
            master_key, master_salt, enc_key_len=p.enc_key_len,
            auth_key_len=p.auth_key_len, salt_len=p.salt_len)
        self._rk_rtp[sid] = expand_key(ks.rtp_enc)
        self._rk_rtcp[sid] = expand_key(ks.rtcp_enc)
        self._mid_rtp[sid] = hmac_precompute(ks.rtp_auth)
        self._mid_rtcp[sid] = hmac_precompute(ks.rtcp_auth)
        self._salt_rtp[sid] = 0
        self._salt_rtp[sid, :p.salt_len] = np.frombuffer(ks.rtp_salt, np.uint8)
        self._salt_rtcp[sid] = 0
        self._salt_rtcp[sid, :p.salt_len] = np.frombuffer(ks.rtcp_salt,
                                                          np.uint8)
        self._reset_rows([sid])
        self.active[sid] = True

    def add_streams(self, sids, master_keys, master_salts, kdr=0) -> None:
        """Vectorized bulk install: `add_stream` for many rows at once
        (the KDF, key schedules and HMAC midstates run as single
        vectorized passes — a 10k-stream bootstrap)."""
        sids = np.asarray(sids, dtype=np.int64)
        mks = np.atleast_2d(np.asarray(master_keys, dtype=np.uint8))
        mss = np.atleast_2d(np.asarray(master_salts, dtype=np.uint8))
        s = len(sids)
        p = self.policy
        if np.any(np.asarray(kdr)):
            raise _not_ported("key derivation rate epochs")
        if mks.shape != (s, p.enc_key_len):
            raise ValueError(
                f"master keys must be [{s}, {p.enc_key_len}] for "
                f"{self.profile.value}, got {mks.shape}")
        if mss.shape != (s, p.salt_len):
            raise ValueError(f"master salts must be [{s}, {p.salt_len}]")
        ksb = derive_session_keys_batch(
            mks, mss, enc_key_len=p.enc_key_len,
            auth_key_len=p.auth_key_len, salt_len=p.salt_len)
        self._rk_rtp[sids] = expand_keys_batch(ksb.rtp_enc)
        self._rk_rtcp[sids] = expand_keys_batch(ksb.rtcp_enc)
        self._mid_rtp[sids] = hmac_precompute_batch(ksb.rtp_auth)
        self._mid_rtcp[sids] = hmac_precompute_batch(ksb.rtcp_auth)
        self._salt_rtp[sids] = 0
        self._salt_rtp[sids, :p.salt_len] = ksb.rtp_salt
        self._salt_rtcp[sids] = 0
        self._salt_rtcp[sids, :p.salt_len] = ksb.rtcp_salt
        self._reset_rows(sids)
        self.active[sids] = True

    def remove_stream(self, sid: int) -> None:
        self.remove_streams([sid])

    def remove_streams(self, sids) -> None:
        """Bulk teardown: key material is zeroed (a recycled row must
        never authenticate under a departed stream's keys) and all
        sequential state is reset so the row is immediately reusable."""
        sids = np.asarray(sids, dtype=np.int64)
        if sids.size == 0:
            return
        self.active[sids] = False
        for tab in (self._rk_rtp, self._rk_rtcp, self._mid_rtp,
                    self._mid_rtcp, self._salt_rtp, self._salt_rtcp):
            tab[sids] = 0
        self._reset_rows(sids)

    def _reset_rows(self, sids) -> None:
        self.tx_ext[sids] = -1
        self.rx_max[sids] = -1
        self.rx_mask[sids] = 0
        self.rtcp_tx_index[sids] = -1
        self.rtcp_rx_max[sids] = -1
        self.rtcp_rx_mask[sids] = 0
        self.auth_fail[sids] = 0
        self.replay_reject[sids] = 0
        self._dev = None
        self._dev_rtcp = None

    def _device_tables(self):
        """(round keys, midstates) of the RTP plane on `self.device`,
        uploaded again after any key mutation."""
        if self._dev is None:
            self._dev = (to_device(self._rk_rtp, self.device),
                         to_device(self._mid_rtp.view(np.int32), self.device))
        return self._dev

    def _device_tables_rtcp(self):
        """The same for the RTCP plane (kernels I and J)."""
        if self._dev_rtcp is None:
            self._dev_rtcp = (
                to_device(self._rk_rtcp, self.device),
                to_device(self._mid_rtcp.view(np.int32), self.device))
        return self._dev_rtcp

    def _require_active(self, stream: np.ndarray) -> None:
        """Protect-path guard: every row must map to an installed stream."""
        bad = (stream < 0) | (stream >= self.capacity) | ~self.active[
            np.clip(stream, 0, self.capacity - 1)]
        if np.any(bad):
            raise KeyError(
                f"protect on unmapped/inactive stream ids "
                f"{np.unique(stream[bad]).tolist()}")

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
        tab_rk, tab_mid = self._device_tables()
        return (tab_rk, tab_mid,
                to_device(stream.astype(np.int32), d),
                to_device(batch.data, d),
                to_device(np.asarray(length, dtype=np.int32), d),
                to_device(hdr.payload_off.astype(np.int32), d),
                to_device(iv, d),
                to_device((v & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
                          d))

    # ------------------------------------------------------------------ RTP
    def protect_rtp(self, batch: PacketBatch) -> PacketBatch:
        """Encrypt + tag a batch of outgoing RTP (rows in send order).

        Mixed-size batches are split into width/row size classes at this
        device boundary; padding rows repeat a real row (duplicate
        index: tx max unchanged) and are dropped on reassembly.
        Reference: SRTPTransformer.transform → SRTPCryptoContext.transformPacket.
        """
        if batch.batch_size == 0:
            return batch
        with record_function("srtp.protect_rtp"):
            done = [(rows, self._protect_part(part), n)
                    for rows, part, n in bucket_by_size(batch)]
            out, _ = unbucket(done, batch.batch_size, batch.capacity)
        return out

    def _protect_part(self, batch: PacketBatch) -> PacketBatch:
        hdr = rtp_header.parse(batch)
        stream = np.asarray(batch.stream, dtype=np.int64)
        self._require_active(stream)
        max_len = int(np.max(batch.length, initial=0))
        if max_len + self.policy.auth_tag_len > batch.capacity:
            raise ValueError(
                f"packet of {max_len}B + {self.policy.auth_tag_len}B tag "
                f"exceeds batch capacity {batch.capacity}")
        idx = chain_packet_indices(stream, hdr.seq, self.tx_ext)
        iv = self._cm_iv(self._salt_rtp[stream], hdr.ssrc, idx)
        with record_function("srtp.upload"):
            args = self._kernel_args(stream, batch, hdr, iv, idx >> 16,
                                     batch.length)
        with record_function("srtp.kernel"):
            data, length = kernel.srtp_protect(*args,
                                               self.policy.auth_tag_len)
        with record_function("srtp.download"):
            data, length = data.cpu().numpy(), length.cpu().numpy()
        np.maximum.at(self.tx_ext, stream, idx)
        return PacketBatch(data, length, batch.stream)

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
        if batch.batch_size == 0:
            ok0 = np.zeros(0, dtype=bool)
            if return_index:
                return batch, ok0, np.zeros(0, dtype=np.int64)
            return batch, ok0
        done, masks = [], []
        idx = np.zeros(batch.batch_size, dtype=np.int64)
        with record_function("srtp.unprotect_rtp"):
            for rows, part, n in bucket_by_size(batch):
                o, okp, idxp = self._unprotect_part(part)
                done.append((rows, o, n))
                masks.append(okp)
                idx[rows] = idxp[:n]
            out, ok = unbucket(done, batch.batch_size, batch.capacity, masks)
            # ok=False rows keep their original bytes (contract above)
            out.data[~ok, :] = 0
            take = min(out.capacity, batch.capacity)
            out.data[~ok, :take] = batch.data[~ok, :take]
            out.length[~ok] = np.asarray(batch.length)[~ok]
        if return_index:
            return out, ok, idx
        return out, ok

    def _unprotect_part(self, batch: PacketBatch):
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
        not_replayed = replay.check(self.rx_max, self.rx_mask, srow, idx)
        iv = self._cm_iv(self._salt_rtp[srow], hdr.ssrc, idx)
        with record_function("srtp.upload"):
            args = self._kernel_args(srow, batch, hdr, iv, idx >> 16, length)
        with record_function("srtp.kernel"):
            res = kernel.srtp_unprotect(*args, p.auth_tag_len)
        with record_function("srtp.download"):
            data, mlen, auth_ok = (t.cpu().numpy() for t in res)
        np.add.at(self.auth_fail, srow, valid & not_replayed & ~auth_ok)
        np.add.at(self.replay_reject, srow, valid & ~not_replayed)
        ok = valid & not_replayed & auth_ok
        # in-batch duplicate indices: keep the first *authenticated*
        # occurrence (a forged front-runner fails auth and must not block
        # the genuine copy later in the batch)
        ok &= ~replay.dedup_first(stream, idx, ok)
        replay.update(self.rx_max, self.rx_mask, stream, idx, ok)
        out_data = np.where(ok[:, None], data, batch.data)
        out_len = np.where(ok, mlen, length).astype(np.int32)
        return PacketBatch(out_data, out_len, batch.stream), ok, idx

    # ----------------------------------------------------------------- RTCP
    def protect_rtcp(self, batch: PacketBatch) -> PacketBatch:
        """Encrypt + index + tag outgoing compound RTCP (kernel I).

        The SRTCP index is assigned sequentially per stream in batch
        order and the E bit is set (RFC 3711 §3.4).
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
        with record_function("srtp.protect_rtcp"):
            index = self.rtcp_tx_index[stream] + 1 + segment_ranks(stream)
            index_word = index | np.int64(1 << 31)
            ssrc = rtp_header.read_u32(batch.data, 4)
            iv = self._cm_iv(self._salt_rtcp[stream], ssrc, index)
            d = self.device
            tab_rk, tab_mid = self._device_tables_rtcp()
            data, length = kernel.srtcp_protect(
                tab_rk, tab_mid, to_device(stream.astype(np.int32), d),
                to_device(batch.data, d),
                to_device(np.asarray(batch.length, dtype=np.int32), d),
                to_device(iv, d),
                to_device((index_word & 0xFFFFFFFF).astype(np.uint32)
                          .view(np.int32), d),
                self.policy.auth_tag_len)
            data, length = data.cpu().numpy(), length.cpu().numpy()
            np.maximum.at(self.rtcp_tx_index, stream, index)
        return PacketBatch(data, length, batch.stream)

    def unprotect_rtcp(self, batch: PacketBatch):
        """Auth-check, replay-check and decrypt incoming SRTCP (kernel J).

        The host parses the E || index trailer before the launch to build
        the IVs and keeps the replay window; rows with E = 0 pass through
        undecrypted.  Returns (batch', ok); rows with ok=False keep their
        original bytes.
        Reference: SRTCPTransformer.reverseTransform.
        """
        p = self.policy
        stream = np.asarray(batch.stream, dtype=np.int64)
        length = np.asarray(batch.length, dtype=np.int32)
        if batch.batch_size == 0:
            return batch, np.zeros(0, dtype=bool)
        with record_function("srtp.unprotect_rtcp"):
            srow = np.clip(stream, 0, self.capacity - 1)
            valid = ((length >= 8 + 4 + p.auth_tag_len) & self.active[srow]
                     & (stream >= 0) & (stream < self.capacity))
            # the trailer's E || index word sits before the tag
            tpos = np.maximum(length - (p.auth_tag_len + 4), 0)
            word = np.zeros(len(stream), dtype=np.int64)
            for k in range(4):
                col = np.minimum(tpos + k, batch.capacity - 1)
                word = (word << 8) | np.take_along_axis(
                    batch.data, col[:, None].astype(np.int64), axis=1)[:, 0]
            index = word & 0x7FFFFFFF
            ssrc = rtp_header.read_u32(batch.data, 4)
            not_replayed = replay.check(self.rtcp_rx_max, self.rtcp_rx_mask,
                                        srow, index)
            iv = self._cm_iv(self._salt_rtcp[srow], ssrc, index)
            d = self.device
            tab_rk, tab_mid = self._device_tables_rtcp()
            res = kernel.srtcp_unprotect(
                tab_rk, tab_mid, to_device(srow.astype(np.int32), d),
                to_device(batch.data, d), to_device(length, d),
                to_device(iv, d), p.auth_tag_len)
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

    # ------------------------------------------------ not ported in this slice
    def protect_rtp_async(self, batch):
        raise _not_ported("dispatch-only protect_rtp_async")

    def unprotect_rtp_async(self, batch):
        raise _not_ported("dispatch-only unprotect_rtp_async")

    def move_rows(self, src_sids, dst_sids):
        raise _not_ported("move_rows")

    # ------------------------------------------------------------ checkpoint
    _SNAP_ARRAYS = ("active", "rk_rtp", "mid_rtp", "rk_rtcp", "mid_rtcp",
                    "salt_rtp", "salt_rtcp", "tx_ext", "rx_max", "rx_mask",
                    "rtcp_tx_index", "rtcp_rx_max", "rtcp_rx_mask",
                    "auth_fail", "replay_reject")
    _PRIVATE = {"rk_rtp", "mid_rtp", "rk_rtcp", "mid_rtcp", "salt_rtp",
                "salt_rtcp"}

    def _attr(self, key: str) -> str:
        return "_" + key if key in self._PRIVATE else key

    def snapshot(self) -> dict:
        """Serializable crypto-state snapshot (ROC/replay survive
        restarts), in the JAX package's format."""
        snap = {"profile": self.profile.value}
        for key in self._SNAP_ARRAYS:
            snap[key] = getattr(self, self._attr(key)).copy()
        snap["kdr"] = np.zeros(self.capacity, dtype=np.int64)
        snap["epoch_rtp"] = np.zeros(self.capacity, dtype=np.int64)
        snap["epoch_rtcp"] = np.zeros(self.capacity, dtype=np.int64)
        snap["masters"] = {}
        return snap

    @classmethod
    def restore(cls, snap: dict, device: DeviceLike = None
                ) -> "SrtpStreamTable":
        """Build a table from a snapshot of either package (same format).
        Snapshots of kdr streams or GCM/F8 profiles are refused."""
        t = cls(capacity=len(snap["active"]),
                profile=SrtpProfile(snap["profile"]), device=device)
        if np.any(np.asarray(snap.get("kdr", 0))) or snap.get("masters"):
            raise _not_ported("key derivation rate epochs")
        for key in cls._SNAP_ARRAYS:
            have = getattr(t, t._attr(key))
            val = np.asarray(snap[key])
            if val.shape != have.shape:
                raise ValueError(f"snapshot {key}: shape {val.shape}, "
                                 f"expected {have.shape}")
            setattr(t, t._attr(key), val.astype(have.dtype, copy=True))
        return t

    @classmethod
    def from_jax_state(cls, snap: dict, device: DeviceLike = None
                       ) -> "SrtpStreamTable":
        """Adopt the JAX table's `snapshot()` — a dict of NumPy arrays —
        including ROC, tx index and replay state, so both tables process
        the next batch identically."""
        return cls.restore(snap, device)

