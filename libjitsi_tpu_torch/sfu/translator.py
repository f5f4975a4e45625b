"""RTP translator — the SFU fan-out primitive (BASELINE config #5).

Counterpart: `libjitsi_tpu/sfu/translator.py` `RtpTranslator`, the
AES-CM, NULL and AES-F8 profiles with HMAC-SHA1.  Reference:
`org.jitsi.impl.neomedia.rtp.translator.RTPTranslatorImpl` fans each
received packet from one `StreamRTPManager` to all the others, re-running
every receiver leg's send chain — one SRTP re-encrypt per receiver per
packet (SURVEY §3.4).  Here the packets are
decrypted once and one launch of kernel H (`csrc/srtp_fanout.cu`, through
`transform.srtp.kernel.srtp_fanout_protect`) re-encrypts the whole
(packets x receivers) grid.

Key observations that keep the layout small (RFC 3711): session keys
depend only on each receiver endpoint's master key, so the key tables are
per receiver leg ([R, rounds, 16] round keys, [R, 2, 5] midstates, [R, 16]
salts); and the forwarded packet keeps the sender's SSRC/seq/ts, so the
SRTP index of every copy is the sender's authenticated index.

Unlike the JAX translator, the host does not expand the grid: it uploads
the P packets once with their SSRCs and indices, plus each output row's
packet and leg, and the kernel builds every copy's IV.  The JAX path's
row-class and width padding exist for XLA's compile cache and are not
ported: a launch's rows are as wide as its longest copy with its tag,
in whole 16-byte units.  Output rows are packet-major, each packet's
receivers in the sorted order of its route, exactly as the JAX
`translate` orders them.

Under NULL_HMAC_SHA1_80 each copy is tagged under its leg's key and its
payload stays in clear (H's NULL instance), as the JAX translator does
(`encrypt = cipher != NULL`).  Under F8_128_HMAC_SHA1_80 each copy is
encrypted with AES-F8 under its leg's keys (H's F8 instance): the
translator keeps a second schedule a leg, k_e XOR m, as the F8 table
does, and builds each packet's RFC 3711 §4.1.2 IV from its header and
ROC.  The JAX translator encrypts F8 copies with AES-CM (its fault,
ROADMAP Queue 3), so the port's F8 copies equal the F8 table's
`protect_rtp` of the leg at the same index, not the JAX translator's.
AEAD-GCM fan-out (K11's `:73`, `:81`) is not ported yet (ROADMAP Queue
1, item 8).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from libjitsi_tpu_torch.core.device import DeviceLike, resolve_device, to_device
from libjitsi_tpu_torch.core.packet import PacketBatch
from libjitsi_tpu_torch.kernels.aes import expand_key, expand_keys_batch
from libjitsi_tpu_torch.kernels.sha1 import (hmac_precompute,
                                             hmac_precompute_batch)
from libjitsi_tpu_torch.rtp import header as rtp_header
from libjitsi_tpu_torch.transform.srtp import kernel
from libjitsi_tpu_torch.transform.srtp.context import (CIPHER_NAME,
                                                       Download,
                                                       f8_rtp_iv,
                                                       f8_schedules)
from libjitsi_tpu_torch.transform.srtp.kdf import (derive_session_keys,
                                                   derive_session_keys_batch)
from libjitsi_tpu_torch.transform.srtp.policy import (Auth, Cipher,
                                                      SrtpProfile)


class RtpTranslator:
    """Decrypt-once / re-encrypt-N fan-out over a receiver key table.

    Receivers are endpoint legs with their own SRTP master keys; senders
    are identified by their decrypted packets' stream ids; the routing
    table says which receivers get which sender's media.  `device` None
    means the card; the tests pass device="cpu".
    """

    def __init__(self, capacity: int = 1024,
                 profile: SrtpProfile = SrtpProfile.AES_CM_128_HMAC_SHA1_80,
                 device: DeviceLike = None):
        policy = profile.policy
        if policy.cipher == Cipher.AES_GCM or policy.auth != Auth.HMAC_SHA1:
            raise NotImplementedError(
                f"fan-out for profile {profile.value} is not ported yet "
                "(ROADMAP Queue 1, item 8)")
        self.profile = profile
        self.policy = policy
        self.cipher = CIPHER_NAME[policy.cipher]
        self.device = resolve_device(device)
        rounds = {16: 11, 32: 15}[policy.enc_key_len]
        self.capacity = capacity
        self.active = np.zeros(capacity, dtype=bool)
        self._rk = np.zeros((capacity, rounds, 16), dtype=np.uint8)
        self._mid = np.zeros((capacity, 2, 5), dtype=np.uint32)
        self._salt = np.zeros((capacity, 16), dtype=np.uint8)
        # AES-F8: each leg's second schedule, k_e XOR m (RFC 3711
        # §4.1.2.2), for IV'
        self._rk_f8 = (np.zeros((capacity, rounds, 16), dtype=np.uint8)
                       if self.cipher == "f8" else None)
        self._dev = None
        # routing: sender sid -> sorted receiver id array
        self._routes: Dict[int, np.ndarray] = {}

    # ---------------------------------------------------------- receivers
    def add_receiver(self, rid: int, master_key: bytes,
                     master_salt: bytes) -> None:
        p = self.policy
        ks = derive_session_keys(
            master_key, master_salt, enc_key_len=p.enc_key_len,
            auth_key_len=p.auth_key_len, salt_len=p.salt_len)
        self._rk[rid] = expand_key(ks.rtp_enc)
        if self._rk_f8 is not None:
            self._rk_f8[rid] = f8_schedules(
                np.frombuffer(ks.rtp_enc, np.uint8)[None],
                np.frombuffer(ks.rtp_salt, np.uint8)[None])[0]
        self._mid[rid] = hmac_precompute(ks.rtp_auth)
        self._salt[rid, :p.salt_len] = np.frombuffer(ks.rtp_salt, np.uint8)
        self._salt[rid, p.salt_len:] = 0
        self.active[rid] = True
        self._dev = None

    def add_receivers(self, rids, master_keys, master_salts) -> None:
        """Vectorized bulk `add_receiver`: one batched KDF, key schedule
        and midstate pass."""
        rids = np.asarray(rids, dtype=np.int64)
        if len(rids) == 0:
            return
        p = self.policy

        def rows(keys):          # accept bytes rows like add_receiver
            return np.stack([np.frombuffer(bytes(k), dtype=np.uint8)
                             for k in keys])

        ksb = derive_session_keys_batch(
            rows(master_keys), rows(master_salts),
            enc_key_len=p.enc_key_len, auth_key_len=p.auth_key_len,
            salt_len=p.salt_len)
        self._rk[rids] = expand_keys_batch(ksb.rtp_enc)
        if self._rk_f8 is not None:
            self._rk_f8[rids] = f8_schedules(ksb.rtp_enc, ksb.rtp_salt)
        self._mid[rids] = hmac_precompute_batch(ksb.rtp_auth)
        self._salt[rids, :p.salt_len] = ksb.rtp_salt
        self._salt[rids, p.salt_len:] = 0
        self.active[rids] = True
        self._dev = None

    def remove_receiver(self, rid: int) -> None:
        self.active[rid] = False
        self._rk[rid] = 0
        self._mid[rid] = 0
        if self._rk_f8 is not None:
            self._rk_f8[rid] = 0
        self._dev = None
        for s, rr in list(self._routes.items()):
            self._routes[s] = rr[rr != rid]

    def move_receivers(self, src_rids, dst_rids) -> None:
        """Relocate receiver legs to new rows bit-exact; routes that name
        the old rows are rewritten."""
        src = np.asarray(src_rids, dtype=np.int64)
        dst = np.asarray(dst_rids, dtype=np.int64)
        if src.size != dst.size:
            raise ValueError("src/dst length mismatch")
        if src.size == 0:
            return
        if not self.active[src].all():
            raise ValueError("cannot move inactive receiver rows")
        if self.active[dst].any():
            raise ValueError("destination receiver rows occupied")
        for tab in self._key_tables():
            tab[dst] = tab[src]
        self.active[dst] = True
        remap = {int(s): int(d) for s, d in zip(src, dst)}
        for s_sid, rr in list(self._routes.items()):
            self._routes[s_sid] = np.asarray(
                [remap.get(int(r), int(r)) for r in rr], dtype=rr.dtype)
        self.active[src] = False
        for tab in self._key_tables():
            tab[src] = 0
        self._dev = None

    def _key_tables(self):
        tabs = [self._rk, self._mid, self._salt]
        return tabs + ([self._rk_f8] if self._rk_f8 is not None else [])

    # ------------------------------------------------------------ routing
    def connect(self, sender_sid: int, receiver_ids: Sequence[int]) -> None:
        """Declare that `sender_sid`'s media goes to these receivers
        (reference: the translator's willWrite acceptance per target)."""
        self._routes[sender_sid] = np.unique(
            np.asarray(receiver_ids, dtype=np.int64))

    def disconnect(self, sender_sid: int) -> None:
        self._routes.pop(sender_sid, None)

    def _device_tables(self):
        if self._dev is None:
            d = self.device
            self._dev = (to_device(self._rk, d),
                         to_device(self._mid.view(np.int32), d),
                         to_device(self._salt, d),
                         None if self._rk_f8 is None
                         else to_device(self._rk_f8, d))
        return self._dev

    # ------------------------------------------------------------ fan-out
    def translate(self, batch: PacketBatch, index: np.ndarray
                  ) -> Tuple[PacketBatch, np.ndarray]:
        """Fan out decrypted sender packets to their receivers, batched.

        batch: decrypted RTP with `stream` = sender sid; `index` [B] is
        each packet's 48-bit SRTP index (`SrtpStreamTable.unprotect_rtp(
        ..., return_index=True)`).  Returns (wire_batch, receiver_ids):
        one row per (packet, receiver), each protected with its
        receiver's session keys.  Packets from senders with no route
        produce no rows.
        """
        return self.translate_async(batch, index).result()

    def translate_async(self, batch: PacketBatch, index: np.ndarray
                        ) -> "PendingTranslate":
        """Launch-only `translate`: kernel H's instance is enqueued on the
        device's stream, its rows copied back behind a CUDA event on the
        card, and `.result()` waits for them."""
        stream = np.asarray(batch.stream, dtype=np.int64)
        rows: List[int] = []
        recvs: List[np.ndarray] = []
        for i, sid in enumerate(stream):
            rr = self._routes.get(int(sid))
            if rr is None or len(rr) == 0:
                continue
            rows.append(i)
            recvs.append(rr)
        if not rows:
            return PendingTranslate(None, np.zeros(0, np.int64),
                                    batch.capacity)
        counts = np.array([len(r) for r in recvs])
        src = np.repeat(np.array(rows, dtype=np.int64), counts)
        recv = np.concatenate(recvs)
        if not np.all(self.active[recv]):
            raise KeyError("route to receiver without installed keys")
        length = np.asarray(batch.length, dtype=np.int32)
        if int(np.max(length[src], initial=0)) + self.policy.auth_tag_len \
                > batch.capacity:
            raise ValueError("fan-out rows need tag headroom in capacity")
        hdr = rtp_header.parse(batch)
        # rows as wide as the longest routed copy with its tag (in whole
        # 16-byte units): voice in MTU-wide receive buffers would move ~8x
        # the bytes through the kernel and back
        width = min(batch.capacity, -(-(int(np.max(length[src]))
                                         + self.policy.auth_tag_len) // 16)
                    * 16)
        index = np.asarray(index, dtype=np.int64)
        out, out_len = self._fanout_call(
            batch.data[:, :width], length, hdr, index, src, recv)
        return PendingTranslate(Download(self.device, out, out_len), recv,
                                batch.capacity)

    def _fanout_call(self, data, length, hdr, index, src, recv):
        """One launch of kernel H's instance for the profile's cipher over
        the (packet, leg) rows; under AES-F8 with each packet's IV."""
        d = self.device
        tab_rk, tab_mid, tab_salt, tab_f8 = self._device_tables()
        iv = None
        if self.cipher == "f8":
            iv = to_device(f8_rtp_iv(hdr, (index >> 16) & 0xFFFFFFFF), d)
        return kernel.srtp_fanout_protect(
            tab_rk, tab_mid, tab_salt, to_device(data, d),
            to_device(length, d),
            to_device(np.asarray(hdr.payload_off, dtype=np.int32), d),
            to_device((np.asarray(hdr.ssrc, dtype=np.int64) & 0xFFFFFFFF)
                      .astype(np.uint32).view(np.int32), d),
            to_device(index, d), to_device(src.astype(np.int32), d),
            to_device(recv.astype(np.int32), d), self.policy.auth_tag_len,
            self.cipher, tab_f8, iv)


class PendingTranslate:
    """An in-flight `translate_async` fan-out: its rows on their way to
    the host (`Download`: pinned copies behind a CUDA event on the card).
    `block_until_ready()` waits for them; `result()` reads them once and
    caches them."""

    def __init__(self, download: Optional[Download], recv: np.ndarray,
                 capacity: int):
        self._download = download
        self.recv = recv
        self._capacity = capacity
        self._done: Optional[Tuple[PacketBatch, np.ndarray]] = None

    def block_until_ready(self) -> "PendingTranslate":
        if self._download is not None:
            self._download.wait()
        return self

    def result(self) -> Tuple[PacketBatch, np.ndarray]:
        if self._done is None:
            if self._download is None:
                wire = PacketBatch.empty(0, self._capacity)
            else:
                data, length = self._download.numpy()
                wire = PacketBatch(data, length, self.recv.astype(np.int32))
            self._done = (wire, self.recv)
            self._download = None
        return self._done
