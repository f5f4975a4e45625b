"""Packet capture and replay fixtures: the pcap and rtpdump formats.

Counterpart: `libjitsi_tpu/io/pcap.py`, copied so the port imports
nothing of the JAX package; each writer writes the same bytes as its
counterpart there.  Two reference mechanisms:
- `org.jitsi.impl.packetlogging.PacketLoggingServiceImpl`, pcap logging
  of RTP/RTCP for debugging: `PcapWriter` is the tap `MediaLoop` calls
  with each ingress batch (`pcap_tap=`).
- `...jmfext.media.protocol.rtpdumpfile.*`, rtpdump traces played back
  as a capture device: `RtpdumpWriter` / `RtpdumpReader` handle rtpdump
  v1.0, so a recorded trace drives a test without hardware.
"""

from __future__ import annotations

import struct
import time
from typing import Iterator, List, Optional, Tuple

PCAP_MAGIC = 0xA1B2C3D4
LINKTYPE_RAW = 101  # packets start at the IPv4 header


def _ipv4_udp(payload: bytes, src_ip: int, dst_ip: int, src_port: int,
              dst_port: int) -> bytes:
    udp = struct.pack("!HHHH", src_port, dst_port, 8 + len(payload), 0) \
        + payload
    total = 20 + len(udp)
    hdr = struct.pack("!BBHHHBBHII", 0x45, 0, total, 0, 0, 64, 17, 0,
                      src_ip, dst_ip)
    # header checksum
    s = 0
    for i in range(0, 20, 2):
        s += struct.unpack("!H", hdr[i:i + 2])[0]
    s = (s & 0xFFFF) + (s >> 16)
    s = (s & 0xFFFF) + (s >> 16)
    hdr = hdr[:10] + struct.pack("!H", ~s & 0xFFFF) + hdr[12:]
    return hdr + udp


class PcapWriter:
    """Append UDP datagrams to a pcap file (raw-IP linktype)."""

    def __init__(self, path: str, snaplen: int = 65535):
        self._f = open(path, "wb")
        self._f.write(struct.pack("<IHHiIII", PCAP_MAGIC, 2, 4, 0, 0,
                                  snaplen, LINKTYPE_RAW))

    def write(self, payload: bytes, ts: Optional[float] = None,
              src_ip: int = 0x7F000001, dst_ip: int = 0x7F000001,
              src_port: int = 0, dst_port: int = 0) -> None:
        ts = time.time() if ts is None else ts
        pkt = _ipv4_udp(payload, src_ip, dst_ip, src_port, dst_port)
        sec = int(ts)
        usec = int((ts - sec) * 1e6)
        self._f.write(struct.pack("<IIII", sec, usec, len(pkt), len(pkt)))
        self._f.write(pkt)

    def write_batch(self, batch, ts: Optional[float] = None, **kw) -> None:
        for i in range(batch.batch_size):
            self.write(batch.to_bytes(i), ts, **kw)

    def close(self) -> None:
        self._f.close()


class PcapReader:
    """Iterate (timestamp, udp_payload, src_port, dst_port) records."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        g = self._f.read(24)
        magic = struct.unpack("<I", g[:4])[0]
        if magic != PCAP_MAGIC:
            raise ValueError("unsupported pcap magic (only usec LE)")
        self.linktype = struct.unpack("<I", g[20:24])[0]

    def __iter__(self) -> Iterator[Tuple[float, bytes, int, int]]:
        while True:
            h = self._f.read(16)
            if len(h) < 16:
                return
            sec, usec, caplen, _ = struct.unpack("<IIII", h)
            pkt = self._f.read(caplen)
            if self.linktype == LINKTYPE_RAW and len(pkt) >= 28:
                ihl = (pkt[0] & 0x0F) * 4
                sport, dport = struct.unpack("!HH", pkt[ihl:ihl + 4])
                payload = pkt[ihl + 8:]
            else:
                sport = dport = 0
                payload = pkt
            yield sec + usec / 1e6, payload, sport, dport

    def close(self) -> None:
        self._f.close()


# ------------------------------------------------------------- rtpdump ----

_RTPDUMP_PREAMBLE = b"#!rtpplay1.0 127.0.0.1/0\n"


class RtpdumpWriter:
    """rtpdump v1.0 (the rtpdumpfile fixture format)."""

    def __init__(self, path: str, start: Optional[float] = None):
        self._f = open(path, "wb")
        self.start = time.time() if start is None else start
        self._f.write(_RTPDUMP_PREAMBLE)
        sec = int(self.start)
        usec = int((self.start - sec) * 1e6)
        self._f.write(struct.pack("!IIIHH", sec, usec, 0x7F000001, 0, 0))

    def write(self, packet: bytes, ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else ts
        off_ms = max(0, round((ts - self.start) * 1000))
        self._f.write(struct.pack("!HHI", 8 + len(packet), len(packet),
                                  off_ms))
        self._f.write(packet)

    def close(self) -> None:
        self._f.close()


class RtpdumpReader:
    """Iterate (offset_ms, rtp_packet) records."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        pre = self._f.readline()
        if not pre.startswith(b"#!rtpplay1.0"):
            raise ValueError("not an rtpdump file")
        self._f.read(16)  # file header

    def __iter__(self) -> Iterator[Tuple[int, bytes]]:
        while True:
            h = self._f.read(8)
            if len(h) < 8:
                return
            rec_len, pkt_len, off_ms = struct.unpack("!HHI", h)
            pkt = self._f.read(rec_len - 8)
            yield off_ms, pkt[:pkt_len]

    def close(self) -> None:
        self._f.close()
