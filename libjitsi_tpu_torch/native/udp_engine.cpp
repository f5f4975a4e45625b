// Batched UDP I/O engine for the host data plane (PyTorch port's copy).
//
// Counterpart: libjitsi_tpu/native/udp_engine.cpp, recvmmsg/sendmmsg part
// with its kernel receive timestamps (SO_TIMESTAMPNS).
// The reference's packet I/O is java.net sockets with one thread per
// connector stream (org.jitsi.impl.neomedia.RTPConnectorUDPImpl et al.);
// at 10k streams that design melts.  This engine batches syscalls with
// recvmmsg/sendmmsg, supports SO_REUSEPORT fan-in, and receives into a
// buffer whose memory layout IS the framework's PacketBatch
// struct-of-arrays ([max_pkts, capacity] uint8 matrix + int32 length
// vector).
//
// Exposed as a plain C ABI for ctypes.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/types.h>
#include <unistd.h>
#include <vector>

extern "C" {

// Create a bound UDP socket.  reuseport != 0 enables SO_REUSEPORT so N
// engine instances can share one port (kernel-level stream sharding).
// Returns fd >= 0 or -errno.
int udp_create(const char *bind_ip, uint16_t port, int reuseport,
               int rcvbuf_bytes) {
  int fd = socket(AF_INET, SOCK_DGRAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -errno;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  if (reuseport) setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
  // SO_RCVBUFFORCE may pass net.core.rmem_max (CAP_NET_ADMIN); without
  // the capability the kernel caps SO_RCVBUF at rmem_max
  if (rcvbuf_bytes > 0 &&
      setsockopt(fd, SOL_SOCKET, SO_RCVBUFFORCE, &rcvbuf_bytes,
                 sizeof(rcvbuf_bytes)) < 0)
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf_bytes, sizeof(rcvbuf_bytes));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  addr.sin_addr.s_addr = bind_ip ? inet_addr(bind_ip) : INADDR_ANY;
  if (bind(fd, reinterpret_cast<sockaddr *>(&addr), sizeof(addr)) < 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  return fd;
}

int udp_close(int fd) { return close(fd); }

// The receive buffer the kernel granted (bytes, as getsockopt reports
// it), or -errno.
int udp_rcvbuf(int fd) {
  int v = 0;
  socklen_t len = sizeof(v);
  if (getsockopt(fd, SOL_SOCKET, SO_RCVBUF, &v, &len) < 0) return -errno;
  return v;
}

// Get the locally bound port (for port-0 ephemeral binds in tests).
int udp_local_port(int fd) {
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(fd, reinterpret_cast<sockaddr *>(&addr), &len) < 0)
    return -errno;
  return ntohs(addr.sin_port);
}

// Enable kernel receive timestamps (SO_TIMESTAMPNS): the BWE's
// inter-arrival filters react to sub-millisecond queueing-delay
// gradients, and a userspace arrival time carries scheduler jitter that
// the kernel's stamp (taken at skb receive) does not.  0 or -errno.
int udp_enable_timestamps(int fd) {
  int one = 1;
  if (setsockopt(fd, SOL_SOCKET, SO_TIMESTAMPNS, &one, sizeof(one)) < 0)
    return -errno;
  return 0;
}

// Batched receive via recvmmsg into the caller's [max_pkts, capacity]
// row-major buffer; writes per-packet lengths, source ip4 (host order)
// and ports, and when arrival_ns != nullptr each packet's kernel arrival
// time (CLOCK_REALTIME nanoseconds; a packet without a kernel stamp gets
// one clock_gettime taken after the drain).  Waits up to timeout_ms for
// the FIRST packet, then drains whatever is immediately available (the
// batching-window pattern: the caller controls latency by the timeout,
// throughput by max_pkts).  After the first recvmmsg a drain pass keeps
// calling recvmmsg(MSG_DONTWAIT) into the remaining rows while
// datagrams are still queued, so a burst that straddles the first
// syscall fills the batch instead of spilling into the next tick; it
// never spins on an idle socket.  Returns number of packets, 0 on
// timeout, -errno on error.
int udp_recv_batch_ts(int fd, uint8_t *buf, int capacity, int max_pkts,
                      int32_t *lengths, uint32_t *src_ip,
                      uint16_t *src_port, int64_t *arrival_ns,
                      int timeout_ms) {
  if (timeout_ms > 0) {
    pollfd p{fd, POLLIN, 0};
    int pr = poll(&p, 1, timeout_ms);
    if (pr < 0) return -errno;
    if (pr == 0) return 0;
  }
  thread_local std::vector<mmsghdr> hdrs;
  thread_local std::vector<iovec> iovs;
  thread_local std::vector<sockaddr_in> addrs;
  thread_local std::vector<uint8_t> ctrl;
  if (static_cast<int>(hdrs.size()) < max_pkts) {
    hdrs.resize(max_pkts);
    iovs.resize(max_pkts);
    addrs.resize(max_pkts);
  }
  constexpr size_t kCtrl = 64;  // room for one timestampns cmsg
  if (arrival_ns && ctrl.size() < static_cast<size_t>(max_pkts) * kCtrl)
    ctrl.resize(static_cast<size_t>(max_pkts) * kCtrl);
  for (int i = 0; i < max_pkts; i++) {
    iovs[i].iov_base = buf + static_cast<size_t>(i) * capacity;
    iovs[i].iov_len = capacity;
    std::memset(&hdrs[i], 0, sizeof(mmsghdr));
    hdrs[i].msg_hdr.msg_iov = &iovs[i];
    hdrs[i].msg_hdr.msg_iovlen = 1;
    hdrs[i].msg_hdr.msg_name = &addrs[i];
    hdrs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
    if (arrival_ns) {
      hdrs[i].msg_hdr.msg_control =
          ctrl.data() + static_cast<size_t>(i) * kCtrl;
      hdrs[i].msg_hdr.msg_controllen = kCtrl;
    }
  }
  int total = 0;
  while (total < max_pkts) {
    int n = recvmmsg(fd, hdrs.data() + total, max_pkts - total, MSG_DONTWAIT,
                     nullptr);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      if (total > 0) break;  // deliver what we have; error next call
      return -errno;
    }
    if (n == 0) break;
    total += n;
  }
  if (total == 0) return 0;
  int64_t fallback = 0;
  if (arrival_ns) {
    timespec now{};
    clock_gettime(CLOCK_REALTIME, &now);
    fallback = static_cast<int64_t>(now.tv_sec) * 1000000000LL + now.tv_nsec;
  }
  for (int i = 0; i < total; i++) {
    lengths[i] = static_cast<int32_t>(hdrs[i].msg_len);
    src_ip[i] = ntohl(addrs[i].sin_addr.s_addr);
    src_port[i] = ntohs(addrs[i].sin_port);
    if (!arrival_ns) continue;
    arrival_ns[i] = fallback;
    for (cmsghdr *c = CMSG_FIRSTHDR(&hdrs[i].msg_hdr); c;
         c = CMSG_NXTHDR(&hdrs[i].msg_hdr, c)) {
      if (c->cmsg_level == SOL_SOCKET && c->cmsg_type == SO_TIMESTAMPNS) {
        timespec ts{};
        std::memcpy(&ts, CMSG_DATA(c), sizeof(ts));
        arrival_ns[i] =
            static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
        break;
      }
    }
  }
  return total;
}

// Row-indexed gather send via sendmmsg.  Rows are selected by idx[]
// into the caller's full [*, capacity] row-major matrix, so the host
// never materializes a contiguous copy of the egress subset: the iovec
// gather IS the row selection, and the whole multi-destination burst
// is one syscall (per-msg msg_name carries each row's destination).
// lengths/dst_ip/dst_port are length-n arrays in idx order; idx may be
// nullptr for the identity (rows 0..n-1).  dst_ip is host-order ip4.
// Returns packets sent or -errno.
int udp_send_batch_idx(int fd, const uint8_t *buf, int capacity,
                       const int32_t *lengths, const uint32_t *dst_ip,
                       const uint16_t *dst_port, const int32_t *idx,
                       int n) {
  thread_local std::vector<mmsghdr> hdrs;
  thread_local std::vector<iovec> iovs;
  thread_local std::vector<sockaddr_in> addrs;
  if (static_cast<int>(hdrs.size()) < n) {
    hdrs.resize(n);
    iovs.resize(n);
    addrs.resize(n);
  }
  for (int i = 0; i < n; i++) {
    int row = idx ? idx[i] : i;
    iovs[i].iov_base = const_cast<uint8_t *>(buf) +
                       static_cast<size_t>(row) * capacity;
    iovs[i].iov_len = lengths[i];
    addrs[i] = sockaddr_in{};
    addrs[i].sin_family = AF_INET;
    addrs[i].sin_port = htons(dst_port[i]);
    addrs[i].sin_addr.s_addr = htonl(dst_ip[i]);
    std::memset(&hdrs[i], 0, sizeof(mmsghdr));
    hdrs[i].msg_hdr.msg_iov = &iovs[i];
    hdrs[i].msg_hdr.msg_iovlen = 1;
    hdrs[i].msg_hdr.msg_name = &addrs[i];
    hdrs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
  }
  int sent = 0;
  while (sent < n) {
    int r = sendmmsg(fd, hdrs.data() + sent, n - sent, 0);
    if (r < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      return -errno;
    }
    sent += r;
  }
  return sent;
}

// Batched send via sendmmsg from the same row-major layout.
// dst_ip is host-order ip4.  Returns packets sent or -errno.
int udp_send_batch(int fd, const uint8_t *buf, int capacity,
                   const int32_t *lengths, const uint32_t *dst_ip,
                   const uint16_t *dst_port, int n) {
  return udp_send_batch_idx(fd, buf, capacity, lengths, dst_ip, dst_port,
                            nullptr, n);
}

}  // extern "C"
