// Batched UDP I/O engine for the host data plane (PyTorch port's copy).
//
// Counterpart: libjitsi_tpu/native/udp_engine.cpp: the recvmmsg/sendmmsg
// engine with its kernel receive timestamps (SO_TIMESTAMPNS), and the
// io_uring ingest engine below it (raw syscalls, no liburing; built where
// <linux/io_uring.h> is present, ENOSYS stubs elsewhere).
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
// ===========================================================================
// io_uring engine (generation 2 host I/O).
//
// Same socket, same pinned-arena memory contract as the recvmmsg engine
// above, but ingest is ring-driven: every row of the CURRENT recv arena
// gets a single-shot RECVMSG SQE whose iovec points at that row, the
// whole arena is armed with ONE io_uring_enter, and steady-state drains
// reap completions from the shared-memory CQ without entering the
// kernel at all.  One syscall then covers an entire arena fill-cycle
// (rows packets) instead of one per recvmmsg window.
//
// Deliberate non-use of multishot RECVMSG: multishot completions carry
// an io_uring_recvmsg_out header + name/control blob IN the data
// buffer, in completion order from a provided-buffer pool — both break
// the arena contract (payload bytes at row offset 0, rows contiguous
// in arrival order) that makes the recv arena a zero-copy PacketBatch.
// Re-armed single-shot RECVMSG keeps the exact memory layout and still
// amortizes the enter down to ~1/rows per packet, which is what the
// syscall telemetry (udp_uring_stat) lets callers verify.
//
// Delivery is CONTIGUOUS-PREFIX: completions can land out of row order
// (rarely, under load), so a drain hands back only the completed prefix
// [delivered, first-hole) and later calls pick up the rest.  Egress
// multiplexes SENDMSG SQEs on the same CQ, tagged in user_data.
//
// Built only when the kernel UAPI header is present; otherwise every
// entry point is an ENOSYS stub so one .so serves both worlds and the
// Python probe (udp_uring_supported) picks the engine at runtime.

// the build passes no flag: the header's presence decides
#if !defined(HAVE_IO_URING) && defined(__has_include)
#if __has_include(<linux/io_uring.h>)
#define HAVE_IO_URING 1
#endif
#endif

#if defined(__linux__) && defined(HAVE_IO_URING)

#include <linux/io_uring.h>
#include <linux/time_types.h>
#include <new>
#include <sys/mman.h>
#include <sys/syscall.h>

// cancel-any postdates some UAPI headers (kernel 5.19); the running
// kernel decides support at runtime, the constant is ABI-stable
#ifndef IORING_ASYNC_CANCEL_ANY
#define IORING_ASYNC_CANCEL_ANY (1U << 2)
#endif

namespace {

int sys_uring_setup(unsigned entries, io_uring_params *p) {
  return static_cast<int>(syscall(__NR_io_uring_setup, entries, p));
}

int sys_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                    unsigned flags, const void *arg, size_t argsz) {
  return static_cast<int>(syscall(__NR_io_uring_enter, fd, to_submit,
                                  min_complete, flags, arg, argsz));
}

constexpr uint64_t kSendTag = 1ULL << 62;  // user_data: send vs recv row

struct UringEngine {
  int sock_fd = -1;
  int ring_fd = -1;
  unsigned features = 0;
  bool sqpoll = false;
  bool want_ts = false;
  // mmapped ring state
  void *sq_ptr = nullptr, *cq_ptr = nullptr;
  size_t sq_len = 0, cq_len = 0, sqe_len = 0;
  io_uring_sqe *sqes = nullptr;
  unsigned *sq_head = nullptr, *sq_tail = nullptr, *sq_mask = nullptr;
  unsigned *sq_flags = nullptr, *sq_array = nullptr;
  unsigned *cq_head = nullptr, *cq_tail = nullptr, *cq_mask = nullptr;
  io_uring_cqe *cqes = nullptr;
  unsigned sq_entries = 0, cq_entries = 0;
  unsigned sq_pending = 0;  // SQEs staged since the last submit
  // current arena (one fill-cycle): metadata written straight into the
  // caller's arena-backed arrays at absolute row positions
  uint8_t *buf = nullptr;
  int rows = 0, capacity = 0;
  int32_t *out_len = nullptr;
  uint32_t *out_ip = nullptr;
  uint16_t *out_port = nullptr;
  int64_t *out_ts = nullptr;
  int posted = 0;     // rows with an SQE armed (staged or submitted)
  int delivered = 0;  // contiguous prefix handed back to the caller
  int inflight = 0;   // armed, not yet completed
  std::vector<uint8_t> completed;    // per-row completion flag
  std::vector<msghdr> mh;            // per-row op resources: must stay
  std::vector<iovec> iov;            // alive until the CQE arrives
  std::vector<sockaddr_in> addr;
  std::vector<uint8_t> ctrl;
  long enters = 0;      // io_uring_enter syscalls (the honest count)
  long reaps = 0;       // completions consumed ring-side
  long recv_errors = 0; // failed recv completions (row re-armed)
};

constexpr size_t kUringCtrl = 64;  // room for one timestampns cmsg

unsigned npow2(unsigned v) {
  unsigned p = 1;
  while (p < v) p <<= 1;
  return p;
}

int64_t cmsg_stamp(msghdr *m, int64_t fallback) {
  for (cmsghdr *c = CMSG_FIRSTHDR(m); c; c = CMSG_NXTHDR(m, c)) {
    if (c->cmsg_level == SOL_SOCKET && c->cmsg_type == SO_TIMESTAMPNS) {
      timespec ts{};
      std::memcpy(&ts, CMSG_DATA(c), sizeof(ts));
      return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
    }
  }
  return fallback;
}

// stage one SQE (caller guarantees SQ room); submission happens later
io_uring_sqe *stage_sqe(UringEngine *u) {
  unsigned tail = *u->sq_tail + u->sq_pending;
  io_uring_sqe *sqe = &u->sqes[tail & *u->sq_mask];
  std::memset(sqe, 0, sizeof(*sqe));
  u->sq_array[tail & *u->sq_mask] = tail & *u->sq_mask;
  u->sq_pending++;
  return sqe;
}

unsigned sq_room(UringEngine *u) {
  unsigned head = __atomic_load_n(u->sq_head, __ATOMIC_ACQUIRE);
  unsigned used = (*u->sq_tail + u->sq_pending) - head;
  return u->sq_entries - used;
}

// publish staged SQEs and optionally wait for >=1 completion.  The
// only place the engine enters the kernel.
int uring_submit(UringEngine *u, bool wait, int timeout_ms) {
  unsigned to_submit = u->sq_pending;
  if (to_submit) {
    __atomic_store_n(u->sq_tail, *u->sq_tail + to_submit,
                     __ATOMIC_RELEASE);
    u->sq_pending = 0;
  }
  unsigned flags = 0;
  unsigned min_complete = 0;
  io_uring_getevents_arg arg{};
  __kernel_timespec kts{};
  const void *argp = nullptr;
  size_t argsz = 0;
  if (wait) {
    flags |= IORING_ENTER_GETEVENTS;
    min_complete = 1;
    if (timeout_ms >= 0 && (u->features & IORING_FEAT_EXT_ARG)) {
      kts.tv_sec = timeout_ms / 1000;
      kts.tv_nsec = static_cast<long long>(timeout_ms % 1000) * 1000000;
      arg.ts = reinterpret_cast<uint64_t>(&kts);
      argp = &arg;
      argsz = sizeof(arg);
      flags |= IORING_ENTER_EXT_ARG;
    }
  }
  if (u->sqpoll) {
    unsigned sf = __atomic_load_n(u->sq_flags, __ATOMIC_ACQUIRE);
    if (!wait && !(sf & IORING_SQ_NEED_WAKEUP)) return 0;  // no syscall
    if (sf & IORING_SQ_NEED_WAKEUP) flags |= IORING_ENTER_SQ_WAKEUP;
    to_submit = 0;  // the poller thread consumes the SQ itself
  } else if (!to_submit && !wait) {
    return 0;
  }
  u->enters++;
  int r = sys_uring_enter(u->ring_fd, to_submit, min_complete, flags,
                          argp, argsz);
  if (r < 0 && errno != ETIME && errno != EINTR && errno != EBUSY)
    return -errno;
  return 0;
}

// Arm RECVMSG SQEs for every not-yet-posted row, as ONE IOSQE_IO_LINK
// chain: the kernel starts recv i+1 only after recv i completes.  The
// chain (a) preserves arrival order across rows — the arena stays a
// time-ordered batch exactly like the recvmmsg engine's, so the accept
// set can be bit-identical across engine modes, and (b) keeps a single
// poll waiter on the socket instead of rows-many (independent armed
// recvs race their poll retries, scrambling packet->row assignment and
// thundering-herd-waking every waiter per datagram).  A queued burst
// still cascades down the chain entirely in-kernel, zero syscalls.
//
// Guarded on inflight == 0: rows only (re-)arm when no prior SQE is
// outstanding, so a failed chain (one error cancels the remaining
// links) is re-armed as one fresh chain AFTER all its -ECANCELED
// completions drain — a row is never double-armed.
void arm_rows(UringEngine *u) {
  if (u->inflight > 0 || u->posted >= u->rows) return;
  io_uring_sqe *last = nullptr;
  while (u->posted < u->rows && sq_room(u) > 0) {
    int row = u->posted;
    u->iov[row].iov_base = u->buf + static_cast<size_t>(row) * u->capacity;
    u->iov[row].iov_len = u->capacity;
    std::memset(&u->mh[row], 0, sizeof(msghdr));
    u->mh[row].msg_iov = &u->iov[row];
    u->mh[row].msg_iovlen = 1;
    u->mh[row].msg_name = &u->addr[row];
    u->mh[row].msg_namelen = sizeof(sockaddr_in);
    if (u->want_ts) {
      u->mh[row].msg_control = u->ctrl.data() + row * kUringCtrl;
      u->mh[row].msg_controllen = kUringCtrl;
    }
    io_uring_sqe *sqe = stage_sqe(u);
    sqe->opcode = IORING_OP_RECVMSG;
    sqe->flags = IOSQE_IO_LINK;
    sqe->fd = u->sock_fd;
    sqe->addr = reinterpret_cast<uint64_t>(&u->mh[row]);
    sqe->user_data = static_cast<uint64_t>(row);
    u->posted++;
    u->inflight++;
    last = sqe;
  }
  if (last) last->flags &= ~IOSQE_IO_LINK;  // terminate the chain
}

// drain the CQ ring-side (no syscall).  Recv completions mark their
// row done and stash metadata into the arena arrays; failed recvs
// (e.g. ECONNREFUSED surfacing a prior send's ICMP error) re-arm the
// row.  Send completions (kSendTag) bump *send_done.  Returns number
// of completions consumed.
int reap(UringEngine *u, int *send_done, int *send_errs) {
  int n = 0;
  int64_t fallback = 0;
  unsigned head = *u->cq_head;
  for (;;) {
    unsigned tail = __atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE);
    if (head == tail) break;
    io_uring_cqe *cqe = &u->cqes[head & *u->cq_mask];
    uint64_t ud = cqe->user_data;
    int res = cqe->res;
    head++;
    n++;
    if (ud & kSendTag) {
      if (send_done) (*send_done)++;
      if (res < 0 && send_errs) (*send_errs)++;
    } else {
      int row = static_cast<int>(ud);
      u->inflight--;
      if (res < 0) {
        // chain-head error (e.g. ECONNREFUSED surfacing a prior
        // send's ICMP error) or the -ECANCELED tail the failed link
        // cascaded: roll `posted` back to the first affected row.
        // arm_rows re-arms the contiguous suffix as one fresh chain
        // once every outstanding completion has drained (inflight 0),
        // so ordering and the never-double-armed invariant both hold.
        if (res != -ECANCELED) u->recv_errors++;
        if (row < u->posted) u->posted = row;
        continue;
      }
      u->completed[row] = 1;
      u->out_len[row] = res;  // truncated to capacity, recvmmsg-style
      u->out_ip[row] = ntohl(u->addr[row].sin_addr.s_addr);
      u->out_port[row] = ntohs(u->addr[row].sin_port);
      if (u->out_ts) {
        if (fallback == 0) {
          timespec now{};
          clock_gettime(CLOCK_REALTIME, &now);
          fallback = static_cast<int64_t>(now.tv_sec) * 1000000000LL +
                     now.tv_nsec;
        }
        u->out_ts[row] = cmsg_stamp(&u->mh[row], fallback);
      }
    }
  }
  if (n) {
    __atomic_store_n(u->cq_head, head, __ATOMIC_RELEASE);
    u->reaps += n;
  }
  return n;
}

}  // namespace

extern "C" {

#define URING_ARENA_EXHAUSTED (-9999)

// Runtime probe: can this kernel set up an io_uring at all?  Cached.
int udp_uring_supported(void) {
  static int cached = -1;
  if (cached >= 0) return cached;
  io_uring_params p{};
  int fd = sys_uring_setup(4, &p);
  if (fd >= 0) {
    close(fd);
    cached = 1;
  } else {
    cached = 0;
  }
  return cached;
}

// Create a ring bound to an existing UDP socket (from udp_create).
// `entries` sizes the arena (rows) the ring must cover; the CQ is
// sized for a full arena of recv completions plus an egress burst.
// Returns an opaque handle or nullptr.
void *udp_uring_create(int sock_fd, int entries, int sqpoll, int want_ts) {
  UringEngine *u = new (std::nothrow) UringEngine();
  if (!u) return nullptr;
  unsigned sq = npow2(static_cast<unsigned>(entries < 8 ? 8 : entries));
  if (sq > 4096) sq = 4096;
  io_uring_params p{};
  p.flags = IORING_SETUP_CQSIZE;
  p.cq_entries = sq * 2;
  if (sqpoll) {
    p.flags |= IORING_SETUP_SQPOLL;
    p.sq_thread_idle = 100;
  }
  int rfd = sys_uring_setup(sq, &p);
  if (rfd < 0 && sqpoll) {
    // SQPOLL can need privileges older kernels reserve; fall back to
    // the enter-per-submit mode rather than failing the engine
    p.flags = IORING_SETUP_CQSIZE;
    sqpoll = 0;
    rfd = sys_uring_setup(sq, &p);
  }
  if (rfd < 0) {
    delete u;
    return nullptr;
  }
  u->sock_fd = sock_fd;
  u->ring_fd = rfd;
  u->features = p.features;
  u->sqpoll = sqpoll != 0;
  u->want_ts = want_ts != 0;
  u->sq_entries = p.sq_entries;
  u->cq_entries = p.cq_entries;
  u->sq_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
  u->cq_len = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
  if (p.features & IORING_FEAT_SINGLE_MMAP) {
    size_t len = u->sq_len > u->cq_len ? u->sq_len : u->cq_len;
    u->sq_ptr = mmap(nullptr, len, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_POPULATE, rfd, IORING_OFF_SQ_RING);
    u->cq_ptr = u->sq_ptr;
    u->sq_len = u->cq_len = len;
  } else {
    u->sq_ptr = mmap(nullptr, u->sq_len, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_POPULATE, rfd, IORING_OFF_SQ_RING);
    u->cq_ptr = mmap(nullptr, u->cq_len, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_POPULATE, rfd, IORING_OFF_CQ_RING);
  }
  u->sqe_len = p.sq_entries * sizeof(io_uring_sqe);
  u->sqes = static_cast<io_uring_sqe *>(
      mmap(nullptr, u->sqe_len, PROT_READ | PROT_WRITE,
           MAP_SHARED | MAP_POPULATE, rfd, IORING_OFF_SQES));
  if (u->sq_ptr == MAP_FAILED || u->cq_ptr == MAP_FAILED ||
      u->sqes == MAP_FAILED) {
    close(rfd);
    delete u;
    return nullptr;
  }
  auto *sqb = static_cast<uint8_t *>(u->sq_ptr);
  u->sq_head = reinterpret_cast<unsigned *>(sqb + p.sq_off.head);
  u->sq_tail = reinterpret_cast<unsigned *>(sqb + p.sq_off.tail);
  u->sq_mask = reinterpret_cast<unsigned *>(sqb + p.sq_off.ring_mask);
  u->sq_flags = reinterpret_cast<unsigned *>(sqb + p.sq_off.flags);
  u->sq_array = reinterpret_cast<unsigned *>(sqb + p.sq_off.array);
  auto *cqb = static_cast<uint8_t *>(u->cq_ptr);
  u->cq_head = reinterpret_cast<unsigned *>(cqb + p.cq_off.head);
  u->cq_tail = reinterpret_cast<unsigned *>(cqb + p.cq_off.tail);
  u->cq_mask = reinterpret_cast<unsigned *>(cqb + p.cq_off.ring_mask);
  u->cqes = reinterpret_cast<io_uring_cqe *>(cqb + p.cq_off.cqes);
  return u;
}

// Hand the ring a fresh arena to fill (one fill-cycle = rows packets).
// Per-row metadata is written straight into the arena-backed arrays at
// absolute row positions as completions arrive.  Fails with -EBUSY
// while recvs from the previous arena are still in flight — callers
// switch arenas only at exhaustion, where inflight is naturally 0, so
// the kernel NEVER holds a reference into a handed-back arena.
int udp_uring_arm(void *h, uint8_t *buf, int rows, int capacity,
                  int32_t *lengths, uint32_t *src_ip, uint16_t *src_port,
                  int64_t *arrival_ns) {
  auto *u = static_cast<UringEngine *>(h);
  if (!u || rows <= 0) return -EINVAL;
  reap(u, nullptr, nullptr);
  if (u->inflight > 0) return -EBUSY;
  if (static_cast<unsigned>(rows) > u->sq_entries) rows = u->sq_entries;
  u->buf = buf;
  u->rows = rows;
  u->capacity = capacity;
  u->out_len = lengths;
  u->out_ip = src_ip;
  u->out_port = src_port;
  u->out_ts = arrival_ns;
  u->posted = 0;
  u->delivered = 0;
  u->completed.assign(rows, 0);
  if (static_cast<int>(u->mh.size()) < rows) {
    u->mh.resize(rows);
    u->iov.resize(rows);
    u->addr.resize(rows);
  }
  if (u->want_ts && u->ctrl.size() < rows * kUringCtrl)
    u->ctrl.resize(rows * kUringCtrl);
  arm_rows(u);
  return uring_submit(u, false, 0);  // one enter arms the whole arena
}

// Deliver up to max_pkts completed packets as a CONTIGUOUS row run.
// Writes the first delivered row to *start_row; returns the count
// (0 on timeout), URING_ARENA_EXHAUSTED when every row of the current
// arena has been delivered (caller arms the next arena), or -errno.
// Steady state (completions already waiting) never enters the kernel.
int udp_uring_recv(void *h, int max_pkts, int timeout_ms,
                   int32_t *start_row) {
  auto *u = static_cast<UringEngine *>(h);
  if (!u || !u->buf) return -EINVAL;
  if (u->delivered >= u->rows) return URING_ARENA_EXHAUSTED;
  reap(u, nullptr, nullptr);
  arm_rows(u);
  if (u->sq_pending) uring_submit(u, false, 0);
  if (!u->completed[u->delivered] && timeout_ms > 0) {
    int r = uring_submit(u, true, timeout_ms);
    if (r < 0) return r;
    reap(u, nullptr, nullptr);
  }
  int lo = u->delivered;
  int hi = lo;
  int cap = lo + (max_pkts < u->rows - lo ? max_pkts : u->rows - lo);
  while (hi < cap && u->completed[hi]) hi++;
  if (hi == lo) return 0;
  u->delivered = hi;
  *start_row = lo;
  return hi - lo;
}

// Row-indexed gather send, ring edition: one SENDMSG SQE per packet
// submitted in SQ-sized chunks, waiting each chunk's completions so
// the per-op msghdr slots can be reused.  Same contract as
// udp_send_batch_idx.  Returns packets sent or -errno.
int udp_uring_send_idx(void *h, const uint8_t *buf, int capacity,
                       const int32_t *lengths, const uint32_t *dst_ip,
                       const uint16_t *dst_port, const int32_t *idx,
                       int n) {
  auto *u = static_cast<UringEngine *>(h);
  if (!u) return -EINVAL;
  thread_local std::vector<msghdr> smh;
  thread_local std::vector<iovec> siov;
  thread_local std::vector<sockaddr_in> saddr;
  int done = 0;
  int errs = 0;
  int sent_at = 0;
  while (sent_at < n) {
    reap(u, &done, &errs);
    unsigned room = sq_room(u);
    if (room == 0) {
      int r = uring_submit(u, true, -1);
      if (r < 0) return r;
      continue;
    }
    int chunk = n - sent_at < static_cast<int>(room)
                    ? n - sent_at
                    : static_cast<int>(room);
    if (static_cast<int>(smh.size()) < chunk) {
      smh.resize(chunk);
      siov.resize(chunk);
      saddr.resize(chunk);
    }
    for (int i = 0; i < chunk; i++) {
      int k = sent_at + i;
      int row = idx ? idx[k] : k;
      siov[i].iov_base = const_cast<uint8_t *>(buf) +
                         static_cast<size_t>(row) * capacity;
      siov[i].iov_len = lengths[k];
      saddr[i] = sockaddr_in{};
      saddr[i].sin_family = AF_INET;
      saddr[i].sin_port = htons(dst_port[k]);
      saddr[i].sin_addr.s_addr = htonl(dst_ip[k]);
      std::memset(&smh[i], 0, sizeof(msghdr));
      smh[i].msg_iov = &siov[i];
      smh[i].msg_iovlen = 1;
      smh[i].msg_name = &saddr[i];
      smh[i].msg_namelen = sizeof(sockaddr_in);
      io_uring_sqe *sqe = stage_sqe(u);
      sqe->opcode = IORING_OP_SENDMSG;
      sqe->fd = u->sock_fd;
      sqe->addr = reinterpret_cast<uint64_t>(&smh[i]);
      sqe->user_data = kSendTag | static_cast<uint64_t>(k);
    }
    int target = done + chunk;
    int r = uring_submit(u, false, 0);
    if (r < 0) return r;
    // the chunk's msghdr slots are reused next iteration: wait for
    // every completion of THIS chunk before building the next
    while (done < target) {
      reap(u, &done, &errs);
      if (done >= target) break;
      r = uring_submit(u, true, -1);
      if (r < 0) return r;
    }
    sent_at += chunk;
  }
  return n - errs;
}

// Telemetry: 0 = io_uring_enter syscalls, 1 = completions reaped
// ring-side, 2 = SQPOLL active, 3 = failed recv completions re-armed.
long udp_uring_stat(void *h, int which) {
  auto *u = static_cast<UringEngine *>(h);
  if (!u) return -EINVAL;
  switch (which) {
    case 0: return u->enters;
    case 1: return u->reaps;
    case 2: return u->sqpoll ? 1 : 0;
    case 3: return u->recv_errors;
  }
  return -EINVAL;
}

// Tear down the ring.  Armed recvs hold kernel references into the
// per-row msghdr slots (and the caller's arena), so they are cancelled
// (IORING_OP_ASYNC_CANCEL, cancel-any) and their completions drained
// BEFORE anything is freed — closing the ring fd alone defers the
// kernel-side cancellation and would race the frees.  If the drain
// cannot converge the engine struct is deliberately leaked rather than
// handing the kernel dangling memory.  Does NOT close sock_fd.
void udp_uring_destroy(void *h) {
  auto *u = static_cast<UringEngine *>(h);
  if (!u) return;
  if (u->inflight > 0 && u->ring_fd >= 0) {
    io_uring_sqe *sqe = stage_sqe(u);
    sqe->opcode = IORING_OP_ASYNC_CANCEL;
    sqe->cancel_flags = IORING_ASYNC_CANCEL_ANY;
    sqe->user_data = kSendTag | 1;
    uring_submit(u, false, 0);
    for (int i = 0; i < 64 && u->inflight > 0; i++) {
      reap(u, nullptr, nullptr);
      if (u->inflight > 0 && uring_submit(u, true, 50) < 0) break;
    }
    reap(u, nullptr, nullptr);
    if (u->inflight > 0) {
      close(u->ring_fd);  // leak u: kernel may still reference mh[]
      return;
    }
  }
  if (u->sqes && u->sqes != MAP_FAILED) munmap(u->sqes, u->sqe_len);
  if (u->cq_ptr && u->cq_ptr != u->sq_ptr && u->cq_ptr != MAP_FAILED)
    munmap(u->cq_ptr, u->cq_len);
  if (u->sq_ptr && u->sq_ptr != MAP_FAILED) munmap(u->sq_ptr, u->sq_len);
  if (u->ring_fd >= 0) close(u->ring_fd);
  delete u;
}

}  // extern "C"

#else  // !HAVE_IO_URING ------------------------------------------------

// ENOSYS stubs: the one .so serves kernels/toolchains without io_uring;
// the Python probe sees udp_uring_supported() == 0 and stays on the
// recvmmsg engine with a bit-identical accept set.
extern "C" {

int udp_uring_supported(void) { return 0; }

void *udp_uring_create(int, int, int, int) { return nullptr; }

int udp_uring_arm(void *, uint8_t *, int, int, int32_t *, uint32_t *,
                  uint16_t *, int64_t *) {
  return -ENOSYS;
}

int udp_uring_recv(void *, int, int, int32_t *) { return -ENOSYS; }

int udp_uring_send_idx(void *, const uint8_t *, int, const int32_t *,
                       const uint32_t *, const uint16_t *, const int32_t *,
                       int) {
  return -ENOSYS;
}

long udp_uring_stat(void *, int) { return -ENOSYS; }

void udp_uring_destroy(void *) {}

}  // extern "C"

#endif  // HAVE_IO_URING
