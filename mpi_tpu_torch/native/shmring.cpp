// Native data plane for the same-host transport: a single-producer /
// single-consumer byte ring in POSIX shared memory, one ring per directed
// rank pair, plus a per-receiver futex "doorbell" so a reader waiting on
// many rings sleeps in the kernel and is woken by any sender — the same
// wake-on-arrival behavior a blocking socket recv() gets, without the TCP
// stack on the data path (mpi_tpu_torch/transport/shm.py owns the protocol).
// The port's own copy of mpi_tpu/native/shmring.cpp: same layout, same
// entry points; the port builds and loads only this file.
//
// Design notes:
// * head/tail are monotonic byte counters (never wrapped), so fullness is
//   simply head - tail; positions wrap with % capacity.
// * Both write and read STREAM in available-space chunks, so frames larger
//   than the ring capacity flow through without deadlock (the Python layer
//   prefixes each frame with its length and reads exactly that many bytes).
// * Empty/full waits are futexes on 32-bit seq words in the shared header
//   (wseq bumps per produced chunk, rseq per consumed chunk); wakes are
//   issued only when the waiter counter says someone is sleeping, so the
//   uncontended path stays syscall-free.
// * The consumer creates the ring (unlinking any stale segment first) and
//   flips `magic` last with release ordering; producers open-and-wait.
//
// Built by mpi_tpu_torch/native/build.py into mpi_tpu_torch/_build/:
//   g++ -O3 -std=c++17 -shared -fPIC

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <linux/futex.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x4D505452;  // "MPTR"
constexpr size_t kDataOffset = 64;       // keep data cache-line separated

struct Header {
  std::atomic<uint64_t> head;   // total bytes written
  std::atomic<uint64_t> tail;   // total bytes read
  uint64_t capacity;
  std::atomic<uint32_t> magic;
  std::atomic<uint32_t> wseq;     // bumped per produced chunk
  std::atomic<uint32_t> rseq;     // bumped per consumed chunk
  std::atomic<uint32_t> wwait;    // sleepers on wseq (the reader)
  std::atomic<uint32_t> rwait;    // sleepers on rseq (the writer)
};
static_assert(sizeof(Header) <= kDataOffset, "header must fit the pad");

struct Ring {
  Header* h;
  uint8_t* data;
  size_t maplen;
  int fd;
};

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

long sys_futex(std::atomic<uint32_t>* uaddr, int op, uint32_t val,
               const struct timespec* timeout) {
  return syscall(SYS_futex, (uint32_t*)uaddr, op, val, timeout, nullptr, 0);
}

// Sleep until *seq != seen or the step timeout elapses.  `waiters` is the
// matching sleeper counter.  Returns false iff `deadline` (absolute,
// negative = never) has passed.  The wait covers the full remaining time
// (capped at 250ms as a lost-wakeup safety net) so an idle waiter costs
// ~4 syscalls/s, not a poll loop.
bool futex_wait_step(std::atomic<uint32_t>* seq, uint32_t seen,
                     std::atomic<uint32_t>* waiters, double deadline) {
  double remain = deadline < 0 ? 0.25 : deadline - now_s();
  if (remain <= 0) return false;
  if (remain > 0.25) remain = 0.25;
  struct timespec ts;
  ts.tv_sec = (time_t)remain;
  ts.tv_nsec = (long)((remain - ts.tv_sec) * 1e9);
  waiters->fetch_add(1, std::memory_order_seq_cst);
  if (seq->load(std::memory_order_seq_cst) == seen) {
    sys_futex(seq, FUTEX_WAIT, seen, &ts);
  }
  waiters->fetch_sub(1, std::memory_order_seq_cst);
  return deadline < 0 || now_s() < deadline;
}

void bump_and_wake(std::atomic<uint32_t>* seq, std::atomic<uint32_t>* waiters) {
  seq->fetch_add(1, std::memory_order_seq_cst);
  if (waiters->load(std::memory_order_seq_cst) != 0) {
    sys_futex(seq, FUTEX_WAKE, INT32_MAX, nullptr);
  }
}

// Plain polling step for the setup paths (segment not yet mapped).
bool poll_step(int& spins, double deadline) {
  if (spins < 64) {
    ++spins;
    sched_yield();
  } else {
    struct timespec ts = {0, 200 * 1000};  // 200us
    nanosleep(&ts, nullptr);
  }
  return deadline < 0 || now_s() < deadline;
}

}  // namespace

extern "C" {

// Consumer side: (re)create the segment and initialize the header.
void* shmring_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // stale segment from a crashed run, if any
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t maplen = kDataOffset + capacity;
  if (ftruncate(fd, (off_t)maplen) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, maplen, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  Ring* r = new Ring;
  r->h = (Header*)mem;
  r->data = (uint8_t*)mem + kDataOffset;
  r->maplen = maplen;
  r->fd = fd;
  memset(mem, 0, sizeof(Header));
  r->h->capacity = capacity;
  r->h->magic.store(kMagic, std::memory_order_release);
  return r;
}

// Producer side: open an existing segment, waiting up to timeout_s for the
// consumer to create and initialize it.
void* shmring_open(const char* name, double timeout_s) {
  double deadline = timeout_s < 0 ? -1.0 : now_s() + timeout_s;
  int fd = -1;
  int spins = 0;
  for (;;) {
    fd = shm_open(name, O_RDWR, 0600);
    if (fd >= 0) break;
    if (errno != ENOENT || !poll_step(spins, deadline)) return nullptr;
  }
  struct stat st;  // wait for the consumer's ftruncate
  spins = 0;
  for (;;) {
    if (fstat(fd, &st) != 0) {
      close(fd);
      return nullptr;
    }
    if ((size_t)st.st_size > kDataOffset) break;
    if (!poll_step(spins, deadline)) {
      close(fd);
      return nullptr;
    }
  }
  size_t maplen = (size_t)st.st_size;
  void* mem = mmap(nullptr, maplen, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Header* h = (Header*)mem;
  spins = 0;
  while (h->magic.load(std::memory_order_acquire) != kMagic) {
    if (!poll_step(spins, deadline)) {
      munmap(mem, maplen);
      close(fd);
      return nullptr;
    }
  }
  Ring* r = new Ring;
  r->h = h;
  r->data = (uint8_t*)mem + kDataOffset;
  r->maplen = maplen;
  r->fd = fd;
  return r;
}

uint64_t shmring_avail(void* ring) {
  Ring* r = (Ring*)ring;
  return r->h->head.load(std::memory_order_acquire) -
         r->h->tail.load(std::memory_order_relaxed);
}

// Stream n bytes into the ring; 0 on success, -1 on timeout.
int shmring_write(void* ring, const void* buf, uint64_t n, double timeout_s) {
  Ring* r = (Ring*)ring;
  Header* h = r->h;
  const uint8_t* src = (const uint8_t*)buf;
  const uint64_t cap = h->capacity;
  uint64_t head = h->head.load(std::memory_order_relaxed);
  uint64_t done = 0;
  double deadline = timeout_s < 0 ? -1.0 : now_s() + timeout_s;
  while (done < n) {
    uint32_t seen = h->rseq.load(std::memory_order_seq_cst);
    uint64_t tail = h->tail.load(std::memory_order_acquire);
    uint64_t space = cap - (head - tail);
    if (space == 0) {
      if (!futex_wait_step(&h->rseq, seen, &h->rwait, deadline)) return -1;
      continue;
    }
    uint64_t pos = head % cap;
    uint64_t chunk = n - done;
    if (chunk > space) chunk = space;
    if (chunk > cap - pos) chunk = cap - pos;  // contiguous run
    memcpy(r->data + pos, src + done, chunk);
    done += chunk;
    head += chunk;
    h->head.store(head, std::memory_order_release);
    bump_and_wake(&h->wseq, &h->wwait);
  }
  return 0;
}

// Stream exactly n bytes out of the ring; 0 on success, -1 on timeout.
int shmring_read(void* ring, void* buf, uint64_t n, double timeout_s) {
  Ring* r = (Ring*)ring;
  Header* h = r->h;
  uint8_t* dst = (uint8_t*)buf;
  const uint64_t cap = h->capacity;
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  uint64_t done = 0;
  double deadline = timeout_s < 0 ? -1.0 : now_s() + timeout_s;
  while (done < n) {
    uint32_t seen = h->wseq.load(std::memory_order_seq_cst);
    uint64_t head = h->head.load(std::memory_order_acquire);
    uint64_t avail = head - tail;
    if (avail == 0) {
      if (!futex_wait_step(&h->wseq, seen, &h->wwait, deadline)) return -1;
      continue;
    }
    uint64_t pos = tail % cap;
    uint64_t chunk = n - done;
    if (chunk > avail) chunk = avail;
    if (chunk > cap - pos) chunk = cap - pos;
    memcpy(dst + done, r->data + pos, chunk);
    done += chunk;
    tail += chunk;
    h->tail.store(tail, std::memory_order_release);
    bump_and_wake(&h->rseq, &h->rwait);
  }
  return 0;
}

// Read UP TO n bytes (at least 1 unless timeout): returns the count, 0 on
// timeout with nothing consumed.  The resumable half of shmring_read —
// Python loops it in short slices so a dead peer or a teardown request is
// noticed between slices instead of after one long in-C block, and large
// frames can stream straight into their final buffer at an offset.
int64_t shmring_read_some(void* ring, void* buf, uint64_t n, double timeout_s) {
  Ring* r = (Ring*)ring;
  Header* h = r->h;
  uint8_t* dst = (uint8_t*)buf;
  const uint64_t cap = h->capacity;
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  double deadline = timeout_s < 0 ? -1.0 : now_s() + timeout_s;
  for (;;) {
    uint32_t seen = h->wseq.load(std::memory_order_seq_cst);
    uint64_t head = h->head.load(std::memory_order_acquire);
    uint64_t avail = head - tail;
    if (avail == 0) {
      if (!futex_wait_step(&h->wseq, seen, &h->wwait, deadline)) return 0;
      continue;
    }
    uint64_t chunk = n < avail ? n : avail;
    uint64_t pos = tail % cap;
    uint64_t run = cap - pos;
    if (chunk <= run) {
      memcpy(dst, r->data + pos, chunk);
    } else {  // wraps: two runs, one call
      memcpy(dst, r->data + pos, run);
      memcpy(dst + run, r->data, chunk - run);
    }
    tail += chunk;
    h->tail.store(tail, std::memory_order_release);
    bump_and_wake(&h->rseq, &h->rwait);
    return (int64_t)chunk;
  }
}

// Write UP TO n bytes: returns the count, 0 on timeout with nothing
// committed.  Resumable half of shmring_write (same rationale as
// shmring_read_some).
int64_t shmring_write_some(void* ring, const void* buf, uint64_t n,
                           double timeout_s) {
  Ring* r = (Ring*)ring;
  Header* h = r->h;
  const uint8_t* src = (const uint8_t*)buf;
  const uint64_t cap = h->capacity;
  uint64_t head = h->head.load(std::memory_order_relaxed);
  double deadline = timeout_s < 0 ? -1.0 : now_s() + timeout_s;
  for (;;) {
    uint32_t seen = h->rseq.load(std::memory_order_seq_cst);
    uint64_t tail = h->tail.load(std::memory_order_acquire);
    uint64_t space = cap - (head - tail);
    if (space == 0) {
      if (!futex_wait_step(&h->rseq, seen, &h->rwait, deadline)) return 0;
      continue;
    }
    uint64_t chunk = n < space ? n : space;
    uint64_t pos = head % cap;
    uint64_t run = cap - pos;
    if (chunk <= run) {
      memcpy(r->data + pos, src, chunk);
    } else {
      memcpy(r->data + pos, src, run);
      memcpy(r->data, src + run, chunk - run);
    }
    head += chunk;
    h->head.store(head, std::memory_order_release);
    bump_and_wake(&h->wseq, &h->wwait);
    return (int64_t)chunk;
  }
}

void shmring_close(void* ring) {
  Ring* r = (Ring*)ring;
  munmap((void*)r->h, r->maplen);
  close(r->fd);
  delete r;
}

int shmring_unlink(const char* name) { return shm_unlink(name); }

// ---- doorbell: one futex seq per receiving rank ---------------------------
// Senders ring it after delivering a complete frame into any of the
// receiver's rings; the receiver's reader thread sleeps here when all its
// rings are empty.  Layout: [magic][seq][waiters].

struct Doorbell {
  std::atomic<uint32_t> magic;
  std::atomic<uint32_t> seq;
  std::atomic<uint32_t> waiters;
};

void* shmdb_create(const char* name) {
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, sizeof(Doorbell)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, sizeof(Doorbell), PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Doorbell* d = (Doorbell*)mem;
  d->seq.store(0, std::memory_order_relaxed);
  d->waiters.store(0, std::memory_order_relaxed);
  d->magic.store(kMagic, std::memory_order_release);
  return d;
}

void* shmdb_open(const char* name, double timeout_s) {
  double deadline = timeout_s < 0 ? -1.0 : now_s() + timeout_s;
  int fd = -1;
  int spins = 0;
  for (;;) {
    fd = shm_open(name, O_RDWR, 0600);
    if (fd >= 0) break;
    if (errno != ENOENT || !poll_step(spins, deadline)) return nullptr;
  }
  struct stat st;
  spins = 0;
  for (;;) {
    if (fstat(fd, &st) != 0) {
      close(fd);
      return nullptr;
    }
    if ((size_t)st.st_size >= sizeof(Doorbell)) break;
    if (!poll_step(spins, deadline)) {
      close(fd);
      return nullptr;
    }
  }
  void* mem = mmap(nullptr, sizeof(Doorbell), PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Doorbell* d = (Doorbell*)mem;
  spins = 0;
  while (d->magic.load(std::memory_order_acquire) != kMagic) {
    if (!poll_step(spins, deadline)) {
      munmap(mem, sizeof(Doorbell));
      return nullptr;
    }
  }
  return d;
}

uint32_t shmdb_read(void* db) {
  return ((Doorbell*)db)->seq.load(std::memory_order_seq_cst);
}

void shmdb_ring(void* db) {
  Doorbell* d = (Doorbell*)db;
  bump_and_wake(&d->seq, &d->waiters);
}

// Sleep until seq != seen (or timeout); returns the current seq.
uint32_t shmdb_wait(void* db, uint32_t seen, double timeout_s) {
  Doorbell* d = (Doorbell*)db;
  double deadline = timeout_s < 0 ? -1.0 : now_s() + timeout_s;
  while (d->seq.load(std::memory_order_seq_cst) == seen) {
    if (!futex_wait_step(&d->seq, seen, &d->waiters, deadline)) break;
  }
  return d->seq.load(std::memory_order_seq_cst);
}

void shmdb_close(void* db) { munmap(db, sizeof(Doorbell)); }

int shmdb_unlink(const char* name) { return shm_unlink(name); }

// ---- collective arena (coll/sm) -------------------------------------------
// One POSIX segment per shm-backed communicator: a 64-byte native header
// (magic handshake, like the ring), then the Python layer's layout — P
// per-rank flag LINES (64 bytes each: [u32 seq][u32 waiters], cache-line
// separated so two ranks' posts never share a line) followed by P data
// slots ranks load/store directly.  The flag ops below are the whole
// synchronization vocabulary: a monotone per-rank sequence counter is the
// generalized sense-reversing barrier (sense = counter parity, and the
// monotone spelling needs no reset phase), posted with release semantics
// AFTER the data stores and awaited with acquire semantics BEFORE the
// data loads.  Waits spin briefly (arena peers are co-located, so the
// expected wait is sub-microsecond) and then sleep on a futex in the
// flag line itself; Python loops the wait in short slices so the ULFM
// detector can convert a dead peer into ProcFailedError.

struct ArenaHeader {
  std::atomic<uint32_t> magic;
};

struct ArenaMap {
  void* mem;
  size_t maplen;
};

void* shmarena_create(const char* name, uint64_t nbytes) {
  shm_unlink(name);  // stale segment from a crashed run, if any
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t maplen = kDataOffset + nbytes;
  if (ftruncate(fd, (off_t)maplen) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, maplen, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  memset(mem, 0, kDataOffset);  // flags/slots start zeroed lazily (fresh file)
  ArenaMap* a = new ArenaMap{mem, maplen};
  ((ArenaHeader*)mem)->magic.store(kMagic, std::memory_order_release);
  return a;
}

void* shmarena_open(const char* name, double timeout_s) {
  double deadline = timeout_s < 0 ? -1.0 : now_s() + timeout_s;
  int fd = -1;
  int spins = 0;
  for (;;) {
    fd = shm_open(name, O_RDWR, 0600);
    if (fd >= 0) break;
    if (errno != ENOENT || !poll_step(spins, deadline)) return nullptr;
  }
  struct stat st;  // wait for the creator's ftruncate
  spins = 0;
  for (;;) {
    if (fstat(fd, &st) != 0) {
      close(fd);
      return nullptr;
    }
    if ((size_t)st.st_size > kDataOffset) break;
    if (!poll_step(spins, deadline)) {
      close(fd);
      return nullptr;
    }
  }
  size_t maplen = (size_t)st.st_size;
  void* mem = mmap(nullptr, maplen, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  ArenaHeader* h = (ArenaHeader*)mem;
  spins = 0;
  while (h->magic.load(std::memory_order_acquire) != kMagic) {
    if (!poll_step(spins, deadline)) {
      munmap(mem, maplen);
      return nullptr;
    }
  }
  return new ArenaMap{mem, maplen};
}

// usable base address / byte count (past the native header)
uint64_t shmarena_addr(void* a) {
  return (uint64_t)((uint8_t*)((ArenaMap*)a)->mem + kDataOffset);
}

uint64_t shmarena_size(void* a) {
  return (uint64_t)(((ArenaMap*)a)->maplen - kDataOffset);
}

void shmarena_close(void* a) {
  ArenaMap* m = (ArenaMap*)a;
  munmap(m->mem, m->maplen);
  delete m;
}

int shmarena_unlink(const char* name) { return shm_unlink(name); }

// flag line: [u32 seq][u32 waiters] at line_addr (64-byte separated by the
// Python layout).  seq comparisons are wrap-safe (signed difference), so
// 2^31 barriers fit between any two ranks' progress — unreachable skew.

uint32_t shmflag_read(uint64_t line_addr) {
  return ((std::atomic<uint32_t>*)line_addr)->load(std::memory_order_seq_cst);
}

void shmflag_post(uint64_t line_addr, uint32_t value) {
  std::atomic<uint32_t>* seq = (std::atomic<uint32_t>*)line_addr;
  std::atomic<uint32_t>* waiters = seq + 1;
  seq->store(value, std::memory_order_seq_cst);
  if (waiters->load(std::memory_order_seq_cst) != 0) {
    sys_futex(seq, FUTEX_WAKE, INT32_MAX, nullptr);
  }
}

// Wait until seq >= target (wrap-safe) or timeout; returns the current
// value either way.  Short yield-spin first: the common case is a peer a
// few instructions behind, and on an oversubscribed box the yield lets it
// run; the futex nap handles the long tail without burning the core.
uint32_t shmflag_wait_ge(uint64_t line_addr, uint32_t target,
                         double timeout_s) {
  std::atomic<uint32_t>* seq = (std::atomic<uint32_t>*)line_addr;
  std::atomic<uint32_t>* waiters = seq + 1;
  double deadline = timeout_s < 0 ? -1.0 : now_s() + timeout_s;
  int spins = 0;
  for (;;) {
    uint32_t cur = seq->load(std::memory_order_seq_cst);
    if ((int32_t)(cur - target) >= 0) return cur;
    if (spins < 64) {
      ++spins;
      sched_yield();
      continue;
    }
    if (!futex_wait_step(seq, cur, waiters, deadline)) {
      return seq->load(std::memory_order_seq_cst);
    }
  }
}

}  // extern "C"
