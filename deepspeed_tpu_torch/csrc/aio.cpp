// Async tensor<->file IO engine for NVMe offload.
//
// Counterpart of the JAX package's csrc/aio.cpp (the same source) and
// of the reference's csrc/aio/ stack
// (deepspeed_aio_common.cpp:69-216 do_aio_operation_sequential/
// _overlap over libaio io_submit, deepspeed_py_aio_handle.cpp
// thread-pooled handle, py_ds_aio.cpp binding surface: aio_handle /
// sync_pread / sync_pwrite / async_pread / async_pwrite / wait).
//
// Primary engine: Linux kernel AIO (raw io_setup/io_submit/io_getevents
// syscalls — exactly what libaio wraps, no userspace lib needed) over an
// O_DIRECT fd with 4 KiB-aligned bounce slots, keeping ``queue_depth``
// blocks in flight per transfer. ``single_submit`` picks one io_submit
// per iocb vs one batched call; ``overlap_events`` reaps completions
// while submission continues vs draining only when the ring is full —
// the reference's two strategies (deepspeed_aio_common.cpp:69/:121).
// A std::thread pool runs each transfer and is also the FALLBACK engine
// (plain pread/pwrite) when O_DIRECT or io_setup is unavailable
// (overlayfs, container aio-max-nr limits) or the transfer is unaligned.
// Set DS_AIO_DISABLE_KERNEL=1 to force the fallback (perf comparisons).
//
// C ABI for ctypes; no torch, no pybind11. Built by
// deepspeed_tpu_torch/ops/op_builder.py with the host compiler:
// g++ -O3 -std=c++17 -shared -fPIC -pthread aio.cpp
#include <fcntl.h>
#include <linux/aio_abi.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kAlign = 4096;
constexpr int64_t kUseFallback = INT64_MIN;  // sentinel: no IO happened yet

long sys_io_setup(unsigned nr, aio_context_t* ctx) {
  return syscall(__NR_io_setup, nr, ctx);
}
long sys_io_destroy(aio_context_t ctx) { return syscall(__NR_io_destroy, ctx); }
long sys_io_submit(aio_context_t ctx, long n, struct iocb** ios) {
  return syscall(__NR_io_submit, ctx, n, ios);
}
long sys_io_getevents(aio_context_t ctx, long min_nr, long nr,
                      struct io_event* ev) {
  return syscall(__NR_io_getevents, ctx, min_nr, nr, ev, nullptr);
}

bool kernel_aio_disabled() {
  const char* e = getenv("DS_AIO_DISABLE_KERNEL");
  return e && e[0] && e[0] != '0';
}

// high-water mark of simultaneously in-flight kernel-AIO requests since
// the last reset — the enforceable proof that the queue-depth engine
// actually overlaps I/O (bandwidth ratios are hostage to the
// hypervisor's virtio cache; this is not)
std::atomic<long> g_max_inflight{0};

void note_inflight(int inflight) {
  long cur = g_max_inflight.load(std::memory_order_relaxed);
  while (inflight > cur &&
         !g_max_inflight.compare_exchange_weak(cur, inflight)) {
  }
}

int64_t blocked_rw(bool write, const char* path, char* buf, int64_t nbytes,
                   int64_t file_offset, int block_size);

// One transfer through kernel AIO. Returns bytes transferred, -errno, or
// kUseFallback when the environment can't do it (caller then takes the
// thread-pool pread/pwrite path; nothing has been read/written yet).
int64_t kernel_aio_rw(bool write, const char* path, char* buf,
                      int64_t nbytes, int64_t file_offset, int64_t block_size,
                      int queue_depth, bool single_submit,
                      bool overlap_events) {
  if (kernel_aio_disabled() || nbytes < kAlign || (file_offset % kAlign))
    return kUseFallback;
  block_size = (block_size / kAlign) * kAlign;
  if (block_size <= 0) block_size = kAlign;
  if (queue_depth <= 0) queue_depth = 8;

  int flags = write ? (O_WRONLY | O_CREAT | O_DIRECT) : (O_RDONLY | O_DIRECT);
  int fd = ::open(path, flags, 0644);
  if (fd < 0) return kUseFallback;  // O_DIRECT unsupported here

  aio_context_t ctx = 0;
  if (sys_io_setup(queue_depth, &ctx) < 0) {
    ::close(fd);
    return kUseFallback;
  }

  char* bounce = nullptr;
  if (posix_memalign(reinterpret_cast<void**>(&bounce), kAlign,
                     static_cast<size_t>(block_size) * queue_depth) != 0) {
    sys_io_destroy(ctx);
    ::close(fd);
    return kUseFallback;
  }

  const int64_t body = (nbytes / kAlign) * kAlign;  // O_DIRECT-aligned part
  int64_t next_off = 0;   // next body offset to submit
  int64_t completed = 0;  // bytes confirmed done
  int64_t rc = 0;

  std::vector<iocb> cbs(queue_depth);
  std::vector<int64_t> slot_user_off(queue_depth);  // slot -> buf offset
  std::vector<int64_t> slot_len(queue_depth);
  std::vector<int> free_slots;
  for (int i = queue_depth - 1; i >= 0; --i) free_slots.push_back(i);
  std::vector<io_event> events(queue_depth);
  std::vector<iocb*> batch;
  int inflight = 0;

  auto reap = [&](long min_nr) -> int64_t {
    long got = sys_io_getevents(ctx, min_nr, queue_depth, events.data());
    if (got < 0) return -errno;
    for (long i = 0; i < got; ++i) {
      int slot = static_cast<int>(events[i].data);
      int64_t res = events[i].res;
      if (res < 0) return res;
      if (!write)  // copy the landed block out of its bounce slot
        memcpy(buf + slot_user_off[slot], bounce + slot * block_size,
               static_cast<size_t>(res));
      completed += res;
      if (res > 0 && res < slot_len[slot]) {
        // short transfer: the unserved tail of this block would otherwise
        // be silently dropped (round-4 advisory). res need not stay
        // kAlign-aligned, so finish the remainder through the buffered
        // engine (coherent with the O_DIRECT body on Linux, same as the
        // unaligned-tail path below). res == 0 is EOF on a read shorter
        // than the request — partial byte count returned, like the
        // thread-pool fallback.
        int64_t rem_off = slot_user_off[slot] + res;
        int64_t rem_len = slot_len[slot] - res;
        int64_t r2 = blocked_rw(write, path, buf + rem_off, rem_len,
                                file_offset + rem_off,
                                static_cast<int>(block_size));
        if (r2 < 0) return r2;
        completed += r2;
      }
      free_slots.push_back(slot);
      --inflight;
    }
    return 0;
  };

  while (rc == 0 && (next_off < body || inflight > 0)) {
    // fill the ring
    batch.clear();
    while (next_off < body && !free_slots.empty()) {
      int slot = free_slots.back();
      free_slots.pop_back();
      int64_t chunk = std::min<int64_t>(block_size, body - next_off);
      chunk = (chunk / kAlign) * kAlign;  // O_DIRECT length alignment
      slot_user_off[slot] = next_off;
      slot_len[slot] = chunk;
      if (write) memcpy(bounce + slot * block_size, buf + next_off,
                        static_cast<size_t>(chunk));
      iocb* cb = &cbs[slot];
      memset(cb, 0, sizeof(*cb));
      cb->aio_lio_opcode = write ? IOCB_CMD_PWRITE : IOCB_CMD_PREAD;
      cb->aio_fildes = fd;
      cb->aio_buf = reinterpret_cast<uint64_t>(bounce + slot * block_size);
      cb->aio_nbytes = chunk;
      cb->aio_offset = file_offset + next_off;
      cb->aio_data = slot;
      next_off += chunk;
      ++inflight;
      if (single_submit) {
        iocb* one = cb;
        if (sys_io_submit(ctx, 1, &one) < 0) { rc = -errno; break; }
      } else {
        batch.push_back(cb);
      }
    }
    if (rc == 0 && !batch.empty()) {
      if (sys_io_submit(ctx, batch.size(), batch.data()) < 0) rc = -errno;
    }
    note_inflight(inflight);
    if (rc == 0 && inflight > 0) {
      if (overlap_events) {
        // overlap: free at least one slot, then go refill — submission
        // and completion interleave (reference do_aio_operation_overlap)
        int64_t r = reap(1);
        if (r < 0) rc = r;
      } else {
        // sequential: drain the whole wave before the next submit batch
        // (reference do_aio_operation_sequential)
        while (rc == 0 && inflight > 0) {
          int64_t r = reap(1);
          if (r < 0) rc = r;
        }
      }
    }
  }
  while (rc == 0 && inflight > 0) {
    int64_t r = reap(1);
    if (r < 0) rc = r;
  }

  // destroy BEFORE freeing the bounce region: io_destroy waits for any
  // still-in-flight requests, which DMA into these slots (on the error
  // paths inflight can be nonzero here)
  sys_io_destroy(ctx);
  free(bounce);
  ::close(fd);
  if (rc < 0) return rc;

  // unaligned tail through a buffered fd (mixing O_DIRECT body + buffered
  // tail on one file is coherent on Linux)
  int64_t tail = nbytes - body;
  if (tail > 0) {
    int tfd = ::open(path, write ? (O_WRONLY | O_CREAT) : O_RDONLY, 0644);
    if (tfd < 0) return -errno;
    ssize_t r = write
        ? ::pwrite(tfd, buf + body, tail, file_offset + body)
        : ::pread(tfd, buf + body, tail, file_offset + body);
    ::close(tfd);
    if (r < 0) return -errno;
    completed += r;
  }
  return completed;
}

struct Request {
  int64_t id;
  std::function<int64_t()> work;
};

struct Handle {
  int block_size;
  int queue_depth;
  int single_submit;
  int overlap_events;
  int num_threads;
  std::vector<std::thread> workers;
  std::deque<Request> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable done_cv;
  std::map<int64_t, int64_t> results;  // req id -> bytes or -errno
  std::atomic<int64_t> next_id{1};
  bool shutdown = false;

  void worker_loop() {
    for (;;) {
      Request req;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return shutdown || !queue.empty(); });
        if (shutdown && queue.empty()) return;
        req = std::move(queue.front());
        queue.pop_front();
      }
      int64_t res = req.work();
      {
        std::lock_guard<std::mutex> lk(mu);
        results[req.id] = res;
      }
      done_cv.notify_all();
    }
  }
};

std::map<int64_t, Handle*> g_handles;
std::mutex g_handles_mu;
std::atomic<int64_t> g_next_handle{1};

Handle* get_handle(int64_t h) {
  std::lock_guard<std::mutex> lk(g_handles_mu);
  auto it = g_handles.find(h);
  return it == g_handles.end() ? nullptr : it->second;
}

int64_t blocked_rw(bool write, const char* path, char* buf, int64_t nbytes,
                   int64_t file_offset, int block_size) {
  int flags = write ? (O_WRONLY | O_CREAT) : O_RDONLY;
  int fd = ::open(path, flags, 0644);
  if (fd < 0) return -errno;
  int64_t off = 0;
  while (off < nbytes) {
    int64_t chunk = std::min<int64_t>(block_size, nbytes - off);
    ssize_t r = write ? ::pwrite(fd, buf + off, chunk, file_offset + off)
                      : ::pread(fd, buf + off, chunk, file_offset + off);
    if (r < 0) {
      ::close(fd);
      return -errno;
    }
    if (r == 0) break;  // EOF on read
    off += r;
  }
  ::close(fd);
  return off;
}

}  // namespace

extern "C" {

int64_t aio_handle_create(int block_size, int queue_depth, int single_submit,
                          int overlap_events, int num_threads) {
  Handle* h = new Handle();
  h->block_size = block_size > 0 ? block_size : (1 << 20);
  h->queue_depth = queue_depth > 0 ? queue_depth : 8;
  h->single_submit = single_submit;
  h->overlap_events = overlap_events;
  h->num_threads = num_threads > 0 ? num_threads : 1;
  for (int i = 0; i < h->num_threads; ++i)
    h->workers.emplace_back([h] { h->worker_loop(); });
  std::lock_guard<std::mutex> lk(g_handles_mu);
  int64_t id = g_next_handle++;
  g_handles[id] = h;
  return id;
}

int aio_handle_destroy(int64_t handle) {
  Handle* h;
  {
    std::lock_guard<std::mutex> lk(g_handles_mu);
    auto it = g_handles.find(handle);
    if (it == g_handles.end()) return -1;
    h = it->second;
    g_handles.erase(it);
  }
  {
    std::lock_guard<std::mutex> lk(h->mu);
    h->shutdown = true;
  }
  h->cv.notify_all();
  for (auto& t : h->workers) t.join();
  delete h;
  return 0;
}

// async submit: returns request id (>0) or -errno
int64_t aio_async_pread(int64_t handle, char* buffer, const char* path,
                        int64_t nbytes, int64_t file_offset) {
  Handle* h = get_handle(handle);
  if (!h) return -1;
  int64_t id = h->next_id++;
  std::string p(path);
  int bs = h->block_size, qd = h->queue_depth;
  bool ss = h->single_submit != 0, oe = h->overlap_events != 0;
  {
    std::lock_guard<std::mutex> lk(h->mu);
    h->queue.push_back({id, [=] {
                          int64_t r = kernel_aio_rw(false, p.c_str(), buffer,
                                                    nbytes, file_offset, bs,
                                                    qd, ss, oe);
                          if (r == kUseFallback)
                            r = blocked_rw(false, p.c_str(), buffer, nbytes,
                                           file_offset, bs);
                          return r;
                        }});
  }
  h->cv.notify_one();
  return id;
}

int64_t aio_async_pwrite(int64_t handle, const char* buffer, const char* path,
                         int64_t nbytes, int64_t file_offset) {
  Handle* h = get_handle(handle);
  if (!h) return -1;
  int64_t id = h->next_id++;
  std::string p(path);
  int bs = h->block_size, qd = h->queue_depth;
  bool ss = h->single_submit != 0, oe = h->overlap_events != 0;
  {
    std::lock_guard<std::mutex> lk(h->mu);
    h->queue.push_back({id, [=] {
                          char* b = const_cast<char*>(buffer);
                          int64_t r = kernel_aio_rw(true, p.c_str(), b,
                                                    nbytes, file_offset, bs,
                                                    qd, ss, oe);
                          if (r == kUseFallback)
                            r = blocked_rw(true, p.c_str(), b, nbytes,
                                           file_offset, bs);
                          return r;
                        }});
  }
  h->cv.notify_one();
  return id;
}

// wait for one request; returns bytes transferred or -errno
int64_t aio_wait(int64_t handle, int64_t request_id) {
  Handle* h = get_handle(handle);
  if (!h) return -1;
  std::unique_lock<std::mutex> lk(h->mu);
  h->done_cv.wait(lk, [&] { return h->results.count(request_id) > 0; });
  int64_t res = h->results[request_id];
  h->results.erase(request_id);
  return res;
}

// count of completed-but-unwaited requests (reference wait/poll surface)
int64_t aio_pending(int64_t handle) {
  Handle* h = get_handle(handle);
  if (!h) return -1;
  std::lock_guard<std::mutex> lk(h->mu);
  return (int64_t)(h->queue.size());
}

int64_t aio_sync_pread(int64_t handle, char* buffer, const char* path,
                       int64_t nbytes, int64_t file_offset) {
  int64_t id = aio_async_pread(handle, buffer, path, nbytes, file_offset);
  if (id < 0) return id;
  return aio_wait(handle, id);
}

int64_t aio_sync_pwrite(int64_t handle, const char* buffer, const char* path,
                        int64_t nbytes, int64_t file_offset) {
  int64_t id = aio_async_pwrite(handle, buffer, path, nbytes, file_offset);
  if (id < 0) return id;
  return aio_wait(handle, id);
}

// observability: high-water mark of in-flight kernel-AIO requests since
// the last reset (0 = everything went through the fallback)
int64_t aio_max_inflight() { return g_max_inflight.load(); }
void aio_reset_max_inflight() { g_max_inflight.store(0); }

// 1 when the kernel io_submit engine can run for files under probe_dir:
// io_setup permitted AND O_DIRECT opens there (tmpfs/overlayfs reject it,
// in which case every transfer takes the thread-pool fallback). A null
// probe_dir checks io_setup only.
int aio_kernel_available(const char* probe_dir) {
  if (kernel_aio_disabled()) return 0;
  aio_context_t ctx = 0;
  if (sys_io_setup(1, &ctx) < 0) return 0;
  sys_io_destroy(ctx);
  if (probe_dir && probe_dir[0]) {
    std::string p(probe_dir);
    p += "/.ds_aio_probe";
    int fd = ::open(p.c_str(), O_WRONLY | O_CREAT | O_DIRECT, 0644);
    if (fd < 0) return 0;
    ::close(fd);
    ::unlink(p.c_str());
  }
  return 1;
}

}  // extern "C"
