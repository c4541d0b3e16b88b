// Host staging runtime for the input pipeline (upstream analogue:
// paddle/fluid's pinned-memory allocator + DataLoader C++ workers), host
// code: the port's own copy of the JAX package's csrc/staging.cpp.
//
// Two pieces, bound from Python via ctypes (no pybind11 in this image):
//
// 1. Staging ring buffer: N fixed-size, 64-byte-aligned host slots
//    recycled producer->consumer with a mutex/condvar handshake. The
//    DataLoader assembles each device batch directly into one slot (no
//    per-sample numpy concatenation), then hands the contiguous buffer
//    to the device transfer and recycles the slot.
//
// 2. Decoder pool: a fixed team of C++ threads executing sample-decode
//    jobs (strided memcpy, u8->f32 normalize) WITHOUT the Python GIL —
//    the Python side only enqueues pointers. This is where multi-core
//    decode parallelism comes from (Python threads would serialize on
//    the GIL for the copy loop).
//
// Build: g++ -O3 -fPIC -shared -pthread (see paddle_tpu_torch/io/native.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// staging ring buffer
// ---------------------------------------------------------------------------

struct Staging {
  std::vector<uint8_t*> slots;
  size_t slot_bytes;
  std::deque<int> free_q;     // slots available to producers
  std::deque<int> ready_q;    // committed slots awaiting the consumer
  std::vector<size_t> committed_bytes;
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  bool closed = false;
};

void* staging_create(size_t slot_bytes, int n_slots) {
  auto* s = new Staging();
  s->slot_bytes = slot_bytes;
  s->slots.resize(n_slots);
  s->committed_bytes.resize(n_slots, 0);
  for (int i = 0; i < n_slots; ++i) {
    void* p = nullptr;
    if (posix_memalign(&p, 64, slot_bytes) != 0) {
      for (int j = 0; j < i; ++j) free(s->slots[j]);
      delete s;
      return nullptr;
    }
    s->slots[i] = static_cast<uint8_t*>(p);
    s->free_q.push_back(i);
  }
  return s;
}

// producer: block until a free slot; returns slot index or -1 if closed
int staging_acquire(void* h) {
  auto* s = static_cast<Staging*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_free.wait(lk, [&] { return !s->free_q.empty() || s->closed; });
  if (s->free_q.empty()) return -1;
  int idx = s->free_q.front();
  s->free_q.pop_front();
  return idx;
}

uint8_t* staging_ptr(void* h, int slot) {
  return static_cast<Staging*>(h)->slots[slot];
}

size_t staging_slot_bytes(void* h) {
  return static_cast<Staging*>(h)->slot_bytes;
}

void staging_commit(void* h, int slot, size_t nbytes) {
  auto* s = static_cast<Staging*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->committed_bytes[slot] = nbytes;
    s->ready_q.push_back(slot);
  }
  s->cv_ready.notify_one();
}

// consumer: block until a committed slot; returns index or -1 if closed+empty
int staging_pop(void* h, size_t* nbytes_out) {
  auto* s = static_cast<Staging*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_ready.wait(lk, [&] { return !s->ready_q.empty() || s->closed; });
  if (s->ready_q.empty()) return -1;
  int idx = s->ready_q.front();
  s->ready_q.pop_front();
  if (nbytes_out) *nbytes_out = s->committed_bytes[idx];
  return idx;
}

void staging_release(void* h, int slot) {
  auto* s = static_cast<Staging*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->free_q.push_back(slot);
  }
  s->cv_free.notify_one();
}

void staging_close(void* h) {
  auto* s = static_cast<Staging*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->closed = true;
  }
  s->cv_free.notify_all();
  s->cv_ready.notify_all();
}

void staging_destroy(void* h) {
  auto* s = static_cast<Staging*>(h);
  staging_close(h);
  for (auto* p : s->slots) free(p);
  delete s;
}

// ---------------------------------------------------------------------------
// decoder pool
// ---------------------------------------------------------------------------

enum JobKind : int {
  JOB_MEMCPY = 0,       // raw copy src -> dst
  JOB_U8_TO_F32 = 1,    // dst_f32[i] = (src_u8[i] - shift) * scale
  JOB_F32_SCALE = 2,    // dst_f32[i] = (src_f32[i] - shift) * scale
};

// a ticket is a counter + condvar the submitter blocks on (a bare atomic
// would force pool_ticket_wait to busy-spin, pinning a host core for the
// whole batch assembly and competing with the decoder threads)
struct Ticket {
  std::mutex mu;
  std::condition_variable cv;
  int count = 0;
};

struct Job {
  int kind;
  const uint8_t* src;
  uint8_t* dst;
  size_t n;            // element count
  float scale, shift;
  Ticket* done_flag;
};

struct Pool {
  std::vector<std::thread> threads;
  std::deque<Job> q;
  std::mutex mu;
  std::condition_variable cv;
  bool stop = false;
};

static void run_job(const Job& j) {
  switch (j.kind) {
    case JOB_MEMCPY:
      memcpy(j.dst, j.src, j.n);
      break;
    case JOB_U8_TO_F32: {
      const uint8_t* s = j.src;
      float* d = reinterpret_cast<float*>(j.dst);
      for (size_t i = 0; i < j.n; ++i)
        d[i] = (static_cast<float>(s[i]) - j.shift) * j.scale;
      break;
    }
    case JOB_F32_SCALE: {
      const float* s = reinterpret_cast<const float*>(j.src);
      float* d = reinterpret_cast<float*>(j.dst);
      for (size_t i = 0; i < j.n; ++i) d[i] = (s[i] - j.shift) * j.scale;
      break;
    }
  }
  if (j.done_flag) {
    // notify while still holding the mutex: the waiter may destroy the
    // ticket the moment its predicate is satisfied, so an unlocked
    // notify_all could touch freed memory
    std::lock_guard<std::mutex> lk(j.done_flag->mu);
    ++j.done_flag->count;
    j.done_flag->cv.notify_all();
  }
}

void* pool_create(int n_threads) {
  auto* p = new Pool();
  for (int i = 0; i < n_threads; ++i) {
    p->threads.emplace_back([p] {
      for (;;) {
        Job j;
        {
          std::unique_lock<std::mutex> lk(p->mu);
          p->cv.wait(lk, [&] { return !p->q.empty() || p->stop; });
          if (p->q.empty()) return;
          j = p->q.front();
          p->q.pop_front();
        }
        run_job(j);
      }
    });
  }
  return p;
}

void* pool_ticket_create() { return new Ticket(); }
int pool_ticket_count(void* t) {
  auto* tk = static_cast<Ticket*>(t);
  std::lock_guard<std::mutex> lk(tk->mu);
  return tk->count;
}
void pool_ticket_destroy(void* t) {
  delete static_cast<Ticket*>(t);
}

void pool_submit(void* h, int kind, const void* src, void* dst, size_t n,
                 float scale, float shift, void* ticket) {
  auto* p = static_cast<Pool*>(h);
  Job j{kind, static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
        n, scale, shift, static_cast<Ticket*>(ticket)};
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->q.push_back(j);
  }
  p->cv.notify_one();
}

// block (in C++, GIL released by ctypes) until `count` jobs completed
void pool_ticket_wait(void* t, int count) {
  auto* tk = static_cast<Ticket*>(t);
  std::unique_lock<std::mutex> lk(tk->mu);
  tk->cv.wait(lk, [&] { return tk->count >= count; });
}

void pool_destroy(void* h) {
  auto* p = static_cast<Pool*>(h);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv.notify_all();
  for (auto& t : p->threads) t.join();
  delete p;
}

}  // extern "C"
