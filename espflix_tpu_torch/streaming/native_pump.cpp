// A lane-parallel pump for the served gather's mapped lanes.
//
// Fleet._gather_batch_packed (runtime/scheduler.py) hands every lane
// that reads from a title mapping (streaming/title_maps.py) to one
// np_pump call a tick.  Each lane runs the gather's pump rounds on its
// own: pop its next picture straight into the batch layout (the session
// feed's sf_pop_pictures_packed on that one lane); when it is starved
// and its title has bytes left, feed the next min(chunk, end - pos)
// bytes from the mapping at the lane's cursor (sf_feed) and pop again,
// at most max_rounds pops.  A lane stops at a picture (rc 1), at a
// capacity rc (< 0: the picture is not consumed, the caller pops it
// through the growable path) or at its title's end (ended: the caller
// runs the EOS branch).
//
// The feed library's per-lane steps share no state between lanes: a
// pop touches only its lane, that lane's batch row (words, prev_nw,
// n_words, slice rows at its slot) and the outputs at its own index; a
// feed only its lane.  So the lanes split over threads with the same
// bytes in the same order per lane, and the same results.  The entry
// points come in as function pointers from the library the process has
// loaded (native/libespflix_native.so), so this file holds no copy of
// the feed's logic.
//
// Threads: a Pool, made once a process, keeps workers that sleep on a
// condition variable between calls.  A call wakes as many as it asks
// for; they and the calling thread take lanes in small blocks from an
// atomic counter (trick lanes take 3-4 rounds where others take 1-2),
// and the call returns when every one of them is done.

#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <mutex>
#include <system_error>
#include <thread>
#include <vector>

namespace {

typedef int (*PopFn)(void* h, const int32_t* lanes, int n,
                     const int32_t* slots, int64_t* meta, uint8_t* words,
                     long words_cap, int32_t* prev_nw, int32_t* n_words,
                     int32_t* slice_off, int32_t* slice_rows,
                     int max_slices, uint8_t* iq, uint8_t* nq,
                     int32_t* rc);
typedef int (*FeedFn)(void* h, int lane, const uint8_t* data, long len);

struct Job {
  PopFn pop;
  FeedFn feed;
  void* handle;  // the feed library's Feed
  int n;         // lanes in this call
  int block;     // lanes a thread takes at a time
  // per call index k: the lane's fleet slot
  const int32_t* slots;
  // per fleet slot: native lane, mapping base, cursor (read and
  // written), end
  const int32_t* nlane;
  const uint64_t* base;
  int64_t* pos;
  const int64_t* end;
  long chunk;
  int max_rounds;
  // the packed batch (rows by slot)
  uint8_t* words;
  long words_cap;
  int32_t* prev_nw;
  int32_t* n_words;
  int32_t* slice_off;
  int32_t* slice_rows;
  int max_slices;
  // outputs per call index k
  int64_t* meta;  // [n, meta_stride]: session_feed.cpp's meta layout
  int meta_stride;
  uint8_t* iq;    // [n, 64]
  uint8_t* nq;    // [n, 64]
  int32_t* rc;
  int32_t* rounds;
  int64_t* fed;
  uint8_t* ended;
  std::atomic<int> next{0};
};

void pump_lane(const Job& j, int k) {
  const int32_t* slot = j.slots + k;
  const int32_t s = *slot;
  const int32_t lane = j.nlane[s];
  const uint8_t* base = reinterpret_cast<const uint8_t*>(j.base[s]);
  int32_t rc = 0;
  int r = 0;
  int64_t fed = 0;
  uint8_t ended = 0;
  while (r < j.max_rounds) {
    r++;
    j.pop(j.handle, &lane, 1, slot, j.meta + (long)k * j.meta_stride,
          j.words, j.words_cap, j.prev_nw, j.n_words, j.slice_off,
          j.slice_rows, j.max_slices, j.iq + (long)k * 64,
          j.nq + (long)k * 64, &rc);
    if (rc != 0) break;
    const int64_t left = j.end[s] - j.pos[s];
    if (left <= 0) {
      ended = 1;
      break;
    }
    const long len = (long)std::min<int64_t>(j.chunk, left);
    j.feed(j.handle, lane, base + j.pos[s], len);
    j.pos[s] += len;
    fed += len;
  }
  j.rc[k] = rc;
  j.rounds[k] = r;
  j.fed[k] = fed;
  j.ended[k] = ended;
}

void drain(Job& j) {
  for (;;) {
    const int k0 = j.next.fetch_add(j.block);
    if (k0 >= j.n) return;
    const int k1 = std::min(k0 + j.block, j.n);
    for (int k = k0; k < k1; k++) pump_lane(j, k);
  }
}

struct Pool {
  std::mutex call;  // one np_pump at a time
  std::mutex m;     // the fields below
  std::condition_variable wake, done;
  std::vector<std::thread> workers;
  Job* job = nullptr;
  uint64_t gen = 0;  // calls started
  int helpers = 0;   // workers taking part in call `gen`
  int busy = 0;      // of them, those not done yet
  bool stop = false;

  void loop(int id) {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(m);
    for (;;) {
      wake.wait(lk, [&] { return stop || (gen != seen && id < helpers); });
      if (stop) return;
      seen = gen;
      Job* j = job;
      lk.unlock();
      drain(*j);
      lk.lock();
      if (--busy == 0) done.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* np_pool_create() { return new Pool(); }

// Stop and join the workers, then free the pool.
void np_pool_destroy(void* h) {
  Pool* p = static_cast<Pool*>(h);
  {
    std::lock_guard<std::mutex> lk(p->m);
    p->stop = true;
  }
  p->wake.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

// Pump the n lanes at slots[0..n) on `threads` threads (the caller and
// threads - 1 workers, started on first need).  Returns the threads
// that took part.
int np_pump(void* h, int threads, void* pop, void* feed, void* handle,
            int n, const int32_t* slots, const int32_t* nlane,
            const uint64_t* base, int64_t* pos, const int64_t* end,
            long chunk, int max_rounds, uint8_t* words, long words_cap,
            int32_t* prev_nw, int32_t* n_words, int32_t* slice_off,
            int32_t* slice_rows, int max_slices, int64_t* meta,
            int meta_stride, uint8_t* iq, uint8_t* nq, int32_t* rc,
            int32_t* rounds, int64_t* fed, uint8_t* ended) {
  Pool* p = static_cast<Pool*>(h);
  std::lock_guard<std::mutex> call(p->call);
  Job j;
  j.pop = reinterpret_cast<PopFn>(pop);
  j.feed = reinterpret_cast<FeedFn>(feed);
  j.handle = handle;
  j.n = n;
  j.slots = slots;
  j.nlane = nlane;
  j.base = base;
  j.pos = pos;
  j.end = end;
  j.chunk = chunk;
  j.max_rounds = max_rounds;
  j.words = words;
  j.words_cap = words_cap;
  j.prev_nw = prev_nw;
  j.n_words = n_words;
  j.slice_off = slice_off;
  j.slice_rows = slice_rows;
  j.max_slices = max_slices;
  j.meta = meta;
  j.meta_stride = meta_stride;
  j.iq = iq;
  j.nq = nq;
  j.rc = rc;
  j.rounds = rounds;
  j.fed = fed;
  j.ended = ended;
  int helpers = std::max(0, std::min(threads - 1, n - 1));
  // blocks of 1-16 lanes, about eight a thread
  j.block = std::max(1, std::min(16, n / (8 * (helpers + 1))));
  {
    std::lock_guard<std::mutex> lk(p->m);
    try {
      while ((int)p->workers.size() < helpers) {
        const int id = (int)p->workers.size();
        p->workers.emplace_back([p, id] { p->loop(id); });
      }
    } catch (const std::system_error&) {
      helpers = (int)p->workers.size();  // run on the threads there are
    }
    p->job = &j;
    p->helpers = helpers;
    p->busy = helpers;
    p->gen++;
  }
  if (helpers) p->wake.notify_all();
  drain(j);
  if (helpers) {
    std::unique_lock<std::mutex> lk(p->m);
    p->done.wait(lk, [&] { return p->busy == 0; });
  }
  return helpers + 1;
}

}  // extern "C"
