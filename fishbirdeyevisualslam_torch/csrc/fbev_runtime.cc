// fbev_runtime — native pipeline executor + dataset prefetcher of the
// PyTorch / CUDA port (a copy of the JAX package's native/fbev_runtime.cc,
// built separately into build/, loaded by runtime/native.py).
//
// Mirrors the reference's thread architecture (System.cc:96-111: Tracking in
// the caller's thread, LocalMapping and LoopClosing as long-lived workers fed
// by queues with an abort flag, LocalMapping.cc:132-144) as a reusable
// library:
//
//   * N-stage pipeline: each stage owns a worker thread and a bounded MPSC
//     queue; items submitted to stage 0 flow through the stages in order.
//     Stage work is a host callback (registered through the C ABI — the Python
//     side passes ctypes function pointers; callbacks run under the GIL, and
//     the PyTorch operations they dispatch release it while they run).
//   * abort flag per stage (the reference's InterruptBA/mbAbortBA): the
//     producer can request the current item's work be cut short; the callback
//     polls fbev_stage_abort_requested().
//   * dataset prefetcher: a worker thread loading files ahead of the consumer
//     into a bounded buffer (binary PGM P5 parsing built in; arbitrary files
//     returned as raw bytes).
//
// Plain C ABI; no Python headers required (loaded via ctypes).

#include <atomic>
#include <cctype>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

typedef void (*fbev_stage_fn)(int stage, long item, void* user);

struct Stage {
  std::thread worker;
  std::deque<long> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> abort_item{false};
  std::atomic<long> processed{0};
  fbev_stage_fn fn = nullptr;
  void* user = nullptr;
  size_t capacity = 64;
};

struct Pipeline {
  std::vector<Stage*> stages;
  std::atomic<bool> stop{false};
  std::atomic<long> submitted{0};
};

static void stage_loop(Pipeline* p, int idx) {
  Stage* s = p->stages[idx];
  for (;;) {
    long item;
    {
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv.wait(lk, [&] { return p->stop.load() || !s->queue.empty(); });
      if (p->stop.load() && s->queue.empty()) return;
      item = s->queue.front();
      s->queue.pop_front();
    }
    s->cv.notify_all();
    s->abort_item.store(false);
    if (s->fn) s->fn(idx, item, s->user);
    s->processed.fetch_add(1);
    // forward to next stage
    if (idx + 1 < (int)p->stages.size()) {
      Stage* n = p->stages[idx + 1];
      std::unique_lock<std::mutex> lk(n->mu);
      n->cv.wait(lk, [&] { return p->stop.load() || n->queue.size() < n->capacity; });
      if (p->stop.load()) return;
      n->queue.push_back(item);
      n->cv.notify_all();
    }
  }
}

void* fbev_pipeline_create(int n_stages, int capacity) {
  Pipeline* p = new Pipeline();
  for (int i = 0; i < n_stages; i++) {
    Stage* s = new Stage();
    s->capacity = capacity > 0 ? (size_t)capacity : 64;
    p->stages.push_back(s);
  }
  for (int i = 0; i < n_stages; i++)
    p->stages[i]->worker = std::thread(stage_loop, p, i);
  return p;
}

void fbev_pipeline_set_stage(void* pp, int stage, fbev_stage_fn fn, void* user) {
  Pipeline* p = (Pipeline*)pp;
  p->stages[stage]->fn = fn;
  p->stages[stage]->user = user;
}

// submit an item id into stage 0 (blocks if the queue is full)
void fbev_pipeline_submit(void* pp, long item) {
  Pipeline* p = (Pipeline*)pp;
  Stage* s = p->stages[0];
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv.wait(lk, [&] { return p->stop.load() || s->queue.size() < s->capacity; });
  if (p->stop.load()) return;
  s->queue.push_back(item);
  p->submitted.fetch_add(1);
  s->cv.notify_all();
}

// request the stage's current item be cut short (InterruptBA analog)
void fbev_pipeline_signal_abort(void* pp, int stage) {
  ((Pipeline*)pp)->stages[stage]->abort_item.store(true);
}

int fbev_stage_abort_requested(void* pp, int stage) {
  return ((Pipeline*)pp)->stages[stage]->abort_item.load() ? 1 : 0;
}

long fbev_pipeline_processed(void* pp, int stage) {
  return ((Pipeline*)pp)->stages[stage]->processed.load();
}

int fbev_pipeline_queue_depth(void* pp, int stage) {
  Stage* s = ((Pipeline*)pp)->stages[stage];
  std::lock_guard<std::mutex> lk(s->mu);
  return (int)s->queue.size();
}

// wait until every submitted item has passed through the final stage
void fbev_pipeline_flush(void* pp) {
  Pipeline* p = (Pipeline*)pp;
  long want = p->submitted.load();
  Stage* last = p->stages.back();
  while (last->processed.load() < want)
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
}

void fbev_pipeline_destroy(void* pp) {
  Pipeline* p = (Pipeline*)pp;
  p->stop.store(true);
  for (auto* s : p->stages) s->cv.notify_all();
  for (auto* s : p->stages)
    if (s->worker.joinable()) s->worker.join();
  for (auto* s : p->stages) delete s;
  delete p;
}

// ---------------------------------------------------------------------------
// Dataset prefetcher
// ---------------------------------------------------------------------------

struct LoadedFile {
  std::vector<uint8_t> data;
  int width = 0, height = 0;  // set for PGM; 0 otherwise
};

struct Prefetcher {
  std::vector<std::string> paths;
  std::deque<LoadedFile*> ready;
  std::vector<LoadedFile*> outstanding;  // handed to the caller, not yet released
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
  size_t capacity;
  size_t next = 0;
  size_t loading = 0;  // files taken by the worker and not yet in `ready`
  std::thread worker;
};

static LoadedFile* load_file(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return nullptr;
  auto* out = new LoadedFile();
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->data.resize(n);
  if (fread(out->data.data(), 1, n, f) != (size_t)n) { fclose(f); delete out; return nullptr; }
  fclose(f);
  // binary PGM (P5): parse header, rewrite data to raw pixels
  if (n > 2 && out->data[0] == 'P' && out->data[1] == '5') {
    const char* s = (const char*)out->data.data();
    int w, h, maxv, pos = 2;
    auto skip_ws = [&]() {
      while (pos < n && (isspace(s[pos]) || s[pos] == '#')) {
        if (s[pos] == '#') while (pos < n && s[pos] != '\n') pos++;
        else pos++;
      }
    };
    auto read_int = [&]() {
      skip_ws();
      int v = 0;
      while (pos < n && isdigit(s[pos])) v = v * 10 + (s[pos++] - '0');
      return v;
    };
    w = read_int(); h = read_int(); maxv = read_int(); pos++;  // single ws after maxval
    if (w > 0 && h > 0 && maxv <= 255 && pos + (long)w * h <= n) {
      std::vector<uint8_t> px(out->data.begin() + pos, out->data.begin() + pos + (long)w * h);
      out->data = std::move(px);
      out->width = w;
      out->height = h;
    }
  }
  return out;
}

static void prefetch_loop(Prefetcher* p) {
  for (;;) {
    size_t idx;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv.wait(lk, [&] { return p->stop.load() || p->ready.size() < p->capacity; });
      if (p->stop.load()) return;
      if (p->next >= p->paths.size()) return;
      idx = p->next++;
      p->loading++;
    }
    LoadedFile* lf = load_file(p->paths[idx]);
    {
      std::lock_guard<std::mutex> lk(p->mu);
      p->ready.push_back(lf);
      p->loading--;
    }
    p->cv.notify_all();
  }
}

void* fbev_prefetch_create(const char** paths, int n, int capacity) {
  auto* p = new Prefetcher();
  for (int i = 0; i < n; i++) p->paths.emplace_back(paths[i]);
  p->capacity = capacity > 0 ? capacity : 8;
  p->worker = std::thread(prefetch_loop, p);
  return p;
}

// Returns 1 on success.  The data pointer stays valid until the caller passes
// it back to fbev_prefetch_release (per-prefetcher outstanding list — no
// global state, no leak).  Returns 0 when the sequence is exhausted or a file
// failed to load.
int fbev_prefetch_next(void* pp, uint8_t** data, long* len, int* width, int* height) {
  auto* p = (Prefetcher*)pp;
  std::unique_lock<std::mutex> lk(p->mu);
  // exhausted only once every file was taken and none is still loading: a
  // file taken but not yet pushed would otherwise read as the end
  p->cv.wait(lk, [&] {
    return p->stop.load() || !p->ready.empty() ||
           (p->next >= p->paths.size() && p->loading == 0);
  });
  if (p->ready.empty()) return 0;
  LoadedFile* lf = p->ready.front();
  p->ready.pop_front();
  if (lf) p->outstanding.push_back(lf);
  lk.unlock();
  p->cv.notify_all();
  if (!lf) return 0;
  *data = lf->data.data();
  *len = (long)lf->data.size();
  *width = lf->width;
  *height = lf->height;
  return 1;
}

// Release a buffer previously returned by fbev_prefetch_next (identified by
// its data pointer).  Returns 1 if found and freed.
int fbev_prefetch_release(void* pp, uint8_t* data) {
  auto* p = (Prefetcher*)pp;
  std::lock_guard<std::mutex> lk(p->mu);
  for (size_t i = 0; i < p->outstanding.size(); i++) {
    if (p->outstanding[i]->data.data() == data) {
      delete p->outstanding[i];
      p->outstanding.erase(p->outstanding.begin() + i);
      return 1;
    }
  }
  return 0;
}

int fbev_prefetch_outstanding(void* pp) {
  auto* p = (Prefetcher*)pp;
  std::lock_guard<std::mutex> lk(p->mu);
  return (int)p->outstanding.size();
}

void fbev_prefetch_destroy(void* pp) {
  auto* p = (Prefetcher*)pp;
  p->stop.store(true);
  p->cv.notify_all();
  if (p->worker.joinable()) p->worker.join();
  for (auto* lf : p->ready) delete lf;
  for (auto* lf : p->outstanding) delete lf;
  delete p;
}

}  // extern "C"
