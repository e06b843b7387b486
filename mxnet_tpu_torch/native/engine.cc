/*
 * Threaded dependency engine.
 *
 * Same contract as the reference's ThreadedEngine
 * (`src/engine/threaded_engine.{h,cc}`: single-writer / multi-reader
 * versioned variables, ops dispatched when all read/write deps are
 * satisfied), redesigned rather than translated: a per-var FIFO of waiting
 * ops guarded by a small mutex instead of lock-free linked blocks, and a
 * global priority task queue feeding a thread pool
 * (cf. `threaded_engine_perdevice.cc` worker pools).  Device-side ordering
 * is XLA's job; this engine orders *host* tasks (IO, host reductions,
 * checkpoint writes) pushed from Python via ctypes callbacks.
 */
#include "mxtpu.h"
#include "error.h"

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <queue>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {


struct Opr;

/* A versioned variable: FIFO of waiting ops + count of running readers. */
struct Var {
  std::mutex mu;
  // waiting ops in push order; .second = is_write
  std::deque<std::pair<Opr*, bool>> waiting;
  int running_reads = 0;
  bool running_write = false;
  bool to_delete = false;
};

struct Opr {
  mxtpu_fn_t fn = nullptr;
  void* arg = nullptr;
  int priority = 0;
  uint64_t seq = 0;  // FIFO tiebreak among equal priorities
  std::atomic<int> wait{0};
  std::vector<Var*> const_vars;
  std::vector<Var*> mutable_vars;
};

struct OprOrder {
  bool operator()(const Opr* a, const Opr* b) const {
    if (a->priority != b->priority) return a->priority < b->priority;
    return a->seq > b->seq;  // earlier push first
  }
};

class Engine {
 public:
  explicit Engine(int nthreads) {
    if (nthreads <= 0) nthreads = 4;
    for (int i = 0; i < nthreads; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  ~Engine() {
    WaitAll();
    {
      std::unique_lock<std::mutex> lk(qmu_);
      shutdown_ = true;
    }
    qcv_.notify_all();
    for (auto& t : workers_) t.join();
    for (Var* v : all_vars_) delete v;
  }

  Var* NewVar() {
    Var* v = new Var();
    std::unique_lock<std::mutex> lk(vars_mu_);
    all_vars_.insert(v);
    return v;
  }

  /* Deletion is itself a write op: runs after everything pending. */
  void DeleteVar(Var* v) {
    Var** box = new Var*[2];
    box[0] = v;
    box[1] = reinterpret_cast<Var*>(this);
    Push([](void* a) {
      Var** box = static_cast<Var**>(a);
      Engine* eng = reinterpret_cast<Engine*>(box[1]);
      eng->ReapVar(box[0]);
      delete[] box;
    }, box, nullptr, 0, &v, 1, 0);
  }

  void ReapVar(Var* v) {
    std::unique_lock<std::mutex> lk(vars_mu_);
    v->to_delete = true;  // actually freed in destructor sweep; cheap + safe
  }

  int Push(mxtpu_fn_t fn, void* arg, Var* const* cvars, int ncv,
           Var* const* mvars, int nmv, int priority) {
    Opr* op = new Opr();
    op->fn = fn;
    op->arg = arg;
    op->priority = priority;
    op->seq = seq_.fetch_add(1);
    op->const_vars.assign(cvars, cvars + ncv);
    op->mutable_vars.assign(mvars, mvars + nmv);
    // duplicate const+mutable var (like CheckDuplicate,
    // threaded_engine.cc:205-237) is a caller bug
    for (Var* m : op->mutable_vars)
      for (Var* c : op->const_vars)
        if (m == c) {
          delete op;
          mxtpu_err() = "var appears in both const_vars and mutable_vars";
          return -1;
        }
    pending_.fetch_add(1);
    // each dep satisfied immediately decrements; start from total count + 1
    // (the +1 sentinel avoids dispatch while still registering deps)
    op->wait.store(ncv + nmv + 1);
    for (Var* v : op->const_vars) {
      std::unique_lock<std::mutex> lk(v->mu);
      if (!v->running_write && v->waiting.empty()) {
        ++v->running_reads;
        op->wait.fetch_sub(1);
      } else {
        v->waiting.emplace_back(op, false);
      }
    }
    for (Var* v : op->mutable_vars) {
      std::unique_lock<std::mutex> lk(v->mu);
      if (!v->running_write && v->running_reads == 0 && v->waiting.empty()) {
        v->running_write = true;
        op->wait.fetch_sub(1);
      } else {
        v->waiting.emplace_back(op, true);
      }
    }
    if (op->wait.fetch_sub(1) == 1) Enqueue(op);
    return 0;
  }

  void WaitForVar(Var* v) {
    // sentinel read op that signals a local latch (reference WaitForVar,
    // threaded_engine.cc:300-327)
    struct Latch {
      std::mutex mu;
      std::condition_variable cv;
      bool done = false;
    } latch;
    Var* cv[1] = {v};
    Push([](void* a) {
      Latch* l = static_cast<Latch*>(a);
      std::unique_lock<std::mutex> lk(l->mu);
      l->done = true;
      l->cv.notify_all();
    }, &latch, cv, 1, nullptr, 0, /*priority=*/1 << 20);
    std::unique_lock<std::mutex> lk(latch.mu);
    latch.cv.wait(lk, [&] { return latch.done; });
  }

  void WaitAll() {
    std::unique_lock<std::mutex> lk(idle_mu_);
    idle_cv_.wait(lk, [this] { return pending_.load() == 0; });
  }

  int64_t NumExecuted() const { return executed_.load(); }

 private:
  void Enqueue(Opr* op) {
    {
      std::unique_lock<std::mutex> lk(qmu_);
      ready_.push(op);
    }
    qcv_.notify_one();
  }

  void WorkerLoop() {
    for (;;) {
      Opr* op;
      {
        std::unique_lock<std::mutex> lk(qmu_);
        qcv_.wait(lk, [this] { return shutdown_ || !ready_.empty(); });
        if (shutdown_ && ready_.empty()) return;
        op = ready_.top();
        ready_.pop();
      }
      op->fn(op->arg);
      Complete(op);
      executed_.fetch_add(1);
      if (pending_.fetch_sub(1) == 1) {
        std::unique_lock<std::mutex> lk(idle_mu_);
        idle_cv_.notify_all();
      }
    }
  }

  /* Release deps; dispatch newly-ready ops (CompleteRead/WriteDependency). */
  void Complete(Opr* op) {
    std::vector<Opr*> ready;
    for (Var* v : op->const_vars) {
      std::unique_lock<std::mutex> lk(v->mu);
      if (--v->running_reads == 0) DrainLocked(v, &ready);
    }
    for (Var* v : op->mutable_vars) {
      std::unique_lock<std::mutex> lk(v->mu);
      v->running_write = false;
      DrainLocked(v, &ready);
    }
    delete op;
    for (Opr* r : ready)
      if (r->wait.fetch_sub(1) == 1) Enqueue(r);
  }

  /* With v->mu held: admit the next writer, or all leading readers. */
  void DrainLocked(Var* v, std::vector<Opr*>* ready) {
    if (v->running_write) return;
    while (!v->waiting.empty()) {
      auto [op, is_write] = v->waiting.front();
      if (is_write) {
        if (v->running_reads == 0 && !v->running_write) {
          v->running_write = true;
          v->waiting.pop_front();
          ready->push_back(op);
        }
        return;  // writer blocks everything behind it
      }
      if (v->running_write) return;
      ++v->running_reads;
      v->waiting.pop_front();
      ready->push_back(op);
    }
  }

  std::vector<std::thread> workers_;
  std::mutex qmu_;
  std::condition_variable qcv_;
  std::priority_queue<Opr*, std::vector<Opr*>, OprOrder> ready_;
  bool shutdown_ = false;

  std::mutex idle_mu_;
  std::condition_variable idle_cv_;
  std::atomic<int64_t> pending_{0};
  std::atomic<int64_t> executed_{0};
  std::atomic<uint64_t> seq_{0};

  std::mutex vars_mu_;
  std::set<Var*> all_vars_;
};

std::mutex g_handles_mu;
std::map<mxtpu_handle, Engine*> g_engines;
std::map<mxtpu_handle, Var*> g_vars;
mxtpu_handle g_next_handle = 1;

Engine* GetEngine(mxtpu_handle h) {
  std::unique_lock<std::mutex> lk(g_handles_mu);
  auto it = g_engines.find(h);
  return it == g_engines.end() ? nullptr : it->second;
}

Var* GetVar(mxtpu_handle h) {
  std::unique_lock<std::mutex> lk(g_handles_mu);
  auto it = g_vars.find(h);
  return it == g_vars.end() ? nullptr : it->second;
}

}  // namespace

const char* mxtpu_last_error() { return mxtpu_err().c_str(); }

mxtpu_handle mxtpu_engine_create(int nthreads) {
  Engine* e = new Engine(nthreads);
  std::unique_lock<std::mutex> lk(g_handles_mu);
  mxtpu_handle h = g_next_handle++;
  g_engines[h] = e;
  return h;
}

void mxtpu_engine_destroy(mxtpu_handle eng) {
  Engine* e = nullptr;
  {
    std::unique_lock<std::mutex> lk(g_handles_mu);
    auto it = g_engines.find(eng);
    if (it == g_engines.end()) return;
    e = it->second;
    g_engines.erase(it);
  }
  delete e;
}

mxtpu_handle mxtpu_var_create(mxtpu_handle eng) {
  Engine* e = GetEngine(eng);
  if (!e) { mxtpu_err() = "bad engine handle"; return 0; }
  Var* v = e->NewVar();
  std::unique_lock<std::mutex> lk(g_handles_mu);
  mxtpu_handle h = g_next_handle++;
  g_vars[h] = v;
  return h;
}

void mxtpu_var_delete(mxtpu_handle eng, mxtpu_handle var) {
  Engine* e = GetEngine(eng);
  Var* v = GetVar(var);
  if (!e || !v) return;
  {
    std::unique_lock<std::mutex> lk(g_handles_mu);
    g_vars.erase(var);
  }
  e->DeleteVar(v);
}

int mxtpu_push(mxtpu_handle eng, mxtpu_fn_t fn, void* arg,
               const mxtpu_handle* const_vars, int n_const,
               const mxtpu_handle* mutable_vars, int n_mutable,
               int priority) {
  Engine* e = GetEngine(eng);
  if (!e) { mxtpu_err() = "bad engine handle"; return -1; }
  std::vector<Var*> cv(n_const), mv(n_mutable);
  for (int i = 0; i < n_const; ++i) {
    cv[i] = GetVar(const_vars[i]);
    if (!cv[i]) { mxtpu_err() = "bad const var handle"; return -1; }
  }
  for (int i = 0; i < n_mutable; ++i) {
    mv[i] = GetVar(mutable_vars[i]);
    if (!mv[i]) { mxtpu_err() = "bad mutable var handle"; return -1; }
  }
  return e->Push(fn, arg, cv.data(), n_const, mv.data(), n_mutable, priority);
}

void mxtpu_wait_for_var(mxtpu_handle eng, mxtpu_handle var) {
  Engine* e = GetEngine(eng);
  Var* v = GetVar(var);
  if (e && v) e->WaitForVar(v);
}

void mxtpu_wait_all(mxtpu_handle eng) {
  Engine* e = GetEngine(eng);
  if (e) e->WaitAll();
}

int64_t mxtpu_engine_num_executed(mxtpu_handle eng) {
  Engine* e = GetEngine(eng);
  return e ? e->NumExecuted() : -1;
}
