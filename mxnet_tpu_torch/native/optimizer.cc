/*
 * Native SGD optimizer for the parameter server.
 *
 * Reference: `src/optimizer/sgd-inl.h` + `include/mxnet/optimizer.h` — the
 * C++ optimizer registry existed so *servers* could apply updates without
 * Python in the loop.  Same role here: a TCP parameter server installs
 * this fast path when the pickled optimizer is plain SGD (the port binds
 * it in `_native.py`; its parameter server is still to come).
 *
 * Update rule (`sgd-inl.h:21-40`):
 *   grad = clip(grad * rescale, ±clip_gradient)
 *   mom  = momentum * mom - lr * (grad + wd * weight)
 *   weight += mom                      (momentum > 0)
 *   weight -= lr * (grad + wd*weight)  (momentum == 0)
 *
 * Updates are chunked across a small thread pool like the reference's
 * OMP-parallel server reduce (`kvstore_local.h:180-236`).
 */
#include "mxtpu.h"
#include "error.h"

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

namespace {

struct SgdOpt {
  float lr, momentum, wd, rescale, clip;
  int nthreads;
  std::mutex mu;
  std::map<int, std::vector<float>> mom;  // per-key momentum state
};

std::mutex g_mu;
std::map<mxtpu_handle, std::unique_ptr<SgdOpt>> g_opts;
mxtpu_handle g_next = 1;

inline void update_range(SgdOpt* o, float* w, const float* g, float* m,
                         int64_t lo, int64_t hi) {
  const float lr = o->lr, mu = o->momentum, wd = o->wd, rs = o->rescale,
              cl = o->clip;
  if (mu > 0.0f) {
    for (int64_t i = lo; i < hi; ++i) {
      float gr = g[i] * rs;
      if (cl > 0.0f) gr = std::max(-cl, std::min(cl, gr));
      m[i] = mu * m[i] - lr * (gr + wd * w[i]);
      w[i] += m[i];
    }
  } else {
    for (int64_t i = lo; i < hi; ++i) {
      float gr = g[i] * rs;
      if (cl > 0.0f) gr = std::max(-cl, std::min(cl, gr));
      w[i] -= lr * (gr + wd * w[i]);
    }
  }
}

}  // namespace

MXTPU_API mxtpu_handle mxtpu_sgd_create(float lr, float momentum, float wd,
                                        float rescale, float clip_gradient,
                                        int nthreads) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto o = std::make_unique<SgdOpt>();
  o->lr = lr;
  o->momentum = momentum;
  o->wd = wd;
  o->rescale = rescale;
  o->clip = clip_gradient;
  o->nthreads = nthreads > 0 ? nthreads : 4;
  mxtpu_handle h = g_next++;
  g_opts[h] = std::move(o);
  return h;
}

MXTPU_API void mxtpu_sgd_set_lr(mxtpu_handle opt, float lr) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_opts.find(opt);
  if (it != g_opts.end()) it->second->lr = lr;
}

MXTPU_API int mxtpu_sgd_update(mxtpu_handle opt, int key, float* weight,
                               const float* grad, int64_t n) {
  SgdOpt* o;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_opts.find(opt);
    if (it == g_opts.end()) {
      mxtpu_err() = "sgd_update: bad handle";
      return -1;
    }
    o = it->second.get();
  }
  float* m = nullptr;
  if (o->momentum > 0.0f) {
    std::lock_guard<std::mutex> lk(o->mu);
    auto& v = o->mom[key];
    if ((int64_t)v.size() != n) v.assign(n, 0.0f);
    m = v.data();
  }
  // big arrays: chunk across threads (reference bigarray_bound_ pattern)
  const int64_t kParallelBound = 1 << 16;
  if (n < kParallelBound || o->nthreads <= 1) {
    update_range(o, weight, grad, m, 0, n);
    return 0;
  }
  int nt = o->nthreads;
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(update_range, o, weight, grad, m, lo, hi);
  }
  for (auto& t : ts) t.join();
  return 0;
}

MXTPU_API void mxtpu_sgd_destroy(mxtpu_handle opt) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_opts.erase(opt);
}

/* -- momentum state export/import (server snapshot support) --------------
 *
 * The parameter server's atomic snapshots (`parallel/dist.py
 * _write_snapshot`) must capture the momentum tables this updater keeps
 * in C++ — before these entry points existed, enabling snapshots forced
 * the server back onto the Python updater (ROADMAP carried item).
 */

namespace {
SgdOpt* find_opt(mxtpu_handle opt) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_opts.find(opt);
  return it == g_opts.end() ? nullptr : it->second.get();
}
}  // namespace

MXTPU_API int64_t mxtpu_sgd_keys(mxtpu_handle opt, int* out, int64_t cap) {
  SgdOpt* o = find_opt(opt);
  if (!o) {
    mxtpu_err() = "sgd_keys: bad handle";
    return -1;
  }
  std::lock_guard<std::mutex> lk(o->mu);
  int64_t n = 0;
  for (const auto& kv : o->mom) {
    if (out && n < cap) out[n] = kv.first;
    ++n;
  }
  return n;  // count of keys with momentum state (call with cap=0 to size)
}

MXTPU_API int64_t mxtpu_sgd_state_size(mxtpu_handle opt, int key) {
  SgdOpt* o = find_opt(opt);
  if (!o) {
    mxtpu_err() = "sgd_state_size: bad handle";
    return -1;
  }
  std::lock_guard<std::mutex> lk(o->mu);
  auto it = o->mom.find(key);
  return it == o->mom.end() ? 0 : (int64_t)it->second.size();
}

MXTPU_API int mxtpu_sgd_get_state(mxtpu_handle opt, int key, float* out,
                                  int64_t n) {
  SgdOpt* o = find_opt(opt);
  if (!o) {
    mxtpu_err() = "sgd_get_state: bad handle";
    return -1;
  }
  std::lock_guard<std::mutex> lk(o->mu);
  auto it = o->mom.find(key);
  if (it == o->mom.end() || (int64_t)it->second.size() != n) {
    mxtpu_err() = "sgd_get_state: no state of that size for key";
    return -1;
  }
  std::copy(it->second.begin(), it->second.end(), out);
  return 0;
}

MXTPU_API int mxtpu_sgd_set_state(mxtpu_handle opt, int key,
                                  const float* data, int64_t n) {
  SgdOpt* o = find_opt(opt);
  if (!o) {
    mxtpu_err() = "sgd_set_state: bad handle";
    return -1;
  }
  std::lock_guard<std::mutex> lk(o->mu);
  o->mom[key].assign(data, data + n);
  return 0;
}
