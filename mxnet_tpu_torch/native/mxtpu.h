/*
 * mxtpu native runtime — C ABI (the PyTorch port's copy).
 *
 * The host side of the reference's native runtime layers: the dependency
 * engine (`include/mxnet/engine.h`, `src/engine/threaded_engine*`), dmlc
 * recordio (`src/io/`), and the threaded batch loader
 * (`src/io/iter_prefetcher.h`).  Device compute is ordered by the CUDA
 * streams; this library owns *host-side* systems work: dependency-ordered
 * async host tasks (IO, reductions, checkpoints), record IO, and
 * prefetching/decode pipelines.
 *
 * Everything is exposed through a flat C ABI consumed via ctypes
 * (`mxnet_tpu_torch/_native.py`); no pybind, no framework headers.  The
 * JPEG decoder and the im2rec packer compile only where the build finds
 * libjpeg (MXTPU_HAVE_JPEG); `mxtpu_has_jpeg` says which.
 */
#ifndef MXTPU_H_
#define MXTPU_H_

#include <cstdint>

#if defined(__GNUC__)
#define MXTPU_API extern "C" __attribute__((visibility("default")))
#else
#define MXTPU_API extern "C"
#endif

typedef int64_t mxtpu_handle;
typedef void (*mxtpu_fn_t)(void* arg);

/* ---- error reporting (c_api_error pattern: TLS last-error string) ---- */
MXTPU_API const char* mxtpu_last_error();

/* 1 when this build decodes and encodes JPEG (linked with libjpeg), else 0 */
MXTPU_API int mxtpu_has_jpeg();

/* ---- dependency engine ---- */
MXTPU_API mxtpu_handle mxtpu_engine_create(int nthreads);
MXTPU_API void mxtpu_engine_destroy(mxtpu_handle eng);
MXTPU_API mxtpu_handle mxtpu_var_create(mxtpu_handle eng);
/* schedules deletion after all pending ops on the var complete */
MXTPU_API void mxtpu_var_delete(mxtpu_handle eng, mxtpu_handle var);
/* fn(arg) runs on a worker thread once all deps are satisfied.
 * const_vars: read deps; mutable_vars: write deps.  priority: higher runs
 * first among ready tasks. Returns 0 on success. */
MXTPU_API int mxtpu_push(mxtpu_handle eng, mxtpu_fn_t fn, void* arg,
                         const mxtpu_handle* const_vars, int n_const,
                         const mxtpu_handle* mutable_vars, int n_mutable,
                         int priority);
MXTPU_API void mxtpu_wait_for_var(mxtpu_handle eng, mxtpu_handle var);
MXTPU_API void mxtpu_wait_all(mxtpu_handle eng);
/* stats: number of ops executed since creation */
MXTPU_API int64_t mxtpu_engine_num_executed(mxtpu_handle eng);

/* ---- recordio ---- */
MXTPU_API mxtpu_handle mxtpu_recio_writer_open(const char* path);
MXTPU_API int mxtpu_recio_write(mxtpu_handle w, const void* data,
                                uint64_t len);
MXTPU_API void mxtpu_recio_writer_close(mxtpu_handle w);

/* part_index/num_parts shard the file by byte ranges with resync to the
 * next record magic, like dmlc::InputSplit (sharded distributed reads). */
MXTPU_API mxtpu_handle mxtpu_recio_reader_open(const char* path,
                                               int part_index, int num_parts);
/* returns pointer valid until next call; len=0 and NULL at EOF */
MXTPU_API const void* mxtpu_recio_read(mxtpu_handle r, uint64_t* len);
MXTPU_API void mxtpu_recio_reader_seek0(mxtpu_handle r);
MXTPU_API void mxtpu_recio_reader_close(mxtpu_handle r);

/* ---- threaded prefetching batch loader ----
 * Reads recordio records (IRHeader 'IfQQ' + raw npy payload), decodes on
 * n_threads workers, assembles float32 batches of batch_size x sample_len
 * (+ labels), double-buffered ahead of the consumer. */
MXTPU_API mxtpu_handle mxtpu_loader_open(const char* path, int part_index,
                                         int num_parts, int batch_size,
                                         uint64_t sample_len, int n_threads,
                                         int prefetch);
/* copies next batch into caller buffers; returns number of valid samples
 * (0 at epoch end; < batch_size on last partial batch, rest zero-padded);
 * -1 with the last error set when the batch holds a JPEG record and this
 * build has no libjpeg (nothing is zero-filled for that) */
MXTPU_API int mxtpu_loader_next(mxtpu_handle l, float* data, float* label);
/* JPEG fast path: batches stay uint8 HWC exactly as libjpeg emits them —
 * no host-side deinterleave/float widening, 4x smaller copies; the device
 * does layout+convert.  Only valid for JPEG payloads. */
MXTPU_API mxtpu_handle mxtpu_loader_open_u8(const char* path,
                                            int part_index, int num_parts,
                                            int batch_size,
                                            uint64_t sample_len,
                                            int n_threads, int prefetch);
MXTPU_API int mxtpu_loader_next_u8(mxtpu_handle l, uint8_t* data,
                                   float* label);
/* decode failures (samples left zero-filled) in the batch most recently
 * returned by mxtpu_loader_next/_u8 — lets the caller detect mixed or
 * corrupt payloads instead of silently training on zeros */
MXTPU_API int mxtpu_loader_last_failed(mxtpu_handle l);
MXTPU_API void mxtpu_loader_reset(mxtpu_handle l);
MXTPU_API void mxtpu_loader_close(mxtpu_handle l);

/* -- native im2rec packer (`tools/im2rec.cc`) ---------------------------
 * Pack `index \t label \t relpath` list entries (JPEG inputs) into
 * rec_path + .idx: decode, resize shorter side to `resize` (0 = keep),
 * re-encode at `quality`, parallel across nthreads with deterministic
 * output order.  Returns records written (-1 on fatal error); entries
 * that fail to decode are skipped and counted into *out_failed. */
MXTPU_API int64_t mxtpu_im2rec_pack(const char* list_path, const char* root,
                                    const char* rec_path, int resize,
                                    int quality, int nthreads,
                                    int64_t* out_failed);

/* -- native SGD (server-side updates, `src/optimizer/sgd-inl.h`) -------- */
MXTPU_API mxtpu_handle mxtpu_sgd_create(float lr, float momentum, float wd,
                                        float rescale, float clip_gradient,
                                        int nthreads);
MXTPU_API void mxtpu_sgd_set_lr(mxtpu_handle opt, float lr);
/* In-place: weight += update(grad); momentum state kept per (opt, key). */
MXTPU_API int mxtpu_sgd_update(mxtpu_handle opt, int key, float* weight,
                               const float* grad, int64_t n);
MXTPU_API void mxtpu_sgd_destroy(mxtpu_handle opt);
/* Momentum-state export/import so dist-PS snapshots can capture and
 * rehydrate the C++ tables (fault tolerance composes with the native
 * updater).  keys: write up to cap ids into out, return the total count
 * (cap=0 sizes the buffer); state_size: floats held for key (0 = none);
 * get/set: copy the table out/in (get requires the exact size). */
MXTPU_API int64_t mxtpu_sgd_keys(mxtpu_handle opt, int* out, int64_t cap);
MXTPU_API int64_t mxtpu_sgd_state_size(mxtpu_handle opt, int key);
MXTPU_API int mxtpu_sgd_get_state(mxtpu_handle opt, int key, float* out,
                                  int64_t n);
MXTPU_API int mxtpu_sgd_set_state(mxtpu_handle opt, int key,
                                  const float* data, int64_t n);

#endif  /* MXTPU_H_ */
