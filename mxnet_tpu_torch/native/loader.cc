/*
 * Threaded prefetching batch loader.
 *
 * Counterpart of the reference's decode+batch pipeline
 * (`src/io/iter_image_recordio.cc` OMP decode, `src/io/iter_batchloader.h`,
 * `src/io/iter_prefetcher.h` ThreadedIter double-buffering): a producer
 * thread streams records from a (sharded) recordio pack, decodes the
 * IRHeader+npy payloads with a small worker pool, assembles fixed-size
 * float32 batches, and keeps `prefetch` batches ready ahead of the
 * consumer.  The consumer (`mxnet_tpu_torch/io.py` ImageRecordIter)
 * copies into numpy and hands the batch to the device — keeping the
 * card's feed off the Python thread.
 *
 * Payload format: IRHeader 'IfQQ' (flag, label, id, id2) followed by either
 * a raw .npy blob or a JPEG (see `mxnet_tpu_torch/recordio.py` pack_img).
 * npy dtypes <f4, <f8, |u1, <i1, <i4, <i8 convert to float32; JPEG decodes
 * via libjpeg to RGB/grayscale (PIL-compatible colors) and lands CHW
 * float32 — the reference's OMP cv2::imdecode role
 * (`iter_image_recordio.cc:184-194`) without per-record Python overhead.
 * Built without libjpeg (no MXTPU_HAVE_JPEG), a batch holding a JPEG
 * record fails as a whole: `Next` returns -1 and sets the last error.
 */
#include "mxtpu.h"
#include "error.h"

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifdef MXTPU_HAVE_JPEG
#include "jpeg_err.h"
#endif

namespace {

bool IsJpeg(const unsigned char* p, uint64_t len) {
  return len >= 3 && p[0] == 0xFF && p[1] == 0xD8 && p[2] == 0xFF;
}

/* PIL convert('L') exact luma: (19595 R + 38470 G + 7471 B + 0x8000)>>16
 * (Pillow ImagingConvert L24 rounding). */
inline uint8_t PilLuma(const unsigned char* px) {
  return (uint8_t)((19595u * px[0] + 38470u * px[1] + 7471u * px[2]
                    + 0x8000u) >> 16);
}

/* Decode a JPEG payload.  Exactly one of outf (CHW float32) / outu8 (HWC
 * uint8) is set.  Channel count is inferred from sample_len / (h*w).
 * Bit-identical to the Python/PIL path: c==3 decodes RGB; c==1 returns Y
 * directly for grayscale-encoded JPEGs and the PIL luma of the RGB decode
 * for color-encoded ones (JCS_GRAYSCALE on a color source would return
 * the encoded Y component instead, which PIL does not). */
constexpr const char* kNoJpeg =
    "a record holds a JPEG, and this build of the native library has no "
    "libjpeg (jpeglib.h was not found when it was built)";

#ifdef MXTPU_HAVE_JPEG
constexpr bool kHaveJpeg = true;
using JpegErr = MxtpuJpegErr;
constexpr auto JpegErrExit = MxtpuJpegErrExit;

bool DecodeJpegImpl(const unsigned char* buf, uint64_t len,
                    uint64_t sample_len, float* outf, uint8_t* outu8,
                    std::string* err) {
  // declared before setjmp: longjmp past a live non-trivial automatic is UB
  std::vector<unsigned char> row;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JpegErrExit;
  if (setjmp(jerr.jb)) {
    *err = std::string("jpeg decode failed: ") + jerr.msg;
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  uint64_t h = cinfo.image_height, w = cinfo.image_width;
  if (h == 0 || w == 0 || sample_len % (h * w) != 0) {
    *err = "jpeg dims do not divide sample_len";
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  uint64_t c = sample_len / (h * w);
  bool luma_convert = false;  // c==1 from a color source: RGB -> PIL luma
  if (c == 3) {
    cinfo.out_color_space = JCS_RGB;
  } else if (c == 1) {
    if (cinfo.jpeg_color_space == JCS_GRAYSCALE) {
      cinfo.out_color_space = JCS_GRAYSCALE;
    } else {
      cinfo.out_color_space = JCS_RGB;
      luma_convert = true;
    }
  } else {
    *err = "jpeg: only 1 or 3 channel samples supported";
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_start_decompress(&cinfo);
  uint64_t dec_c = luma_convert ? 3 : c;
  bool direct_u8 = outu8 != nullptr && !luma_convert;
  if (!direct_u8) row.resize(w * dec_c);
  while (cinfo.output_scanline < h) {
    uint64_t y = cinfo.output_scanline;
    unsigned char* rp =
        direct_u8 ? outu8 + y * w * c : row.data();
    jpeg_read_scanlines(&cinfo, &rp, 1);
    if (direct_u8) continue;
    if (outu8 != nullptr) {  // luma_convert into u8 output
      for (uint64_t x = 0; x < w; ++x)
        outu8[y * w + x] = PilLuma(rp + x * 3);
    } else if (luma_convert) {
      float* dst = outf + y * w;
      for (uint64_t x = 0; x < w; ++x)
        dst[x] = (float)PilLuma(rp + x * 3);
    } else {
      for (uint64_t ch = 0; ch < c; ++ch) {
        float* dst = outf + ch * h * w + y * w;
        for (uint64_t x = 0; x < w; ++x) dst[x] = (float)rp[x * c + ch];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}
#else
constexpr bool kHaveJpeg = false;

bool DecodeJpegImpl(const unsigned char*, uint64_t, uint64_t, float*,
                    uint8_t*, std::string* err) {
  *err = kNoJpeg;
  return false;
}
#endif

bool DecodeJpeg(const unsigned char* buf, uint64_t len, uint64_t sample_len,
                float* out, std::string* err) {
  return DecodeJpegImpl(buf, len, sample_len, out, nullptr, err);
}

bool DecodeJpegU8(const unsigned char* buf, uint64_t len,
                  uint64_t sample_len, uint8_t* out, std::string* err) {
  return DecodeJpegImpl(buf, len, sample_len, nullptr, out, err);
}

struct Batch {
  std::vector<float> data;      // CHW float mode
  std::vector<uint8_t> data_u8; // HWC uint8 mode (JPEG fast path)
  std::vector<float> label;
  int n = 0;
  int failed = 0;  // samples left zero-filled by a decode failure
  bool epoch_end = false;
  bool no_jpeg = false;  // a JPEG record in a build without libjpeg
  std::string err;       // the first decode error of the batch
};

Batch EpochEnd() {
  Batch b;
  b.epoch_end = true;
  return b;
}

/* minimal .npy header parse: returns element count and a converter */
bool ParseNpy(const char* buf, uint64_t len, uint64_t sample_len,
              float* out, std::string* err) {
  if (len < 10 || memcmp(buf, "\x93NUMPY", 6) != 0) {
    *err = "payload is not a .npy blob";
    return false;
  }
  int major = buf[6];
  uint64_t hlen, hoff;
  if (major == 1) {
    uint16_t h;
    memcpy(&h, buf + 8, 2);
    hlen = h;
    hoff = 10;
  } else {
    uint32_t h;
    memcpy(&h, buf + 8, 4);
    hlen = h;
    hoff = 12;
  }
  if (hoff + hlen > len) { *err = "truncated npy header"; return false; }
  std::string hdr(buf + hoff, hlen);
  if (hdr.find("'fortran_order': True") != std::string::npos) {
    *err = "fortran-order npy not supported";
    return false;
  }
  auto dpos = hdr.find("'descr':");
  if (dpos == std::string::npos) { *err = "npy: no descr"; return false; }
  auto q1 = hdr.find('\'', dpos + 8);
  auto q2 = hdr.find('\'', q1 + 1);
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  const char* body = buf + hoff + hlen;
  uint64_t blen = len - hoff - hlen;

  auto fill = [&](auto type_tag, uint64_t esize) -> bool {
    using T = decltype(type_tag);
    if (blen < sample_len * esize) {
      *err = "npy payload smaller than sample_len";
      return false;
    }
    const T* p = reinterpret_cast<const T*>(body);
    for (uint64_t i = 0; i < sample_len; ++i) out[i] = (float)p[i];
    return true;
  };
  if (descr == "<f4") return fill(float{}, 4);
  if (descr == "<f8") return fill(double{}, 8);
  if (descr == "|u1") return fill(uint8_t{}, 1);
  if (descr == "|i1") return fill(int8_t{}, 1);
  if (descr == "<i4") return fill(int32_t{}, 4);
  if (descr == "<i8") return fill(int64_t{}, 8);
  *err = "unsupported npy dtype " + descr;
  return false;
}

class Loader {
 public:
  Loader(mxtpu_handle reader, int batch_size, uint64_t sample_len,
         int n_threads, int prefetch, bool u8 = false)
      : reader_(reader), batch_size_(batch_size), sample_len_(sample_len),
        n_threads_(n_threads < 1 ? 1 : n_threads),
        prefetch_(prefetch < 1 ? 1 : prefetch), u8_(u8) {
    Start();
  }

  ~Loader() {
    Stop();
    mxtpu_recio_reader_close(reader_);
  }

  int Next(float* data, float* label) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_cons_.wait(lk, [this] { return !queue_.empty(); });
    Batch b = std::move(queue_.front());
    queue_.pop_front();
    cv_prod_.notify_one();
    if (b.epoch_end) {
      // keep returning 0 until reset
      queue_.push_front(EpochEnd());
      return 0;
    }
    if (!Deliver(b)) return -1;
    memcpy(data, b.data.data(), b.data.size() * sizeof(float));
    memcpy(label, b.label.data(), b.label.size() * sizeof(float));
    return b.n;
  }

  int NextU8(uint8_t* data, float* label) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_cons_.wait(lk, [this] { return !queue_.empty(); });
    Batch b = std::move(queue_.front());
    queue_.pop_front();
    cv_prod_.notify_one();
    if (b.epoch_end) {
      queue_.push_front(EpochEnd());
      return 0;
    }
    if (!Deliver(b)) return -1;
    memcpy(data, b.data_u8.data(), b.data_u8.size());
    memcpy(label, b.label.data(), b.label.size() * sizeof(float));
    return b.n;
  }

  /* the batch's failures, and its first decode error as the CALLER's
   * last error (the workers' thread-local errors are not the caller's);
   * false for a batch that cannot be delivered at all */
  bool Deliver(const Batch& b) {
    last_failed_ = b.failed;
    if (!b.err.empty()) mxtpu_err() = b.err;
    if (b.no_jpeg) mxtpu_err() = kNoJpeg;
    return !b.no_jpeg;
  }

  int LastFailed() {
    std::unique_lock<std::mutex> lk(mu_);
    return last_failed_;
  }

  void Reset() {
    Stop();
    mxtpu_recio_reader_seek0(reader_);
    {
      std::unique_lock<std::mutex> lk(mu_);
      queue_.clear();
    }
    Start();
  }

 private:
  void Start() {
    stop_ = false;
    producer_ = std::thread([this] { Produce(); });
  }

  void Stop() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_prod_.notify_all();
    if (producer_.joinable()) producer_.join();
  }

  void Produce() {
    std::vector<std::vector<char>> raw;
    bool eof = false;
    while (!eof) {
      raw.clear();
      for (int i = 0; i < batch_size_; ++i) {
        uint64_t len = 0;
        const void* rec = mxtpu_recio_read(reader_, &len);
        if (!rec) { eof = true; break; }
        raw.emplace_back((const char*)rec, (const char*)rec + len);
      }
      if (!raw.empty()) {
        Batch b;
        b.n = (int)raw.size();
        if (u8_) {
          b.data_u8.assign((size_t)batch_size_ * sample_len_, 0);
        } else {
          b.data.assign((size_t)batch_size_ * sample_len_, 0.0f);
        }
        b.label.assign(batch_size_, 0.0f);
        DecodeBatch(raw, &b);
        std::unique_lock<std::mutex> lk(mu_);
        cv_prod_.wait(lk, [this] {
          return stop_ || (int)queue_.size() < prefetch_;
        });
        if (stop_) return;
        queue_.push_back(std::move(b));
        cv_cons_.notify_one();
      }
    }
    std::unique_lock<std::mutex> lk(mu_);
    queue_.push_back(EpochEnd());
    cv_cons_.notify_one();
  }

  void DecodeBatch(const std::vector<std::vector<char>>& raw, Batch* b) {
    std::atomic<size_t> next{0};
    std::vector<std::string> errs(raw.size());
    auto work = [&] {
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= raw.size()) return;
        DecodeOne(raw[i], b, (int)i, &errs[i]);
      }
    };
    if (n_threads_ <= 1 || raw.size() <= 1) {
      work();
    } else {
      std::vector<std::thread> pool;
      int nt = std::min<int>(n_threads_, (int)raw.size());
      for (int t = 0; t < nt - 1; ++t) pool.emplace_back(work);
      work();
      for (auto& t : pool) t.join();
    }
    for (const std::string& e : errs) {
      if (e.empty()) continue;
      if (b->err.empty()) b->err = e;
      ++b->failed;
    }
    for (const std::vector<char>& rec : raw) {
      const unsigned char* p =
          reinterpret_cast<const unsigned char*>(rec.data());
      if (!kHaveJpeg && rec.size() > 24 && IsJpeg(p + 24, rec.size() - 24))
        b->no_jpeg = true;
    }
  }

  /* decode record `rec` into `slot`; on failure the sample stays
   * zero-filled and *err says why (one writer per slot, no lock) */
  void DecodeOne(const std::vector<char>& rec, Batch* b, int slot,
                 std::string* err) {
    // IRHeader 'IfQQ': u32 flag, f32 label, u64 id, u64 id2 (24 bytes)
    if (rec.size() < 24) {
      *err = "record shorter than its 24-byte IRHeader";
      return;
    }
    float lbl;
    memcpy(&lbl, rec.data() + 4, 4);
    b->label[slot] = lbl;
    const unsigned char* payload =
        reinterpret_cast<const unsigned char*>(rec.data()) + 24;
    uint64_t plen = rec.size() - 24;
    if (u8_) {
      uint8_t* out = b->data_u8.data() + (size_t)slot * sample_len_;
      if (IsJpeg(payload, plen))
        DecodeJpegU8(payload, plen, sample_len_, out, err);
      else
        *err = "u8 loader requires jpeg payloads";
    } else {
      float* out = b->data.data() + (size_t)slot * sample_len_;
      if (IsJpeg(payload, plen))
        DecodeJpeg(payload, plen, sample_len_, out, err);
      else
        ParseNpy(rec.data() + 24, plen, sample_len_, out, err);
    }
  }

  mxtpu_handle reader_;
  int batch_size_;
  uint64_t sample_len_;
  int n_threads_;
  int prefetch_;
  bool u8_ = false;
  int last_failed_ = 0;  // decode failures in the last batch Next() returned

  std::thread producer_;
  std::mutex mu_;
  std::condition_variable cv_cons_, cv_prod_;
  std::deque<Batch> queue_;
  bool stop_ = false;
};

std::mutex g_lmu;
std::deque<std::pair<mxtpu_handle, Loader*>> g_loaders;
mxtpu_handle g_lnext = 2000000001;

Loader* FindLoader(mxtpu_handle h) {
  std::unique_lock<std::mutex> lk(g_lmu);
  for (auto& kv : g_loaders)
    if (kv.first == h) return kv.second;
  return nullptr;
}

}  // namespace

namespace {

mxtpu_handle OpenLoader(const char* path, int part_index, int num_parts,
                        int batch_size, uint64_t sample_len, int n_threads,
                        int prefetch, bool u8) {
  mxtpu_handle rd = mxtpu_recio_reader_open(path, part_index, num_parts);
  if (!rd) return 0;
  Loader* l =
      new Loader(rd, batch_size, sample_len, n_threads, prefetch, u8);
  std::unique_lock<std::mutex> lk(g_lmu);
  mxtpu_handle h = g_lnext++;
  g_loaders.emplace_back(h, l);
  return h;
}

}  // namespace

mxtpu_handle mxtpu_loader_open(const char* path, int part_index,
                               int num_parts, int batch_size,
                               uint64_t sample_len, int n_threads,
                               int prefetch) {
  return OpenLoader(path, part_index, num_parts, batch_size, sample_len,
                    n_threads, prefetch, /*u8=*/false);
}

mxtpu_handle mxtpu_loader_open_u8(const char* path, int part_index,
                                  int num_parts, int batch_size,
                                  uint64_t sample_len, int n_threads,
                                  int prefetch) {
  return OpenLoader(path, part_index, num_parts, batch_size, sample_len,
                    n_threads, prefetch, /*u8=*/true);
}

int mxtpu_loader_next(mxtpu_handle h, float* data, float* label) {
  Loader* l = FindLoader(h);
  if (!l) { mxtpu_err() = "bad loader handle"; return -1; }
  return l->Next(data, label);
}

int mxtpu_loader_next_u8(mxtpu_handle h, uint8_t* data, float* label) {
  Loader* l = FindLoader(h);
  if (!l) { mxtpu_err() = "bad loader handle"; return -1; }
  return l->NextU8(data, label);
}

int mxtpu_loader_last_failed(mxtpu_handle h) {
  Loader* l = FindLoader(h);
  if (!l) { mxtpu_err() = "bad loader handle"; return -1; }
  return l->LastFailed();
}

void mxtpu_loader_reset(mxtpu_handle h) {
  Loader* l = FindLoader(h);
  if (l) l->Reset();
}

void mxtpu_loader_close(mxtpu_handle h) {
  Loader* l = nullptr;
  {
    std::unique_lock<std::mutex> lk(g_lmu);
    for (auto it = g_loaders.begin(); it != g_loaders.end(); ++it)
      if (it->first == h) {
        l = it->second;
        g_loaders.erase(it);
        break;
      }
  }
  delete l;
}

int mxtpu_has_jpeg() { return kHaveJpeg ? 1 : 0; }
