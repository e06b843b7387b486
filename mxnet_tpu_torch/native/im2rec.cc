/*
 * Native RecordIO image packer (reference `tools/im2rec.cc`): reads an
 * `index \t label \t relpath` list, decodes each JPEG, optionally resizes
 * the shorter side, re-encodes at the requested quality, and writes
 * IRHeader('IfQQ') + payload records plus the .idx offsets file.
 *
 * The reference used OpenCV imdecode/resize/imencode on a thread pool
 * with an ordered output queue (`im2rec.cc:120-210`); here libjpeg does
 * codec work and a chunked parallel-encode / sequential-write loop keeps
 * output order deterministic with bounded memory.  JPEG inputs only.
 * Built without libjpeg (no MXTPU_HAVE_JPEG), the entry point returns -1
 * and says so in the last error.
 */
#include "error.h"
#include "mxtpu.h"

#ifdef MXTPU_HAVE_JPEG
#include "jpeg_err.h"

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <thread>
#include <vector>


namespace {

using JpegErr2 = MxtpuJpegErr;
constexpr auto Im2recJpegErrExit = MxtpuJpegErrExit;

/* decode a jpeg buffer to interleaved RGB (or replicate gray to RGB) */
bool DecodeRgb(const unsigned char* buf, uint64_t len,
               std::vector<unsigned char>* out, unsigned* W, unsigned* H,
               std::string* err) {
  jpeg_decompress_struct cinfo;
  JpegErr2 jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = Im2recJpegErrExit;
  if (setjmp(jerr.jb)) {
    *err = std::string("jpeg decode failed: ") + jerr.msg;
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *W = cinfo.output_width;
  *H = cinfo.output_height;
  out->resize((size_t)*W * *H * 3);
  while (cinfo.output_scanline < *H) {
    unsigned char* rp = out->data() + (size_t)cinfo.output_scanline * *W * 3;
    jpeg_read_scanlines(&cinfo, &rp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

/* bilinear resize of interleaved RGB */
void ResizeRgb(const std::vector<unsigned char>& src, unsigned sw,
               unsigned sh, std::vector<unsigned char>* dst, unsigned dw,
               unsigned dh) {
  dst->resize((size_t)dw * dh * 3);
  for (unsigned y = 0; y < dh; ++y) {
    float fy = dh > 1 ? (float)y * (sh - 1) / (dh - 1) : 0.0f;
    unsigned y0 = (unsigned)fy;
    unsigned y1 = y0 + 1 < sh ? y0 + 1 : y0;
    float wy = fy - y0;
    for (unsigned x = 0; x < dw; ++x) {
      float fx = dw > 1 ? (float)x * (sw - 1) / (dw - 1) : 0.0f;
      unsigned x0 = (unsigned)fx;
      unsigned x1 = x0 + 1 < sw ? x0 + 1 : x0;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float p00 = src[((size_t)y0 * sw + x0) * 3 + c];
        float p01 = src[((size_t)y0 * sw + x1) * 3 + c];
        float p10 = src[((size_t)y1 * sw + x0) * 3 + c];
        float p11 = src[((size_t)y1 * sw + x1) * 3 + c];
        float v = p00 * (1 - wy) * (1 - wx) + p01 * (1 - wy) * wx
                  + p10 * wy * (1 - wx) + p11 * wy * wx;
        (*dst)[((size_t)y * dw + x) * 3 + c] =
            (unsigned char)(v + 0.5f);
      }
    }
  }
}

bool EncodeJpeg(const std::vector<unsigned char>& rgb, unsigned w,
                unsigned h, int quality, std::vector<unsigned char>* out,
                std::string* err) {
  jpeg_compress_struct cinfo;
  JpegErr2 jerr;
  // volatile: written between setjmp and longjmp (jpeg_mem_dest updates
  // *outbuffer on every internal buffer growth), read after longjmp
  unsigned char* volatile mem = nullptr;
  unsigned long mem_len = 0;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = Im2recJpegErrExit;
  if (setjmp(jerr.jb)) {
    *err = std::string("jpeg encode failed: ") + jerr.msg;
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, const_cast<unsigned char**>(&mem), &mem_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < h) {
    JSAMPROW rp = const_cast<unsigned char*>(
        rgb.data() + (size_t)cinfo.next_scanline * w * 3);
    jpeg_write_scanlines(&cinfo, &rp, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  unsigned char* buf = mem;
  out->assign(buf, buf + mem_len);
  free(buf);
  return true;
}

struct Entry {
  uint64_t index;
  float label;
  std::string path;
};

/* one record: IRHeader('IfQQ': u32 flag, f32 label, u64 id, u64 id2) +
 * jpeg payload — the layout recordio.pack_img writes */
bool BuildRecord(const Entry& e, int resize, int quality,
                 std::vector<unsigned char>* rec, std::string* err) {
  std::ifstream f(e.path, std::ios::binary);
  if (!f) {
    *err = "cannot open " + e.path;
    return false;
  }
  std::vector<unsigned char> raw((std::istreambuf_iterator<char>(f)),
                                 std::istreambuf_iterator<char>());
  std::vector<unsigned char> rgb, payload;
  unsigned w = 0, h = 0;
  if (!DecodeRgb(raw.data(), raw.size(), &rgb, &w, &h, err)) return false;
  if (resize > 0 && (w < h ? w : h) != (unsigned)resize) {
    // reference semantics: scale the SHORTER side to `resize`
    unsigned dw, dh;
    if (w < h) {
      dw = resize;
      dh = (unsigned)((uint64_t)h * resize / w);
    } else {
      dh = resize;
      dw = (unsigned)((uint64_t)w * resize / h);
    }
    std::vector<unsigned char> resized;
    ResizeRgb(rgb, w, h, &resized, dw, dh);
    rgb.swap(resized);
    w = dw;
    h = dh;
  }
  if (!EncodeJpeg(rgb, w, h, quality, &payload, err)) return false;
  rec->resize(24 + payload.size());
  uint32_t flag = 0;
  memcpy(rec->data(), &flag, 4);
  memcpy(rec->data() + 4, &e.label, 4);
  uint64_t id = e.index, id2 = 0;
  memcpy(rec->data() + 8, &id, 8);
  memcpy(rec->data() + 16, &id2, 8);
  memcpy(rec->data() + 24, payload.data(), payload.size());
  return true;
}

}  // namespace

/* Pack list entries into rec_path (+ .idx next to it).  Returns the
 * number of records written, or -1 with mxtpu_last_error set.  Entries
 * that fail to decode are SKIPPED and counted in *out_failed. */
MXTPU_API int64_t mxtpu_im2rec_pack(const char* list_path, const char* root,
                                    const char* rec_path, int resize,
                                    int quality, int nthreads,
                                    int64_t* out_failed) {
  std::ifstream lf(list_path);
  if (!lf) {
    mxtpu_err() = std::string("cannot open list ") + list_path;
    return -1;
  }
  std::vector<Entry> entries;
  std::string line;
  while (std::getline(lf, line)) {
    if (line.empty()) continue;
    std::istringstream ss(line);
    Entry e;
    std::string rel;
    if (!(ss >> e.index >> e.label)) continue;
    std::getline(ss, rel);
    size_t p = rel.find_first_not_of(" \t");
    if (p == std::string::npos) continue;
    rel = rel.substr(p);
    e.path = std::string(root) + "/" + rel;
    entries.push_back(std::move(e));
  }

  mxtpu_handle wh = mxtpu_recio_writer_open(rec_path);
  if (!wh) return -1;
  std::string idx_path(rec_path);
  // strip the extension only from the final path component: a dot in a
  // directory name must not truncate the path ("/data/v1.2/train" ->
  // "/data/v1.2/train.idx", not "/data/v1.idx")
  size_t slash = idx_path.find_last_of('/');
  size_t dot = idx_path.rfind('.');
  if (dot != std::string::npos &&
      (slash == std::string::npos || dot > slash)) {
    idx_path = idx_path.substr(0, dot);
  }
  idx_path += ".idx";
  std::ofstream idx(idx_path);

  if (nthreads < 1) nthreads = 1;
  const size_t kChunk = (size_t)nthreads * 16;
  int64_t written = 0, failed = 0;
  uint64_t offset = 0;
  for (size_t base = 0; base < entries.size(); base += kChunk) {
    size_t n = std::min(kChunk, entries.size() - base);
    std::vector<std::vector<unsigned char>> recs(n);
    std::vector<std::string> errs(n);
    std::atomic<size_t> next{0};
    auto work = [&] {
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= n) return;
        BuildRecord(entries[base + i], resize, quality, &recs[i],
                    &errs[i]);
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads - 1; ++t) pool.emplace_back(work);
    work();
    for (auto& t : pool) t.join();
    for (size_t i = 0; i < n; ++i) {  // ordered, sequential write
      if (recs[i].empty()) {
        ++failed;
        mxtpu_err() = errs[i];
        continue;
      }
      idx << entries[base + i].index << "\t" << offset << "\n";
      if (mxtpu_recio_write(wh, recs[i].data(), recs[i].size()) != 0) {
        mxtpu_recio_writer_close(wh);
        return -1;
      }
      uint64_t len = recs[i].size();
      offset += 8 + len + ((4 - (len & 3)) & 3);
      ++written;
    }
  }
  mxtpu_recio_writer_close(wh);
  if (out_failed) *out_failed = failed;
  return written;
}

#else

MXTPU_API int64_t mxtpu_im2rec_pack(const char*, const char*, const char*,
                                    int, int, int, int64_t* out_failed) {
  if (out_failed) *out_failed = 0;
  mxtpu_err() = "im2rec: this build of the native library has no libjpeg "
                "(jpeglib.h was not found when it was built)";
  return -1;
}

#endif  /* MXTPU_HAVE_JPEG */
