/*
 * RecordIO reader/writer — dmlc recordio on-disk format
 * (format authority: `mxnet_tpu_torch/recordio.py`; reference implementation
 * lived in dmlc-core, used by `src/io/iter_image_recordio.cc`).
 *
 * Record: u32 magic (0xced7230a) | u32 lrec | payload | pad to 4 bytes,
 * lrec = (cflag << 29) | length.  We write single-part records (cflag 0).
 *
 * The reader supports part_index/num_parts byte-range sharding with resync
 * to the next magic, the mechanism behind the reference's distributed data
 * loading (`iter_image_recordio.cc:105-126` via dmlc::InputSplit).
 */
#include "mxtpu.h"
#include "error.h"

#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;


struct Writer {
  FILE* f = nullptr;
};

struct Reader {
  FILE* f = nullptr;
  uint64_t begin = 0;   // shard start (after resync)
  uint64_t end = 0;     // shard end boundary: records *starting* before
                        // this offset belong to the shard
  std::vector<char> buf;
};

std::mutex g_mu;
std::map<mxtpu_handle, Writer*> g_writers;
std::map<mxtpu_handle, Reader*> g_readers;
mxtpu_handle g_next = 1000000001;  // disjoint from engine handles

template <class T>
mxtpu_handle Register(std::map<mxtpu_handle, T*>& m, T* p) {
  std::unique_lock<std::mutex> lk(g_mu);
  mxtpu_handle h = g_next++;
  m[h] = p;
  return h;
}

template <class T>
T* Lookup(std::map<mxtpu_handle, T*>& m, mxtpu_handle h) {
  std::unique_lock<std::mutex> lk(g_mu);
  auto it = m.find(h);
  return it == m.end() ? nullptr : it->second;
}

/* scan forward from `pos` to the first record magic at 4-byte alignment */
uint64_t Resync(FILE* f, uint64_t pos, uint64_t fsize) {
  pos = (pos + 3) & ~uint64_t(3);
  while (pos + 8 <= fsize) {
    if (fseek(f, (long)pos, SEEK_SET) != 0) return fsize;
    uint32_t magic = 0, lrec = 0;
    if (fread(&magic, 4, 1, f) != 1 || fread(&lrec, 4, 1, f) != 1)
      return fsize;
    if (magic == kMagic) {
      // sanity: record must fit in the file
      uint64_t len = lrec & ((1u << 29) - 1);
      if (pos + 8 + len <= fsize) return pos;
    }
    pos += 4;
  }
  return fsize;
}

}  // namespace

mxtpu_handle mxtpu_recio_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) { mxtpu_err() = std::string("cannot open for write: ") + path; return 0; }
  Writer* w = new Writer{f};
  return Register(g_writers, w);
}

int mxtpu_recio_write(mxtpu_handle h, const void* data, uint64_t len) {
  Writer* w = Lookup(g_writers, h);
  if (!w) { mxtpu_err() = "bad writer handle"; return -1; }
  if (len >= (1u << 29)) { mxtpu_err() = "record too large"; return -1; }
  uint32_t magic = kMagic, lrec = (uint32_t)len;
  if (fwrite(&magic, 4, 1, w->f) != 1) return -1;
  if (fwrite(&lrec, 4, 1, w->f) != 1) return -1;
  if (len && fwrite(data, 1, len, w->f) != len) return -1;
  static const char zeros[4] = {0, 0, 0, 0};
  uint64_t pad = (4 - (len & 3)) & 3;
  if (pad && fwrite(zeros, 1, pad, w->f) != pad) return -1;
  return 0;
}

void mxtpu_recio_writer_close(mxtpu_handle h) {
  Writer* w = Lookup(g_writers, h);
  if (!w) return;
  {
    std::unique_lock<std::mutex> lk(g_mu);
    g_writers.erase(h);
  }
  fclose(w->f);
  delete w;
}

mxtpu_handle mxtpu_recio_reader_open(const char* path, int part_index,
                                     int num_parts) {
  if (num_parts <= 0) num_parts = 1;
  if (part_index < 0 || part_index >= num_parts) {
    mxtpu_err() = "part_index out of range";
    return 0;
  }
  FILE* f = fopen(path, "rb");
  if (!f) { mxtpu_err() = std::string("cannot open: ") + path; return 0; }
  fseek(f, 0, SEEK_END);
  uint64_t fsize = (uint64_t)ftell(f);
  uint64_t chunk = fsize / num_parts;
  uint64_t raw_begin = chunk * part_index;
  uint64_t raw_end = (part_index == num_parts - 1) ? fsize
                                                   : chunk * (part_index + 1);
  Reader* r = new Reader();
  r->f = f;
  r->begin = (part_index == 0) ? 0 : Resync(f, raw_begin, fsize);
  r->end = raw_end;
  fseek(f, (long)r->begin, SEEK_SET);
  return Register(g_readers, r);
}

const void* mxtpu_recio_read(mxtpu_handle h, uint64_t* len) {
  *len = 0;
  Reader* r = Lookup(g_readers, h);
  if (!r) { mxtpu_err() = "bad reader handle"; return nullptr; }
  uint64_t pos = (uint64_t)ftell(r->f);
  if (pos >= r->end) return nullptr;  // shard exhausted
  uint32_t magic = 0, lrec = 0;
  if (fread(&magic, 4, 1, r->f) != 1) return nullptr;
  if (magic != kMagic) { mxtpu_err() = "bad record magic"; return nullptr; }
  if (fread(&lrec, 4, 1, r->f) != 1) return nullptr;
  uint64_t n = lrec & ((1u << 29) - 1);
  r->buf.resize(n);
  if (n && fread(r->buf.data(), 1, n, r->f) != n) {
    mxtpu_err() = "truncated record";
    return nullptr;
  }
  uint64_t pad = (4 - (n & 3)) & 3;
  if (pad) fseek(r->f, (long)pad, SEEK_CUR);
  *len = n;
  return r->buf.data();
}

void mxtpu_recio_reader_seek0(mxtpu_handle h) {
  Reader* r = Lookup(g_readers, h);
  if (r) fseek(r->f, (long)r->begin, SEEK_SET);
}

void mxtpu_recio_reader_close(mxtpu_handle h) {
  Reader* r = Lookup(g_readers, h);
  if (!r) return;
  {
    std::unique_lock<std::mutex> lk(g_mu);
    g_readers.erase(h);
  }
  fclose(r->f);
  delete r;
}
