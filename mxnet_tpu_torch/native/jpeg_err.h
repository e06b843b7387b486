/* Shared libjpeg setjmp error manager (used by loader.cc and im2rec.cc).
 *
 * libjpeg's default error_exit calls exit(); this redirects to longjmp so
 * a bad payload fails one record, not the process.  CAUTION for users:
 * declare every non-trivial automatic (std::vector etc.) BEFORE setjmp —
 * longjmp past a live non-trivial object is UB — and make any local that
 * is written between setjmp and longjmp `volatile` if read afterwards. */
#ifndef MXTPU_JPEG_ERR_H_
#define MXTPU_JPEG_ERR_H_

#include <cstdio>  // jpeglib.h needs FILE declared first

#include <jpeglib.h>
#include <setjmp.h>

struct MxtpuJpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
  char msg[JMSG_LENGTH_MAX];
};

inline void MxtpuJpegErrExit(j_common_ptr cinfo) {
  MxtpuJpegErr* e = reinterpret_cast<MxtpuJpegErr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, e->msg);
  longjmp(e->jb, 1);
}

#endif  /* MXTPU_JPEG_ERR_H_ */
