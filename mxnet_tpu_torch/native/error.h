/* Shared thread-local last-error string (reference `src/c_api/c_api_error.h`
 * pattern: errno-style TLS message behind a C ABI getter). */
#ifndef MXTPU_ERROR_H_
#define MXTPU_ERROR_H_

#include <string>

inline std::string& mxtpu_err() {
  static thread_local std::string e;
  return e;
}

#endif  /* MXTPU_ERROR_H_ */
