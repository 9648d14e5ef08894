// Native-layer foundations: CHECK/LOG + thread-local error ring.
//
// TPU-native counterpart of dmlc-core's logging surface
// (ref: 3rdparty/dmlc-core include/dmlc/logging.h; src/c_api error ring
// MXGetLastError).  Errors thrown as NativeError are caught at the C ABI
// boundary and surfaced to Python via MXGetLastError (same contract as the
// reference's MXNetError propagation).
#pragma once

#include <cstdio>
#include <stdexcept>
#include <string>

namespace mxt {

class NativeError : public std::runtime_error {
 public:
  explicit NativeError(const std::string& msg) : std::runtime_error(msg) {}
};

// thread-local last-error storage for the C ABI
std::string& LastError();

#define MXT_CHECK(cond)                                                    \
  if (!(cond))                                                             \
  throw ::mxt::NativeError(std::string("Check failed: " #cond " at ") +    \
                           __FILE__ + ":" + std::to_string(__LINE__))

#define MXT_CHECK_MSG(cond, msg)                                           \
  if (!(cond)) throw ::mxt::NativeError(std::string(msg))

// wrap a C ABI body: catches exceptions, stores message, returns -1/0
#define MXT_API_BEGIN() try {
#define MXT_API_END()                                                      \
  }                                                                        \
  catch (const std::exception& e) {                                        \
    ::mxt::LastError() = e.what();                                         \
    return -1;                                                             \
  }                                                                        \
  return 0;

}  // namespace mxt
