// Engine C ABI (ref: include/mxnet/c_api.h MXEngine* surface; consumed by
// Python via ctypes exactly like the reference's base.py check_call).
#include <cstdint>

#include "engine.h"

extern "C" {

int MXEngineCreate(int num_workers, void** out) {
  MXT_API_BEGIN();
  *out = new mxt::Engine(num_workers);
  MXT_API_END();
}

int MXEngineFree(void* h) {
  MXT_API_BEGIN();
  delete static_cast<mxt::Engine*>(h);
  MXT_API_END();
}

int MXEngineNewVariable(void* h, int64_t* out) {
  MXT_API_BEGIN();
  *out = static_cast<mxt::Engine*>(h)->NewVariable();
  MXT_API_END();
}

int MXEngineDeleteVariable(void* h, int64_t var) {
  MXT_API_BEGIN();
  static_cast<mxt::Engine*>(h)->DeleteVariable(var);
  MXT_API_END();
}

int MXEnginePushAsync(void* h, mxt::EngineFn fn, void* arg,
                      const int64_t* read_vars, int n_read,
                      const int64_t* write_vars, int n_write, int priority) {
  MXT_API_BEGIN();
  static_cast<mxt::Engine*>(h)->PushAsync(fn, arg, read_vars, n_read,
                                          write_vars, n_write, priority);
  MXT_API_END();
}

int MXEngineWaitForVar(void* h, int64_t var) {
  MXT_API_BEGIN();
  static_cast<mxt::Engine*>(h)->WaitForVar(var);
  MXT_API_END();
}

int MXEngineWaitForAll(void* h) {
  MXT_API_BEGIN();
  static_cast<mxt::Engine*>(h)->WaitForAll();
  MXT_API_END();
}

int MXEngineNumPending(void* h, int* out) {
  MXT_API_BEGIN();
  *out = static_cast<mxt::Engine*>(h)->NumPending();
  MXT_API_END();
}

int MXEngineVarVersion(void* h, int64_t var, uint64_t* out) {
  MXT_API_BEGIN();
  *out = static_cast<mxt::Engine*>(h)->VarVersion(var);
  MXT_API_END();
}

}  // extern "C"
