// Dependency engine: versioned variables + async op scheduling.
//
// TPU-native counterpart of the reference's engine
// (ref: src/engine/threaded_engine.cc ThreadedVar/ThreadedOpr/OprBlock,
// include/mxnet/engine.h Engine::PushAsync/WaitForVar/WaitForAll;
// naive_engine.cc for the synchronous debug mode).
//
// Role in this framework (SURVEY.md §7): device compute is scheduled by
// PjRt's async streams, so this engine schedules HOST-side work — data
// pipeline stages, decode workers, checkpoint IO, and any user task
// pushed from Python — with the same read/write-variable hazard
// semantics the reference guarantees (WAR/RAW/WAW serialization per
// variable, concurrent reads, FIFO write order).
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include "base.h"

namespace mxt {

typedef void (*EngineFn)(void* arg);

class Engine;

struct Opr {
  EngineFn fn;
  void* arg;
  std::vector<struct Var*> reads;
  std::vector<struct Var*> writes;
  std::atomic<int> wait{0};
  int priority{0};
  bool delete_writes{false};  // final op of DeleteVariable: frees the Var
};

// Versioned variable with the reference's ThreadedVar grant rules:
// reads run concurrently; writes are exclusive and FIFO; reads queued
// behind a write wait for it (ref: threaded_engine.h ThreadedVar).
struct Var {
  std::mutex m;
  struct Entry {
    Opr* opr;
    bool is_write;
  };
  std::deque<Entry> queue;  // not-yet-granted ops, FIFO
  int running_reads = 0;
  bool running_write = false;
  uint64_t version = 0;  // bumped per completed write
};

class Engine {
 public:
  explicit Engine(int num_workers);
  ~Engine();

  int64_t NewVariable();
  void DeleteVariable(int64_t handle);
  void PushAsync(EngineFn fn, void* arg, const int64_t* read_vars,
                 int n_read, const int64_t* write_vars, int n_write,
                 int priority);
  void WaitForVar(int64_t handle);
  void WaitForAll();
  int NumPending();
  uint64_t VarVersion(int64_t handle);
  bool is_naive() const { return workers_.empty(); }

 private:
  Var* GetVar(int64_t handle);
  void GrantLocked(Var* v);           // caller holds v->m
  void DecWait(Opr* opr);
  void PushAsyncVars(EngineFn fn, void* arg, std::vector<Var*> reads,
                     std::vector<Var*> writes, int priority,
                     bool delete_writes);
  void DrainReady();
  void Execute(Opr* opr);
  void CompleteDeps(Opr* opr);
  void WorkerLoop();

  std::mutex vars_m_;
  std::unordered_map<int64_t, Var*> vars_;
  std::atomic<int64_t> next_var_{1};

  std::mutex ready_m_;
  std::condition_variable ready_cv_;
  std::deque<Opr*> ready_hi_, ready_lo_;
  bool shutdown_ = false;

  std::mutex pending_m_;
  std::condition_variable pending_cv_;
  int pending_ = 0;

  std::vector<std::thread> workers_;
};

}  // namespace mxt
