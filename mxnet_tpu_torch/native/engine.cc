// Dependency engine implementation (see engine.h for the design notes and
// reference citations: src/engine/threaded_engine.cc semantics).
#include "engine.h"

namespace mxt {

std::string& LastError() {
  static thread_local std::string err;
  return err;
}

Engine::Engine(int num_workers) {
  for (int i = 0; i < num_workers; ++i) {
    workers_.emplace_back([this] { WorkerLoop(); });
  }
}

Engine::~Engine() {
  WaitForAll();
  {
    std::lock_guard<std::mutex> lk(ready_m_);
    shutdown_ = true;
  }
  ready_cv_.notify_all();
  for (auto& t : workers_) t.join();
  std::lock_guard<std::mutex> lk(vars_m_);
  for (auto& kv : vars_) delete kv.second;
}

int64_t Engine::NewVariable() {
  int64_t h = next_var_.fetch_add(1);
  std::lock_guard<std::mutex> lk(vars_m_);
  vars_[h] = new Var();
  return h;
}

Var* Engine::GetVar(int64_t handle) {
  std::lock_guard<std::mutex> lk(vars_m_);
  auto it = vars_.find(handle);
  MXT_CHECK_MSG(it != vars_.end(), "unknown engine variable handle");
  return it->second;
}

static void NoopFn(void*) {}

void Engine::DeleteVariable(int64_t handle) {
  // erase from the map now (new pushes on the handle become errors), then
  // schedule a final write op that frees the Var once all pending ops on
  // it have drained (ref: FnProperty::kDeleteVar push)
  Var* v;
  {
    std::lock_guard<std::mutex> lk(vars_m_);
    auto it = vars_.find(handle);
    MXT_CHECK_MSG(it != vars_.end(), "unknown engine variable handle");
    v = it->second;
    vars_.erase(it);
  }
  PushAsyncVars(NoopFn, nullptr, {}, {v}, 0, /*delete_writes=*/true);
}

// caller holds v->m; grants head reads (concurrent) or one head write
void Engine::GrantLocked(Var* v) {
  while (!v->queue.empty()) {
    Var::Entry& head = v->queue.front();
    if (head.is_write) {
      if (v->running_reads == 0 && !v->running_write) {
        Opr* o = head.opr;
        v->queue.pop_front();
        v->running_write = true;
        DecWait(o);
        continue;  // next iteration sees running_write and stops
      }
      break;
    } else {
      if (!v->running_write) {
        Opr* o = head.opr;
        v->queue.pop_front();
        ++v->running_reads;
        DecWait(o);
        continue;
      }
      break;
    }
  }
}

// NOTE: may be called while holding a Var lock — never executes inline;
// ready work queues up and is drained by workers (threaded) or by the
// pushing thread after locks are released (naive)
void Engine::DecWait(Opr* opr) {
  if (opr->wait.fetch_sub(1) == 1) {
    {
      std::lock_guard<std::mutex> lk(ready_m_);
      (opr->priority > 0 ? ready_hi_ : ready_lo_).push_back(opr);
    }
    ready_cv_.notify_one();
  }
}

void Engine::PushAsyncVars(EngineFn fn, void* arg, std::vector<Var*> reads,
                           std::vector<Var*> writes, int priority,
                           bool delete_writes) {
  // the reference contract (threaded_engine.cc CheckDuplicate): an op's
  // read and write sets must be disjoint and duplicate-free — a var in
  // both would deadlock the op against itself, silently
  for (size_t i = 0; i < writes.size(); ++i) {
    for (size_t j = i + 1; j < writes.size(); ++j)
      MXT_CHECK_MSG(writes[i] != writes[j],
                    "engine: duplicate variable in write set");
    for (Var* r : reads)
      MXT_CHECK_MSG(writes[i] != r,
                    "engine: variable appears in BOTH read and write "
                    "sets of one op (would deadlock)");
  }
  for (size_t i = 0; i < reads.size(); ++i)
    for (size_t j = i + 1; j < reads.size(); ++j)
      MXT_CHECK_MSG(reads[i] != reads[j],
                    "engine: duplicate variable in read set");
  Opr* opr = new Opr();
  opr->fn = fn;
  opr->arg = arg;
  opr->priority = priority;
  opr->delete_writes = delete_writes;
  opr->reads = std::move(reads);
  opr->writes = std::move(writes);
  {
    std::lock_guard<std::mutex> lk(pending_m_);
    ++pending_;
  }
  // +1 guard keeps the op from firing while dependencies are appended
  opr->wait.store(static_cast<int>(opr->reads.size() + opr->writes.size()) +
                  1);
  for (Var* v : opr->reads) {
    std::lock_guard<std::mutex> lk(v->m);
    v->queue.push_back({opr, false});
    GrantLocked(v);
  }
  for (Var* v : opr->writes) {
    std::lock_guard<std::mutex> lk(v->m);
    v->queue.push_back({opr, true});
    GrantLocked(v);
  }
  DecWait(opr);  // release the guard
  if (is_naive()) DrainReady();
}

void Engine::PushAsync(EngineFn fn, void* arg, const int64_t* read_vars,
                       int n_read, const int64_t* write_vars, int n_write,
                       int priority) {
  std::vector<Var*> reads, writes;
  for (int i = 0; i < n_read; ++i) reads.push_back(GetVar(read_vars[i]));
  for (int i = 0; i < n_write; ++i) writes.push_back(GetVar(write_vars[i]));
  PushAsyncVars(fn, arg, std::move(reads), std::move(writes), priority,
                false);
}

// synchronous mode: the pushing thread runs everything that is ready
// (including work unblocked by completions) — ref: naive_engine.cc
void Engine::DrainReady() {
  for (;;) {
    Opr* opr = nullptr;
    {
      std::lock_guard<std::mutex> lk(ready_m_);
      if (!ready_hi_.empty()) {
        opr = ready_hi_.front();
        ready_hi_.pop_front();
      } else if (!ready_lo_.empty()) {
        opr = ready_lo_.front();
        ready_lo_.pop_front();
      }
    }
    if (opr == nullptr) return;
    Execute(opr);
  }
}

void Engine::Execute(Opr* opr) {
  opr->fn(opr->arg);
  CompleteDeps(opr);
  delete opr;
  {
    std::lock_guard<std::mutex> lk(pending_m_);
    --pending_;
  }
  pending_cv_.notify_all();
}

void Engine::CompleteDeps(Opr* opr) {
  for (Var* v : opr->reads) {
    std::lock_guard<std::mutex> lk(v->m);
    --v->running_reads;
    GrantLocked(v);
  }
  for (Var* v : opr->writes) {
    bool free_var = false;
    {
      std::lock_guard<std::mutex> lk(v->m);
      v->running_write = false;
      ++v->version;
      GrantLocked(v);
      // the deleting op is the var's final write: safe to free once its
      // queue drained (the handle was removed from the map beforehand)
      free_var = opr->delete_writes && v->queue.empty() &&
                 v->running_reads == 0 && !v->running_write;
    }
    if (free_var) delete v;
  }
}

void Engine::WorkerLoop() {
  for (;;) {
    Opr* opr = nullptr;
    {
      std::unique_lock<std::mutex> lk(ready_m_);
      ready_cv_.wait(lk, [this] {
        return shutdown_ || !ready_hi_.empty() || !ready_lo_.empty();
      });
      if (shutdown_ && ready_hi_.empty() && ready_lo_.empty()) return;
      if (!ready_hi_.empty()) {
        opr = ready_hi_.front();
        ready_hi_.pop_front();
      } else {
        opr = ready_lo_.front();
        ready_lo_.pop_front();
      }
    }
    Execute(opr);
  }
}

namespace {
struct WaitCtx {
  std::mutex m;
  std::condition_variable cv;
  bool done = false;
};
void SignalFn(void* arg) {
  WaitCtx* w = static_cast<WaitCtx*>(arg);
  std::lock_guard<std::mutex> lk(w->m);
  w->done = true;
  w->cv.notify_all();
}
}  // namespace

void Engine::WaitForVar(int64_t handle) {
  // a read op that signals — serializes after all pending writes
  WaitCtx w;
  PushAsync(SignalFn, &w, &handle, 1, nullptr, 0, 1);
  std::unique_lock<std::mutex> lk(w.m);
  w.cv.wait(lk, [&] { return w.done; });
}

void Engine::WaitForAll() {
  std::unique_lock<std::mutex> lk(pending_m_);
  pending_cv_.wait(lk, [this] { return pending_ == 0; });
}

int Engine::NumPending() {
  std::lock_guard<std::mutex> lk(pending_m_);
  return pending_;
}

uint64_t Engine::VarVersion(int64_t handle) {
  Var* v = GetVar(handle);
  std::lock_guard<std::mutex> lk(v->m);
  return v->version;
}

}  // namespace mxt
