// RecordIO reader/writer + threaded prefetching reader.
//
// TPU-native counterpart of dmlc-core's recordio + ThreadedIter
// (ref: 3rdparty/dmlc-core include/dmlc/recordio.h RecordIOWriter/Reader,
// include/dmlc/threadediter.h; consumed by src/io/iter_image_recordio_2.cc).
// Wire format matches mxnet_tpu/recordio.py exactly:
//   u32 magic 0x3ed7230a | u32 lrecord = (cflag<<29)|len | data | pad4
//   cflag: 0 whole record, 1 first chunk, 2 middle, 3 last.
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "base.h"

namespace mxt {

static const uint32_t kMagic = 0x3ed7230a;
static const int kCFlagBits = 29;
static const uint32_t kLenMask = (1u << kCFlagBits) - 1;

static size_t Pad4(size_t n) { return (4 - n % 4) % 4; }

class RecordWriter {
 public:
  explicit RecordWriter(const std::string& path, size_t max_chunk = kLenMask)
      : max_chunk_(max_chunk == 0 || max_chunk > kLenMask ? kLenMask
                                                          : max_chunk) {
    f_ = std::fopen(path.c_str(), "wb");
    MXT_CHECK_MSG(f_ != nullptr, "cannot open for write: " + path);
  }
  ~RecordWriter() {
    if (f_) std::fclose(f_);
  }
  // returns byte offset of the record start (for .idx sidecars).
  // Records longer than the 29-bit length field are split into
  // cflag-chained chunks (1 first / 2 middle / 3 last) that both readers
  // rejoin transparently — no silent truncation at 2^29 bytes.
  int64_t Write(const char* buf, size_t len) {
    int64_t pos = std::ftell(f_);
    if (len <= max_chunk_) {
      WriteChunk(buf, len, 0);
    } else {
      size_t off = 0;
      while (off < len) {
        size_t n = len - off < max_chunk_ ? len - off : max_chunk_;
        uint32_t cflag = off == 0 ? 1u : (off + n == len ? 3u : 2u);
        WriteChunk(buf + off, n, cflag);
        off += n;
      }
    }
    return pos;
  }

 private:
  void WriteChunk(const char* buf, size_t len, uint32_t cflag) {
    uint32_t header[2] = {
        kMagic, (cflag << kCFlagBits) | static_cast<uint32_t>(len)};
    std::fwrite(header, sizeof(uint32_t), 2, f_);
    std::fwrite(buf, 1, len, f_);
    static const char zeros[4] = {0, 0, 0, 0};
    std::fwrite(zeros, 1, Pad4(len), f_);
  }

  std::FILE* f_ = nullptr;
  size_t max_chunk_;
};

class RecordReader {
 public:
  explicit RecordReader(const std::string& path) : path_(path) {
    f_ = std::fopen(path.c_str(), "rb");
    MXT_CHECK_MSG(f_ != nullptr, "cannot open for read: " + path);
  }
  ~RecordReader() {
    if (f_) std::fclose(f_);
  }
  void Reset() { std::fseek(f_, 0, SEEK_SET); }
  void Seek(int64_t pos) { std::fseek(f_, pos, SEEK_SET); }

  // false at EOF; out receives the full (chunk-joined) record
  bool Next(std::string* out) {
    out->clear();
    for (;;) {
      uint32_t header[2];
      size_t got = std::fread(header, sizeof(uint32_t), 2, f_);
      if (got < 2) {
        // EOF inside a chunk chain means the file is corrupt — fail loud,
        // never hand back a silently-shortened record
        MXT_CHECK_MSG(out->empty(),
                      "truncated chunked record at EOF in " + path_);
        return false;
      }
      MXT_CHECK_MSG(header[0] == kMagic,
                    "invalid record magic in " + path_);
      uint32_t cflag = header[1] >> kCFlagBits;
      size_t len = header[1] & kLenMask;
      size_t cur = out->size();
      out->resize(cur + len);
      MXT_CHECK_MSG(std::fread(&(*out)[cur], 1, len, f_) == len,
                    "truncated record in " + path_);
      std::fseek(f_, static_cast<long>(Pad4(len)), SEEK_CUR);
      if (cflag == 0 || cflag == 3) return true;
    }
  }

 private:
  std::string path_;
  std::FILE* f_ = nullptr;
};

// Background-thread prefetching reader: bounded queue of whole records
// (the dmlc::ThreadedIter role in CS6 of SURVEY.md).
class PrefetchReader {
 public:
  PrefetchReader(const std::string& path, int capacity)
      : reader_(path), capacity_(capacity < 1 ? 1 : capacity) {
    Start();
  }
  ~PrefetchReader() { Stop(); }

  // false at end of epoch; after that, Reset() starts the next epoch
  bool Next(std::string* out) {
    std::unique_lock<std::mutex> lk(m_);
    cv_nonempty_.wait(lk, [this] { return !q_.empty() || eof_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    cv_space_.notify_one();
    return true;
  }

  void Reset() {
    Stop();
    reader_.Reset();
    Start();
  }

 private:
  void Start() {
    stop_ = false;
    eof_ = false;
    q_.clear();
    worker_ = std::thread([this] {
      std::string rec;
      for (;;) {
        if (!reader_.Next(&rec)) break;
        std::unique_lock<std::mutex> lk(m_);
        cv_space_.wait(lk, [this] {
          return stop_ || static_cast<int>(q_.size()) < capacity_;
        });
        if (stop_) return;
        q_.push_back(std::move(rec));
        cv_nonempty_.notify_one();
      }
      std::lock_guard<std::mutex> lk(m_);
      eof_ = true;
      cv_nonempty_.notify_all();
    });
  }

  void Stop() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
      cv_space_.notify_all();
    }
    if (worker_.joinable()) worker_.join();
  }

  RecordReader reader_;
  int capacity_;
  std::mutex m_;
  std::condition_variable cv_nonempty_, cv_space_;
  std::deque<std::string> q_;
  std::thread worker_;
  bool stop_ = false;
  bool eof_ = false;
};

}  // namespace mxt

// ---------------------------------------------------------------------------
// C ABI (consumed via ctypes — the reference's only binding mechanism,
// ref: include/mxnet/c_api.h + python/mxnet/base.py check_call)
// ---------------------------------------------------------------------------

extern "C" {

const char* MXGetLastError() { return mxt::LastError().c_str(); }

int MXRecordIOWriterCreate(const char* path, void** out) {
  MXT_API_BEGIN();
  *out = new mxt::RecordWriter(path);
  MXT_API_END();
}

// max_chunk below the 29-bit default exercises the chunked path in tests
int MXRecordIOWriterCreateEx(const char* path, size_t max_chunk, void** out) {
  MXT_API_BEGIN();
  *out = new mxt::RecordWriter(path, max_chunk);
  MXT_API_END();
}

int MXRecordIOWriterWrite(void* h, const char* buf, size_t len,
                          int64_t* out_pos) {
  MXT_API_BEGIN();
  *out_pos = static_cast<mxt::RecordWriter*>(h)->Write(buf, len);
  MXT_API_END();
}

int MXRecordIOWriterFree(void* h) {
  MXT_API_BEGIN();
  delete static_cast<mxt::RecordWriter*>(h);
  MXT_API_END();
}

int MXRecordIOReaderCreate(const char* path, void** out) {
  MXT_API_BEGIN();
  *out = new mxt::RecordReader(path);
  MXT_API_END();
}

// thread-local buffer keeps the returned pointer valid until the next call
static thread_local std::string g_record_buf;

int MXRecordIOReaderNext(void* h, const char** out_buf, size_t* out_len,
                         int* out_eof) {
  MXT_API_BEGIN();
  if (static_cast<mxt::RecordReader*>(h)->Next(&g_record_buf)) {
    *out_buf = g_record_buf.data();
    *out_len = g_record_buf.size();
    *out_eof = 0;
  } else {
    *out_buf = nullptr;
    *out_len = 0;
    *out_eof = 1;
  }
  MXT_API_END();
}

int MXRecordIOReaderSeek(void* h, int64_t pos) {
  MXT_API_BEGIN();
  static_cast<mxt::RecordReader*>(h)->Seek(pos);
  MXT_API_END();
}

int MXRecordIOReaderReset(void* h) {
  MXT_API_BEGIN();
  static_cast<mxt::RecordReader*>(h)->Reset();
  MXT_API_END();
}

int MXRecordIOReaderFree(void* h) {
  MXT_API_BEGIN();
  delete static_cast<mxt::RecordReader*>(h);
  MXT_API_END();
}

int MXPrefetchReaderCreate(const char* path, int capacity, void** out) {
  MXT_API_BEGIN();
  *out = new mxt::PrefetchReader(path, capacity);
  MXT_API_END();
}

int MXPrefetchReaderNext(void* h, const char** out_buf, size_t* out_len,
                         int* out_eof) {
  MXT_API_BEGIN();
  if (static_cast<mxt::PrefetchReader*>(h)->Next(&g_record_buf)) {
    *out_buf = g_record_buf.data();
    *out_len = g_record_buf.size();
    *out_eof = 0;
  } else {
    *out_buf = nullptr;
    *out_len = 0;
    *out_eof = 1;
  }
  MXT_API_END();
}

int MXPrefetchReaderReset(void* h) {
  MXT_API_BEGIN();
  static_cast<mxt::PrefetchReader*>(h)->Reset();
  MXT_API_END();
}

int MXPrefetchReaderFree(void* h) {
  MXT_API_BEGIN();
  delete static_cast<mxt::PrefetchReader*>(h);
  MXT_API_END();
}

}  // extern "C"
