// Native image data pipeline: .rec shards -> decoded/augmented batches.
//
// TPU-native counterpart of the reference's threaded image pipeline
// (ref: src/io/iter_image_recordio_2.cc ImageRecordIOParser2 +
// image_aug_default.cc DefaultImageAugmenter + dmlc ThreadedIter).
// Differences by design, not omission:
//   * decode/augment tasks are scheduled on the N1 dependency Engine
//     (engine.{h,cc}) instead of a bespoke OMP loop — one scheduler for
//     all host-side work;
//   * the default output is uint8 NHWC batches: normalization runs on
//     the TPU fused into the first conv (bf16), and uint8 host->device
//     transfer is 4x cheaper than float32 over the host link.  A
//     `normalize=1` mode emits float32 NCHW (mean/std applied) for
//     drop-in parity with the Python ImageRecordIter contract.
//
// Built as a SEPARATE shared object (libmxnet_tpu_image.so) because it
// links OpenCV (the reference links OpenCV for the same role); the core
// native library keeps zero image dependencies.
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

#include "base.h"
#include "engine.h"

namespace mxt {

// ---- wire format helpers (matches recordio.cc / recordio.py) -------------

static const uint32_t kMagic = 0x3ed7230a;
static const int kCFlagBits = 29;
static const uint32_t kLenMask = (1u << kCFlagBits) - 1;

struct IRHeader {  // ref: python recordio.py IRHeader "<IfQQ"
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
};

// ---- config --------------------------------------------------------------

struct PipelineCfg {
  int batch = 1;
  int channels = 3;
  int height = 224;
  int width = 224;
  int label_width = 1;
  int resize_short = -1;   // resize shorter edge before crop; -1 = off
  bool rand_crop = false;  // random vs center crop
  bool rand_mirror = false;
  bool shuffle = false;    // random order via the .idx sidecar
  bool normalize = false;  // emit float32 NCHW (mean/std) instead of u8 NHWC
  float mean[3] = {0, 0, 0};
  float std[3] = {1, 1, 1};
  int threads = 4;
  int prefetch = 4;  // max in-flight batches
  uint64_t seed = 0;
};

// "key=value;key=value" — extensible without ABI churn (the ctypes
// counterpart of dmlc::Parameter kwargs init)
static PipelineCfg ParseCfg(const std::string& s) {
  PipelineCfg c;
  size_t pos = 0;
  while (pos < s.size()) {
    size_t eq = s.find('=', pos);
    if (eq == std::string::npos) break;
    size_t end = s.find(';', eq);
    if (end == std::string::npos) end = s.size();
    std::string k = s.substr(pos, eq - pos);
    std::string v = s.substr(eq + 1, end - eq - 1);
    double d = atof(v.c_str());
    if (k == "batch") c.batch = (int)d;
    else if (k == "channels") c.channels = (int)d;
    else if (k == "height") c.height = (int)d;
    else if (k == "width") c.width = (int)d;
    else if (k == "label_width") c.label_width = (int)d;
    else if (k == "resize_short") c.resize_short = (int)d;
    else if (k == "rand_crop") c.rand_crop = d != 0;
    else if (k == "rand_mirror") c.rand_mirror = d != 0;
    else if (k == "shuffle") c.shuffle = d != 0;
    else if (k == "normalize") c.normalize = d != 0;
    else if (k == "mean_r") c.mean[0] = (float)d;
    else if (k == "mean_g") c.mean[1] = (float)d;
    else if (k == "mean_b") c.mean[2] = (float)d;
    else if (k == "std_r") c.std[0] = (float)d;
    else if (k == "std_g") c.std[1] = (float)d;
    else if (k == "std_b") c.std[2] = (float)d;
    else if (k == "threads") c.threads = (int)d;
    else if (k == "prefetch") c.prefetch = (int)d;
    else if (k == "seed") c.seed = (uint64_t)d;
    pos = end + 1;
  }
  return c;
}

// ---- batches -------------------------------------------------------------

struct Batch {
  uint64_t seq;
  std::vector<uint8_t> data;   // u8 NHWC or f32 NCHW (bytes)
  std::vector<float> label;    // batch * label_width
  std::atomic<int> remaining{0};
  int pad = 0;
};

struct DecodeTask {
  class ImagePipeline* pipe;
  Batch* batch;
  int slot;
  std::string raw;  // full record (IRHeader + encoded image)
  uint64_t rng_seed;
};

// ---- the pipeline --------------------------------------------------------

class ImagePipeline {
 public:
  ImagePipeline(const std::string& rec_path, const std::string& idx_path,
                const std::string& cfg_str)
      : cfg_(ParseCfg(cfg_str)),
        rec_path_(rec_path),
        engine_(std::max(1, cfg_.threads)) {
    f_ = std::fopen(rec_path.c_str(), "rb");
    MXT_CHECK_MSG(f_ != nullptr, "cannot open " + rec_path);
    if (!idx_path.empty()) LoadIdx(idx_path);
    MXT_CHECK_MSG(!cfg_.shuffle || !offsets_.empty(),
                  "shuffle=1 requires a .idx sidecar");
    StartEpoch();
  }

  ~ImagePipeline() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
      cv_space_.notify_all();
      cv_out_.notify_all();
    }
    if (reader_.joinable()) reader_.join();
    engine_.WaitForAll();
    for (auto& kv : done_) delete kv.second;
    if (f_) std::fclose(f_);
  }

  // next completed batch in order; nullptr at epoch end
  Batch* Next() {
    std::unique_lock<std::mutex> lk(m_);
    cv_out_.wait(lk, [this] {
      return stop_ || !error_.empty() ||
             (!done_.empty() && done_.begin()->first == next_out_) ||
             (reader_eof_ && next_out_ == next_seq_);
    });
    if (stop_) return nullptr;
    if (!error_.empty()) throw NativeError(error_);
    auto it = done_.find(next_out_);
    if (it == done_.end()) return nullptr;  // epoch exhausted
    Batch* b = it->second;
    done_.erase(it);
    ++next_out_;
    in_flight_--;
    cv_space_.notify_one();
    return b;
  }

  void Reset() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
      cv_space_.notify_all();
    }
    if (reader_.joinable()) reader_.join();
    engine_.WaitForAll();
    std::lock_guard<std::mutex> lk(m_);
    for (auto& kv : done_) delete kv.second;
    done_.clear();
    stop_ = false;
    reader_eof_ = false;
    error_.clear();  // a failed epoch must not poison the next one
    in_flight_ = 0;
    next_out_ = next_seq_ = 0;
    std::fseek(f_, 0, SEEK_SET);
    epoch_++;
    StartEpochLocked();
  }

  const PipelineCfg& cfg() const { return cfg_; }

  void FinishSlot(Batch* b) {
    if (b->remaining.fetch_sub(1) == 1) {
      std::lock_guard<std::mutex> lk(m_);
      done_[b->seq] = b;
      cv_out_.notify_all();
    }
  }

  // decode worker failed: record the first error (surfaced at Next) and
  // complete the slot so the batch chain never wedges
  void TaskError(DecodeTask* t, const char* msg) {
    Batch* b = t->batch;
    {
      std::lock_guard<std::mutex> lk(m_);
      if (error_.empty()) error_ = msg;
      cv_out_.notify_all();
    }
    delete t;
    FinishSlot(b);
  }

  // decode + augment one record into its batch slot (runs on the engine)
  void RunTask(DecodeTask* t) {
    const PipelineCfg& c = cfg_;
    const char* p = t->raw.data();
    MXT_CHECK_MSG(t->raw.size() >= sizeof(IRHeader),
                  "record smaller than IRHeader in " + rec_path_);
    IRHeader h;
    std::memcpy(&h, p, sizeof(h));
    size_t off = sizeof(h);
    int lw = c.label_width;
    if (h.flag > 0) {
      // bounds-check the claimed label count before touching the payload
      MXT_CHECK_MSG(off + (size_t)h.flag * sizeof(float) <= t->raw.size(),
                    "corrupt record: label count exceeds record size in " +
                        rec_path_);
      const float* lab = reinterpret_cast<const float*>(p + off);
      for (int i = 0; i < lw; ++i)
        t->batch->label[t->slot * lw + i] =
            (int)h.flag > i ? lab[i] : 0.0f;
      off += h.flag * sizeof(float);
    } else {
      t->batch->label[t->slot * lw] = h.label;
    }

    cv::Mat buf(1, (int)(t->raw.size() - off), CV_8U,
                const_cast<char*>(p + off));
    cv::Mat img = cv::imdecode(
        buf, c.channels == 1 ? cv::IMREAD_GRAYSCALE : cv::IMREAD_COLOR);
    MXT_CHECK_MSG(!img.empty(), "image decode failed in " + rec_path_);
    if (c.channels == 3) cv::cvtColor(img, img, cv::COLOR_BGR2RGB);

    std::mt19937_64 rng(t->rng_seed);
    // resize shorter edge (ref: image_aug_default.cc resize logic)
    int rs = c.resize_short;
    if (rs <= 0 && (img.rows < c.height || img.cols < c.width))
      rs = std::max(c.height, c.width);
    if (rs > 0) {
      double scale = (double)rs / std::min(img.rows, img.cols);
      // clamp BOTH dims to at least the crop size (the min-dimension clamp
      // must apply even when scale == 1.0, e.g. resize equal to the short
      // edge on an image narrower than the crop)
      int nw = std::max(c.width, (int)lround(img.cols * scale));
      int nh = std::max(c.height, (int)lround(img.rows * scale));
      if (nw != img.cols || nh != img.rows)
        cv::resize(img, img, cv::Size(nw, nh), 0, 0,
                   scale < 1.0 ? cv::INTER_AREA : cv::INTER_LINEAR);
    }
    // crop to (height, width): random (train) or center
    int dy = img.rows - c.height, dx = img.cols - c.width;
    int y0, x0;
    if (c.rand_crop) {
      y0 = dy > 0 ? (int)(rng() % (uint64_t)(dy + 1)) : 0;
      x0 = dx > 0 ? (int)(rng() % (uint64_t)(dx + 1)) : 0;
    } else {
      y0 = std::max(0, dy / 2);
      x0 = std::max(0, dx / 2);
    }
    cv::Mat crop = img(cv::Rect(x0, y0, c.width, c.height));
    if (c.rand_mirror && (rng() & 1)) cv::flip(crop, crop, 1);

    const int hw = c.height * c.width, ch = c.channels;
    if (c.normalize) {
      // float32 NCHW, (x - mean) / std — python-iterator parity mode
      float* out = reinterpret_cast<float*>(t->batch->data.data()) +
                   (size_t)t->slot * ch * hw;
      for (int y = 0; y < c.height; ++y) {
        const uint8_t* row = crop.ptr<uint8_t>(y);
        for (int x = 0; x < c.width; ++x)
          for (int k = 0; k < ch; ++k)
            out[k * hw + y * c.width + x] =
                ((float)row[x * ch + k] - cfg_.mean[k]) / cfg_.std[k];
      }
    } else {
      // u8 NHWC straight copy — device-side normalization mode
      uint8_t* out = t->batch->data.data() + (size_t)t->slot * hw * ch;
      for (int y = 0; y < c.height; ++y)
        std::memcpy(out + (size_t)y * c.width * ch, crop.ptr<uint8_t>(y),
                    (size_t)c.width * ch);
    }
    Batch* b = t->batch;
    delete t;
    FinishSlot(b);
  }

 private:
  void LoadIdx(const std::string& idx_path) {
    std::FILE* fi = std::fopen(idx_path.c_str(), "rb");
    MXT_CHECK_MSG(fi != nullptr, "cannot open " + idx_path);
    char line[256];
    while (std::fgets(line, sizeof(line), fi)) {
      const char* tab = std::strchr(line, '\t');
      if (tab) offsets_.push_back((int64_t)atoll(tab + 1));
    }
    std::fclose(fi);
  }

  void StartEpoch() {
    std::lock_guard<std::mutex> lk(m_);
    StartEpochLocked();
  }

  void StartEpochLocked() {
    order_.clear();
    if (cfg_.shuffle) {
      order_.resize(offsets_.size());
      for (size_t i = 0; i < order_.size(); ++i) order_[i] = i;
      std::mt19937_64 rng(cfg_.seed + 0x9e3779b97f4a7c15ull * (epoch_ + 1));
      std::shuffle(order_.begin(), order_.end(), rng);
    }
    reader_ = std::thread([this] {
      // reader errors (corrupt shard: bad magic, truncation) surface as
      // MXNetError from Next(), never std::terminate
      try {
        ReaderLoop();
      } catch (const std::exception& e) {
        std::lock_guard<std::mutex> lk(m_);
        if (error_.empty()) error_ = e.what();
        reader_eof_ = true;
        cv_out_.notify_all();
      }
    });
  }

  bool ReadRecordAt(size_t pos_idx, std::string* out) {
    if (!order_.empty())
      std::fseek(f_, (long)offsets_[order_[pos_idx]], SEEK_SET);
    out->clear();
    for (;;) {
      uint32_t header[2];
      if (std::fread(header, sizeof(uint32_t), 2, f_) < 2) {
        MXT_CHECK_MSG(out->empty(), "truncated chunked record in " + rec_path_);
        return false;
      }
      MXT_CHECK_MSG(header[0] == kMagic, "bad record magic in " + rec_path_);
      uint32_t cflag = header[1] >> kCFlagBits;
      size_t len = header[1] & kLenMask;
      size_t cur = out->size();
      out->resize(cur + len);
      MXT_CHECK_MSG(std::fread(&(*out)[cur], 1, len, f_) == len,
                    "truncated record in " + rec_path_);
      std::fseek(f_, (long)((4 - len % 4) % 4), SEEK_CUR);
      if (cflag == 0 || cflag == 3) return true;
    }
  }

  void ReaderLoop() {
    const PipelineCfg& c = cfg_;
    size_t idx = 0;
    const size_t total = order_.empty() ? (size_t)-1 : order_.size();
    bool eof = false;
    std::mt19937_64 seed_rng(c.seed + epoch_);
    std::vector<std::string> first_records;
    while (!eof) {
      uint64_t seq;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_space_.wait(lk, [this] {
          return stop_ || in_flight_ < cfg_.prefetch;
        });
        if (stop_) return;
        in_flight_++;
        seq = next_seq_++;
      }
      Batch* b = new Batch;
      b->seq = seq;
      size_t bytes = (size_t)c.batch * c.channels * c.height * c.width *
                     (c.normalize ? sizeof(float) : 1);
      b->data.resize(bytes);
      b->label.assign((size_t)c.batch * c.label_width, 0.0f);
      b->remaining.store(c.batch);
      int filled = 0;
      std::vector<DecodeTask*> tasks;
      tasks.reserve(c.batch);
      for (int s = 0; s < c.batch; ++s) {
        std::string raw;
        bool ok = idx < total && ReadRecordAt(idx, &raw);
        if (ok) {
          ++idx;
          ++filled;
          if ((int)first_records.size() < c.batch)
            first_records.push_back(raw);
        } else {
          eof = true;
          if (filled == 0) {  // nothing left: drop this batch entirely
            std::lock_guard<std::mutex> lk(m_);
            in_flight_--;
            next_seq_--;
            reader_eof_ = true;
            delete b;
            for (auto* t : tasks) delete t;
            cv_out_.notify_all();
            return;
          }
          // pad the tail batch by repeating this epoch's first records
          raw = first_records[s % first_records.size()];
          b->pad++;
        }
        DecodeTask* t = new DecodeTask{this, b, s, std::move(raw),
                                       seed_rng()};
        tasks.push_back(t);
      }
      for (auto* t : tasks)
        engine_.PushAsync(
            [](void* arg) {
              DecodeTask* dt = static_cast<DecodeTask*>(arg);
              try {
                dt->pipe->RunTask(dt);
              } catch (const std::exception& e) {
                dt->pipe->TaskError(dt, e.what());
              }
            },
            t, nullptr, 0, nullptr, 0, 0);
    }
    std::lock_guard<std::mutex> lk(m_);
    reader_eof_ = true;
    cv_out_.notify_all();
  }

  PipelineCfg cfg_;
  std::string rec_path_;
  Engine engine_;
  std::FILE* f_ = nullptr;
  std::vector<int64_t> offsets_;
  std::vector<size_t> order_;
  uint64_t epoch_ = 0;

  std::mutex m_;
  std::condition_variable cv_space_, cv_out_;
  std::map<uint64_t, Batch*> done_;
  uint64_t next_seq_ = 0, next_out_ = 0;
  int in_flight_ = 0;
  bool stop_ = false;
  bool reader_eof_ = false;
  std::string error_;
  std::thread reader_;
};

}  // namespace mxt

// ---------------------------------------------------------------------------
// C ABI (ctypes-consumed, like the rest of src/)
// ---------------------------------------------------------------------------

extern "C" {

const char* MXImageGetLastError() { return mxt::LastError().c_str(); }

int MXImagePipelineCreate(const char* rec_path, const char* idx_path,
                          const char* cfg, void** out) {
  MXT_API_BEGIN();
  *out = new mxt::ImagePipeline(rec_path, idx_path ? idx_path : "", cfg);
  MXT_API_END();
}

// returns the next batch; *out_batch NULL at epoch end.  data/label point
// into the batch object — valid until MXImagePipelineReleaseBatch.
int MXImagePipelineNext(void* h, void** out_batch, const uint8_t** out_data,
                        const float** out_label, int* out_pad) {
  MXT_API_BEGIN();
  mxt::Batch* b = static_cast<mxt::ImagePipeline*>(h)->Next();
  *out_batch = b;
  if (b) {
    *out_data = b->data.data();
    *out_label = b->label.data();
    *out_pad = b->pad;
  } else {
    *out_data = nullptr;
    *out_label = nullptr;
    *out_pad = 0;
  }
  MXT_API_END();
}

int MXImagePipelineReleaseBatch(void* batch) {
  MXT_API_BEGIN();
  delete static_cast<mxt::Batch*>(batch);
  MXT_API_END();
}

int MXImagePipelineReset(void* h) {
  MXT_API_BEGIN();
  static_cast<mxt::ImagePipeline*>(h)->Reset();
  MXT_API_END();
}

int MXImagePipelineFree(void* h) {
  MXT_API_BEGIN();
  delete static_cast<mxt::ImagePipeline*>(h);
  MXT_API_END();
}

}  // extern "C"
