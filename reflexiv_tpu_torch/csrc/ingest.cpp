// One-pass FASTQ ingest: each file is inflated once.
//
// The calling thread reads the file through zlib (gzread inflates gzip of
// any number of members and passes plain text through) into fixed blocks,
// each cut at its last '\n' with the tail carried into the next block. It
// counts each block's lines, so that every block knows the index of its
// first line mod 4, and queues the block. Worker threads turn each block's
// sequence lines (index = 1 mod 4) into 2-bit codes in the block's own
// buffer while the next block inflates, then hand the text buffer back for
// reuse. Once the file is read the longest read is the row stride, and
// rfx_ingest_fill copies every block's reads into the caller's zeroed
// (reads, stride) matrix on several threads.
//
// Lines are split as native/reflexiv_native.cpp's read_line splits them,
// so the matrix equals rfx_scan + rfx_load's (fmt 0) byte for byte: every
// line counts for the phase, empty ones too; one '\r' before '\n' is
// dropped; a last line without '\n' counts, with its '\r' kept; a read
// error ends the input, as it ends gzgets. read_line takes gzgets chunks
// of at most 65,535 bytes and returns a line once it holds more than
// 1 MiB, so a line of 17 chunks or more is cut after the 17th and its
// rest read as further lines. (Unlike read_line, a NUL byte is data here,
// where strlen ends the chunk there.)
//
// Build: g++ -O3 -march=native -fPIC -shared -std=c++17 ingest.cpp -lz
// -pthread (reflexiv_tpu_torch/ingest.py builds it on first use).

#include <sys/mman.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <climits>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kBlockBytes = 4 << 20;   // text a block holds
constexpr unsigned kZlibBuffer = 1 << 20;  // zlib's input buffer
constexpr int kMaxWorkers = 4;             // one keeps up with inflate
// read_line's cut: 17 chunks of 65,535 bytes
constexpr int64_t kCut = 17 * 65535;
// a line of kCut bytes or more holds a whole aligned window of this size
constexpr int64_t kWindow = 1 << 19;
static_assert(2 * kWindow - 1 <= kCut, "a cut line must hold a window");

// A=0 C=1 G=2 T=3 in either case; everything else (N included) maps to T,
// as native/reflexiv_native.cpp's table does.
struct CodeTable {
  uint8_t t[256];
  CodeTable() {
    std::memset(t, 3, sizeof(t));
    t['A'] = t['a'] = 0;
    t['C'] = t['c'] = 1;
    t['G'] = t['g'] = 2;
    t['T'] = t['t'] = 3;
  }
};
const CodeTable kCodes;

// Calls fn(start, length) for each line of text[0, n) as read_line
// returns them; text starts at the start of a line.
template <class F>
void for_each_line(const char* text, int64_t n, F&& fn) {
  int64_t pos = 0;
  while (pos < n) {
    const char* nl =
        static_cast<const char*>(std::memchr(text + pos, '\n', n - pos));
    int64_t d = nl != nullptr ? nl - (text + pos) : n - pos;
    for (; d >= kCut; d -= kCut, pos += kCut) fn(text + pos, kCut);
    if (nl != nullptr) {
      int64_t len = d;
      if (len > 0 && text[pos + len - 1] == '\r') --len;
      fn(text + pos, len);
      pos += d + 1;
    } else {
      if (d > 0) fn(text + pos, d);
      pos += d;
    }
  }
}

// Newlines in p[0, n), counted in 64 byte lanes (a form the compiler
// vectorizes: three times std::count's rate).
int64_t count_newlines(const char* p, int64_t n) {
  int64_t total = 0, i = 0;
  while (i + 64 <= n) {
    const int64_t stop = std::min(n - 64, i + 254 * 64);  // no lane wraps
    uint8_t lanes[64] = {};
    for (; i <= stop; i += 64)
      for (int j = 0; j < 64; ++j) lanes[j] += p[i + j] == '\n';
    for (int j = 0; j < 64; ++j) total += lanes[j];
  }
  for (; i < n; ++i) total += p[i] == '\n';
  return total;
}

// Lines in text[0, n), which ends in '\n': its newlines, unless an aligned
// window holds none, where a line may be long enough to be cut.
int64_t count_lines(const char* text, int64_t n) {
  int64_t lines = 0, w = 0;
  for (; w + kWindow <= n; w += kWindow) {
    int64_t c = count_newlines(text + w, kWindow);
    if (c == 0) {
      lines = 0;
      for_each_line(text, n, [&](const char*, int64_t) { ++lines; });
      return lines;
    }
    lines += c;
  }
  return lines + count_newlines(text + w, n - w);
}

// Pages mapped for one block's codes and unmapped when it is freed. From
// malloc, a second pass's blocks would come from arenas that the
// program's other threads share, which keep them resident after the
// fill, on top of what the job allocates next.
class Pages {
 public:
  explicit Pages(size_t n) : n_(std::max<size_t>(n, 1)) {
    void* p = mmap(nullptr, n_, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) throw std::bad_alloc();
    p_ = static_cast<uint8_t*>(p);
  }
  ~Pages() { munmap(p_, n_); }
  Pages(const Pages&) = delete;
  Pages& operator=(const Pages&) = delete;
  uint8_t* data() const { return p_; }

 private:
  size_t n_;
  uint8_t* p_;
};

struct Block {
  std::vector<char>* text = nullptr;  // pooled; given back once parsed
  int64_t size = 0;
  int phase = 0;                      // index of its first line, mod 4
  std::unique_ptr<Pages> codes;       // its reads' codes, end to end
  std::vector<int32_t> lens;
  int64_t longest = 0;
};

void parse(Block* b) {
  const char* text = b->text->data();
  b->codes = std::make_unique<Pages>(b->size);
  b->lens.reserve(b->size / 128);
  uint8_t* out = b->codes->data();
  int64_t idx = b->phase;
  for_each_line(text, b->size, [&](const char* s, int64_t len) {
    if ((idx++ & 3) != 1) return;
    for (int64_t i = 0; i < len; ++i) out[i] = kCodes.t[(uint8_t)s[i]];
    out += len;
    b->lens.push_back((int32_t)len);
    b->longest = std::max(b->longest, len);
  });
}

struct Pass {
  std::vector<std::unique_ptr<Block>> blocks;
  int64_t reads = 0, longest = 0, inflated = 0, wait_ns = 0;
  bool filled = false;  // the fill frees the blocks' codes
};

// The reader's queue of blocks to parse and the pool of text buffers.
class Pipeline {
 public:
  Pipeline(int workers) : texts_(workers + 2) {
    for (auto& t : texts_) free_.push_back(&t);
  }

  // A free text buffer; the nanoseconds waited for one go to *wait_ns.
  std::vector<char>* take_text(int64_t* wait_ns) {
    std::unique_lock<std::mutex> lk(mu_);
    if (free_.empty()) {
      auto t0 = std::chrono::steady_clock::now();
      free_cv_.wait(lk, [&] { return !free_.empty(); });
      *wait_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                      std::chrono::steady_clock::now() - t0).count();
    }
    std::vector<char>* t = free_.back();
    free_.pop_back();
    return t;
  }

  void give_text(std::vector<char>* t) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      free_.push_back(t);
    }
    free_cv_.notify_one();
  }

  void push(Block* b) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      work_.push_back(b);
    }
    work_cv_.notify_one();
  }

  void close() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      closed_ = true;
    }
    work_cv_.notify_all();
  }

  void work() {
    while (true) {
      Block* b;
      {
        std::unique_lock<std::mutex> lk(mu_);
        work_cv_.wait(lk, [&] { return !work_.empty() || closed_; });
        if (work_.empty()) return;
        b = work_.front();
        work_.pop_front();
      }
      try {
        parse(b);
      } catch (...) {
        failed = true;
      }
      give_text(b->text);
      b->text = nullptr;
    }
  }

  std::atomic<bool> failed{false};

 private:
  std::vector<std::vector<char>> texts_;
  std::mutex mu_;
  std::condition_variable free_cv_, work_cv_;
  std::vector<std::vector<char>*> free_;
  std::deque<Block*> work_;
  bool closed_ = false;
};

// Inflates f block by block into pass, handing each block to the pipeline.
void read_blocks(gzFile f, int64_t block_bytes, Pipeline* pipe, Pass* pass) {
  std::vector<char> carry;  // the start of a line the last block cut off
  int phase = 0;
  bool eof = false;
  while (!eof && !pipe->failed) {
    std::vector<char>* text = pipe->take_text(&pass->wait_ns);
    int64_t cap = std::max<int64_t>(
        (int64_t)text->size(), (int64_t)carry.size() + block_bytes);
    if ((int64_t)text->size() < cap) text->resize(cap);
    std::memcpy(text->data(), carry.data(), carry.size());
    int64_t have = carry.size(), end = 0;
    while (true) {
      while (have < cap && !eof) {
        int got = gzread(f, text->data() + have,
                         (unsigned)std::min<int64_t>(cap - have, INT_MAX));
        if (got <= 0) {
          eof = true;
        } else {
          have += got;
          pass->inflated += got;
        }
      }
      if (eof) {
        end = have;
        break;
      }
      const void* nl = memrchr(text->data(), '\n', have);
      if (nl != nullptr) {
        end = static_cast<const char*>(nl) - text->data() + 1;
        break;
      }
      cap *= 2;  // no line ends in the block: read on into a larger one
      text->resize(cap);
    }
    carry.assign(text->data() + end, text->data() + have);
    if (end == 0) {
      pipe->give_text(text);
      continue;
    }
    auto b = std::make_unique<Block>();
    b->text = text;
    b->size = end;
    b->phase = phase;
    if (!eof) phase = (int)((phase + count_lines(text->data(), end)) & 3);
    pass->blocks.push_back(std::move(b));
    pipe->push(pass->blocks.back().get());
  }
}

}  // namespace

extern "C" {

// Reads a FASTQ file in one pass on up to `threads` threads (the caller's
// and its workers), in blocks of `block_bytes` (0: the default). Returns a
// handle for rfx_ingest_fill and rfx_ingest_free, or null on failure;
// info receives (reads, longest read, bytes inflated, nanoseconds the
// reader waited for a free block).
void* rfx_ingest_fastq(const char* path, int64_t block_bytes, int threads,
                       int64_t* info) {
  gzFile f = gzopen(path, "rb");
  if (f == nullptr) return nullptr;
  gzbuffer(f, kZlibBuffer);
  if (block_bytes <= 0) block_bytes = kBlockBytes;
  const int workers = std::max(1, std::min(threads - 1, kMaxWorkers));
  auto pass = std::make_unique<Pass>();
  Pipeline pipe(workers);
  std::vector<std::thread> pool;
  try {
    for (int i = 0; i < workers; ++i)
      pool.emplace_back([&pipe] { pipe.work(); });
    read_blocks(f, block_bytes, &pipe, pass.get());
  } catch (...) {
    pipe.failed = true;
  }
  pipe.close();
  for (auto& t : pool) t.join();
  gzclose(f);
  if (pipe.failed) return nullptr;
  for (const auto& b : pass->blocks) {
    pass->reads += (int64_t)b->lens.size();
    pass->longest = std::max(pass->longest, b->longest);
  }
  info[0] = pass->reads;
  info[1] = pass->longest;
  info[2] = pass->inflated;
  info[3] = pass->wait_ns;
  return pass.release();
}

// Writes the pass's reads into codes (rows of `stride` bytes, zeroed by the
// caller) and lens, in file order, on up to `threads` threads, freeing each
// block's codes once copied. Returns the rows written, or -1 when a read is
// longer than `stride` or the pass was filled before.
int64_t rfx_ingest_fill(void* handle, uint8_t* codes, int32_t* lens,
                        int64_t stride, int threads) {
  Pass* pass = static_cast<Pass*>(handle);
  if (pass->longest > stride || pass->filled) return -1;
  pass->filled = true;
  const size_t nb = pass->blocks.size();
  std::vector<int64_t> first(nb + 1, 0);
  for (size_t i = 0; i < nb; ++i)
    first[i + 1] = first[i] + (int64_t)pass->blocks[i]->lens.size();
  std::atomic<size_t> next{0};
  auto body = [&] {
    for (size_t i; (i = next++) < nb;) {
      Block* b = pass->blocks[i].get();
      const uint8_t* src = b->codes->data();
      for (size_t r = 0; r < b->lens.size(); ++r) {
        const int64_t row = first[i] + (int64_t)r;
        std::memcpy(codes + row * stride, src, b->lens[r]);
        lens[row] = b->lens[r];
        src += b->lens[r];
      }
      b->codes.reset();
    }
  };
  std::vector<std::thread> pool;
  const size_t extra = std::min<size_t>(std::max(threads, 1), nb);
  try {
    for (size_t i = 1; i < extra; ++i) pool.emplace_back(body);
  } catch (...) {
    // fewer threads: the caller's copies what the others do not
  }
  body();
  for (auto& t : pool) t.join();
  return first[nb];
}

void rfx_ingest_free(void* handle) { delete static_cast<Pass*>(handle); }

}  // extern "C"
