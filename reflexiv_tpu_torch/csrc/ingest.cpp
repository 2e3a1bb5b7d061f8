// One-pass FASTQ ingest: each file is inflated once.
//
// A gzip file of several members (concatenated gzip streams, as bgzip,
// block-gzip writers and `cat a.gz b.gz` lay them out) is inflated on all
// of the pass's threads at once, a member to a thread. A member's
// compressed length is in no header, so members are found by guessing and
// confirmed by a chain. Every offset holding 1f 8b 08 and a flag byte with
// its reserved bits (0xe0) clear is a candidate; a thread inflates a
// candidate with zlib, which checks its trailer's CRC32 and length, into
// blocks of text and counts each block's lines. Offset 0 is a member, and
// a candidate is one only where the member before it ends, after its
// trailer; the chain must end at the file's last byte. Candidates the
// chain passes over (false starts inside a member's compressed bytes) are
// dropped with their text. Once the text before a block is known, so is
// the index of its first line mod 4 (its phase): any thread then parses
// its whole lines, a line that spans blocks (or members) copied together
// first. Text waiting for its phase lives in a fixed pool of blocks, sized
// for one 32 MiB member per thread; a thread inflating ahead waits when
// the pool is empty, while the member the chain has reached never does.
// The file is mapped, and the pages of each part scanned and each member
// inflated leave the process's resident set (not the page cache).
//
// Every other file (plain text, one gzip member, a chain that fails:
// a decode error, a truncated member, a CRC or length mismatch, bytes
// after the last member) is read on one thread: the calling thread reads
// it through zlib (gzread inflates gzip of any number of members and
// passes plain text through) into fixed blocks, each cut at its last '\n'
// with the tail carried into the next block, counts each block's lines
// and queues the block; worker threads turn each block's sequence lines
// (index = 1 mod 4) into 2-bit codes in the block's own buffer while the
// next block inflates, then hand the text buffer back for reuse. Where
// gzread reports a data error, the pass gives up and says so: read_line
// ends a file at such an error in its own way, so the caller reads that
// file in native/'s two passes. Once a file is read the longest read is
// the row stride, and rfx_ingest_fill copies every block's reads into the
// caller's zeroed (reads, stride) matrix on several threads.
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

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
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
constexpr int64_t kMemberText = 32 << 20;  // text of a member the pool holds
constexpr int64_t kMinMember = 20;         // header, empty block, trailer
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

// The lines for_each_line makes of one line of d bytes before its '\n'
// (or, without one, at the end of the text).
int64_t pieces(int64_t d, bool newline) {
  return d / kCut + (newline || d % kCut > 0 ? 1 : 0);
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

// Pages mapped for one block's codes or text and unmapped when it is
// freed. From malloc, a second pass's blocks would come from arenas that
// the program's other threads share, which keep them resident after the
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
  char* text() const { return reinterpret_cast<char*>(p_); }

 private:
  size_t n_;
  uint8_t* p_;
};

struct Chunk;

// Part of a block's text that lies in one inflated chunk.
struct Slice {
  Chunk* chunk;
  int64_t begin, end;
};

struct Block {
  std::vector<char>* text = nullptr;  // one thread's: pooled, given back
  std::vector<Slice> slices;          // the members': where its text lies
  int64_t size = 0;
  int phase = 0;                      // index of its first line, mod 4
  std::unique_ptr<Pages> codes;       // its reads' codes, end to end
  std::vector<int32_t> lens;
  int64_t longest = 0;
};

void parse(Block* b, const char* text) {
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
  int64_t members = 0, inflaters = 1, false_starts = 0, fell_back = 0;
  bool data_error = false;  // gzread failed: read_line's reading differs
  bool filled = false;      // the fill frees the blocks' codes
};

int64_t since_ns(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now() - t0).count();
}

// ---- one thread inflates ----

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
      *wait_ns += since_ns(t0);
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
        parse(b, b->text->data());
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
          pass->data_error = got < 0;
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

// Reads the file at path on the calling thread and up to kMaxWorkers
// parse workers; false when it cannot be opened or a thread failed.
bool read_one_thread(const char* path, int64_t block_bytes, int threads,
                     Pass* pass) {
  gzFile f = gzopen(path, "rb");
  if (f == nullptr) return false;
  gzbuffer(f, kZlibBuffer);
  const int workers = std::max(1, std::min(threads - 1, kMaxWorkers));
  Pipeline pipe(workers);
  std::vector<std::thread> pool;
  try {
    for (int i = 0; i < workers; ++i)
      pool.emplace_back([&pipe] { pipe.work(); });
    read_blocks(f, block_bytes, &pipe, pass);
  } catch (...) {
    pipe.failed = true;
  }
  pipe.close();
  for (auto& t : pool) t.join();
  gzclose(f);
  return !pipe.failed;
}

// ---- members on every thread ----

// Inflated text of one member, one block's worth at most.
struct Chunk {
  std::unique_ptr<Pages> text;  // pooled; given back once no block needs it
  int64_t size = 0;
  int64_t first_nl = -1, last_nl = -1;  // -1: no '\n' in it
  int64_t body_lines = 0;               // lines of text(first_nl, last_nl]
  int refs = 1;  // the sequencer's, and one for each block over it
};

struct Member {
  explicit Member(int64_t at) : offset(at) {}
  enum State { kWaiting, kRunning, kDone, kFailed };
  int64_t offset;
  int64_t end = -1;  // after its trailer, once inflated
  State state = kWaiting;
  bool dropped = false;  // the chain passes over it
  std::vector<std::unique_ptr<Chunk>> chunks;
};

// Drops the whole pages of map[from, to), a read-only file mapping, from
// the process's resident set: they stay in the page cache, and a later
// read maps them again.
void drop_pages(const uint8_t* map, int64_t from, int64_t to) {
  static const int64_t page = sysconf(_SC_PAGESIZE);
  const int64_t lo = (from + page - 1) / page * page, hi = to / page * page;
  if (hi > lo) madvise(const_cast<uint8_t*>(map) + lo, hi - lo, MADV_DONTNEED);
}

// Offsets in p[0, n) that may start a gzip member, in order, found on up
// to `threads` threads.
std::vector<int64_t> member_starts(const uint8_t* p, int64_t n, int threads) {
  const int64_t last = n - kMinMember;  // no member starts after it
  if (last < 0) return {};
  const int parts = (int)std::max<int64_t>(
      1, std::min<int64_t>(threads, (last + 1) >> 20));
  std::vector<std::vector<int64_t>> found(parts);
  auto scan = [&](int part) {
    const int64_t lo = (last + 1) * part / parts;
    const int64_t hi = (last + 1) * (part + 1) / parts;
    for (int64_t i = lo; i < hi;) {
      const void* hit = std::memchr(p + i, 0x1f, hi - i);
      if (hit == nullptr) break;
      i = static_cast<const uint8_t*>(hit) - p;
      if (p[i + 1] == 0x8b && p[i + 2] == 8 && (p[i + 3] & 0xe0) == 0)
        found[part].push_back(i);
      ++i;
    }
    drop_pages(p, lo, hi);
  };
  std::vector<std::thread> pool;
  try {
    for (int part = 1; part < parts; ++part) pool.emplace_back(scan, part);
  } catch (...) {
    for (auto& t : pool) t.join();
    throw;
  }
  scan(0);
  for (auto& t : pool) t.join();
  std::vector<int64_t> out;
  for (auto& f : found) out.insert(out.end(), f.begin(), f.end());
  return out;
}

class MemberReader {
 public:
  MemberReader(const uint8_t* data, int64_t n,
               const std::vector<int64_t>& starts, int64_t block,
               int threads, Pass* pass)
      : data_(data), n_(n), block_(block), pass_(pass) {
    members_.reserve(starts.size());
    for (int64_t at : starts) members_.emplace_back(at);
    cap_ = (int64_t)threads * ((kMemberText + block - 1) / block + 2);
  }

  // Reads the file on up to `threads` threads (the caller's among them);
  // true when the chain reached the file's end and every block is parsed.
  bool run(int threads) {
    std::vector<std::thread> pool;
    try {
      for (int i = 1; i < threads; ++i) pool.emplace_back([this] { work(); });
    } catch (...) {
      // fewer threads: the caller's does what the others do not
    }
    work();
    for (auto& t : pool) t.join();
    if (failed_) return false;
    pass_->inflated = text_bytes_;
    pass_->wait_ns = wait_ns_;
    pass_->members = accepted_;
    pass_->inflaters = inflaters_;
    pass_->false_starts = (int64_t)members_.size() - accepted_;
    return true;
  }

 private:
  void work() {
    z_stream zs{};
    bool zinit = false, inflated = false;
    try {
      std::unique_lock<std::mutex> lk(mu_);
      while (!failed_) {
        if (!queue_.empty()) {
          parse_one(lk);
          continue;
        }
        Member* m = claim();
        if (m == nullptr) {
          if (complete_) break;
          cv_.wait(lk);
          continue;
        }
        lk.unlock();
        if (!inflated) {
          inflated = true;
          ++inflaters_;
        }
        if (!zinit) {
          if (inflateInit2(&zs, 31) != Z_OK) throw std::bad_alloc();
          zinit = true;
        } else {
          inflateReset(&zs);
        }
        inflate_member(m, &zs);
        lk.lock();
      }
    } catch (...) {
      std::lock_guard<std::mutex> lk(mu_);
      fail();
    }
    if (zinit) inflateEnd(&zs);
  }

  // The next candidate not known to be false, marked running (under mu_).
  Member* claim() {
    while (next_claim_ < members_.size() && members_[next_claim_].dropped)
      ++next_claim_;
    if (complete_ || next_claim_ == members_.size()) return nullptr;
    Member* m = &members_[next_claim_++];
    m->state = Member::kRunning;
    return m;
  }

  bool frontier(const Member* m) const {
    return !complete_ && m == &members_[cur_];
  }

  // Inflates m block by block until its trailer, an error, or the chain
  // drops it (called without mu_).
  void inflate_member(Member* m, z_stream* zs) {
    const uint8_t* in = data_ + m->offset;
    int64_t left = n_ - m->offset;
    zs->avail_in = 0;
    while (true) {
      std::unique_ptr<Pages> text = take(m);
      if (text == nullptr) return;
      zs->next_out = text->data();
      zs->avail_out = (uInt)block_;
      int ret = Z_OK;
      while (zs->avail_out > 0) {
        if (zs->avail_in == 0 && left > 0) {
          const int64_t feed = std::min<int64_t>(left, 1 << 30);
          zs->next_in = const_cast<Bytef*>(in);
          zs->avail_in = (uInt)feed;
          in += feed;
          left -= feed;
        }
        ret = inflate(zs, Z_NO_FLUSH);
        if (ret != Z_OK) break;  // the trailer, or a fault (a truncated
      }                          // member: Z_BUF_ERROR)
      const bool end = ret == Z_STREAM_END;
      const bool bad = ret != Z_OK && !end;
      const int64_t size = block_ - zs->avail_out;
      std::unique_ptr<Chunk> c;
      if (size > 0 && !bad) {
        c = std::make_unique<Chunk>();
        c->text = std::move(text);
        c->size = size;
        describe(c.get());
      }
      if (end) drop_pages(data_, m->offset, m->offset + zs->total_in);
      std::lock_guard<std::mutex> lk(mu_);
      if (text != nullptr) give(std::move(text));
      if (c != nullptr) {
        if (m->dropped || failed_) {
          give(std::move(c->text));
        } else {
          m->chunks.push_back(std::move(c));
        }
      }
      if (end) {
        m->state = Member::kDone;
        m->end = m->offset + (int64_t)zs->total_in;
      } else if (bad) {
        m->state = Member::kFailed;
        if (!frontier(m)) drop(m);
      }
      advance();
      cv_.notify_all();
      if (end || bad) return;
    }
  }

  // Where c's lines end, and the lines between its first and last '\n'.
  static void describe(Chunk* c) {
    const char* t = c->text->text();
    const void* first = std::memchr(t, '\n', c->size);
    if (first == nullptr) return;
    c->first_nl = static_cast<const char*>(first) - t;
    c->last_nl = static_cast<const char*>(memrchr(t, '\n', c->size)) - t;
    if (c->last_nl > c->first_nl)
      c->body_lines =
          count_lines(t + c->first_nl + 1, c->last_nl - c->first_nl);
  }

  // A text buffer for m's next chunk, or null once m is dropped or the
  // chain has failed (takes mu_). Waits while the pool is empty, parsing
  // what is ready meanwhile; the chain's member takes one past the pool.
  std::unique_ptr<Pages> take(Member* m) {
    std::unique_lock<std::mutex> lk(mu_);
    bool fresh = false, waited = false;
    auto t0 = std::chrono::steady_clock::now();
    while (!failed_ && !m->dropped) {
      if (!free_.empty()) break;
      if (live_ < cap_) {
        fresh = true;
        break;
      }
      if (!queue_.empty()) {
        parse_one(lk);
        continue;
      }
      if (frontier(m)) {
        fresh = true;
        break;
      }
      if (!waited) {
        waited = true;
        t0 = std::chrono::steady_clock::now();
      }
      cv_.wait(lk);
    }
    if (waited) wait_ns_ += since_ns(t0);
    if (failed_ || m->dropped) return nullptr;
    if (!fresh) {
      std::unique_ptr<Pages> t = std::move(free_.back());
      free_.pop_back();
      return t;
    }
    ++live_;
    lk.unlock();
    try {
      return std::make_unique<Pages>(block_);
    } catch (...) {
      lk.lock();
      --live_;
      throw;
    }
  }

  // Back to the pool, or unmapped where the chain's member took it past
  // the pool (under mu_).
  void give(std::unique_ptr<Pages> t) {
    if (live_ > cap_) {
      --live_;
    } else {
      free_.push_back(std::move(t));
    }
    cv_.notify_all();
  }

  void unref(Chunk* c) {
    if (--c->refs == 0) give(std::move(c->text));
  }

  void drop(Member* m) {
    m->dropped = true;
    for (auto& c : m->chunks)
      if (c->text != nullptr) give(std::move(c->text));
    m->chunks.clear();
  }

  void fail() {
    failed_ = true;
    cv_.notify_all();
  }

  // Parses the first queued block without mu_ (held on entry and exit).
  void parse_one(std::unique_lock<std::mutex>& lk) {
    Block* b = queue_.front();
    queue_.pop_front();
    lk.unlock();
    bool ok = true;
    try {
      if (b->slices.size() == 1) {
        const Slice& s = b->slices[0];
        parse(b, s.chunk->text->text() + s.begin);
      } else {
        std::vector<char> joined(b->size);
        char* at = joined.data();
        for (const Slice& s : b->slices) {
          std::memcpy(at, s.chunk->text->text() + s.begin, s.end - s.begin);
          at += s.end - s.begin;
        }
        parse(b, joined.data());
      }
    } catch (...) {
      ok = false;
    }
    lk.lock();
    for (const Slice& s : b->slices) unref(s.chunk);
    b->slices.clear();
    if (!ok) fail();
  }

  // Queues a block over `slices` (whose references it takes), `size`
  // bytes holding `lines` lines, at the current phase (under mu_).
  void emit(std::vector<Slice> slices, int64_t size, int64_t lines) {
    auto b = std::make_unique<Block>();
    b->slices = std::move(slices);
    b->size = size;
    b->phase = phase_;
    phase_ = (int)((phase_ + lines) & 3);
    queue_.push_back(b.get());
    pass_->blocks.push_back(std::move(b));
  }

  // Places chunk c, the next of the chain's text, into blocks: the line
  // that the chunks before it left open, closed by its first '\n'; its
  // whole lines after that; its open tail, kept for the next (under mu_).
  void sequence(Chunk* c) {
    text_bytes_ += c->size;
    if (c->first_nl < 0) {
      ++c->refs;
      open_.push_back({c, 0, c->size});
      open_bytes_ += c->size;
    } else {
      int64_t from = 0, lines = c->body_lines;
      if (!open_.empty()) {
        ++c->refs;
        open_.push_back({c, 0, c->first_nl + 1});
        emit(std::move(open_), open_bytes_ + c->first_nl + 1,
             pieces(open_bytes_ + c->first_nl, true));
        open_.clear();
        from = c->first_nl + 1;
      } else {
        lines += pieces(c->first_nl, true);
      }
      if (c->last_nl >= from) {
        ++c->refs;
        emit({{c, from, c->last_nl + 1}}, c->last_nl + 1 - from, lines);
      }
      open_bytes_ = c->size - c->last_nl - 1;
      if (open_bytes_ > 0) {
        ++c->refs;
        open_.push_back({c, c->last_nl + 1, c->size});
      }
    }
    unref(c);
  }

  // Follows the chain from the member it has reached: sequences that
  // member's new chunks and, once it is inflated, steps to the candidate at
  // its end, dropping those before it (under mu_).
  void advance() {
    while (!failed_ && !complete_) {
      Member& m = members_[cur_];
      while (next_chunk_ < m.chunks.size())
        sequence(m.chunks[next_chunk_++].get());
      if (m.state == Member::kWaiting || m.state == Member::kRunning) return;
      if (m.state == Member::kFailed) return fail();
      ++accepted_;
      size_t j = cur_ + 1;
      if (m.end == n_) {
        if (!open_.empty())  // a last line without '\n'
          emit(std::move(open_), open_bytes_, pieces(open_bytes_, false));
        complete_ = true;
        j = members_.size();
      } else {
        while (j < members_.size() && members_[j].offset < m.end) ++j;
      }
      for (size_t k = cur_ + 1; k < j; ++k) drop(&members_[k]);
      if (complete_) return;
      if (j == members_.size() || members_[j].offset != m.end) return fail();
      cur_ = j;
      next_chunk_ = 0;
    }
  }

  const uint8_t* data_;
  const int64_t n_, block_;
  Pass* pass_;
  std::vector<Member> members_;  // candidates, by offset
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Block*> queue_;     // blocks to parse, in any order
  std::vector<std::unique_ptr<Pages>> free_;
  int64_t live_ = 0, cap_ = 0;   // text buffers out, and the pool's size
  size_t next_claim_ = 0;
  size_t cur_ = 0, next_chunk_ = 0;  // the chain's member and its chunk
  std::vector<Slice> open_;          // the line the chain's text leaves open
  int64_t open_bytes_ = 0;
  int phase_ = 0;
  int64_t accepted_ = 0, text_bytes_ = 0, wait_ns_ = 0;
  std::atomic<int64_t> inflaters_{0};
  bool failed_ = false, complete_ = false;
};

// Memory-maps the file at path and reads its gzip members on `threads`
// threads: 1 when read, 0 when it is not a gzip file of two or more
// candidate members, -1 when the chain failed.
int read_members(const char* path, int64_t block_bytes, int threads,
                 Pass* pass) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return 0;
  struct stat st;
  void* map = MAP_FAILED;
  if (fstat(fd, &st) == 0 && st.st_size >= 2 * kMinMember)
    map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return 0;
  const uint8_t* data = static_cast<const uint8_t*>(map);
  int got = 0;
  try {
    const std::vector<int64_t> starts =
        member_starts(data, st.st_size, threads);
    if (starts.size() >= 2 && starts[0] == 0) {
      MemberReader reader(data, st.st_size, starts, block_bytes, threads,
                          pass);
      got = reader.run(threads) ? 1 : -1;
    }
  } catch (...) {
    got = -1;
  }
  munmap(map, st.st_size);
  return got;
}

}  // namespace

extern "C" {

// Reads a FASTQ file in one pass on up to `threads` threads, in blocks of
// `block_bytes` (0: the default). Returns a handle for rfx_ingest_fill and
// rfx_ingest_free, or null; info receives (reads, longest read, bytes of
// text, nanoseconds the inflating threads waited for a free block, gzip
// members the chain accepted, threads that inflated, candidates rejected,
// 1 where the members' chain failed and one thread read the file again,
// 1 where zlib reported a data error, so that the caller reads the file in
// native/'s two passes; with it, the handle is null).
void* rfx_ingest_fastq(const char* path, int64_t block_bytes, int threads,
                       int64_t* info) {
  if (block_bytes <= 0) block_bytes = kBlockBytes;
  block_bytes = std::min<int64_t>(block_bytes, 1 << 30);
  auto pass = std::make_unique<Pass>();
  const int got =
      threads >= 2 ? read_members(path, block_bytes, threads, pass.get()) : 0;
  if (got < 0) {
    pass = std::make_unique<Pass>();
    pass->fell_back = 1;
  }
  if (got != 1 && !read_one_thread(path, block_bytes, threads, pass.get()))
    return nullptr;
  for (const auto& b : pass->blocks) {
    pass->reads += (int64_t)b->lens.size();
    pass->longest = std::max(pass->longest, b->longest);
  }
  info[0] = pass->reads;
  info[1] = pass->longest;
  info[2] = pass->inflated;
  info[3] = pass->wait_ns;
  info[4] = pass->members;
  info[5] = pass->inflaters;
  info[6] = pass->false_starts;
  info[7] = pass->fell_back;
  info[8] = pass->data_error;
  if (pass->data_error) return nullptr;
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
