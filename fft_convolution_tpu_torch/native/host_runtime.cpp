// Host-side real-time runtime for fft_convolution_tpu_torch (the port's own
// copy of the JAX package's native/host_runtime.cpp; same C interface).
//
// The card executes the spectral math; this C++ layer owns the host side of
// the real-time path — the role the reference's allocation-free Rust
// while-loop plays inside process() (src/fft_convolver.rs:222-294) and the
// audio-callback glue its examples assume (examples/compare_partitioned.rs:30-48):
//
//   * a lock-free SPSC float ring buffer (audio callback <-> dispatcher
//     thread), cache-line padded indices, power-of-two capacity;
//   * a block assembler that turns arbitrary-size callback buffers into the
//     fixed-size blocks the per-block kernels take, tracking the intra-
//     block fill exactly like the reference's input_buffer_fill;
//   * 16-bit PCM mono WAV encode/decode (the hound-equivalent,
//     examples/util/mod.rs:21-40), so offline render paths never touch
//     Python sample loops.
//
// Everything is exported with C linkage for ctypes; no allocations occur
// after construction on any hot-path call (the RT-safety contract of
// src/lib.rs:8).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr size_t kCacheLine = 64;

inline uint32_t next_pow2(uint32_t v) {
  v -= 1;
  v |= v >> 1; v |= v >> 2; v |= v >> 4; v |= v >> 8; v |= v >> 16;
  return v + 1;
}

}  // namespace

// ---------------------------------------------------------------------------
// SPSC lock-free ring buffer
// ---------------------------------------------------------------------------

struct RingBuffer {
  float* data;
  uint32_t mask;  // capacity - 1 (capacity is a power of two)
  alignas(kCacheLine) std::atomic<uint64_t> head;  // write index (producer)
  alignas(kCacheLine) std::atomic<uint64_t> tail;  // read index (consumer)
};

extern "C" {

RingBuffer* rb_create(uint32_t min_capacity) {
  auto* rb = new RingBuffer();
  uint32_t cap = next_pow2(min_capacity < 2 ? 2 : min_capacity);
  rb->data = static_cast<float*>(std::calloc(cap, sizeof(float)));
  rb->mask = cap - 1;
  rb->head.store(0, std::memory_order_relaxed);
  rb->tail.store(0, std::memory_order_relaxed);
  return rb;
}

void rb_destroy(RingBuffer* rb) {
  if (!rb) return;
  std::free(rb->data);
  delete rb;
}

uint32_t rb_capacity(const RingBuffer* rb) { return rb->mask + 1; }

uint64_t rb_readable(const RingBuffer* rb) {
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_acquire);
}

uint64_t rb_writable(const RingBuffer* rb) {
  return (rb->mask + 1) - rb_readable(rb);
}

// Producer side: returns samples actually written (0..n). Never blocks.
uint32_t rb_write(RingBuffer* rb, const float* src, uint32_t n) {
  uint64_t head = rb->head.load(std::memory_order_relaxed);
  uint64_t tail = rb->tail.load(std::memory_order_acquire);
  uint32_t cap = rb->mask + 1;
  uint32_t free_n = static_cast<uint32_t>(cap - (head - tail));
  if (n > free_n) n = free_n;
  for (uint32_t i = 0; i < n; ++i) {
    rb->data[(head + i) & rb->mask] = src[i];
  }
  rb->head.store(head + n, std::memory_order_release);
  return n;
}

// Consumer side: returns samples actually read (0..n). Never blocks.
uint32_t rb_read(RingBuffer* rb, float* dst, uint32_t n) {
  uint64_t tail = rb->tail.load(std::memory_order_relaxed);
  uint64_t head = rb->head.load(std::memory_order_acquire);
  uint32_t avail = static_cast<uint32_t>(head - tail);
  if (n > avail) n = avail;
  for (uint32_t i = 0; i < n; ++i) {
    dst[i] = rb->data[(tail + i) & rb->mask];
  }
  rb->tail.store(tail + n, std::memory_order_release);
  return n;
}

// ---------------------------------------------------------------------------
// Block assembler: arbitrary-size pushes -> fixed-size device blocks
// ---------------------------------------------------------------------------

struct BlockAssembler {
  float* buf;          // [block_size]
  uint32_t block_size;
  uint32_t fill;       // == the reference's input_buffer_fill
};

BlockAssembler* ba_create(uint32_t block_size) {
  auto* ba = new BlockAssembler();
  ba->buf = static_cast<float*>(std::calloc(block_size, sizeof(float)));
  ba->block_size = block_size;
  ba->fill = 0;
  return ba;
}

void ba_destroy(BlockAssembler* ba) {
  if (!ba) return;
  std::free(ba->buf);
  delete ba;
}

uint32_t ba_fill(const BlockAssembler* ba) { return ba->fill; }

// Push up to n samples; writes any completed blocks tightly packed into
// out_blocks (capacity max_blocks * block_size). Returns number of completed
// blocks. *consumed reports how many input samples were taken (all of them
// unless out_blocks ran out of room).
uint32_t ba_push(BlockAssembler* ba, const float* src, uint32_t n,
                 float* out_blocks, uint32_t max_blocks, uint32_t* consumed) {
  uint32_t done = 0;
  uint32_t used = 0;
  while (used < n) {
    uint32_t want = ba->block_size - ba->fill;
    uint32_t take = n - used < want ? n - used : want;
    std::memcpy(ba->buf + ba->fill, src + used, take * sizeof(float));
    ba->fill += take;
    used += take;
    if (ba->fill == ba->block_size) {
      if (done == max_blocks) {  // out of output room: un-take this block
        ba->fill -= take;
        used -= take;
        break;
      }
      std::memcpy(out_blocks + static_cast<size_t>(done) * ba->block_size,
                  ba->buf, ba->block_size * sizeof(float));
      // zero on completion, like the engine's input_buffer
      // (src/fft_convolver.rs:280) — peek() of a partial block is then
      // exactly the zero-padded FFT input
      std::memset(ba->buf, 0, ba->block_size * sizeof(float));
      ba->fill = 0;
      ++done;
    }
  }
  if (consumed) *consumed = used;
  return done;
}

void ba_reset(BlockAssembler* ba) {
  std::memset(ba->buf, 0, ba->block_size * sizeof(float));
  ba->fill = 0;
}

// Copy of the current partial block (zero-padded to block_size).
void ba_peek(const BlockAssembler* ba, float* dst) {
  std::memcpy(dst, ba->buf, ba->block_size * sizeof(float));
}

// ---------------------------------------------------------------------------
// WAV codec (16-bit PCM mono) — examples/util/mod.rs:21-40 equivalent
// ---------------------------------------------------------------------------

namespace {

struct WavHeader {
  char riff[4]; uint32_t riff_size; char wave[4];
  char fmt[4]; uint32_t fmt_size; uint16_t format; uint16_t channels;
  uint32_t sample_rate; uint32_t byte_rate; uint16_t block_align;
  uint16_t bits; char data[4]; uint32_t data_size;
};

}  // namespace

// Returns 0 on success.
int32_t wav_write_mono16(const char* path, const float* samples, uint64_t n,
                         uint32_t sample_rate) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  WavHeader h;
  std::memcpy(h.riff, "RIFF", 4);
  std::memcpy(h.wave, "WAVE", 4);
  std::memcpy(h.fmt, "fmt ", 4);
  std::memcpy(h.data, "data", 4);
  h.fmt_size = 16; h.format = 1; h.channels = 1;
  h.sample_rate = sample_rate;
  h.bits = 16;
  h.block_align = 2;
  h.byte_rate = sample_rate * 2;
  h.data_size = static_cast<uint32_t>(n * 2);
  h.riff_size = 36 + h.data_size;
  std::fwrite(&h, sizeof(h), 1, f);
  constexpr uint32_t kChunk = 4096;
  int16_t tmp[kChunk];
  for (uint64_t off = 0; off < n; off += kChunk) {
    uint32_t m = static_cast<uint32_t>(n - off < kChunk ? n - off : kChunk);
    for (uint32_t i = 0; i < m; ++i) {
      // f32 [-1, 1] -> i16 by scale-and-truncate (examples/util/mod.rs:32-33)
      tmp[i] = static_cast<int16_t>(samples[off + i] * 32767.0f);
    }
    std::fwrite(tmp, sizeof(int16_t), m, f);
  }
  std::fclose(f);
  return 0;
}

// Returns sample count on success (and fills *sample_rate), -1 on error.
// Call with dst == nullptr to query the length first.
int64_t wav_read_mono16(const char* path, float* dst, int64_t max_n,
                        uint32_t* sample_rate) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  WavHeader h;
  if (std::fread(&h, sizeof(h), 1, f) != 1 || std::memcmp(h.riff, "RIFF", 4) ||
      h.format != 1 || h.bits != 16 || h.channels != 1) {
    std::fclose(f);
    return -1;
  }
  if (sample_rate) *sample_rate = h.sample_rate;
  int64_t n = h.data_size / 2;
  if (dst) {
    if (n > max_n) n = max_n;
    constexpr uint32_t kChunk = 4096;
    int16_t tmp[kChunk];
    int64_t got = 0;
    while (got < n) {
      uint32_t m = static_cast<uint32_t>(n - got < kChunk ? n - got : kChunk);
      size_t r = std::fread(tmp, sizeof(int16_t), m, f);
      if (r == 0) break;
      for (size_t i = 0; i < r; ++i) {
        dst[got + i] = static_cast<float>(tmp[i]) / 32767.0f;
      }
      got += static_cast<int64_t>(r);
    }
    n = got;
  }
  std::fclose(f);
  return n;
}

}  // extern "C"
