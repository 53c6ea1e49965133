// Native continuous-batching frame packer (the port's copy of
// native/packer.cpp, code unchanged).
//
// The reference's rayon pre-processing stage (moshi-server/src/batched_asr.rs
// pre_process_pipelined :526-653): per-slot lock-free SPSC pcm ring buffers
// fed by the websocket threads, drained by the device loop into one
// contiguous (B, frame) batch + active mask in a single pass, without holding
// the GIL.
//
// C ABI consumed from Python via ctypes (dsm_tpu_torch/server/native.py),
// which builds it at first use with g++ -O3 -shared -fPIC -std=c++17 into
// build/dsm_tpu_torch/<hash>/.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

struct SlotRing {
  // Single-producer (ws thread) / single-consumer (device loop) f32 ring.
  std::vector<float> buf;
  std::atomic<uint64_t> head{0};  // written samples
  std::atomic<uint64_t> tail{0};  // consumed samples
  std::atomic<uint32_t> generation{0};

  void reset() {
    head.store(0, std::memory_order_relaxed);
    tail.store(0, std::memory_order_relaxed);
    generation.fetch_add(1, std::memory_order_release);
  }

  uint64_t available() const {
    return head.load(std::memory_order_acquire) -
           tail.load(std::memory_order_relaxed);
  }

  uint64_t free_space() const {
    return buf.size() - (head.load(std::memory_order_relaxed) -
                         tail.load(std::memory_order_acquire));
  }
};

struct Packer {
  int batch;
  int frame;
  size_t capacity;
  // SlotRing holds atomics (non-movable) -> fixed array, not vector.
  std::unique_ptr<SlotRing[]> slots;
};

}  // namespace

extern "C" {

void* packer_create(int batch, int frame, int capacity_frames) {
  auto* p = new Packer();
  p->batch = batch;
  p->frame = frame;
  p->capacity = static_cast<size_t>(frame) * capacity_frames;
  p->slots.reset(new SlotRing[batch]);
  for (int i = 0; i < batch; ++i) p->slots[i].buf.resize(p->capacity);
  return p;
}

void packer_destroy(void* h) { delete static_cast<Packer*>(h); }

void packer_reset_slot(void* h, int slot) {
  auto* p = static_cast<Packer*>(h);
  if (slot < 0 || slot >= p->batch) return;
  p->slots[slot].reset();
}

// Returns samples accepted (may be < n if the ring is full).
int64_t packer_push(void* h, int slot, const float* pcm, int64_t n) {
  auto* p = static_cast<Packer*>(h);
  if (slot < 0 || slot >= p->batch || n <= 0) return 0;
  SlotRing& s = p->slots[slot];
  uint64_t can = s.free_space();
  uint64_t todo = n < 0 ? 0 : (static_cast<uint64_t>(n) < can
                                   ? static_cast<uint64_t>(n)
                                   : can);
  uint64_t head = s.head.load(std::memory_order_relaxed);
  size_t cap = p->capacity;
  uint64_t written = 0;
  while (written < todo) {
    size_t idx = (head + written) % cap;
    size_t run = cap - idx;
    uint64_t chunk = todo - written < run ? todo - written : run;
    std::memcpy(s.buf.data() + idx, pcm + written, chunk * sizeof(float));
    written += chunk;
  }
  s.head.store(head + written, std::memory_order_release);
  return static_cast<int64_t>(written);
}

int64_t packer_available(void* h, int slot) {
  auto* p = static_cast<Packer*>(h);
  if (slot < 0 || slot >= p->batch) return 0;
  return static_cast<int64_t>(p->slots[slot].available());
}

// Drain up to one frame per active slot into out (batch*frame floats,
// zero-filled for inactive slots); mask[b] = 1 if slot b produced a frame.
// `active` marks slots currently owned by a connection. Returns the number
// of packed frames.
int packer_pack(void* h, const uint8_t* active, float* out, uint8_t* mask) {
  auto* p = static_cast<Packer*>(h);
  const int frame = p->frame;
  const size_t cap = p->capacity;
  int packed = 0;
  for (int b = 0; b < p->batch; ++b) {
    float* dst = out + static_cast<size_t>(b) * frame;
    mask[b] = 0;
    if (!active[b]) {
      std::memset(dst, 0, sizeof(float) * frame);
      continue;
    }
    SlotRing& s = p->slots[b];
    if (s.available() < static_cast<uint64_t>(frame)) {
      std::memset(dst, 0, sizeof(float) * frame);
      continue;
    }
    uint64_t tail = s.tail.load(std::memory_order_relaxed);
    size_t idx = tail % cap;
    size_t run = cap - idx;
    if (run >= static_cast<size_t>(frame)) {
      std::memcpy(dst, s.buf.data() + idx, sizeof(float) * frame);
    } else {
      std::memcpy(dst, s.buf.data() + idx, sizeof(float) * run);
      std::memcpy(dst + run, s.buf.data(), sizeof(float) * (frame - run));
    }
    s.tail.store(tail + frame, std::memory_order_release);
    mask[b] = 1;
    ++packed;
  }
  return packed;
}

}  // extern "C"
