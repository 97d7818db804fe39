// Host-side chunk gather of the replay buffer (the host-streamed feed).
//
// Each host-fed training step gathers n * L buffer rows (batch 50 x chunk
// 50 = 2500 rows, ~22 KB each over the image, sound, action, reward and
// nonterminal arrays) into a time-major [L, n, ...] batch.  NumPy's fancy
// indexing allocates an index intermediate and runs on one core under the
// interpreter; this is one pass of bounds-checked memcpys into an output the
// caller allocates, split over threads by time step.  It is called through
// ctypes, which releases the interpreter lock for the call, so a prefetch
// thread gathers while the loop's thread queues the step.
//
// Built with g++ into build/torch_native/ at first use by
// multimodal_rssm_torch/data/native.py.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// dst[(l * n + i) * row_bytes ...] = src[idx[i * L + l] * row_bytes ...]
// idx: int64 [n, L], row-major.  Returns 0, or -1 (nothing written) when an
// index lies outside [0, src_rows).
int mrssm_gather_chunks(const uint8_t* src, uint64_t src_rows,
                        uint64_t row_bytes, const int64_t* idx, uint64_t n,
                        uint64_t L, uint8_t* dst, int num_threads) {
  const uint64_t total = n * L;
  for (uint64_t k = 0; k < total; ++k) {
    const int64_t r = idx[k];
    if (r < 0 || (uint64_t)r >= src_rows) return -1;
  }

  auto worker = [&](uint64_t l_begin, uint64_t l_end) {
    for (uint64_t l = l_begin; l < l_end; ++l) {
      uint8_t* dst_row = dst + (l * n) * row_bytes;
      for (uint64_t i = 0; i < n; ++i) {
        const uint64_t r = (uint64_t)idx[i * L + l];
        std::memcpy(dst_row + i * row_bytes, src + r * row_bytes, row_bytes);
      }
    }
  };

  if (num_threads <= 1 || L < 4) {
    worker(0, L);
    return 0;
  }
  const uint64_t nt = (uint64_t)num_threads < L ? (uint64_t)num_threads : L;
  const uint64_t chunk = (L + nt - 1) / nt;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (uint64_t t = 0; t < nt; ++t) {
    const uint64_t b = t * chunk;
    const uint64_t e = b + chunk < L ? b + chunk : L;
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
