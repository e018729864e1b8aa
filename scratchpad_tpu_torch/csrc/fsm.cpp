// Native grammar-mask kernel: walk every vocabulary token through a dense
// DFA transition table and emit the allowed-token bitmask + destination
// states for one DFA state.
//
// This is the TPU-rebuild equivalent of xgrammar's C++ adaptive-token-mask
// computation (reference: scratchpad/constrained/xgrammar_backend.py:82-100
// calls into the xgrammar C++ library); the Python engine keeps a per-state
// cache, and this kernel makes the cache fill ~100x cheaper than the
// pure-Python walk (128k tokens x avg token length transitions).
//
// Built standalone with g++ (no pybind11 in the image); called via ctypes.
// Plain C ABI, no exceptions, no allocation.

#include <cstdint>

extern "C" {

// trans:    [num_states * num_classes] int32, -1 = dead
// seqs:     flat class-id sequences for all tokens
// offsets:  [vocab + 1] int64 into seqs; offsets[t]==offsets[t+1] -> token
//           skipped (special/empty/undecodable)
// state:    DFA state whose mask to compute
// mask:     [ceil(vocab/32)] uint32, caller-zeroed
// dst:      [vocab] int32, caller-filled with -1
void sptpu_fsm_compute_state(const int32_t* trans, int32_t num_classes,
                             const int32_t* seqs, const int64_t* offsets,
                             int64_t vocab, int32_t state, uint32_t* mask,
                             int32_t* dst) {
  for (int64_t t = 0; t < vocab; ++t) {
    const int64_t a = offsets[t], b = offsets[t + 1];
    if (a == b) continue;
    int32_t s = state;
    for (int64_t i = a; i < b; ++i) {
      s = trans[static_cast<int64_t>(s) * num_classes + seqs[i]];
      if (s < 0) break;
    }
    if (s >= 0) {
      dst[t] = s;
      mask[t >> 5] |= (1u << (t & 31));
    }
  }
}

}  // extern "C"
