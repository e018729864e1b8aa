// Native mask fill for the pushdown-automaton grammar engine (pda.py).
//
// Walks every vocabulary token from a fixed set of PDA configurations
// (global rule-DFA state + call stack) and sets the allowed-token bitmask.
// The Python engine keeps per-config-set caches; this kernel makes the
// cache fill fast (the xgrammar-C++ analogue for recursive grammars,
// reference: scratchpad/constrained/xgrammar_backend.py).
//
// Tables (flattened by pda.py):
//   trans      [n_states * C] int32, -1 dead; states are GLOBAL ids (each
//              rule's DFA occupies a contiguous block)
//   accepting  [n_states] uint8 (rule-local acceptance)
//   call_off   [n_states+1] int64 CSR into call_pairs
//   call_pairs [2*n_calls] int32: (callee_init_state, return_state)
//
// A walk configuration is (state, stack). The stack is the initial
// config's frozen stack (read-only, pops just shrink base_len) plus a
// local grown segment. Configs are deduped per step by exact compare.
//
// Tokens whose walk exceeds the config/depth budget are reported in
// overflow_ids; the caller re-walks those exactly in Python.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr int kMaxConfigs = 48;
constexpr int kMaxLocalDepth = 200;
constexpr int kMaxClosureIters = 4096;

struct Cfg {
  int32_t state;
  int32_t base_cfg;   // which initial config's stack we sit on
  int32_t base_len;   // how many of its frames are still live
  std::vector<int32_t> local;  // frames pushed during this walk

  bool operator==(const Cfg& o) const {
    return state == o.state && base_cfg == o.base_cfg &&
           base_len == o.base_len && local == o.local;
  }
};

struct Tables {
  const int32_t* trans;
  int32_t C;
  const uint8_t* accepting;
  const int64_t* call_off;
  const int32_t* call_pairs;
  const int32_t* cfg_stack_off;
  const int32_t* cfg_stacks;
};

// returns false on budget overflow
bool closure(const Tables& t, std::vector<Cfg>& set) {
  int iters = 0;
  for (size_t i = 0; i < set.size(); ++i) {
    if (++iters > kMaxClosureIters) return false;
    Cfg cur = set[i];  // copy: set may reallocate
    // calls
    for (int64_t k = t.call_off[cur.state]; k < t.call_off[cur.state + 1];
         ++k) {
      const int32_t callee = t.call_pairs[2 * k];
      const int32_t ret = t.call_pairs[2 * k + 1];
      Cfg nxt = cur;
      nxt.state = callee;
      nxt.local.push_back(ret);
      if (nxt.local.size() > kMaxLocalDepth) return false;
      bool dup = false;
      for (const Cfg& c : set)
        if (c == nxt) { dup = true; break; }
      if (!dup) {
        if (set.size() >= kMaxConfigs) return false;
        set.push_back(std::move(nxt));
      }
    }
    // returns
    if (t.accepting[cur.state]) {
      Cfg nxt = cur;
      if (!nxt.local.empty()) {
        nxt.state = nxt.local.back();
        nxt.local.pop_back();
      } else if (nxt.base_len > 0) {
        const int32_t* stk = t.cfg_stacks + t.cfg_stack_off[nxt.base_cfg];
        nxt.state = stk[nxt.base_len - 1];
        nxt.base_len -= 1;
      } else {
        continue;  // overall acceptance; no frame to pop
      }
      bool dup = false;
      for (const Cfg& c : set)
        if (c == nxt) { dup = true; break; }
      if (!dup) {
        if (set.size() >= kMaxConfigs) return false;
        set.push_back(std::move(nxt));
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

void sptpu_pda_fill_mask(
    const int32_t* trans, int32_t C, const uint8_t* accepting,
    const int64_t* call_off, const int32_t* call_pairs, const int32_t* seqs,
    const int64_t* offsets, int64_t vocab, const int32_t* cfg_states,
    const int32_t* cfg_stack_off, const int32_t* cfg_stacks, int32_t n_cfg,
    uint32_t* mask,            // [ceil(vocab/32)] caller-zeroed
    int32_t* overflow_ids,     // [max_overflow] out
    int32_t max_overflow,
    int32_t* n_overflow) {     // out
  Tables t{trans, C, accepting, call_off, call_pairs, cfg_stack_off,
           cfg_stacks};
  *n_overflow = 0;

  std::vector<Cfg> init;
  init.reserve(n_cfg);
  for (int32_t i = 0; i < n_cfg; ++i) {
    Cfg c;
    c.state = cfg_states[i];
    c.base_cfg = i;
    c.base_len = static_cast<int32_t>(cfg_stack_off[i + 1] -
                                      cfg_stack_off[i]);
    init.push_back(std::move(c));
  }
  // initial configs arrive already closed (pda.py closes every step)

  std::vector<Cfg> cur, nxt;
  for (int64_t tid = 0; tid < vocab; ++tid) {
    const int64_t a = offsets[tid], b = offsets[tid + 1];
    if (a == b) continue;
    cur = init;
    bool ok = true, alive = true;
    for (int64_t p = a; p < b && alive; ++p) {
      const int32_t cls = seqs[p];
      nxt.clear();
      for (const Cfg& c : cur) {
        const int32_t d = t.trans[static_cast<int64_t>(c.state) * C + cls];
        if (d < 0) continue;
        Cfg m = c;
        m.state = d;
        bool dup = false;
        for (const Cfg& q : nxt)
          if (q == m) { dup = true; break; }
        if (!dup) {
          if (nxt.size() >= kMaxConfigs) { ok = false; break; }
          nxt.push_back(std::move(m));
        }
      }
      if (!ok) break;
      if (nxt.empty()) { alive = false; break; }
      if (!closure(t, nxt)) { ok = false; break; }
      cur.swap(nxt);
    }
    if (!ok) {
      if (*n_overflow < max_overflow) overflow_ids[(*n_overflow)++] = tid;
      continue;
    }
    if (alive) mask[tid >> 5] |= (1u << (tid & 31));
  }
}

}  // extern "C"

extern "C" {

// Classification walk (xgrammar's adaptive-token-mask analogue): walk every
// token from the STACK-AGNOSTIC projection of a configuration set (each
// config = a bare (state) with an empty abstract stack). A pop past the
// abstract base means the token's fate depends on the caller's real stack:
// such tokens are reported context-DEPENDENT. Tokens that survive without
// escaping are context-independently ACCEPTED (bit set in mask); tokens
// whose every path dies without escaping are context-independently
// rejected. Budget overflows are reported as context-dependent (the caller
// re-walks them exactly).
void sptpu_pda_classify(
    const int32_t* trans, int32_t C, const uint8_t* accepting,
    const int64_t* call_off, const int32_t* call_pairs, const int32_t* seqs,
    const int64_t* offsets, int64_t vocab, const int32_t* states,
    int32_t n_states_in,
    uint32_t* mask,        // [ceil(vocab/32)] caller-zeroed: CI-accepted
    int32_t* ctx_ids,      // [max_ctx] out: context-dependent token ids
    int32_t max_ctx,
    int32_t* n_ctx) {      // out; == max_ctx+1 signals ctx-list overflow
  Tables t{trans, C, accepting, call_off, call_pairs, nullptr, nullptr};
  *n_ctx = 0;

  std::vector<Cfg> init;
  init.reserve(n_states_in);
  for (int32_t i = 0; i < n_states_in; ++i) {
    Cfg c;
    c.state = states[i];
    c.base_cfg = 0;
    c.base_len = 0;  // abstract base: pops below here = escape
    init.push_back(std::move(c));
  }

  std::vector<Cfg> cur, nxt;
  for (int64_t tid = 0; tid < vocab; ++tid) {
    const int64_t a = offsets[tid], b = offsets[tid + 1];
    if (a == b) continue;
    cur = init;
    bool ok = true, alive = true, escaped = false;
    for (int64_t p = a; p < b && alive; ++p) {
      const int32_t cls = seqs[p];
      nxt.clear();
      for (const Cfg& c : cur) {
        const int32_t d = t.trans[static_cast<int64_t>(c.state) * C + cls];
        if (d < 0) continue;
        Cfg m = c;
        m.state = d;
        bool dup = false;
        for (const Cfg& q : nxt)
          if (q == m) { dup = true; break; }
        if (!dup) {
          if (nxt.size() >= kMaxConfigs) { ok = false; break; }
          nxt.push_back(std::move(m));
        }
      }
      if (!ok) break;
      // closure with escape detection: accepting configs with an empty
      // stack would pop the caller's real frame
      for (size_t i = 0; i < nxt.size() && ok; ++i) {
        Cfg cc = nxt[i];
        for (int64_t k = t.call_off[cc.state]; k < t.call_off[cc.state + 1];
             ++k) {
          Cfg m = cc;
          m.state = t.call_pairs[2 * k];
          m.local.push_back(t.call_pairs[2 * k + 1]);
          if (m.local.size() > kMaxLocalDepth) { ok = false; break; }
          bool dup = false;
          for (const Cfg& q : nxt)
            if (q == m) { dup = true; break; }
          if (!dup) {
            if (nxt.size() >= kMaxConfigs) { ok = false; break; }
            nxt.push_back(std::move(m));
          }
        }
        if (!ok) break;
        if (t.accepting[cc.state]) {
          if (!cc.local.empty()) {
            Cfg m = cc;
            m.state = m.local.back();
            m.local.pop_back();
            bool dup = false;
            for (const Cfg& q : nxt)
              if (q == m) { dup = true; break; }
            if (!dup) {
              if (nxt.size() >= kMaxConfigs) { ok = false; break; }
              nxt.push_back(std::move(m));
            }
          } else {
            escaped = true;  // would pop past the abstract base
          }
        }
      }
      if (!ok) break;
      if (nxt.empty()) { alive = false; break; }
      cur.swap(nxt);
    }
    if (!ok || escaped) {
      if (*n_ctx < max_ctx) {
        ctx_ids[(*n_ctx)++] = tid;
      } else {
        *n_ctx = max_ctx + 1;  // overflow marker
        return;
      }
      continue;
    }
    if (alive) mask[tid >> 5] |= (1u << (tid & 31));
  }
}

}  // extern "C"
