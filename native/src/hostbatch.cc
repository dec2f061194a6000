// Batched host-side glue for the device pass-1 / realignment engine.
//
// The device scores whole read batches (mia/core/jax_engine.py); this
// module does everything around those dispatches that would otherwise cost
// per-read Python time:
//
//   * mia_kpa_build        — direct-address k-mer index over a reference
//                            strand (init_kpa/populate_kpa,
//                            /root/reference/src/kmer.c:90-168)
//   * mia_p1_create/free   — immutable per-assembly context (both encoded
//                            reference strands, both PSSMs, k-mer indexes)
//   * mia_p1_prepare       — per-batch k-mer filter + band intervals +
//                            device-input packing (new_kmer_filter,
//                            /root/reference/src/kmer.c:239-331, re-expressed
//                            as interval lists instead of byte masks)
//   * mia_p1_finish        — per-batch score-verified window DP + traceback
//                            for each read's winning strand (the host half of
//                            the split described in jax_engine.windowed_exact_dp)
//
// Interval semantics match mia/ops/kmer.py and jax_engine.mask_intervals
// exactly: a read whose band needs more than `max_intervals` runs on the
// host fallback (flag HOST_ONLY); a read whose band spans more than `win_w`
// columns is scored full-width on device (flag WIDE).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
void mia_dp_fill(const int8_t* s1c, int len1, const int8_t* s2c, int len2,
                 const int32_t* submat, const uint8_t* mask, int sg5,
                 const char* seq1, const char* seq2, const int32_t* hpcl,
                 const int32_t* hpcs, const int32_t* hprl, const int32_t* hprs,
                 int win_lo, int32_t* score, int32_t* trace);
int32_t mia_dp_traceback(const int32_t* trace, int len1, int len2, int aer,
                         int aec, const char* seq1, const char* seq2,
                         char* out_ref, char* out_frag, int cap, int32_t* abr,
                         int32_t* abc);
}

namespace {

constexpr int kMaxKmerPos = 128;   // MAX_KMER_POS, src/params.h:76
constexpr int kKmerSaturate = 128; // KMER_SATURATE, src/params.h:77
constexpr int kMaskBuffer = 10;    // ALIGN_MASK_BUFFER, src/params.h:78
constexpr int32_t kGep = 200;
constexpr int32_t kHim2 = INT32_MIN / 2;

inline int base_code(unsigned char c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return -1;
  }
}

// base2inx (src/map_align.c:16-29): uppercase ACGT only, everything else 4.
inline int8_t base2inx(unsigned char c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return 4;
  }
}

struct Kpa {
  int k = 0;
  std::vector<int64_t> uniq;      // sorted distinct codes
  std::vector<int32_t> starts;    // CSR offsets into positions
  std::vector<int32_t> counts;
  std::vector<int32_t> positions; // ascending within each k-mer

  // positions of `code`, or nullptr
  const int32_t* lookup(int64_t code, int32_t* count) const {
    auto it = std::lower_bound(uniq.begin(), uniq.end(), code);
    if (it == uniq.end() || *it != code) {
      *count = 0;
      return nullptr;
    }
    size_t i = it - uniq.begin();
    *count = counts[i];
    return positions.data() + starts[i];
  }
};

// rolling 2-bit codes over `seq`; invalid (non-ACGT or soft-masked) windows
// are skipped via the emit callback contract (valid flag)
template <typename Emit>
void scan_kmers(const char* seq, int64_t len, int k, bool soft_mask,
                Emit emit) {
  if (len < k) return;
  const int64_t mask = (int64_t(1) << (2 * k)) - 1;
  int64_t code = 0;
  int run = 0;      // count of consecutive valid chars ending here
  int lower_run = 0; // consecutive chars w/o lowercase (for soft-mask skip)
  for (int64_t i = 0; i < len; ++i) {
    int c = base_code((unsigned char)seq[i]);
    if (c < 0) {
      run = 0;
      code = 0;
    } else {
      code = ((code << 2) | c) & mask;
      ++run;
    }
    bool lower = seq[i] >= 'a' && seq[i] <= 'z';
    lower_run = lower ? 0 : lower_run + 1;
    if (run >= k && (!soft_mask || lower_run >= k)) emit(i - k + 1, code);
  }
}

struct Ctx {
  int64_t len1 = 0;
  std::vector<int8_t> fw_c, rc_c;      // encoded strands
  std::vector<char> fw_s, rc_s;        // raw chars (traceback emission)
  std::vector<int32_t> submat[2];      // [31*5*5] each; 1 may be empty
  int32_t max_sub[2] = {0, 0};
  Kpa* fkpa = nullptr;                 // not owned
  Kpa* rkpa = nullptr;
  int kmer_len = 0;                    // <0 => no filtering (full-open)
  int win_w = 384;
  int max_iv = 16;
  bool hp = false;                     // -h homopolymer gap discounting
  std::vector<int32_t> hp_l[2], hp_s[2];  // per-strand run (length, start)
};

// per-position homopolymer (run length, run start) arrays over raw chars
// (pop_hpl_and_hps, /root/reference/src/map_align.c:1193-1234); start values
// are indices into `s` itself (caller offsets for global coordinates)
void pop_hp(const char* s, int64_t n, std::vector<int32_t>& hpl,
            std::vector<int32_t>& hps) {
  hpl.resize(n);
  hps.resize(n);
  int64_t i = 0;
  while (i < n) {
    int64_t j = i + 1;
    while (j < n && s[j] == s[i]) ++j;
    for (int64_t t = i; t < j; ++t) {
      hpl[t] = (int32_t)(j - i);
      hps[t] = (int32_t)i;
    }
    i = j;
  }
}

struct IvBuf {
  std::vector<std::pair<int32_t, int32_t>> iv; // [lo, end) exclusive
};

// union of hit bands as sorted merged intervals; returns total hit count
int accumulate_bands(const Kpa& kpa, const char* seq, int frag_len, int k,
                     int64_t len1, bool rc_strand, IvBuf& out) {
  out.iv.clear();
  int total = 0;
  std::vector<std::pair<int32_t, int32_t>>& iv = out.iv;
  scan_kmers(seq, frag_len, k, false, [&](int64_t fp, int64_t code) {
    int32_t cnt = 0;
    const int32_t* pos = kpa.lookup(code, &cnt);
    total += cnt;
    for (int32_t j = 0; j < cnt; ++j) {
      int64_t rp = pos[j];
      int64_t lo = rp - fp - kMaskBuffer;
      // quirk preserved from new_kmer_filter (mia/ops/kmer.py:176,184):
      // the fw band extends one column further right than the rc band
      int64_t hi = rc_strand ? rp + frag_len - fp - 1 + kMaskBuffer
                             : rp + (frag_len - fp) + kMaskBuffer;
      lo = std::max<int64_t>(lo, 0);
      hi = std::min<int64_t>(hi, len1 - 1);
      if (hi >= lo) iv.emplace_back((int32_t)lo, (int32_t)(hi + 1));
    }
  });
  if (total >= kKmerSaturate) {
    iv.clear();
    iv.emplace_back(0, (int32_t)len1);
    return total;
  }
  if (iv.empty()) return total;
  std::sort(iv.begin(), iv.end());
  size_t w = 0;
  for (size_t i = 1; i < iv.size(); ++i) {
    if (iv[i].first <= iv[w].second) {
      iv[w].second = std::max(iv[w].second, iv[i].second);
    } else {
      iv[++w] = iv[i];
    }
  }
  iv.resize(w + 1);
  return total;
}

// Runs fn(i) for i in [0, n) across n_threads; a throwing iteration (e.g.
// std::bad_alloc from a plane resize) is reported through on_err(i) instead
// of std::terminate'ing the process, so allocation failure degrades to the
// caller's per-read host-fallback path.
template <typename Fn, typename OnErr>
void mia_parallel_for(int n, int n_threads, Fn fn, OnErr on_err) {
  auto safe = [&](int i) {
    try {
      fn(i);
    } catch (...) {
      on_err(i);
    }
  };
  if (n_threads <= 1 || n < 2) {
    for (int i = 0; i < n; ++i) safe(i);
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      safe(i);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

void* mia_kpa_build(const char* seq, int64_t len, int k, int soft_mask) {
  auto* kpa = new Kpa();
  kpa->k = k;
  std::vector<std::pair<int64_t, int32_t>> entries; // (code, pos)
  entries.reserve(len);
  scan_kmers(seq, len, k, soft_mask != 0,
             [&](int64_t pos, int64_t code) { entries.emplace_back(code, (int32_t)pos); });
  std::stable_sort(entries.begin(), entries.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });
  // cap at the first kMaxKmerPos positions per k-mer (src/kmer.c:75-77)
  for (size_t i = 0; i < entries.size();) {
    size_t j = i;
    while (j < entries.size() && entries[j].first == entries[i].first) ++j;
    size_t keep = std::min<size_t>(j - i, kMaxKmerPos);
    kpa->uniq.push_back(entries[i].first);
    kpa->starts.push_back((int32_t)kpa->positions.size());
    kpa->counts.push_back((int32_t)keep);
    for (size_t t = i; t < i + keep; ++t) kpa->positions.push_back(entries[t].second);
    i = j;
  }
  return kpa;
}

void mia_kpa_free(void* h) { delete static_cast<Kpa*>(h); }

void* mia_p1_create(const char* fw_seq, const char* rc_seq, int64_t len1,
                    const int32_t* submat_a, const int32_t* submat_b,
                    void* fkpa, void* rkpa, int kmer_len, int win_w,
                    int max_intervals, int hp) {
  auto* ctx = new Ctx();
  ctx->len1 = len1;
  ctx->fw_s.assign(fw_seq, fw_seq + len1);
  ctx->rc_s.assign(rc_seq, rc_seq + len1);
  ctx->fw_c.resize(len1);
  ctx->rc_c.resize(len1);
  for (int64_t i = 0; i < len1; ++i) {
    ctx->fw_c[i] = base2inx((unsigned char)fw_seq[i]);
    ctx->rc_c[i] = base2inx((unsigned char)rc_seq[i]);
  }
  for (int s = 0; s < 2; ++s) {
    const int32_t* m = s == 0 ? submat_a : submat_b;
    if (!m) continue;
    ctx->submat[s].assign(m, m + 31 * 5 * 5);
    ctx->max_sub[s] = *std::max_element(ctx->submat[s].begin(), ctx->submat[s].end());
  }
  ctx->fkpa = static_cast<Kpa*>(fkpa);
  ctx->rkpa = static_cast<Kpa*>(rkpa);
  ctx->kmer_len = kmer_len;
  ctx->win_w = win_w;
  ctx->max_iv = max_intervals;
  ctx->hp = hp != 0;
  if (ctx->hp) {
    pop_hp(ctx->fw_s.data(), len1, ctx->hp_l[0], ctx->hp_s[0]);
    pop_hp(ctx->rc_s.data(), len1, ctx->hp_l[1], ctx->hp_s[1]);
  }
  return ctx;
}

void mia_p1_free(void* h) { delete static_cast<Ctx*>(h); }

// flags bits
enum { kSkip = 1, kHostOnly = 2, kWide = 4 };

// Pack one batch for the device scorer.  Outputs (caller-allocated):
//   s2c      [n, L] int32 codes (pad 4)
//   fw_ws/rc_ws [n] int32 window starts (0 when wide/unused)
//   fw_ivg/rc_ivg [n, K, 2] int32 GLOBAL-coordinate intervals (end-exclusive)
//   flags    [n] int32 (kSkip / kHostOnly / kWide)
// A strand with no hits gets zero intervals (device returns HIM).
void mia_p1_prepare(void* h, int n, const char* arena, const int64_t* off,
                    const int32_t* lens, int L, int32_t* s2c, int32_t* fw_ws,
                    int32_t* rc_ws, int32_t* fw_ivg, int32_t* rc_ivg,
                    int32_t* flags) {
  Ctx* ctx = static_cast<Ctx*>(h);
  const int K = ctx->max_iv;
  const int64_t len1 = ctx->len1;
  IvBuf fb, rb;
  for (int b = 0; b < n; ++b) {
    const char* seq = arena + off[b];
    const int frag_len = lens[b];
    int32_t* fi = fw_ivg + (int64_t)b * K * 2;
    int32_t* ri = rc_ivg + (int64_t)b * K * 2;
    std::memset(fi, 0, sizeof(int32_t) * K * 2);
    std::memset(ri, 0, sizeof(int32_t) * K * 2);
    fw_ws[b] = rc_ws[b] = 0;
    int32_t* row = s2c + (int64_t)b * L;
    for (int i = 0; i < L; ++i)
      row[i] = i < frag_len ? base2inx((unsigned char)seq[i]) : 4;

    if (ctx->kmer_len < 0) {
      // no filtering: full-open both strands => wide path
      fi[0] = 0; fi[1] = (int32_t)len1;
      ri[0] = 0; ri[1] = (int32_t)len1;
      flags[b] = kWide;
      continue;
    }
    int num_f = 0, num_r = 0;
    fb.iv.clear(); rb.iv.clear();
    if (frag_len >= ctx->kmer_len) {
      if (ctx->fkpa)
        num_f = accumulate_bands(*ctx->fkpa, seq, frag_len, ctx->kmer_len,
                                 len1, false, fb);
      if (ctx->rkpa)
        num_r = accumulate_bands(*ctx->rkpa, seq, frag_len, ctx->kmer_len,
                                 len1, true, rb);
    }
    if (num_f + num_r == 0) {
      flags[b] = kSkip;
      continue;
    }
    if ((int)fb.iv.size() > K || (int)rb.iv.size() > K) {
      flags[b] = kHostOnly;
      continue;
    }
    bool wide = false;
    for (int s = 0; s < 2 && !wide; ++s) {
      const auto& iv = s == 0 ? fb.iv : rb.iv;
      if (iv.empty()) continue;
      int32_t lo = iv.front().first;
      int32_t hi = iv.back().second;
      int32_t ws = std::max(lo - 2, 0);
      if (hi - ws > ctx->win_w) wide = true;
    }
    for (int s = 0; s < 2; ++s) {
      const auto& iv = s == 0 ? fb.iv : rb.iv;
      int32_t* gi = s == 0 ? fi : ri;
      for (size_t t = 0; t < iv.size(); ++t) {
        gi[2 * t] = iv[t].first;
        gi[2 * t + 1] = iv[t].second;
      }
      if (!wide && !iv.empty()) {
        int32_t ws = std::max(iv.front().first - 2, 0);
        (s == 0 ? fw_ws : rc_ws)[b] = ws;
      }
    }
    flags[b] = wide ? kWide : 0;
  }
}

// Score-verified window DP + traceback for each read's winning strand.
// Mirrors jax_engine.windowed_exact_dp: solve over mask AND [lo, aec]; accept
// iff (best, aec) reproduce and the alignment start clears the window edge;
// else re-solve over the full k-mer-banded width.
// out_meta[b] = {best, abc, aec, pwlen}; strings at out_ref/out_frag + b*cap.
void mia_p1_finish(void* h, int n, const char* arena, const int64_t* off,
                   const int32_t* lens, const uint8_t* strand,
                   const uint8_t* smidx, const int32_t* dev_best,
                   const int32_t* dev_aec, const int32_t* ivg,
                   int K, int32_t* out_meta, char* out_ref, char* out_frag,
                   int64_t cap, int n_threads) {
  Ctx* ctx = static_cast<Ctx*>(h);
  const int64_t len1 = ctx->len1;

  mia_parallel_for(n, n_threads, [&](int b) {
    static thread_local std::vector<uint8_t> mask;
    static thread_local std::vector<int8_t> s2c;
    static thread_local std::vector<int32_t> score, trace;
    static thread_local std::vector<int32_t> hprl_v, hprs_v;
    const char* seq2 = arena + off[b];
    const int len2 = lens[b];
    const int side = strand[b] ? 1 : 0;
    const int8_t* s1c = strand[b] ? ctx->rc_c.data() : ctx->fw_c.data();
    const char* seq1 = strand[b] ? ctx->rc_s.data() : ctx->fw_s.data();
    const int32_t* sm = ctx->submat[smidx[b]].data();
    const int32_t msub = ctx->max_sub[smidx[b]];
    const int32_t* iv = ivg + (int64_t)b * K * 2;
    int32_t* meta = out_meta + (int64_t)b * 4;

    s2c.resize(len2);
    for (int i = 0; i < len2; ++i) s2c[i] = base2inx((unsigned char)seq2[i]);
    const int32_t* hprl = nullptr;
    const int32_t* hprs = nullptr;
    if (ctx->hp) {
      pop_hp(seq2, len2, hprl_v, hprs_v);
      hprl = hprl_v.data();
      hprs = hprs_v.data();
    }

    const int32_t best = dev_best[b];
    const int32_t aec = dev_aec[b];
    int64_t slack = 0;
    if ((int64_t)best < (int64_t)len2 * msub)
      slack = ((int64_t)len2 * msub - best) / kGep;
    const int64_t margin = (int64_t)len2 + slack + 16;
    const int32_t lo = (int32_t)std::max<int64_t>((int64_t)aec - margin, 0);

    // iterate: attempt 0 = verification window [lo, aec]; attempt 1 = full
    for (int attempt = 0; attempt < 2; ++attempt) {
      const bool windowed = attempt == 0 && (lo > 0 || aec < len1 - 1);
      if (attempt == 0 && !windowed) continue;  // degenerate: go straight to full
      // effective open-column range under (intervals AND [clip_lo, clip_hi])
      int32_t clip_lo = windowed ? lo : 0;
      int32_t clip_hi = windowed ? aec + 1 : (int32_t)len1;  // end-exclusive
      int32_t first_open = -1, last_open = -1;
      for (int t = 0; t < K; ++t) {
        int32_t a = std::max(iv[2 * t], clip_lo);
        int32_t e = std::min(iv[2 * t + 1], clip_hi);
        if (iv[2 * t + 1] <= 0) continue;  // unused slot
        if (a < e) {
          if (first_open < 0) first_open = a;
          last_open = e - 1;
        }
      }
      if (first_open < 0) {
        if (attempt == 0) continue;  // nothing open in window: full pass
        meta[0] = INT32_MIN / 2;     // fully masked (shouldn't happen for winners)
        meta[1] = meta[2] = meta[3] = 0;
        break;
      }
      const int32_t win_lo = std::max(first_open - 2, 0);
      const int32_t w = last_open - win_lo + 1;
      mask.assign(w, 0);
      for (int t = 0; t < K; ++t) {
        if (iv[2 * t + 1] <= 0) continue;
        int32_t a = std::max(std::max(iv[2 * t], clip_lo), win_lo);
        int32_t e = std::min(std::min(iv[2 * t + 1], clip_hi), win_lo + w);
        for (int32_t c = a; c < e; ++c) mask[c - win_lo] = 1;
      }
      score.resize((size_t)w * len2);
      trace.resize((size_t)w * len2);
      mia_dp_fill(s1c + win_lo, w, s2c.data(), len2, sm, mask.data(),
                  /*sg5=*/1, seq1 + win_lo, seq2,
                  ctx->hp ? ctx->hp_l[side].data() + win_lo : nullptr,
                  ctx->hp ? ctx->hp_s[side].data() + win_lo : nullptr,
                  hprl, hprs, win_lo, score.data(), trace.data());
      const int32_t* last = score.data() + (size_t)(len2 - 1) * w;
      int32_t aecl = 0;
      int32_t bs = last[0];
      for (int c = 1; c < w; ++c)
        if (last[c] > bs) { bs = last[c]; aecl = c; }
      int32_t abr, abc;
      int32_t pwlen = mia_dp_traceback(
          trace.data(), w, len2, len2 - 1, aecl, seq1 + win_lo, seq2,
          out_ref + (int64_t)b * cap, out_frag + (int64_t)b * cap, (int)cap,
          &abr, &abc);
      const int32_t aecg = aecl + win_lo;
      const int32_t abcg = abc + win_lo;
      if (windowed) {
        if (!(bs == best && aecg == aec && (lo == 0 || abcg > lo + 2)))
          continue;  // verification failed: fall back to the full width
      }
      meta[0] = bs;
      meta[1] = abcg;
      meta[2] = aecg;
      meta[3] = pwlen;
      break;
    }
  }, [&](int b) {
    // worker threw (e.g. bad_alloc): pwlen = -1 signals the caller to rerun
    // this read on its per-read host path
    int32_t* meta = out_meta + (int64_t)b * 4;
    meta[0] = kHim2;
    meta[1] = meta[2] = 0;
    meta[3] = -1;
  });
}

}  // extern "C"

namespace {

constexpr int32_t kFirstRoundCut = 2000;  // FIRST_ROUND_SCORE_CUTOFF, src/params.h:25

// Per-thread DP workspace (score/trace planes for both strands).
struct SolveBufs {
  std::vector<int32_t> score[2], trace[2];
  std::vector<uint8_t> mask[2];
  std::vector<int8_t> s2c;
};

// Banded fill over the merged-interval window of one strand; returns the
// window width (0 when the strand has no open columns).  best/aec are the
// last-row argmax in GLOBAL coordinates (earliest tie wins,
// src/mia.c:1278-1302).
int fill_strand(const Ctx* ctx, bool rc, const IvBuf& iv, const int8_t* s2c,
                int len2, const int32_t* sm, SolveBufs& bufs, int side,
                const char* seq2, const int32_t* hprl, const int32_t* hprs,
                int32_t* best, int32_t* aec, int32_t* win_lo_out) {
  if (iv.iv.empty()) return 0;
  const int8_t* s1c = rc ? ctx->rc_c.data() : ctx->fw_c.data();
  const char* s1 = rc ? ctx->rc_s.data() : ctx->fw_s.data();
  const int32_t win_lo = std::max(iv.iv.front().first - 2, 0);
  const int32_t w = iv.iv.back().second - win_lo;
  auto& mask = bufs.mask[side];
  mask.assign(w, 0);
  for (const auto& p : iv.iv)
    for (int32_t c = p.first; c < p.second; ++c) mask[c - win_lo] = 1;
  bufs.score[side].resize((size_t)w * len2);
  bufs.trace[side].resize((size_t)w * len2);
  const int hside = rc ? 1 : 0;
  mia_dp_fill(s1c + win_lo, w, s2c, len2, sm, mask.data(), /*sg5=*/1,
              s1 + win_lo, seq2,
              ctx->hp ? ctx->hp_l[hside].data() + win_lo : nullptr,
              ctx->hp ? ctx->hp_s[hside].data() + win_lo : nullptr,
              hprl, hprs,
              win_lo, bufs.score[side].data(), bufs.trace[side].data());
  const int32_t* last = bufs.score[side].data() + (size_t)(len2 - 1) * w;
  int a = 0;
  int32_t b = last[0];
  for (int c = 1; c < w; ++c)
    if (last[c] > b) { b = last[c]; a = c; }
  *best = b;
  *aec = a + win_lo;
  *win_lo_out = win_lo;
  return w;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Fully-native batched pass 1: per read, k-mer filter both strands
// (new_kmer_filter, src/kmer.c:239-331), banded DP fw+rc (dyn_prog,
// src/mia.c:740-981), strand pick + FIRST_ROUND_SCORE_CUTOFF gate
// (sg_align, src/map_align.c:1500-1614), traceback of the winner.
//
// out_meta[b] = {status, strand, best, abc, aec, pwlen} with status
//   0 = aligned (pw strings at b*cap),  1 = zero k-mer hits (read skipped),
//   2 = gate-rejected (best valid),     3 = needs host fallback (rare: the
//       traceback arena could overflow for this window; caller reruns the
//       per-read Python path).
// Threaded over reads; outputs are per-read slots so there is no contention.
void mia_p1_solve(void* h, int n, const char* arena, const int64_t* off,
                  const int32_t* lens, int distant_ref, int n_threads,
                  int32_t* out_meta, char* out_ref, char* out_frag,
                  int64_t cap) {
  Ctx* ctx = static_cast<Ctx*>(h);
  const int64_t len1 = ctx->len1;
  const int32_t* sm = ctx->submat[0].data();

  mia_parallel_for(n, n_threads, [&](int b) {
    static thread_local SolveBufs bufs;
    static thread_local IvBuf fb, rb;
    const char* seq = arena + off[b];
    const int len2 = lens[b];
    int32_t* meta = out_meta + (int64_t)b * 6;
    if (len2 <= 0) {
      meta[0] = 3;  // degenerate: per-read host path decides
      meta[1] = meta[2] = meta[3] = meta[4] = meta[5] = 0;
      return;
    }

    int num_f = 0, num_r = 0;
    fb.iv.clear();
    rb.iv.clear();
    if (ctx->kmer_len < 0) {
      // no -k filtering: both strands full-open (reference aligns all reads
      // full-width when the k-mer filter is off, src/mia_main.c:781-791)
      fb.iv.emplace_back(0, (int32_t)len1);
      rb.iv.emplace_back(0, (int32_t)len1);
      num_f = num_r = 1;
    } else if (len2 >= ctx->kmer_len) {
      if (ctx->fkpa)
        num_f = accumulate_bands(*ctx->fkpa, seq, len2, ctx->kmer_len, len1,
                                 false, fb);
      if (ctx->rkpa)
        num_r = accumulate_bands(*ctx->rkpa, seq, len2, ctx->kmer_len, len1,
                                 true, rb);
    }
    if (num_f + num_r == 0) {
      meta[0] = 1;
      meta[1] = meta[2] = meta[3] = meta[4] = meta[5] = 0;
      return;
    }

    bufs.s2c.resize(len2);
    for (int i = 0; i < len2; ++i)
      bufs.s2c[i] = base2inx((unsigned char)seq[i]);
    static thread_local std::vector<int32_t> hprl_v, hprs_v;
    const int32_t* hprl = nullptr;
    const int32_t* hprs = nullptr;
    if (ctx->hp) {
      pop_hp(seq, len2, hprl_v, hprs_v);
      hprl = hprl_v.data();
      hprs = hprs_v.data();
    }

    int32_t fbest = kHim2, faec = 0, fwlo = 0;
    int32_t rbest = kHim2, raec = 0, rwlo = 0;
    const int fw_w =
        fill_strand(ctx, false, fb, bufs.s2c.data(), len2, sm, bufs, 0,
                    seq, hprl, hprs, &fbest, &faec, &fwlo);
    const int rc_w =
        fill_strand(ctx, true, rb, bufs.s2c.data(), len2, sm, bufs, 1,
                    seq, hprl, hprs, &rbest, &raec, &rwlo);

    // strand pick: ties go rc (sg_align, src/map_align.c:1545-1556)
    const bool rc = !(fbest > rbest);
    const int32_t best = rc ? rbest : fbest;
    meta[1] = rc ? 1 : 0;
    meta[2] = best;
    if (best < kFirstRoundCut && !distant_ref) {
      meta[0] = 2;
      meta[3] = meta[4] = meta[5] = 0;
      return;
    }
    const int side = rc ? 1 : 0;
    const int w = rc ? rc_w : fw_w;
    const int wlo = rc ? rwlo : fwlo;
    const int32_t aecl = (rc ? raec : faec) - wlo;
    if ((int64_t)w + len2 + 2 > cap) {
      meta[0] = 3;  // arena could overflow: host fallback
      meta[3] = meta[4] = meta[5] = 0;
      return;
    }
    const char* s1 = (rc ? ctx->rc_s.data() : ctx->fw_s.data()) + wlo;
    int32_t abr, abc;
    const int32_t pwlen = mia_dp_traceback(
        bufs.trace[side].data(), w, len2, len2 - 1, aecl, s1, seq,
        out_ref + (int64_t)b * cap, out_frag + (int64_t)b * cap, (int)cap,
        &abr, &abc);
    meta[0] = 0;
    meta[3] = abc + wlo;
    meta[4] = (rc ? raec : faec);
    meta[5] = pwlen;
  }, [&](int b) {
    int32_t* meta = out_meta + (int64_t)b * 6;
    meta[0] = 3;  // worker threw (e.g. bad_alloc): per-read host fallback
    meta[1] = meta[2] = meta[3] = meta[4] = meta[5] = 0;
  });
}

// ---------------------------------------------------------------------------
// Batched per-iteration realignment: each strand-known read realigns in its
// [as-REALIGN_BUFFER, ae+REALIGN_BUFFER] window of the new consensus with
// its strand's PSSM (reiterate_assembly, src/mia_main.c:112-278).  The
// context's fw strand holds the (wrapped) consensus; smidx picks submat 0/1.
//
// wlo/whi are the end-exclusive window bounds the caller derived (including
// the full-reference fallback rule, src/mia_main.c:209-212).
// out_meta[b] = {status, best, abc, aec, pwlen} with abc/aec GLOBAL; status
// 0 = ok, 3 = host fallback (traceback arena too small for this window).
void mia_rei_solve(void* h, int n, const char* arena, const int64_t* off,
                   const int32_t* lens, const uint8_t* smidx,
                   const int32_t* wlo, const int32_t* whi, int n_threads,
                   int32_t* out_meta, char* out_ref, char* out_frag,
                   int64_t cap) {
  Ctx* ctx = static_cast<Ctx*>(h);

  mia_parallel_for(n, n_threads, [&](int b) {
    static thread_local SolveBufs bufs;
    const char* seq = arena + off[b];
    const int len2 = lens[b];
    int32_t* meta = out_meta + (int64_t)b * 5;
    const int32_t lo = wlo[b];
    const int w = whi[b] - lo;
    if (len2 <= 0 || w <= 0 || (int64_t)w + len2 + 2 > cap) {
      meta[0] = 3;
      meta[1] = meta[2] = meta[3] = meta[4] = 0;
      return;
    }
    bufs.s2c.resize(len2);
    for (int i = 0; i < len2; ++i)
      bufs.s2c[i] = base2inx((unsigned char)seq[i]);
    // hp arrays computed on the SLICE with slice-local starts, exactly like
    // the Python path's set_hp_cols after set_seq1(ref.seq[lo:hi]) — run
    // boundaries clip at the window edge
    static thread_local std::vector<int32_t> hcl, hcs, hrl, hrs;
    const int32_t* hp_args[4] = {nullptr, nullptr, nullptr, nullptr};
    if (ctx->hp) {
      pop_hp(ctx->fw_s.data() + lo, w, hcl, hcs);
      pop_hp(seq, len2, hrl, hrs);
      hp_args[0] = hcl.data();
      hp_args[1] = hcs.data();
      hp_args[2] = hrl.data();
      hp_args[3] = hrs.data();
    }
    bufs.mask[0].assign(w, 1);
    bufs.score[0].resize((size_t)w * len2);
    bufs.trace[0].resize((size_t)w * len2);
    // window-local fill: the Python path slices the reference string, so
    // column 0 here is window column 0 (win_lo = 0), exactly like
    // set_seq1(a, ref.seq[ref_start:ref_end]) in driver.reiterate_assembly
    mia_dp_fill(ctx->fw_c.data() + lo, w, bufs.s2c.data(), len2,
                ctx->submat[smidx[b]].data(), bufs.mask[0].data(), /*sg5=*/1,
                ctx->fw_s.data() + lo, seq, hp_args[0], hp_args[1],
                hp_args[2], hp_args[3], 0, bufs.score[0].data(),
                bufs.trace[0].data());
    const int32_t* last = bufs.score[0].data() + (size_t)(len2 - 1) * w;
    int aecl = 0;
    int32_t best = last[0];
    for (int c = 1; c < w; ++c)
      if (last[c] > best) { best = last[c]; aecl = c; }
    int32_t abr, abc;
    const int32_t pwlen = mia_dp_traceback(
        bufs.trace[0].data(), w, len2, len2 - 1, aecl,
        ctx->fw_s.data() + lo, seq, out_ref + (int64_t)b * cap,
        out_frag + (int64_t)b * cap, (int)cap, &abr, &abc);
    meta[0] = 0;
    meta[1] = best;
    meta[2] = abc + lo;
    meta[3] = aecl + lo;
    meta[4] = pwlen;
  }, [&](int b) {
    int32_t* meta = out_meta + (int64_t)b * 5;
    meta[0] = 3;  // worker threw: per-read host fallback
    meta[1] = meta[2] = meta[3] = meta[4] = 0;
  });
}

}  // extern "C"
