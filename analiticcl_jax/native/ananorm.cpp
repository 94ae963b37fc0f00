// Native host kernels for analiticcl-jax: batch greedy alphabet
// normalization and prime-product anagram values.
//
// The reference's only "native" role is Rust host code; here the host hot
// paths (lexicon ingestion at million-entry scale, SURVEY.md §7 stage 1) are
// C++ with a plain C ABI consumed via ctypes (analiticcl_jax/utils/native.py).
//
// Semantics mirror /root/reference/src/anahash.rs:14-81: at every byte
// position, alphabet elements are tried in file order (first match wins, even
// if a later element would match longer); unknown input advances one UTF-8
// codepoint and records the UNK class.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Element {
    std::string text;
    int32_t cls;
    int32_t order;  // global order of appearance
};

struct Matcher {
    int32_t n_classes = 0;
    // elements bucketed by first byte, each bucket in global order
    std::vector<Element> buckets[256];
    bool single_byte_only = true;
    int32_t bytemap[256];  // fast path when all elements are single ASCII bytes
};

inline int utf8_len(unsigned char c) {
    if (c < 0x80) return 1;
    if ((c >> 5) == 0x6) return 2;
    if ((c >> 4) == 0xe) return 3;
    if ((c >> 3) == 0x1e) return 4;
    return 1;  // invalid byte: treat as single
}

// Run fn(t0, t1) over [0, n) split across threads (outputs must be disjoint
// per range). Million-entry ingestion is the only caller that needs this;
// small batches stay single-threaded to avoid spawn overhead.
template <typename Fn>
void parallel_ranges(int32_t n, Fn fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int32_t nthreads = hw ? (int32_t)hw : 1;
    if (nthreads > 16) nthreads = 16;
    if (n < 65536 || nthreads <= 1) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> threads;
    int32_t chunk = (n + nthreads - 1) / nthreads;
    for (int32_t t = 0; t < nthreads; t++) {
        int32_t lo = t * chunk;
        int32_t hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        threads.emplace_back([=] { fn(lo, hi); });
    }
    for (auto& th : threads) th.join();
}

// Normalize texts [t0, t1) where text t spans bytes [starts[t], ends[t]).
// OutT is int32_t (general) or int8_t (alphabets with <= 126 classes, the
// common case — million-entry ingestion keeps 4x fewer bytes end-to-end).
template <typename OutT>
void normalize_range(Matcher* m, const char* texts, const int64_t* starts,
                     const int64_t* ends, int32_t t0, int32_t t1,
                     int32_t max_len, OutT* out_norms, int32_t* out_lens) {
    const int32_t unk = m->n_classes + 1;
    for (int32_t t = t0; t < t1; t++) {
        const char* s = texts + starts[t];
        int64_t n = ends[t] - starts[t];
        OutT* out = out_norms + (int64_t)t * max_len;
        int32_t len = 0;
        int64_t i = 0;
        while (i < n) {
            unsigned char c = (unsigned char)s[i];
            int32_t cls = -1;
            int64_t adv = 0;
            if (m->single_byte_only && c < 0x80) {
                cls = m->bytemap[c];
                adv = 1;
            } else {
                const std::vector<Element>& bucket = m->buckets[c];
                for (const Element& el : bucket) {
                    int64_t blen = (int64_t)el.text.size();
                    if (blen <= n - i && memcmp(el.text.data(), s + i, blen) == 0) {
                        cls = el.cls;
                        adv = blen;
                        break;
                    }
                }
            }
            if (cls < 0) {
                cls = unk;
                adv = utf8_len(c);
                if (adv > n - i) adv = n - i;
            }
            if (len < max_len) out[len] = (OutT)cls;
            len++;
            i += adv;
        }
        out_lens[t] = len;
    }
}

}  // namespace

extern "C" {

// Build a matcher. elements: concatenated UTF-8 bytes; elem_offsets has
// n_elements+1 entries; elem_class maps each element to its alphabet class.
void* ananorm_build(const char* elements, const int64_t* elem_offsets,
                    const int32_t* elem_class, int32_t n_elements,
                    int32_t n_classes) {
    Matcher* m = new Matcher();
    m->n_classes = n_classes;
    for (int i = 0; i < 256; i++) m->bytemap[i] = -1;
    for (int32_t e = 0; e < n_elements; e++) {
        int64_t start = elem_offsets[e], end = elem_offsets[e + 1];
        if (end <= start) continue;
        Element el;
        el.text.assign(elements + start, elements + end);
        el.cls = elem_class[e];
        el.order = e;
        unsigned char first = (unsigned char)el.text[0];
        if (el.text.size() != 1 || first >= 0x80) m->single_byte_only = false;
        if (el.text.size() == 1 && first < 0x80 && m->bytemap[first] < 0)
            m->bytemap[first] = el.cls;
        m->buckets[first].push_back(std::move(el));
    }
    return m;
}

void ananorm_free(void* handle) { delete static_cast<Matcher*>(handle); }

// Normalize a batch of texts. texts: concatenated UTF-8; text_offsets has
// n_texts+1 entries. Outputs: out_norms [n_texts, max_len] int32 (0-padded),
// out_lens [n_texts] int32 (true length, possibly > max_len, in which case the
// norm is truncated). UNK class index = n_classes + 1 (anahash.rs:76).
void ananorm_normalize_batch(void* handle, const char* texts,
                             const int64_t* text_offsets, int32_t n_texts,
                             int32_t max_len, int32_t* out_norms,
                             int32_t* out_lens) {
    Matcher* m = static_cast<Matcher*>(handle);
    // contiguous segments: starts = offsets[0..n), ends = offsets[1..n+1)
    parallel_ranges(n_texts, [=](int32_t t0, int32_t t1) {
        normalize_range(m, texts, text_offsets, text_offsets + 1, t0, t1,
                        max_len, out_norms, out_lens);
    });
}

// Normalize texts delimited by explicit [starts[t], ends[t]) byte ranges
// (non-contiguous segments — e.g. newline-separated blobs where the
// separator byte must not be normalized). Threaded for ingestion-scale
// batches; first match wins exactly as in ananorm_normalize_batch.
void ananorm_normalize_se(void* handle, const char* texts,
                          const int64_t* starts, const int64_t* ends,
                          int32_t n_texts, int32_t max_len,
                          int32_t* out_norms, int32_t* out_lens) {
    Matcher* m = static_cast<Matcher*>(handle);
    parallel_ranges(n_texts, [=](int32_t t0, int32_t t1) {
        normalize_range(m, texts, starts, ends, t0, t1, max_len, out_norms,
                        out_lens);
    });
}

// int8 output variant (valid when every class index incl. UNK fits int8)
void ananorm_normalize_se8(void* handle, const char* texts,
                           const int64_t* starts, const int64_t* ends,
                           int32_t n_texts, int32_t max_len,
                           int8_t* out_norms, int32_t* out_lens) {
    Matcher* m = static_cast<Matcher*>(handle);
    parallel_ranges(n_texts, [=](int32_t t0, int32_t t1) {
        normalize_range(m, texts, starts, ends, t0, t1, max_len, out_norms,
                        out_lens);
    });
}

// Count vectors from normalized strings: out_counts [n_texts, n_slots] uint8
// (saturating at 255). Norm entries >= unk_norm_index (or out of range) land
// in the UNK slot n_slots-1 (anahash.rs:42 convention).
extern "C++" {
template <typename NT>
static void counts_batch_impl(const NT* norms, const int32_t* lens,
                              int32_t n_texts, int32_t max_len,
                              int32_t n_slots, uint8_t* out_counts) {
    parallel_ranges(n_texts, [=](int32_t r0, int32_t r1) {
        for (int32_t t = r0; t < r1; t++) {
            const NT* nm = norms + (int64_t)t * max_len;
            uint8_t* out = out_counts + (int64_t)t * n_slots;
            memset(out, 0, n_slots);
            int32_t len = lens[t] < max_len ? lens[t] : max_len;
            for (int32_t k = 0; k < len; k++) {
                int32_t cls = (int32_t)nm[k];
                if (cls < 0 || cls >= n_slots) cls = n_slots - 1;
                if (out[cls] != 255) out[cls]++;
            }
        }
    });
}
}  // extern "C++"

void ananorm_counts_batch(const int32_t* norms, const int32_t* lens,
                          int32_t n_texts, int32_t max_len, int32_t n_slots,
                          uint8_t* out_counts) {
    counts_batch_impl(norms, lens, n_texts, max_len, n_slots, out_counts);
}

void ananorm_counts_batch8(const int8_t* norms, const int32_t* lens,
                           int32_t n_texts, int32_t max_len, int32_t n_slots,
                           uint8_t* out_counts) {
    counts_batch_impl(norms, lens, n_texts, max_len, n_slots, out_counts);
}

// Prime-product anagram values as 64-byte big-endian integers (for exact
// canonical sorting; reference sorts anagram values numerically,
// lib.rs:222-245 / BTreeSet). norms/lens as produced above; primes has
// n_classes+1 entries (last = UNK prime, anahash.rs:42). Values overflowing
// 512 bits saturate to all-0xFF (sorts last; such words are >160 chars).
extern "C++" {
template <typename NT>
static void anavalue_batch_impl(const NT* norms, const int32_t* lens,
                                int32_t n_texts, int32_t max_len,
                                const uint32_t* primes, int32_t n_primes,
                                int32_t unk_norm_index, uint8_t* out_bytes) {
    const int NB = 64;  // bytes per value
    const int NW = 16;  // 32-bit words
    parallel_ranges(n_texts, [=](int32_t r0, int32_t r1) {
    std::vector<uint32_t> acc(NW);
    for (int32_t t = r0; t < r1; t++) {
        std::fill(acc.begin(), acc.end(), 0u);
        acc[0] = 1u;
        bool overflow = false;
        const NT* nm = norms + (int64_t)t * max_len;
        int32_t len = lens[t] < max_len ? lens[t] : max_len;
        for (int32_t k = 0; k < len && !overflow; k++) {
            int32_t cls = (int32_t)nm[k];
            if (cls == unk_norm_index) cls = n_primes - 1;  // UNK slot
            if (cls < 0 || cls >= n_primes) cls = n_primes - 1;
            uint64_t p = primes[cls];
            uint64_t carry = 0;
            for (int w = 0; w < NW; w++) {
                uint64_t v = (uint64_t)acc[w] * p + carry;
                acc[w] = (uint32_t)v;
                carry = v >> 32;
            }
            if (carry) overflow = true;
        }
        uint8_t* out = out_bytes + (int64_t)t * NB;
        if (overflow) {
            memset(out, 0xFF, NB);
        } else {
            // big-endian for lexicographic = numeric comparison
            for (int w = 0; w < NW; w++) {
                uint32_t v = acc[NW - 1 - w];
                out[w * 4 + 0] = (uint8_t)(v >> 24);
                out[w * 4 + 1] = (uint8_t)(v >> 16);
                out[w * 4 + 2] = (uint8_t)(v >> 8);
                out[w * 4 + 3] = (uint8_t)v;
            }
        }
    }
    });
}
}  // extern "C++"

void ananorm_anavalue_batch(const int32_t* norms, const int32_t* lens,
                            int32_t n_texts, int32_t max_len,
                            const uint32_t* primes, int32_t n_primes,
                            int32_t unk_norm_index, uint8_t* out_bytes) {
    anavalue_batch_impl(norms, lens, n_texts, max_len, primes, n_primes,
                        unk_norm_index, out_bytes);
}

void ananorm_anavalue_batch8(const int8_t* norms, const int32_t* lens,
                             int32_t n_texts, int32_t max_len,
                             const uint32_t* primes, int32_t n_primes,
                             int32_t unk_norm_index, uint8_t* out_bytes) {
    anavalue_batch_impl(norms, lens, n_texts, max_len, primes, n_primes,
                        unk_norm_index, out_bytes);
}

// ---------------------------------------------------------------------------
// Shortest edit scripts (sesdiff-equivalent; see analiticcl_jax/editscript.py
// for the reference Python implementation whose traceback order this mirrors
// exactly: identity preferred, then insertion, then deletion — which emits
// deletions before insertions in forward order).
// Output encoding: one byte op ('=', '-', '+') + uvarint byte-length + UTF-8
// run bytes, repeated; total length returned.
// ---------------------------------------------------------------------------

namespace {

// decode UTF-8 into codepoint start offsets
static void utf8_offsets(const char* s, int64_t n, std::vector<int32_t>& offs) {
    offs.clear();
    int64_t i = 0;
    while (i < n) {
        offs.push_back((int32_t)i);
        i += utf8_len((unsigned char)s[i]);
        if (i > n) i = n;
    }
    offs.push_back((int32_t)n);
}

}  // namespace

// Computes the shortest edit script from a to b. out receives the encoded
// instruction stream (caller provides capacity out_cap); returns the encoded
// length, or -1 if out_cap is too small.
int64_t ananorm_edit_script(const char* a, int64_t an, const char* b,
                            int64_t bn, char* out, int64_t out_cap) {
    std::vector<int32_t> ao, bo;
    utf8_offsets(a, an, ao);
    utf8_offsets(b, bn, bo);
    int n = (int)ao.size() - 1;
    int m = (int)bo.size() - 1;

    // strip common prefix / suffix (in codepoints)
    int pre = 0;
    while (pre < n && pre < m) {
        int la = ao[pre + 1] - ao[pre], lb = bo[pre + 1] - bo[pre];
        if (la != lb || memcmp(a + ao[pre], b + bo[pre], la) != 0) break;
        pre++;
    }
    int suf = 0;
    while (suf < n - pre && suf < m - pre) {
        int ia = n - 1 - suf, ib = m - 1 - suf;
        int la = ao[ia + 1] - ao[ia], lb = bo[ib + 1] - bo[ib];
        if (la != lb || memcmp(a + ao[ia], b + bo[ib], la) != 0) break;
        suf++;
    }
    int cn = n - pre - suf, cm = m - pre - suf;

    // LCS-alignment DP over the core
    std::vector<int32_t> dp((int64_t)(cn + 1) * (cm + 1));
    auto D = [&](int i, int j) -> int32_t& { return dp[(int64_t)i * (cm + 1) + j]; };
    for (int i = 0; i <= cn; i++) D(i, 0) = i;
    for (int j = 0; j <= cm; j++) D(0, j) = j;
    for (int i = 1; i <= cn; i++) {
        int ia = pre + i - 1;
        int la = ao[ia + 1] - ao[ia];
        for (int j = 1; j <= cm; j++) {
            int ib = pre + j - 1;
            int lb = bo[ib + 1] - bo[ib];
            if (la == lb && memcmp(a + ao[ia], b + bo[ib], la) == 0) {
                D(i, j) = D(i - 1, j - 1);
            } else {
                int32_t d = D(i - 1, j) < D(i, j - 1) ? D(i - 1, j) : D(i, j - 1);
                D(i, j) = d + 1;
            }
        }
    }

    // traceback (reverse order); ops: 0=identity char from a, 1=insert char
    // from b, 2=delete char from a — consuming insertions first puts
    // deletions first in forward order (editscript.py:_diff_core)
    std::vector<std::pair<char, int32_t>> rev;  // (op, codepoint index in a/b)
    int i = cn, j = cm;
    while (i > 0 || j > 0) {
        int ia = pre + i - 1, ib = pre + j - 1;
        bool eq = false;
        if (i > 0 && j > 0) {
            int la = ao[ia + 1] - ao[ia], lb = bo[ib + 1] - bo[ib];
            eq = (la == lb && memcmp(a + ao[ia], b + bo[ib], la) == 0 &&
                  D(i, j) == D(i - 1, j - 1));
        }
        if (eq) {
            rev.push_back({'=', ia});
            i--; j--;
        } else if (j > 0 && D(i, j) == D(i, j - 1) + 1) {
            rev.push_back({'+', ib});
            j--;
        } else {
            rev.push_back({'-', ia});
            i--;
        }
    }

    // emit: prefix identity, core (reversed), suffix identity; aggregate runs
    std::string buf;
    char cur_op = 0;
    std::string cur_text;
    auto flush = [&]() {
        if (cur_op == 0 || cur_text.empty()) { cur_op = 0; cur_text.clear(); return; }
        buf.push_back(cur_op);
        uint64_t len = cur_text.size();
        while (len >= 0x80) { buf.push_back((char)(0x80 | (len & 0x7F))); len >>= 7; }
        buf.push_back((char)len);
        buf += cur_text;
        cur_op = 0;
        cur_text.clear();
    };
    auto emit = [&](char op, const char* p, int l) {
        if (op != cur_op) { flush(); cur_op = op; }
        cur_text.append(p, l);
    };
    if (pre) emit('=', a, ao[pre]);
    for (auto it = rev.rbegin(); it != rev.rend(); ++it) {
        char op = it->first;
        int32_t idx = it->second;
        if (op == '+') emit('+', b + bo[idx], bo[idx + 1] - bo[idx]);
        else emit(op, a + ao[idx], ao[idx + 1] - ao[idx]);
    }
    if (suf) emit('=', a + ao[n - suf], an - ao[n - suf]);
    flush();

    if ((int64_t)buf.size() > out_cap) return -1;
    memcpy(out, buf.data(), buf.size());
    return (int64_t)buf.size();
}

// Batch variant: one input `a` against n_b candidates (concatenated in bs
// with bo offsets, n_b+1 entries). Encodings are written back-to-back into
// out; out_offsets (n_b+1 entries) receives the boundaries. Returns total
// bytes or -1 if out_cap is too small.
int64_t ananorm_edit_script_batch(const char* a, int64_t an, const char* bs,
                                  const int64_t* bo, int32_t n_b, char* out,
                                  int64_t out_cap, int64_t* out_offsets) {
    int64_t pos = 0;
    out_offsets[0] = 0;
    for (int32_t k = 0; k < n_b; k++) {
        int64_t r = ananorm_edit_script(a, an, bs + bo[k], bo[k + 1] - bo[k],
                                        out + pos, out_cap - pos);
        if (r < 0) return -1;
        pos += r;
        out_offsets[k + 1] = pos;
    }
    return pos;
}

// --------------------------------------------------------------------------
// Confusable matching against edit scripts (mirrors confusables.rs:47-128 /
// analiticcl_jax/confusables.py). A confusable set is compiled once from a
// flat blob; weights for a batch of candidates compute in one call.
// Blob layout (little-endian):
//   u32 n_confusables
//   per confusable: f64 weight, u8 strictbegin, u8 strictend, u32 n_instr,
//     per instruction: u8 op ('='/'+'/'-'), u32 n_options,
//       per option: u32 len, bytes
// --------------------------------------------------------------------------

namespace {

struct ConfInstr {
    char op;
    std::vector<std::string> options;
    // per-option byte masks (bit = byte & 63) for the cheap necessary-
    // condition prefilter: an option can only occur in a text whose mask
    // covers it
    std::vector<uint64_t> opt_masks;
};

struct Conf {
    double weight;
    bool strictbegin, strictend;
    std::vector<ConfInstr> instr;
};

struct ConfSet {
    std::vector<Conf> confusables;
};

static inline uint64_t byte_mask(const char* s, int64_t n) {
    uint64_t m = 0;
    for (int64_t i = 0; i < n; i++)
        m |= 1ull << (((unsigned char)s[i]) & 63);
    return m;
}

// Necessary condition for confusable c to match ANY edit script a -> b:
// every instruction must have at least one option whose bytes all occur in
// the relevant side ('-' from a, '+' from b, '=' from both). False means
// the weight is certainly 1, so the edit script need not be computed.
static bool conf_possible(const Conf& c, uint64_t am, uint64_t bm) {
    for (const auto& ins : c.instr) {
        uint64_t need_in;
        if (ins.op == '-') need_in = am;
        else if (ins.op == '+') need_in = bm;
        else need_in = am & bm;
        bool ok = false;
        for (uint64_t om : ins.opt_masks) {
            if ((om & ~need_in) == 0) { ok = true; break; }
        }
        if (!ok) return false;
    }
    return true;
}

struct Run {
    char op;
    const char* text;
    int64_t len;
};

static bool ends_with(const char* s, int64_t n, const std::string& t) {
    return (int64_t)t.size() <= n &&
           memcmp(s + n - t.size(), t.data(), t.size()) == 0;
}

static bool starts_with(const char* s, int64_t n, const std::string& t) {
    return (int64_t)t.size() <= n && memcmp(s, t.data(), t.size()) == 0;
}

static bool equals(const char* s, int64_t n, const std::string& t) {
    return (int64_t)t.size() == n && memcmp(s, t.data(), t.size()) == 0;
}

static bool instruction_matches(const ConfInstr& ins, const Run& ref,
                                size_t matches, size_t l) {
    if ((ins.op == '+' || ins.op == '-') && ref.op == ins.op) {
        for (const auto& s : ins.options)
            if (ends_with(ref.text, ref.len, s)) return true;
        return false;
    }
    if (ins.op == '=' && ref.op == '=') {
        for (const auto& s : ins.options) {
            if (matches == 0 && matches == l - 1) {
                if (equals(ref.text, ref.len, s)) return true;
            } else if (matches == 0) {
                if (ends_with(ref.text, ref.len, s)) return true;
            } else if (matches == l - 1) {
                if (starts_with(ref.text, ref.len, s)) return true;
            } else if (equals(ref.text, ref.len, s)) {
                return true;
            }
        }
        return false;
    }
    return false;
}

static bool found_in(const Conf& c, const std::vector<Run>& runs) {
    size_t l = c.instr.size();
    size_t matches = 0;
    for (size_t i = 0; i < runs.size(); i++) {
        if (matches >= l) break;
        if (!instruction_matches(c.instr[matches], runs[i], matches, l)) {
            matches = 0;
            if (c.strictbegin) return false;
            continue;
        }
        matches++;
        if (matches == l) {
            if (c.strictend) return i == runs.size() - 1;
            return true;
        }
    }
    return false;
}

static void decode_runs(const char* data, int64_t n, std::vector<Run>& runs) {
    runs.clear();
    int64_t i = 0;
    while (i < n) {
        char op = data[i++];
        uint64_t len = 0;
        int shift = 0;
        while (true) {
            unsigned char b = (unsigned char)data[i++];
            len |= (uint64_t)(b & 0x7F) << shift;
            if (b < 0x80) break;
            shift += 7;
        }
        runs.push_back({op, data + i, (int64_t)len});
        i += (int64_t)len;
    }
}

}  // namespace

void* ananorm_confusables_build(const char* blob, int64_t n) {
    const unsigned char* p = (const unsigned char*)blob;
    const unsigned char* end = p + n;
    auto rd_u32 = [&]() {
        uint32_t v;
        memcpy(&v, p, 4);
        p += 4;
        return v;
    };
    ConfSet* set = new ConfSet();
    uint32_t nc = rd_u32();
    set->confusables.reserve(nc);
    for (uint32_t c = 0; c < nc && p < end; c++) {
        Conf conf;
        memcpy(&conf.weight, p, 8);
        p += 8;
        conf.strictbegin = *p++ != 0;
        conf.strictend = *p++ != 0;
        uint32_t ni = rd_u32();
        conf.instr.reserve(ni);
        for (uint32_t k = 0; k < ni; k++) {
            ConfInstr ins;
            ins.op = (char)*p++;
            uint32_t no = rd_u32();
            for (uint32_t o = 0; o < no; o++) {
                uint32_t len = rd_u32();
                ins.options.emplace_back((const char*)p, len);
                ins.opt_masks.push_back(byte_mask((const char*)p, len));
                p += len;
            }
            conf.instr.push_back(std::move(ins));
        }
        set->confusables.push_back(std::move(conf));
    }
    return set;
}

void ananorm_confusables_free(void* handle) {
    delete (ConfSet*)handle;
}

// Weights for one input against n_b candidates: computes each edit script
// natively and multiplies the weights of matching confusables.
int64_t ananorm_confusable_weights(void* handle, const char* a, int64_t an,
                                   const char* bs, const int64_t* bo,
                                   int32_t n_b, double* out_weights) {
    ConfSet* set = (ConfSet*)handle;
    std::vector<char> buf;
    std::vector<Run> runs;
    uint64_t am = byte_mask(a, an);
    for (int32_t k = 0; k < n_b; k++) {
        int64_t bn = bo[k + 1] - bo[k];
        uint64_t bm = byte_mask(bs + bo[k], bn);
        bool any = false;
        for (const auto& c : set->confusables)
            if (conf_possible(c, am, bm)) { any = true; break; }
        if (!any) {  // no confusable can match: weight certainly 1
            out_weights[k] = 1.0;
            continue;
        }
        int64_t cap = 2 * (an + bn) + 64;
        if ((int64_t)buf.size() < cap) buf.resize(cap);
        int64_t r = ananorm_edit_script(a, an, bs + bo[k], bn, buf.data(),
                                        (int64_t)buf.size());
        if (r < 0) return -1;
        decode_runs(buf.data(), r, runs);
        double w = 1.0;
        for (const auto& c : set->confusables)
            if (conf_possible(c, am, bm) && found_in(c, runs)) w *= c.weight;
        out_weights[k] = w;
    }
    return 0;
}

// Many (input, candidate) pairs in ONE call: pair k matches input
// a_idx[k] (byte range a_off[i]..a_off[i+1] of as_blob) against candidate k
// (b_off[k]..b_off[k+1] of bs_blob). The device pipeline's late-confusables
// fast path rescopes a whole batch's cropped survivors with a single
// library crossing instead of one per query.
int64_t ananorm_confusable_weights_multi(void* handle, const char* as_blob,
                                         const int64_t* a_off,
                                         const int32_t* a_idx,
                                         const char* bs_blob,
                                         const int64_t* b_off, int32_t n_b,
                                         double* out_weights) {
    ConfSet* set = (ConfSet*)handle;
    std::vector<char> buf;
    std::vector<Run> runs;
    int32_t last_a = -1;
    uint64_t am = 0;
    for (int32_t k = 0; k < n_b; k++) {
        int32_t i = a_idx[k];
        const char* a = as_blob + a_off[i];
        int64_t an = a_off[i + 1] - a_off[i];
        if (i != last_a) {  // inputs arrive grouped per query
            am = byte_mask(a, an);
            last_a = i;
        }
        int64_t bn = b_off[k + 1] - b_off[k];
        uint64_t bm = byte_mask(bs_blob + b_off[k], bn);
        bool any = false;
        for (const auto& c : set->confusables)
            if (conf_possible(c, am, bm)) { any = true; break; }
        if (!any) {
            out_weights[k] = 1.0;
            continue;
        }
        int64_t cap = 2 * (an + bn) + 64;
        if ((int64_t)buf.size() < cap) buf.resize(cap);
        int64_t r = ananorm_edit_script(a, an, bs_blob + b_off[k], bn,
                                        buf.data(), (int64_t)buf.size());
        if (r < 0) return -1;
        decode_runs(buf.data(), r, runs);
        double w = 1.0;
        for (const auto& c : set->confusables)
            if (conf_possible(c, am, bm) && found_in(c, runs)) w *= c.weight;
        out_weights[k] = w;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Whole-batch ranking tail (score + sort + tie-aware crop + cutoff).
//
// Bit-equal port of ops/rank_batch.py::rank_fast_batch plus the scoring /
// canonical-reorder prologue of DevicePipeline.collect (ops/pipeline.py):
// all float work is IEEE double in the exact same operation order as the
// numpy expressions, so results are bit-identical to the Python tail (which
// is itself pinned against the scalar oracle; reference semantics
// lib.rs:1405-1653). The numpy path remains as fallback and test oracle.
//
// Inputs are the raw device-transfer arrays (device-row candidates, uint8
// metrics, seg non-decreasing). The function:
//   1. maps device rows -> canonical rows and sorts each segment's pairs by
//      canonical row (stable), mirroring np.lexsort((o_c, o_q));
//   2. scores each pair in f64 (same expression order as collect());
//   3. ranks each ELIGIBLE segment (no expandable pairs) exactly like
//      rank_fast_batch (threshold, freq normalization with device floors,
//      blended sort, tie-aware crop incl. the early_cutoff quirk, relative
//      cutoff threshold unless stop_before_cutoff);
//   4. reports ineligible segments (expandable pairs present) via out_elig
//      plus the sorted permutation/bounds so the host can run its exact
//      object path on just those rows.
// Returns the survivor count, or -1 on argument errors.
extern "C" int64_t ananorm_rank_tail(
    int32_t n_pairs, int32_t nseg,
    const int32_t* o_q, const int32_t* o_c_dev,
    const uint8_t* o_ld, const uint8_t* o_lcs, const uint8_t* o_pf,
    const uint8_t* o_sf, const uint8_t* o_case,
    const int64_t* canon_of, int32_t ni_pad,
    const int32_t* q_lens,
    const double* freq_tab, const uint8_t* has_var,
    const int64_t* vocab_ids_tab, int32_t index_size,
    const uint32_t* floors_u32,
    double w_ld, double w_lcs, double w_prefix, double w_suffix,
    double w_case, double w_sum,
    double score_threshold, double cutoff_threshold, double freq_weight,
    int32_t max_matches, int32_t have_freq, int32_t stop_before_cutoff,
    int32_t* out_seg, int64_t* out_vid, double* out_ds, double* out_fq,
    uint8_t* out_elig, int32_t* out_perm, int32_t* out_bounds) {
    if (n_pairs < 0 || nseg <= 0 || index_size <= 0) return -1;

    // --- segment bounds over the o_q column ---
    // (o_q need NOT be grouped: the sharded pipeline concatenates per-shard
    // segments, so the same segment id recurs; a stable counting-sort
    // scatter groups pairs exactly like np.lexsort((o_c, o_q)) would)
    for (int32_t s = 0; s <= nseg; s++) out_bounds[s] = 0;
    for (int32_t p = 0; p < n_pairs; p++) {
        int32_t s = o_q[p];
        if (s < 0 || s >= nseg) return -1;
        out_bounds[s + 1]++;
    }
    for (int32_t s = 0; s < nseg; s++) out_bounds[s + 1] += out_bounds[s];

    // --- canonical rows + per-segment stable sort by canonical row ---
    std::vector<int64_t> canon((size_t)n_pairs);
    for (int32_t p = 0; p < n_pairs; p++) {
        int32_t d = o_c_dev[p];
        if (d > ni_pad - 1) d = ni_pad - 1;
        if (d < 0) d = 0;
        canon[p] = canon_of[d];
    }
    {
        std::vector<int32_t> cur(out_bounds, out_bounds + nseg);
        for (int32_t p = 0; p < n_pairs; p++) out_perm[cur[o_q[p]]++] = p;
    }
    for (int32_t s = 0; s < nseg; s++) {
        int32_t lo = out_bounds[s], hi = out_bounds[s + 1];
        if (hi - lo > 1)
            std::stable_sort(out_perm + lo, out_perm + hi,
                             [&](int32_t a, int32_t b) {
                                 return canon[a] < canon[b];
                             });
    }

    // --- f64 scoring, same expression order as collect() ---
    std::vector<double> score((size_t)n_pairs), pfreq((size_t)n_pairs);
    std::vector<int64_t> ccan((size_t)n_pairs);
    std::vector<uint8_t> elig((size_t)nseg, 1);
    for (int32_t s = 0; s < nseg; s++) {
        for (int32_t r = out_bounds[s]; r < out_bounds[s + 1]; r++) {
            int32_t p = out_perm[r];
            int64_t c = canon[p];
            int64_t c_safe = c < (int64_t)index_size ? c : index_size - 1;
            if (c_safe < 0) c_safe = 0;
            ccan[r] = c_safe;
            double qlen = (double)q_lens[s];
            if (qlen < 1.0) qlen = 1.0;
            double ld = (double)o_ld[p];
            double ds = ld > qlen ? 0.0 : 1.0 - ld / qlen;
            double sc = (w_ld * ds + (w_lcs * (double)o_lcs[p]) / qlen +
                         (w_prefix * (double)o_pf[p]) / qlen +
                         (w_suffix * (double)o_sf[p]) / qlen +
                         (o_case[p] ? w_case : 0.0)) /
                        w_sum;
            score[r] = sc;
            pfreq[r] = freq_tab ? freq_tab[c_safe] : 1.0;
            if (has_var && has_var[c_safe]) elig[s] = 0;
        }
    }

    // --- per-segment rank (rank_fast_batch semantics) ---
    int64_t out_n = 0;
    std::vector<int32_t> kept;
    std::vector<int32_t> ord;
    for (int32_t s = 0; s < nseg; s++) {
        out_elig[s] = elig[s];
        if (!elig[s]) continue;
        int32_t lo = out_bounds[s], hi = out_bounds[s + 1];
        kept.clear();
        for (int32_t r = lo; r < hi; r++)
            if (score[r] >= score_threshold) kept.push_back(r);
        if (kept.empty()) continue;
        // frequency normalization (max over above-threshold + device floor)
        double floor_f = (double)floors_u32[s];
        double max_freq;
        if (have_freq) {
            double seg_max = 0.0;
            for (int32_t r : kept)
                if (pfreq[r] > seg_max) seg_max = pfreq[r];
            max_freq = seg_max > floor_f ? seg_max : floor_f;
        } else {
            max_freq = 1.0 > floor_f ? 1.0 : floor_f;
        }
        double denom = max_freq > 0.0 ? max_freq : 1.0;
        int32_t n = (int32_t)kept.size();
        ord.resize(n);
        for (int32_t i = 0; i < n; i++) ord[i] = i;
        // freqn / blended per kept pair (freqn = freq / denom, f64)
        std::vector<double> freqn(n), s_key(n), dsv(n);
        for (int32_t i = 0; i < n; i++) {
            freqn[i] = pfreq[kept[i]] / denom;
            dsv[i] = score[kept[i]];
        }
        double fw = freq_weight;
        if (fw > 0.0) {
            for (int32_t i = 0; i < n; i++)
                s_key[i] = (dsv[i] + fw * freqn[i]) / (1.0 + fw);
            std::stable_sort(ord.begin(), ord.end(),
                             [&](int32_t a, int32_t b) {
                                 return s_key[a] > s_key[b];
                             });
        } else {
            for (int32_t i = 0; i < n; i++) s_key[i] = dsv[i];
            std::stable_sort(
                ord.begin(), ord.end(), [&](int32_t a, int32_t b) {
                    if (dsv[a] != dsv[b]) return dsv[a] > dsv[b];
                    return freqn[a] > freqn[b];
                });
        }
        // sorted views
        std::vector<double> ss(n), dd(n), ff(n);
        std::vector<int32_t> rr(n);
        for (int32_t i = 0; i < n; i++) {
            ss[i] = s_key[ord[i]];
            dd[i] = dsv[ord[i]];
            ff[i] = freqn[ord[i]];
            rr[i] = kept[ord[i]];
        }
        // tie-aware crop at max_matches (rank_batch.py:93-137)
        int64_t end = n;
        int32_t mm = max_matches;
        if (mm > 0 && n > mm) {
            double last_sc = ss[mm - 1];
            double cropped_sc = ss[mm];
            if (cropped_sc < last_sc) {
                end = mm;
            } else {
                // hard case: first rank with dist < cropped, eq ranks below
                int64_t first_lt = -1;
                for (int32_t r = 0; r < n; r++)
                    if (dd[r] < cropped_sc) { first_lt = r; break; }
                int64_t limit = first_lt >= 0 ? first_lt : n;
                int64_t e1 = -1, e2 = -1;
                for (int32_t r = 0; r < (int32_t)limit; r++)
                    if (dd[r] == cropped_sc) {
                        if (e1 < 0) e1 = r;
                        else if (e2 < 0) { e2 = r; break; }
                    }
                int64_t early;
                if (e1 >= 0 && e1 != 0) early = e1;
                else if (e2 >= 0) early = e2;
                else early = 0;
                int64_t late = first_lt >= 0 ? first_lt : 0;
                if (early > 0) end = early + 1;
                else if (late > 0) end = late + 1;
                // else keep all
            }
        }
        // relative cutoff threshold (rank_batch.py:139-152)
        if (cutoff_threshold >= 1.0 && !stop_before_cutoff) {
            double best = ss[0];
            double lim = best / cutoff_threshold;
            for (int64_t r = 1; r < end; r++)
                if (ss[r] <= lim) { end = r; break; }
        }
        for (int64_t r = 0; r < end; r++) {
            out_seg[out_n] = s;
            out_vid[out_n] = vocab_ids_tab[ccan[rr[r]]];
            out_ds[out_n] = dd[r];
            out_fq[out_n] = ff[r];
            out_n++;
        }
    }
    return out_n;
}

// ---------------------------------------------------------------------------
// Search-mode unit segmentation (the native core of
// models/search_fast.prepare_unit; reference semantics search.rs:190-313 +
// lib.rs:1817-1861).
//
// Input: the unit's texts as one ASCII byte blob with [n_texts+1] offsets
// (the Python caller gates on str.isascii(), where is_alphabetic() reduces
// to [A-Za-z]). Output: per-text boundary runs, hard-batch chains, ngram
// segments with the trailing-segment internal-boundaries quirk, and the
// deduplicated lookup-key table (first-appearance order) that the segments'
// q column indexes. All offsets are text-local. Returns 0, or -1 when an
// output cap would overflow (caller falls back to the Python path).
extern "C" int64_t ananorm_segment(
    const uint8_t* data, int32_t n_texts, const int64_t* text_off,
    int32_t max_ngram,
    int32_t* b_text_off,  // [n_texts+1] per-text boundary prefix counts
    int32_t* bb, int32_t* be,  // [caps_b]
    int32_t* c_text_off,  // [n_texts+1] per-text chain prefix counts
    int32_t* c_begin, int32_t* c_end, int32_t* c_blo, int32_t* c_bhi,
    int32_t* s_chain, int32_t* s_order, int32_t* s_begin, int32_t* s_end,
    int32_t* s_q,
    int32_t* u_text, int32_t* u_begin, int32_t* u_end,
    int64_t caps_b, int64_t caps_c, int64_t caps_s, int64_t caps_u,
    int64_t* out_counts  // [4]: nb, nc, ns, nu
) {
    if (n_texts < 0 || max_ngram < 1) return -1;
    bool alpha[256];
    for (int i = 0; i < 256; i++) {
        alpha[i] = (i >= 'A' && i <= 'Z') || (i >= 'a' && i <= 'z');
    }
    int64_t nb_all = 0, nc_all = 0, ns_all = 0;
    std::unordered_map<std::string_view, int32_t> uniq;
    std::vector<std::pair<int32_t, std::pair<int32_t, int32_t>>> ukeys;
    uniq.reserve(4096);

    b_text_off[0] = 0;
    c_text_off[0] = 0;
    for (int32_t ti = 0; ti < n_texts; ti++) {
        const uint8_t* t = data + text_off[ti];
        int64_t n = text_off[ti + 1] - text_off[ti];
        int64_t b_base = nb_all;  // this text's boundaries start here
        if (n > 0) {
            // boundary runs of non-alphabetic bytes + trailing empty
            int64_t i = 0;
            while (i < n) {
                if (!alpha[t[i]]) {
                    int64_t j = i + 1;
                    while (j < n && !alpha[t[j]]) j++;
                    if (nb_all >= caps_b) return -1;
                    bb[nb_all] = (int32_t)i;
                    be[nb_all] = (int32_t)j;
                    nb_all++;
                    i = j;
                } else {
                    i++;
                }
            }
            if (nb_all == b_base || be[nb_all - 1] != (int32_t)n) {
                if (nb_all >= caps_b) return -1;
                bb[nb_all] = (int32_t)n;
                be[nb_all] = (int32_t)n;
                nb_all++;
            }
            int32_t nb_t = (int32_t)(nb_all - b_base);
            const int32_t* tbb = bb + b_base;
            const int32_t* tbe = be + b_base;

            // hard-batch split (HARD = multi-byte run or final boundary)
            int64_t c_base = nc_all;
            {
                int32_t begin = 0, begin_index = 0;
                for (int32_t i2 = 0; i2 < nb_t; i2++) {
                    if ((tbe[i2] - tbb[i2] > 1 || i2 == nb_t - 1) &&
                        tbb[i2] != begin) {
                        if (nc_all >= caps_c) return -1;
                        c_begin[nc_all] = begin;
                        c_end[nc_all] = tbb[i2];
                        c_blo[nc_all] = begin_index;
                        c_bhi[nc_all] = i2 + 1;
                        nc_all++;
                        begin = tbe[i2];
                        begin_index = i2 + 1;
                    }
                }
            }

            // segments per chain, order-major within the chain
            for (int64_t cid = c_base; cid < nc_all; cid++) {
                int32_t bbegin = c_begin[cid], bend = c_end[cid];
                int32_t blo = c_blo[cid], bhi = c_bhi[cid];
                int32_t m_b = bhi - blo;
                for (int32_t order = 1; order <= max_ngram; order++) {
                    int32_t seg_begin = bbegin;
                    int32_t i2 = 0;
                    while (i2 + order - 1 < m_b) {
                        int32_t bnd_begin = tbb[blo + i2 + order - 1];
                        if (bnd_begin > bend) break;
                        int32_t ln = bnd_begin - seg_begin;
                        if (ln > 0 && !(ln == 1 && t[seg_begin] == ' ')) {
                            std::string_view key(
                                (const char*)t + seg_begin, (size_t)ln);
                            auto it = uniq.find(key);
                            int32_t q;
                            if (it == uniq.end()) {
                                q = (int32_t)ukeys.size();
                                if (q >= caps_u) return -1;
                                uniq.emplace(key, q);
                                ukeys.push_back({ti, {seg_begin, bnd_begin}});
                            } else {
                                q = it->second;
                            }
                            if (ns_all >= caps_s) return -1;
                            s_chain[ns_all] = (int32_t)cid;
                            s_order[ns_all] = order;
                            s_begin[ns_all] = seg_begin;
                            s_end[ns_all] = bnd_begin;
                            s_q[ns_all] = q;
                            ns_all++;
                        }
                        seg_begin = tbe[blo + i2];
                        i2++;
                    }
                    if (seg_begin < bend) {
                        int32_t ln = bend - seg_begin;
                        if (ln > 0 && !(ln == 1 && t[seg_begin] == ' ')) {
                            // internal-boundaries quirk: contiguous hit
                            // range; a single hit yields an empty slice
                            const int32_t* lo_p = std::upper_bound(
                                tbb + blo, tbb + bhi, seg_begin);
                            const int32_t* hi_p = std::lower_bound(
                                tbe + blo, tbe + bhi, bend);
                            int32_t cnt = (int32_t)((hi_p - tbe) - (lo_p - tbb));
                            if (cnt >= 2 && cnt == order) {
                                std::string_view key(
                                    (const char*)t + seg_begin, (size_t)ln);
                                auto it = uniq.find(key);
                                int32_t q;
                                if (it == uniq.end()) {
                                    q = (int32_t)ukeys.size();
                                    if (q >= caps_u) return -1;
                                    uniq.emplace(key, q);
                                    ukeys.push_back({ti, {seg_begin, bend}});
                                } else {
                                    q = it->second;
                                }
                                if (ns_all >= caps_s) return -1;
                                s_chain[ns_all] = (int32_t)cid;
                                s_order[ns_all] = order;
                                s_begin[ns_all] = seg_begin;
                                s_end[ns_all] = bend;
                                s_q[ns_all] = q;
                                ns_all++;
                            }
                        }
                    }
                }
            }
        }
        b_text_off[ti + 1] = (int32_t)nb_all;
        c_text_off[ti + 1] = (int32_t)nc_all;
    }
    for (size_t u = 0; u < ukeys.size(); u++) {
        u_text[u] = ukeys[u].first;
        u_begin[u] = ukeys[u].second.first;
        u_end[u] = ukeys[u].second.second;
    }
    out_counts[0] = nb_all;
    out_counts[1] = nc_all;
    out_counts[2] = ns_all;
    out_counts[3] = (int64_t)ukeys.size();
    return 0;
}

}  // extern "C"

// --------------------------------------------------------------------------
// Exact n-best lattice decode with LM rescoring — the native core of
// search_fast._consolidate_lm, mirroring VariantModel.most_likely_sequence
// (reference lib.rs:2088-2495) for the LM-on / no-context-rules case:
//   - per chain, exact n-best paths by cost; ties break in the in_arcs
//     enumeration order (source state asc, arc creation order asc,
//     source-hypothesis index asc) — _nbest_paths_arrays semantics
//   - final hypotheses collected in (cost, state, hidx) order, top nbest
//   - per-hypothesis LM logprob: sliding bigram over the token stream
//     BOS ++ per-arc tokens ++ EOS (lib.rs:2580-2674), contributions
//     gathered from a precomputed per-bigram table so values are bit-equal
//     to the Python paths (which share the same table)
//   - weighted log-space selection, first maximum wins (lib.rs:2383-2425)
// --------------------------------------------------------------------------

namespace {

struct NbHyp {
    double cost;
    int32_t prev;  // pool index of the source hypothesis, -1 at state 0
    int32_t arc;   // sorted-arc index taken into this state, -1 at state 0
};

struct NbCand {
    double cost;
    int32_t arc_pos;  // position within the (chain, target) arc slice:
                      // encodes (src, serial) — the slice is sorted so
    int32_t hidx;     // source-hypothesis index within its state
    int32_t prev;     // pool index of the source hypothesis
};

struct NbFinal {
    double cost;
    int32_t state;
    int32_t hidx;
    int32_t pool;
};

// open-addressing map int64 key -> double (bigram contribution table)
struct LmHash {
    std::vector<int64_t> keys;
    std::vector<double> vals;
    uint64_t mask = 0;

    static uint64_t mix(int64_t x) {
        uint64_t z = (uint64_t)x + 0x9e3779b97f4a7c15ull;
        z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
        z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
        return z ^ (z >> 31);
    }

    void build(const int64_t* k, const double* v, int64_t n) {
        uint64_t cap = 16;
        while (cap < (uint64_t)(n + 1) * 2) cap <<= 1;
        mask = cap - 1;
        keys.assign(cap, INT64_MIN);
        vals.assign(cap, 0.0);
        for (int64_t i = 0; i < n; i++) {
            uint64_t h = mix(k[i]) & mask;
            while (keys[h] != INT64_MIN) h = (h + 1) & mask;
            keys[h] = k[i];
            vals[h] = v[i];
        }
    }

    bool find(int64_t key, double* out) const {
        uint64_t h = mix(key) & mask;
        for (;;) {
            int64_t k = keys[h];
            if (k == key) {
                *out = vals[h];
                return true;
            }
            if (k == INT64_MIN) return false;
            h = (h + 1) & mask;
        }
    }
};

}  // namespace

extern "C" {

int64_t ananorm_nbest_lm(
    // arcs sorted by (chain, tgt, src, creation order); a_orig maps back to
    // the creation-order id (== the tie-break serial)
    int64_t n_arcs, const int32_t* a_chain, const int32_t* a_src,
    const int32_t* a_tgt, const double* a_cost, const int64_t* a_orig,
    const int64_t* chain_arc_off,  // [nchain+1] slices into the sorted arcs
    // token streams, indexed by ORIGINAL arc id: vid part then tail part
    const int32_t* arc_vid_idx,  // -1 = OOV (one unknown token)
    const int32_t* arc_b_idx,    // index into the tail table
    const int32_t* vid_tok, const int64_t* vid_tok_off,
    const int32_t* tail_tok, const int64_t* tail_off,
    int32_t nchain, const int32_t* nstates,
    const int32_t* finals_flat, const int64_t* finals_off,
    int32_t nbest, int64_t eps_base,  // orig ids >= eps_base are epsilon
    const int64_t* bi_keys, const double* bi_contrib, int64_t n_bi,
    double smoothing, int32_t bos, int32_t eos,
    double lm_w, double vm_w, double ctx_w,
    // outputs: the selected path per chain (original arc ids, forward
    // order, epsilon arcs dropped)
    int64_t* out_arcs, int64_t out_cap, int64_t* out_off) {
    LmHash lm;
    lm.build(bi_keys, bi_contrib, n_bi);
    const double denom = lm_w + vm_w + ctx_w;

    auto cand_cmp = [](const NbCand& x, const NbCand& y) {
        if (x.cost != y.cost) return x.cost < y.cost;
        if (x.arc_pos != y.arc_pos) return x.arc_pos < y.arc_pos;
        return x.hidx < y.hidx;
    };
    auto final_cmp = [](const NbFinal& x, const NbFinal& y) {
        if (x.cost != y.cost) return x.cost < y.cost;
        if (x.state != y.state) return x.state < y.state;
        return x.hidx < y.hidx;
    };

    std::vector<NbHyp> pool;
    std::vector<int32_t> soff;
    std::vector<NbCand> cand;
    std::vector<NbFinal> fin;
    std::vector<int32_t> path;
    std::vector<double> perps;
    int64_t out_n = 0;
    out_off[0] = 0;

    for (int32_t c = 0; c < nchain; c++) {
        const int64_t alo = chain_arc_off[c], ahi = chain_arc_off[c + 1];
        const int32_t nst = nstates[c];
        pool.clear();
        pool.push_back({0.0, -1, -1});
        soff.assign((size_t)nst + 1, 0);
        soff[1] = 1;
        int64_t p = alo;
        for (int32_t t = 1; t < nst; t++) {
            cand.clear();
            while (p < ahi && a_tgt[p] < t) p++;
            while (p < ahi && a_tgt[p] == t) {
                const int32_t s = a_src[p];
                const int32_t h0 = soff[s], h1 = soff[s + 1];
                const int32_t arc_pos = (int32_t)(p - alo);
                const double ac = a_cost[p];
                for (int32_t h = h0; h < h1; h++) {
                    cand.push_back(
                        {pool[h].cost + ac, arc_pos, h - h0, h});
                }
                p++;
            }
            if ((int64_t)cand.size() > nbest) {
                std::nth_element(cand.begin(), cand.begin() + nbest,
                                 cand.end(), cand_cmp);
                cand.resize(nbest);
            }
            std::sort(cand.begin(), cand.end(), cand_cmp);
            for (const NbCand& cd : cand) {
                pool.push_back(
                    {cd.cost, cd.prev, (int32_t)(alo + cd.arc_pos)});
            }
            soff[t + 1] = (int32_t)pool.size();
        }

        // final hypotheses: (cost, state, hidx) order, top nbest
        fin.clear();
        for (int64_t fi = finals_off[c]; fi < finals_off[c + 1]; fi++) {
            const int32_t s = finals_flat[fi];
            if (s < 1 || s >= nst) continue;
            for (int32_t h = soff[s]; h < soff[s + 1]; h++) {
                fin.push_back({pool[h].cost, s, h - soff[s], h});
            }
        }
        if ((int64_t)fin.size() > nbest) {
            std::nth_element(fin.begin(), fin.begin() + nbest, fin.end(),
                             final_cmp);
            fin.resize(nbest);
        }
        std::sort(fin.begin(), fin.end(), final_cmp);
        if (fin.empty()) {
            out_off[c + 1] = out_n;
            continue;
        }

        // LM pass over every kept hypothesis
        const size_t nk = fin.size();
        perps.assign(nk, 0.0);
        double best_perp = 999999.0;
        double bvc = (double)(nst - 2) * 2.0;
        for (size_t k = 0; k < nk; k++) {
            path.clear();
            for (int32_t h = fin[k].pool; pool[h].prev >= 0;
                 h = pool[h].prev) {
                path.push_back(pool[h].arc);
            }
            double lp = 0.0;
            int64_t n = 0;
            int32_t prev = bos;
            auto step = [&](int32_t t1) {
                if (prev >= 0 && t1 >= 0) {
                    const int64_t key =
                        ((int64_t)prev << 32) | (uint32_t)t1;
                    double v;
                    lp += lm.find(key, &v) ? v : smoothing;
                } else {
                    lp += smoothing;
                }
                n++;
                prev = t1;
            };
            for (int64_t i = (int64_t)path.size() - 1; i >= 0; i--) {
                const int64_t orig = a_orig[path[i]];
                if (orig >= eps_base) continue;  // epsilon: no symbol
                const int32_t vix = arc_vid_idx[orig];
                if (vix < 0) {
                    step(-1);  // OOV copies the input as one unknown token
                } else {
                    for (int64_t j = vid_tok_off[vix];
                         j < vid_tok_off[vix + 1]; j++) {
                        step(vid_tok[j]);
                    }
                }
                const int32_t bix = arc_b_idx[orig];
                for (int64_t j = tail_off[bix]; j < tail_off[bix + 1];
                     j++) {
                    step(tail_tok[j]);
                }
            }
            step(eos);
            const double perp = n ? (-1.0 / (double)n) * lp : 0.0;
            perps[k] = perp;
            if (perp < best_perp) best_perp = perp;
            if (fin[k].cost < bvc) bvc = fin[k].cost;
        }

        // weighted log-space selection, first maximum wins
        double best_score = -99999999.0;
        int64_t best_k = -1;
        for (size_t k = 0; k < nk; k++) {
            const double norm_lm = std::log(best_perp / perps[k]);
            const double cost = fin[k].cost;
            double nvs;
            if (cost <= 0.0) {
                nvs = 0.0;
            } else if (bvc <= 0.0) {
                nvs = -INFINITY;
            } else {
                nvs = std::log(bvc / cost);
            }
            const double score =
                (lm_w * norm_lm + vm_w * nvs + ctx_w * 0.0) / denom;
            if (score > best_score || best_k < 0) {
                best_score = score;
                best_k = (int64_t)k;
            }
        }

        path.clear();
        for (int32_t h = fin[best_k].pool; pool[h].prev >= 0;
             h = pool[h].prev) {
            path.push_back(pool[h].arc);
        }
        for (int64_t i = (int64_t)path.size() - 1; i >= 0; i--) {
            const int64_t orig = a_orig[path[i]];
            if (orig >= eps_base) continue;
            if (out_n >= out_cap) return -1;
            out_arcs[out_n++] = orig;
        }
        out_off[c + 1] = out_n;
    }
    return out_n;
}

}  // extern "C"
