// Host n-gram scorer core of the port: corpus + per-sentence BLEU (COCO
// semantics) and the ROUGE-L LCS over pre-tokenized pairs. A copy of the JAX
// package's native/ngram_scores.cpp, built by
// vilmedic_torch/scorers/nlg/native.py with g++ into vilmedic_torch/_build/
// and bound with ctypes. SCST recomputes per-sentence rewards for every
// training batch, so tokenize / n-gram count / clip / LCS run in C++ instead
// of Python dict machinery.
//
// Semantics mirror vilmedic_torch/scorers/nlg/bleu.py (COCO BleuScorer,
// option='closest': tiny=1e-15, small=1e-9, closest-ref brevity penalty) and
// the LCS F1 of vilmedic_torch/scorers/nlg/rouge.py. Tokens are split on the
// space character only, as the callers join them.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libngram_scores.so ngram_scores.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kTiny = 1e-15;
constexpr double kSmall = 1e-9;

using Tokens = std::vector<std::string>;
using NgramCounts = std::unordered_map<std::string, int>;

Tokens tokenize(const char* s) {
  Tokens out;
  const char* p = s;
  while (*p) {
    while (*p == ' ') ++p;
    const char* start = p;
    while (*p && *p != ' ') ++p;
    if (p > start) out.emplace_back(start, p - start);
  }
  return out;
}

// n-gram key: tokens joined with '\x1f' plus order prefix
void count_ngrams(const Tokens& tokens, int max_n, NgramCounts* counts) {
  for (int n = 1; n <= max_n; ++n) {
    if ((int)tokens.size() < n) break;
    for (size_t i = 0; i + n <= tokens.size(); ++i) {
      std::string key;
      key.reserve(16);
      key.push_back((char)n);
      for (int j = 0; j < n; ++j) {
        key += tokens[i + j];
        key.push_back('\x1f');
      }
      ++(*counts)[key];
    }
  }
}

struct SegmentStats {
  long testlen = 0;
  long reflen = 0;
  std::vector<long> guess;
  std::vector<long> correct;
};

SegmentStats segment_stats(const char* hyp, const char* const* refs,
                           int n_refs, int max_n) {
  SegmentStats st;
  st.guess.assign(max_n, 0);
  st.correct.assign(max_n, 0);

  Tokens hyp_tokens = tokenize(hyp);
  st.testlen = (long)hyp_tokens.size();

  // closest reference length (ties -> shorter)
  long best_diff = -1;
  for (int r = 0; r < n_refs; ++r) {
    long len = (long)tokenize(refs[r]).size();
    long diff = std::labs(len - st.testlen);
    if (best_diff < 0 || diff < best_diff ||
        (diff == best_diff && len < st.reflen)) {
      best_diff = diff;
      st.reflen = len;
    }
  }

  NgramCounts hyp_counts;
  count_ngrams(hyp_tokens, max_n, &hyp_counts);

  NgramCounts max_ref_counts;
  for (int r = 0; r < n_refs; ++r) {
    NgramCounts rc;
    count_ngrams(tokenize(refs[r]), max_n, &rc);
    for (const auto& kv : rc) {
      auto it = max_ref_counts.find(kv.first);
      if (it == max_ref_counts.end() || it->second < kv.second)
        max_ref_counts[kv.first] = kv.second;
    }
  }

  for (int n = 1; n <= max_n; ++n)
    st.guess[n - 1] = std::max(0L, st.testlen - n + 1);
  for (const auto& kv : hyp_counts) {
    int n = (int)(unsigned char)kv.first[0];
    auto it = max_ref_counts.find(kv.first);
    int clip = it == max_ref_counts.end() ? 0 : it->second;
    st.correct[n - 1] += std::min(kv.second, clip);
  }
  return st;
}

double bleu_from_stats(long testlen, long reflen, const std::vector<long>& guess,
                       const std::vector<long>& correct, int max_n) {
  double log_sum = 0.0;
  double ratio = (testlen + kTiny) / (reflen + kSmall);
  double bleu = 0.0;
  for (int k = 0; k < max_n; ++k) {
    log_sum += std::log(correct[k] + kTiny) - std::log(guess[k] + kSmall);
    bleu = std::exp(log_sum / (k + 1));
    if (ratio < 1) bleu *= std::exp(1 - 1 / ratio);
  }
  return bleu;
}

}  // namespace

extern "C" {

// refs/hyps: arrays of n C strings (single reference per hypothesis).
// per_sentence_out: n doubles; returns corpus BLEU_max_n.
double bleu_score(const char* const* refs, const char* const* hyps, int n,
                  int max_n, double* per_sentence_out) {
  long tot_testlen = 0, tot_reflen = 0;
  std::vector<long> tot_guess(max_n, 0), tot_correct(max_n, 0);
  for (int i = 0; i < n; ++i) {
    const char* ref_arr[1] = {refs[i]};
    SegmentStats st = segment_stats(hyps[i], ref_arr, 1, max_n);
    if (per_sentence_out)
      per_sentence_out[i] =
          bleu_from_stats(st.testlen, st.reflen, st.guess, st.correct, max_n);
    tot_testlen += st.testlen;
    tot_reflen += st.reflen;
    for (int k = 0; k < max_n; ++k) {
      tot_guess[k] += st.guess[k];
      tot_correct[k] += st.correct[k];
    }
  }
  return bleu_from_stats(tot_testlen, tot_reflen, tot_guess, tot_correct, max_n);
}

// ROUGE-L F1 per pair (LCS over space-separated tokens — the caller has
// already applied the ROUGE tokenizer and stemmer, so this is only the
// O(m*n) DP that dominates the pure-Python ROUGE-L in the SCST reward loop).
// refs/hyps: n space-joined token strings; f1_out: n doubles.
void rouge_l_batch(const char* const* refs, const char* const* hyps, int n,
                   double* f1_out) {
  std::unordered_map<std::string, int> intern;
  auto to_ids = [&intern](const char* s) {
    std::vector<int> ids;
    for (const auto& tok : tokenize(s)) {
      auto it = intern.emplace(tok, (int)intern.size()).first;
      ids.push_back(it->second);
    }
    return ids;
  };
  std::vector<int> prev, cur;
  for (int i = 0; i < n; ++i) {
    std::vector<int> r = to_ids(refs[i]);
    std::vector<int> h = to_ids(hyps[i]);
    if (r.empty() || h.empty()) {
      f1_out[i] = 0.0;
      continue;
    }
    const size_t m = h.size();
    prev.assign(m + 1, 0);
    cur.assign(m + 1, 0);
    for (size_t a = 1; a <= r.size(); ++a) {
      const int ra = r[a - 1];
      for (size_t b = 1; b <= m; ++b) {
        cur[b] = (ra == h[b - 1]) ? prev[b - 1] + 1
                                  : std::max(prev[b], cur[b - 1]);
      }
      std::swap(prev, cur);
    }
    const double lcs = (double)prev[m];
    const double precision = lcs / (double)h.size();
    const double recall = lcs / (double)r.size();
    f1_out[i] = (precision + recall > 0.0)
                    ? 2.0 * precision * recall / (precision + recall)
                    : 0.0;
  }
}

}  // extern "C"
