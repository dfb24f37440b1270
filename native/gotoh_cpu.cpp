// Reference-equivalent CPU Gotoh fill (score-only, linear memory).
//
// Mirrors the recurrence of /root/reference/src/alignment/algo.rs:151-282
// including its quirks (SURVEY §2.4): the local zero-floor is injected
// inside every predecessor max (algo.rs:103), I<->D cross-transitions
// are allowed at open cost (algo.rs:231-243), and the local best cell
// is the *last* row-major argmax (algo.rs:311-322).
//
// Dual purpose:
//  * a CPU stand-in for the reference's single-threaded fill (same
//    algorithm, same i64 math);
//  * a large-scale correctness oracle for the device fills (scores at
//    30 kb+, where the numpy oracle is impractical).
//
// Build: make -C native

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {
inline int64_t max4(int64_t a, int64_t b, int64_t c, int64_t d) {
  return std::max(std::max(a, b), std::max(c, d));
}

// Shared fill; sub(i-1, j-1) supplies the substitution score.
template <typename SubFn>
int gotoh_fill(const uint8_t* s1, int64_t m, const uint8_t* s2, int64_t n,
               int64_t g, int64_t h, int is_local, int64_t* out,
               SubFn sub_at) {
  const int64_t NEG = INT64_MIN / 4;
  const int64_t zero_lane = is_local ? 0 : NEG;

  std::vector<int64_t> Ip(n + 1), Sp(n + 1), Dp(n + 1);
  std::vector<int64_t> Ic(n + 1), Sc(n + 1), Dc(n + 1);

  Ip[0] = Sp[0] = Dp[0] = 0;
  for (int64_t j = 1; j <= n; ++j) {
    Ip[j] = h + j * g;
    Sp[j] = NEG;
    Dp[j] = NEG;
  }

  int64_t best = INT64_MIN, best_i = 0, best_j = 0;
  if (is_local) {
    for (int64_t j = 0; j <= n; ++j) {
      int64_t cm = max4(Ip[j], Sp[j], Dp[j], 0);
      if (cm >= best) { best = cm; best_i = 0; best_j = j; }
    }
  }

  for (int64_t i = 1; i <= m; ++i) {
    Ic[0] = NEG;
    Sc[0] = NEG;
    Dc[0] = h + i * g;
    const uint8_t c1 = s1[i - 1];
    for (int64_t j = 1; j <= n; ++j) {
      const int64_t iw = Ic[j - 1], sw = Sc[j - 1], dw = Dc[j - 1];
      Ic[j] = max4(iw + g, sw + h + g, dw + h + g, zero_lane);
      Dc[j] = max4(Ip[j] + h + g, Sp[j] + h + g, Dp[j] + g, zero_lane);
      const int64_t sub = sub_at(c1, s2[j - 1]);
      Sc[j] = sub + max4(Ip[j - 1], Sp[j - 1], Dp[j - 1], zero_lane);
    }
    if (is_local) {
      for (int64_t j = 0; j <= n; ++j) {
        int64_t cm = max4(Ic[j], Sc[j], Dc[j], 0);
        if (cm >= best) { best = cm; best_i = i; best_j = j; }
      }
    }
    Ip.swap(Ic);
    Sp.swap(Sc);
    Dp.swap(Dc);
  }

  if (is_local) {
    out[0] = best;
    out[1] = best_i;
    out[2] = best_j;
  } else {
    out[0] = std::max(std::max(Ip[n], Sp[n]), Dp[n]);
    out[1] = m;
    out[2] = n;
  }
  return 0;
}
}  // namespace

extern "C" {

// out[0] = score, out[1] = best_i, out[2] = best_j (local retrace
// start; for global out[1]=m, out[2]=n). Returns 0 on success.
int gotoh_score_cpu(const uint8_t* s1, int64_t m, const uint8_t* s2,
                    int64_t n, int64_t sm, int64_t sx, int64_t g, int64_t h,
                    int is_local, int64_t* out) {
  return gotoh_fill(s1, m, s2, n, g, h, is_local, out,
                    [sm, sx](uint8_t a, uint8_t b) -> int64_t {
                      return (a == b) ? sm : sx;
                    });
}

// Substitution-matrix variant: sub(a, b) = lut256[a * 256 + b]
// (covers kimura transition scoring and full matrices, e.g. BLOSUM62;
// an extension over the reference's two-score model).
int gotoh_score_cpu_subst(const uint8_t* s1, int64_t m, const uint8_t* s2,
                          int64_t n, const int32_t* lut256, int64_t g,
                          int64_t h, int is_local, int64_t* out) {
  return gotoh_fill(s1, m, s2, n, g, h, is_local, out,
                    [lut256](uint8_t a, uint8_t b) -> int64_t {
                      return lut256[(int32_t)a * 256 + (int32_t)b];
                    });
}

}  // extern "C"
