// Native host-side dataset preprocessing (counterpart of
// neuron_gan_tpu/runtime/preproc.cpp).
//
// The reference's per-image load pipeline hot spots
// (reference data/NeuronDataset.py:84-110):
//   * multi_otsu_hist: k-class Otsu thresholds by dynamic programming on
//     cumulative histogram moments (skimage.threshold_multiotsu, which the
//     reference calls at NeuronDataset.py:93);
//   * noise_stats_u8: mean and std of the background pixels below the first
//     threshold (NeuronDataset.py:94-97).
//
// Both are numpy's results (bit for bit with numpy 2.0.2, whose reductions
// take the generic pairwise loop below; a numpy whose vector loops sum in
// another order differs in the std's last bit), so a stack built with them
// is the numpy path's stack:
//   * the DP takes the same operations in the same order as the numpy DP of
//     data/neuron_dataset.py (sequential prefix sums, first maximum wins);
//   * the mean is an exact integer sum over the count;
//   * the std takes two passes: the squared deviations from the mean, summed
//     in numpy's order (pairwise sums of 8 accumulators over blocks of at
//     most 128, within chunks of numpy's buffer size, the chunks summed in
//     order), over the count, then the square root.  The moment identity
//     (E[v^2] - E[v]^2), which the JAX package's library uses, cancels
//     catastrophically where the mean is large and the spread small.
//
// A plain C interface for ctypes (runtime/native.py); built with g++ at
// first use by runtime/build.py.

#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

// numpy's pairwise summation of a contiguous float64 block
// (loops_utils.h.src, PW_BLOCKSIZE 128)
double pairwise_sum(const double* a, long long n) {
  if (n < 8) {
    double res = 0.0;
    for (long long i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= 128) {
    double r[8];
    for (int k = 0; k < 8; ++k) r[k] = a[k];
    long long i = 8;
    for (; i < n - (n % 8); i += 8) {
      for (int k = 0; k < 8; ++k) r[k] += a[i + k];
    }
    double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  long long n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

}  // namespace

extern "C" {

// Multi-Otsu thresholds over a histogram of `n_bins` counts with bin centers
// `centers`.  Writes `classes-1` thresholds into `out`.  Returns 0 on
// success, 1 for fewer bins than classes, 2 for an empty histogram.
// DP: f[k][j] = max_{i<j} f[k-1][i] + S(i+1, j)^2 / W(i+1, j).
int multi_otsu_hist(const double* hist, const double* centers, int n_bins,
                    int classes, double* out) {
  if (classes < 2 || n_bins < classes) return 1;
  const int n = n_bins;
  double total = 0;
  for (int i = 0; i < n; ++i) total += hist[i];
  if (total <= 0) return 2;

  std::vector<double> cp(n + 1, 0.0), cs(n + 1, 0.0);
  for (int i = 0; i < n; ++i) {
    const double p = hist[i] / total;
    cp[i + 1] = cp[i] + p;
    cs[i + 1] = cs[i] + p * centers[i];
  }
  auto seg = [&](int i, int j) {  // score of bins [i, j]
    const double w = cp[j + 1] - cp[i];
    const double s = cs[j + 1] - cs[i];
    return w > 0 ? (s * s) / w : 0.0;
  };

  const double neg_inf = -std::numeric_limits<double>::infinity();
  std::vector<std::vector<double>> f(classes, std::vector<double>(n, neg_inf));
  std::vector<std::vector<int>> arg(classes, std::vector<int>(n, 0));
  for (int j = 0; j < n; ++j) f[0][j] = seg(0, j);
  for (int k = 1; k < classes; ++k) {
    for (int j = k; j < n; ++j) {
      double best = neg_inf;
      int best_i = k - 1;
      for (int i = k - 1; i < j; ++i) {
        const double v = f[k - 1][i] + seg(i + 1, j);
        if (v > best) { best = v; best_i = i; }
      }
      f[k][j] = best;
      arg[k][j] = best_i;
    }
  }
  int j = n - 1;
  for (int k = classes - 1; k >= 1; --k) {
    const int i = arg[k][j];
    out[k - 1] = centers[i];
    j = i;
  }
  return 0;
}

// Mean and std of the pixels 0 < v < thresh of a uint8 image, as numpy's
// sel.mean() and sel.std() give them (`chunk`: numpy's buffer size,
// np.getbufsize()).  Returns the count; writes 0, 0 for no pixel.
long long noise_stats_u8(const uint8_t* img, long long n, double thresh,
                         long long chunk, double* mean, double* std_out) {
  unsigned long long sum = 0;
  long long cnt = 0;
  for (long long i = 0; i < n; ++i) {
    const double v = img[i];
    if (v > 0.0 && v < thresh) {
      sum += img[i];
      ++cnt;
    }
  }
  if (cnt == 0) { *mean = 0; *std_out = 0; return 0; }
  const double m = static_cast<double>(sum) / static_cast<double>(cnt);
  std::vector<double> dev2;
  dev2.reserve(cnt);
  for (long long i = 0; i < n; ++i) {
    const double v = img[i];
    if (v > 0.0 && v < thresh) dev2.push_back((v - m) * (v - m));
  }
  double acc = 0.0;
  for (long long k = 0; k < cnt; k += chunk) {
    acc += pairwise_sum(dev2.data() + k, cnt - k < chunk ? cnt - k : chunk);
  }
  *mean = m;
  *std_out = std::sqrt(acc / static_cast<double>(cnt));
  return cnt;
}

}  // extern "C"
