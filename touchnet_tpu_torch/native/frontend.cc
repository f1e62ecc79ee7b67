// Copyright (c) 2026 touchnet_tpu authors.
// Copied from touchnet_tpu/native/frontend.cc, its code unchanged:
// the same source built with the same g++ flags gives the same features
// bit for bit. Loaded by touchnet_tpu_torch/data/native.py.
//
// Native audio frontend: kaldi fbank + kaldi MFCC + Whisper log-mel.
//
// Capability parity: the reference's CPU frontends are torchaudio's
// compliance.kaldi fbank/mfcc and Whisper's torch.stft log-mel (C++ under
// torch, reference touchnet/data/functions.py:108-190, SURVEY.md §2.9).
// These are the equivalent first-party native components for the TPU
// build's dataloader workers:
//   fbank: framing (snip edges) -> dither -> DC removal -> pre-emphasis ->
//     povey window -> real FFT (iterative radix-2) -> power spectrum ->
//     kaldi-mel triangular filterbank -> log with eps floor.
//   mfcc: fbank -> orthonormal DCT-II (num_ceps rows) -> sinusoidal lifter.
//   logmel (Whisper): reflect-pad n_fft/2 -> periodic hann -> rfft (n_fft
//     400 is not a power of two; Bluestein chirp-z over a padded radix-2
//     plan) -> power, last frame dropped -> slaney mel -> log10 clamp ->
//     global (max - 8) floor -> (x + 4) / 4.
// Exposed via a plain C ABI consumed through ctypes
// (touchnet_tpu_torch/data/native.py); numerics match data/dsp.py
// bit-closely (float64 internal accumulation, float32 I/O).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <vector>

namespace {

constexpr double kEps = 1.1920928955078125e-07;  // float32 machine epsilon

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Iterative radix-2 complex FFT with precomputed twiddles + bit-reversal
// table (plan-cached; built once per padded size).
struct FFTPlan {
  int n = 0;
  std::vector<int> rev;
  std::vector<double> tw_re, tw_im;  // per stage, concatenated

  void build(int size) {
    n = size;
    rev.resize(n);
    rev[0] = 0;
    for (int i = 1; i < n; ++i) {
      rev[i] = (rev[i >> 1] >> 1) | ((i & 1) ? (n >> 1) : 0);
    }
    tw_re.clear();
    tw_im.clear();
    for (int len = 2; len <= n; len <<= 1) {
      for (int j = 0; j < len / 2; ++j) {
        const double ang = -2.0 * M_PI * j / len;
        tw_re.push_back(std::cos(ang));
        tw_im.push_back(std::sin(ang));
      }
    }
  }
};

void fft(const FFTPlan& plan, std::vector<double>& re, std::vector<double>& im) {
  const int n = plan.n;
  for (int i = 0; i < n; ++i) {
    const int j = plan.rev[i];
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  size_t tw = 0;
  for (int len = 2; len <= n; len <<= 1) {
    for (int i = 0; i < n; i += len) {
      for (int j = 0; j < len / 2; ++j) {
        const double wr = plan.tw_re[tw + j], wi = plan.tw_im[tw + j];
        const double ur = re[i + j], ui = im[i + j];
        const double xr = re[i + j + len / 2], xi = im[i + j + len / 2];
        const double vr = xr * wr - xi * wi;
        const double vi = xr * wi + xi * wr;
        re[i + j] = ur + vr;
        im[i + j] = ui + vi;
        re[i + j + len / 2] = ur - vr;
        im[i + j + len / 2] = ui - vi;
      }
    }
    tw += len / 2;
  }
}

// Bluestein chirp-z transform: DFT of arbitrary size n via one radix-2 FFT
// of size M = next_pow2(2n - 1). Used by the Whisper log-mel (n_fft = 400).
struct BluesteinPlan {
  int n = 0, m = 0;
  FFTPlan fft_plan;
  std::vector<double> chirp_re, chirp_im;  // c_k = exp(-i pi k^2 / n)
  std::vector<double> bfft_re, bfft_im;    // FFT_M of the conjugate chirp

  void build(int size) {
    n = size;
    m = next_pow2(2 * n - 1);
    fft_plan.build(m);
    chirp_re.resize(n);
    chirp_im.resize(n);
    std::vector<double> b_re(m, 0.0), b_im(m, 0.0);
    for (int k = 0; k < n; ++k) {
      // k^2 mod 2n keeps the angle argument small (k^2 overflows double
      // precision of the phase for large k otherwise)
      const long long k2 = (1LL * k * k) % (2LL * n);
      const double ang = -M_PI * static_cast<double>(k2) / n;
      chirp_re[k] = std::cos(ang);
      chirp_im[k] = std::sin(ang);
      b_re[k] = chirp_re[k];
      b_im[k] = -chirp_im[k];  // conj(c_k)
      if (k > 0) {
        b_re[m - k] = b_re[k];
        b_im[m - k] = b_im[k];
      }
    }
    fft(fft_plan, b_re, b_im);
    bfft_re = std::move(b_re);
    bfft_im = std::move(b_im);
  }

  // In: re/im of length n (im may be zeros). Out: DFT written back to re/im.
  void transform(std::vector<double>& re, std::vector<double>& im,
                 std::vector<double>& work_re, std::vector<double>& work_im)
      const {
    work_re.assign(m, 0.0);
    work_im.assign(m, 0.0);
    for (int k = 0; k < n; ++k) {
      work_re[k] = re[k] * chirp_re[k] - im[k] * chirp_im[k];
      work_im[k] = re[k] * chirp_im[k] + im[k] * chirp_re[k];
    }
    fft(fft_plan, work_re, work_im);
    for (int k = 0; k < m; ++k) {
      const double xr = work_re[k], xi = work_im[k];
      work_re[k] = xr * bfft_re[k] - xi * bfft_im[k];
      work_im[k] = xr * bfft_im[k] + xi * bfft_re[k];
    }
    // inverse FFT_M via conj -> fft -> conj, scaled by 1/M
    for (int k = 0; k < m; ++k) work_im[k] = -work_im[k];
    fft(fft_plan, work_re, work_im);
    for (int k = 0; k < n; ++k) {
      const double pr = work_re[k] / m, pi = -work_im[k] / m;
      re[k] = pr * chirp_re[k] - pi * chirp_im[k];
      im[k] = pr * chirp_im[k] + pi * chirp_re[k];
    }
  }
};

double mel_scale(double freq) { return 1127.0 * std::log(1.0 + freq / 700.0); }

// Slaney mel scale (librosa htk=False): linear below 1 kHz, log above.
double hz_to_mel_slaney(double freq) {
  const double f_sp = 200.0 / 3.0;
  const double min_log_hz = 1000.0, min_log_mel = min_log_hz / f_sp;
  const double logstep = std::log(6.4) / 27.0;
  if (freq >= min_log_hz) {
    return min_log_mel + std::log(std::max(freq, 1e-10) / min_log_hz) / logstep;
  }
  return freq / f_sp;
}

double mel_to_hz_slaney(double mel) {
  const double f_sp = 200.0 / 3.0;
  const double min_log_hz = 1000.0, min_log_mel = min_log_hz / f_sp;
  const double logstep = std::log(6.4) / 27.0;
  if (mel >= min_log_mel) {
    return min_log_hz * std::exp(logstep * (mel - min_log_mel));
  }
  return f_sp * mel;
}

struct SparseBank {
  int start = 0;
  std::vector<double> w;
};

struct FbankPlan {
  int sample_rate = 0;
  int num_mel = 0;
  int frame_len_ms = 0;
  int frame_shift_ms = 0;
  double low_freq = 20.0, high_freq = 0.0;
  int window_size = 0, window_shift = 0, padded = 0;
  std::vector<double> window;                 // povey
  std::vector<SparseBank> banks;              // sparse triangular filters
  FFTPlan fft_plan;

  void build() {
    window_size = sample_rate * frame_len_ms / 1000;
    window_shift = sample_rate * frame_shift_ms / 1000;
    padded = next_pow2(window_size);
    window.resize(window_size);
    for (int i = 0; i < window_size; ++i) {
      const double h = 0.5 - 0.5 * std::cos(2.0 * M_PI * i / (window_size - 1));
      window[i] = std::pow(h, 0.85);
    }
    double hi = high_freq <= 0.0 ? 0.5 * sample_rate + high_freq : high_freq;
    const double mel_lo = mel_scale(low_freq), mel_hi = mel_scale(hi);
    const double mel_delta = (mel_hi - mel_lo) / (num_mel + 1);
    const double bin_width = static_cast<double>(sample_rate) / padded;
    const int nbins = padded / 2;
    banks.assign(num_mel, SparseBank{});
    for (int m = 0; m < num_mel; ++m) {
      const double left = mel_lo + m * mel_delta;
      const double center = mel_lo + (m + 1) * mel_delta;
      const double right = mel_lo + (m + 2) * mel_delta;
      int first = -1;
      std::vector<double> weights;
      for (int b = 0; b < nbins; ++b) {
        const double mel = mel_scale(bin_width * b);
        if (mel > left && mel < right) {
          if (first < 0) first = b;
          weights.push_back(mel <= center
                                ? (mel - left) / (center - left)
                                : (right - mel) / (right - center));
        } else if (first >= 0) {
          break;  // triangular support is contiguous
        }
      }
      banks[m].start = first < 0 ? 0 : first;
      banks[m].w = std::move(weights);
    }
    fft_plan.build(padded);
  }
};

// Whisper log-mel plan: periodic hann window + slaney filterbank + chirp-z.
struct LogMelPlan {
  int sample_rate = 0, n_fft = 0, n_mels = 0;
  std::vector<double> window;            // periodic hann
  std::vector<SparseBank> banks;         // slaney-normalized triangles
  FFTPlan fft_plan;                      // when n_fft is a power of two
  BluesteinPlan bluestein;               // otherwise
  bool pow2 = false;

  void build() {
    pow2 = (n_fft & (n_fft - 1)) == 0;
    if (pow2) {
      fft_plan.build(n_fft);
    } else {
      bluestein.build(n_fft);
    }
    window.resize(n_fft);
    for (int i = 0; i < n_fft; ++i) {
      window[i] = 0.5 - 0.5 * std::cos(2.0 * M_PI * i / n_fft);
    }
    const int nbins = 1 + n_fft / 2;
    const double fmax = sample_rate / 2.0;
    const double mel_max = hz_to_mel_slaney(fmax);
    std::vector<double> mel_f(n_mels + 2);
    for (int i = 0; i < n_mels + 2; ++i) {
      mel_f[i] = mel_to_hz_slaney(mel_max * i / (n_mels + 1));
    }
    banks.assign(n_mels, SparseBank{});
    for (int m = 0; m < n_mels; ++m) {
      const double enorm = 2.0 / (mel_f[m + 2] - mel_f[m]);
      int first = -1;
      std::vector<double> weights;
      for (int b = 0; b < nbins; ++b) {
        const double f = fmax * b / (n_fft / 2);
        const double lower = (f - mel_f[m]) / (mel_f[m + 1] - mel_f[m]);
        const double upper = (mel_f[m + 2] - f) / (mel_f[m + 2] - mel_f[m + 1]);
        const double w = std::max(0.0, std::min(lower, upper));
        if (w > 0.0) {
          if (first < 0) first = b;
          weights.push_back(w * enorm);
        } else if (first >= 0) {
          break;  // triangular support is contiguous
        }
      }
      banks[m].start = first < 0 ? 0 : first;
      banks[m].w = std::move(weights);
    }
  }
};

std::mutex g_mutex;
FbankPlan g_plan;       // fbank C API (low 20 Hz, high nyquist)
FbankPlan g_mfcc_plan;  // mfcc C API (caller-set low/high)
LogMelPlan g_logmel_plan;

// Log-mel filterbank energies (float64) for `frames` snip-edges frames.
// Shared core of the fbank and mfcc entry points; `plan` must be built.
void fbank_core(const FbankPlan& plan, const float* wave, int frames,
                float dither, uint64_t dither_seed, std::vector<double>& feat) {
  const int ws = plan.window_size, sh = plan.window_shift;
  const int num_mel = plan.num_mel;
  std::mt19937_64 rng(dither_seed);
  std::normal_distribution<double> gauss(0.0, 1.0);
  std::vector<double> frame(ws);
  std::vector<double> re(plan.padded), im(plan.padded);
  feat.resize(static_cast<size_t>(frames) * num_mel);

  for (int f = 0; f < frames; ++f) {
    const float* src = wave + static_cast<int64_t>(f) * sh;
    double mean = 0.0;
    for (int i = 0; i < ws; ++i) frame[i] = src[i];
    if (dither != 0.0f) {
      for (int i = 0; i < ws; ++i) frame[i] += dither * gauss(rng);
    }
    for (int i = 0; i < ws; ++i) mean += frame[i];
    mean /= ws;
    for (int i = 0; i < ws; ++i) frame[i] -= mean;  // remove DC
    // pre-emphasis 0.97 (first sample against itself, kaldi convention)
    for (int i = ws - 1; i > 0; --i) frame[i] -= 0.97 * frame[i - 1];
    frame[0] -= 0.97 * frame[0];
    for (int i = 0; i < ws; ++i) frame[i] *= plan.window[i];

    std::fill(re.begin(), re.end(), 0.0);
    std::fill(im.begin(), im.end(), 0.0);
    std::copy(frame.begin(), frame.end(), re.begin());
    fft(plan.fft_plan, re, im);

    const int nbins = plan.padded / 2;
    for (int m = 0; m < num_mel; ++m) {
      const SparseBank& bank = plan.banks[m];
      double acc = 0.0;
      const int limit =
          std::min<int>(bank.start + static_cast<int>(bank.w.size()), nbins);
      for (int b = bank.start; b < limit; ++b) {
        const double p = re[b] * re[b] + im[b] * im[b];
        acc += p * bank.w[b - bank.start];
      }
      feat[static_cast<size_t>(f) * num_mel + m] =
          std::log(acc > kEps ? acc : kEps);
    }
  }
}

void maybe_rebuild(FbankPlan& plan, int sample_rate, int num_mel,
                   int frame_len_ms, int frame_shift_ms, double low_freq,
                   double high_freq) {
  if (plan.sample_rate != sample_rate || plan.num_mel != num_mel ||
      plan.frame_len_ms != frame_len_ms ||
      plan.frame_shift_ms != frame_shift_ms || plan.low_freq != low_freq ||
      plan.high_freq != high_freq) {
    plan.sample_rate = sample_rate;
    plan.num_mel = num_mel;
    plan.frame_len_ms = frame_len_ms;
    plan.frame_shift_ms = frame_shift_ms;
    plan.low_freq = low_freq;
    plan.high_freq = high_freq;
    plan.build();
  }
}

}  // namespace

extern "C" {

// Returns the number of frames for n_samples under snip-edges framing.
int touchnet_fbank_num_frames(int n_samples, int sample_rate, int frame_len_ms,
                              int frame_shift_ms) {
  const int ws = sample_rate * frame_len_ms / 1000;
  const int sh = sample_rate * frame_shift_ms / 1000;
  if (n_samples < ws) return 0;
  return 1 + (n_samples - ws) / sh;
}

// wave: float32 samples (int16 scale, caller multiplies by 1<<15).
// out: float32 [num_frames, num_mel], caller-allocated.
// Returns number of frames written, or -1 on error.
int touchnet_fbank(const float* wave, int n_samples, int sample_rate,
                   int num_mel, int frame_len_ms, int frame_shift_ms,
                   float dither, uint64_t dither_seed, float* out) {
  std::lock_guard<std::mutex> lock(g_mutex);
  maybe_rebuild(g_plan, sample_rate, num_mel, frame_len_ms, frame_shift_ms,
                20.0, 0.0);
  const int frames = touchnet_fbank_num_frames(
      n_samples, sample_rate, frame_len_ms, frame_shift_ms);
  if (frames <= 0) return frames;
  std::vector<double> feat;
  fbank_core(g_plan, wave, frames, dither, dither_seed, feat);
  for (size_t i = 0; i < feat.size(); ++i) out[i] = static_cast<float>(feat[i]);
  return frames;
}

// Kaldi-compatible MFCC: fbank -> orthonormal DCT-II -> sinusoidal lifter
// (dsp.py mfcc / torchaudio.compliance.kaldi.mfcc semantics).
// out: float32 [num_frames, num_ceps]. Returns frames written, or -1.
int touchnet_mfcc(const float* wave, int n_samples, int sample_rate,
                  int num_mel, int frame_len_ms, int frame_shift_ms,
                  float dither, uint64_t dither_seed, int num_ceps,
                  float cepstral_lifter, float low_freq, float high_freq,
                  float* out) {
  if (num_ceps <= 0 || num_ceps > num_mel) return -1;
  std::lock_guard<std::mutex> lock(g_mutex);
  maybe_rebuild(g_mfcc_plan, sample_rate, num_mel, frame_len_ms,
                frame_shift_ms, low_freq, high_freq);
  const int frames = touchnet_fbank_num_frames(
      n_samples, sample_rate, frame_len_ms, frame_shift_ms);
  if (frames <= 0) return frames;
  std::vector<double> feat;
  fbank_core(g_mfcc_plan, wave, frames, dither, dither_seed, feat);

  // orthonormal DCT-II matrix [num_mel, num_ceps] + lifter coefficients
  std::vector<double> dct(static_cast<size_t>(num_mel) * num_ceps);
  const double norm = std::sqrt(2.0 / num_mel);
  for (int k = 0; k < num_mel; ++k) {
    for (int j = 0; j < num_ceps; ++j) {
      double c = norm * std::cos(M_PI / num_mel * (k + 0.5) * j);
      if (j == 0) c /= std::sqrt(2.0);
      dct[static_cast<size_t>(k) * num_ceps + j] = c;
    }
  }
  std::vector<double> lifter(num_ceps, 1.0);
  if (cepstral_lifter != 0.0f) {
    for (int j = 0; j < num_ceps; ++j) {
      lifter[j] = 1.0 + 0.5 * cepstral_lifter *
                            std::sin(M_PI * j / cepstral_lifter);
    }
  }
  for (int f = 0; f < frames; ++f) {
    const double* row = feat.data() + static_cast<size_t>(f) * num_mel;
    for (int j = 0; j < num_ceps; ++j) {
      double acc = 0.0;
      for (int k = 0; k < num_mel; ++k) {
        acc += row[k] * dct[static_cast<size_t>(k) * num_ceps + j];
      }
      out[static_cast<int64_t>(f) * num_ceps + j] =
          static_cast<float>(acc * lifter[j]);
    }
  }
  return frames;
}

// Whisper log-mel frame count: centered STFT (reflect pad n_fft/2 both
// sides) over n_samples + padding appended zeros, last frame dropped.
int touchnet_logmel_num_frames(int n_samples, int padding, int n_fft,
                               int hop_length) {
  const int total = n_samples + padding + 2 * (n_fft / 2);
  if (total < n_fft) return 0;
  return 1 + (total - n_fft) / hop_length - 1;  // whisper drops last frame
}

// Whisper-style log-mel (reference touchnet/data/functions.py:159-190):
// raw float waveform in [-1, 1]; out float32 [num_frames, n_mels].
// Returns frames written, or -1 on error.
int touchnet_logmel(const float* wave, int n_samples, int sample_rate,
                    int n_fft, int hop_length, int n_mels, int padding,
                    float* out) {
  if (n_fft <= 1 || hop_length <= 0 || n_mels <= 0 || padding < 0) return -1;
  std::lock_guard<std::mutex> lock(g_mutex);
  LogMelPlan& plan = g_logmel_plan;
  if (plan.sample_rate != sample_rate || plan.n_fft != n_fft ||
      plan.n_mels != n_mels) {
    plan.sample_rate = sample_rate;
    plan.n_fft = n_fft;
    plan.n_mels = n_mels;
    plan.build();
  }
  const int frames =
      touchnet_logmel_num_frames(n_samples, padding, n_fft, hop_length);
  if (frames <= 0) return frames;

  // padded signal access: [reflect n_fft/2 | wave | zeros(padding) | reflect]
  const int pad = n_fft / 2;
  const int body = n_samples + padding;  // wave + appended zeros
  auto sample_at = [&](int i) -> double {
    int j = i - pad;
    if (j < 0) j = -j;                       // left reflection
    if (j >= body) j = 2 * (body - 1) - j;   // right reflection
    return (j >= 0 && j < n_samples) ? static_cast<double>(wave[j]) : 0.0;
  };

  std::vector<double> re(n_fft), im(n_fft);
  std::vector<double> work_re, work_im;
  std::vector<double> mel(static_cast<size_t>(frames) * n_mels);
  const int nbins = 1 + n_fft / 2;
  std::vector<double> power(nbins);

  for (int f = 0; f < frames; ++f) {
    const int start = f * hop_length;
    for (int i = 0; i < n_fft; ++i) {
      re[i] = sample_at(start + i) * plan.window[i];
      im[i] = 0.0;
    }
    if (plan.pow2) {
      fft(plan.fft_plan, re, im);
    } else {
      plan.bluestein.transform(re, im, work_re, work_im);
    }
    for (int b = 0; b < nbins; ++b) power[b] = re[b] * re[b] + im[b] * im[b];
    for (int m = 0; m < n_mels; ++m) {
      const SparseBank& bank = plan.banks[m];
      double acc = 0.0;
      const int limit =
          std::min<int>(bank.start + static_cast<int>(bank.w.size()), nbins);
      for (int b = bank.start; b < limit; ++b) {
        acc += power[b] * bank.w[b - bank.start];
      }
      mel[static_cast<size_t>(f) * n_mels + m] =
          std::log10(std::max(acc, 1e-10));
    }
  }
  double gmax = -1e300;
  for (double v : mel) gmax = std::max(gmax, v);
  const double floor = gmax - 8.0;
  for (size_t i = 0; i < mel.size(); ++i) {
    out[i] = static_cast<float>((std::max(mel[i], floor) + 4.0) / 4.0);
  }
  return frames;
}

}  // extern "C"
