// Native host-side audio library of the port (the JAX package's
// native/audio_kernels.cpp, the same arithmetic, so both libraries give
// bit-equal results): a windowed-sinc polyphase resampler, PCM format
// conversion, downmix and peak, exposed through a minimal C ABI and loaded
// from Python with ctypes. It runs on the host CPU, not on the card.
//
// Build: g++ -O3 -shared -fPIC -std=c++17, driven by native/build.py at
// first use into build/native/ at the repository root.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// Modified Bessel function of the first kind, order 0 (for Kaiser window).
double bessel_i0(double x) {
  double sum = 1.0, term = 1.0;
  const double x2 = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= x2 / (static_cast<double>(k) * k);
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

long long gcd_ll(long long a, long long b) {
  while (b) {
    long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

extern "C" {

// Output length of resampling n_in samples from src_rate to dst_rate.
long long q3tts_resample_out_len(long long n_in, int src_rate, int dst_rate) {
  if (src_rate == dst_rate) return n_in;
  const long long g = gcd_ll(src_rate, dst_rate);
  const long long up = dst_rate / g, down = src_rate / g;
  return (n_in * up + down - 1) / down;
}

// Polyphase windowed-sinc resampler (Kaiser window, beta=8.6, ~80 dB
// stopband). float32 mono in -> float32 mono out. Returns samples written,
// or -1 on error. `out` must hold q3tts_resample_out_len() samples.
long long q3tts_resample(const float* in, long long n_in, int src_rate,
                         int dst_rate, float* out, long long out_cap) {
  if (!in || !out || n_in < 0 || src_rate <= 0 || dst_rate <= 0) return -1;
  if (src_rate == dst_rate) {
    if (out_cap < n_in) return -1;
    std::memcpy(out, in, sizeof(float) * static_cast<size_t>(n_in));
    return n_in;
  }
  const long long g = gcd_ll(src_rate, dst_rate);
  const long long up = dst_rate / g, down = src_rate / g;
  const long long n_out = (n_in * up + down - 1) / down;
  if (out_cap < n_out) return -1;

  // Lowpass at the tighter Nyquist; 24 taps per phase.
  const int taps_per_phase = 24;
  const long long half = (taps_per_phase / 2) * up;  // filter half-length
  const long long n_taps = 2 * half + 1;
  const double cutoff = 1.0 / static_cast<double>(up > down ? up : down);
  const double beta = 8.6;
  const double i0b = bessel_i0(beta);

  std::vector<double> h(static_cast<size_t>(n_taps));
  for (long long i = 0; i < n_taps; ++i) {
    const double m = static_cast<double>(i - half);
    const double t = m / static_cast<double>(half + 1);
    const double win = bessel_i0(beta * std::sqrt(1.0 - t * t)) / i0b;
    const double arg = kPi * m * cutoff;
    const double sinc = (m == 0.0) ? 1.0 : std::sin(arg) / arg;
    h[static_cast<size_t>(i)] = cutoff * sinc * win * static_cast<double>(up);
  }

  // out[j] sits at input-time num/up, num = j*down. The tap weighting
  // input sample (base - k) is h[half + frac + k*up]: valid taps require
  // 0 <= half + frac + k*up < n_taps.
  for (long long j = 0; j < n_out; ++j) {
    const long long num = j * down;
    const long long base = num / up;         // integer input index
    const long long frac = num % up;         // phase in [0, up)
    // floor/ceil bounds for k so the tap index stays in range
    long long k_min = -((half + frac) / up);
    long long k_max = (half - frac) / up;
    if (base - k_max < 0) k_max = base;                       // clip to input
    if (base - k_min > n_in - 1) k_min = base - (n_in - 1);
    double acc = 0.0;
    for (long long k = k_min; k <= k_max; ++k) {
      const long long tap = half + frac + k * up;
      acc += h[static_cast<size_t>(tap)] * static_cast<double>(in[base - k]);
    }
    out[j] = static_cast<float>(acc);
  }
  return n_out;
}

// float32 [-1,1] -> int16 PCM with clamping.
void q3tts_f32_to_i16(const float* in, long long n, int16_t* out) {
  for (long long i = 0; i < n; ++i) {
    float v = in[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    const float scaled = v * 32767.0f;
    out[i] = static_cast<int16_t>(scaled >= 0 ? scaled + 0.5f : scaled - 0.5f);
  }
}

// int16 PCM -> float32 [-1,1].
void q3tts_i16_to_f32(const int16_t* in, long long n, float* out) {
  const float inv = 1.0f / 32768.0f;
  for (long long i = 0; i < n; ++i) out[i] = static_cast<float>(in[i]) * inv;
}

// Downmix interleaved multi-channel float32 to mono (mean).
void q3tts_downmix_mono(const float* in, long long frames, int channels,
                        float* out) {
  if (channels <= 1) {
    std::memcpy(out, in, sizeof(float) * static_cast<size_t>(frames));
    return;
  }
  const float inv = 1.0f / static_cast<float>(channels);
  for (long long i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c)
      acc += static_cast<double>(in[i * channels + c]);
    out[i] = static_cast<float>(acc * inv);
  }
}

// Peak level of a float32 buffer.
float q3tts_peak(const float* in, long long n) {
  float peak = 0.0f;
  for (long long i = 0; i < n; ++i) {
    const float a = std::fabs(in[i]);
    if (a > peak) peak = a;
  }
  return peak;
}

int q3tts_abi_version() { return 1; }

}  // extern "C"
