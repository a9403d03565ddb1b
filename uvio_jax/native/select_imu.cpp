// Native host-runtime kernels for the per-frame data path.
//
// The reference's runtime around the estimator is C++ (`Propagator::
// select_imu_readings` + `interpolate_data`, Propagator.cpp:269-386);
// this is the framework's equivalent native layer: the
// per-frame IMU slicing/boundary-interpolation/padding that feeds the
// device, exposed over a plain C ABI for a ctypes binding (no Python
// API dependency). Compiled lazily by uvio_jax/native/__init__.py.
//
// Semantics are identical to the Python fallback
// (`filter/propagator.py::select_imu_readings_np`), bit-for-bit for
// linear interpolation in double precision.

#include <cstdint>
#include <cstring>

extern "C" {

// returns the number of real (unpadded) samples written, or
//   -1 : backwards request (t1 <= t0)
//   -2 : batch would exceed m_max
int64_t uvio_select_imu_readings(
    const double* times, const double* ws, const double* accs, int64_t n,
    double t0, double t1, int64_t m_max,
    double* out_t, double* out_w, double* out_a) {
  if (!(t1 > t0) || n < 2) return -1;

  // lower_bound over times for a timestamp
  auto interp = [&](double t, double* w_out, double* a_out) {
    int64_t lo = 0, hi = n;  // first index with times[i] >= t
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (times[mid] < t) lo = mid + 1; else hi = mid;
    }
    int64_t i = lo;
    if (i < 1) i = 1;
    if (i > n - 1) i = n - 1;
    double denom = times[i] - times[i - 1];
    double lam = denom != 0.0 ? (t - times[i - 1]) / denom : 0.0;
    for (int k = 0; k < 3; k++) {
      w_out[k] = (1.0 - lam) * ws[3 * (i - 1) + k] + lam * ws[3 * i + k];
      a_out[k] = (1.0 - lam) * accs[3 * (i - 1) + k] + lam * accs[3 * i + k];
    }
  };

  int64_t count = 0;
  // boundary sample at t0
  out_t[count] = t0;
  interp(t0, &out_w[3 * count], &out_a[3 * count]);
  count++;
  // interior samples strictly inside (t0, t1)
  for (int64_t i = 0; i < n; i++) {
    if (times[i] > t0 && times[i] < t1) {
      if (count >= m_max) return -2;
      out_t[count] = times[i];
      std::memcpy(&out_w[3 * count], &ws[3 * i], 3 * sizeof(double));
      std::memcpy(&out_a[3 * count], &accs[3 * i], 3 * sizeof(double));
      count++;
    }
  }
  if (count >= m_max) return -2;
  // boundary sample at t1
  out_t[count] = t1;
  interp(t1, &out_w[3 * count], &out_a[3 * count]);
  count++;
  int64_t real = count;
  // pad by repeating the final sample (dt == 0 rows are inert on device)
  for (int64_t i = count; i < m_max; i++) {
    out_t[i] = out_t[count - 1];
    std::memcpy(&out_w[3 * i], &out_w[3 * (count - 1)], 3 * sizeof(double));
    std::memcpy(&out_a[3 * i], &out_a[3 * (count - 1)], 3 * sizeof(double));
  }
  return real;
}

}  // extern "C"
