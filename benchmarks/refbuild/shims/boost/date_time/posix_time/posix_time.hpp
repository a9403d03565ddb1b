// std::chrono-backed stand-in for the tiny boost::posix_time surface the
// reference benchmark build needs (ptime, microsec_clock::local_time and
// durations' total_*seconds). Built only for the out-of-repo head-to-head
// reference executable — NOT part of the uvio_jax framework.
#pragma once
#include <chrono>
#include <cstdint>

namespace boost {
namespace posix_time {

struct time_duration {
  std::int64_t us{0};
  std::int64_t total_microseconds() const { return us; }
  std::int64_t total_milliseconds() const { return us / 1000; }
  std::int64_t total_seconds() const { return us / 1000000; }
};

struct ptime {
  std::chrono::steady_clock::time_point tp{};
  time_duration operator-(const ptime &o) const {
    return {std::chrono::duration_cast<std::chrono::microseconds>(tp - o.tp).count()};
  }
};

struct microsec_clock {
  static ptime local_time() { return {std::chrono::steady_clock::now()}; }
};

} // namespace posix_time
} // namespace boost
