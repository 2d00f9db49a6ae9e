// K22: one field of the civil calendar over a DATE or TIMESTAMP lane.
//
// Replaces the reference's expr/datetime_expr.py `_ymd` (:84) and the
// civil-calendar arithmetic behind Year, Month, DayOfMonth, Quarter,
// DayOfYear, LastDay, AddMonths and TruncDate (expr/cast.py
// `_civil_from_days` :558 and `_days_from_civil` :548, Howard Hinnant's
// algorithms with floor divisions), the floor-mod fields of DayOfWeek
// and WeekDay, and `_time_part` (:169) for Hour, Minute and Second.
// There each field is some 30 int64 array ops, each reading and writing
// the whole column; here one launch reads the lane once and writes the
// int32 field once.
//
// Input: a DATE lane (int32 days since 1970-01-01) or a TIMESTAMP lane
// (int64 microseconds, floor-divided to its day for a day field).
// ADD_MONTHS also reads the months, an int32 column or one literal.  The
// validity is the caller's: every row is read and written.  Results are
// computed as the reference's int64 numpy code computes them and wrapped
// to int32 (its `astype(np.int32)`); every `//` and `%` of the reference
// floors, so a negative operand takes the floor helpers below (C++
// truncates toward zero).
//
// Bound: device-memory bytes, 8 a row for a DATE field (4 in, 4 out), 12
// for a TIMESTAMP field or with a months column, over 3.35 TB/s.  The
// arithmetic is the risk: the card has no 64-bit integer multiplier, so
// each 64-bit division by a constant is several 32-bit multiply-highs.
// The calendar therefore runs in 32-bit arithmetic wherever the day
// fits (|days| <= 2e9: every day of a TIMESTAMP, every DATE but those
// near +-2^31), in 64-bit otherwise; only the last step of
// days-from-civil (era * 146097) is always 64-bit.
//
// Design: a grid-stride elementwise pass.  Each thread takes one 16-byte
// vector of the lane (4 days or 2 timestamps) from where the lane's
// pointer is 16-byte aligned; the rows before that (at most 3) and after
// the last whole vector (at most 3) go one a thread.  The output and the
// months column are moved as vectors where their pointers share that
// alignment (a column that is a view at another offset moves row by
// row).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr long long kMicrosPerDay = 86400000000LL;

enum Field {
  YEAR, MONTH, DAY, QUARTER, DAYOFWEEK, WEEKDAY, DAYOFYEAR, LAST_DAY, HOUR,
  MINUTE, SECOND, ADD_MONTHS, TRUNC_YEAR, TRUNC_MONTH, TRUNC_QUARTER,
  TRUNC_WEEK, kFields
};

// floor division and modulo by a positive constant
template <typename I>
__device__ __forceinline__ I floor_div(I a, I b) {
  const I q = a / b;
  return q - static_cast<I>(a - q * b < 0);
}

template <typename I>
__device__ __forceinline__ I floor_mod(I a, I b) {
  const I r = a % b;
  return r < 0 ? r + b : r;
}

// (y, m, d) of days since 1970-01-01; I is int where days + 719468 and
// days - 146096 + 719468 fit it.  doe, yoe, doy and mp are never
// negative, so their divisions truncate.
template <typename I>
__device__ __forceinline__ void civil(I days, int& y, int& m, int& d) {
  const I z = days + 719468;
  const I era = floor_div<I>(z >= 0 ? z : z - 146096, 146097);
  const int doe = static_cast<int>(z - era * 146097);
  const int yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const int doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const int mp = (5 * doy + 2) / 153;
  d = doy - (153 * mp + 2) / 5 + 1;
  m = mp + (mp < 10 ? 3 : -9);
  y = static_cast<int>(yoe + era * 400) + (m <= 2);
}

__device__ __forceinline__ void civil_of(long long days, int& y, int& m,
                                         int& d) {
  if (days >= -2000000000LL && days <= 2000000000LL) {
    civil<int>(static_cast<int>(days), y, m, d);
  } else {
    civil<long long>(days, y, m, d);
  }
}

// days since 1970-01-01 of (y, m, d), for m in 1..12 and |y| < 2^30
__device__ __forceinline__ long long days_of(int y, int m, int d) {
  y -= (m <= 2);
  const int era = floor_div<int>(y >= 0 ? y : y - 399, 400);
  const int yoe = y - era * 400;
  const int mp = (m + 9) % 12;
  const int doy = (153 * mp + 2) / 5 + d - 1;
  const int doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return static_cast<long long>(era) * 146097 + doe - 719468;
}

__device__ __forceinline__ long long day_field(long long days, int field,
                                               int months) {
  switch (field) {
    case DAYOFWEEK: return floor_mod<long long>(days + 4, 7) + 1;
    case WEEKDAY: return floor_mod<long long>(days + 3, 7);
    case TRUNC_WEEK: return days - floor_mod<long long>(days + 3, 7);
    default: break;
  }
  int y, m, d;
  civil_of(days, y, m, d);
  switch (field) {
    case YEAR: return y;
    case MONTH: return m;
    case DAY: return d;
    case QUARTER: return (m - 1) / 3 + 1;
    case DAYOFYEAR: return days - days_of(y, 1, 1) + 1;
    case LAST_DAY:
      return days_of(m == 12 ? y + 1 : y, m == 12 ? 1 : m + 1, 1) - 1;
    case TRUNC_YEAR: return days_of(y, 1, 1);
    case TRUNC_MONTH: return days_of(y, m, 1);
    case TRUNC_QUARTER: return days_of(y, (m - 1) / 3 * 3 + 1, 1);
    default: break;
  }
  // ADD_MONTHS: the day clamps to the target month's last day
  const long long tot = static_cast<long long>(y) * 12 + (m - 1) + months;
  const int ny = static_cast<int>(floor_div<long long>(tot, 12));
  const int nm = static_cast<int>(floor_mod<long long>(tot, 12)) + 1;
  const long long last = days_of(nm == 12 ? ny + 1 : ny,
                                 nm == 12 ? 1 : nm + 1, 1) - 1;
  int ly, lm, ld;
  civil_of(last, ly, lm, ld);
  return days_of(ny, nm, d < ld ? d : ld);
}

template <typename T>
__device__ __forceinline__ int one(T v, int field, int months) {
  long long days = v;
  if constexpr (sizeof(T) == 8) {       // a TIMESTAMP lane: microseconds
    if (field >= HOUR && field <= SECOND) {
      const unsigned long long tod = static_cast<unsigned long long>(
          floor_mod<long long>(v, kMicrosPerDay));
      const unsigned long long div =
          field == HOUR ? 3600000000ull : field == MINUTE ? 60000000ull
                                                          : 1000000ull;
      const unsigned part = static_cast<unsigned>(tod / div);
      return static_cast<int>(part % (field == HOUR ? 24u : 60u));
    }
    days = floor_div<long long>(v, kMicrosPerDay);
  }
  return static_cast<int>(day_field(days, field, months));
}

template <typename T> struct Vec;
template <> struct Vec<int> {
  using In = int4;
  using Out = int4;
};
template <> struct Vec<long long> {
  using In = longlong2;
  using Out = int2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
date_fields_kernel(const T* __restrict__ in, long long n, int head,
                   long long nvec, int field,
                   const int* __restrict__ months, int months_lit,
                   int vec_months, int vec_out, int* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  using VIn = typename Vec<T>::In;
  using VOut = typename Vec<T>::Out;
  const long long g0 = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  // the rows before the first aligned vector and after the last one
  const long long tail = head + nvec * V;
  if (g0 < head) {
    out[g0] = one<T>(in[g0], field, months ? months[g0] : months_lit);
  }
  if (g0 < n - tail) {
    const long long i = tail + g0;
    out[i] = one<T>(in[i], field, months ? months[i] : months_lit);
  }
  const VIn* vin = reinterpret_cast<const VIn*>(in + head);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = g0; g < nvec; g += stride) {
    const long long base = head + g * V;
    const VIn x = __ldg(vin + g);
    const T* xs = reinterpret_cast<const T*>(&x);
    int mo[V];
    if (months == nullptr) {
#pragma unroll
      for (int j = 0; j < V; ++j) mo[j] = months_lit;
    } else if (vec_months) {
      const VOut mv = __ldg(reinterpret_cast<const VOut*>(months + base));
      const int* ms = reinterpret_cast<const int*>(&mv);
#pragma unroll
      for (int j = 0; j < V; ++j) mo[j] = ms[j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) mo[j] = __ldg(months + base + j);
    }
    VOut r;
    int* rs = reinterpret_cast<int*>(&r);
#pragma unroll
    for (int j = 0; j < V; ++j) rs[j] = one<T>(xs[j], field, mo[j]);
    if (vec_out) {
      *reinterpret_cast<VOut*>(out + base) = r;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) out[base + j] = rs[j];
    }
  }
}

template <typename T>
int launch(const T* in, long long n, int field, const int* months,
           int months_lit, int* out, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(in);
  const long long head_rows = static_cast<long long>(
      ((16 - (addr & 15)) & 15) / sizeof(T));
  const int head = static_cast<int>(head_rows < n ? head_rows : n);
  const long long nvec = (n - head) / V;
  // the output (and months) vector at row head + g * V is aligned when
  // row head is on a 4 * V byte boundary
  const auto aligned = [&](const int* p) {
    return static_cast<int>(
        p != nullptr &&
        (reinterpret_cast<uintptr_t>(p + head) & (4 * V - 1)) == 0);
  };
  long long blocks = (nvec + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : blocks > kMaxBlocks ? kMaxBlocks : blocks;
  date_fields_kernel<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      in, n, head, nvec, field, months, months_lit, aligned(months),
      aligned(out), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values: int32[n] days (is_timestamp 0) or int64[n] microseconds (1);
// field: a Field code (time parts only of a timestamp, ADD_MONTHS only of
// days); months: int32[n] or null (then months_lit); out: int32[n].
extern "C" int srt_date_fields(const void* values, int is_timestamp,
                               long long n, int field, const int* months,
                               int months_lit, int* out,
                               cudaStream_t stream) {
  const bool time_part = field >= HOUR && field <= SECOND;
  if (n < 0 || field < 0 || field >= kFields ||
      (is_timestamp && field == ADD_MONTHS) || (!is_timestamp && time_part))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (is_timestamp)
    return launch<long long>(static_cast<const long long*>(values), n, field,
                             months, months_lit, out, stream);
  return launch<int>(static_cast<const int*>(values), n, field, months,
                     months_lit, out, stream);
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }
